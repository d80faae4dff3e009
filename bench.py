#!/usr/bin/env python
"""Benchmark: wav segments/sec through (a) the batched device feature graph
and (b) the FUSED wav->feature->train step (BASELINE.json's headline metric:
"wav segments/sec (feature+train step)") for CNN8 and VGG, against the CPU
(NumPy/SciPy, librosa-equivalent) per-clip pipeline.

Runs on an NVIDIA GPU only and fails without one. Input is seeded synthetic
clips (tpu_breath.data.synth), since the dataset is not in the repository.
Prints the card (nvidia-smi name and power limit), then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device", ...extras}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N_CLIPS = 2048
CHUNK = 128
TRAIN_BATCH = 512
TRAIN_STEPS = 8
# >=20 clips so the CPU-oracle denominator isn't hostage to per-clip variance
# (tuning-estimation cost varies with peak count)
BASELINE_CLIPS = 24


def main() -> int:
    import jax
    import jax.numpy as jnp
    from jax import lax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX's first device is {dev.platform}",
              file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}

    from tpu_breath.baseline import feature_np
    from tpu_breath.config import CNN8_TRAIN, DEFAULT_FEATURES, VGG_TRAIN
    from tpu_breath.data import synth
    from tpu_breath.features import extract_features
    from tpu_breath.models import registry
    from tpu_breath.train import loop as train_loop

    labels_np = np.tile(np.array(["I", "E"]), N_CLIPS // 2)
    wavs = synth.synth_clips(labels_np, np.random.default_rng(0)
                             ).astype(np.float32) / 32768.0

    # --- CPU baseline: the per-clip NumPy/SciPy pipeline (same math stack
    # librosa dispatches to), single core, like the reference's precompute.
    t0 = time.perf_counter()
    for i in range(BASELINE_CLIPS):
        feature_np.process_clip(wavs[i], DEFAULT_FEATURES)
    cpu_rate = BASELINE_CLIPS / (time.perf_counter() - t0)

    # --- (a) feature-only: all chunks inside one jitted graph
    @jax.jit
    def sweep(w):
        chunks = w.reshape(N_CLIPS // CHUNK, CHUNK, -1)
        return lax.map(lambda c: extract_features(c, DEFAULT_FEATURES),
                       chunks)

    x = jnp.asarray(wavs)
    jax.block_until_ready(sweep(x))  # compile + warmup
    t0 = time.perf_counter()
    feats = jax.block_until_ready(sweep(x))
    feat_rate = N_CLIPS / (time.perf_counter() - t0)
    assert all(np.isfinite(np.asarray(a)).all() for a in feats)

    # --- (b) fused wav->feature->train step per model: one donated jit
    # graph per step, TRAIN_STEPS steps dispatched asynchronously.
    labels = jnp.asarray((labels_np == "E").astype(np.float32))
    scals_dummy = jnp.zeros((N_CLIPS, 0), jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), TRAIN_STEPS)
    use_aug = jnp.asarray(True)
    fused = {}
    for arch, base_cfg in (("cnn8", CNN8_TRAIN), ("vgg", VGG_TRAIN)):
        cfg = type(base_cfg)(**{**base_cfg.__dict__,
                                "batch_size": TRAIN_BATCH})
        model = registry.build(arch, DEFAULT_FEATURES.n_scalars)
        state, tx, _ = train_loop.create_state(
            model, jax.random.PRNGKey(0), cfg, N_CLIPS // TRAIN_BATCH)
        step = train_loop.make_train_step(model, tx, cfg,
                                          fused_spec=DEFAULT_FEATURES,
                                          fused_chunk=CHUNK)

        def run_steps(state):
            stats = None
            for s in range(TRAIN_STEPS):
                idx = jnp.asarray(np.arange(TRAIN_BATCH) + (s * TRAIN_BATCH)
                                  % (N_CLIPS - TRAIN_BATCH))
                state, stats = step(state, x, scals_dummy, labels, idx,
                                    keys[s], use_aug)
            return state, jax.block_until_ready(stats["loss"])

        state, _ = run_steps(state)  # compile + warmup
        t0 = time.perf_counter()
        state, loss = run_steps(state)
        fused[arch] = TRAIN_STEPS * TRAIN_BATCH / (time.perf_counter() - t0)
        assert np.isfinite(float(loss))

    # vs_baseline pairs with "value": fused clips/s over the CPU oracle's
    # feature-only clips/s — conservative, since the fused step does strictly
    # more work per clip (features + fwd/bwd/AdamW) than the oracle.
    print(json.dumps({
        "metric": "fused wav->feature->train-step throughput (9-ch spectrogram stack + 36 scalars + CNN8 fwd/bwd/AdamW per 1s wav clip)",
        "value": round(fused["cnn8"], 2),
        "unit": "clips/s",
        "vs_baseline": round(fused["cnn8"] / cpu_rate, 2),
        "device": device,
        "card": card,
        "input": "synthetic clips, seed 0",
        "feature_only_clips_per_s": round(feat_rate, 2),
        "feature_vs_cpu_baseline": round(feat_rate / cpu_rate, 2),
        "cpu_oracle_clips_per_s": round(cpu_rate, 3),
        "cpu_baseline_clips": BASELINE_CLIPS,
        "vgg_fused_clips_per_s": round(fused["vgg"], 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
