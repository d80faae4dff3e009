#!/usr/bin/env python
"""Smoke run of the whole program on NVIDIA GPUs, through its entry points.

    python chip_smoke.py               # one card: phases a-h below
    python chip_smoke.py --devices 4   # four cards: the data-parallel phases

One card, in order:
  a. the card-only tests (`python -m pytest -m gpu tests/`, a subprocess
     that runs and exits before this process opens the card);
  b. golden parity: the feature graph at full width (9x128x63 + 36 scalars)
     on the wavs in tests/fixtures/golden_*.npz against their oracle outputs,
     and the chroma tuning estimate against the NumPy oracle;
  c. seeded synthetic competition input (1,280 train + 256 test clips);
  d. `precompute` over all 1,536 clips (chunk 128);
  e. `train --archs cnn8,vgg --epochs 2 --mesh off --predict` at batch 512,
     with compiled.memory_analysis() of each cached train step;
  f. each model at real width in float32 at "highest" precision on the GPU
     against the same on the CPU, then the default bf16 path against it;
  g. `predict --from-wav` on 8 test wavs against the cached-feature ensemble;
  h. `train --fused --archs cnn8 --epochs 1 --mesh off` against e's epoch 1.

Four cards (--devices 4): `train --archs cnn8 --f32 --epochs 2` with
`--mesh 4` against `--mesh off`, and `precompute --mesh 4` against the
single-card run, and nothing else.

Every comparison prints its error beside its tolerance. The last line of
standard output is one JSON object {"ok": true, "device": {...}}; it is
printed only when every phase passed on a GPU, and the exit code is 0 only
then. Inputs and outputs go to .cache/smoke_* inside the checkout.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, ".cache", "smoke_input")
OUT = os.path.join(HERE, ".cache", "smoke_out")
N_TRAIN, N_TEST = 1280, 256


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def report(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def compare(phase: str, name: str, err: float, tol: float) -> None:
    """Print a measured error beside its tolerance; fail above it."""
    report(phase, check=name, err=f"{err:.3e}", tol=f"{tol:.0e}",
           ok=err <= tol)
    check(err <= tol, f"{name}: error {err:.3e} > tolerance {tol:.0e}")


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def check_device(devices) -> dict:
    """The device the run reports; refuses anything but a GPU."""
    d = devices[0]
    if d.platform != "gpu":
        raise SmokeFailure(f"no GPU: JAX's first device is {d.platform} "
                           f"({d.device_kind})")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


class CompileClock:
    """Sums JAX's trace, lowering and backend-compile durations, and counts
    persistent-cache hits and misses, from JAX's monitoring events."""
    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax
        self.secs, self.hits, self.misses = 0.0, 0, 0

        def on_duration(event, secs, **_):
            if event in self.EVENTS:
                self.secs += secs

        def on_event(event, **_):
            if event == "/jax/compilation_cache/cache_hits":
                self.hits += 1
            elif event == "/jax/compilation_cache/cache_misses":
                self.misses += 1

        jax.monitoring.register_event_duration_secs_listener(on_duration)
        jax.monitoring.register_event_listener(on_event)

    @contextlib.contextmanager
    def phase(self, name: str):
        s0, h0, m0, t0 = self.secs, self.hits, self.misses, time.time()
        yield
        report(name, wall_s=f"{time.time() - t0:.1f}",
               compile_s=f"{self.secs - s0:.1f}",
               cache_hits=self.hits - h0, cache_misses=self.misses - m0)


def cli(*argv: str) -> str:
    """Run the CLI in this process; return what it printed."""
    from tpu_breath import cli as cli_mod
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_mod.main(list(argv))
    return buf.getvalue()


def read_history(out_root: str, arch: str) -> list[dict]:
    with open(os.path.join(out_root, "checkpoints", arch,
                           "history.jsonl")) as f:
        return [json.loads(line) for line in f]


def rel_err(a, b) -> float:
    """max |a - b| over max |b|, across every leaf of two pytrees."""
    import jax
    import numpy as np
    la = [np.asarray(x, np.float64) for x in jax.tree.leaves(a)]
    lb = [np.asarray(x, np.float64) for x in jax.tree.leaves(b)]
    num = max(float(np.max(np.abs(x - y))) for x, y in zip(la, lb))
    return num / max(max(float(np.max(np.abs(y))) for y in lb), 1e-30)


# ----------------------------------------------------------------- phases

def phase_gpu_tests(cache_dir: str) -> None:
    env = {**os.environ, "JAX_COMPILATION_CACHE_DIR": cache_dir}
    r = subprocess.run([sys.executable, "-m", "pytest", "-m", "gpu",
                        "tests/", "-q", "-p", "no:cacheprovider"],
                       cwd=HERE, env=env, capture_output=True, text=True)
    tail = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    report("a", pytest_rc=r.returncode, summary=repr(tail))
    if r.returncode != 0:
        print(r.stdout[-6000:], r.stderr[-3000:], sep="\n")
    check(r.returncode == 0, "card-only tests failed")
    check(" passed" in tail and "skipped" not in tail,
          "card-only tests did not all run")


def phase_golden(phase: str = "b") -> None:
    import glob
    import jax
    import numpy as np
    from tpu_breath.baseline import dsp_np
    from tpu_breath.config import DEFAULT_FEATURES as SPEC
    from tpu_breath.features import extract_features
    from tpu_breath.ops import chroma as ch_ops, spectral as sp_ops

    paths = sorted(glob.glob(os.path.join(HERE, "tests", "fixtures",
                                          "golden_*.npz")))
    check(len(paths) >= 2, "golden fixtures missing")
    fx = [np.load(p) for p in paths]
    wavs = np.stack([d["wav"] for d in fx])
    f, s = jax.jit(lambda w: extract_features(w, SPEC))(wavs)
    f, s = np.asarray(f), np.asarray(s)
    check(f.shape == (len(fx), 9, 128, 63) and s.shape == (len(fx), 36),
          f"feature shapes {f.shape} {s.shape}")
    for c, name in enumerate(SPEC.channel_order):
        err = max(float(np.max(np.abs(f[i, c] - d[name])))
                  for i, d in enumerate(fx))
        compare(phase, f"golden channel {name} (max abs)", err, 2e-3)
    err = max(float(np.max(np.abs(s[i] - d["scalars"])
                           / np.maximum(np.abs(d["scalars"]), 1e-2)))
              for i, d in enumerate(fx))
    compare(phase, "golden scalars (max rel)", err, 2e-2)

    # the near-tied chroma tuning argmax, device vs the float64 oracle, on
    # the golden wavs and 30 synthetic clips (reported, not gated)
    from tpu_breath.data import synth
    rng = np.random.default_rng(1)
    ys = np.concatenate([wavs, synth.synth_clips(
        ["E", "I"] * 15, rng).astype(np.float32) / 32768.0])

    @jax.jit
    def tunings(y):
        s512 = sp_ops.stft_mag_cr(y, SPEC.n_fft, SPEC.hop_length)
        s2048 = sp_ops.stft_mag(y, 2048, SPEC.hop_length)[..., ::2]
        t12 = jax.vmap(lambda S: ch_ops.estimate_tuning(
            S, SPEC.sr, SPEC.n_fft, 12))(s512)
        t36 = jax.vmap(lambda S: ch_ops.estimate_tuning(
            S, SPEC.sr, 2048, 36))(s2048)
        return t12, t36

    t12, t36 = map(np.asarray, tunings(ys))
    flips12 = flips36 = 0
    for i, y in enumerate(ys.astype(np.float64)):
        stft_m = np.abs(dsp_np.stft(y, SPEC.n_fft, SPEC.hop_length))
        flips12 += abs(t12[i] - dsp_np.estimate_tuning_from_S(
            stft_m, SPEC.sr, SPEC.n_fft, 12)) > 1e-6
        flips36 += abs(t36[i] - dsp_np.estimate_tuning_from_y(
            y, SPEC.sr, 36)) > 1e-6
    report(phase, tuning_flips_bpo12=f"{flips12}/{len(ys)}",
           tuning_flips_bpo36=f"{flips36}/{len(ys)}")


def phase_synth() -> None:
    from tpu_breath.data import synth
    for d in (ROOT, OUT):
        shutil.rmtree(d, ignore_errors=True)
    synth.write_competition_input(ROOT, N_TRAIN, N_TEST, seed=0)
    n_wav = (len(os.listdir(os.path.join(ROOT, "train")))
             + len(os.listdir(os.path.join(ROOT, "test"))))
    check(n_wav == N_TRAIN + N_TEST, f"{n_wav} wavs written")
    report("c", root=os.path.relpath(ROOT, HERE), wavs=n_wav)


def phase_precompute() -> None:
    import numpy as np
    from tpu_breath.config import Paths
    from tpu_breath.data import dataset as ds
    cli("precompute", "--root", ROOT, "--out-root", OUT)
    store = ds.FeatureStore.load_cache(Paths(root=ROOT).feature_cache)
    check(store.features.shape == (N_TRAIN + N_TEST, 9, 128, 63),
          f"features {store.features.shape}")
    check(store.scalars.shape == (N_TRAIN + N_TEST, 36),
          f"scalars {store.scalars.shape}")
    n_bad = int(np.sum(~np.isfinite(store.features).all(axis=(1, 2, 3))))
    report("d", clips=len(store.ids), clips_with_nonfinite_features=n_bad)


def phase_train() -> dict:
    import numpy as np
    from tpu_breath.data import dataset as ds
    cli("train", "--root", ROOT, "--out-root", OUT, "--archs", "cnn8,vgg",
        "--epochs", "2", "--mesh", "off", "--predict")
    hist = {}
    for arch in ("cnn8", "vgg"):
        hist[arch] = read_history(OUT, arch)
        losses = [r["train_loss"] for r in hist[arch]]
        report("e", arch=arch, train_loss=losses,
               val_acc=[r["val_acc"] for r in hist[arch]])
        check(len(losses) == 2 and all(np.isfinite(losses)),
              f"{arch} losses {losses}")
        ckpts = [d for d in os.listdir(os.path.join(OUT, "checkpoints", arch))
                 if d.startswith("best_epoch")]
        check(bool(ckpts), f"{arch} wrote no checkpoint")
    sub = ds.read_table(os.path.join(OUT, "submissions", "submission.csv"))
    check(len(sub["ID"]) == N_TEST, f"submission has {len(sub['ID'])} rows")
    check(set(sub["Target"]) <= {"E", "I"}, "submission labels")
    report("e", submission_rows=len(sub["ID"]),
           exhale_share=f"{sub['Target'].count('E') / N_TEST:.3f}")
    for arch in ("cnn8", "vgg"):
        m = train_step_memory(arch)
        report("e", arch=arch, memory_analysis_MiB=", ".join(
            f"{k[:-len('_size_in_bytes')]}={getattr(m, k) / 2**20:.1f}"
            for k in dir(m)
            if k.endswith("_size_in_bytes") and not k.startswith("host_")))
    return hist


def train_step_memory(arch: str):
    """compiled.memory_analysis() of the cached train step as `train` builds
    it: batch 512 gathered from the 1,024-row resident train split."""
    import jax
    import jax.numpy as jnp
    from tpu_breath.config import CNN8_TRAIN, VGG_TRAIN
    from tpu_breath.models import registry
    from tpu_breath.train import loop
    cfg = {"cnn8": CNN8_TRAIN, "vgg": VGG_TRAIN}[arch]
    cfg = type(cfg)(**{**cfg.__dict__, "num_epochs": 2})
    model = registry.build(arch, 36)
    state, tx, _ = loop.create_state(model, jax.random.PRNGKey(0), cfg, 2)
    step = loop.make_train_step(model, tx, cfg)
    n = N_TRAIN - -(-N_TRAIN // 5)
    sds = jax.ShapeDtypeStruct
    args = (state, sds((n, 9, 128, 63), jnp.float32),
            sds((n, 36), jnp.float32), sds((n,), jnp.float32),
            sds((cfg.batch_size,), jnp.int32), jax.random.PRNGKey(1),
            sds((), jnp.bool_))
    return step.lower(*args).compile().memory_analysis()


def phase_model_reference() -> None:
    """Each model at real width, batch 8, against a float64 reference on
    the CPU: eval logits, the gradient with BatchNorm in eval mode, and the
    gradient with BatchNorm in train mode.

    Float32 at "highest" precision on the GPU and on the CPU: logits and
    eval-mode gradients within 1e-4 of the reference. The train-mode
    gradient at batch 8 is ill-conditioned (BatchNorm's backward subtracts
    batch means of nearly equal terms), so any float32 evaluation carries
    ~1e-3 there: XLA:CPU's own float32 is printed beside the GPU's, and the
    bound is 2e-3. The default bf16 path's logits: 8 significant bits round
    each conv, dense and BN output at up to 2^-8 = 3.9e-3 relative; VGG
    rounds 16 such layers in series, 6.2e-2 if every rounding added up, and
    the bound is 1e-1 of the largest logit. The
    float32 path at default precision is printed too: on this card a
    float32 product with no stated precision may run in TF32."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from tpu_breath.models import registry
    from tpu_breath.train.loop import bce_with_logits

    cpu, gpu = jax.devices("cpu")[0], jax.devices()[0]
    rng = np.random.default_rng(0)
    data = (rng.standard_normal((8, 9, 128, 63)),
            rng.standard_normal((8, 36)), (np.arange(8) % 2).astype(float))

    def outputs(model, v, f, s, y):
        def grad(train):
            def loss(p):
                z, _ = model.apply({"params": p,
                                    "batch_stats": v["batch_stats"]},
                                   f, s, train=train)
                return bce_with_logits(z, y)
            return jax.grad(loss)(v["params"])
        return {"logits": model.apply(v, f, s)[0], "grad_eval": grad(False),
                "grad_train": grad(True)}

    for arch in ("cnn8", "vgg"):
        variables = registry.build(arch, 36).init(jax.random.PRNGKey(0))

        def run(dtype, device, precision=None):
            model = registry.build(arch, 36, dtype=dtype, dropout_rate=0.0)
            args = jax.tree.map(lambda x: np.asarray(x, dtype),
                                (variables, *data))
            with jax.default_matmul_precision(precision):
                return jax.device_get(jax.jit(
                    lambda *a: outputs(model, *a))(
                        *jax.device_put(args, device)))

        with jax.enable_x64(True):
            ref = run(np.float64, cpu, "highest")
        cpu32 = run(np.float32, cpu, "highest")
        gpu32 = run(np.float32, gpu, "highest")
        tf32 = run(np.float32, gpu)
        bf16 = run(jnp.bfloat16, gpu)
        for key, tol in (("logits", 1e-4), ("grad_eval", 1e-4),
                         ("grad_train", 2e-3)):
            report("f", arch=arch, output=key,
                   cpu_f32_vs_f64=f"{rel_err(cpu32[key], ref[key]):.3e}",
                   gpu_f32_default_precision_vs_f64=
                   f"{rel_err(tf32[key], ref[key]):.3e}")
            compare("f", f"{arch} {key}: gpu f32 vs f64 (rel)",
                    rel_err(gpu32[key], ref[key]), tol)
        compare("f", f"{arch} logits: gpu f32 vs cpu f32 (rel)",
                rel_err(gpu32["logits"], cpu32["logits"]), 1e-4)
        compare("f", f"{arch} logits: gpu bf16 vs f64 (rel)",
                rel_err(bf16["logits"], ref["logits"]), 1e-1)


def phase_serve() -> None:
    """The serve graph (features + both models in one jit, micro-batch 8)
    against the cached-feature ensemble on the same 8 clips. Both run the
    same bf16 models on features from two compilations (batch 8 inside the
    serve graph, chunk 128 in precompute), so they may differ by rounding:
    tolerance 2e-3 absolute in probability."""
    import numpy as np
    from tpu_breath import cli as cli_mod, ensemble
    from tpu_breath.config import DEFAULT_FEATURES, Paths
    from tpu_breath.data import dataset as ds, wav as wav_io

    paths = Paths(root=ROOT, out_root=OUT)
    test_ids = ds.read_table(paths.test_csv)["ID"][:8]
    wav_paths = [os.path.join(paths.test_audio_dir, ds.test_wav_name(i))
                 for i in test_ids]
    printed = cli("predict", "--root", ROOT, "--out-root", OUT,
                  "--from-wav", *wav_paths)
    cli_probs = np.array([float(line.split("\t")[2])
                          for line in printed.splitlines()
                          if line.count("\t") == 2])
    check(len(cli_probs) == 8, f"predict printed {len(cli_probs)} rows")

    archs = ["cnn8", "vgg"]
    ckpts, scores = cli_mod._load_ensemble_ckpts(paths, archs)
    wavs = wav_io.load_wav_batch(wav_paths, DEFAULT_FEATURES.expected_len)
    served = ensemble.serve_from_wav(ckpts, archs, scores, wavs)
    store = ds.FeatureStore.load_cache(paths.feature_cache).subset(test_ids)
    cached = ensemble.weighted_ensemble(ckpts, archs, scores,
                                        np.asarray(store.features),
                                        np.asarray(store.scalars), 36)
    compare("g", "predict --from-wav printed probs vs serve graph (abs)",
            float(np.max(np.abs(cli_probs - served))), 5.1e-5)
    compare("g", "serve graph vs cached-feature ensemble (abs)",
            float(np.max(np.abs(served - cached))), 2e-3)


def phase_fused(cached_hist: dict) -> None:
    import numpy as np
    out = OUT + "_fused"
    shutil.rmtree(out, ignore_errors=True)
    cli("train", "--root", ROOT, "--out-root", out, "--fused", "--archs",
        "cnn8", "--epochs", "1", "--mesh", "off")
    fused = read_history(out, "cnn8")[0]
    cached = cached_hist["cnn8"][0]
    check(np.isfinite(fused["train_loss"]), f"fused loss {fused}")
    # Epoch 1 of a 1-epoch and of a 2-epoch run share their learning rates
    # (no warmup at 4 steps; both start at the base rate), so the train
    # loss and accuracy of epoch 1 are comparable.
    report("h", fused_train_loss=fused["train_loss"],
           cached_train_loss=cached["train_loss"],
           loss_diff=f"{abs(fused['train_loss'] - cached['train_loss']):.3e}",
           acc_diff=f"{abs(fused['train_acc'] - cached['train_acc']):.3e}",
           identical=fused["train_loss"] == cached["train_loss"]
           and fused["train_acc"] == cached["train_acc"])


def phase_four_cards() -> None:
    """Data-parallel precompute and training over 4 cards against one."""
    import numpy as np
    from tpu_breath.config import Paths
    from tpu_breath.data import dataset as ds
    root4 = ROOT + "_mesh4"
    shutil.rmtree(root4, ignore_errors=True)
    os.makedirs(root4)
    for name in ("train", "test", "train.csv", "test.csv"):
        os.symlink(os.path.join(ROOT, name), os.path.join(root4, name))
    cli("precompute", "--root", ROOT, "--out-root", OUT, "--mesh", "off")
    cli("precompute", "--root", root4, "--out-root", OUT, "--mesh", "4")
    one = ds.FeatureStore.load_cache(Paths(root=ROOT).feature_cache)
    four = ds.FeatureStore.load_cache(Paths(root=root4).feature_cache)
    check(one.ids == four.ids, "clip order differs")
    n_diff = int(np.sum(np.asarray(one.features) != np.asarray(four.features)))
    report("4", precompute_channel_elements_differing=n_diff)
    check(n_diff == 0, "mesh-4 channels are not bit-identical")
    s1, s4 = np.asarray(one.scalars), np.asarray(four.scalars)
    ratio = float(np.max(np.abs(s4 - s1) / (2e-6 + 1e-6 * np.abs(s1))))
    compare("4", "mesh-4 scalars: max |d| / (2e-6 + 1e-6 |x|)", ratio, 1.0)

    hist = {}
    for mesh in ("off", "4"):
        out = f"{OUT}_mesh_{mesh}"
        shutil.rmtree(out, ignore_errors=True)
        cli("train", "--root", ROOT, "--out-root", out, "--archs", "cnn8",
            "--f32", "--epochs", "2", "--batch-size", "512", "--seed", "0",
            "--mesh", mesh)
        hist[mesh] = read_history(out, "cnn8")
        report("4", mesh=mesh,
               train_loss=[r["train_loss"] for r in hist[mesh]],
               val_loss=[r["val_loss"] for r in hist[mesh]])
    for r1, r4 in zip(hist["off"], hist["4"], strict=True):
        compare("4", f"epoch {r1['epoch']} train_loss mesh 4 vs off",
                abs(r1["train_loss"] - r4["train_loss"]), 1e-3)
        compare("4", f"epoch {r1['epoch']} val_loss mesh 4 vs off",
                abs(r1["val_loss"] - r4["val_loss"]), 1e-3)
        check(r1["train_acc"] == r4["train_acc"], "train_acc differs")
        check(r1["lr"] == r4["lr"], "lr differs")


# ------------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "tpu_breath")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        card = gpu_name_and_power()
    except (OSError, subprocess.SubprocessError) as e:
        print(f"no NVIDIA GPU: nvidia-smi failed ({e})", file=sys.stderr)
        return 1
    from tpu_breath.utils import compile_cache
    try:
        cache_dir = os.environ.get(compile_cache.ENV) or \
            compile_cache.default_dir()
        if args.devices == 1:
            phase_gpu_tests(cache_dir)  # before this process opens the card
        compile_cache.configure()
        import jax
        device = check_device(jax.devices())
        check(device["count"] == args.devices,
              f"run for {args.devices} GPU(s), {device['count']} present")
        print(card, flush=True)
        report("setup", jax=jax.__version__, device=device["kind"],
               count=device["count"], compile_cache=cache_dir)
        clock = CompileClock()
        if args.devices == 4:
            with clock.phase("c"):
                phase_synth()
            with clock.phase("4"):
                phase_four_cards()
        else:
            with clock.phase("b"):
                phase_golden()
            with clock.phase("c"):
                phase_synth()
            with clock.phase("d"):
                phase_precompute()
            with clock.phase("e"):
                hist = phase_train()
            with clock.phase("f"):
                phase_model_reference()
            with clock.phase("g"):
                phase_serve()
            with clock.phase("h"):
                phase_fused(hist)
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
