"""Locate WHERE fused-context feature numerics diverge from the standalone
feature graph (round-4 regression hunt).

Round 3 proved fused-from-wav training bit-identical to cached-feature
training at seeds 0-4. The round-4 sweep on the current stack
(results/sweep_r4/) shows cached and fused VGG histories diverging from
epoch 1 at the 4th decimal — i.e. the train features computed INSIDE the
fused step no longer bit-match the precompute graph's output. This probe
compares, on the real backend with real clips:

  A. extract_features_batched(wavs, chunk=128)      (the precompute graph)
  B. jit(lax.map(extract_features, 128-chunks))     (the fused step's feature
                                                     sub-layout, no training)
  C. the features materialized by running the REAL fused train step with an
     instrumented loss that returns them (same enclosing graph as training)
  D. variant of C with lax.optimization_barrier around the feature
     subgraph's output (the candidate fix)

and prints per-channel + scalar max |Δ| for each pair. Whichever pair first
shows a nonzero delta names the guilty compilation context.

Usage: python tools/fused_identity_probe.py [--n 128]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _delta(name, a, b, spec):
    a = np.asarray(a)
    b = np.asarray(b)
    if a.shape != b.shape:
        print(f"  {name}: SHAPE MISMATCH {a.shape} vs {b.shape}")
        return
    d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    if a.ndim == 4:  # [B, C, F, T] channels
        for c, ch in enumerate(spec.channel_order):
            m = float(d[:, c].max())
            flag = "" if m == 0.0 else "   <-- DIFFERS"
            print(f"  {name}/{ch:10s} max|D| {m:.3e}{flag}")
    else:
        m = float(d.max())
        flag = "" if m == 0.0 else "   <-- DIFFERS"
        print(f"  {name}: max|D| {m:.3e}{flag}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)  # production batch: the
    # b > fused_chunk branch of _maybe_fused_features (lax.map over chunks)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from jax import lax
    from tpu_breath.augment import Batch
    from tpu_breath.config import DEFAULT_FEATURES as SPEC, CNN8_TRAIN
    from tpu_breath.data import dataset as ds, wav as wav_io
    from tpu_breath.config import Paths
    from tpu_breath.features import extract_features, extract_features_batched
    from tpu_breath.models.cnn8 import CNN8
    from tpu_breath.train import loop as train_loop

    paths = Paths(root="input")
    ids = ds.load_tables(paths)[0]["ID"][:args.n]
    wav_paths = [os.path.join(paths.train_audio_dir, ds.train_wav_name(i))
                 for i in ids]
    wavs = wav_io.load_wav_batch(wav_paths, SPEC.expected_len)
    labels = np.tile([0.0, 1.0], args.n // 2).astype(np.float32)
    x = jnp.asarray(wavs)
    chunk = 128
    nck = args.n // chunk

    print(f"[A] precompute graph (extract_features_batched, chunk={chunk})")
    fa, sa = extract_features_batched(wavs, SPEC, chunk=chunk)

    print("[B] bare lax.map fused sub-layout")
    @jax.jit
    def bare_map(w):
        c = w.reshape(nck, chunk, -1)
        f, s = lax.map(lambda y: extract_features(y, SPEC), c)
        return f.reshape(args.n, *f.shape[2:]), s.reshape(args.n, *s.shape[2:])
    fb, sb = bare_map(x)
    fb, sb = np.asarray(fb), np.asarray(sb)
    _delta("A-vs-B feats", fa, fb, SPEC)
    _delta("A-vs-B scalars", sa, sb, SPEC)

    # C: the real fused train step, instrumented to ALSO return the features
    # it computed. loop._maybe_fused_features is the exact production helper.
    cfg = type(CNN8_TRAIN)(**{**CNN8_TRAIN.__dict__, "batch_size": args.n})
    model = CNN8(num_scalar_features=SPEC.n_scalars)
    state, tx, _ = train_loop.create_state(
        model, jax.random.PRNGKey(0), cfg, steps_per_epoch=8)
    key = jax.random.PRNGKey(1)
    use_aug = jnp.asarray(False)  # epoch-1 semantics: augmentation off

    # cached core: instrumented = _maybe_fused_features + cached core, which
    # is exactly what _make_batch_core(fused_spec=SPEC) inlines — same graph,
    # plus the feature arrays as extra outputs.
    core = train_loop._make_batch_core(model, tx, cfg, None, None, chunk)

    def instrumented(st, batch, k, u, barrier):
        fb_ = train_loop._maybe_fused_features(batch, SPEC, chunk)
        if barrier:
            f, s = lax.optimization_barrier((fb_.features, fb_.scalars))
            fb_ = Batch(f, s, fb_.labels)
        new_state, stats = core(st, Batch(fb_.features, fb_.scalars,
                                          fb_.labels), k, u)
        return new_state, stats, fb_.features, fb_.scalars

    inst = jax.jit(instrumented, static_argnums=(4,))
    for barrier, tag in ((False, "C (fused step context)"),
                         (True, "D (fused step + optimization_barrier)")):
        print(f"[{tag}]")
        _, _, fc, sc = inst(state, Batch(x, None, jnp.asarray(labels)),
                            key, use_aug, barrier)
        _delta("A-vs feats", fa, np.asarray(fc), SPEC)
        _delta("A-vs scalars", sa, np.asarray(sc), SPEC)

    # E: step-level check — does the cached step on A's features produce the
    # same updated params as the production (un-instrumented) fused step?
    cached_step = train_loop.make_train_step_batched(model, tx, cfg)
    fused_step = train_loop.make_train_step_batched(model, tx, cfg,
                                                    fused_spec=SPEC,
                                                    fused_chunk=chunk)
    import jax.tree_util as jtu
    st_c, stats_c = cached_step(jax.tree.map(jnp.copy, state),
                                Batch(jnp.asarray(fa), jnp.asarray(sa),
                                      jnp.asarray(labels)), key, use_aug)
    st_f, stats_f = fused_step(jax.tree.map(jnp.copy, state),
                               Batch(x, None, jnp.asarray(labels)),
                               key, use_aug)
    dmax = max(float(np.abs(np.asarray(a, np.float64) -
                            np.asarray(b, np.float64)).max())
               for a, b in zip(jtu.tree_leaves(st_c.params),
                               jtu.tree_leaves(st_f.params)))
    print(f"[E] cached-vs-fused one-step params max|D| {dmax:.3e}  "
          f"loss D {abs(float(stats_c['loss']) - float(stats_f['loss'])):.3e}")


if __name__ == "__main__":
    main()
