"""Fused wav->train mode: the feature graph runs inside the jitted train step
(BASELINE.json config #5) and must match the cached-features step."""
import numpy as np
import jax
import jax.numpy as jnp

from tpu_breath.config import FeatureSpec, TrainCfg
from tpu_breath.models.cnn8 import CNN8
from tpu_breath.augment import Batch
from tpu_breath.features import extract_features
from tpu_breath.train.loop import create_state, make_train_step

SPEC = FeatureSpec()


def test_fused_step_matches_cached_features(real_clips):
    b = 4
    wavs = jnp.asarray(real_clips[:b])
    labels = jnp.asarray(np.array([0, 1, 0, 1], np.float32))
    cfg = TrainCfg(num_epochs=1, batch_size=b, warmup_epochs=99)  # aug off
    model = CNN8(num_scalar_features=SPEC.n_scalars, dropout_rate=0.0,
                 dtype=jnp.float32)

    feats, scals = jax.jit(lambda w: extract_features(w, SPEC))(wavs)
    idx = jnp.arange(b)
    key = jax.random.PRNGKey(0)

    state_c, tx, _ = create_state(model, jax.random.PRNGKey(1), cfg, 1)
    step_cached = make_train_step(model, tx, cfg)
    _, stats_c = step_cached(state_c, feats, scals, labels, idx, key,
                             jnp.asarray(False))

    state_f, tx2, _ = create_state(model, jax.random.PRNGKey(1), cfg, 1)
    step_fused = make_train_step(model, tx2, cfg, fused_spec=SPEC)
    dummy_scals = jnp.zeros((b, 0), jnp.float32)
    _, stats_f = step_fused(state_f, wavs, dummy_scals, labels, idx, key,
                            jnp.asarray(False))

    assert abs(float(stats_c["loss"]) - float(stats_f["loss"])) < 1e-5
    assert float(stats_c["acc"]) == float(stats_f["acc"])


def test_fused_fit_history_identical_to_cached(real_clips, tmp_path):
    """The production-scale property observed in the round-3 sweeps
    (results/sweep: every fused_* history equals its cached_* counterpart on
    every metric at every epoch), pinned at test scale: fit() in fused mode
    and cached mode at the same seed produce IDENTICAL histories. Holds
    because the in-step feature graph reproduces the precompute graph
    bit-for-bit and all per-epoch randomness is fold_in(seed, epoch)-derived
    (pure function of the config, not of the input layout)."""
    import jax
    from tpu_breath.train import loop

    wavs = np.tile(np.asarray(real_clips), (4, 1))          # 16 clips
    labels = np.tile(np.array([0, 1, 1, 0], np.float32), 4)
    feats, scals = jax.jit(lambda w: extract_features(w, SPEC))(
        jnp.asarray(wavs))
    feats, scals = np.asarray(feats), np.asarray(scals)
    cfg = TrainCfg(num_epochs=3, base_lr=1e-3, batch_size=8,
                   eval_batch_size=8, warmup_epochs=1,  # aug ON from epoch 1
                   patience=99, seed=3)
    mk = lambda: CNN8(num_scalar_features=SPEC.n_scalars, dtype=jnp.float32)

    res_c = loop.fit(mk(), (feats, scals), (feats, scals), labels, labels,
                     cfg, save_dir=None, log_fn=lambda *_: None)
    res_f = loop.fit(mk(), (wavs, None), (feats, scals), labels, labels,
                     cfg, save_dir=None, log_fn=lambda *_: None,
                     fused_spec=SPEC)

    assert len(res_c.history) == len(res_f.history) == 3
    for rc, rf in zip(res_c.history, res_f.history):
        for k in rc:
            if k == "sec":
                continue
            assert rc[k] == rf[k], (k, rc, rf)


def test_fused_step_mesh_matches_single(real_clips):
    """Fused wav->train under a 4-device mesh (the streamed-batch step,
    train --fused --mesh) vs the single-device fused step: same loss/acc and
    the same parameter update (documented f32 reduction-order escape hatch,
    as in tests/test_parallel.py)."""
    from tpu_breath.parallel import mesh as mesh_lib
    from tpu_breath.train.loop import make_train_step_batched

    b = 4
    wavs = jnp.asarray(real_clips[:b])
    labels = jnp.asarray(np.array([0, 1, 0, 1], np.float32))
    cfg = TrainCfg(num_epochs=1, batch_size=b, warmup_epochs=99)  # aug off
    model = CNN8(num_scalar_features=SPEC.n_scalars, dropout_rate=0.0,
                 dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    dummy_scals = jnp.zeros((b, 0), jnp.float32)

    state1, tx1, _ = create_state(model, jax.random.PRNGKey(1), cfg, 1)
    step1 = make_train_step(model, tx1, cfg, fused_spec=SPEC)
    new1, stats1 = step1(state1, wavs, dummy_scals, labels, jnp.arange(b),
                         key, jnp.asarray(False))

    mesh = mesh_lib.make_mesh(jax.devices()[:4])
    state4, tx4, _ = create_state(model, jax.random.PRNGKey(1), cfg, 1)
    state4 = jax.device_put(state4, mesh_lib.replicated(mesh))
    step4 = make_train_step_batched(model, tx4, cfg, mesh, fused_spec=SPEC)
    batch = Batch(jax.device_put(wavs, mesh_lib.data_sharding(mesh)), None,
                  jax.device_put(labels, mesh_lib.data_sharding(mesh)))
    new4, stats4 = step4(state4, batch, key, jnp.asarray(False))

    assert abs(float(stats1["loss"]) - float(stats4["loss"])) < 1e-5
    assert float(stats1["acc"]) == float(stats4["acc"])
    p1 = np.concatenate([np.ravel(jax.device_get(x))
                         for x in jax.tree.leaves(new1.params)])
    p4 = np.concatenate([np.ravel(jax.device_get(x))
                         for x in jax.tree.leaves(new4.params)])
    assert np.max(np.abs(p1 - p4)) < 3 * cfg.base_lr
    # Same escape hatch as tests/test_parallel.py: XLA:CPU conv reductions
    # are thread-nondeterministic at the ulp level, and Adam's first step
    # turns a sign-fragile near-zero gradient into a full +/-lr move. Bound
    # the fraction of meaningfully-different params instead of bit equality.
    mismatched = np.abs(p1 - p4) > 1e-4
    assert mismatched.mean() < 1e-3, mismatched.mean()


def test_fused_chunked_map_matches_precompute(real_clips):
    """The b > fused_chunk branch of _maybe_fused_features (lax.map over
    chunk slices — the PRODUCTION layout at batch 512 / chunk 128) must
    reproduce the standalone per-chunk precompute graph bit-for-bit. The
    round-4 regression lived exactly here: XLA reassociated the
    16,000-sample skew/kurtosis reductions inside the lax.map body but not
    in the standalone jit, silently desyncing fused from cached training at
    the 4th decimal (tools/fused_identity_probe.py; fixed by
    ops/scalars._row_sum_stable)."""
    from tpu_breath.train.loop import _maybe_fused_features

    b, chunk = 4, 2
    wavs = jnp.asarray(real_clips[:b])
    labels = jnp.asarray(np.array([0, 1, 0, 1], np.float32))

    # standalone graph at chunk geometry, as precompute dispatches it
    ref_f, ref_s = [], []
    ext = jax.jit(lambda w: extract_features(w, SPEC))
    for lo in range(0, b, chunk):
        f, s = ext(wavs[lo:lo + chunk])
        ref_f.append(np.asarray(f))
        ref_s.append(np.asarray(s))
    ref_f, ref_s = np.concatenate(ref_f), np.concatenate(ref_s)

    out = jax.jit(lambda w: _maybe_fused_features(
        Batch(w, None, labels), SPEC, chunk))(wavs)
    np.testing.assert_array_equal(np.asarray(out.features), ref_f)
    np.testing.assert_array_equal(np.asarray(out.scalars), ref_s)
