"""Training-engine tests: schedule parity, augmentation semantics, a 32-clip
smoke train (loss decreases, early stopping, checkpoint roundtrip) — the test
strategy the reference lacks (SURVEY.md §4)."""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tpu_breath.config import TrainCfg
from tpu_breath.augment import Batch, cutmix, mixup, apply_augmentation
from tpu_breath.train.schedule import warmup_cosine
from tpu_breath.train import loop, metrics
from tpu_breath.models.cnn8 import CNN8


# ------------------------------------------------------------------ schedule

def test_schedule_matches_torch_sequential_lr():
    """LinearLR(0.1 -> 1.0 over W) then CosineAnnealing(T_max=T-W, eta_min),
    stepped per batch (reference src/train.py:41-50)."""
    base, total = 4e-4, 600
    w = int(0.05 * total)
    sched = warmup_cosine(base, total)
    # torch reference semantics computed directly
    for step in [0, 1, w // 2, w - 1, w, w + 1, total // 2, total - 1]:
        if step < w:
            expect = base * (0.1 + 0.9 * step / w)
        else:
            t = step - w
            expect = 1e-6 + (base - 1e-6) * 0.5 * (
                1 + np.cos(np.pi * t / (total - w)))
        got = float(sched(step))
        assert abs(got - expect) < 1e-9, (step, got, expect)


# -------------------------------------------------------------- augmentation

def _toy_batch(b=16):
    rng = np.random.default_rng(0)
    return Batch(jnp.asarray(rng.standard_normal((b, 9, 128, 63)), jnp.float32),
                 jnp.asarray(rng.standard_normal((b, 36)), jnp.float32),
                 jnp.asarray(rng.integers(0, 2, b), jnp.float32))


def test_cutmix_leaves_scalars_and_mixes_labels():
    batch = _toy_batch()
    out = jax.jit(lambda k, bt: cutmix(k, bt, 1.0))(jax.random.PRNGKey(0), batch)
    np.testing.assert_array_equal(np.asarray(out.scalars),
                                  np.asarray(batch.scalars))  # D6 semantics
    labels = np.asarray(out.labels)
    assert labels.min() >= 0.0 and labels.max() <= 1.0
    # features changed somewhere inside a box
    assert not np.array_equal(np.asarray(out.features),
                              np.asarray(batch.features))


def test_cutmix_label_weight_matches_box_area():
    batch = _toy_batch()
    out = jax.jit(lambda k, bt: cutmix(k, bt, 1.0))(jax.random.PRNGKey(7), batch)
    # reconstruct lambda from how many pixels changed in one channel
    changed = (np.asarray(out.features[:, 0]) !=
               np.asarray(batch.features[:, 0]))
    frac = changed[0].mean()  # box is identical across the batch
    lam = 1 - frac
    y0 = np.asarray(batch.labels)
    # find the permutation partner effect: out = lam*y + (1-lam)*y[perm]
    y1 = np.asarray(out.labels)
    resid = y1 - lam * y0
    # residuals must be (1-lam) * some 0/1 labels
    vals = np.unique(np.round(resid / max(1 - lam, 1e-9), 5))
    assert np.all(np.isin(vals, [0.0, 1.0]))


def test_mixup_mixes_scalars_too():
    batch = _toy_batch()
    out = jax.jit(lambda k, bt: mixup(k, bt, 0.2))(jax.random.PRNGKey(1), batch)
    assert not np.array_equal(np.asarray(out.scalars),
                              np.asarray(batch.scalars))


def test_augmentation_gate():
    batch = _toy_batch()
    fn = jax.jit(lambda k, bt, g: apply_augmentation(k, bt, g, 0.6, 0.4, 1.0, 0.2))
    out = fn(jax.random.PRNGKey(2), batch, jnp.asarray(False))
    np.testing.assert_array_equal(np.asarray(out.features),
                                  np.asarray(batch.features))
    # with cutmix_prob+mixup_prob = 1.0 the batch is always mixed when gated on
    out = fn(jax.random.PRNGKey(2), batch, jnp.asarray(True))
    assert not np.array_equal(np.asarray(out.features),
                              np.asarray(batch.features))


# ------------------------------------------------------------------- metrics

def test_metrics_against_sklearn():
    rng = np.random.default_rng(3)
    probs = rng.random(500)
    labels = (rng.random(500) < probs).astype(np.float64)  # correlated
    m = metrics.binary_metrics(probs, labels)
    from sklearn.metrics import (roc_auc_score, accuracy_score,
                                 precision_score, recall_score, f1_score)
    preds = probs > 0.5
    assert abs(m["auc"] - roc_auc_score(labels, probs)) < 1e-9
    assert abs(m["acc"] - accuracy_score(labels, preds)) < 1e-12
    assert abs(m["precision"] - precision_score(labels, preds)) < 1e-12
    assert abs(m["recall"] - recall_score(labels, preds)) < 1e-12
    assert abs(m["f1"] - f1_score(labels, preds)) < 1e-9


# ---------------------------------------------------------------- smoke train

@pytest.fixture(scope="module")
def toy_data():
    """32 separable synthetic clips: class decides the sign of a feature blob."""
    rng = np.random.default_rng(42)
    n = 32
    labels = (np.arange(n) % 2).astype(np.float32)
    feats = rng.standard_normal((n, 9, 128, 63)).astype(np.float32) * 0.1
    feats += labels[:, None, None, None] * 2.0
    scals = rng.standard_normal((n, 36)).astype(np.float32)
    scals[:, 0] = labels * 3.0
    return feats, scals, labels


def test_smoke_train_loss_decreases_and_ckpt_roundtrip(toy_data, tmp_path):
    feats, scals, labels = toy_data
    # enough steps for the BatchNorm running stats (momentum 0.9) to converge
    # toward batch statistics — eval-mode accuracy depends on them
    cfg = TrainCfg(num_epochs=25, base_lr=1e-3, batch_size=16,
                   eval_batch_size=16, warmup_epochs=99,  # aug off
                   patience=99, seed=0)
    model = CNN8(num_scalar_features=36, dropout_rate=0.0)
    res = loop.fit(model, (feats, scals), (feats, scals), labels, labels,
                   cfg, save_dir=str(tmp_path / "ckpt"), log_fn=lambda *_: None)
    losses = [r["train_loss"] for r in res.history]
    assert losses[-1] < losses[0], losses
    assert res.best_val_acc > 0.6
    assert res.best_ckpt_path and os.path.isdir(res.best_ckpt_path)

    # checkpoint roundtrip: restored params produce identical eval logits
    from tpu_breath.train import checkpoint as ckpt_lib
    restored = ckpt_lib.restore(res.best_ckpt_path, res.best_state)
    ev = loop.make_eval_step(model)
    idx = jnp.arange(16)
    a = np.asarray(ev(res.best_state, jnp.asarray(feats), jnp.asarray(scals), idx))
    b = np.asarray(ev(restored, jnp.asarray(feats), jnp.asarray(scals), idx))
    np.testing.assert_allclose(a, b, rtol=0, atol=0)


def test_early_stopping_stops(toy_data, tmp_path):
    feats, scals, labels = toy_data
    cfg = TrainCfg(num_epochs=50, base_lr=0.0, batch_size=16,
                   eval_batch_size=16, warmup_epochs=99, patience=2, seed=0)
    model = CNN8(num_scalar_features=36, dropout_rate=0.0)
    res = loop.fit(model, (feats, scals), (feats, scals), labels, labels,
                   cfg, save_dir=None, log_fn=lambda *_: None)
    # near-zero lr (schedule floor is eta_min) -> improvements dry up fast and
    # patience cuts the run well short of num_epochs
    assert len(res.history) < cfg.num_epochs


def test_resume_matches_uninterrupted(toy_data, tmp_path):
    """Kill a run mid-training; the resumed run's history must equal the
    uninterrupted run's, epoch for epoch — requires stateless per-epoch RNG
    (fold_in/seeded-per-epoch) and early-stop bookkeeping restored from the
    checkpoint (reference early-stop semantics
    src/train.py:142-171)."""
    feats, scals, labels = toy_data
    cfg = TrainCfg(num_epochs=10, base_lr=1e-3, batch_size=16,
                   eval_batch_size=16, warmup_epochs=2,  # aug ON from epoch 3
                   patience=99, seed=3)
    model = CNN8(num_scalar_features=36, dropout_rate=0.0)

    full = loop.fit(model, (feats, scals), (feats, scals), labels, labels,
                    cfg, save_dir=str(tmp_path / "full"),
                    log_fn=lambda *_: None)

    class Killed(Exception):
        pass

    seen = [0]

    def crash_after_6(msg):
        seen[0] += 1
        if seen[0] >= 6:
            raise Killed

    with pytest.raises(Killed):
        loop.fit(model, (feats, scals), (feats, scals), labels, labels,
                 cfg, save_dir=str(tmp_path / "part"), log_fn=crash_after_6)

    resumed = loop.fit(model, (feats, scals), (feats, scals), labels, labels,
                       cfg, save_dir=str(tmp_path / "part"), resume=True,
                       log_fn=lambda *_: None)

    by_epoch = {r["epoch"]: r for r in full.history}
    assert resumed.history, "resume should replay at least one epoch"
    assert resumed.history[0]["epoch"] > 1, "resume should not restart at 0"
    for row in resumed.history:
        ref = by_epoch[row["epoch"]]
        for k in ("train_loss", "train_acc", "val_loss", "val_acc", "lr"):
            assert row[k] == ref[k], (row["epoch"], k, row[k], ref[k])
    assert resumed.best_val_acc == full.best_val_acc


def test_latest_checkpoint_skips_interrupted_save(tmp_path):
    """metadata.json is written LAST in checkpoint.save(); a directory
    without it is a save that died mid-write and must be skipped so
    resume/predict fall back to the newest INTACT checkpoint."""
    from tpu_breath.train import checkpoint as ckpt_lib

    good = tmp_path / "best_epoch003"
    good.mkdir()
    (good / "metadata.json").write_text('{"epoch": 3, "val_acc": 0.7}')
    partial = tmp_path / "best_epoch007"  # newer, but no metadata.json
    partial.mkdir()

    assert ckpt_lib.latest_checkpoint(str(tmp_path)) == str(good)
    # only partial dirs -> behave like no checkpoint at all
    (good / "metadata.json").unlink()
    assert ckpt_lib.latest_checkpoint(str(tmp_path)) is None


def test_checkpoint_npz_roundtrips_full_state(tmp_path):
    """save -> restore reproduces every leaf of the TrainState, optimizer
    moments and step included, with its dtype and the state's structure;
    a checkpoint of another shape is refused."""
    from tpu_breath.train import checkpoint as ckpt_lib

    cfg = TrainCfg(num_epochs=1, batch_size=4, warmup_epochs=99)
    model = CNN8(num_scalar_features=36, dropout_rate=0.0)
    state, tx, _ = loop.create_state(model, jax.random.PRNGKey(0), cfg, 1)
    batch = _toy_batch(4)
    state, _ = loop.make_train_step(model, tx, cfg)(
        state, batch.features, batch.scalars, batch.labels, jnp.arange(4),
        jax.random.PRNGKey(1), jnp.asarray(False))
    path = ckpt_lib.save(str(tmp_path), state, 1, {"val_acc": 0.5})
    fresh, _, _ = loop.create_state(model, jax.random.PRNGKey(9), cfg, 1)
    restored = ckpt_lib.restore(path, fresh)

    assert (jax.tree_util.tree_structure(restored)
            == jax.tree_util.tree_structure(state))
    assert int(restored.step) == 1
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    mu = restored.opt_state[1][0].mu  # clip -> adamw's scale_by_adam state
    assert any(np.any(x != 0) for x in jax.tree.leaves(mu))
    assert ckpt_lib.restore_latest(str(tmp_path), fresh)[1] == 1

    other = CNN8(num_scalar_features=12, dropout_rate=0.0)
    wrong, _, _ = loop.create_state(other, jax.random.PRNGKey(0), cfg, 1)
    with pytest.raises(ValueError, match="expected"):
        ckpt_lib.restore(path, wrong)
