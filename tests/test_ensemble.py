"""Ensemble math + submission format (reference src/utils/ensemble.py:49-74,
src/scripts.py:62-69)."""
import numpy as np

from tpu_breath import ensemble


def test_softmax_weights():
    w = ensemble.softmax_weights([0.78, 0.79])
    assert abs(w.sum() - 1.0) < 1e-12
    assert w[1] > w[0]
    e = np.exp([0.78, 0.79])
    np.testing.assert_allclose(w, e / e.sum())


def test_sum_normalized_weights():
    w = ensemble.softmax_weights([1.0, 3.0], use_softmax=False)
    np.testing.assert_allclose(w, [0.25, 0.75])


def test_write_submission(tmp_path):
    out = tmp_path / "sub.csv"
    ids = ["a.wav", "b.wav", "c.wav"]
    probs = np.array([0.9, 0.5, 0.2])  # exactly 0.5 -> 'I' (strict >)
    df = ensemble.write_submission(ids, probs, str(out))
    assert list(df["Target"]) == ["E", "I", "I"]
    lines = out.read_text().splitlines()
    assert lines[0] == "ID,Target"
    assert lines[1] == "a.wav,E"


def test_weighted_ensemble_blends_models(tmp_path):
    """Two trained-for-zero-steps models with known weights: the ensemble
    probability must be the weighted mean of the individual sigmoids."""
    import jax
    from tpu_breath.config import TrainCfg
    from tpu_breath.models import registry
    from tpu_breath.train.loop import create_state
    from tpu_breath.train import checkpoint as ckpt_lib

    rng = np.random.default_rng(0)
    feats = rng.standard_normal((6, 9, 16, 8)).astype(np.float32)
    scals = rng.standard_normal((6, 36)).astype(np.float32)
    ckpts, archs = [], []
    for i, arch in enumerate(["cnn8", "cnn8"]):
        model = registry.build(arch, 36)
        state, _, _ = create_state(model, jax.random.PRNGKey(i), TrainCfg(), 1)
        path = ckpt_lib.save(str(tmp_path / f"m{i}"), state, 1,
                             {"val_acc": 0.7 + 0.05 * i})
        ckpts.append(path)
        archs.append(arch)
    probs = ensemble.weighted_ensemble(ckpts, archs, [0.7, 0.75], feats,
                                       scals, 36, batch_size=6)
    # reconstruct from the individual models
    w = ensemble.softmax_weights([0.7, 0.75])
    expect = np.zeros(6)
    for path, arch, wi in zip(ckpts, archs, w):
        model, state = ensemble.load_model_state(path, arch, 36)
        expect += wi * ensemble.predict_probs(model, state, feats, scals,
                                              batch_size=6)
    np.testing.assert_allclose(probs, expect, atol=1e-7)
    assert np.all((probs > 0) & (probs < 1))
