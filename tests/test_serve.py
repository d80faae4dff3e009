"""The cache-free serving surface: `predict --from-wav` and
ensemble.serve_from_wav — one jitted wav->features->ensemble graph
(replaces the reference's per-clip librosa loop + torch ensemble,
src/precompute/process.py:25 + src/utils/ensemble.py:49)."""
import numpy as np
import pytest

from tpu_breath import ensemble
from tpu_breath.cli import build_parser
from tpu_breath.config import DEFAULT_FEATURES as SPEC, TrainCfg


def _write_pcm16(path, samples, sr=16000):
    import wave
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(samples, -1, 1) * 32767).astype("<i2")
                      .tobytes())


def test_from_wav_flag_parses():
    p = build_parser()
    a = p.parse_args(["predict", "--from-wav", "a.wav", "b.wav"])
    assert a.from_wav == ["a.wav", "b.wav"]
    a = p.parse_args(["predict"])
    assert a.from_wav is None


def test_serve_from_wav_matches_cached_ensemble(tmp_path):
    """serve_from_wav (fused wav->features->models graph, padded tail
    micro-batch) must agree with the cached-feature weighted_ensemble on the
    same clips and checkpoints."""
    import jax
    import jax.numpy as jnp
    from tpu_breath.data import wav as wav_io
    from tpu_breath.features import extract_features
    from tpu_breath.models import registry
    from tpu_breath.train import checkpoint as ckpt_lib
    from tpu_breath.train.loop import create_state

    rng = np.random.default_rng(7)
    paths = []
    for i in range(3):  # 3 clips, micro_batch=2 -> exercises tail padding
        p = tmp_path / f"clip{i}.wav"
        _write_pcm16(p, rng.standard_normal(16000) * 0.05)
        paths.append(str(p))
    wavs = wav_io.load_wav_batch(paths, SPEC.expected_len)

    ckpts, archs, scores = [], [], []
    for i in range(2):
        model = registry.build("cnn8", SPEC.n_scalars)
        state, _, _ = create_state(model, jax.random.PRNGKey(i), TrainCfg(), 1)
        ckpts.append(ckpt_lib.save(str(tmp_path / f"m{i}"), state, 1,
                                   {"val_acc": 0.7 + 0.05 * i}))
        archs.append("cnn8")
        scores.append(0.7 + 0.05 * i)

    probs = ensemble.serve_from_wav(ckpts, archs, scores, wavs, SPEC,
                                    micro_batch=2)
    assert probs.shape == (3,)
    assert np.all((probs > 0) & (probs < 1))

    feats, scals = jax.jit(lambda w: extract_features(w, SPEC))(
        jnp.asarray(wavs))
    expect = ensemble.weighted_ensemble(ckpts, archs, scores,
                                        np.asarray(feats), np.asarray(scals),
                                        SPEC.n_scalars, batch_size=3)
    # same checkpoints, same math; the serve graph blends on device in f32
    # while weighted_ensemble accumulates on host in f64
    np.testing.assert_allclose(probs, expect, atol=5e-6)
