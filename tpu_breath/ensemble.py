"""Validation-accuracy-weighted sigmoid ensemble + submission writer.

Rebuild of reference src/utils/ensemble.py:49-74 and the submission logic of
src/scripts.py:62-69: weights = softmax(val accuracies) (or sum-normalized),
per-batch weighted sum of each model's sigmoid probabilities, threshold 0.5,
'E'/'I' labels. Inference is a jitted batched apply per model; the test set
lives on device once.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from tpu_breath.data import dataset as ds
from tpu_breath.models import registry
from tpu_breath.train import checkpoint as ckpt_lib
from tpu_breath.train.loop import TrainState, create_state, make_eval_step
from tpu_breath.config import TrainCfg


def softmax_weights(val_scores, use_softmax: bool = True) -> np.ndarray:
    w = np.asarray(val_scores, np.float64)
    if use_softmax:
        e = np.exp(w - w.max())
        return e / e.sum()
    return w / w.sum()


def predict_probs(model, state: TrainState, feats: np.ndarray,
                  scals: np.ndarray, batch_size: int = 1024) -> np.ndarray:
    """Sigmoid probabilities for one model over the whole set."""
    eval_step = make_eval_step(model)
    f = jnp.asarray(feats)
    s = jnp.asarray(scals)
    n = feats.shape[0]
    out = np.empty(n, np.float32)
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        idx = np.arange(lo, hi)
        if hi - lo < batch_size:
            idx = np.concatenate([idx, np.full(batch_size - (hi - lo), hi - 1)])
        logits = np.asarray(eval_step(state, f, s, jnp.asarray(idx)))
        out[lo:hi] = logits[: hi - lo]
    return 1.0 / (1.0 + np.exp(-out))


def load_model_state(ckpt_path: str, arch: str, num_scalar_features: int):
    """Arch registry + checkpoint restore (analogue of
    src/utils/ensemble.py:7-18)."""
    model = registry.build(arch, num_scalar_features)
    state, _, _ = create_state(model, jax.random.PRNGKey(0), TrainCfg(),
                               steps_per_epoch=1)
    state = ckpt_lib.restore(ckpt_path, state)
    return model, state


def weighted_ensemble(ckpt_paths, archs, val_scores, feats, scals,
                      num_scalar_features: int, use_softmax: bool = True,
                      batch_size: int = 1024) -> np.ndarray:
    assert len(ckpt_paths) == len(archs) == len(val_scores)
    weights = softmax_weights(val_scores, use_softmax)
    probs = np.zeros(feats.shape[0], np.float64)
    for path, arch, w in zip(ckpt_paths, archs, weights):
        model, state = load_model_state(path, arch, num_scalar_features)
        probs += w * predict_probs(model, state, feats, scals, batch_size)
    return probs


def average_ensemble(ckpt_paths, archs, feats, scals,
                     num_scalar_features: int, batch_size: int = 1024
                     ) -> np.ndarray:
    """Unweighted mean variant (src/utils/ensemble.py:20-46)."""
    n = len(ckpt_paths)
    return weighted_ensemble(ckpt_paths, archs, np.ones(n), feats, scals,
                             num_scalar_features, use_softmax=False,
                             batch_size=batch_size)


def serve_from_wav(ckpt_paths, archs, val_scores, wavs: np.ndarray,
                   spec=None, use_softmax: bool = True,
                   micro_batch: int = 8) -> np.ndarray:
    """Cache-free inference: wavs[N, 16000] -> ensemble probabilities[N]
    through ONE jitted graph (feature extraction + every model's forward +
    the weighted sigmoid blend fused into a single device dispatch per
    micro-batch). This is the serving path the reference lacks — its
    per-clip story is ~20 sequential librosa calls plus two torch models
    (src/precompute/process.py:25 + src/utils/ensemble.py:49).

    micro_batch fixes the compiled shape; the tail is padded and dropped.
    """
    from tpu_breath.config import DEFAULT_FEATURES
    from tpu_breath.features import extract_features

    spec = spec or DEFAULT_FEATURES
    loaded = [load_model_state(p, a, spec.n_scalars)
              for p, a in zip(ckpt_paths, archs)]
    models = [m for m, _ in loaded]
    states = jax.device_put([st for _, st in loaded])
    weights = softmax_weights(val_scores, use_softmax)

    @jax.jit
    def serve(states, y):
        f, s = extract_features(y, spec)
        p = jnp.zeros(y.shape[0], jnp.float32)
        for model, state, w in zip(models, states, weights):
            logits, _ = model.apply({"params": state.params,
                                     "batch_stats": state.batch_stats}, f, s)
            p = p + float(w) * jax.nn.sigmoid(logits)
        return p

    n = wavs.shape[0]
    out = np.empty(n, np.float64)
    pending = []
    for lo in range(0, n, micro_batch):
        hi = min(lo + micro_batch, n)
        x = wavs[lo:hi]
        if hi - lo < micro_batch:
            x = np.pad(x, ((0, micro_batch - (hi - lo)), (0, 0)))
        pending.append((lo, hi, serve(states, jnp.asarray(x))))
    for lo, hi, p in pending:
        out[lo:hi] = np.asarray(p)[: hi - lo]
    return out


def write_submission(ids, probs, out_path: str,
                     threshold: float = 0.5) -> ds.Table:
    """probs > 0.5 -> 'E' else 'I' (src/scripts.py:62-69)."""
    table = {"ID": [str(i) for i in ids],
             "Target": ["E" if p > threshold else "I" for p in probs]}
    ds.write_table(table, out_path)
    return table
