"""Committed golden fixtures: the full feature pipeline pinned against .npz
files checked into the repo (SURVEY.md §4's golden-vector strategy). These
catch regressions in BOTH the JAX graph and the NumPy oracle — the live
oracle-vs-JAX tests alone would drift silently if the oracle changed."""
import glob
import os

import numpy as np
import jax
import pytest

from tpu_breath.config import FeatureSpec
from tpu_breath.features import extract_features
from tpu_breath.baseline import feature_np

SPEC = FeatureSpec()
FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                         "fixtures", "golden_*.npz")))


def test_fixtures_exist():
    assert len(FIXTURES) >= 2


def _check_pipeline(device):
    wavs, stacks, scalars = [], [], []
    for path in FIXTURES:
        d = np.load(path)
        wavs.append(d["wav"])
        stacks.append(np.stack([d[k] for k in SPEC.channel_order]))
        scalars.append(d["scalars"])
    wavs = np.stack(wavs)
    feats, scals = jax.jit(lambda w: extract_features(w, SPEC))(
        jax.device_put(wavs, device))
    feats, scals = np.asarray(feats), np.asarray(scals)
    for i, path in enumerate(FIXTURES):
        d = np.abs(feats[i] - stacks[i])
        assert d.max() < 2e-3, (path, d.max())
        rel = np.abs(scals[i] - scalars[i]) / np.maximum(
            np.abs(scalars[i]), 1e-2)
        assert rel.max() < 2e-2, (path, rel.max())


def test_jax_pipeline_matches_golden(cpu_device):
    _check_pipeline(cpu_device)


@pytest.mark.gpu
def test_jax_pipeline_matches_golden_on_gpu(gpu_device):
    _check_pipeline(gpu_device)


def test_oracle_matches_golden():
    for path in FIXTURES:
        d = np.load(path)
        out = feature_np.process_clip(d["wav"], SPEC)
        for k in SPEC.channel_order:
            np.testing.assert_allclose(out[k], d[k], atol=1e-6,
                                       err_msg=f"{path}:{k}")
        np.testing.assert_allclose(out["scalars"], d["scalars"], atol=1e-6)
