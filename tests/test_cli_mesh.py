"""The production CLI train path under a data-parallel mesh:
`train --mesh 8` must go through fit()'s streaming path (host_shard +
stream_batches + batch-sharded device_put) and produce the same history as
the single-device resident path, within the documented Adam sign-fragility
tolerance (see tests/test_parallel.py::test_dp_matches_single_device)."""
import json
import os

import numpy as np
import pytest

from tpu_breath import cli
from tpu_breath.config import Paths


N_TRAIN, N_TEST = 64, 8


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    """Synthetic dataset root: csvs + a prebuilt flat feature cache (the CLI
    hits the cache and never needs wav files or the feature graph)."""
    root = tmp_path_factory.mktemp("synth_input")
    rng = np.random.default_rng(7)
    ids_tr = [f"breath_{'E' if i % 2 else 'I'}_{i:03d}" for i in range(N_TRAIN)]
    ids_te = [f"test_{i:03d}" for i in range(N_TEST)]
    with open(root / "train.csv", "w") as f:
        f.write("ID,Target\n")
        for i, fid in enumerate(ids_tr):
            f.write(f"{fid},{'E' if i % 2 else 'I'}\n")
    with open(root / "test.csv", "w") as f:
        f.write("ID\n" + "\n".join(ids_te) + "\n")
    paths = Paths(root=str(root))
    os.makedirs(paths.feature_cache)
    all_ids = ids_tr + ids_te
    # small spatial dims keep the CPU conv compile fast; CNN8 is size-agnostic
    feats = rng.standard_normal(
        (len(all_ids), 9, 16, 8)).astype(np.float32)
    # plant a learnable signal so accuracies move
    y = np.asarray([1.0 if "_E_" in i else 0.0 for i in ids_tr] + [0.5] * N_TEST)
    feats[:, 0, 0, 0] += 2.0 * y
    scals = rng.standard_normal((len(all_ids), 36)).astype(np.float32)
    # save_cache stamps meta.json with FEATURE_NUMERIC_VERSION; a bare
    # features.npy/scalars.npy cache now reads as absent (stale-cache guard)
    from tpu_breath.data.dataset import FeatureStore
    FeatureStore(all_ids, feats, scals).save_cache(paths.feature_cache)
    return root


def _run(root, out, mesh):
    # --f32: in bf16, BatchNorm's cross-device reduction order shifts batch
    # stats by ~1e-3 and Adam amplifies it; layout equivalence is only
    # meaningfully testable in f32 (same rationale as test_parallel.py)
    cli.main(["train", "--root", str(root), "--out-root", str(out),
              "--archs", "cnn8", "--epochs", "2", "--batch-size", "16",
              "--seed", "0", "--f32", "--mesh", mesh])
    hist_path = os.path.join(str(out), "checkpoints", "cnn8", "history.jsonl")
    with open(hist_path) as f:
        return [json.loads(line) for line in f]


def _load_ckpt_tree(out):
    """{checkpoint dir name: {state.npz key: array}}, params and batch_stats
    keys grouped under their top-level field."""
    import glob
    dirs = sorted(glob.glob(os.path.join(str(out), "checkpoints", "cnn8",
                                         "best_epoch*")))
    trees = {}
    for d in dirs:
        with np.load(os.path.join(d, "state.npz")) as z:
            trees[os.path.basename(d)] = {
                field: {k: z[k] for k in sorted(z.files)
                        if k.startswith(f".{field}")}
                for field in ("params", "batch_stats")}
    return trees


def _flat(tree) -> np.ndarray:
    import jax
    return np.concatenate([np.asarray(x).ravel()
                           for x in jax.tree.leaves(tree)])


def test_cli_train_mesh_matches_single(synth_root, tmp_path):
    h1 = _run(synth_root, tmp_path / "single", "off")
    h8 = _run(synth_root, tmp_path / "mesh8", "8")
    assert len(h1) == len(h8) == 2
    for r1, r8 in zip(h1, h8):
        # identical batch schedule + PRNG keys; only f32 reduction order
        # differs between layouts (documented Adam sign-fragility)
        assert abs(r1["train_loss"] - r8["train_loss"]) < 1e-3, (r1, r8)
        assert abs(r1["val_loss"] - r8["val_loss"]) < 1e-3, (r1, r8)
        assert r1["train_acc"] == r8["train_acc"]
        assert r1["lr"] == r8["lr"]

    # Final-state equivalence: both layouts must have saved
    # checkpoints at the SAME epochs (identical improvement bookkeeping), and
    # the final checkpoint's params/batch_stats must agree elementwise — a
    # seeded cross-replica reduction bug of one batch-norm stat fails here,
    # where a val-accuracy window could mask it.
    c1, c8 = _load_ckpt_tree(tmp_path / "single"), _load_ckpt_tree(tmp_path / "mesh8")
    assert set(c1) == set(c8) and c1, (sorted(c1), sorted(c8))
    last = sorted(c1)[-1]
    p1, p8 = _flat(c1[last]["params"]), _flat(c8[last]["params"])
    # Adam sign-fragility bound (cf. test_parallel.py): a near-zero f32
    # gradient whose sign depends on reduction order moves a full lr step.
    # test_parallel bounds the fragile set at 0.1% after ONE step; this run
    # takes 6 steps, so allow modest compounding (measured 0.11%) — a real
    # cross-replica reduction bug mismatches a large fraction, not 0.3%.
    mismatched = np.abs(p1 - p8) > 1e-4
    assert mismatched.mean() < 3e-3, mismatched.mean()
    assert np.max(np.abs(p1 - p8)) < 3 * 4e-4 * 2  # 2 epochs of cnn8 lr
    b1, b8 = _flat(c1[last]["batch_stats"]), _flat(c8[last]["batch_stats"])
    # batch stats are EMAs of ACTIVATION reductions, so they inherit the
    # sign-fragile param drift (measured <=6e-3 rel after 6 steps). A real
    # cross-replica reduction bug (e.g. one device's contribution dropped)
    # shifts a stat by ~1/8 = 0.125 relative on an 8-device mesh — an order
    # of magnitude above this tolerance.
    np.testing.assert_allclose(b1, b8, rtol=2e-2, atol=2e-2)


def test_cli_mesh_flag_default_auto():
    p = cli.build_parser()
    a = p.parse_args(["train"])
    assert a.mesh == "auto" and a.batch_size == 0
    a = p.parse_args(["train", "--mesh", "off", "--batch-size", "32"])
    assert a.mesh == "off" and a.batch_size == 32
