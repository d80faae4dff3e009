"""Data-layer tests: ID mapping, split parity, wav decode, npz interop,
streaming loader."""
import os

import numpy as np
import pytest

from tpu_breath.config import FeatureSpec
from tpu_breath.data import dataset as ds
from tpu_breath.data import wav as wav_io
from tpu_breath.data import loader

SPEC = FeatureSpec()


def test_train_wav_name_strips_label_fragment():
    # reference src/precompute/core.py:24
    assert ds.train_wav_name("steth_20180814_09_37_11_I_004") == \
        "steth_20180814_09_37_11_004.wav"
    assert ds.train_wav_name("steth_x_E_000") == "steth_x_000.wav"


def test_test_wav_name():
    assert ds.test_wav_name("a.wav") == "a.wav"
    assert ds.test_wav_name("a") == "a.wav"


def _check_split_against_sklearn(n):
    table = {"ID": [f"c{i}" for i in range(n)],
             "Target": ["E", "I"] * (n // 2) + ["E"] * (n % 2)}
    tr, va = ds.split_train_val(table)
    from sklearn.model_selection import train_test_split
    tr2, va2 = train_test_split(table["ID"], test_size=0.20, shuffle=True,
                                random_state=42)
    assert tr["ID"] == list(tr2) and va["ID"] == list(va2)
    assert len(va["ID"]) == -(-n // 5)
    by_id = dict(zip(table["ID"], table["Target"]))
    assert tr["Target"] == [by_id[i] for i in tr["ID"]]
    return tr, va


def test_split_is_sklearn_seed42():
    tr, va = _check_split_against_sklearn(100)
    assert len(tr["ID"]) == 80 and len(va["ID"]) == 20


@pytest.mark.parametrize("n", [59, 1280, 7])
def test_split_matches_sklearn_uneven_sizes(n):
    """The numpy split reproduces sklearn's train_test_split row for row,
    also where 0.2 * n is not whole (the ceil goes to val)."""
    _check_split_against_sklearn(n)


def test_labels():
    assert ds.labels_from_targets(["E", "I", "E"]).tolist() == [1.0, 0.0, 1.0]


def test_wav_native_matches_python():
    import glob
    paths = sorted(glob.glob("/root/reference/input/test/*.wav"))[:8]
    if not paths:
        pytest.skip("no reference wavs")
    batch = wav_io.load_wav_batch(paths)
    ref = np.stack([wav_io.load_wav(p) for p in paths])
    np.testing.assert_array_equal(batch, ref)


def test_npz_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    ids = ["a", "b"]
    feats = rng.standard_normal((2, 9, 128, 63)).astype(np.float32)
    scals = rng.standard_normal((2, 36)).astype(np.float32)
    store = ds.FeatureStore(ids, feats, scals)
    store.save_npz(str(tmp_path), SPEC)
    d = np.load(tmp_path / "a.npz")
    assert set(d.keys()) == set(SPEC.npz_keys) | {"scalars"}
    rt = ds.FeatureStore.load_npz(str(tmp_path), ids, SPEC)
    np.testing.assert_array_equal(rt.features, feats)
    np.testing.assert_array_equal(rt.scalars, scals)


def test_cache_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    store = ds.FeatureStore(["x", "y", "z"],
                            rng.standard_normal((3, 9, 8, 4)).astype(np.float32),
                            rng.standard_normal((3, 5)).astype(np.float32))
    store.save_cache(str(tmp_path))
    rt = ds.FeatureStore.load_cache(str(tmp_path))
    assert rt.ids == store.ids
    np.testing.assert_array_equal(np.asarray(rt.features), store.features)
    sub = rt.subset(["z", "x"])
    np.testing.assert_array_equal(sub.features[0], store.features[2])


def test_cache_version_guard(tmp_path):
    """A cache written before a feature-numerics change must read as absent
    (advisor r4: stale features silently mixing with post-fix fused training
    reintroduces the fused-vs-cached desync)."""
    import json
    import os
    rng = np.random.default_rng(2)
    store = ds.FeatureStore(["a"],
                            rng.standard_normal((1, 9, 8, 4)).astype(np.float32),
                            rng.standard_normal((1, 5)).astype(np.float32))
    store.save_cache(str(tmp_path))
    assert ds.FeatureStore.cache_exists(str(tmp_path))
    meta = os.path.join(tmp_path, "meta.json")
    with open(meta, "w") as f:
        json.dump({"numeric_version": "some-older-stack"}, f)
    assert not ds.FeatureStore.cache_exists(str(tmp_path))
    os.remove(meta)  # pre-versioning cache: no meta.json at all
    assert not ds.FeatureStore.cache_exists(str(tmp_path))


def test_batch_indices_drop_last_and_determinism():
    a = list(loader.batch_indices(10, 4, np.random.default_rng(0)))
    b = list(loader.batch_indices(10, 4, np.random.default_rng(0)))
    assert len(a) == 2 and all(len(x) == 4 for x in a)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_prefetcher_yields_all_batches():
    arrays = (np.arange(20).reshape(10, 2).astype(np.float32),
              np.arange(10).astype(np.float32))
    stream = loader.stream_batches(arrays, 2, np.random.default_rng(0),
                                   depth=3, shuffle=False)
    got = list(stream)
    assert len(got) == 5
    flat = np.concatenate([np.asarray(b[1]) for b in got])
    np.testing.assert_array_equal(np.sort(flat), np.arange(10))


def test_host_shard_partitions_everything():
    n = 103
    covered = []
    for h in range(4):
        s = loader.host_shard(n, host_id=h, host_count=4)
        covered.extend(range(*s.indices(n)))
    assert sorted(covered) == list(range(n))


def _synth(root, seed=0):
    from tpu_breath.data import synth
    synth.write_competition_input(str(root), n_train=8, n_test=4, seed=seed)


def _tree_bytes(root) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_synth_input_is_deterministic(tmp_path):
    """The same seed writes the same bytes; another seed other clips. The
    layout is the one the CLI reads: csvs plus one wav per row."""
    _synth(tmp_path / "a")
    _synth(tmp_path / "b")
    _synth(tmp_path / "c", seed=1)
    a, b, c = (_tree_bytes(tmp_path / d) for d in "abc")
    assert a == b
    assert a.keys() == c.keys() and a != c
    train = ds.read_table(str(tmp_path / "a" / "train.csv"))
    test = ds.read_table(str(tmp_path / "a" / "test.csv"))
    assert len(train["ID"]) == 8 and set(train["Target"]) == {"E", "I"}
    for i in train["ID"]:
        assert os.path.join("train", ds.train_wav_name(i)) in a
    for i in test["ID"]:
        assert os.path.join("test", ds.test_wav_name(i)) in a


def test_synth_wavs_decode_same_native_and_python(tmp_path):
    _synth(tmp_path)
    paths = sorted(str(p) for p in (tmp_path / "train").glob("*.wav"))
    batch = wav_io.load_wav_batch(paths, SPEC.expected_len)
    ref = np.stack([wav_io.load_wav(p, SPEC.expected_len) for p in paths])
    np.testing.assert_array_equal(batch, ref)
    assert batch.shape == (8, 16_000) and np.all(np.abs(batch) <= 1.0)
    assert np.all(np.std(batch, axis=1) > 1e-3)


def test_synth_labels_are_learnable():
    """Exhale clips sit lower in frequency than inhale clips on average, so
    the label can be learned from the features."""
    from tpu_breath.data import synth
    labels = ["E", "I"] * 32
    y = synth.synth_clips(labels, np.random.default_rng(0)).astype(np.float64)
    mag = np.abs(np.fft.rfft(y, axis=-1))
    freqs = np.fft.rfftfreq(y.shape[-1], 1 / synth.SR)
    centroid = (mag * freqs).sum(-1) / mag.sum(-1)
    is_e = np.array(labels) == "E"
    assert centroid[is_e].mean() + 200 < centroid[~is_e].mean()
