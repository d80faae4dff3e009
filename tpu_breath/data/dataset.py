"""CSV handling, ID<->wav mapping, the seed-42 split, and the feature store.

Replaces the reference's Dataset/DataLoader layer (src/dataset.py,
src/utils/dataloaders.py) with an accelerator-resident design: the whole
feature set (4k x 290KB) lives in device memory as dense arrays and batches
are device-side gathers — no worker processes, no per-item npz reads, no
host<->device copies inside the epoch loop.

A CSV is read into a table: a dict from column name to the column's values
as a list of strings, in file order.

Two persistence formats:
- npz parity mode: one .npz per clip with the reference's exact schema
  (src/precompute/process.py:93-103), interoperable both ways.
- flat cache: features.npy / scalars.npy / ids.txt written once, mmap-read —
  the fast path.
"""
from __future__ import annotations

import csv
import dataclasses
import math
import os
import re

import numpy as np

from tpu_breath.config import FeatureSpec, Paths


def train_wav_name(file_id: str) -> str:
    """Strip the _[EI]_ label fragment (reference src/precompute/core.py:24)."""
    return re.sub(r"_[EI]_", "_", file_id) + ".wav"


def test_wav_name(file_id: str) -> str:
    return file_id if file_id.endswith(".wav") else file_id + ".wav"


Table = dict[str, list[str]]


def read_table(path: str) -> Table:
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        columns = list(zip(*reader)) or [()] * len(header)
    return {name: list(col) for name, col in zip(header, columns)}


def write_table(table: Table, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(table)
        writer.writerows(zip(*table.values()))


def load_tables(paths: Paths) -> tuple[Table, Table]:
    return read_table(paths.train_csv), read_table(paths.test_csv)


def take_rows(table: Table, rows) -> Table:
    return {k: [v[i] for i in rows] for k, v in table.items()}


def split_train_val(table: Table, test_size: float = 0.20, seed: int = 42
                    ) -> tuple[Table, Table]:
    """The reference's exact split: sklearn's train_test_split(shuffle=True,
    random_state=42), NOT stratified (src/utils/dataloaders.py:11; the
    paper's stratification claim is discrepancy D4). Reproduced in numpy:
    val is the first ceil(test_size * n) rows of RandomState(seed)'s
    permutation and train the rest, each in permutation order."""
    n = len(next(iter(table.values())))
    perm = np.random.RandomState(seed).permutation(n)
    n_val = math.ceil(test_size * n)
    return take_rows(table, perm[n_val:]), take_rows(table, perm[:n_val])


def labels_from_targets(targets) -> np.ndarray:
    """'E' -> 1.0, 'I' -> 0.0 (reference src/dataset.py:54)."""
    return np.asarray([1.0 if t == "E" else 0.0 for t in targets], np.float32)


@dataclasses.dataclass
class FeatureStore:
    """Dense in-memory feature set for a list of clip IDs."""

    ids: list[str]
    features: np.ndarray  # [N, C, H, W] float32
    scalars: np.ndarray   # [N, S] float32

    def subset(self, id_list) -> "FeatureStore":
        index = {fid: i for i, fid in enumerate(self.ids)}
        rows = np.asarray([index[i] for i in id_list])
        return FeatureStore(list(id_list), self.features[rows],
                            self.scalars[rows])

    # ---------------- flat cache ----------------

    def save_cache(self, cache_dir: str) -> None:
        import json

        from tpu_breath.config import FEATURE_NUMERIC_VERSION
        os.makedirs(cache_dir, exist_ok=True)
        np.save(os.path.join(cache_dir, "features.npy"), self.features)
        np.save(os.path.join(cache_dir, "scalars.npy"), self.scalars)
        with open(os.path.join(cache_dir, "ids.txt"), "w") as f:
            f.write("\n".join(self.ids))
        with open(os.path.join(cache_dir, "meta.json"), "w") as f:
            json.dump({"numeric_version": FEATURE_NUMERIC_VERSION,
                       "n_clips": len(self.ids),
                       "feature_shape": list(self.features.shape[1:]),
                       "scalar_dim": int(self.scalars.shape[1])}, f)

    @classmethod
    def load_cache(cls, cache_dir: str, mmap: bool = True) -> "FeatureStore":
        mode = "r" if mmap else None
        feats = np.load(os.path.join(cache_dir, "features.npy"), mmap_mode=mode)
        scals = np.load(os.path.join(cache_dir, "scalars.npy"), mmap_mode=mode)
        with open(os.path.join(cache_dir, "ids.txt")) as f:
            ids = f.read().splitlines()
        return cls(ids, feats, scals)

    @classmethod
    def cache_exists(cls, cache_dir: str) -> bool:
        """True only for a complete cache written by the CURRENT numeric
        stack. A missing/mismatched meta.json (e.g. a cache predating a
        feature-numerics change) reads as absent, forcing regeneration —
        stale features must never mix with fresh fused training."""
        import json

        from tpu_breath.config import FEATURE_NUMERIC_VERSION
        if not all(os.path.exists(os.path.join(cache_dir, n))
                   for n in ("features.npy", "scalars.npy", "ids.txt")):
            return False
        meta_path = os.path.join(cache_dir, "meta.json")
        if not os.path.exists(meta_path):
            return False
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return False
        return meta.get("numeric_version") == FEATURE_NUMERIC_VERSION

    # ---------------- npz parity mode ----------------

    def save_npz(self, out_dir: str, spec: FeatureSpec) -> None:
        """One .npz per clip with the reference schema — a drop-in for
        feature dirs consumed by the reference's DS (src/dataset.py:37-51)."""
        os.makedirs(out_dir, exist_ok=True)
        order = spec.channel_order
        for i, fid in enumerate(self.ids):
            arrays = {name: self.features[i, c]
                      for c, name in enumerate(order)}
            arrays["scalars"] = self.scalars[i]
            np.savez(os.path.join(out_dir, fid + ".npz"), **arrays)

    @classmethod
    def load_npz(cls, feature_dir: str, id_list, spec: FeatureSpec
                 ) -> "FeatureStore":
        """Read reference-produced npz files; channels are auto-discovered
        from the first file's keys minus the excluded set and stacked in
        sorted order, exactly like the reference Dataset
        (src/dataset.py:17-31)."""
        excluded = {"scalars", "sr", "hop_length", "n_fft"}
        first = np.load(os.path.join(feature_dir, id_list[0] + ".npz"))
        names = sorted(k for k in first.keys() if k not in excluded)
        scalar_dim = first["scalars"].shape[0]
        n = len(id_list)
        feats = np.empty((n, len(names), spec.n_mels, spec.t_fixed), np.float32)
        scals = np.empty((n, scalar_dim), np.float32)
        for i, fid in enumerate(id_list):
            with np.load(os.path.join(feature_dir, fid + ".npz")) as d:
                for c, name in enumerate(names):
                    feats[i, c] = d[name]
                scals[i] = d["scalars"]
        return cls(list(id_list), feats, scals)
