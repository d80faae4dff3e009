"""Streaming host->device input pipeline.

The default training path holds the whole feature set in device memory (it is
only ~1.5 GB for this competition). This module is the general path the
reference's DataLoader stack (src/utils/dataloaders.py: worker processes,
pinned memory, prefetch_factor) maps to when the dataset outgrows device
memory:

- batch_indices(): the epoch's shuffled, drop_last-batched index stream
  (keyed RNG, reproducible).
- Prefetcher: double-buffered async host->device transfer, `depth` batches
  ahead — the functional analogue of pinned-memory + prefetch_factor workers.
- host_shard(): contiguous per-host partition for multi-host training (each
  host feeds only its slice; the mesh's data axis stitches the global batch).
"""
from __future__ import annotations

import collections
from typing import Iterable, Iterator, Sequence

import numpy as np
import jax


def batch_indices(n: int, batch_size: int, rng: np.random.Generator,
                  shuffle: bool = True, drop_last: bool = True,
                  max_batches: int | None = None) -> Iterator[np.ndarray]:
    """max_batches caps the epoch's batch count — required under multi-host
    SPMD, where every process must execute the same number of collective
    steps even when host_shard() gave it a larger shard."""
    order = rng.permutation(n) if shuffle else np.arange(n)
    end = (n // batch_size) * batch_size if drop_last else n
    if max_batches is not None:
        end = min(end, max_batches * batch_size)
    for lo in range(0, end, batch_size):
        yield order[lo: lo + batch_size]


class Prefetcher:
    """Wrap an iterator of host batches (pytrees of numpy arrays); keeps
    `depth` batches in flight on device."""

    def __init__(self, it: Iterable, depth: int = 2, sharding=None):
        self._it = iter(it)
        self._depth = max(depth, 1)
        self._sharding = sharding

    def _put(self, batch):
        if self._sharding is not None:
            if jax.process_count() > 1:
                # each process contributes its local rows of the global batch
                return jax.tree.map(
                    lambda x: jax.make_array_from_process_local_data(
                        self._sharding, x), batch)
            return jax.tree.map(
                lambda x: jax.device_put(x, self._sharding), batch)
        return jax.tree.map(jax.device_put, batch)

    def __iter__(self):
        queue = collections.deque()
        try:
            for _ in range(self._depth):
                queue.append(self._put(next(self._it)))
        except StopIteration:
            pass
        while queue:
            out = queue.popleft()
            try:
                queue.append(self._put(next(self._it)))
            except StopIteration:
                pass
            yield out


def host_shard(n: int, host_id: int | None = None,
               host_count: int | None = None) -> slice:
    """Contiguous [start, stop) slice of the example index space owned by
    this host (jax.process_index/count by default)."""
    host_id = jax.process_index() if host_id is None else host_id
    host_count = jax.process_count() if host_count is None else host_count
    per = -(-n // host_count)
    return slice(host_id * per, min((host_id + 1) * per, n))


def stream_batches(arrays: Sequence[np.ndarray], batch_size: int,
                   rng: np.random.Generator, depth: int = 2, sharding=None,
                   shuffle: bool = True, drop_last: bool = True,
                   max_batches: int | None = None):
    """Convenience: shuffled, prefetched batch stream over parallel arrays
    (e.g. features, scalars, labels) that live on host (possibly memmapped)."""
    n = len(arrays[0])

    def gen():
        for idx in batch_indices(n, batch_size, rng, shuffle, drop_last,
                                 max_batches):
            yield tuple(np.ascontiguousarray(a[idx]) for a in arrays)

    return Prefetcher(gen(), depth=depth, sharding=sharding)
