"""scipy.signal.find_peaks (height + distance) as a fixed-shape JAX routine.

The reference counts envelope peaks with find_peaks(height=mean,
distance=sr//10) (src/precompute/methods.py:76-82). scipy's algorithm:
local maxima (plateau-aware) -> height filter -> greedy distance suppression
in descending height order. Here candidates are capped at K (top-K by height)
and the greedy pass is a K-step lax.scan over boolean masks. Real 1s
breathing-envelope clips show 250-600 above-mean local maxima, so K=2048 makes
the truncation immaterial (a candidate outside the top K could only matter if
>K higher candidates all fell in other suppression windows).

Plateau semantics match scipy's _local_maxima_1d: a run of equal samples is
ONE peak at the run's floor-midpoint, iff the samples just outside both run
edges are strictly lower; runs touching either signal boundary never qualify.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax


def _prefix_max(x: jax.Array, reverse: bool = False) -> jax.Array:
    """Cumulative max via log-depth parallel prefix (lax.cummax lowers to a
    16000-step sequential scan on this backend — ~10x the whole scalar
    graph's budget; associative_scan is 14 shifted maxima instead)."""
    return lax.associative_scan(jnp.maximum, x, reverse=reverse,
                                axis=x.ndim - 1)


def _fill_from_marks(vals: jax.Array, marks: jax.Array,
                     reverse: bool = False) -> jax.Array:
    """Propagate the value at each marked position across the following
    (or preceding, reverse=True) unmarked positions — a segmented fill as a
    log-depth associative scan over (value, seen) pairs, gather-free."""
    def comb(a, b):
        av, af = a
        bv, bf = b
        return jnp.where(bf, bv, av), af | bf

    v, _ = lax.associative_scan(
        comb, (jnp.where(marks, vals, 0.0), marks),
        reverse=reverse, axis=vals.ndim - 1)
    return v


def local_maxima(x: jax.Array) -> jax.Array:
    """Boolean mask of plateau-aware local maxima (scipy _local_maxima_1d).

    Vectorized run-length trick: left_edge[i]/right_edge[i] are the first/
    last index of the equal-value run containing i (log-depth prefix maxima),
    and the run-adjacent sample values are forward/backward segmented fills
    of the shifted signal; a run is a peak iff both adjacent samples exist
    and are strictly lower, and only the run's floor-midpoint carries it.
    """
    n = x.shape[-1]
    idx = jnp.arange(n)
    change = x[1:] != x[:-1]
    starts = jnp.concatenate([jnp.array([True]), change])
    ends = jnp.concatenate([change, jnp.array([True])])
    left_edge = _prefix_max(jnp.where(starts, idx, -1))
    right_edge = -_prefix_max(jnp.where(ends, -idx, -n), reverse=True)
    # value just left of the run start / just right of the run end,
    # propagated across the run (first/last run values are guarded by the
    # edge conditions, so their fill garbage never matters)
    left_val = _fill_from_marks(jnp.concatenate([x[:1], x[:-1]]), starts)
    right_val = _fill_from_marks(jnp.concatenate([x[1:], x[-1:]]), ends,
                                 reverse=True)
    left_ok = (left_edge > 0) & (left_val < x)
    right_ok = (right_edge < n - 1) & (right_val < x)
    mid = (left_edge + right_edge) // 2
    return left_ok & right_ok & (idx == mid)


def _stats(kept: jax.Array, heights: jax.Array, dtype):
    """(n, mean, std) with the reference's empty/singleton conventions."""
    n_peaks = jnp.sum(kept)
    kh = jnp.where(kept, heights, 0.0)
    mean_h = jnp.where(n_peaks > 0, jnp.sum(kh) / jnp.maximum(n_peaks, 1), 0.0)
    var_h = jnp.where(
        n_peaks > 0,
        jnp.sum(jnp.where(kept, (heights - mean_h) ** 2, 0.0))
        / jnp.maximum(n_peaks, 1),
        0.0)
    std_h = jnp.where(n_peaks > 1, jnp.sqrt(var_h), 0.0)
    return n_peaks.astype(dtype), mean_h, std_h


def find_peaks_stats(x: jax.Array, height: jax.Array, distance: int,
                     k_max: int = 2048):
    """One signal x[n]: returns (n_peaks, mean_height, std_height) of the
    peaks surviving scipy's greedy distance suppression.

    Fast path (large distance, the production case: distance=sr//10): at
    most n//distance+1 peaks can survive, so greedy selection is that many
    argmax-and-suppress rounds over the full signal — each round's global
    max among alive candidates IS the next peak scipy keeps (everything
    skipped between two kept peaks lies in a kept peak's window). ~12
    parallel-reduce rounds replace a k_max-step sequential scan.

    Slow path (small distance): top-k_max candidates by height, k_max-step
    boolean suppression scan (k_max=2048 covers real envelopes; a candidate
    outside the top K could only matter if >K higher candidates all fell in
    other suppression windows)."""
    n = x.shape[-1]
    is_peak = local_maxima(x)
    candidate = is_peak & (x >= height)
    scores = jnp.where(candidate, x, -jnp.inf)
    max_survivors = n // max(distance, 1) + 2

    if distance <= 1:
        # no suppression: every candidate survives
        return _stats(candidate, jnp.where(candidate, x, 0.0), x.dtype)

    if max_survivors <= 256:
        pos = jnp.arange(n)

        def body(alive_scores, _):
            i = jnp.argmax(alive_scores)  # ties -> lowest index, like top_k
            v = alive_scores[i]
            take = jnp.isfinite(v)
            near = jnp.abs(pos - i) < distance
            alive_scores = jnp.where(near, -jnp.inf, alive_scores)
            return alive_scores, (take, jnp.where(take, v, 0.0))

        _, (kept, vals) = lax.scan(body, scores, None, length=max_survivors)
        return _stats(kept, vals, x.dtype)

    k_max = min(k_max, n)
    heights, pos = lax.top_k(scores, k_max)  # descending
    valid = jnp.isfinite(heights)

    def body(carry, i):
        alive = carry
        take = alive[i] & valid[i]
        # suppress everything within `distance` of this peak (except itself)
        near = (jnp.abs(pos - pos[i]) < distance) & (jnp.arange(k_max) != i)
        alive = jnp.where(take, alive & ~near, alive)
        return alive, take

    alive0 = jnp.ones(k_max, bool)
    _, kept = lax.scan(body, alive0, jnp.arange(k_max))
    return _stats(kept, heights, x.dtype)


def find_peaks_stats_batched(x: jax.Array, height: jax.Array, distance: int):
    """Batched find_peaks_stats: x[..., n], height[...] -> three [...] arrays."""
    fn = find_peaks_stats
    for _ in range(x.ndim - 1):
        fn = jax.vmap(fn, in_axes=(0, 0, None))
    return fn(x, height, distance)
