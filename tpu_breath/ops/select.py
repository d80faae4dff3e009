"""Exact order statistics without sorting (radix select).

A sort was the most expensive primitive of this pipeline's scalar/tuning
paths on the backend it was first built for, yet every use only needs one
or two order statistics (whether jnp.sort wins on the GPU is an open item in
ROADMAP.md). Radix select gets them exactly: map f32 to order-preserving
uint32 (sign-flip trick), then 4 byte-passes of 256-bin compare-reduce
counts narrow the rank to a single key. All passes are fixed-shape
vectorized reductions — no data-dependent control flow, vmap-friendly.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def f32_to_ordered_u32(x: jax.Array) -> jax.Array:
    """Monotone bijection f32 -> uint32: non-negative floats map to
    [2^31, 2^32), negatives to [0, 2^31) reversed."""
    b = jax.lax.bitcast_convert_type(x, jnp.int32)
    sign_bit = jnp.int32(-2147483648)  # 0x80000000
    flipped = jnp.where(b < 0, ~b, b ^ sign_bit)
    return jax.lax.bitcast_convert_type(flipped, jnp.uint32)


def u32_to_f32(u: jax.Array) -> jax.Array:
    """Inverse of f32_to_ordered_u32."""
    i = jax.lax.bitcast_convert_type(u, jnp.int32)
    sign_bit = jnp.int32(-2147483648)
    b = jnp.where(i < 0, i ^ sign_bit, ~i)  # i<0 <=> u >= 2^31
    return jax.lax.bitcast_convert_type(b, jnp.float32)


def rank_select_u32(keys: jax.Array, rank: jax.Array,
                    bits: int = 1) -> jax.Array:
    """Exact rank-th smallest (0-indexed) of 1-D uint32 keys by radix
    descent, `bits` bits per step (32 must divide by bits). rank may be
    traced.

    bits=1 is the 32-step binary descent: per bit (high to low), one masked
    count decides whether the answer has that bit set — 32 compare+sum
    passes over the data. (A 256-bin-per-byte histogram built as 256
    separate compare-reduces costs 32x this and loses to the sort it
    replaces.)

    bits>1 descends a 2^bits-way radix tree in 32/bits steps; each step
    builds its in-prefix bucket histogram as ONE fused one-hot reduction
    (one read of the keys producing 2^bits counts), betting that XLA fuses
    the [n, W] one-hot into the pass — cutting memory traffic over the keys
    from 32 reads to 32/bits. The result is bit-identical to bits=1 (pure
    integer logic; asserted in tests)."""
    if 32 % bits:
        raise ValueError(f"bits ({bits}) must divide 32")
    rank = rank.astype(jnp.int32)
    prefix = jnp.zeros((), jnp.uint32)
    if bits == 1:
        for bit in range(31, -1, -1):
            cand = prefix | (jnp.uint32(1) << bit)
            below = jnp.sum(keys < cand, dtype=jnp.int32)
            # if fewer than rank+1 keys are < cand, the answer is >= cand
            prefix = jnp.where(below <= rank, cand, prefix)
        return prefix
    w = 1 << bits
    lanes = jnp.arange(w, dtype=jnp.uint32)
    below = jnp.zeros((), jnp.int32)  # keys strictly under the prefix range
    for hi in range(32 - bits, -1, -bits):
        if hi + bits >= 32:
            in_pref = jnp.ones(keys.shape, bool)
        else:
            in_pref = (keys >> (hi + bits)) == (prefix >> (hi + bits))
        bucket = (keys >> hi) & jnp.uint32(w - 1)
        hist = jnp.sum((bucket[:, None] == lanes[None, :]) & in_pref[:, None],
                       axis=0, dtype=jnp.int32)          # [w], one fused pass
        excl = jnp.cumsum(hist) - hist                   # exclusive prefix sum
        ok = (below + excl) <= rank                      # monotone in lane
        w_star = jnp.int32(jnp.sum(ok)) - 1              # last ok lane
        prefix = prefix | (w_star.astype(jnp.uint32) << hi)
        below = below + jnp.take(excl, w_star)
    return prefix


def rank_select_u32_multi(keys: jax.Array, ranks: jax.Array,
                          bits: int = 1) -> jax.Array:
    """rank_select_u32 for a VECTOR of ranks in one shared descent: every
    pass reads the keys once and resolves all R candidate counts together
    ([R, n] compare + reduce), so R nearby order statistics cost one
    descent's worth of sequential passes instead of R (the p90/p10 pair and
    the median's lo/hi pair each halve-to-quarter their pass count).
    Bit-identical to R independent rank_select_u32 calls (pure integer
    logic; asserted in tests/test_select.py)."""
    ranks = jnp.asarray(ranks).astype(jnp.int32)
    if bits != 1:
        # the wide-radix alternative keeps its measured-negative scalar form
        return jax.vmap(lambda r: rank_select_u32(keys, r, bits=bits))(ranks)
    prefix = jnp.zeros(ranks.shape, jnp.uint32)
    for bit in range(31, -1, -1):
        cand = prefix | (jnp.uint32(1) << bit)
        below = jnp.sum(keys[None, :] < cand[:, None], axis=-1,
                        dtype=jnp.int32)
        prefix = jnp.where(below <= ranks, cand, prefix)
    return prefix


def rank_value(x: jax.Array, rank, bits: int = 1) -> jax.Array:
    """Exact rank-th smallest value of 1-D f32 x (rank static or traced)."""
    keys = f32_to_ordered_u32(x.astype(jnp.float32))
    return u32_to_f32(rank_select_u32(keys, jnp.asarray(rank), bits=bits))


def percentiles(x: jax.Array, qs, bits: int = 1) -> jax.Array:
    """np.percentile(x, qs) (linear interpolation) of 1-D x for a tuple of
    static quantiles, sort-free: ALL bracketing ranks resolve in one shared
    multi-rank descent (two quantiles cost 32 passes total, not 128)."""
    n = x.shape[-1]
    los, fracs = [], []
    for q in qs:
        pos = q / 100.0 * (n - 1)
        lo = int(np.floor(pos))
        los.append(lo)
        fracs.append(np.float32(pos - lo))
    ranks = np.array([[lo, min(lo + 1, n - 1)] for lo in los],
                     np.int32).ravel()
    keys = f32_to_ordered_u32(x.astype(jnp.float32))
    vals = u32_to_f32(rank_select_u32_multi(keys, jnp.asarray(ranks),
                                            bits=bits)).reshape(len(qs), 2)
    frac = jnp.asarray(np.array(fracs, np.float32))
    return vals[:, 0] * (1 - frac) + vals[:, 1] * frac


def percentile(x: jax.Array, q: float, bits: int = 1) -> jax.Array:
    """np.percentile(x, q) (linear interpolation) of 1-D x, sort-free."""
    return percentiles(x, (q,), bits=bits)[0]


def masked_median(values: jax.Array, mask: jax.Array,
                  bits: int = 1) -> jax.Array:
    """np.median over values[mask] (0.0 if the mask is empty): masked
    entries map to +inf keys, one shared two-rank descent picks the
    middles."""
    flat_v = jnp.where(mask, values, jnp.inf).ravel().astype(jnp.float32)
    keys = f32_to_ordered_u32(flat_v)
    k = jnp.sum(mask)
    lo = jnp.maximum((k - 1) // 2, 0)
    hi = jnp.maximum(k // 2, 0)
    v = u32_to_f32(rank_select_u32_multi(keys, jnp.stack([lo, hi]),
                                         bits=bits))
    med = 0.5 * (v[0] + v[1])
    return jnp.where(k > 0, med, 0.0)
