"""Burg-method LPC as a fixed-trip-count JAX recursion, vmapped over frames.

Batched replacement for the reference's per-frame librosa.lpc loop
(reference src/precompute/methods.py:116-134): the Burg order recursion is a
12-iteration fori_loop with masked dot products over fixed-length buffers
(XLA requires static shapes; librosa's shrinking slices become index masks),
and vmap lifts it over the 98 frames x batch at once.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def burg_lpc(y: jax.Array, order: int) -> jax.Array:
    """AR coefficients [order+1] (a[0]=1) for one frame y[n], matching
    librosa.core._lpc's Burg recursion. Non-finite results map to zeros, which
    the caller interprets as the reference's failure->zeros semantics."""
    n = y.shape[-1]
    m = n - 1  # working buffer length
    fwd0 = y[1:]
    bwd0 = y[:-1]
    den0 = jnp.dot(fwd0, fwd0) + jnp.dot(bwd0, bwd0)
    ar0 = jnp.zeros(order + 1, y.dtype).at[0].set(1.0)
    iota = jnp.arange(m)
    j_idx = jnp.arange(order + 1)

    def body(i, carry):
        fwd, bwd, ar, den = carry
        length = m - i  # current valid window [0, length)
        valid = iota < length
        reflect = -2.0 * jnp.sum(jnp.where(valid, bwd * fwd, 0.0)) / den
        # ar_new[j] = ar[j] + reflect * ar[i + 1 - j] for 1 <= j <= i+1
        rev = ar[jnp.clip(i + 1 - j_idx, 0, order)]
        upd_mask = (j_idx >= 1) & (j_idx <= i + 1)
        ar = ar + jnp.where(upd_mask, reflect * rev, 0.0)
        fwd_new = fwd + reflect * bwd
        bwd_new = bwd + reflect * fwd
        # fwd drops its first element (left-shift); bwd drops its last
        # (valid window shrinks, data stays in place)
        fwd = jnp.roll(fwd_new, -1)
        # librosa updates den incrementally (q*den - edges); in f32 that
        # cancellation path diverges badly when |reflect| -> 1, so recompute
        # the mathematically identical sum over the shrunk window instead.
        valid_next = iota < (length - 1)
        den = (jnp.sum(jnp.where(valid_next, fwd * fwd, 0.0))
               + jnp.sum(jnp.where(valid_next, bwd_new * bwd_new, 0.0)))
        return fwd, bwd_new, ar, den

    _, _, ar, _ = lax.fori_loop(0, order, body, (fwd0, bwd0, ar0, den0))
    ok = jnp.all(jnp.isfinite(ar))
    return jnp.where(ok, ar, jnp.zeros_like(ar))


@functools.lru_cache(maxsize=None)
def _hamming(n: int) -> np.ndarray:
    return np.hamming(n).astype(np.float32)


def lpc_features(y: jax.Array, order: int, sr: int = 16_000) -> jax.Array:
    """y[..., n] -> [..., order, n_frames]: pre-emphasis 0.97, 25ms/10ms
    Hamming frames, Burg LPC per frame, coefficients a[1:]
    (reference src/precompute/methods.py:116-134)."""
    pre = 0.97
    y_emph = jnp.concatenate([y[..., :1], y[..., 1:] - pre * y[..., :-1]], axis=-1)
    frame_length = int(0.025 * sr)
    frame_shift = int(0.010 * sr)
    n = y.shape[-1]
    n_frames = len(range(0, n - frame_length, frame_shift))
    from tpu_breath.ops import spectral
    frames = spectral.frame_signal(y_emph, frame_length, frame_shift,
                                   n_frames)  # gather-free (gcd blocks)
    frames = frames * jnp.asarray(_hamming(frame_length))

    fn = functools.partial(burg_lpc, order=order)
    for _ in range(frames.ndim - 1):
        fn = jax.vmap(fn)
    coeffs = fn(frames)  # [..., n_frames, order+1]
    return coeffs[..., 1:].swapaxes(-1, -2)
