"""Fourier transforms as matmuls.

The feature graph was first built for a backend with no FFT primitive, so
every transform here is a dense matmul against constant DFT matrices
(whether cuFFT beats them on the GPU is an open item in ROADMAP.md):

- n_fft 512 / 2048 STFTs: direct real-DFT matmul with [n_fft, n_fft//2+1]
  cosine/sine constant matrices (built once at trace time).
- Length-16000 (Hilbert analytic signal) and length-32768 (full
  autocorrelation) transforms: two-stage Cooley-Tukey with the two factors'
  DFTs done as matmuls (16000 = 125 x 128, 32768 = 256 x 128).

Complex values are carried as explicit (re, im) float32 pairs, so every
product is a real matmul.

Replaces the np.fft/scipy FFT usage inside librosa that the reference leans on
(reference src/precompute/process.py:32-78, src/precompute/methods.py:72-112).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

# Feature extraction needs f32-accurate matmuls; DEFAULT precision may use
# TF32 (H100) or bf16 passes.
MM_PRECISION = lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=MM_PRECISION)


@functools.lru_cache(maxsize=None)
def _rdft_consts(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT matrices: x[..., n] @ (C - iS) == rfft(x). Shapes [n, n//2+1]."""
    k = np.arange(n)[:, None]
    f = np.arange(n // 2 + 1)[None, :]
    ang = 2.0 * np.pi * k * f / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def rdft(x: jax.Array, n: int | None = None) -> tuple[jax.Array, jax.Array]:
    """rfft along the last axis via matmul. Returns (re, im), each [..., n//2+1].

    Large power-of-two sizes go through the two-stage Cooley-Tukey path
    (~3.5x fewer FLOPs than the direct [n, n//2+1] product); small sizes stay
    a single dense matmul."""
    if n is None:
        n = x.shape[-1]
    if x.shape[-1] < n:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, n - x.shape[-1])]
        x = jnp.pad(x, pad)
    elif x.shape[-1] > n:
        x = x[..., :n]
    if n >= 1024 and n % 128 == 0:
        re, im = cfft_ct(x, jnp.zeros_like(x), n // 128, 128)
        return re[..., : n // 2 + 1], im[..., : n // 2 + 1]
    C, S = _rdft_consts(n)
    return _mm(x, jnp.asarray(C)), _mm(x, -jnp.asarray(S))


@functools.lru_cache(maxsize=None)
def _dft_consts(n: int, inverse: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Full complex-DFT matrices [n, n] (cos, sin with the transform's sign)."""
    k = np.arange(n)[:, None]
    f = np.arange(n)[None, :]
    sign = 1.0 if inverse else -1.0
    ang = sign * 2.0 * np.pi * k * f / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _cdft_mat(xr, xi, n, inverse=False):
    """Complex DFT along last axis via matmul of the (re, im) pair."""
    C, S = _dft_consts(n, inverse)
    C = jnp.asarray(C)
    S = jnp.asarray(S)
    yr = _mm(xr, C) - _mm(xi, S)
    yi = _mm(xr, S) + _mm(xi, C)
    return yr, yi


@functools.lru_cache(maxsize=None)
def _twiddle(n1: int, n2: int, inverse: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Cooley-Tukey twiddle factors W_N^{n1*k2}, laid out [n1, n2]."""
    n = n1 * n2
    i1 = np.arange(n1)[:, None]
    k2 = np.arange(n2)[None, :]
    sign = 1.0 if inverse else -1.0
    ang = sign * 2.0 * np.pi * i1 * k2 / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def cfft_ct(xr: jax.Array, xi: jax.Array, n1: int, n2: int,
            inverse: bool = False) -> tuple[jax.Array, jax.Array]:
    """Complex FFT of length n1*n2 along the last axis, two-stage Cooley-Tukey
    (decimation in time: inner DFT over n2, twiddle, outer DFT over n1).
    X[k1*n2 + k2] = sum_{i1} W_{n1}^{i1 k1} [ W_N^{i1 k2} sum_{i2} x[i2*n1 + i1] W_{n2}^{i2 k2} ]
    """
    batch = xr.shape[:-1]
    n = n1 * n2
    assert xr.shape[-1] == n
    # x[i2*n1 + i1] -> [..., i1, i2]
    ar = xr.reshape(*batch, n2, n1).swapaxes(-1, -2)
    ai = xi.reshape(*batch, n2, n1).swapaxes(-1, -2)
    # inner DFT over i2 (length n2): [..., i1, k2]
    br, bi = _cdft_mat(ar, ai, n2, inverse)
    # twiddle
    tc, ts = _twiddle(n1, n2, inverse)
    tc = jnp.asarray(tc)
    ts = jnp.asarray(ts)
    cr = br * tc - bi * ts
    ci = br * ts + bi * tc
    # outer DFT over i1 (length n1): transpose to [..., k2, i1]
    cr = cr.swapaxes(-1, -2)
    ci = ci.swapaxes(-1, -2)
    dr, di = _cdft_mat(cr, ci, n1, inverse)
    # result indexed [..., k2, k1] -> X[k1*n2 + k2]
    dr = dr.swapaxes(-1, -2).reshape(*batch, n)
    di = di.swapaxes(-1, -2).reshape(*batch, n)
    return dr, di


def hilbert_envelope(y: jax.Array) -> jax.Array:
    """|analytic signal| of y[..., 16000], matching scipy.signal.hilbert
    (used by reference src/precompute/methods.py:72)."""
    n = y.shape[-1]
    assert n == 16000, "envelope path is specialized to 1s @ 16kHz clips"
    n1, n2 = 125, 128
    Yr, Yi = cfft_ct(y, jnp.zeros_like(y), n1, n2)
    h = np.zeros(n, dtype=np.float32)
    h[0] = 1.0
    h[1: n // 2] = 2.0
    h[n // 2] = 1.0
    h = jnp.asarray(h)
    Zr, Zi = Yr * h, Yi * h
    # ifft(z) = conj(fft(conj(z))) / n
    ar, ai = cfft_ct(Zr, -Zi, n1, n2)
    ar, ai = ar / n, -ai / n
    return jnp.sqrt(ar * ar + ai * ai)


def autocorr_full(y: jax.Array) -> jax.Array:
    """Linear full autocorrelation, positive lags: matches
    np.correlate(y, y, 'full')[n-1:] (reference src/precompute/methods.py:105).
    y[..., 16000] -> [..., 16000]. Uses a 32768-point CT transform."""
    n = y.shape[-1]
    nfft = 32768
    assert 2 * n - 1 <= nfft
    pad = [(0, 0)] * (y.ndim - 1) + [(0, nfft - n)]
    yp = jnp.pad(y, pad)
    n1, n2 = 256, 128
    Yr, Yi = cfft_ct(yp, jnp.zeros_like(yp), n1, n2)
    P = Yr * Yr + Yi * Yi
    # ifft of a real, even spectrum is real: take re(fft(P))/nfft
    ar, _ = cfft_ct(P, jnp.zeros_like(P), n1, n2)
    return ar[..., :n] / nfft
