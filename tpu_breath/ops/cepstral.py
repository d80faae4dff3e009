"""MFCC, Savitzky-Golay deltas, and 2-D DCT modulation spectrum as matmuls.

All three are *linear* operators at fixed sizes, so each becomes one constant
matrix product:
- delta/delta2: the savgol_filter(width=9, mode='interp') operator, including
  its polynomial-fit edge handling, is materialized by pushing an identity
  matrix through scipy once at trace time (bit-identical to librosa's backend,
  reference src/precompute/process.py:34-35,44-45).
- DCT-II(ortho): dense [n, n] matrix (reference src/precompute/methods.py:142-143).
"""
from __future__ import annotations

import functools

import numpy as np
import scipy.signal
from scipy.fftpack import dct as scipy_dct
import jax
import jax.numpy as jnp
from jax import lax

from tpu_breath.ops import spectral

MM_PRECISION = lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=MM_PRECISION)


@functools.lru_cache(maxsize=None)
def savgol_matrix(t: int, width: int = 9, order: int = 1) -> np.ndarray:
    """[t, t] matrix A with (A @ x) == savgol_filter(x, width, polyorder=order,
    deriv=order, mode='interp')."""
    eye = np.eye(t, dtype=np.float64)
    A = scipy.signal.savgol_filter(eye, width, polyorder=order, deriv=order,
                                   axis=0, mode="interp")
    return A.astype(np.float32)


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """[n, n] DCT-II ortho matrix D with (D @ x) == dct(x, type=2, norm='ortho')."""
    return scipy_dct(np.eye(n), type=2, norm="ortho", axis=0).astype(np.float32)


def delta(x: jax.Array, order: int = 1, width: int = 9) -> jax.Array:
    """librosa.feature.delta along the last (time) axis of [..., F, T]."""
    A = jnp.asarray(savgol_matrix(x.shape[-1], width, order))
    return _mm(x, A.T)


def mfcc(y: jax.Array, sr: int, n_mfcc: int, hop_length: int,
         n_fft: int) -> jax.Array:
    """librosa.feature.mfcc: dB mel (ref=1, top_db=80 per clip), DCT-II ortho
    over mel bins, first n_mfcc rows. y[..., n] -> [..., n_mfcc, T]."""
    S = spectral.melspectrogram(y, sr, n_fft=n_fft, hop_length=hop_length,
                                n_mels=128, fmax=None, power=2.0)
    S_db = spectral.power_to_db(S, ref_max=False)
    D = jnp.asarray(dct_matrix(128)[:n_mfcc])
    # [..., 128, T] -> [..., n_mfcc, T]
    return jnp.einsum("mf,...ft->...mt", D, S_db, precision=MM_PRECISION)


def mod_spec(mel_db: jax.Array, n_keep: int = 40) -> jax.Array:
    """2-D DCT modulation spectrum: DCT over freq, keep first n_keep rows,
    DCT over time (reference src/precompute/methods.py:142-143)."""
    f, t = mel_db.shape[-2], mel_db.shape[-1]
    Df = jnp.asarray(dct_matrix(f)[:n_keep])
    Dt = jnp.asarray(dct_matrix(t))
    x = jnp.einsum("kf,...ft->...kt", Df, mel_db, precision=MM_PRECISION)
    return _mm(x, Dt.T)
