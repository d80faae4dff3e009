"""Onset strength + autocorrelation tempogram (JAX, batched).

Replaces librosa.onset.onset_strength / librosa.feature.tempogram as used by
the reference (src/precompute/process.py:74-78). The per-frame local
autocorrelation is a 1024-point zero-padded power spectrum computed with the
matmul DFT, followed by an inverse-cosine matmul that folds in the 1/N and
hermitian weights — two matmuls per clip instead of librosa's per-frame
FFT loop.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from tpu_breath.baseline import dsp_np as _oracle
from tpu_breath.ops import spectral, dft

MM_PRECISION = lax.Precision.HIGHEST


def onset_strength(y: jax.Array, sr: int, hop_length: int,
                   n_fft: int = 2048, lag: int = 1,
                   mel_power: jax.Array | None = None) -> jax.Array:
    """y[..., n] -> onset envelope [..., T]: dB-mel spectral flux, rectified,
    mean over bands, center compensation (prepends n_fft//(2*hop)+lag zeros).
    mel_power: optionally reuse a precomputed [..., 128, T] power mel
    spectrogram (n_fft=2048, fmax=sr/2) shared with the scalar descriptors."""
    S = mel_power
    if S is None:
        S = spectral.melspectrogram(y, sr, n_fft=n_fft, hop_length=hop_length,
                                    n_mels=128, fmax=0.5 * sr, power=2.0)
    S = spectral.power_to_db(S, ref_max=False)
    diff = jnp.maximum(0.0, S[..., lag:] - S[..., :-lag])
    env = jnp.mean(diff, axis=-2)
    pad_width = lag + n_fft // (2 * hop_length)
    pad = [(0, 0)] * (env.ndim - 1) + [(pad_width, 0)]
    env = jnp.pad(env, pad)
    return env[..., : S.shape[-1]]


@functools.lru_cache(maxsize=None)
def _iac_matrix(n_pad: int, win_length: int) -> np.ndarray:
    """[n_pad//2+1, win_length] matrix turning an rfft power spectrum into the
    first win_length lags of the (linear) autocorrelation."""
    f = np.arange(n_pad // 2 + 1)[:, None]
    l = np.arange(win_length)[None, :]
    w = np.full(n_pad // 2 + 1, 2.0)
    w[0] = 1.0
    if n_pad % 2 == 0:
        w[-1] = 1.0
    M = w[:, None] * np.cos(2 * np.pi * f * l / n_pad) / n_pad
    return M.astype(np.float32)


def tempogram(onset_env: jax.Array, win_length: int = 384) -> jax.Array:
    """onset_env[..., T] -> [..., win_length, T]: linear-ramp pad, hop-1
    framing, Hann window, per-frame autocorrelation, per-frame inf-norm."""
    t = onset_env.shape[-1]
    pad_amt = win_length // 2
    pad = [(0, 0)] * (onset_env.ndim - 1) + [(pad_amt, pad_amt)]
    oe = jnp.pad(onset_env, pad, mode="linear_ramp", end_values=0.0)
    idx = np.arange(t)[:, None] + np.arange(win_length)[None, :]
    frames = oe[..., idx]  # [..., T, win]
    win = jnp.asarray(_oracle.hann(win_length, periodic=True).astype(np.float32))
    frames = frames * win
    n_pad = 1024  # >= 2*win-1 so circular == linear autocorrelation
    re, im = dft.rdft(frames, n_pad)
    P = re * re + im * im
    M = jnp.asarray(_iac_matrix(n_pad, win_length))
    ac = jnp.matmul(P, M, precision=MM_PRECISION)  # [..., T, win]
    ac = ac.swapaxes(-1, -2)
    length = jnp.max(jnp.abs(ac), axis=-2, keepdims=True)
    length = jnp.where(length < np.finfo(np.float32).tiny, 1.0, length)
    return ac / length
