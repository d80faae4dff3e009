"""Constant-Q transform + CENS chroma (JAX, batched, librosa-faithful).

This implements librosa's ACTUAL recursive multirate CQT algorithm
(librosa 0.10 vqt: per-octave FFT-basis correlation at successively halved
sample rates), not just the textbook direct transform — including the
per-clip tuning estimation chroma_cens performs when called with y=
(reference src/precompute/process.py:53 calls
librosa.feature.chroma_cens(y=y, ...), which estimates tuning via piptrack).

The recursion collapses to fully static XLA-friendly shapes because the bins
are geometric with bins_per_octave filters per octave: the normalized
frequencies (f/sr) and sample-lengths of every octave's filters are
IDENTICAL, so one [bpo, n_fft//2+1] FFT basis serves all octaves, and the
sqrt(sr/my_sr) downsample compensation cancels exactly against the final
1/sqrt(lengths) scaling. Per octave the work is one 512-point ones-window
STFT (matmul-DFT) of the decimated signal and one tiny complex matmul.
Tuning takes only the 100 discrete histogram-edge values, so the 100
tuning-shifted bases are precomputed EXACTLY as librosa builds them
(float-length arange kernels, l1 norm, x lengths/n_fft, FFT,
sparsify_rows 1%) and gathered per clip by the estimated tuning index.

The 2:1 octave decimation matches librosa's res_type='polyphase' mode
bit-for-bit (scipy.signal.resample_poly(y, 1, 2): 41-tap kaiser-5.0 FIR,
full-conv offset 20, ceil(n/2) length, x sqrt(2) for scale=True); librosa's
default soxr_hq resampler differs by a bounded ripple measured in PARITY.md.

A direct single-GEMM CQT (cqt_mag below) is kept for comparison; it computes
the transform the multirate algorithm approximates but does NOT match
librosa's per-bin scaling (librosa's response is sqrt(length)-weighted).
"""
from __future__ import annotations

import functools

import numpy as np
import scipy.signal
import jax
import jax.numpy as jnp
from jax import lax

from tpu_breath.baseline import dsp_np as _oracle
from tpu_breath.ops import spectral
from tpu_breath.ops import chroma as chroma_ops

MM_PRECISION = lax.Precision.HIGHEST


@functools.lru_cache(maxsize=None)
def _kernel_consts(sr: int, fmin: float, n_bins: int, bins_per_octave: int):
    """(k_re, k_im [n_bins, L_pad], inv_sqrt_len [n_bins], L_pad, half)."""
    kernels, lengths = _oracle.cqt_kernel_bank(sr, fmin, n_bins, bins_per_octave)
    max_len = kernels.shape[1]
    l_pad = -(-max_len // 128) * 128  # pad to lane multiple
    k = np.zeros((n_bins, l_pad), dtype=np.complex128)
    k[:, :max_len] = np.conj(kernels)
    inv_sqrt = (1.0 / np.sqrt(lengths)).astype(np.float32)
    return (k.real.astype(np.float32), k.imag.astype(np.float32),
            inv_sqrt, l_pad, max_len // 2)


def cqt_mag(y: jax.Array, sr: int, hop_length: int, fmin: float,
            n_bins: int, bins_per_octave: int) -> jax.Array:
    """|CQT| of y[..., n] -> [..., n_bins, 1 + n//hop], scale=True semantics."""
    k_re, k_im, inv_sqrt, l_pad, half = _kernel_consts(
        sr, fmin, n_bins, bins_per_octave)
    n = y.shape[-1]
    n_frames = 1 + n // hop_length
    pad = [(0, 0)] * (y.ndim - 1) + [(half, l_pad)]
    ypad = jnp.pad(y, pad)
    idx = (np.arange(n_frames)[:, None] * hop_length
           + np.arange(l_pad)[None, :])
    frames = ypad[..., idx]  # [..., T, L]
    re = jnp.einsum("...tl,kl->...kt", frames, jnp.asarray(k_re),
                    precision=MM_PRECISION)
    im = jnp.einsum("...tl,kl->...kt", frames, jnp.asarray(k_im),
                    precision=MM_PRECISION)
    mag = jnp.sqrt(re * re + im * im)
    return mag * jnp.asarray(inv_sqrt)[:, None]


# ---------------------------------------------------------------------------
# Multirate CQT (librosa 0.10 vqt recursion; see module docstring)
# ---------------------------------------------------------------------------

_TUNING_RESOLUTION = 0.01


@functools.lru_cache(maxsize=None)
def _vqt_consts(sr: int, fmin: float, bins_per_octave: int,
                n_octaves: int = 7):
    """Precompute, for each of the 100 possible tuning values, the shared
    per-octave FFT basis with all scale factors folded in so that
    C[octave o] = basis @ STFT_ones(y_decimated_o).

    Derivation: librosa scales fft_basis by sqrt(sr/my_sr) = 2**(o/2) at
    octave o and finally divides by sqrt(lengths_at_full_rate); lengths in
    octave o are lengths_top * 2**o, so both 2**(o/2) factors cancel and
    basis = fft_basis_top / sqrt(lengths_top) serves every octave.
    Returns (bases_re, bases_im [n_tunings, bpo, n_fft//2+1] f32, n_fft,
    fir_taps [41])."""
    n_t = int(np.ceil(1.0 / _TUNING_RESOLUTION))
    n_fft_ref = None
    bases_re, bases_im = [], []
    for ti in range(n_t):
        tau = -0.5 + ti * _TUNING_RESOLUTION
        fmin_t = fmin * 2.0 ** (tau / bins_per_octave)
        k = np.arange((n_octaves - 1) * bins_per_octave,
                      n_octaves * bins_per_octave)
        freqs_top = fmin_t * 2.0 ** (k / bins_per_octave)
        fft_basis, n_fft = _oracle._vqt_filter_fft(
            sr, freqs_top, bins_per_octave)
        lengths, _ = _oracle.wavelet_lengths(
            freqs_top, sr, bins_per_octave=bins_per_octave)
        b = fft_basis / np.sqrt(lengths)[:, None]
        if n_fft_ref is None:
            n_fft_ref = n_fft
        assert n_fft == n_fft_ref, "basis n_fft must be tuning-independent"
        bases_re.append(b.real.astype(np.float32))
        bases_im.append(b.imag.astype(np.float32))
    taps = scipy.signal.firwin(41, 0.5, window=("kaiser", 5.0))
    return (np.stack(bases_re), np.stack(bases_im), n_fft_ref,
            taps.astype(np.float32))


def decimate2(y: jax.Array, taps: np.ndarray) -> jax.Array:
    """librosa.resample(y, orig_sr=2, target_sr=1, res_type='polyphase',
    scale=True), bit-matching scipy.signal.resample_poly(y, 1, 2): full
    convolution with the 41-tap kaiser FIR, offset 20, stride 2, ceil(n/2)
    samples, then / sqrt(1/2)."""
    n = y.shape[-1]
    n_out = -(-n // 2)
    pad = [(0, 0)] * (y.ndim - 1) + [(20, 21)]
    ypad = jnp.pad(y, pad)
    frames = spectral.frame_signal(ypad, len(taps), 2, n_out)
    dec = jnp.matmul(frames, jnp.asarray(taps[::-1].copy()),
                     precision=MM_PRECISION)
    return dec * np.float32(np.sqrt(2.0))


@functools.lru_cache(maxsize=None)
def _vqt_time_kernels(sr: int, fmin: float, bins_per_octave: int,
                      n_octaves: int = 7):
    """Tuning-gathered TIME-DOMAIN response kernels: for each of the 100
    tuning values, K[k, l] = sum_f basis[k, f] * exp(-2pi i f l / n_fft) —
    the per-octave FFT-basis projection (basis @ STFT) folded with the DFT
    itself into one constant, built in float64 and rounded once.

    C[octave][k, t] = sum_f basis[k,f] D[t,f] = sum_l frames[t,l] K[k,l],
    so each octave's response is ONE batched [T, n_fft] x [n_fft, 2*bpo]
    GEMM instead of a full 512-pt STFT plus four [bpo, F] projections, with
    the f64-exact kernel replacing two separately-rounded f32 constants.

    Returns ([n_tunings, 2*bpo, n_fft] packed (re | im), n_fft, fir_taps)."""
    n_t = int(np.ceil(1.0 / _TUNING_RESOLUTION))
    outs = []
    n_fft_ref = None
    for ti in range(n_t):
        tau = -0.5 + ti * _TUNING_RESOLUTION
        fmin_t = fmin * 2.0 ** (tau / bins_per_octave)
        k = np.arange((n_octaves - 1) * bins_per_octave,
                      n_octaves * bins_per_octave)
        freqs_top = fmin_t * 2.0 ** (k / bins_per_octave)
        fft_basis, n_fft = _oracle._vqt_filter_fft(
            sr, freqs_top, bins_per_octave)
        lengths, _ = _oracle.wavelet_lengths(
            freqs_top, sr, bins_per_octave=bins_per_octave)
        b = fft_basis / np.sqrt(lengths)[:, None]
        if n_fft_ref is None:
            n_fft_ref = n_fft
        assert n_fft == n_fft_ref, "kernel n_fft must be tuning-independent"
        E = np.exp(-2j * np.pi * np.outer(np.arange(n_fft // 2 + 1),
                                          np.arange(n_fft)) / n_fft)
        Kt = b @ E  # [bpo, n_fft] complex128
        outs.append(np.concatenate([Kt.real, Kt.imag], axis=0)
                    .astype(np.float32))
    taps = scipy.signal.firwin(41, 0.5, window=("kaiser", 5.0))
    return np.stack(outs), n_fft_ref, taps.astype(np.float32)


def cqt_mag_multirate(y: jax.Array, tuning_idx: jax.Array, sr: int,
                      hop_length: int, fmin: float, bins_per_octave: int,
                      n_octaves: int) -> jax.Array:
    """|CQT| via librosa's recursion. y[..., n], tuning_idx[...] int32 (the
    estimate_tuning histogram index) -> [..., n_bins, 1 + n//hop] with
    librosa cqt(scale=True) semantics. Per octave: frame the (decimated)
    signal and apply the tuning-gathered time-domain kernels
    (_vqt_time_kernels) in one batched GEMM."""
    K_all, n_fft, taps = _vqt_time_kernels(sr, fmin, bins_per_octave,
                                           n_octaves)
    K = jnp.asarray(K_all)[tuning_idx]  # [..., 2*bpo, n_fft]
    bpo = bins_per_octave
    octaves = []
    my_y, my_hop = y, hop_length
    for o in range(n_octaves):
        assert my_hop >= 1
        n = my_y.shape[-1]
        n_frames = 1 + n // my_hop  # stft_ri center=True framing
        pad = [(0, 0)] * (y.ndim - 1) + [(n_fft // 2, n_fft // 2)]
        frames = spectral.frame_signal(jnp.pad(my_y, pad), n_fft, my_hop,
                                       n_frames)
        resp = jnp.einsum("...tl,...kl->...kt", frames, K,
                          precision=MM_PRECISION)
        rr, ri = resp[..., :bpo, :], resp[..., bpo:, :]
        octaves.append(jnp.sqrt(rr * rr + ri * ri))
        if o < n_octaves - 1:
            assert my_hop % 2 == 0, "hop must have n_octaves-1 factors of 2"
            my_hop //= 2
            my_y = decimate2(my_y, taps)
    # octaves[0] is the TOP octave; stack lowest-first like __trim_stack
    n_frames = min(oc.shape[-1] for oc in octaves)
    return jnp.concatenate([oc[..., :n_frames] for oc in octaves[::-1]],
                           axis=-2)


def cqt_mag_multirate_spectral(y: jax.Array, tuning_idx: jax.Array, sr: int,
                               hop_length: int, fmin: float,
                               bins_per_octave: int,
                               n_octaves: int) -> jax.Array:
    """The pre-round-4 layout (kept as the A/B reference for
    tests/test_ops_parity.py): per octave a full ones-window 512-pt STFT of
    the decimated signal, then four [bpo, F] x [F, T] basis projections.
    Mathematically identical to cqt_mag_multirate up to GEMM associativity
    (the fused kernel evaluates basis @ DFT in float64 at trace time)."""
    b_re, b_im, n_fft, taps = _vqt_consts(sr, fmin, bins_per_octave, n_octaves)
    basis_re = jnp.asarray(b_re)[tuning_idx]  # [..., bpo, F]
    basis_im = jnp.asarray(b_im)[tuning_idx]
    octaves = []
    my_y, my_hop = y, hop_length
    for o in range(n_octaves):
        assert my_hop >= 1
        d_re, d_im = spectral.stft_ri(my_y, n_fft, my_hop, window="ones")
        # complex (basis @ D): D is time-major [..., T, F]
        rr = (jnp.einsum("...kf,...tf->...kt", basis_re, d_re,
                         precision=MM_PRECISION)
              - jnp.einsum("...kf,...tf->...kt", basis_im, d_im,
                           precision=MM_PRECISION))
        ri = (jnp.einsum("...kf,...tf->...kt", basis_re, d_im,
                         precision=MM_PRECISION)
              + jnp.einsum("...kf,...tf->...kt", basis_im, d_re,
                           precision=MM_PRECISION))
        octaves.append(jnp.sqrt(rr * rr + ri * ri))
        if o < n_octaves - 1:
            assert my_hop % 2 == 0, "hop must have n_octaves-1 factors of 2"
            my_hop //= 2
            my_y = decimate2(my_y, taps)
    n_frames = min(oc.shape[-1] for oc in octaves)
    return jnp.concatenate([oc[..., :n_frames] for oc in octaves[::-1]],
                           axis=-2)


@functools.lru_cache(maxsize=None)
def _cq_to_chroma(n_bins: int, bins_per_octave: int, n_chroma: int,
                  fmin: float) -> np.ndarray:
    return _oracle.cq_to_chroma(n_bins, bins_per_octave, n_chroma, fmin
                                ).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _cens_window(win_len_smooth: int) -> np.ndarray:
    win = _oracle.hann(win_len_smooth + 2, periodic=False)
    return (win / win.sum()).astype(np.float32)


def _norm_cols(x: jax.Array, norm: int) -> jax.Array:
    if norm == 1:
        length = jnp.sum(jnp.abs(x), axis=-2, keepdims=True)
    else:
        length = jnp.sqrt(jnp.sum(x * x, axis=-2, keepdims=True))
    length = jnp.where(length < np.finfo(np.float32).tiny, 1.0, length)
    return x / length


def chroma_cens(y: jax.Array, sr: int, hop_length: int, fmin: float,
                n_chroma: int = 12, bins_per_octave: int = 36,
                n_octaves: int = 7, win_len_smooth: int = 41,
                stft2048_mag: jax.Array | None = None) -> jax.Array:
    """y[..., n] -> CENS chroma [..., n_chroma, T], the full librosa
    chroma_cens(y=...) path: per-clip tuning estimation (piptrack on
    |STFT(2048, hop 512)|, bins_per_octave-resolution histogram), multirate
    CQT, chroma fold, l1 norm, 4-level quantization, Hann smoothing, l2 norm.

    stft2048_mag: optional precomputed |STFT(n_fft=2048, hop=hop_length)|
    [..., F, T] — tuning uses its even-indexed frames (hop 512 = 2*hop
    frames are a subset of hop-256 frames), saving a second 2048-pt DFT.
    """
    if stft2048_mag is None:
        stft2048_mag = spectral.stft_mag(y, 2048, hop_length)
    # piptrack's own hop is n_fft//4 = 512 = 2*hop_length
    assert 2048 // 4 == 2 * hop_length, "tuning frame subset needs hop 256"
    s_pip = stft2048_mag[..., ::2]
    tune_fn = functools.partial(chroma_ops.estimate_tuning_index, sr=sr,
                                n_fft=2048, bins_per_octave=bins_per_octave)
    for _ in range(y.ndim - 1):
        tune_fn = jax.vmap(tune_fn)
    with jax.named_scope("tuning"):
        tuning_idx = tune_fn(s_pip)
    n_bins = n_octaves * bins_per_octave
    with jax.named_scope("cqt"):
        C = cqt_mag_multirate(y, tuning_idx, sr, hop_length, fmin,
                              bins_per_octave, n_octaves)
    # cq_to_chroma's tuning-dependent roll is round(midi(fmin_t) mod 12 *
    # n_chroma/12) = 0 for every representable tuning here (|tuning/3| < 0.5
    # semitone), so the fold matrix is a static constant.
    ctc = jnp.asarray(_cq_to_chroma(n_bins, bins_per_octave, n_chroma, fmin))
    chroma = jnp.einsum("ck,...kt->...ct", ctc, C, precision=MM_PRECISION)
    chroma = _norm_cols(chroma, 1)
    quant = jnp.zeros_like(chroma)
    for step in (0.4, 0.2, 0.1, 0.05):
        quant = quant + 0.25 * (chroma > step).astype(chroma.dtype)
    # 'same' convolution along time with the (win_len_smooth+2)-point window
    win = _cens_window(win_len_smooth)
    w = len(win)
    t = chroma.shape[-1]
    qpad = jnp.pad(quant, [(0, 0)] * (quant.ndim - 1) + [(w // 2, w - 1 - w // 2)])
    idx = np.arange(t)[:, None] + np.arange(w)[None, :]
    smoothed = jnp.einsum("...ctw,w->...ct", qpad[..., idx], jnp.asarray(win),
                          precision=MM_PRECISION)
    return _norm_cols(smoothed, 2)
