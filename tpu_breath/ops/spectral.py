"""Batched STFT / mel spectrogram ops (JAX, matmul-DFT based).

Batched replacement for the librosa spectral stack the reference uses
(reference src/precompute/process.py:32-41,51,59-62). Everything is batched
over clips and static-shaped; filterbank/DFT matrices are trace-time
constants shared with the NumPy oracle so the two paths can only diverge in
the compute graph, which is what the parity tests pin down.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from tpu_breath.baseline import dsp_np as _oracle
from tpu_breath.ops import dft

MM_PRECISION = lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=MM_PRECISION)


@functools.lru_cache(maxsize=None)
def _hann(n: int, periodic: bool = True) -> np.ndarray:
    return _oracle.hann(n, periodic).astype(np.float32)


@functools.lru_cache(maxsize=None)
def mel_matrix(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
               fmax: float | None = None) -> np.ndarray:
    """[n_mels, n_fft//2+1] Slaney-normalized mel filterbank (trace-time const)."""
    return _oracle.mel_filterbank(sr, n_fft, n_mels, fmin, fmax).astype(np.float32)


def frame_signal(y: jax.Array, frame_length: int, hop_length: int,
                 n_frames: int) -> jax.Array:
    """y[..., n] -> [..., n_frames, frame_length] (time-major for matmul).

    When hop divides the frame length (every STFT here: 512/256, 2048/256),
    framing is hop-sized blocks re-viewed with k overlapping shifts — pure
    reshape + slice + concat, ZERO gathers. The general case falls back to
    an index gather."""
    g = int(np.gcd(frame_length, hop_length))
    if g >= 8:  # lane-friendly block width; g==1 cases keep the gather
        k = frame_length // g       # blocks per frame
        s = hop_length // g         # block stride between frames
        nb = (n_frames - 1) * s + k
        need = nb * g
        n = y.shape[-1]
        if need > n:
            pad = [(0, 0)] * (y.ndim - 1) + [(0, need - n)]
            y = jnp.pad(y, pad)
        blocks = y[..., :need].reshape(*y.shape[:-1], nb, g)
        stop = (n_frames - 1) * s + 1
        return jnp.concatenate(
            [blocks[..., j:j + stop:s, :] for j in range(k)], axis=-1)
    idx = (np.arange(n_frames)[:, None] * hop_length
           + np.arange(frame_length)[None, :])
    return y[..., idx]


@functools.lru_cache(maxsize=None)
def _blockdft_consts(n_fft: int, hop: int, window: str) -> np.ndarray:
    """Stacked per-block windowed DFT bases for the shifted-block STFT:
    [hop, k*2*F] where k = n_fft//hop, F = n_fft//2+1; block j's columns are
    (C | -S) rows j*hop:(j+1)*hop of the window-folded real-DFT basis."""
    k = n_fft // hop
    f = n_fft // 2 + 1
    kk = np.arange(n_fft)[:, None]
    ff = np.arange(f)[None, :]
    ang = 2.0 * np.pi * kk * ff / n_fft
    c, s = np.cos(ang), -np.sin(ang)
    if window == "hann":
        w = _oracle.hann(n_fft, True)[:, None]
        c, s = c * w, s * w
    parts = []
    for j in range(k):
        parts.append(c[j * hop:(j + 1) * hop])
        parts.append(s[j * hop:(j + 1) * hop])
    return np.concatenate(parts, axis=1).astype(np.float32)


def stft_ri(y: jax.Array, n_fft: int, hop_length: int,
            window: str = "hann") -> tuple[jax.Array, jax.Array]:
    """librosa.stft semantics (center=True, zero pad, periodic hann).
    y[..., n] -> (re, im) each [..., 1 + n//hop, n_fft//2 + 1], time-major.

    When hop divides n_fft, computed as a shifted-block DFT: the signal is
    viewed as hop-sized blocks (a reshape, no frame materialization or
    gather), ONE [nb, hop] x [hop, k*2F] GEMM produces every block's partial
    response, and D[t] = sum_j partial[t+j, block j] — k static slices + adds.
    Identical FLOPs to the framed matmul, none of the frame traffic."""
    n = y.shape[-1]
    n_frames = 1 + n // hop_length
    k = n_fft // hop_length if n_fft % hop_length == 0 else 0
    f_bins = n_fft // 2 + 1
    # k<=4: beyond that the stacked basis grows k-fold and loses to the
    # Cooley-Tukey framed path (measured: n_fft 2048 / hop 256, k=8, was 3x
    # slower via blocks)
    if 1 <= k <= 4:
        nb = n_frames - 1 + k
        need = nb * hop_length
        lead = n_fft // 2
        pad = [(0, 0)] * (y.ndim - 1) + [(lead, max(0, need - n - lead))]
        ypad = jnp.pad(y, pad)[..., :need]
        blocks = ypad.reshape(*y.shape[:-1], nb, hop_length)
        big = jnp.asarray(_blockdft_consts(n_fft, hop_length, window))
        prod = _mm(blocks, big)  # [..., nb, k*2F]
        re = jnp.zeros((*y.shape[:-1], n_frames, f_bins), jnp.float32)
        im = jnp.zeros_like(re)
        for j in range(k):
            sl = prod[..., j:j + n_frames, 2 * j * f_bins:(2 * j + 1) * f_bins]
            re = re + sl
            sl = prod[..., j:j + n_frames,
                      (2 * j + 1) * f_bins:(2 * j + 2) * f_bins]
            im = im + sl
        return re, im
    pad = [(0, 0)] * (y.ndim - 1) + [(n_fft // 2, n_fft // 2)]
    ypad = jnp.pad(y, pad)
    frames = frame_signal(ypad, n_fft, hop_length, n_frames)
    if window == "hann":
        frames = frames * jnp.asarray(_hann(n_fft))
    return dft.rdft(frames, n_fft)


@functools.lru_cache(maxsize=None)
def _framedft_consts(n_fft: int, window: str) -> np.ndarray:
    """Window-folded real-DFT basis [n_fft, 2F] = (w*C | -w*S), float64-built
    then rounded once to f32. Folding the window into the basis keeps the
    frames themselves exact (raw signal values), so a compensated GEMM sees
    error-free inputs."""
    kk = np.arange(n_fft)[:, None]
    ff = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * kk * ff / n_fft
    c, s = np.cos(ang), -np.sin(ang)
    if window == "hann":
        w = _oracle.hann(n_fft, True)[:, None]
        c, s = c * w, s * w
    return np.concatenate([c, s], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _framedft_consts_dd(n_fft: int, window: str
                        ) -> tuple[np.ndarray, np.ndarray]:
    """The window-folded real-DFT basis as a double-float pair (hi, lo):
    hi = f32(basis64), lo = f32(basis64 - hi). Carrying the constant's own
    rounding tail through the compensated GEMM makes the product approximate
    frames @ basis64 — the oracle's float64 STFT — instead of the f32-rounded
    basis (whose rounding alone contributes ~3e-7 absolute)."""
    kk = np.arange(n_fft)[:, None]
    ff = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * kk * ff / n_fft
    c, s = np.cos(ang), -np.sin(ang)
    if window == "hann":
        w = _oracle.hann(n_fft, True)[:, None]
        c, s = c * w, s * w
    b64 = np.concatenate([c, s], axis=1)
    hi = b64.astype(np.float32)
    lo = (b64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def stft_ri_dd(y: jax.Array, n_fft: int, hop_length: int, chunk: int = 64):
    """STFT real/imag parts as double-float pairs (re_h, re_l, im_h, im_l),
    each [..., T, F] time-major. The DFT runs through the compensated GEMM
    (dd.matmul_dd_pair) against the dd-carried float64 basis, so the pairs
    track the oracle's float64 STFT to ~1e-7 absolute (slice-accumulation
    floor; PARITY.md)."""
    from tpu_breath.ops import dd
    n = y.shape[-1]
    n_frames = 1 + n // hop_length
    f_bins = n_fft // 2 + 1
    pad = [(0, 0)] * (y.ndim - 1) + [(n_fft // 2, n_fft // 2)]
    frames = frame_signal(jnp.pad(y, pad), n_fft, hop_length, n_frames)
    b_hi, b_lo = _framedft_consts_dd(n_fft, "hann")
    h, l = dd.matmul_dd_pair(frames, jnp.asarray(b_hi), chunk=chunk,
                             b_lo=jnp.asarray(b_lo))
    return (h[..., :f_bins], l[..., :f_bins],
            h[..., f_bins:], l[..., f_bins:])


def stft_mag_cr(y: jax.Array, n_fft: int, hop_length: int,
                chunk: int = 64) -> jax.Array:
    """|STFT| rounded ONCE from quasi-float64: dd DFT pair -> dd squares ->
    dd sqrt -> f32. Matches the oracle's f32(|STFT_float64|) except where the
    true magnitude sits within ~1e-7 of an f32 rounding boundary — the chain
    that feeds the tuning-estimate histogram (ops/chroma.py), whose near-tied
    argmax flips on single-ulp |S| differences (PARITY.md; flip diagnosed in
    tools/flip_hunt.py). Layout [..., F, T] like stft_mag."""
    from tpu_breath.ops import dd
    re_h, re_l, im_h, im_l = stft_ri_dd(y, n_fft, hop_length, chunk=chunk)
    s_h, s_l = dd._dd_add(*dd._dd_mul(re_h, re_l, re_h, re_l),
                          *dd._dd_mul(im_h, im_l, im_h, im_l))
    return dd.sqrt_dd(s_h, s_l).swapaxes(-1, -2)


def stft_mag_dd(y: jax.Array, n_fft: int, hop_length: int,
                chunk: int = 64) -> jax.Array:
    """|STFT| via the compensated GEMM (dd.matmul_dd): ~100x lower absolute
    error than the plain block-DFT, for channels whose normalization
    amplifies matmul rounding past the parity budget (the gammatone z-score,
    PARITY.md). Layout [..., F, T] like stft_mag. Superseded by stft_mag_cr
    (round-once magnitude) on the production graph."""
    from tpu_breath.ops import dd
    n = y.shape[-1]
    n_frames = 1 + n // hop_length
    f_bins = n_fft // 2 + 1
    pad = [(0, 0)] * (y.ndim - 1) + [(n_fft // 2, n_fft // 2)]
    frames = frame_signal(jnp.pad(y, pad), n_fft, hop_length, n_frames)
    basis = jnp.asarray(_framedft_consts(n_fft, "hann"))
    ri = dd.matmul_dd(frames, basis, chunk=chunk)  # [..., T, 2F]
    re, im = ri[..., :f_bins], ri[..., f_bins:]
    return jnp.sqrt(re * re + im * im).swapaxes(-1, -2)


def stft_mag(y: jax.Array, n_fft: int, hop_length: int) -> jax.Array:
    """|STFT|, layout [..., F, T] to mirror librosa."""
    re, im = stft_ri(y, n_fft, hop_length)
    return jnp.sqrt(re * re + im * im).swapaxes(-1, -2)


def stft_power(y: jax.Array, n_fft: int, hop_length: int) -> jax.Array:
    re, im = stft_ri(y, n_fft, hop_length)
    return (re * re + im * im).swapaxes(-1, -2)


def melspectrogram(y: jax.Array, sr: int, n_fft: int, hop_length: int,
                   n_mels: int, fmin: float = 0.0, fmax: float | None = None,
                   power: float = 2.0) -> jax.Array:
    """[..., n_mels, T]. power=2 path avoids the sqrt entirely."""
    re, im = stft_ri(y, n_fft, hop_length)
    p = re * re + im * im  # [..., T, F]
    if power == 1.0:
        p = jnp.sqrt(p)
    fb = jnp.asarray(mel_matrix(sr, n_fft, n_mels, fmin, fmax))
    return _mm(p, fb.T).swapaxes(-1, -2)


def power_to_db(S: jax.Array, ref_max: bool = False, amin: float = 1e-10,
                top_db: float | None = 80.0,
                reduce_axes: tuple[int, ...] = (-2, -1)) -> jax.Array:
    """librosa.power_to_db. ref_max=True uses the per-clip max over
    reduce_axes as the reference (ref=np.max in the reference pipeline,
    src/precompute/process.py:33)."""
    log_spec = 10.0 * jnp.log10(jnp.maximum(amin, S))
    if ref_max:
        ref_db = 10.0 * jnp.log10(jnp.maximum(
            amin, jnp.max(S, axis=reduce_axes, keepdims=True)))
        log_spec = log_spec - ref_db
    if top_db is not None:
        log_spec = jnp.maximum(
            log_spec, jnp.max(log_spec, axis=reduce_axes, keepdims=True) - top_db)
    return log_spec


def znorm(x: jax.Array, axes: tuple[int, ...] = (-2, -1),
          eps: float = 1e-8) -> jax.Array:
    """Global (or per-row) z-score with the reference's epsilon placement:
    (x - mean) / (std + 1e-8) (src/precompute/process.py:36)."""
    mean = jnp.mean(x, axis=axes, keepdims=True)
    var = jnp.mean((x - mean) ** 2, axis=axes, keepdims=True)
    return (x - mean) / (jnp.sqrt(var) + eps)


def pad_time_min(x: jax.Array, t_fixed: int) -> jax.Array:
    """Pad/truncate the time axis (last) filling with the per-clip min
    (reference src/precompute/methods.py:30-37)."""
    t = x.shape[-1]
    if t >= t_fixed:
        return x[..., :t_fixed]
    minv = jnp.min(x, axis=(-2, -1), keepdims=True)
    pad_block = jnp.broadcast_to(minv, x.shape[:-1] + (t_fixed - t,))
    return jnp.concatenate([x, pad_block], axis=-1)


def pad_freq_min(x: jax.Array, to_bins: int) -> jax.Array:
    """Pad/truncate the freq axis (second-to-last) filling with the per-clip
    min (reference src/precompute/methods.py:39-46)."""
    f = x.shape[-2]
    if f >= to_bins:
        return x[..., :to_bins, :]
    minv = jnp.min(x, axis=(-2, -1), keepdims=True)
    pad_block = jnp.broadcast_to(minv, x.shape[:-2] + (to_bins - f, x.shape[-1]))
    return jnp.concatenate([x, pad_block], axis=-2)
