"""STFT chroma with per-clip tuning estimation (JAX, batched).

Replaces librosa.feature.chroma_stft as used by the reference
(src/precompute/process.py:52). The pitch-track -> residual-histogram tuning
estimate is fully static-shaped: candidate masks replace librosa's dynamic
index arrays, the masked median is a radix select, and the 100-bin histogram
is a compare-reduce against np.histogram's exact bin edges. The chroma
filterbank depends on the traced tuning scalar only
as a shift of the log-frequency bins, so it is rebuilt per clip with cheap
[12, n_fft] elementwise math.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

MM_PRECISION = lax.Precision.HIGHEST
_A440_OVER16 = 27.5  # A440 / 16


def _localmax(x: jax.Array, axis: int) -> jax.Array:
    """librosa.util.localmax: > predecessor, >= successor, edge-padded."""
    pad = [(0, 0)] * x.ndim
    pad[axis] = (1, 1)
    xp = jnp.pad(x, pad, mode="edge")
    lo = [slice(None)] * x.ndim
    lo[axis] = slice(0, -2)
    hi = [slice(None)] * x.ndim
    hi[axis] = slice(2, None)
    return (x > xp[tuple(lo)]) & (x >= xp[tuple(hi)])


def piptrack(S: jax.Array, sr: float, n_fft: int, fmin: float = 150.0,
             fmax: float = 4000.0, threshold: float = 0.1):
    """Parabolic-interpolation pitch tracking on magnitudes S[F, T].

    The parabolic-shift division uses the correctly-rounded dd.div_cr: the
    resulting pitches feed a near-tied histogram argmax (estimate_tuning),
    where the ~1-ulp slop of the backend's native divide flips bins (see
    ops/dd.py and PARITY.md)."""
    from tpu_breath.ops import dd
    fmax = min(fmax, sr / 2.0)
    F = S.shape[0]
    fft_freqs = np.linspace(0, sr / 2, F)
    avg = 0.5 * (S[2:, :] - S[:-2, :])
    shift = 2 * S[1:-1, :] - S[2:, :] - S[:-2, :]
    tiny = np.finfo(np.float32).tiny
    shift = dd.div_cr(avg, shift + (jnp.abs(shift) < tiny))
    avg = jnp.pad(avg, ((1, 1), (0, 0)))
    shift = jnp.pad(shift, ((1, 1), (0, 0)))
    dskew = 0.5 * avg * shift
    freq_mask = jnp.asarray(((fmin <= fft_freqs) & (fft_freqs < fmax))[:, None])
    ref_value = threshold * jnp.max(S, axis=0, keepdims=True)
    idx = freq_mask & _localmax(S * freq_mask, axis=0) & (S > ref_value)
    bins = jnp.arange(F, dtype=S.dtype)[:, None]
    pitches = jnp.where(idx, (bins + shift) * float(sr) / n_fft, 0.0)
    mags = jnp.where(idx, S + dskew, 0.0)
    return pitches, mags


def _masked_median(values: jax.Array, mask: jax.Array) -> jax.Array:
    """np.median over values[mask] (0.0 if empty), sort-free via radix
    select (ops/select.py)."""
    from tpu_breath.ops import select
    return select.masked_median(values, mask)


def hist_compare_reduce(flat_r: jax.Array, flat_sel: jax.Array,
                        edges: jax.Array) -> jax.Array:
    """The production histogram stage: compare-and-reduce (no scatter-add)
    against np.histogram's exact (f32-adjusted) bin edges —
    bin b counts residuals in [edge_b, edge_{b+1}), identical to
    searchsorted."""
    ge = flat_r[None, :] >= edges[:, None]  # [n_bins+1, N]
    return jnp.sum(ge[:-1] & ~ge[1:] & flat_sel[None, :],
                   axis=1, dtype=jnp.int32)


@functools.lru_cache(maxsize=None)
def _band_rows(F: int, sr: float, fmin: float = 150.0,
               fmax: float = 4000.0) -> tuple[int, int]:
    """Static row slice [lo, hi) covering the piptrack candidate band
    [fmin, fmax) plus a one-row margin each side (the localmax and parabolic
    stencils read +/-1 neighbors). Rows outside this slice can never be
    selected (freq_mask is False there), so the tuning chain's elementwise
    dd transcendentals and histogram compares skip ~55% of the grid with
    bit-identical results (tests/test_ops_parity.py)."""
    fft_freqs = np.linspace(0, sr / 2, F)
    band = (fft_freqs >= fmin) & (fft_freqs < min(fmax, sr / 2.0))
    lo = max(int(np.argmax(band)) - 1, 0)
    hi = min(F - int(np.argmax(band[::-1])) + 1, F)
    return lo, hi


def _piptrack_band(S: jax.Array, sr: float, n_fft: int,
                   fmin: float = 150.0, fmax: float = 4000.0,
                   threshold: float = 0.1):
    """piptrack restricted to the static candidate-band row slice: returns
    (pitches, mags) of shape [hi-lo, T], bit-identical to the corresponding
    rows of the full-grid piptrack for every selectable bin (margin rows are
    masked to zero exactly like out-of-band rows in the full grid). The
    selection threshold still uses the FULL-spectrum column max."""
    from tpu_breath.ops import dd
    fmax = min(fmax, sr / 2.0)
    F = S.shape[0]
    lo, hi = _band_rows(F, sr, fmin, fmax)
    fft_freqs = np.linspace(0, sr / 2, F)
    ref_value = threshold * jnp.max(S, axis=0, keepdims=True)  # full F
    Sb = S[lo:hi, :]
    avg = 0.5 * (Sb[2:, :] - Sb[:-2, :])
    shift = 2 * Sb[1:-1, :] - Sb[2:, :] - Sb[:-2, :]
    tiny = np.finfo(np.float32).tiny
    shift = dd.div_cr(avg, shift + (jnp.abs(shift) < tiny))
    avg = jnp.pad(avg, ((1, 1), (0, 0)))
    shift = jnp.pad(shift, ((1, 1), (0, 0)))
    dskew = 0.5 * avg * shift
    freqs_b = fft_freqs[lo:hi]
    freq_mask = jnp.asarray(((fmin <= freqs_b) & (freqs_b < fmax))[:, None])
    idx = freq_mask & _localmax(Sb * freq_mask, axis=0) & (Sb > ref_value)
    bins = jnp.arange(lo, hi, dtype=S.dtype)[:, None]
    pitches = jnp.where(idx, (bins + shift) * float(sr) / n_fft, 0.0)
    mags = jnp.where(idx, Sb + dskew, 0.0)
    return pitches, mags


def estimate_tuning_index(S: jax.Array, sr: float, n_fft: int,
                          bins_per_octave: int = 12,
                          resolution: float = 0.01,
                          hist=hist_compare_reduce) -> jax.Array:
    """librosa.estimate_tuning(S=...) as the histogram BIN INDEX (int32 in
    [0, 1/resolution)): tuning = -0.5 + index * resolution. The index form
    lets callers gather tuning-dependent trace-time constants (the CQT FFT
    bases in ops/cqt.py) instead of rebuilding kernels in-graph.

    hist(flat_residual, flat_sel, edges) -> counts[n_bins] is pluggable so
    A/B candidates run through THIS function — the rest of the tuning chain
    is never duplicated."""
    from tpu_breath.ops import dd
    pitches, mags = _piptrack_band(S, sr, n_fft)
    pitch_mask = pitches > 0
    thresh = _masked_median(mags, pitch_mask)
    sel = (mags >= thresh) & pitch_mask
    safe_p = jnp.where(sel, pitches, 1.0)
    # correctly-rounded divide + log2: the residual histogram's modes are
    # tied within +/-1 count on noise clips, so transcendental rounding
    # decides the argmax (ops/dd.py)
    octs = dd.log2_cr(dd.div_cr(safe_p, jnp.full_like(safe_p, _A440_OVER16)))
    residual = jnp.mod(bins_per_octave * octs, 1.0)
    residual = jnp.where(residual >= 0.5, residual - 1.0, residual)
    n_bins = int(np.ceil(1.0 / resolution))
    edges = jnp.asarray(_hist_edges_f32(n_bins))
    counts = hist(residual.ravel(), sel.ravel(), edges)
    best = jnp.argmax(counts).astype(jnp.int32)
    # empty candidate set -> tuning 0.0 -> the index of bin edge 0.0
    return jnp.where(jnp.sum(sel) > 0, best, jnp.int32(n_bins // 2))


def estimate_tuning(S: jax.Array, sr: float, n_fft: int,
                    bins_per_octave: int = 12,
                    resolution: float = 0.01) -> jax.Array:
    """librosa.estimate_tuning(S=...) -> scalar tuning in [-0.5, 0.5) bins."""
    best = estimate_tuning_index(S, sr, n_fft, bins_per_octave, resolution)
    return -0.5 + best.astype(jnp.float32) * resolution


@functools.lru_cache(maxsize=None)
def _hist_edges_f32(n_bins: int) -> np.ndarray:
    """np.histogram bin edges over [-0.5, 0.5], adjusted so f32-vs-f64
    comparisons agree: the oracle (dsp_np.pitch_tuning, matching librosa)
    bins with float64 linspace edges; for a float32 residual r,
    r >= edge_f64 iff r >= (smallest f32 >= edge_f64), so comparing against
    these rounded-up edges makes the device bin assignment IDENTICAL to
    np.histogram's — no flip window at bin boundaries."""
    edges = np.linspace(-0.5, 0.5, n_bins + 1)
    e32 = edges.astype(np.float32)
    low = e32.astype(np.float64) < edges
    e32[low] = np.nextafter(e32[low], np.float32(np.inf))
    return e32


@functools.lru_cache(maxsize=None)
def _chroma_fb_consts(sr: int, n_fft: int, n_chroma: int):
    """Tuning-independent pieces of librosa.filters.chroma."""
    frequencies = np.linspace(0, sr, n_fft, endpoint=False)[1:]
    base = n_chroma * np.log2(frequencies / _A440_OVER16)
    base = np.concatenate(([base[0] - 1.5 * n_chroma], base))
    binwidth = np.concatenate((np.maximum(np.diff(base), 1.0), [1.0]))
    return base.astype(np.float32), binwidth.astype(np.float32)


def chroma_filterbank(tuning: jax.Array, sr: int, n_fft: int,
                      n_chroma: int = 12, ctroct: float = 5.0,
                      octwidth: float = 2.0) -> jax.Array:
    """[n_chroma, 1 + n_fft//2] filterbank for a traced tuning scalar."""
    base, binwidth = _chroma_fb_consts(sr, n_fft, n_chroma)
    frqbins = jnp.asarray(base) - tuning  # hz_to_octs tuning shift
    D = frqbins[None, :] - jnp.arange(n_chroma, dtype=jnp.float32)[:, None]
    half = round(n_chroma / 2)
    D = jnp.remainder(D + half + 10 * n_chroma, n_chroma) - half
    wts = jnp.exp(-0.5 * (2 * D / jnp.asarray(binwidth)[None, :]) ** 2)
    norm = jnp.sqrt(jnp.sum(wts * wts, axis=0, keepdims=True))
    norm = jnp.where(norm < np.finfo(np.float32).tiny, 1.0, norm)
    wts = wts / norm
    wts = wts * jnp.exp(-0.5 * (((frqbins / n_chroma - ctroct) / octwidth) ** 2)
                        )[None, :]
    wts = jnp.roll(wts, -3 * (n_chroma // 12), axis=0)  # base_c
    return wts[:, : n_fft // 2 + 1]


def _norm_inf_cols(x: jax.Array) -> jax.Array:
    length = jnp.max(jnp.abs(x), axis=-2, keepdims=True)
    length = jnp.where(length < np.finfo(np.float32).tiny, 1.0, length)
    return x / length


def chroma_stft_single(S: jax.Array, sr: int, n_chroma: int = 12) -> jax.Array:
    """One clip: S[F, T] magnitudes -> chroma [n_chroma, T]."""
    n_fft = 2 * (S.shape[0] - 1)
    tuning = estimate_tuning(S, sr, n_fft, bins_per_octave=n_chroma)
    fb = chroma_filterbank(tuning, sr, n_fft, n_chroma)
    raw = jnp.matmul(fb, S, precision=MM_PRECISION)
    return _norm_inf_cols(raw)


def chroma_stft(S: jax.Array, sr: int, n_chroma: int = 12) -> jax.Array:
    """Batched: S[..., F, T] -> [..., n_chroma, T]."""
    fn = functools.partial(chroma_stft_single, sr=sr, n_chroma=n_chroma)
    for _ in range(S.ndim - 2):
        fn = jax.vmap(fn)
    return fn(S)
