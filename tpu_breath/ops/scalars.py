"""The 36-dimensional scalar descriptor vector (JAX, batched).

Batched replacement for reference src/precompute/methods.py:48-114: every
librosa/scipy descriptor re-expressed as static-shape batched ops — framing
as gathers, spectral moments as masked reductions, the Hilbert envelope via
the matmul FFT (ops/dft.py), find_peaks via ops/peaks.py, percentiles/medians
via sort+gather. The vector layout matches the reference exactly (and is 36
wide, not the documented 39 — discrepancy D2 in SURVEY.md).
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from tpu_breath.ops import spectral, dft, peaks

MM_PRECISION = lax.Precision.HIGHEST


# -------------------------------------------------------------------------
# framing descriptors
# -------------------------------------------------------------------------

def rms_frames(y: jax.Array, frame_length: int = 2048,
               hop_length: int = 256) -> jax.Array:
    n = y.shape[-1]
    pad = [(0, 0)] * (y.ndim - 1) + [(frame_length // 2, frame_length // 2)]
    yp = jnp.pad(y, pad)
    n_frames = 1 + n // hop_length
    fr = spectral.frame_signal(yp, frame_length, hop_length, n_frames)
    return jnp.sqrt(jnp.mean(fr * fr, axis=-1))


def zcr_frames(y: jax.Array, frame_length: int = 2048, hop_length: int = 256,
               threshold: float = 1e-10) -> jax.Array:
    n = y.shape[-1]
    pad = [(0, 0)] * (y.ndim - 1) + [(frame_length // 2, frame_length // 2)]
    yp = jnp.pad(y, pad, mode="edge")
    yp = jnp.where(jnp.abs(yp) <= threshold, 0.0, yp)
    sign = jnp.signbit(yp)
    n_frames = 1 + n // hop_length
    fr = spectral.frame_signal(sign, frame_length, hop_length, n_frames)
    crossings = fr[..., 1:] != fr[..., :-1]
    # librosa pads the first diff slot with False -> divide by frame_length
    return jnp.sum(crossings, axis=-1).astype(y.dtype) / frame_length


# -------------------------------------------------------------------------
# spectral-shape descriptors (operate on magnitude spectrograms [..., F, T])
# -------------------------------------------------------------------------

def _l1_norm_cols(S: jax.Array) -> jax.Array:
    length = jnp.sum(jnp.abs(S), axis=-2, keepdims=True)
    length = jnp.where(length < np.finfo(np.float32).tiny, 1.0, length)
    return S / length


def spectral_centroid(S: jax.Array, sr: int, n_fft: int) -> jax.Array:
    freq = jnp.asarray(np.linspace(0, sr / 2, 1 + n_fft // 2,
                                   dtype=np.float32))[:, None]
    return jnp.sum(freq * _l1_norm_cols(S), axis=-2)


def spectral_bandwidth(S: jax.Array, sr: int, n_fft: int,
                       p: float = 2.0) -> jax.Array:
    freq = jnp.asarray(np.linspace(0, sr / 2, 1 + n_fft // 2,
                                   dtype=np.float32))[:, None]
    centroid = spectral_centroid(S, sr, n_fft)[..., None, :]
    dev = jnp.abs(freq - centroid)
    return jnp.sum(_l1_norm_cols(S) * dev ** p, axis=-2) ** (1.0 / p)


def spectral_rolloff(S: jax.Array, sr: int, n_fft: int,
                     roll_percent: float = 0.85) -> jax.Array:
    freq = jnp.asarray(np.linspace(0, sr / 2, 1 + n_fft // 2,
                                   dtype=np.float32))[:, None]
    total = jnp.cumsum(S, axis=-2)
    threshold = roll_percent * total[..., -1:, :]
    masked = jnp.where(total < threshold, jnp.inf, freq)
    return jnp.min(masked, axis=-2)


def spectral_flatness(S: jax.Array, amin: float = 1e-10,
                      power: float = 2.0) -> jax.Array:
    S_thresh = jnp.maximum(amin, S ** power)
    gmean = jnp.exp(jnp.mean(jnp.log(S_thresh), axis=-2))
    amean = jnp.mean(S_thresh, axis=-2)
    return gmean / amean


@functools.lru_cache(maxsize=None)
def _contrast_bands(sr: int, n_fft: int, fmin: float = 200.0,
                    n_bands: int = 6, quantile: float = 0.02):
    """Static (start, stop, n_idx) per sub-band, mirroring the oracle's
    dynamic masks (baseline/dsp_np.spectral_contrast)."""
    freq = np.linspace(0, sr / 2, 1 + n_fft // 2)
    octa = np.zeros(n_bands + 2)
    octa[1:] = fmin * (2.0 ** np.arange(0, n_bands + 1))
    bands = []
    for k in range(n_bands + 1):
        f_low, f_high = octa[k], octa[k + 1]
        current = (freq >= f_low) & (freq <= f_high)
        idx = np.flatnonzero(current)
        start, stop = idx[0], idx[-1] + 1
        if k > 0:
            start -= 1
        if k == n_bands:
            stop = len(freq)
        n_in_band = stop - start
        sub_stop = stop if k == n_bands else stop - 1
        n_idx = int(max(np.rint(quantile * n_in_band), 1))
        bands.append((start, sub_stop, n_idx))
    return tuple(bands)


def spectral_contrast(S: jax.Array, sr: int, n_fft: int) -> jax.Array:
    """[..., n_bands+1, T] valley-to-peak contrast in dB."""
    bands = _contrast_bands(sr, n_fft)
    valleys, peaks_ = [], []
    for (start, stop, n_idx) in bands:
        sub = jnp.sort(S[..., start:stop, :], axis=-2)
        valleys.append(jnp.mean(sub[..., :n_idx, :], axis=-2))
        peaks_.append(jnp.mean(sub[..., -n_idx:, :], axis=-2))
    valley = jnp.stack(valleys, axis=-2)
    peak = jnp.stack(peaks_, axis=-2)
    return (spectral.power_to_db(peak, ref_max=False)
            - spectral.power_to_db(valley, ref_max=False))


# -------------------------------------------------------------------------
# statistics helpers
# -------------------------------------------------------------------------

_STABLE_SUM_SPLIT = 128
_STABLE_SUM_MAX = 512


def _row_sum_stable(x: jax.Array) -> jax.Array:
    """Context-stable sum over the last axis.

    XLA tiles a f32 reduce over a LONG axis (the 16,000-sample clip)
    differently depending on the enclosing module: the same
    extract_features body reassociated the accumulation under the fused
    train step's lax.map vs the standalone precompute jit, which broke the
    round-3 fused==cached training identity through exactly the two
    scalars fed by such a reduce — waveform skew/kurtosis
    (tools/fused_identity_probe.py: every other output bit-identical
    across contexts, scalars[29:31] off by ~5e-5 rel). Short-axis
    reductions (frames/bins/mels, <=512 everywhere else in this module)
    compiled bit-stably in every context on both backends, so the fix is
    to express the long sum as two short ones: a static reshape to
    [..., N/128, 128] pins the 128-element partial-sum association in the
    HLO itself, leaving XLA only short reduces to schedule. (A dot against
    an opaque ones vector is 1-ulp context-unstable on the CPU backend used
    by the virtual-mesh tests.)"""
    n = x.shape[-1]
    if n <= _STABLE_SUM_MAX:
        return jnp.sum(x, axis=-1)
    k = _STABLE_SUM_SPLIT
    pad = (-n) % k
    if pad:
        zeros = [(0, 0)] * (x.ndim - 1) + [(0, pad)]
        x = jnp.pad(x, zeros)
    parts = x.reshape(*x.shape[:-1], (n + pad) // k, k)
    return jnp.sum(jnp.sum(parts, axis=-1), axis=-1)


def _skew(x: jax.Array) -> jax.Array:
    """scipy.stats.skew(bias=True) along the last axis."""
    n = x.shape[-1]
    mean = (_row_sum_stable(x) / n)[..., None]
    d = x - mean
    m2 = _row_sum_stable(d * d) / n
    m3 = _row_sum_stable(d * d * d) / n
    return m3 / jnp.maximum(m2, 1e-30) ** 1.5


def _kurtosis(x: jax.Array) -> jax.Array:
    """scipy.stats.kurtosis (Fisher, bias=True) along the last axis."""
    n = x.shape[-1]
    mean = (_row_sum_stable(x) / n)[..., None]
    d = x - mean
    m2 = _row_sum_stable(d * d) / n
    m4 = _row_sum_stable((d * d) * (d * d)) / n
    return m4 / jnp.maximum(m2, 1e-30) ** 2 - 3.0


def _vmap_leading(fn, x: jax.Array, *args):
    """vmap a 1-D-last-axis function over all leading axes of x."""
    f = lambda v: fn(v, *args)
    for _ in range(x.ndim - 1):
        f = jax.vmap(f)
    return f(x)


def _mstd(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    mean = jnp.mean(x, axis=-1)
    var = jnp.mean((x - mean[..., None]) ** 2, axis=-1)
    return mean, jnp.sqrt(var)


# -------------------------------------------------------------------------
# the 36-dim vector
# -------------------------------------------------------------------------

def extract_scalars(y: jax.Array, sr: int = 16_000, hop_length: int = 256,
                    n_fft: int = 512, n_mels: int = 128,
                    stft512_mag: jax.Array | None = None,
                    stft2048_mag: jax.Array | None = None,
                    mel2048_power: jax.Array | None = None) -> jax.Array:
    """y[..., 16000] -> [..., 36]. Layout mirrors reference
    src/precompute/methods.py:48-114 exactly. The stft/mel keyword arguments
    let the feature graph share spectrograms it already computed (the 2048-pt
    mel here is identical to onset_strength's)."""
    feats = []

    rms_v = rms_frames(y, 2048, hop_length)
    zcr_v = zcr_frames(y, 2048, hop_length)
    for v in (rms_v, zcr_v):
        m, s = _mstd(v)
        feats += [m, s, jnp.max(v, axis=-1), jnp.min(v, axis=-1)]

    S2048 = stft2048_mag
    if S2048 is None:
        S2048 = spectral.stft_mag(y, 2048, hop_length)
    # rolloff keeps librosa's default hop of 512; hop-512 frames start at
    # t*512 = (2t)*256, so they are exactly every 2nd hop-256 frame — slice
    # the shared spectrogram instead of paying a second 2048-pt STFT
    if hop_length == 256:
        S2048_h512 = S2048[..., ::2]
    else:
        S2048_h512 = spectral.stft_mag(y, 2048, 512)
    nyq = sr / 2
    centroid = spectral_centroid(S2048, sr, 2048)
    bandwidth = spectral_bandwidth(S2048, sr, 2048)
    rolloff = spectral_rolloff(S2048_h512, sr, 2048)
    flatness = spectral_flatness(S2048)
    contrast = spectral_contrast(S2048, sr, 2048)
    cm, cs = _mstd(centroid)
    bm, bs = _mstd(bandwidth)
    rm, rs = _mstd(rolloff)
    fm, fs = _mstd(flatness)
    ctr_flat = contrast.reshape(*contrast.shape[:-2], -1)
    km, ks = _mstd(ctr_flat)
    feats += [cm / nyq, cs / nyq, _skew(centroid),
              bm / nyq, bs / nyq, rm / nyq, rs / nyq, fm, fs, km, ks]

    env = dft.hilbert_envelope(y)
    em, es = _mstd(env)
    feats += [em, es, em / (es + 1e-8)]
    with jax.named_scope("peak_scan"):
        n_pk, mean_pk, std_pk = peaks.find_peaks_stats_batched(env, em,
                                                               sr // 10)
    feats += [n_pk, mean_pk, std_pk]

    if stft512_mag is None:
        stft512_mag = spectral.stft_mag(y, n_fft, hop_length)
    low_bins = int(1000 * n_fft / sr)
    p512 = stft512_mag * stft512_mag
    low_e = jnp.sum(p512[..., :low_bins, :], axis=(-2, -1))
    tot_e = jnp.sum(p512, axis=(-2, -1))
    low_ratio = low_e / (tot_e + 1e-8)

    mel = mel2048_power
    if mel is None:
        mel = spectral.melspectrogram(y, sr, n_fft=2048, hop_length=hop_length,
                                      n_mels=n_mels, fmax=None, power=2.0)
    mel_db = spectral.power_to_db(mel, ref_max=True)
    d = mel_db[..., 1:] - mel_db[..., :-1]
    flux = jnp.sqrt(jnp.sum(d * d, axis=-2))
    xm, xs = _mstd(flux)
    feats += [low_ratio, xm, xs, jnp.max(flux, axis=-1)]

    # percentiles via radix select, not a [16000] sort (ops/select.py);
    # both quantiles' bracketing ranks resolve in ONE shared descent
    from tpu_breath.ops import select
    abs_y = jnp.abs(y)
    p = _vmap_leading(lambda v: select.percentiles(v, (90.0, 10.0)), abs_y)
    feats += [_skew(y), _kurtosis(y), p[..., 0], p[..., 1]]

    ac = dft.autocorr_full(y)
    ac = ac / ac[..., :1]
    first_min = jnp.argmin(ac[..., : sr // 20], axis=-1).astype(y.dtype)
    feats += [ac[..., sr // 100], ac[..., sr // 50], first_min / sr]

    return jnp.stack(feats, axis=-1)
