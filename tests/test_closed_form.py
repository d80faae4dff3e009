"""Oracle-independence probes.

Every parity test elsewhere compares the device graph against the NumPy
oracle (baseline/dsp_np.py) — but the device path shares trace-time
CONSTANTS with that oracle (mel filterbank, CQT wavelet FFTs), so a
systematic error in a shared constant is invisible to those tests. This file
breaks the coupling two ways:

1. An INDEPENDENT from-scratch derivation of the Slaney mel filterbank
   (written directly from the Auditory-Toolbox mel-scale definition, no code
   shared with dsp_np.mel_filterbank) must match the shared constant.
2. CLOSED-FORM probes: pure tones whose STFT/mel/chroma/CQT responses are
   known analytically (exact-bin Hann-window DFT values) or structurally
   (argmax at the tone's pitch class / CQT bin), checked against the DEVICE
   graph directly — the oracle never enters.

Reference numerics contract: librosa 0.10.2 (reference env.yaml:156) as
consumed by src/precompute/process.py:32-78.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tpu_breath.config import DEFAULT_FEATURES as SPEC
from tpu_breath.ops import spectral, chroma as ch_ops, cqt as cqt_ops
from tpu_breath.baseline import dsp_np as oracle

SR, NFFT, HOP = SPEC.sr, SPEC.n_fft, SPEC.hop_length


# ------------------------------------------------- independent constants

def _hz2mel_slaney(f):
    f = np.asarray(f, np.float64)
    return np.where(f >= 1000.0,
                    15.0 + np.log(np.maximum(f, 1e-30) / 1000.0)
                    * 27.0 / np.log(6.4),
                    3.0 * f / 200.0)


def _mel2hz_slaney(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0,
                    1000.0 * np.exp(np.log(6.4) * (m - 15.0) / 27.0),
                    200.0 * m / 3.0)


def mel_fb_independent(sr, n_fft, n_mels, fmin=0.0, fmax=None):
    """Slaney-normalized triangular mel filterbank, derived from scratch:
    mel scale linear below 1 kHz (3f/200), log above (step 27/ln 6.4 per
    factor 6.4), triangles between successive mel-spaced edges, each scaled
    by 2/(hi-lo). No code shared with dsp_np.mel_filterbank."""
    fmax = sr / 2.0 if fmax is None else fmax
    pts = _mel2hz_slaney(np.linspace(_hz2mel_slaney(fmin),
                                     _hz2mel_slaney(fmax), n_mels + 2))
    freqs = np.arange(1 + n_fft // 2, dtype=np.float64) * (sr / n_fft)
    fb = np.zeros((n_mels, len(freqs)))
    for m in range(n_mels):
        lo, c, hi = pts[m], pts[m + 1], pts[m + 2]
        up = (freqs - lo) / (c - lo)
        down = (hi - freqs) / (hi - c)
        fb[m] = np.maximum(0.0, np.minimum(up, down)) * (2.0 / (hi - lo))
    return fb


@pytest.mark.parametrize("n_mels,fmax", [(128, 4500.0), (64, None)])
def test_mel_filterbank_matches_independent_derivation(n_mels, fmax):
    """The constant shared by the device graph and the oracle
    (spectral.mel_matrix -> dsp_np.mel_filterbank) must equal a from-scratch
    derivation — catches a systematic error in the shared code."""
    shared = oracle.mel_filterbank(SR, NFFT, n_mels, 0.0, fmax)
    indep = mel_fb_independent(SR, NFFT, n_mels, 0.0, fmax)
    np.testing.assert_allclose(shared, indep, rtol=1e-9, atol=1e-12)


def vqt_fft_basis_independent(sr, freqs, bins_per_octave, filter_scale=1.0):
    """From-scratch re-derivation of librosa 0.10's __vqt_filter_fft DENSE
    output (librosa/core/constantq.py semantics, written directly from the
    paper definition — no code shared with dsp_np.wavelet_basis /
    _vqt_filter_fft): l1-normalized periodic-Hann-windowed complex
    exponentials of length Q*sr/f (Q = filter_scale/alpha, alpha the
    geometric relative bandwidth), centered in a pow2 pad, scaled by
    length/n_fft, transformed by an EXPLICIT positive-frequency DFT matrix
    (not np.fft). Returns (dense_basis [n, n_fft//2+1] complex128, n_fft)."""
    import math
    r2 = 2.0 ** (2.0 / bins_per_octave)
    q = filter_scale * (r2 + 1) / (r2 - 1)
    lengths = q * sr / np.asarray(freqs, np.float64)
    n_fft = 1 << int(math.ceil(math.log2(lengths.max())))
    basis = np.zeros((len(freqs), n_fft), np.complex128)
    for i, (ln, f) in enumerate(zip(lengths, freqs)):
        start, stop = math.floor(-ln / 2.0), math.floor(ln / 2.0)
        n = stop - start
        t = (start + np.arange(n, dtype=np.float64)) / sr
        win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)
        sig = np.exp(2j * np.pi * f * t) * win
        sig /= np.abs(sig).sum()
        off = (n_fft - n) // 2
        basis[i, off:off + n] = sig * (ln / n_fft)
    k = np.arange(1 + n_fft // 2, dtype=np.float64)
    dft = np.exp(-2j * np.pi * np.outer(k, np.arange(n_fft)) / n_fft)
    return basis @ dft.T, n_fft


def sparsify_rows_independent(x, quantile=0.01):
    """Independent librosa.util.sparsify_rows: per row, zero the smallest
    |.| entries whose cumulative l1 fraction stays below quantile (keep from
    the first sorted index where the cumulative reaches it). The cumulative
    is accumulated as cumsum(order / sum) — the same float sequencing as the
    oracle (dsp_np.sparsify_rows) — so the threshold INDEX is bit-decided
    identically and the final array comparison can be exact; the independent
    part under test is the searchsorted-vs-argmin selection rule."""
    assert quantile <= 1.0
    out = np.zeros_like(x)
    for i in range(x.shape[0]):
        mags = np.abs(x[i])
        order = np.sort(mags)
        cum = np.cumsum(order / mags.sum())
        idx = np.searchsorted(cum, quantile, side="left")
        thresh = order[min(idx, len(order) - 1)]
        keep = mags >= thresh
        out[i, keep] = x[i, keep]
    return out


@pytest.mark.parametrize("tuning_idx", [0, 50, 99])
def test_vqt_filter_basis_matches_independent_derivation(tuning_idx):
    """The OTHER constant the device graph shares with the oracle: the
    per-octave CQT wavelet FFT basis (ops/cqt.py _vqt_consts ->
    dsp_np._vqt_filter_fft). A from-scratch derivation (explicit DFT matrix,
    independent Q/length/window formulas) must reproduce it for tunings
    across the estimation grid — catches a systematic error in the shared
    wavelet code that every oracle-vs-device parity test would miss."""
    bpo, n_oct = SPEC.cqt_bins_per_octave, SPEC.cqt_n_octaves
    tau = -0.5 + tuning_idx * 0.01
    fmin_t = SPEC.cqt_fmin * 2.0 ** (tau / bpo)
    k = np.arange((n_oct - 1) * bpo, n_oct * bpo)
    freqs_top = fmin_t * 2.0 ** (k / bpo)

    shared_dense, n_fft_s = oracle._vqt_filter_fft(SR, freqs_top, bpo,
                                                   sparsity=0.0)
    indep_dense, n_fft_i = vqt_fft_basis_independent(SR, freqs_top, bpo)
    assert n_fft_s == n_fft_i
    np.testing.assert_allclose(shared_dense, indep_dense,
                               rtol=1e-9, atol=1e-12)

    # the shipped constant also applies sparsify_rows(quantile=0.01); verify
    # that step on the SAME dense input so boundary entries are bit-decided
    shared_sparse = oracle.sparsify_rows(shared_dense, quantile=0.01)
    indep_sparse = sparsify_rows_independent(shared_dense, quantile=0.01)
    np.testing.assert_array_equal(shared_sparse, indep_sparse)

    # and the independent lengths reproduce the shared wavelet_lengths the
    # device folds into its basis (ops/cqt.py:112-114)
    shared_len, _ = oracle.wavelet_lengths(freqs_top, SR,
                                           bins_per_octave=bpo)
    r2 = 2.0 ** (2.0 / bpo)
    indep_len = (r2 + 1) / (r2 - 1) * SR / freqs_top
    np.testing.assert_allclose(shared_len, indep_len, rtol=1e-12)


# ---------------------------------------------------- closed-form probes

def _tone(freq, amp=1.0, phase=0.7):
    t = np.arange(SPEC.expected_len, dtype=np.float64) / SR
    return (amp * np.cos(2 * np.pi * freq * t + phase)).astype(np.float32)


def test_stft_pure_tone_hann_closed_form():
    """Tone at an exact DFT bin k0: the periodic-Hann windowed DFT has
    |X[k0]| = N/4, |X[k0 +/- 1]| = N/8, 0 elsewhere — for ANY phase (the
    negative-frequency image is disjoint at k0=32). Checked on the DEVICE
    stft (both the block-GEMM and compensated paths), interior frames."""
    k0 = 32  # 1000 Hz
    y = _tone(k0 * SR / NFFT)[None]
    for fn in (spectral.stft_mag, spectral.stft_mag_dd):
        mag = np.asarray(jax.jit(lambda x, f=fn: f(x, NFFT, HOP))(
            jnp.asarray(y)))[0]  # [F, T]
        interior = mag[:, 5:58]
        np.testing.assert_allclose(interior[k0], NFFT / 4.0, rtol=2e-4)
        np.testing.assert_allclose(interior[k0 - 1], NFFT / 8.0, rtol=2e-4)
        np.testing.assert_allclose(interior[k0 + 1], NFFT / 8.0, rtol=2e-4)
        side = np.delete(interior, [k0 - 1, k0, k0 + 1], axis=0)
        assert np.max(side) < NFFT / 4.0 * 1e-3, np.max(side)


def test_melspectrogram_tone_closed_form():
    """Mel POWER of the exact-bin tone = fb[:,k0]*(N/4)^2 + (fb[:,k0-1] +
    fb[:,k0+1])*(N/8)^2, with fb the INDEPENDENT filterbank — validates the
    device mel path end-to-end with no shared constant in the expectation."""
    k0 = 32
    y = _tone(k0 * SR / NFFT)[None]
    mel = np.asarray(jax.jit(
        lambda x: spectral.melspectrogram(x, SR, NFFT, HOP, SPEC.n_mels,
                                          fmax=SPEC.fmax))(jnp.asarray(y)))[0]
    fb = mel_fb_independent(SR, NFFT, SPEC.n_mels, 0.0, SPEC.fmax)
    expect = (fb[:, k0] * (NFFT / 4.0) ** 2
              + (fb[:, k0 - 1] + fb[:, k0 + 1]) * (NFFT / 8.0) ** 2)
    got = mel[:, 5:58]
    scale = np.max(expect)
    for t in range(got.shape[1]):
        np.testing.assert_allclose(got[:, t] / scale, expect / scale,
                                   atol=5e-4)


def test_chroma_tone_lands_on_pitch_class():
    """440 Hz (A4) and 523.25 Hz (C5) tones: the device chroma_stft's argmax
    row at every interior frame must be the tone's pitch class (librosa row
    order starts at C: C=0 ... A=9)."""
    for freq, pc in ((440.0, 9), (523.2511306011972, 0)):
        y = _tone(freq)[None]
        ch = np.asarray(jax.jit(
            lambda x: ch_ops.chroma_stft(
                spectral.stft_mag(x, NFFT, HOP), SR))(jnp.asarray(y)))[0]
        assert (ch[:, 5:58].argmax(axis=0) == pc).all(), freq


def test_cqt_tone_lands_on_its_bin():
    """A C4 tone (fmin * 2^3) peaks at CQT bin 3*36=108 (36 bins/octave,
    fmin=C1) on the device multirate CQT, every interior frame."""
    freq = SPEC.cqt_fmin * 8.0  # C4
    y = _tone(freq)[None]
    tuning_idx = jnp.full((1,), 50, jnp.int32)  # tuning 0.0
    cq = np.asarray(jax.jit(
        lambda x: cqt_ops.cqt_mag_multirate(
            x, tuning_idx, SR, HOP, SPEC.cqt_fmin,
            SPEC.cqt_bins_per_octave, SPEC.cqt_n_octaves))(jnp.asarray(y)))[0]
    assert (cq[:, 10:50].argmax(axis=0) == 108).all()


# ------------------------- closed-form probes: delta / LPC / rhythm
# (the three channels that previously rested solely on
# oracle comparison get analytic anchors the oracle never touches)

def test_savgol_delta_exact_on_polynomials():
    """librosa.feature.delta = Savitzky-Golay(width 9, polyorder=order,
    deriv=order, mode='interp'). An SG filter reproduces the EXACT
    derivative of any polynomial of degree <= polyorder — including the
    'interp' edge frames — so on rows that are degree-1 / degree-2
    polynomials of the frame index, the device delta must equal b (order 1)
    and 2c (order 2) at EVERY frame, edges included.
    Ref: src/precompute/process.py:34-41 (librosa delta defaults)."""
    from tpu_breath.ops import cepstral
    t = np.arange(63, dtype=np.float64)
    rows = np.stack([
        3.0 + 0.25 * t,                 # linear
        -2.0 + 1.5 * t,                 # linear
        1.0 + 0.5 * t - 0.03 * t * t,   # quadratic
        4.0 - 0.2 * t + 0.01 * t * t,   # quadratic
    ]).astype(np.float32)[None]  # [1, 4, 63]
    d1 = np.asarray(jax.jit(lambda x: cepstral.delta(x, order=1))(
        jnp.asarray(rows)))[0]
    # order-1 SG (polyorder 1) is exact for the linear rows
    np.testing.assert_allclose(d1[0], np.full(63, 0.25), atol=1e-5)
    np.testing.assert_allclose(d1[1], np.full(63, 1.5), atol=1e-5)
    d2 = np.asarray(jax.jit(lambda x: cepstral.delta(x, order=2))(
        jnp.asarray(rows)))[0]
    # order-2 SG (polyorder 2) is exact for ALL four rows: second
    # derivative of a linear row is 0, of the quadratics 2c
    np.testing.assert_allclose(d2[0], np.zeros(63), atol=1e-5)
    np.testing.assert_allclose(d2[1], np.zeros(63), atol=1e-5)
    np.testing.assert_allclose(d2[2], np.full(63, -0.06), atol=1e-5)
    np.testing.assert_allclose(d2[3], np.full(63, 0.02), atol=1e-5)


def test_burg_lpc_recovers_known_ar12_coefficients():
    """Burg LPC on a synthetic AR(12) process with KNOWN coefficients: six
    stable conjugate pole pairs define a[1:13]; driving white noise through
    1/A(z) and running the DEVICE Burg recursion on a long frame must
    recover them (Burg is consistent; at n=8192 the sampling error is well
    under the tolerance). No oracle involved — the ground truth is the
    generating filter. Ref: src/precompute/methods.py:116-134 (librosa.lpc
    backend is the same Burg recursion)."""
    from tpu_breath.ops import lpc as lpc_ops
    radii = [0.55, 0.65, 0.72, 0.80, 0.85, 0.88]
    thetas = [0.35, 0.80, 1.30, 1.80, 2.30, 2.80]
    a_true = np.array([1.0])
    for r, th in zip(radii, thetas):
        pair = np.array([1.0, -2.0 * r * np.cos(th), r * r])
        a_true = np.convolve(a_true, pair)
    assert len(a_true) == 13
    rng = np.random.default_rng(42)
    e = rng.standard_normal(10_000)
    x = np.zeros_like(e)
    for n in range(len(e)):  # x[n] = e[n] - sum a[k] x[n-k]
        acc = e[n]
        for k in range(1, 13):
            if n - k >= 0:
                acc -= a_true[k] * x[n - k]
        x[n] = acc
    frame = x[1000:9192].astype(np.float32)  # skip the transient
    a_est = np.asarray(jax.jit(
        lambda f: lpc_ops.burg_lpc(f, 12))(jnp.asarray(frame)))
    assert a_est[0] == 1.0
    np.testing.assert_allclose(a_est[1:], a_true[1:], atol=0.03)


def test_tempogram_matches_autocorrelation_definition():
    """The device tempogram (1024-pt matmul power spectrum + inverse-cosine
    matmul) against the DEFINITION of windowed local autocorrelation,
    computed directly in float64: ac[t, L] = sum_n f_t[n] f_t[n+L] with
    f_t the Hann-windowed length-384 frame at time t — then inf-normalized
    per frame. The oracle's FFT-based path never enters.
    Ref: src/precompute/process.py:74-78."""
    from tpu_breath.ops import rhythm
    rng = np.random.default_rng(5)
    env = np.abs(rng.standard_normal(63)).astype(np.float32)
    win_length = SPEC.tempogram_win_length
    got = np.asarray(jax.jit(
        lambda e: rhythm.tempogram(e, win_length))(jnp.asarray(env[None])))[0]

    pad = win_length // 2
    oe = np.pad(env.astype(np.float64), (pad, pad), mode="linear_ramp",
                end_values=0.0)
    w = oracle.hann(win_length, periodic=True)
    expect = np.empty((win_length, 63))
    for t in range(63):
        f = oe[t:t + win_length] * w
        for L in range(win_length):
            expect[L, t] = np.dot(f[: win_length - L], f[L:])
    norm = np.abs(expect).max(axis=0, keepdims=True)
    expect = expect / np.where(norm < np.finfo(np.float32).tiny, 1.0, norm)
    np.testing.assert_allclose(got, expect, atol=5e-5)


def test_tempogram_click_train_peaks_at_period():
    """Two unit clicks 48 frames apart (zero-valued boundaries, so the
    linear-ramp padding stays identically zero): the linear autocorrelation
    of every frame is nonzero ONLY at lags 0 and 48, so each tempogram
    column's largest nonzero-lag value sits at lag 48, every other lag is
    ~0, and the lag-48 value equals the closed form
    w[p1] w[p1+48] ... i.e. (f[p1] f[p2]) / (f[p1]^2 + f[p2]^2) after the
    inf-norm, with f the Hann-windowed click heights."""
    from tpu_breath.ops import rhythm
    period = 48
    p1, p2 = 7, 55
    env = np.zeros(63, np.float32)
    env[p1] = env[p2] = 1.0
    win_length = SPEC.tempogram_win_length
    tg = np.asarray(jax.jit(
        lambda e: rhythm.tempogram(e, win_length))(jnp.asarray(env[None])))[0]
    pad = win_length // 2
    w = oracle.hann(win_length, periodic=True)
    for t in range(63):
        col = tg[:, t]
        assert int(col[1:].argmax()) + 1 == period, t
        # closed form: window positions of the two clicks inside frame t
        f1, f2 = w[p1 + pad - t], w[p2 + pad - t]
        expect = (f1 * f2) / (f1 * f1 + f2 * f2)
        np.testing.assert_allclose(col[period], expect, atol=1e-5)
        off = np.delete(col, [0, period])
        assert np.max(np.abs(off)) < 1e-4, t


def test_onset_strength_structure():
    """Onset strength on (a) a constant-amplitude tone: the rectified dB-mel
    flux is identically ZERO once the window ramp-in passes; (b) a tone
    switched on mid-clip: the envelope's global max lands at the switch-on
    frame (+ the documented center-compensation shift of
    lag + n_fft/(2 hop) frames). Ref: librosa.onset.onset_strength defaults
    reached from src/precompute/process.py:74."""
    from tpu_breath.ops import rhythm
    t = np.arange(SPEC.expected_len, dtype=np.float64) / SR
    tone = np.cos(2 * np.pi * 1000.0 * t)
    const = tone.astype(np.float32)[None]
    env_const = np.asarray(jax.jit(
        lambda y: rhythm.onset_strength(y, SR, HOP))(jnp.asarray(const)))[0]
    # pad region: lag + n_fft/(2*hop) = 1 + 4 = 5 leading zeros, then the
    # window ramp-in; zero once frames see steady state (2048-sample window
    # fully inside the tone by frame ~5+8)
    assert np.all(env_const[:5] == 0.0)
    assert np.max(np.abs(env_const[16:])) < 1e-4
    onset_sample = 8000
    gated = tone.copy()
    gated[:onset_sample] = 0.0
    g = gated.astype(np.float32)[None]
    env_gate = np.asarray(jax.jit(
        lambda y: rhythm.onset_strength(y, SR, HOP))(jnp.asarray(g)))[0]
    shift = 1 + 2048 // (2 * HOP)
    expect_frame = onset_sample // HOP + shift
    assert abs(int(env_gate.argmax()) - expect_frame) <= 4
