"""Golden parity: every JAX DSP op against the NumPy/SciPy oracle on real
stethoscope clips (the oracle is the stand-in for librosa, which is not
installed here; see baseline/dsp_np.py docstring)."""
import numpy as np
import pytest
import scipy.signal
import scipy.stats

import jax
import jax.numpy as jnp

from tpu_breath.baseline import dsp_np as L
from tpu_breath.baseline import feature_np
from tpu_breath.config import FeatureSpec
from tpu_breath.ops import (spectral, cepstral, dft, lpc as lpc_ops,
                            chroma as chroma_ops, cqt as cqt_ops,
                            rhythm, scalars as scalar_ops, peaks)

SPEC = FeatureSpec()
SR, HOP, NFFT = SPEC.sr, SPEC.hop_length, SPEC.n_fft

import functools


@functools.lru_cache(maxsize=None)
def J(fn, **static):
    """Jit an op with keyword statics; ops are always used under jit in the
    framework, and eager dispatch is pathologically slow on this backend."""
    return jax.jit(functools.partial(fn, **static))


def rel_err(a, b, eps=1e-6):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), eps)


# ---------------------------------------------------------------- dft layer

def test_rdft_vs_numpy(real_clips):
    y = real_clips[0][:2048]
    re, im = J(dft.rdft, n=2048)(jnp.asarray(y))
    ref = np.fft.rfft(y)
    assert rel_err(np.asarray(re) + 1j * np.asarray(im), ref) < 1e-5


def test_hilbert_envelope(real_clips):
    env = J(dft.hilbert_envelope)(jnp.asarray(real_clips))
    ref = np.abs(scipy.signal.hilbert(real_clips, axis=-1))
    assert rel_err(env, ref) < 1e-4


def test_autocorr_full(real_clips):
    ac = J(dft.autocorr_full)(jnp.asarray(real_clips))
    for b in range(real_clips.shape[0]):
        ref = np.correlate(real_clips[b], real_clips[b], "full")[15999:]
        assert rel_err(np.asarray(ac[b]), ref) < 1e-4


# ------------------------------------------------------------ spectral ops

def test_stft_mag(real_clips):
    got = np.asarray(J(spectral.stft_mag, n_fft=NFFT, hop_length=HOP)(jnp.asarray(real_clips)))
    for b in range(real_clips.shape[0]):
        ref = np.abs(L.stft(real_clips[b], NFFT, HOP))
        assert rel_err(got[b], ref) < 1e-4


def test_melspectrogram(real_clips):
    got = np.asarray(J(spectral.melspectrogram, sr=SR, n_fft=NFFT, hop_length=HOP, n_mels=128, fmax=4500)(jnp.asarray(real_clips)))
    for b in range(real_clips.shape[0]):
        ref = L.melspectrogram(real_clips[b], SR, n_fft=NFFT, hop_length=HOP,
                               n_mels=128, fmax=4500)
        assert rel_err(got[b], ref) < 1e-4


def test_power_to_db_refmax(real_clips):
    m = L.melspectrogram(real_clips[0], SR, n_fft=NFFT, hop_length=HOP,
                         n_mels=128, fmax=4500)
    got = np.asarray(J(spectral.power_to_db, ref_max=True)(jnp.asarray(m.astype(np.float32))))
    ref = L.power_to_db(m, ref=np.max)
    assert np.max(np.abs(got - ref)) < 1e-3  # dB scale: absolute tolerance


def test_mel_db_full_chain(real_clips):
    y = jnp.asarray(real_clips)
    fn = jax.jit(lambda v: spectral.power_to_db(
        spectral.melspectrogram(v, SR, NFFT, HOP, 128, fmax=4500), ref_max=True))
    got = np.asarray(fn(y))
    for b in range(real_clips.shape[0]):
        ref = L.power_to_db(L.melspectrogram(real_clips[b], SR, n_fft=NFFT,
                                             hop_length=HOP, n_mels=128,
                                             fmax=4500), ref=np.max)
        assert np.max(np.abs(got[b] - ref)) < 2e-3


# ------------------------------------------------------------- cepstral ops

def test_delta_matrix(real_clips):
    m = L.power_to_db(L.melspectrogram(real_clips[0], SR, n_fft=NFFT,
                                       hop_length=HOP, n_mels=128, fmax=4500),
                      ref=np.max).astype(np.float32)
    for order in (1, 2):
        got = np.asarray(J(cepstral.delta, order=order)(jnp.asarray(m)))
        ref = L.delta(m.astype(np.float64), order=order)
        assert np.max(np.abs(got - ref)) < 2e-3


def test_mfcc(real_clips):
    got = np.asarray(J(cepstral.mfcc, sr=SR, n_mfcc=40, hop_length=HOP, n_fft=NFFT)(jnp.asarray(real_clips)))
    for b in range(real_clips.shape[0]):
        ref = L.mfcc(real_clips[b], SR, n_mfcc=40, hop_length=HOP, n_fft=NFFT)
        assert np.max(np.abs(got[b] - ref)) < 5e-3  # dB-scale inputs


def test_mod_spec(real_clips):
    m = L.power_to_db(L.melspectrogram(real_clips[0], SR, n_fft=NFFT,
                                       hop_length=HOP, n_mels=128, fmax=4500),
                      ref=np.max).astype(np.float32)
    got = np.asarray(J(cepstral.mod_spec)(jnp.asarray(m)))
    from scipy.fftpack import dct as sdct
    ref = sdct(sdct(m.astype(np.float64), axis=0, norm="ortho")[:40, :],
               axis=1, norm="ortho")
    assert np.max(np.abs(got - ref)) < 5e-3


# -------------------------------------------------------------------- LPC

def test_burg_lpc_single_frame():
    rng = np.random.default_rng(5)
    e = rng.standard_normal(400)
    yf = np.zeros(400)
    for n in range(2, 400):
        yf[n] = 0.7 * yf[n - 1] - 0.4 * yf[n - 2] + e[n]
    yf = (yf * np.hamming(400)).astype(np.float32)
    got = np.asarray(J(lpc_ops.burg_lpc, order=12)(jnp.asarray(yf)))
    ref = L.lpc(yf.astype(np.float64), 12)
    assert np.max(np.abs(got - ref)) < 1e-3


def test_lpc_features(real_clips):
    got = np.asarray(J(lpc_ops.lpc_features, order=12, sr=SR)(jnp.asarray(real_clips)))
    for b in range(real_clips.shape[0]):
        ref = L.lpc_features(real_clips[b], 12, SR)
        assert got[b].shape == ref.shape
        # f32 Burg recursion vs the oracle's f64: worst-case ~2e-2 absolute on
        # O(1)-magnitude coefficients (the channel is z-scored downstream)
        assert np.max(np.abs(got[b] - ref)) < 2.5e-2
        assert np.mean(np.abs(got[b] - ref)) < 2e-3


# ------------------------------------------------------------------ chroma

def test_tuning_estimate(real_clips):
    """The tuning estimate is an argmax over a ~100-bin histogram whose top
    bins are near-tied on broadband breathing audio; XLA's log2 approximation
    can legitimately flip the winner. Assert the JAX winner is a near-argmax
    of the reference histogram (count within 2 of the max)."""
    for b in range(real_clips.shape[0]):
        S = np.abs(L.stft(real_clips[b], NFFT, HOP)).astype(np.float32)
        got = float(J(chroma_ops.estimate_tuning, sr=SR, n_fft=NFFT)(jnp.asarray(S)))
        # reference histogram
        pitches, mags = L.piptrack(S, SR, NFFT)
        pm = pitches > 0
        thr = np.median(mags[pm]) if pm.any() else 0.0
        freqs = pitches[(mags >= thr) & pm]
        res = np.mod(12 * L.hz_to_octs(freqs), 1.0)
        res[res >= 0.5] -= 1.0
        counts, edges = np.histogram(res, np.linspace(-0.5, 0.5, 101))
        got_bin = int(np.clip(np.round((got + 0.5) * 100), 0, 99))
        assert counts[got_bin] >= counts.max() - 2, (got, counts.max(),
                                                    counts[got_bin])


def test_chroma_filterbank_path_given_tuning(real_clips):
    """Exact parity of the chroma filterbank + projection + inf-norm chain
    when the tuning scalar is pinned (isolates the algorithm from the fragile
    tuning argmax tested above)."""
    for b in range(2):
        S = np.abs(L.stft(real_clips[b], NFFT, HOP)).astype(np.float32)
        tuning = L.estimate_tuning_from_S(S, SR, NFFT)
        fb = np.asarray(J(chroma_ops.chroma_filterbank, sr=SR, n_fft=NFFT)(jnp.float32(tuning)))
        fb_ref = L.chroma_filterbank(SR, NFFT, tuning=tuning)
        assert np.max(np.abs(fb - fb_ref)) < 5e-5  # f32 exp/log2 rounding
        raw = fb_ref @ S
        ref = L.normalize(raw, norm=np.inf, axis=0)
        got = np.asarray(J(chroma_ops._norm_inf_cols)(jnp.asarray(
            (fb @ S).astype(np.float32))))
        assert np.max(np.abs(got - ref)) < 1e-4


def test_chroma_stft_end_to_end(real_clips):
    """End-to-end chroma parity, evaluated at the tuning the JAX path chose
    (the tuning winner itself may legitimately differ between near-tied
    histogram bins — covered by test_tuning_estimate)."""
    S = np.stack([np.abs(L.stft(real_clips[b], NFFT, HOP))
                  for b in range(real_clips.shape[0])]).astype(np.float32)
    got = np.asarray(J(chroma_ops.chroma_stft, sr=SR)(jnp.asarray(S)))
    for b in range(real_clips.shape[0]):
        t_jax = float(J(chroma_ops.estimate_tuning, sr=SR, n_fft=NFFT)(
            jnp.asarray(S[b])))
        fb = L.chroma_filterbank(SR, NFFT, tuning=t_jax)
        ref = L.normalize(fb @ S[b], norm=np.inf, axis=0)
        assert np.max(np.abs(got[b] - ref)) < 1e-3


def test_cqt_mag_direct(real_clips):
    """The retained direct single-GEMM CQT vs the direct oracle (NOT the
    librosa path — see test_cqt_mag_multirate for that)."""
    got = np.asarray(J(cqt_ops.cqt_mag, sr=SR, hop_length=HOP, fmin=SPEC.cqt_fmin, n_bins=252, bins_per_octave=36)(jnp.asarray(real_clips)))
    for b in range(real_clips.shape[0]):
        ref = np.abs(L.cqt(real_clips[b], SR, HOP, SPEC.cqt_fmin, 252, 36))
        assert rel_err(got[b], ref) < 1e-3


def test_decimate2_matches_scipy_resample_poly():
    """The octave decimator must bit-match librosa's 'polyphase' resample
    (scipy.signal.resample_poly(y, 1, 2), x sqrt(2) for scale=True)."""
    from tpu_breath.ops.cqt import _vqt_consts, decimate2
    _, _, _, taps = _vqt_consts(SR, SPEC.cqt_fmin, 36, 7)
    rng = np.random.default_rng(3)
    for n in (16000, 8000, 1000, 500, 251):
        y = rng.standard_normal(n).astype(np.float32)
        got = np.asarray(jax.jit(lambda v: decimate2(v, taps))(jnp.asarray(y)))
        ref = scipy.signal.resample_poly(y.astype(np.float64), 1, 2) / np.sqrt(0.5)
        assert got.shape == ref.shape
        assert np.max(np.abs(got - ref)) < 1e-5, n


def test_estimate_tuning_from_y(real_clips):
    """Device tuning (from the shared hop-256 |STFT2048| even frames) vs the
    oracle's librosa estimate_tuning(y=...) path."""
    from tpu_breath.ops import spectral as spectral_ops
    from tpu_breath.ops import chroma as chroma_jax

    def dev(y):
        s = spectral_ops.stft_mag(y, 2048, HOP)[..., ::2]
        return chroma_jax.estimate_tuning(s, SR, 2048, bins_per_octave=36)

    got = np.asarray(jax.jit(jax.vmap(dev))(jnp.asarray(real_clips)))
    for b in range(real_clips.shape[0]):
        ref = L.estimate_tuning_from_y(real_clips[b].astype(np.float64), SR,
                                       bins_per_octave=36)
        assert abs(got[b] - ref) < 1e-6, (b, got[b], ref)


def test_cqt_mag_multirate(real_clips):
    """Device multirate CQT vs the oracle's librosa-faithful vqt recursion,
    at the per-clip estimated tuning."""
    from tpu_breath.ops import spectral as spectral_ops
    from tpu_breath.ops import chroma as chroma_jax

    def dev(y):
        s = spectral_ops.stft_mag(y, 2048, HOP)[..., ::2]
        idx = chroma_jax.estimate_tuning_index(s, SR, 2048,
                                               bins_per_octave=36)
        return cqt_ops.cqt_mag_multirate(y, idx, SR, HOP, SPEC.cqt_fmin,
                                         36, 7)

    got = np.asarray(jax.jit(jax.vmap(dev))(jnp.asarray(real_clips)))
    for b in range(real_clips.shape[0]):
        y64 = real_clips[b].astype(np.float64)
        tun = L.estimate_tuning_from_y(y64, SR, bins_per_octave=36)
        ref = np.abs(L.vqt_multirate(y64, SR, HOP, SPEC.cqt_fmin, 252, 36,
                                     tuning=tun))
        T = min(got.shape[-1], ref.shape[-1])
        assert rel_err(got[b][:, :T], ref[:, :T]) < 1e-3


def test_chroma_cens(real_clips):
    """Device CENS vs the FULL librosa path (tuning estimation + multirate
    CQT + quantize/smooth/normalize chain) — closes the round-1 oracle-trust
    gap on this channel."""
    got = np.asarray(J(cqt_ops.chroma_cens, sr=SR, hop_length=HOP, fmin=SPEC.cqt_fmin)(jnp.asarray(real_clips)))
    for b in range(real_clips.shape[0]):
        ref = L.chroma_cens_librosa(real_clips[b].astype(np.float64), SR, HOP,
                                    fmin=SPEC.cqt_fmin)
        T = min(got.shape[-1], ref.shape[-1])
        assert np.max(np.abs(got[b][:, :T] - ref[:, :T])) < 1e-3


def test_multirate_vs_direct_relationship(real_clips):
    """The direct transform x filter lengths approximates the multirate
    response (resampler ripple + basis sparsification + positive-frequency
    truncation account for the residual); guards the documented deviation
    bound recorded in PARITY.md."""
    y = real_clips[0].astype(np.float64)
    freqs = SPEC.cqt_fmin * 2.0 ** (np.arange(252) / 36)
    lengths, _ = L.wavelet_lengths(freqs, SR, bins_per_octave=36)
    direct = np.abs(L.cqt(y, SR, HOP, SPEC.cqt_fmin, 252, 36)) * lengths[:, None]
    multi = np.abs(L.vqt_multirate(y, SR, HOP, SPEC.cqt_fmin, 252, 36))
    T = min(direct.shape[1], multi.shape[1])
    r = np.abs(direct[:, :T] - multi[:, :T]) / multi.max()
    assert r.max() < 0.05, r.max()


# ------------------------------------------------------------------ rhythm

def test_onset_strength(real_clips):
    got = np.asarray(J(rhythm.onset_strength, sr=SR, hop_length=HOP)(jnp.asarray(real_clips)))
    for b in range(real_clips.shape[0]):
        ref = L.onset_strength(real_clips[b], SR, HOP)
        assert np.max(np.abs(got[b] - ref)) < 2e-3


def test_tempogram(real_clips):
    oe = np.stack([L.onset_strength(real_clips[b], SR, HOP)
                   for b in range(real_clips.shape[0])]).astype(np.float32)
    got = np.asarray(J(rhythm.tempogram, win_length=384)(jnp.asarray(oe)))
    for b in range(real_clips.shape[0]):
        ref = L.tempogram(oe[b], 384)
        assert np.max(np.abs(got[b] - ref)) < 1e-3


# ------------------------------------------------------------------ scalars

def test_find_peaks_stats(real_clips):
    for b in range(real_clips.shape[0]):
        env = np.abs(scipy.signal.hilbert(real_clips[b])).astype(np.float32)
        h = float(env.mean())
        n_pk, mean_pk, std_pk = J(peaks.find_peaks_stats, distance=SR // 10)(
            jnp.asarray(env), jnp.float32(h))
        pk, props = scipy.signal.find_peaks(env, height=h, distance=SR // 10)
        ph = props["peak_heights"] if len(pk) else [0]
        assert int(n_pk) == len(pk)
        assert abs(float(mean_pk) - np.mean(ph)) < 1e-4
        ref_std = np.std(ph) if len(pk) > 1 else 0.0
        assert abs(float(std_pk) - ref_std) < 1e-4


def test_find_peaks_plateaus(rng):
    """Adversarial plateau/quantization fixtures vs scipy.

    scipy treats an equal-value run as ONE peak at its floor-midpoint iff
    both run-adjacent samples are strictly lower (_local_maxima_1d); the
    strictly-greater-than-immediate-neighbours rule misses every plateau.
    """
    cases = []
    # hand-built plateaus: width 2/3/4, at edges, staircases, all-flat
    cases.append(np.array([0, 1, 1, 0, 2, 2, 2, 0, 3, 3, 3, 3, 0], np.float32))
    cases.append(np.array([5, 5, 0, 1, 0, 5, 5], np.float32))  # edge plateaus
    cases.append(np.array([0, 1, 1, 2, 2, 1, 1, 0], np.float32))  # staircase
    cases.append(np.zeros(32, np.float32))  # flat: no peaks
    cases.append(np.array([0, 1, 2, 3, 3, 2, 1, 0, 1, 2, 3, 3, 3, 2], np.float32))
    # int16-quantized noisy envelopes: plateaus arise from quantization
    for scale in (8, 32, 128):
        env = np.abs(scipy.signal.hilbert(rng.standard_normal(4000)))
        q = np.round(env * scale).astype(np.int16).astype(np.float32)
        cases.append(q)
    # quantized slow sinusoid: long flat tops
    t = np.linspace(0, 4 * np.pi, 2000)
    cases.append(np.round(4 * (np.sin(t) + 1)).astype(np.float32))
    for distance in (1, 5, 160):
        for env in cases:
            h = float(env.mean())
            n_pk, mean_pk, std_pk = J(peaks.find_peaks_stats,
                                      distance=max(distance, 1))(
                jnp.asarray(env), jnp.float32(h))
            pk, props = scipy.signal.find_peaks(env, height=h,
                                                distance=max(distance, 1))
            ph = props["peak_heights"] if len(pk) else [0]
            # Tie caveat: scipy's suppression priority among EQUAL-height
            # peaks is np.argsort quicksort order (arbitrary); ours is
            # index-ascending. When distance=1 (no suppression) or all
            # candidate peak heights are distinct, results must be exact;
            # otherwise tied suppression chains may shift the count by a
            # hair — bound it at 1%.
            heights_all = env[scipy.signal.find_peaks(env, height=h)[0]]
            ties_possible = (distance > 1
                             and len(np.unique(heights_all)) < len(heights_all))
            if not ties_possible:
                assert int(n_pk) == len(pk), (distance, env[:16], int(n_pk), pk)
                assert abs(float(mean_pk) - np.mean(ph)) < 1e-4
                ref_std = np.std(ph) if len(pk) > 1 else 0.0
                assert abs(float(std_pk) - ref_std) < 1e-4
            else:
                assert abs(int(n_pk) - len(pk)) <= max(1, len(pk) // 100)
                assert abs(float(mean_pk) - np.mean(ph)) < 5e-2 * (abs(np.mean(ph)) + 1)


def test_scalar_vector_parity(real_clips):
    got = np.asarray(J(scalar_ops.extract_scalars, sr=SR, hop_length=HOP, n_fft=NFFT, n_mels=128)(jnp.asarray(real_clips)))
    for b in range(real_clips.shape[0]):
        ref = feature_np.extract_scalar_features(real_clips[b], SPEC)
        scale = np.maximum(np.abs(ref), 1e-2)
        assert np.max(np.abs(got[b] - ref) / scale) < 2e-2, (
            np.abs(got[b] - ref) / scale)


# ------------------------------------------- round-4 graph restructurings

def test_piptrack_band_bit_equals_full(real_clips):
    """The band-sliced tuning front end (chroma._piptrack_band) must be
    bit-identical to the full-grid piptrack on every selectable bin — the
    out-of-band rows it skips can never enter the median/histogram (their
    freq_mask is False in the full grid too)."""
    for nf, hop_s in ((NFFT, np.s_[...]), (2048, np.s_[..., ::2])):
        S = np.asarray(J(spectral.stft_mag, n_fft=nf, hop_length=HOP)(
            jnp.asarray(real_clips[:2])))[hop_s]
        lo, hi = chroma_ops._band_rows(S.shape[-2], SR)
        for b in range(S.shape[0]):
            pf, mf = jax.jit(lambda s: chroma_ops.piptrack(s, SR, nf))(
                jnp.asarray(S[b]))
            pb, mb = jax.jit(lambda s: chroma_ops._piptrack_band(s, SR, nf))(
                jnp.asarray(S[b]))
            sel_full = np.asarray(pf) > 0
            assert not sel_full[:lo].any() and not sel_full[hi:].any()
            np.testing.assert_array_equal(
                np.asarray(pb) > 0, sel_full[lo:hi])
            np.testing.assert_array_equal(np.asarray(pb)[np.asarray(pb) > 0],
                                          np.asarray(pf)[sel_full])
            np.testing.assert_array_equal(np.asarray(mb)[np.asarray(pb) > 0],
                                          np.asarray(mf)[sel_full])


def test_cqt_fused_kernels_vs_spectral_layout(real_clips):
    """The tuning-gathered time-domain CQT kernels (one GEMM per octave)
    vs the per-octave STFT + basis-projection layout: identical math up to
    GEMM associativity — bound the difference well below the channel parity
    budget."""
    idx = jnp.asarray(np.array([0, 37, 50, 99][: real_clips.shape[0]],
                               np.int32))
    y = jnp.asarray(real_clips[: idx.shape[0]])
    fused = np.asarray(jax.jit(lambda y, i: cqt_ops.cqt_mag_multirate(
        y, i, SR, HOP, SPEC.cqt_fmin, 36, 7))(y, idx))
    spect = np.asarray(jax.jit(lambda y, i: cqt_ops.cqt_mag_multirate_spectral(
        y, i, SR, HOP, SPEC.cqt_fmin, 36, 7))(y, idx))
    assert fused.shape == spect.shape
    assert rel_err(fused, spect) < 2e-5
