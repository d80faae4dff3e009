"""Locate + diagnose the bpo12 tuning flip from the round-3 parity sweep.

Reproduces the sweep's sample (seed 0, n=500), computes device vs oracle
tuning-12 for each, and for any mismatch dumps where the divergence starts
(S magnitudes, selection mask, histogram counts).
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_breath.config import DEFAULT_FEATURES, Paths
from tpu_breath.data import dataset as ds
from tpu_breath.data import wav as wav_io
from tpu_breath.baseline import dsp_np

import jax
import jax.numpy as jnp
from tpu_breath.ops import spectral as sp_ops, chroma as ch_ops

spec = DEFAULT_FEATURES
paths = Paths(root="input")
train, test = ds.load_tables(paths)
ids = train["ID"] + test["ID"]
wav_paths = ([os.path.join(paths.train_audio_dir, ds.train_wav_name(i))
              for i in train["ID"]]
             + [os.path.join(paths.test_audio_dir, ds.test_wav_name(i))
                for i in test["ID"]])
wavs = wav_io.load_wav_batch(wav_paths, spec.expected_len)

rng = np.random.default_rng(0)
sample = rng.choice(len(ids), size=500, replace=False)


@jax.jit
def device_t12(y):
    s512 = sp_ops.stft_mag_cr(y, spec.n_fft, spec.hop_length)
    return ch_ops.estimate_tuning(s512, spec.sr, spec.n_fft, 12)


mismatches = []
for j, i in enumerate(sample):
    y = wavs[i].astype(np.float64)
    stft_m = np.abs(dsp_np.stft(y, spec.n_fft, spec.hop_length))
    t_o = dsp_np.estimate_tuning_from_S(stft_m, spec.sr, spec.n_fft, 12)
    t_d = float(device_t12(jnp.asarray(wavs[i])))
    if abs(t_d - t_o) > 1e-6:
        mismatches.append((j, i, ids[i], t_o, t_d))
        print(f"FLIP sample={j} idx={i} id={ids[i]} oracle={t_o} device={t_d}")
print(f"{len(mismatches)} flips / 500")

if mismatches:
    _, i, cid, t_o, t_d = mismatches[0]
    y = wavs[i].astype(np.float64)
    S_o64 = np.abs(dsp_np.stft(y, spec.n_fft, spec.hop_length))
    S_o = S_o64.astype(np.float32)
    S_d = np.asarray(sp_ops.stft_mag_cr(jnp.asarray(wavs[i]), spec.n_fft,
                                        spec.hop_length))
    print("S diff: max abs", np.max(np.abs(S_o - S_d)),
          "n mismatched entries", np.sum(S_o != S_d), "of", S_o.size)

    # oracle chain pieces
    p_o, m_o = dsp_np.piptrack(S_o, spec.sr, spec.n_fft)
    mask_o = p_o > 0
    thr_o = np.median(m_o[mask_o]) if mask_o.any() else 0.0
    sel_o = (m_o >= thr_o) & mask_o
    print("oracle: n_pitch", mask_o.sum(), "thr", thr_o, "n_sel", sel_o.sum())

    # device chain pieces on the DEVICE S (f32 graph, replicated in numpy
    # would diverge; run the real ops)
    p_d, m_d = map(np.asarray, ch_ops.piptrack(jnp.asarray(S_d), spec.sr,
                                               spec.n_fft))
    mask_d = p_d > 0
    from tpu_breath.ops import select
    thr_d = float(select.masked_median(jnp.asarray(m_d), jnp.asarray(mask_d)))
    sel_d = (m_d >= thr_d) & mask_d
    print("device: n_pitch", mask_d.sum(), "thr", thr_d, "n_sel", sel_d.sum())
    print("pitch mask agree:", np.array_equal(mask_o, mask_d))

    # histograms
    def oracle_hist(pitches):
        f = pitches[pitches > 0].astype(np.float32)
        q = np.float32(f.astype(np.float64) / 27.5)
        octs = np.float32(np.log2(q.astype(np.float64)))
        r = np.mod(np.float32(12) * octs, np.float32(1.0))
        r[r >= 0.5] -= np.float32(1.0)
        bins = np.linspace(-0.5, 0.5, 101)
        counts, edges = np.histogram(r, bins)
        return counts

    c_o = oracle_hist(p_o[sel_o])
    c_d = oracle_hist(p_d[sel_d])
    top_o = np.argsort(c_o)[-4:][::-1]
    top_d = np.argsort(c_d)[-4:][::-1]
    print("oracle top bins", [(int(b), int(c_o[b])) for b in top_o])
    print("device top bins", [(int(b), int(c_d[b])) for b in top_d])
    diff_bins = np.nonzero(c_o != c_d)[0]
    print("bins with count diffs:", [(int(b), int(c_o[b]), int(c_d[b]))
                                     for b in diff_bins])
