"""Dataset-level quantification of the two documented oracle deviations
(PARITY.md §5/§5b):

(a) Resampler numerics inside the CQT: librosa 0.10's default soxr_hq 2:1
    decimator vs the bit-matched res_type='polyphase' shipped here. soxr is
    not installable offline; the probe brackets it with the long windowed-
    sinc reference decimator (dsp_np.resample_half('sinc')) and propagates
    the difference through the FULL CENS -> chroma-channel recipe (stack
    with chroma_stft rows, per-row z-score, min-pad) on N_RESAMPLE clips,
    ALL ORACLE-SIDE in float64 — this isolates the resampler choice from
    device numerics.

(b) scipy find_peaks tied-peak ordering: scipy's unstable argsort priority
    vs the device's deterministic highest-height/lowest-index greedy order,
    over ALL clips: count clips where (n_peaks, mean, std) differ.

Writes results/deviation_sweep.json.
Usage: python tools/deviation_sweep.py [--n-resample 500]
"""
import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import scipy.signal


def chroma_channel(y: np.ndarray, res_type: str) -> np.ndarray:
    """The oracle chroma channel (chroma_stft + CENS stacked, per-row
    z-score) with the given CQT decimator — mirrors
    baseline/feature_np.process_clip:149-158 line for line
    (reference src/precompute/process.py:51-57)."""
    from tpu_breath.baseline import dsp_np as L
    from tpu_breath.baseline import feature_np as F
    from tpu_breath.config import DEFAULT_FEATURES as spec

    y = F.pad_or_truncate(np.asarray(y, dtype=np.float32), spec.expected_len)
    stft_m = np.abs(L.stft(y, spec.n_fft, spec.hop_length))
    ch = L.chroma_stft(stft_m, spec.sr)
    cens = L.chroma_cens_librosa(y, spec.sr, spec.hop_length,
                                 fmin=spec.cqt_fmin,
                                 bins_per_octave=spec.cqt_bins_per_octave,
                                 n_octaves=spec.cqt_n_octaves,
                                 win_len_smooth=spec.cens_win_len_smooth,
                                 res_type=res_type)
    stack = np.vstack([ch, cens])
    return F._znorm_rows(stack).astype(np.float32)


def greedy_peaks(env: np.ndarray, distance: int):
    """find_peaks(height=mean, distance) with the device's deterministic
    tie order (descending height, ties by LOWEST index)."""
    from scipy.signal import find_peaks
    cand, props = find_peaks(env, height=env.mean())  # no distance yet
    h = props["peak_heights"]
    order = np.argsort(-h, kind="stable")
    keep = np.ones(len(cand), bool)
    for i in order:
        if not keep[i]:
            continue
        j = i - 1
        while j >= 0 and cand[i] - cand[j] < distance:
            keep[j] = False
            j -= 1
        j = i + 1
        while j < len(cand) and cand[j] - cand[i] < distance:
            keep[j] = False
            j += 1
    kept = h[keep]
    n = int(keep.sum())
    return (n, float(np.mean(kept) if n else 0.0),
            float(np.std(kept) if n > 1 else 0.0))


def scipy_peaks(env: np.ndarray, distance: int):
    from scipy.signal import find_peaks
    p, props = find_peaks(env, height=env.mean(), distance=distance)
    h = props["peak_heights"] if len(p) else [0]
    return (len(p), float(np.mean(h)),
            float(np.std(h) if len(p) > 1 else 0.0))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-resample", type=int, default=500)
    ap.add_argument("--out", default="results/deviation_sweep.json")
    args = ap.parse_args()

    from tpu_breath.data import wav as wav_io

    paths = sorted(glob.glob("/root/reference/input/*/*.wav"))
    wavs = wav_io.load_wav_batch(paths, 16_000)
    rng = np.random.default_rng(0)
    out = {"n_clips_total": len(paths)}

    # ---- (b) tied-peak ordering, ALL clips
    sr = 16_000
    n_diff = 0
    max_abs = {"n_peaks": 0.0, "mean": 0.0, "std": 0.0}
    for i in range(len(wavs)):
        env = np.abs(scipy.signal.hilbert(wavs[i].astype(np.float64)))
        a = scipy_peaks(env, sr // 10)
        b = greedy_peaks(env, sr // 10)
        if a != b:
            n_diff += 1
            for k, (x, y) in zip(("n_peaks", "mean", "std"), zip(a, b)):
                max_abs[k] = max(max_abs[k], abs(x - y))
        if (i + 1) % 1000 == 0:
            print(f"peaks {i + 1}/{len(wavs)}: {n_diff} clips differ",
                  flush=True)
    out["peak_tie"] = {
        "n_clips": len(wavs), "n_clips_differ": n_diff,
        "frac_differ": n_diff / len(wavs), "max_abs_diff": max_abs}
    print(f"(b) tied-peak ordering: {n_diff}/{len(wavs)} clips differ "
          f"({100.0 * n_diff / len(wavs):.2f}%), max diffs {max_abs}",
          flush=True)

    # ---- (a) resampler through the z-scored chroma channel
    n_rs = min(args.n_resample, len(wavs))
    sample = rng.choice(len(wavs), size=n_rs, replace=False)
    errs = []
    for j, i in enumerate(sample):
        y64 = wavs[i].astype(np.float64)
        a = chroma_channel(y64, "polyphase")
        b = chroma_channel(y64, "sinc")
        errs.append(float(np.abs(a - b).max()))
        if (j + 1) % 50 == 0:
            print(f"resample {j + 1}/{n_rs}: max so far {max(errs):.3e}",
                  flush=True)
    errs = np.asarray(errs)
    out["resampler_chroma_channel"] = {
        "n_clips": n_rs,
        "max_abs_err": float(errs.max()),
        "p99_abs_err": float(np.percentile(errs, 99)),
        "median_abs_err": float(np.median(errs)),
    }
    print(f"(a) resampler -> z-scored chroma channel over {n_rs} clips: "
          f"max {errs.max():.3e}, p99 {np.percentile(errs, 99):.3e}, "
          f"median {np.median(errs):.3e}", flush=True)

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"written: {args.out}", flush=True)


if __name__ == "__main__":
    main()
