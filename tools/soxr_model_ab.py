"""Model-level bound on the soxr-vs-polyphase CQT resampler deviation


PARITY.md §5 documents the one genuinely open parity channel: librosa 0.10's
chroma_cens defaults to the soxr_hq 2:1 decimator inside its multirate CQT
(reference src/precompute/process.py:53), which is not installable offline;
the shipped device graph uses a bit-matched res_type='polyphase'.
results/deviation_sweep.json measures the bracket (polyphase vs the long
windowed-sinc reference decimator) propagated through CENS -> z-scored
chroma at median 0.62 sigma, p99 4.4 sigma, max 6.7 sigma. This tool answers
the question that matters: does a perturbation of that size move the MODEL?

Method: build two feature caches that differ ONLY in the CQT decimator —
the chroma channel (stack of chroma_stft + CENS, per-row z-score, min-pad
24->128) is recomputed oracle-side in float64 for res_type='polyphase' and
res_type='sinc' and spliced into a copy of the shipped device cache; the
other 8 channels and all scalars are byte-identical between the variants.
Then both archs train at fixed seeds on each cache through the production
CLI, and the per-seed val metrics are compared. The polyphase-spliced
variant (not the raw device cache) is the control, so the measured
difference isolates the resampler choice exactly.

Writes results/soxr_model_ab.json.
Usage: PYTHONPATH=. python tools/soxr_model_ab.py [--seeds-cnn8 2]
       [--seeds-vgg 5] [--splice-only]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

VARIANTS = ("polyphase", "sinc")


def build_spliced_roots(base_root: str = "input") -> None:
    from deviation_sweep import chroma_channel
    from tpu_breath.baseline.feature_np import pad_freq, pad_time
    from tpu_breath.config import DEFAULT_FEATURES as SPEC, Paths
    from tpu_breath.data import dataset as ds
    from tpu_breath.data import wav as wav_io

    paths = Paths(root=base_root)
    store = ds.FeatureStore.load_cache(paths.feature_cache, mmap=False)
    chroma_idx = SPEC.channel_order.index("chroma")

    # decode every wav in store id order (train rows first, then test —
    # the order _build_feature_store writes)
    train_df, test_df = ds.load_tables(paths)
    wav_paths = [os.path.join(paths.train_audio_dir, ds.train_wav_name(i))
                 for i in train_df["ID"]]
    wav_paths += [os.path.join(paths.test_audio_dir, ds.test_wav_name(i))
                  for i in test_df["ID"]]
    assert len(wav_paths) == len(store.ids)
    wavs = wav_io.load_wav_batch(wav_paths, SPEC.expected_len)

    for variant in VARIANTS:
        root = f"{base_root}_soxr_{variant}"
        os.makedirs(root, exist_ok=True)
        for name in ("train", "test", "train.csv", "test.csv"):
            link = os.path.join(root, name)
            if not os.path.exists(link):
                os.symlink(os.path.abspath(os.path.join(base_root, name)),
                           link)
        cache_dir = Paths(root=root).feature_cache
        if ds.FeatureStore.cache_exists(cache_dir):
            print(f"[splice] {cache_dir} exists, skip", flush=True)
            continue
        t0 = time.time()
        feats = np.array(store.features, copy=True)
        for i in range(len(wavs)):
            ch = chroma_channel(wavs[i], variant)            # [24, 63] f32
            feats[i, chroma_idx] = pad_freq(
                pad_time(ch, 24, SPEC.t_fixed), 24, SPEC.n_mels)
            if i % 1000 == 0:
                print(f"[splice:{variant}] {i}/{len(wavs)} "
                      f"({time.time() - t0:.0f}s)", flush=True)
        spliced = ds.FeatureStore(store.ids, feats, store.scalars)
        spliced.save_cache(cache_dir)
        print(f"[splice:{variant}] cache written to {cache_dir} "
              f"({time.time() - t0:.0f}s)", flush=True)


def train_and_collect(seeds_cnn8, seeds_vgg, base_root: str = "input") -> dict:
    from tpu_breath import cli

    out = {}
    for variant in VARIANTS:
        root = f"{base_root}_soxr_{variant}"
        for arch, seeds in (("cnn8", seeds_cnn8), ("vgg", seeds_vgg)):
            for seed in seeds:
                run_dir = f"results/soxr_ab/{variant}_{arch}_seed{seed}"
                hist = os.path.join(run_dir, "checkpoints", arch,
                                    "history.jsonl")
                if not os.path.exists(hist):
                    print(f"[train] {variant} {arch} seed {seed}", flush=True)
                    cli.main(["train", "--root", root, "--out-root", run_dir,
                              "--archs", arch, "--seed", str(seed),
                              "--mesh", "off"])
                rows = [json.loads(l) for l in open(hist)]
                best = max(rows, key=lambda r: r["val_acc"])
                out[f"{variant}_{arch}_seed{seed}"] = {
                    k: best[k] for k in ("epoch", "val_acc", "val_auc",
                                         "val_f1", "val_precision",
                                         "val_recall")}
                print(f"[done] {variant} {arch} seed {seed}: "
                      f"acc {best['val_acc']:.4f}", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds-cnn8", default="2")
    ap.add_argument("--seeds-vgg", default="5")
    ap.add_argument("--splice-only", action="store_true")
    args = ap.parse_args()

    build_spliced_roots()
    if args.splice_only:
        return
    seeds_c = [int(s) for s in args.seeds_cnn8.split(",")]
    seeds_v = [int(s) for s in args.seeds_vgg.split(",")]
    runs = train_and_collect(seeds_c, seeds_v)

    # per-(arch, seed) delta between the variants
    deltas = {}
    for arch, seeds in (("cnn8", seeds_c), ("vgg", seeds_v)):
        for seed in seeds:
            a = runs[f"polyphase_{arch}_seed{seed}"]
            b = runs[f"sinc_{arch}_seed{seed}"]
            deltas[f"{arch}_seed{seed}"] = {
                "acc_delta_sinc_minus_poly": round(
                    b["val_acc"] - a["val_acc"], 6),
                "auc_delta": round(b["val_auc"] - a["val_auc"], 6),
                "f1_delta": round(b["val_f1"] - a["val_f1"], 6)}
    result = {"runs": runs, "deltas": deltas,
              "method": "chroma channel recomputed oracle-side (f64) with "
                        "each CQT decimator and spliced into the shipped "
                        "cache; all other channels/scalars byte-identical"}
    os.makedirs("results", exist_ok=True)
    with open("results/soxr_model_ab.json", "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(deltas, indent=1), flush=True)
    print("written: results/soxr_model_ab.json", flush=True)


if __name__ == "__main__":
    main()
