"""Validation-split metrics of the flagship weighted ensemble.

The reference's headline is the ENSEMBLE (paper/sections/results.tex:24), but
its Kaggle holdout is unmeasurable offline and it never reports ensemble
metrics on the val split. This tool does: given per-arch checkpoints, it
computes acc/AUC/precision/recall/F1 on the 800-clip val split (the exact
seed-42 sklearn split, data/dataset.py:39-47) for each model alone, for the
softmax(val-acc)-weighted blend (reference src/utils/ensemble.py:49-74
semantics), and for the unweighted average — quantifying what the ensemble
path actually buys over its best member.

Usage: PYTHONPATH=. python tools/ensemble_val.py \
           --ckpt cnn8=results/sweep/run_fused_cnn8_seed2/checkpoints/cnn8/best_epochNNN \
           --ckpt vgg=...  [--root input] [--out results/ensemble_val.json]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", action="append", required=True,
                    metavar="ARCH=PATH", help="repeatable; arch=checkpoint")
    ap.add_argument("--root", default="input")
    ap.add_argument("--out", default="results/ensemble_val.json")
    args = ap.parse_args()

    from tpu_breath import ensemble
    from tpu_breath.config import Paths, DEFAULT_FEATURES
    from tpu_breath.data import dataset as ds
    from tpu_breath.train import checkpoint as ckpt_lib
    from tpu_breath.train.metrics import binary_metrics

    paths = Paths(root=args.root)
    train, _ = ds.load_tables(paths)
    store = ds.FeatureStore.load_cache(paths.feature_cache, mmap=False)
    _, va_rows = ds.split_train_val(train)
    va = store.subset(va_rows["ID"])
    y_va = np.asarray(ds.labels_from_targets(va_rows["Target"]), np.float32)

    archs, ckpts, scores = [], [], []
    for spec in args.ckpt:
        arch, path = spec.split("=", 1)
        meta = ckpt_lib.load_metadata(path)
        archs.append(arch)
        ckpts.append(path)
        scores.append(float(meta["val_acc"]))
        print(f"[{arch}] {path} (ckpt val_acc {meta['val_acc']:.4f})",
              flush=True)

    out = {"val_n": int(len(y_va)), "members": {}}
    n_scal = va.scalars.shape[1]
    per_model = []
    for arch, path, sc in zip(archs, ckpts, scores):
        model, state = ensemble.load_model_state(path, arch, n_scal)
        probs = ensemble.predict_probs(model, state, va.features, va.scalars)
        per_model.append(probs)
        m = binary_metrics(probs, y_va)
        m["ckpt_val_acc"] = sc
        out["members"][arch] = {k: round(float(v), 6) for k, v in m.items()}
        print(f"[{arch}] val: " + " ".join(
            f"{k}={v:.4f}" for k, v in m.items()), flush=True)

    w = ensemble.softmax_weights(scores)
    blend = np.sum([wi * p for wi, p in zip(w, per_model)], axis=0)
    out["weights_softmax"] = [round(float(x), 6) for x in w]
    out["weighted_ensemble"] = {
        k: round(float(v), 6) for k, v in binary_metrics(blend, y_va).items()}
    avg = np.mean(per_model, axis=0)
    out["average_ensemble"] = {
        k: round(float(v), 6) for k, v in binary_metrics(avg, y_va).items()}
    print("weighted:", out["weighted_ensemble"], flush=True)
    print("average: ", out["average_ensemble"], flush=True)

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"written: {args.out}", flush=True)


if __name__ == "__main__":
    main()
