"""Multi-seed production sweep: train CNN8/VGG at several
seeds on the CURRENT feature stack, cached and/or fused, and archive each
run's history.jsonl under results/sweep/. Re-runnable: completed
(mode, arch, seed) runs are skipped, so a flaky-backend retry loop resumes
where it stopped.

Usage: PYTHONPATH=. python tools/seed_sweep.py [--archs cnn8,vgg]
       [--seeds 0,1,2,3,4] [--modes cached,fused] [--out results/sweep]
"""
import argparse
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="cnn8,vgg")
    ap.add_argument("--seeds", default="0,1,2,3,4")
    ap.add_argument("--modes", default="cached,fused")
    ap.add_argument("--root", default="input")
    ap.add_argument("--out", default="results/sweep")
    args = ap.parse_args()

    from tpu_breath import cli

    os.makedirs(args.out, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    runs = [(m, a, s) for m in args.modes.split(",")
            for a in args.archs.split(",") for s in seeds]
    for mode, arch, seed in runs:
        hist_dst = os.path.join(args.out, f"{mode}_{arch}_seed{seed}.jsonl")
        if os.path.exists(hist_dst):
            print(f"[sweep] skip {hist_dst} (done)", flush=True)
            continue
        out_root = os.path.join(args.out, f"run_{mode}_{arch}_seed{seed}")
        t0 = time.time()
        print(f"[sweep] start {mode} {arch} seed {seed}", flush=True)
        argv = ["train", "--root", args.root, "--out-root", out_root,
                "--archs", arch, "--seed", str(seed), "--mesh", "off"]
        if mode == "fused":
            argv.append("--fused")
        cli.main(argv)
        src = os.path.join(out_root, "checkpoints", arch, "history.jsonl")
        shutil.copyfile(src, hist_dst)
        rows = [json.loads(l) for l in open(hist_dst)]
        best = max(r["val_acc"] for r in rows)
        print(f"[sweep] done {mode} {arch} seed {seed}: best val acc "
              f"{best:.4f} ({time.time() - t0:.0f}s, {len(rows)} epochs)",
              flush=True)

    # summary table
    summary = {}
    for mode, arch, _ in runs:
        key = f"{mode}_{arch}"
        if key in summary:
            continue
        rows_best = []
        for s in seeds:
            p = os.path.join(args.out, f"{mode}_{arch}_seed{s}.jsonl")
            if not os.path.exists(p):
                continue
            rows = [json.loads(l) for l in open(p)]
            i = max(range(len(rows)), key=lambda i: rows[i]["val_acc"])
            rows_best.append(rows[i])
        if rows_best:
            import numpy as np
            summary[key] = {
                "n_seeds": len(rows_best),
                "val_acc_mean": float(np.mean([r["val_acc"] for r in rows_best])),
                "val_acc_std": float(np.std([r["val_acc"] for r in rows_best])),
                "val_acc_best": float(np.max([r["val_acc"] for r in rows_best])),
                "val_auc_best": float(np.max([r["val_auc"] for r in rows_best])),
                "val_f1_best": float(np.max([r["val_f1"] for r in rows_best])),
                "per_seed": [{k: r[k] for k in
                              ("epoch", "val_acc", "val_auc", "val_f1")}
                             for r in rows_best],
            }
    with open(os.path.join(args.out, "SUMMARY.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1), flush=True)


if __name__ == "__main__":
    main()
