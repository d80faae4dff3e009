"""History-level fused==cached identity check.

Compares every fused_<arch>_seed<N>.jsonl in a sweep directory against its
cached counterpart row by row on every recorded metric EXCEPT wall time
("sec", the only field allowed to differ between the modes; round 3's claim
and round 5's re-proof are both "identical on every metric at every epoch").
Exit code 0 iff every pair matches exactly.

Usage: python tools/history_identity.py [--dir results/sweep_r5]
       [--out results/history_identity_r5.json]
"""
import argparse
import glob
import json
import os
import sys

IGNORE = {"sec"}


def compare(fused_path: str, cached_path: str) -> dict:
    f_rows = [json.loads(l) for l in open(fused_path)]
    c_rows = [json.loads(l) for l in open(cached_path)]
    res = {"fused": os.path.basename(fused_path),
           "cached": os.path.basename(cached_path),
           "n_epochs_fused": len(f_rows), "n_epochs_cached": len(c_rows)}
    if len(f_rows) != len(c_rows):
        res["equal"] = False
        res["first_diff"] = f"epoch count {len(f_rows)} vs {len(c_rows)}"
        return res
    for i, (a, b) in enumerate(zip(f_rows, c_rows)):
        keys = (set(a) | set(b)) - IGNORE
        for k in sorted(keys):
            if a.get(k) != b.get(k):
                res["equal"] = False
                res["first_diff"] = (f"epoch {i + 1} field {k}: "
                                     f"fused={a.get(k)} cached={b.get(k)}")
                return res
    res["equal"] = True
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/sweep_r5")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    results = []
    for f in sorted(glob.glob(os.path.join(args.dir, "fused_*_seed*.jsonl"))):
        c = f.replace("fused_", "cached_")
        if not os.path.exists(c):
            results.append({"fused": os.path.basename(f), "cached": None,
                            "equal": False, "first_diff": "no cached run"})
            continue
        results.append(compare(f, c))
    ok = all(r["equal"] for r in results) and results
    for r in results:
        mark = "==" if r["equal"] else "!="
        extra = "" if r["equal"] else f"  ({r['first_diff']})"
        print(f"{r['fused']} {mark} {r['cached']}{extra}")
    print("IDENTITY:", "ALL EQUAL (every metric, every epoch; wall time "
          "excluded)" if ok else "DIVERGENT")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"pairs": results, "all_equal": bool(ok)}, fh, indent=1)
        print(f"written: {args.out}")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
