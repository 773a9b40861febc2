"""Aggregate per-scene results.json files into a summary table
(python -m gof_tpu_torch.scripts.show_results <out_root> [--latex];
counterpart of scripts/show_results.py).

Replaces scripts/show_mipnerf360.py / show_dtu.py / show_tnt.py (latex-row
emitters): prints one row per scene + the mean.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out_root")
    ap.add_argument("--latex", action="store_true")
    ns = ap.parse_args(argv)

    rows = []
    for scene in sorted(os.listdir(ns.out_root)):
        path = os.path.join(ns.out_root, scene, "results.json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            res = json.load(f)
        method = sorted(res)[-1]
        r = res[method]
        rows.append((scene, r.get("PSNR"), r.get("SSIM"), r.get("LPIPS")))

    if not rows:
        print("no results found")
        return
    sep = " & " if ns.latex else "  "
    end = r" \\" if ns.latex else ""
    print(f"{'scene':<16}{sep}{'PSNR':>7}{sep}{'SSIM':>7}{sep}{'LPIPS':>7}{end}")
    for scene, p, s, l in rows:
        print(f"{scene:<16}{sep}{p:>7.3f}{sep}{s:>7.4f}{sep}"
              f"{(f'{l:7.4f}' if l is not None else '      -')}{end}")
    import numpy as np

    ps = [r[1] for r in rows]
    ss = [r[2] for r in rows]
    print(f"{'mean':<16}{sep}{np.mean(ps):>7.3f}{sep}{np.mean(ss):>7.4f}{sep}      -{end}")


if __name__ == "__main__":
    main()
