"""Full evaluation sweep (python -m gof_tpu_torch.full_eval ...; counterpart
of gof_tpu/full_eval.py).

Replaces full_eval.py: for each scene of the Mip-NeRF 360 and NeRF-synthetic
lists, the port's chain with the reference's flags (run_mipnerf360.py:8-46,
run_nerf_synthetic.py:8-24; lists and chains from
gof_tpu_torch.scripts.run_benchmarks): `python -m gof_tpu_torch.train`,
`render_cli --skip_train`, `metrics` and `extract_mesh`, one subprocess
each, scene after scene; a failed command ends its own scene's chain only.
--skip_training, --skip_rendering and --skip_metrics drop those commands;
--cpu runs every command on the CPU.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from .scripts import run_benchmarks
from .scripts.run_benchmarks import MIPNERF360, NERF_SYNTHETIC

STAGES = ("training", "rendering", "metrics", "mesh")


def scene_job(source: str, model: str, extra: list, skip=(), cpu: bool = False) -> list:
    """The command chain of one scene (train, render, metrics, mesh;
    scripts.run_benchmarks.scene_job), each stage named in `skip` left out."""
    return [c for k, c in zip(STAGES, run_benchmarks.scene_job(source, model, extra, cpu=cpu))
            if k not in skip]


def jobs(ns) -> list:
    skip = [k for k in ("training", "rendering", "metrics") if getattr(ns, f"skip_{k}")]
    out = []
    if ns.mipnerf360:
        root = os.path.join(ns.output_path, "mipnerf360")
        for scene, factor in zip(MIPNERF360["scenes"], MIPNERF360["factors"]):
            out.append(scene_job(os.path.join(ns.mipnerf360, scene), os.path.join(root, scene),
                                 ["-r", str(factor), "--eval"], skip, ns.cpu))
    if ns.nerf_synthetic:
        root = os.path.join(ns.output_path, "nerf_synthetic")
        for scene in NERF_SYNTHETIC:
            out.append(scene_job(os.path.join(ns.nerf_synthetic, scene),
                                 os.path.join(root, scene), ["--white_background", "--eval"],
                                 skip, ns.cpu))
    return out


def main(argv=None) -> list:
    """Runs the chains; returns the failed commands as (command, exit code)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mipnerf360", default="")
    ap.add_argument("--nerf_synthetic", default="")
    ap.add_argument("--output_path", default="./eval")
    ap.add_argument("--skip_training", action="store_true")
    ap.add_argument("--skip_rendering", action="store_true")
    ap.add_argument("--skip_metrics", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run every command on the CPU")
    ns = ap.parse_args(argv)

    failures = []
    for job in jobs(ns):
        for cmd in job:
            print("+", " ".join(cmd), flush=True)
            rc = subprocess.run(cmd).returncode
            if rc != 0:
                failures.append((cmd, rc))
                break
    for cmd, rc in failures:
        print(f"FAILED rc={rc}: {' '.join(cmd)}", file=sys.stderr)
    return failures


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
