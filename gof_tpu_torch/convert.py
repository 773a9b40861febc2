"""COLMAP SfM preprocessing (python -m gof_tpu_torch.convert -s <dir>;
counterpart of gof_tpu/convert.py, with its flags and commands).

Replaces convert.py:30-124: feature extraction -> exhaustive matching ->
mapper -> image undistortion, producing the sparse/0 + images layout the
readers expect. --resize is accepted and skipped, as in gof_tpu. Requires
the `colmap` binary; exits with a clear message when it is missing.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys


def run(cmd):
    print("+", " ".join(cmd), flush=True)
    r = subprocess.run(cmd)
    if r.returncode != 0:
        print(f"command failed with code {r.returncode}", file=sys.stderr)
        sys.exit(r.returncode)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-s", "--source_path", required=True)
    ap.add_argument("--no_gpu", action="store_true")
    ap.add_argument("--skip_matching", action="store_true")
    ap.add_argument("--camera", default="OPENCV")
    ap.add_argument("--colmap_executable", default="colmap")
    ap.add_argument("--resize", action="store_true")
    ns = ap.parse_args(argv)

    colmap = ns.colmap_executable
    if shutil.which(colmap) is None:
        print(
            "COLMAP binary not found. Install COLMAP and re-run, or provide a "
            "pre-computed sparse/ model."
        )
        sys.exit(1)

    src = ns.source_path
    use_gpu = "0" if ns.no_gpu else "1"
    if not ns.skip_matching:
        os.makedirs(os.path.join(src, "distorted", "sparse"), exist_ok=True)
        run([colmap, "feature_extractor",
             "--database_path", f"{src}/distorted/database.db",
             "--image_path", f"{src}/input",
             "--ImageReader.single_camera", "1",
             "--ImageReader.camera_model", ns.camera,
             "--SiftExtraction.use_gpu", use_gpu])
        run([colmap, "exhaustive_matcher",
             "--database_path", f"{src}/distorted/database.db",
             "--SiftMatching.use_gpu", use_gpu])
        run([colmap, "mapper",
             "--database_path", f"{src}/distorted/database.db",
             "--image_path", f"{src}/input",
             "--output_path", f"{src}/distorted/sparse",
             "--Mapper.ba_global_function_tolerance=0.000001"])

    run([colmap, "image_undistorter",
         "--image_path", f"{src}/input",
         "--input_path", f"{src}/distorted/sparse/0",
         "--output_path", src,
         "--output_type", "COLMAP"])

    # move sparse files into sparse/0 (convert.py:92-104)
    sparse = os.path.join(src, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for f in os.listdir(sparse):
        if f == "0":
            continue
        shutil.move(os.path.join(sparse, f), os.path.join(sparse, "0", f))
    print("Done.")


if __name__ == "__main__":
    main()
