"""Benchmark sweep dispatcher (python -m gof_tpu_torch.scripts.run_benchmarks
<dataset> --data_root D --out_root O; counterpart of scripts/run_benchmarks.py).

Replaces the reference's scripts/run_{mipnerf360,dtu,tnt,nerf_synthetic}.py
(one process per GPU, run_mipnerf360.py:50-81). `--workers N` threads pull
scenes off a shared queue; each worker runs a scene's whole chain (train ->
render -> metrics -> mesh [-> TSDF] [-> DTU / TNT eval]) as subprocesses of
the port's CLIs, pinned by pin_env to one device, share-nothing. A failed
command ends only its own scene's chain. Scene lists and per-dataset flags
are gof_tpu's (run_mipnerf360.py:8-10, run_dtu.py:8-21, run_tnt.py:7-28,
run_nerf_synthetic.py:8-24).
"""

from __future__ import annotations

import argparse
import os
import queue
import subprocess
import sys
import threading

MIPNERF360 = {
    "scenes": ["bicycle", "bonsai", "counter", "flowers", "garden", "kitchen", "room", "stump",
               "treehill"],
    "factors": [4, 2, 2, 4, 4, 2, 2, 4, 4],
    "extra": ["--eval"],
}
DTU_SCANS = [24, 37, 40, 55, 63, 65, 69, 83, 97, 105, 106, 110, 114, 118, 122]
TNT_SCENES = ["Barn", "Caterpillar", "Courthouse", "Ignatius", "Meetingroom", "Truck"]
NERF_SYNTHETIC = ["chair", "drums", "ficus", "hotdog", "lego", "materials", "mic", "ship"]
PKG = "gof_tpu_torch"


def scene_job(source, model, extra, do_mesh=True, do_tsdf=False, tail=(), cpu=False):
    """The command chain for one scene (reference run_mipnerf360.py:17-46);
    with `cpu` each of the port's device CLIs gets --cpu."""
    py = [sys.executable, "-m"]
    dev = ["--cpu"] if cpu else []
    cmds = [
        py + [f"{PKG}.train", "-s", source, "-m", model] + extra + dev,
        py + [f"{PKG}.render_cli", "-m", model, "--skip_train"] + dev,
        py + [f"{PKG}.metrics", "-m", model] + dev,
    ]
    if do_mesh:
        cmds.append(py + [f"{PKG}.extract_mesh", "-m", model] + dev)
    if do_tsdf:
        cmds.append(py + [f"{PKG}.extract_mesh_tsdf", "-m", model] + dev)
    cmds.extend(list(c) for c in tail)
    return cmds


def pin_env(wid: int, mode: str) -> dict:
    """Per-worker device pinning, the environment a worker's commands run in.

    cuda: each worker sees one card, CUDA_VISIBLE_DEVICES=<wid>;
    cpu: no card is visible (the commands carry the CLIs' --cpu);
    none: the environment unchanged (single worker).
    """
    if mode == "cuda":
        return {"CUDA_VISIBLE_DEVICES": str(wid)}
    if mode == "cpu":
        return {"CUDA_VISIBLE_DEVICES": ""}
    return {}


def dispatch(jobs, workers: int, pin: str):
    """Run scene jobs over `workers` threads, each running its commands as
    subprocesses in pin_env's environment. Jobs are pulled from a queue as
    workers free up (run_mipnerf360.py:50-81); one failed command ends only
    its own scene's remaining chain. Returns the failures as (worker,
    command, exit code)."""
    q: queue.Queue = queue.Queue()
    for j in jobs:
        q.put(j)
    failures = []
    lock = threading.Lock()

    def worker(wid: int):
        env = dict(os.environ)
        env.update(pin_env(wid, pin))
        while True:
            try:
                job = q.get_nowait()
            except queue.Empty:
                return
            for cmd in job:
                print(f"[w{wid}] + {' '.join(cmd)}", flush=True)
                r = subprocess.run(cmd, env=env)
                if r.returncode != 0:
                    with lock:
                        failures.append((wid, cmd, r.returncode))
                    break

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for wid, cmd, rc in failures:
        print(f"[w{wid}] FAILED rc={rc}: {' '.join(cmd)}", file=sys.stderr)
    return failures


def jobs(ns) -> list:
    """Each selected scene's command chain for ns.dataset."""
    extra_train = ns.train_args.split() if ns.train_args else []
    cpu = ns.pin == "cpu"
    out = []
    if ns.dataset == "mipnerf360":
        for scene, factor in zip(MIPNERF360["scenes"], MIPNERF360["factors"]):
            if ns.scenes and scene not in ns.scenes:
                continue
            out.append(scene_job(os.path.join(ns.data_root, scene),
                                 os.path.join(ns.out_root, scene),
                                 ["-r", str(factor), "--eval"] + extra_train, cpu=cpu))
    elif ns.dataset == "dtu":
        # run_dtu.py:8-21: -r2, decoupled appearance, lambda_distortion 1000;
        # DTU geometry uses the TSDF mesh (run_dtu.py:26-42), then the
        # chamfer eval
        for scan in DTU_SCANS:
            name = f"scan{scan}"
            if ns.scenes and name not in ns.scenes:
                continue
            model = os.path.join(ns.out_root, name)
            tail = []
            if ns.dtu_eval_data:
                tail.append([sys.executable, "-m", f"{PKG}.eval.dtu", "--model_path", model,
                             "--scan_id", str(scan), "--DTU", ns.dtu_eval_data])
            out.append(scene_job(os.path.join(ns.data_root, name), model,
                                 ["-r", "2", "--use_decoupled_appearance", "--lambda_distortion",
                                  "1000"] + extra_train,
                                 do_mesh=True, do_tsdf=True, tail=tail, cpu=cpu))
    elif ns.dataset == "tnt":
        # run_tnt.py:7-28: -r2, decoupled appearance; marching-tets mesh, then
        # the trajectory-aligned F-score eval (run_tnt.py:33-40)
        for scene in TNT_SCENES:
            if ns.scenes and scene not in ns.scenes:
                continue
            model = os.path.join(ns.out_root, scene)
            tail = []
            if ns.tnt_eval_data:
                mesh = os.path.join(model, "test", "ours_30000", "fusion",
                                    "mesh_binary_search_7.ply")
                traj = os.path.join(ns.data_root, scene, f"{scene}_COLMAP_SfM.log")
                cmd = [sys.executable, "-m", f"{PKG}.eval.tnt",
                       "--dataset-dir", os.path.join(ns.tnt_eval_data, scene), "--ply-path", mesh]
                if os.path.exists(traj):
                    cmd += ["--traj-path", traj]
                tail.append(cmd)
            out.append(scene_job(os.path.join(ns.data_root, scene), model,
                                 ["-r", "2", "--use_decoupled_appearance"] + extra_train,
                                 tail=tail, cpu=cpu))
    else:
        for scene in NERF_SYNTHETIC:
            if ns.scenes and scene not in ns.scenes:
                continue
            out.append(scene_job(os.path.join(ns.data_root, scene),
                                 os.path.join(ns.out_root, scene),
                                 ["--white_background", "--eval"] + extra_train, cpu=cpu))
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", choices=["mipnerf360", "dtu", "tnt", "nerf_synthetic"])
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--out_root", required=True)
    ap.add_argument("--scenes", nargs="*", default=None, help="subset of scenes")
    ap.add_argument("--workers", type=int, default=1,
                    help="concurrent scenes; each worker is pinned to one device")
    ap.add_argument("--pin", choices=["cuda", "cpu", "none"], default="none",
                    help="per-worker device pinning (cuda: one card per worker; cpu: every "
                         "command on the CPU)")
    ap.add_argument("--dtu_eval_data", default="",
                    help="DTU ground-truth dir (Points/ObsMask) to chain the chamfer eval "
                         "after mesh extraction")
    ap.add_argument("--tnt_eval_data", default="",
                    help="TNT ground-truth dir to chain the F-score eval after mesh extraction")
    ap.add_argument("--train_args", default="",
                    help="extra flags appended to every train command (space-separated)")
    return ap.parse_args(argv)


def main(argv=None):
    ns = parse_args(argv)
    failures = dispatch(jobs(ns), max(ns.workers, 1), ns.pin)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
