#!/usr/bin/env python3
"""Build and drive gof_tpu_torch's serving, training and mesh-extraction
paths, its DTU/TNT chain, its parallel paths, its gather/scatter probes and
its bench once on one CUDA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --serve   # steps 1-5 alone (serve_main)
    python3 chip_smoke.py --full [DIR]   # the 30k-step run alone (full_main)
    python3 chip_smoke.py --ladder DIR [--rungs N ...]   # the C27 ladder's card runs

1. preflight: torch, CUDA, the card's name and power limit, nvcc;
2. build the CUDA kernels of gof_tpu_torch/csrc with nvcc (sm_90a, one nvcc
   per source, in parallel); print ptxas's registers and spills and each
   kernel's tensor-core, FMA and special-function SASS;
3. make a 100k-gaussian model (bench.py's make_state recipe, seed 1, SH
   degree 3, kernel_size 0.1, filter_3d 1e-4) as a gof_tpu-format model
   directory, and a Blender-format source scene with 4 test views at
   1237x822 on bench.py's camera orbit, in a temporary directory;
4. serve: gof_tpu_torch.render_cli.main(["-m", dir, "--skip_train"]) renders
   the 4 views; the PNGs, the image values and each kernel's launch count
   over that run are checked, and a small scene's CUDA render is held
   against the plain CPU path;
5. hold the forward kernels against their plain PyTorch versions on the
   card, at the shapes of one of those views (the preprocess kernel on the
   served model's leaves and on a 3M-gaussian model with nonzero SH bands
   1-3, in the render's and the field's forms: integer outputs equal,
   floats within PRE_ULPS ulps; K1 in the serving path's
   regularizer instance: T, median depth, MEDIDX, LIVEC and CSTART
   bit-exact, the other channels within ATOL / RTOL, bit-identical across
   launches), and time both with CUDA events; time each layer of that
   view's render, and profile a steady pass over the views;
6. train: a Blender-format scene with 8 training and 4 test views at
   1237x822 on the same orbit (seeded random ground truth) and a
   points3d.ply of bench's 100k-point recipe; gof_tpu_torch.train.main runs
   12 steps (statistics on throughout, the regularizers from step 7), evals
   and saves the PLY; the four kernels' launch counts over that run, the
   losses, the log and the PLY are checked, and render_cli serves the PLY;
7. densify: the same scene through gof_tpu_torch.train.main for 40 steps,
   densifying at 10, 20 and 30 (opacity reset at 35, checkpoints at 20 and
   40): each step's host ms and K1-K4 launches (each at least once a step),
   each densify call's report, active count, capacity and host ms, any pool
   growth and the checkpoint writes; render_cli serves the final PLY;
   load_checkpoint(chkpnt20) equals the state the loop saved bit for bit
   (its read timed), and so does load_checkpoint of that state written in
   an older gof_tpu's legacy layout (moments as TrainParams trees), and
   train.main --start_checkpoint runs steps 21-40; the
   loop's densify inputs of step 30 go through densify_and_prune with the
   world-size prune on, on the card and on CPU copies with the same noise
   (report, masks and values equal, xyz and scaling within 1e-6 of their
   largest magnitude); then every gaussian is split until the pool
   overflows, grow_capacity doubles it and one train step runs on it
   through build_train_step (K1-K4 each launched); K2, K1, K3 and K4 are
   held against their plain versions at that grown pool's shapes, as in 10;
7b. liveness: the same scene through gof_tpu_torch.train.main for 48 steps
   with densification over at 16 (nothing densifies) and temporal liveness
   culling and the regularizers from 17: each step's host ms, key slots,
   live demand and skip, K2 and K1 launched every step, K3 and K4 on every
   step not skipped; at the trained state, each of the 8 views without a
   limit and with warm limits (live_counts + 2): channels 0-7 bit-equal, T
   and the distortion differing only where both T are below 1e-4, and one
   build_train_step (with and without the regularizers) leaving a
   bit-equal state; stale limits (1 chunk) on a translucent copy: live_bad
   equal to the CPU's, the step a no-op that grows the bad tiles' bounds;
   at view 0 the whole step with and without the limit (host clock),
   device busy / idle (torch.profiler) and each layer (the program's
   spans), K1,
   K3 and K4 on the compacted list against their plain versions; the xla
   backend and the dense oracle on the card against the CUDA path (images
   and the rasterizer inputs' gradients);
8. the DTU/TNT chain, each stage through its CLI's main on the card with
   its launches counted: gof_tpu_torch.scripts.make_procedural_scene writes
   its default scene (1237x822, 36 train and 6 test views, 40k points,
   gt_mesh.ply; timed); train.main with the DTU job's flags
   (--use_decoupled_appearance --lambda_distortion 1000) and --eval for
   1000 steps, densifying at the default threshold from 600, the
   regularizers from 800 (each step timed, K1-K4 launched every step, the
   loss finite, the trained embedding rows moved and every other row
   bit-equal to its init, every network weight moved, the checkpoint's
   appearance state and moments bit for bit); render_cli --skip_train and
   metrics (a finite PSNR and SSIM, LPIPS null with its reason);
   extract_mesh_tsdf --dense (max_dim 512) and sparse (voxel 0.02, trunc
   0.08), depth 1-12 (non-empty, finite meshes; stage seconds, block and
   voxel counts);
9. mesh: gof_tpu_torch.extract_mesh.main(["-m", chain model,
   "--texture_mesh"]) extracts the level-set mesh of the chain's PLY over
   its 36 training views (the serving model instead if its field crosses
   0.5 nowhere): counts,
   stage seconds and the launch counts of K5, K2 and K1 over that run; the
   mesh is non-empty and finite and the field at its vertices inside every
   view lies near 0.5 (gof_tpu's e2e bound). K5 is held against its plain
   version at one view with all the tetra points (max |err| <= 1e-6,
   bit-identical across launches, unprojected points exactly 1) and timed;
   the mesh of a small known scene on the card is held against the plain
   CPU path, and the field at all its vertices to gof_tpu's bound; then
   scripts.eval_procedural_geometry scores the marching-tets mesh and both
   TSDF meshes against gt_mesh.ply (F@0.02, precision, recall, chamfer;
   each TSDF mesh's cropped mean_d2s under 0.05), and the card is held
   against the port's CPU path: the appearance step at full width at the
   chain's steps 500 and 1000 (DTU_HOLD_ITERS), each on three views,
   against float64 (multiplier within 1e-5, appearance_l1 within rtol
   1e-5, gradients within 1e-4 x max |float64| at the reference's L1 signs
   and ReLU masks, each ReLU entry that flips within 64 ulps of its
   layer's largest pre-activation; C31's trace op by op at step 1000's
   first view) and discover_blocks / fuse_blocks /
   fuse_depth_maps on three of the chain's depth maps (blocks equal, tsdf
   within 1e-5 where the weights agree, at most 1e-4 of the samples with
   another weight);
9b. parallel (gof_tpu_torch.parallel): (a) two data-parallel ranks
   sharing the card over gloo (parallel.sharding.launch) at bench's point
   in both bench phases: on two copies of bench's view, the state after
   the step against the single-rank step (params within rtol 1e-4 / atol
   1e-7, Adam's moments within 1e-4 of max, the statistics exactly 2x,
   the radii equal; bit-equality printed), on two views against one
   process's mean of their gradients and the same Adam step; the ranks'
   states bit-equal, K1-K4 launched in every rank; the dp step's host
   clock and views/s beside the single-rank step's, each rank's device
   idle share; (c) a one-rank NCCL group's step bit-equal to the dp == 1
   step; (b) train.training(dp=2) with both ranks on the card through the
   densify run's schedule (densifying at 10, 20 and 30, the opacity reset
   at 35): the replicas bit-equal (sha256 of every field), the log,
   checkpoints and PLY written once, by rank 0, and the last checkpoint
   resumed in a one-rank run; (d) the mesh model's opacity field at its
   tetra points with the points split four ways on the card against
   unsharded (rtol 1e-5 / atol 1e-6, K5 launched once per view in every
   shard), and extract_level_set_mesh sharded and unsharded from the mesh
   path's Delaunay: the same vertices and faces; (e) gof_tpu's lr-scaling
   check at its own size (dp=2 at lr x1.41 for 16 steps against dp=1 for
   32);
10. probes: gof_tpu_torch.scripts.pallas_gather_probe.main and
   mxu_gather_probe.main at the scripts' shapes run K6-K13 (row gathers,
   one-hot bf16 and int8 products on the tensor cores, segment sums,
   run-length decode, paged gather) and the binning's sorts: each kernel
   launched, bit-equal to its plain version and to torch.index_select where
   that computes the same function, the segment sums within rtol 1e-5 /
   atol 1e-5 x max |plain| on the card; K10 bit-equal to its plain version
   on CPU copies and across launches, also with one id owning 5000+ rows,
   every row on one id and every row on the sentinel; each timed beside its
   plain version, its library call and its bound; K11 and K13 also on every
   chunk on one page, on fewer chunks than the product's persistent blocks
   and on pages outside the table; K8 and K9 also on sorted indices, every
   row on one index, consecutive rows on distinct k-steps, indices outside
   the table and (K8) 64 k-steps per sorted tile, each case timed; K6 and
   K7 (one kernel) also at W = 30, on a table view one float past its
   buffer, with every index on one row, on the edge indices and at 2^31 +
   65,536 output elements; K12 also with every offset 0, a dense chunk, k
   across 2^30 and across the int32 wrap, uncovered rows and WG = 65,536;
11. the bench design point: bench.py's model, look-at camera and seeded
   random ground truth, through the port's build_train_step in bench's two
   phases (statistics on, regularizers off, step 5000; statistics off,
   regularizers on, step 20000): the median step time, the device idle
   share and the time of each layer of the program's step from
   torch.profiler and its spans, and all four kernels held against their
   plain versions at that view's shapes: K1 in the instance the phase
   launches (without the regularizers in the densify phase, with them in
   the regularize phase; as in 5, and equal to the step's own forward), K3
   on that
   forward's output in the phase's (REG, STATS) instance and the
   one with the statistics flipped (its gaussian-id stream exactly, its
   recomputed T equal to the forward's at every pixel, bit-identical across
   two launches); K4 on the backward's row buffer bit-identical to its
   plain version on CPU copies and across launches, also with one id
   owning 5000+ rows, every row on one id and every row on the sentinel,
   timed beside its column-major entry, whose result must equal it; each
   timed beside its plain version and its library call, with
   its bound (K3's counted per instance from this view's active pairs);
12. profile single calls of K1, K3, K4 (both entries), K8, K9, K10, K11 and
   K13 (device time of each kernel they launch) in each phase;
12b. the port's bench: gof_tpu_torch.bench.main([]) at bench.py's defaults
   (the 100k point at 1237x822 with 20 reps, "late" at 1M gaussians,
   "late3m" at 3M, the 8-camera orbit at 1M with liveness culling); after
   each phase of each point, through bench's observe hook: the phase's
   K1-K4 launches (K2 and K1 at least once per step, K3 and K4 once per
   step not skipped), bench's mean step ms, device busy and idle share
   over 3 more steps, the peak memory, and at the late and late3m points
   K1-K4 held against their plain versions at that phase's shapes as in
   11; on the orbit, after 3 more steps through bench's epoch loop, K1-K4
   held the same way on camera 3's step through its cache row (the
   liveness-compacted list under a bound n_cams - 1 steps stale, as the
   orbit leaves it); then bench's JSON line: every key of bench.py's, the rates finite
   and positive, the key counts positive, 0 < orbit_live_frac <= 1 and
   0 <= orbit_skip_frac <= 1;
12c. full_run: the default schedule compressed to 4500 steps (SHORT_ARGS)
   on the chain's procedural scene through train.main, spied on without a
   synchronisation (RunRecorder): each 1000 steps' host it/s, active count,
   keys, live fraction and skips; densify ms, pool growths, each opacity
   reset and the prune after it; every transition at the iteration the
   schedule gives (densify 600-3400, its size prune from 3100, the reset
   and SH degree 3 at 3000, the regularizers from 3500, culling from 3501),
   the loss finite every step, K2 and K1 launched every step, K3 and K4 on
   every step not skipped, the evals at 3500 and 4500 logged and printed;
   K1-K4 held at its shapes from chkpnt3500 (densify instance) and, through
   the last step's cache row, from chkpnt4500; the mesh path's first field
   evaluation (K5 launched per view) and K5 held at test view 0 with all
   tetra points; on a seeded 1/16 of the gaussians and the centre quarter
   of a view, one step on the card, the CPU path and the CPU path in
   float64 from chkpnt4500 and, with the statistics, from chkpnt3500,
   then densify_and_prune on both devices (trained_card_vs_cpu); every
   densify call's record (densify_breakdown) and their totals;
12d. trajectory: the C27 ladder's rung 0 (RUNGS: the procedural scene at
   96x64, 8 views, 300 steps) started on the host's CPU in a process of its
   own right after the build (python3 chip_smoke.py --trajectory-cpu DIR)
   and run on the card at once, both drawing the CPU's densify noise, with
   the same camera order; at the end every densify call's active counts
   and breakdown on the card within TRAJECTORY_RTOL of the CPU's (Q within
   TRAJECTORY_Q_RTOL), the same calls and resets;
13. print the kernels' JSON line (the four of the first bench phase, K1, K3
   and K4 of the second, the four on the grown pool of 7, K1, K3 and K4 on
   the compacted list of 7b, K1 at the serving
   view, K5 at the chain model's first view, K6-K13 and the four of each
   phase of 12b's late and late3m points and of its orbit, and the five
   of 12c, each with its bound and library time),
   the card's name and power limit, and as the last line
   {"ok": true, "device": {...}}.

Exits non-zero, with no result line, if there is no CUDA device, if any
kernel fails to build or launch, or if any check fails. Needs no network.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_GAUSSIANS = 100_000
PRE_BIG = 3_000_000  # the preprocess kernel's check at the render cell's model size
WIDTH, HEIGHT = 1237, 822
N_VIEWS = 4
SEED = 1
# tolerance of the blend kernel against its plain version: gof_tpu's own
# Pallas-vs-XLA tolerance (tests/test_rasterize.py); K2 must be bit-exact
ATOL, RTOL = 1e-5, 1e-4
# the backward blend against its plain version: max |kernel - plain| <=
# GRAD_BOUND * max |plain| per output group, gof_tpu's Pallas-vs-XLA
# gradient bound (tests/test_rasterize.py:154-157); K4 must be bit-exact
GRAD_BOUND = 1e-4
TRAIN_VIEWS = 8
TRAIN_ITERS = 12
REG_FROM = 7  # the regularizers join at step 7 of the 12
# the densifying run: densify at 10, 20 and 30, checkpoints at 20 and 40.
# The opacity reset waits until 35: a reset at 25 leaves every gaussian of
# this scene (its 3D filter small beside its scales) near opacity 0.01 at
# step 30, under densify's 0.05 prune, which would prune the model. The
# random ground truth gives mean gradients far under the default threshold
# 2e-4 (at most 7.5e-5), where each densification selects one gaussian;
# 1e-9 selects every gaussian with a gradient, about half of them.
DENSIFY_ITERS = 40
DENSIFY_GRAD = 1e-9
DENSIFY_ARGS = ["--iterations", str(DENSIFY_ITERS), "--densify_from_iter", "9",
                "--densification_interval", "10", "--densify_until_iter", "40",
                "--densify_grad_threshold", str(DENSIFY_GRAD),
                "--opacity_reset_interval", "35", "--distortion_from_iter", "15",
                "--depth_normal_from_iter", "15", "--checkpoint_iterations", "20", "40",
                "--test_iterations", "40", "--save_iterations", "40"]
DENSIFY_AT = (10, 20, 30)
# the late training step: densification ends at 16 (densify_from_iter keeps
# its default 500, so nothing densifies) and temporal liveness culling
# turns on at 17, with the regularizers (gof_tpu's defaults turn them on at
# 15,000, culling at 15,001); 48 steps visit each of the 8 views about four
# times with culling on
LIVE_ITERS, LIVE_UNTIL = 48, 16
LIVE_ARGS = ["--iterations", str(LIVE_ITERS), "--densify_until_iter", str(LIVE_UNTIL),
             "--distortion_from_iter", str(LIVE_UNTIL + 1),
             "--depth_normal_from_iter", str(LIVE_UNTIL + 1),
             "--test_iterations", str(LIVE_ITERS + 1)]
BENCH_REPS = 10
# the DTU/TNT chain on the procedural scene: the DTU job's training flags
# (scripts/run_benchmarks.py:147-160) for 1000 steps, densifying at
# gof_tpu's defaults (threshold 2e-4, every 100 steps from 500: at 600-1000
# on the scene's real gradients), the regularizers from step 800
DTU_ITERS = 1000
DTU_REG_FROM = 800
DTU_DENSIFY_FROM, DTU_DENSIFY_EVERY = 500, 100
# the chain states whose appearance step is held on the card (checkpointed:
# a checkpoint only writes, and moves no bit of the trajectory)
DTU_HOLD_ITERS = (500, DTU_ITERS)
# TSDF for a scene about 9 units across whose camera ring (radius 4.2-5.4)
# sees the ground plane out to about 12 units: the dense layout at max_dim
# 512 (voxel ~0.027 over the gaussians' bounds) with a 0.1 truncation; the
# sparse one at voxel 0.02 (16^3 blocks of 0.32) with a 4-voxel truncation
DEPTH_MIN, DEPTH_MAX = 1.0, 12.0
DENSE_TRUNC = 0.1
SPARSE_VOXEL, SPARSE_TRUNC = 0.02, 0.08
TSDF_DEPTH = ["--depth_min", str(DEPTH_MIN), "--depth_max", str(DEPTH_MAX)]
TSDF_DENSE = ["--dense", "--max_dim", "512", "--sdf_trunc", str(DENSE_TRUNC)] + TSDF_DEPTH
TSDF_SPARSE = ["--voxel_size", str(SPARSE_VOXEL), "--sdf_trunc", str(SPARSE_TRUNC)] + TSDF_DEPTH
# the cropped TSDF mesh's mean distance to the gt surface, in scene units
D2S_GATE = 0.05
# fuse_depth_maps on the card against the CPU on a grid of at most this
# many samples per axis (the CPU fuses it in seconds)
DENSE_CHECK_DIM = 256


def preflight() -> str:
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"cuda available: {torch.cuda.is_available()}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        sys.exit(2)
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    from gof_tpu_torch.ops import cuda_lib

    print(f"nvcc: {cuda_lib.find_nvcc()}")
    return smi


SASS_OPS = ("HGMMA", "IGMMA", "HMMA", "IMMA", "FFMA", "FMUL", "FADD", "MUFU", "SHFL", "FSEL",
            "SEL", "BRA", "BSSY", "WARPSYNC", "RED", "REDG", "ATOMG")


def sass_counts(path) -> dict:
    """Per kernel of a built library, how many of each SASS_OPS instruction
    it compiled to (wgmma is GMMA in SASS); {} without cuobjdump."""
    from gof_tpu_torch.ops import cuda_lib

    cuobjdump = os.path.join(os.path.dirname(cuda_lib.find_nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return {}
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                          timeout=120).stdout
    fn, counts = None, {}
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            continue
        words = [w for w in line.split("*/", 1)[-1].split() if not w.startswith("@")]
        op = words[0].split(".")[0] if fn and words else ""
        if op in SASS_OPS:
            counts.setdefault(fn, {}).setdefault(op, 0)
            counts[fn][op] += 1
    return counts


def build() -> None:
    from gof_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    path = cuda_lib.build()
    cuda_lib.library()
    print(f"build: {path} in {time.perf_counter() - t0:.1f} s")
    for line in cuda_lib.build_log().splitlines():
        if any(w in line for w in ("registers", "smem", "spill", "Compiling entry")):
            print(f"  ptxas: {line.strip()}")
    # the instructions the blends and the tensor-core kernels compiled to:
    # tensor-core products, FMAs, the special-function unit's, shuffles,
    # selects and branches
    for fn, c in sass_counts(path).items():
        if "bwd_kernel" in fn or "fwd_kernel" in fn or "MMA" in "".join(c) or "scat" in fn:
            print(f"  sass: {fn}: {c}")


def make_model(n: int, seed: int, sigma: float = -3.2):
    """bench.py::make_state's recipe (gof_tpu_torch.bench.make_state) from a
    generator seeded `seed`, as gof_tpu-format numpy fields."""
    from gof_tpu_torch import bench

    return bench.make_state(n, np.random.default_rng(seed), sigma=sigma)


def orbit_c2w(n_views: int):
    """bench.py's orbit (eye on an ellipse, looking at (0, 0, 5)) as
    Blender/OpenGL camera-to-world matrices."""
    out = []
    for th in np.linspace(-0.7, 0.7, n_views):
        eye = np.array([1.2 * np.sin(th), 0.35 * np.cos(th), 0.0])
        fwd = np.array([0.0, 0.0, 5.0]) - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([right, down, fwd], axis=1)
        c2w[:3, 3] = eye
        c2w[:3, 1:3] *= -1  # COLMAP axes -> OpenGL axes
        out.append(c2w)
    return out


def write_inputs(root: str, n: int, width: int, height: int, n_views: int) -> str:
    """Model dir (PLY + cfg_args.json) and Blender source scene under root."""
    from PIL import Image

    from gof_tpu_torch import config as config_lib
    from gof_tpu_torch.data import scene as scene_lib

    src = os.path.join(root, "scene")
    model = os.path.join(root, "model")
    os.makedirs(os.path.join(src, "images"))
    gy, gx = np.mgrid[0:height, 0:width]
    frames = []
    for i, c2w in enumerate(orbit_c2w(n_views)):
        img = np.stack([gx * 255 // width, gy * 255 // height,
                        np.full_like(gx, 40 * i)], -1).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(src, "images", f"view_{i:03d}.png"))
        frames.append({"file_path": f"images/view_{i:03d}", "transform_matrix": c2w.tolist()})
    for split in ("train", "test"):
        with open(os.path.join(src, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)

    params, state = make_model(n, SEED)
    scene_lib.save_gaussians_ply(
        os.path.join(model, "point_cloud", "iteration_1", "point_cloud.ply"), params, state, 3)
    config_lib.save_cfg(model, config_lib.ModelParams(source_path=src, model_path=model,
                                                      sh_degree=3, kernel_size=0.1),
                        config_lib.PipelineParams(), config_lib.OptimizationParams())
    return model


def serve(model: str, n_views: int, device: str):
    """The main path: the render CLI over the test views, with the kernels'
    launch counts taken over exactly that run."""
    from PIL import Image

    from gof_tpu_torch import render_cli
    from gof_tpu_torch.ops import class_gather, preprocess, rasterize

    counters = (preprocess.PREPROCESS, class_gather.EXPAND, rasterize.FWD)
    for k in counters:
        k.launches = 0
    argv = ["-m", model, "--skip_train"] + (["--cpu"] if device == "cpu" else [])
    t0 = time.perf_counter()
    stats = render_cli.main(argv)["test"]
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in counters}
    print(f"serve: {len(stats)} views in {wall:.2f} s (PLY load + scene read + render + PNG "
          f"writes); launches {launches}")
    for i, s in enumerate(stats):
        print(f"  view {i}: {s['num_keys']} key slots, {s['ms']:.2f} ms")

    rdir = os.path.join(model, "test", "ours_1", "renders")
    pngs = sorted(os.listdir(rdir))
    if len(pngs) != n_views:
        raise RuntimeError(f"expected {n_views} PNGs, found {pngs}")
    for name in pngs:
        arr = np.asarray(Image.open(os.path.join(rdir, name)))
        if arr.std() == 0:
            raise RuntimeError(f"{name} is constant")
    if device == "cuda":
        low = {k: v for k, v in launches.items() if v < n_views}
        if low:
            raise RuntimeError(f"kernels launched fewer times than views: {low}")
    return stats, launches


def view_inputs(model: str, device: str, reps: int = 5):
    """Everything the kernels see for test view 0 — the model's leaves and
    camera, the binning and its class-expansion inputs, payload and meta
    vector — plus the full render. On CUDA, also the device time of each
    layer of the render: the stages of ops/render.py run `reps` times
    between CUDA events (medians)."""
    from gof_tpu_torch import config as config_lib
    from gof_tpu_torch import render_cli
    from gof_tpu_torch.data import scene as scene_lib
    from gof_tpu_torch.ops import binning, preprocess, tiled_ref
    from gof_tpu_torch.ops import rasterize as rz

    cfg, _, _ = config_lib.load_cfg(model)
    sc = scene_lib.Scene(cfg.source_path, "", shuffle=False)
    cam, _ = sc.camera(sc.test_cameras[0], device=device)
    g, s = scene_lib.load_gaussians_ply(
        os.path.join(model, "point_cloud", "iteration_1", "point_cloud.ply"), 3, device=device)
    bg = torch.zeros(3, device=device)
    out = render_cli.render_eval(g, s, cam, cfg, bg)
    ntx, nty = binning.tile_grid(cam.width, cam.height)

    def stages():
        vp = preprocess.preprocess_view(cam, g.xyz, None, g.rotation, None, None, 3,
                                        cfg.kernel_size, s.active,
                                        leaves=preprocess.Leaves.of(g, s))
        yield "preprocess (filters, SH colour, quadrics, rects, op_eff)", vp
        pre, rects = vp.pre, vp.rects
        b = binning.bin_gaussians(pre.depth, rects, ntx, nty, mean2d=pre.mean2d,
                                  radius=pre.radius)
        yield "binning (class layout, K2 expand, sorts)", (rects, b)
        payload = rz.build_payload16(pre.rgb, vp.op_eff, pre.v2g_M, pre.v2g_u0, b)
        meta = rz._meta_vec(cam.focal_x, cam.focal_y, bg, cam.width, cam.height)
        yield "payload gather", (payload, meta)
        tile_out = rz.rasterize_fwd(payload, b, meta, ntx, ntx * nty)
        yield "forward blend (K1) + compact layout", tile_out
        yield "assemble", tiled_ref.assemble_image(tile_out, ntx, nty, cam.width, cam.height)

    times = {}
    with torch.no_grad():
        for _ in range(reps if device == "cuda" else 1):
            res = {}
            evs = []
            if device == "cuda":
                torch.cuda.synchronize()
                evs.append(torch.cuda.Event(enable_timing=True))
                evs[-1].record()
            for name, val in stages():
                res[name] = val
                if device == "cuda":
                    evs.append(torch.cuda.Event(enable_timing=True))
                    evs[-1].record()
            if device == "cuda":
                evs[-1].synchronize()
                for i, name in enumerate(res):
                    times.setdefault(name, []).append(evs[i].elapsed_time(evs[i + 1]))
    if times:
        total = sum(statistics.median(v) for v in times.values())
        print(f"layers of one {cam.width}x{cam.height} view (median of {reps}, CUDA events, "
              f"ms): total {total:.3f}")
        for name, v in times.items():
            print(f"  {name}: {statistics.median(v):.3f}")
    pre = res["preprocess (filters, SH colour, quadrics, rects, op_eff)"].pre
    rects, b = res["binning (class layout, K2 expand, sorts)"]
    payload, meta = res["payload gather"]
    print(f"view 0: {int(b.num_keys)} keys in {int(b.num_slots)} class-padded slots, "
          f"{int(pre.valid.sum())} visible gaussians")
    ex = binning.class_expansion(pre.depth, rects, ntx * nty, pre.mean2d, pre.radius)
    P = pre.depth.shape[0]
    tbl = torch.stack(ex.cols).contiguous()
    gidx = torch.clamp(ex.gidx, 0, P - 1).to(torch.int32).contiguous()
    return (out, (tbl, gidx), (payload, b, meta, ntx, ntx * nty),
            (g, s, cam, cfg.kernel_size))


def check_render(out, width: int, height: int) -> None:
    img = out.image
    if tuple(img.shape) != (9, height, width):
        raise RuntimeError(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError("non-finite image values")
    coverage = float((img[7] > 0).float().mean())
    if not coverage > 0:
        raise RuntimeError("accumulated alpha is zero everywhere")
    print(f"render check: finite [9, {height}, {width}], alpha coverage {coverage:.4f}, "
          f"mean alpha {float(img[7].mean()):.4f}, key slots {int(out.num_keys)}, "
          f"compact demand {int(out.compact_demand)}")


def check_small_scene(device: str = "cuda") -> None:
    """The whole render on `device` against the plain CPU path, on a small
    input: 3000 gaussians of the same recipe, one 160x96 view."""
    from gof_tpu_torch import cameras, config as config_lib, render_cli
    from gof_tpu_torch.model import gaussians as gm

    params, state = make_model(3000, SEED)
    cfg = config_lib.ModelParams(sh_degree=3, kernel_size=0.1)
    outs = []
    for d in (device, "cpu"):
        g, s = gm.from_numpy(params, state, d)
        cam = cameras.look_at_camera(eye=(0.3, 0.1, 0.0), target=(0, 0, 5.0), width=160,
                                     height=96, device=d)
        outs.append(render_cli.render_eval(g, s, cam, cfg, torch.zeros(3, device=d)))
    got, want = outs
    err = float((got.image.cpu() - want.image).abs().max())
    ok = torch.allclose(got.image.cpu(), want.image, atol=ATOL, rtol=RTOL)
    radii_diff = int((got.radii.cpu() != want.radii).sum())
    print(f"small scene, {device} vs plain CPU path: image max |err| {err:.3e} "
          f"(atol {ATOL}/rtol {RTOL}: {ok}), radii differing {radii_diff}, key slots "
          f"{int(got.num_keys)} vs {int(want.num_keys)}")
    # CPU and CUDA math libraries may round a ceil'ed radius differently
    if not ok or radii_diff > 2:
        raise RuntimeError("CUDA render disagrees with the plain CPU path")


def profile_renders(model: str, n_views: int) -> None:
    """torch.profiler over one steady-state pass of the test views: host wall,
    device busy time (kernels and copies only) and the busiest kernels."""
    from torch.profiler import ProfilerActivity, profile

    from gof_tpu_torch import config as config_lib
    from gof_tpu_torch import render_cli
    from gof_tpu_torch.data import scene as scene_lib

    cfg, _, _ = config_lib.load_cfg(model)
    sc = scene_lib.Scene(cfg.source_path, "", shuffle=False)
    cams = [sc.camera(c, device="cuda")[0] for c in sc.test_cameras[:n_views]]
    g, s = scene_lib.load_gaussians_ply(
        os.path.join(model, "point_cloud", "iteration_1", "point_cloud.ply"), 3, device="cuda")
    bg = torch.zeros(3, device="cuda")

    def one_pass():
        for cam in cams:
            render_cli.render_eval(g, s, cam, cfg, bg).image[:3].cpu()

    one_pass()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_pass()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    if not dev:
        print("profile: no device events recorded; idle share not measured")
        return
    print(f"profile of {len(cams)} steady renders (host wall incl. rgb copy to host): "
          f"{wall / len(cams):.3f} ms/view, device busy {busy / len(cams):.3f} ms/view, "
          f"idle share {1 - busy / wall:.3f}, {sum(e.count for e in dev) / len(cams):.0f} "
          f"device ops/view")
    for e in sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
        print(f"  {e.self_device_time_total / 1e3 / len(cams):8.4f} ms/view "
              f"x{e.count // len(cams):4d}  {e.key[:80]}")


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of fn() by CUDA events, after warm-up, each call
    behind a short device sleep (gof_tpu_torch.utils.timing.time_ms)."""
    from gof_tpu_torch.utils.timing import time_ms

    return time_ms(fn, [()], torch.device("cuda"), reps, warmup)


# f32 operations as the kernels' sources write them (an expf, a divide, an
# rsqrtf count one each; a contracted a * b + c two). CHAIN_OPS is
# csrc/ray_alpha.cuh's alpha chain, which K1 and K3 run for every visited
# (pixel, row) pair; K5 runs it with min(t, z) and the T update for every
# (point, row) pair.
CHAIN_OPS = 40
INTEGRATE_OPS = 42
# K1 per active pair (csrc/rasterize_fwd.cu): the T_EPS test, the weight,
# the colour and acc sums and the T update ("blend"); with the regularizer
# channels also the ndc depth, the normal and its rsqrtf, s1, s2 and the
# median test ("reg").
FWD_OPS = {"blend": 11, "reg": 39}
# K3 per active pair (csrc/rasterize_bwd.cu): the gradient chain, with the
# regularizers' and the statistics' terms in the instances that have them.
# The per-visit warp sums (16-21 adds a warp) are not counted.
BWD_OPS = {"grad": 53, "reg": 81, "stats": 23}


def fwd_ops(visited_pairs: int, active_pairs: int, with_reg: bool) -> int:
    return visited_pairs * CHAIN_OPS + active_pairs * (
        FWD_OPS["blend"] + FWD_OPS["reg"] * with_reg)


def bwd_ops(visited_pairs: int, active_pairs: int, with_stats: bool, with_reg: bool) -> int:
    grad = BWD_OPS["grad"] + BWD_OPS["reg"] * with_reg + BWD_OPS["stats"] * with_stats
    return visited_pairs * CHAIN_OPS + active_pairs * grad


def active_pairs(payload, b, fout, meta, ntx: int, ntiles: int) -> int:
    """The visited (pixel, row) pairs whose activity test passes (t > 0.2
    and alpha >= 1/255, rows of the tile's segment in the windows it
    walked): one torch pass of the transmittance chain's test, 128 tiles
    at a time."""
    from gof_tpu_torch.constants import ALPHA_MAX, ALPHA_MIN, NEAR_PLANE
    from gof_tpu_torch.ops import rasterize as rz

    chunk, dev = rz.CHUNK_SIZE, payload.device
    pay_rows, cap = payload.T, payload.shape[1]
    bounds = b.bounds.long()
    live = fout[:, rz.CH_LIVEC, 0].long()
    fx, fy, half_w, half_h = meta[0, 0], meta[0, 1], meta[0, 5], meta[0, 6]
    lane = torch.arange(rz.NPIX, device=dev)
    rows = torch.arange(chunk, device=dev)
    total = 0
    for t0 in range(0, ntiles, 128):
        tids = torch.arange(t0, min(t0 + 128, ntiles), device=dev)
        seg_s, seg_e = bounds[tids], bounds[tids + 1]
        base = torch.div(seg_s, chunk, rounding_mode="floor") * chunk
        nc = torch.where(seg_e > seg_s, torch.div(seg_e - base + chunk - 1, chunk,
                                                  rounding_mode="floor"), 0)
        nc = torch.minimum(nc, live[tids])
        tx = ((tids % ntx) * 32).float()[:, None] + (lane % 32).float()
        ty = ((tids // ntx) * 32).float()[:, None] + (lane // 32).float()
        rx = ((tx + 0.5 - half_w) / fx)[:, None, :]
        ry = ((ty + 0.5 - half_h) / fy)[:, None, :]
        for c in range(int(nc.max()) if len(tids) else 0):
            g = base[:, None] + c * chunk + rows[None, :]
            seg = (g >= seg_s[:, None]) & (g < seg_e[:, None]) & (c < nc)[:, None]
            p = pay_rows[g.clamp(0, cap - 1)]

            def col(k):
                return p[..., k:k + 1]

            d0 = col(4) * rx + col(5) * ry + col(6)
            d1 = col(7) * rx + col(8) * ry + col(9)
            d2 = col(10) * rx + col(11) * ry + col(12)
            dd = d0 * d0 + d1 * d1 + d2 * d2 + 1e-12
            t = -(col(13) * d0 + col(14) * d1 + col(15) * d2) / dd
            mv = ((col(13) + t * d0) ** 2 + (col(14) + t * d1) ** 2 + (col(15) + t * d2) ** 2)
            a = torch.clamp_max(col(3) * torch.exp(-0.5 * mv), ALPHA_MAX)
            total += int(((t > NEAR_PLANE) & (a >= ALPHA_MIN) & seg[..., None]).sum())
    return total


def blend_rows(bounds: torch.Tensor, livec: torch.Tensor) -> int:
    """Payload rows the blend kernels visit: per tile, the rows of its
    segment inside the windows it walked (the early exit's work)."""
    from gof_tpu_torch.ops import rasterize as rz

    seg_s, seg_e = bounds[:-1].long(), bounds[1:].long()
    base = torch.div(seg_s, rz.CHUNK_SIZE, rounding_mode="floor") * rz.CHUNK_SIZE
    end = torch.minimum(seg_e, base + livec.long() * rz.CHUNK_SIZE)
    return int((end - seg_s).clamp(min=0).sum())


def bound(entry: dict, nbytes: float, ops: float = 0.0, library_ms=None) -> dict:
    """Add the card's bound (bytes at 3.35 TB/s, f32 operations at 67
    TFLOP/s) and the library call's time to a kernels-line entry."""
    from gof_tpu_torch.utils.timing import bound_ms

    entry["bound_ms"], entry["bound_by"] = bound_ms(nbytes, ops, "f32")
    entry["library_ms"] = library_ms
    print(f"  {entry['name']}: bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}: "
          f"{nbytes / 2**20:.1f} MiB, {ops:.3e} f32 operations), library call "
          f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}")
    return entry


# the preprocess kernel's float outputs against its plain version on the
# same CUDA tensors (tests/test_torch_cuda.py's bound); its integer outputs
# (valid, the rects) must be equal
PRE_ULPS = 4
# bytes the preprocess kernel must move per gaussian: it reads xyz 12,
# rotation 16, scales 12, opacity 4 and active 1 (and the 3D filter 4, the SH
# coefficients 12 each where given) and writes valid 1, depth 4, mean2d 8,
# conic 12, coef 4, radius 4, radius_xy 8, rgb 12, M 36, u0 12, the rect's
# four ints 16 and op_eff 4
PRE_READ_BYTES, PRE_FILTER_BYTES, PRE_COEFF_BYTES, PRE_WRITE_BYTES = 45, 4, 12, 121


def pre_mismatch(got, want) -> tuple:
    """(integer outputs that differ, the float outputs' largest distance in
    ulps of the larger magnitude, NaN placements that differ) of two
    preprocess_view results."""
    ints = int((got.pre.valid != want.pre.valid).sum())
    ints += sum(int((getattr(got.rects, n) != getattr(want.rects, n)).sum())
                for n in ("x0", "y0", "w", "h"))
    ulps, nans = 0.0, 0
    names = ("depth", "mean2d", "conic", "coef", "radius", "radius_xy", "rgb", "v2g_M",
             "v2g_u0")
    pairs = [(getattr(got.pre, n), getattr(want.pre, n)) for n in names]
    for g, w in pairs + [(got.op_eff, want.op_eff)]:
        g, w = g.flatten(), w.detach().flatten()
        nan = torch.isnan(w)
        nans += int((torch.isnan(g) != nan).sum())
        g, w = g[~nan], w[~nan]
        big = torch.maximum(g.abs(), w.abs())
        ulp = (torch.nextafter(big, torch.full_like(big, float("inf"))) - big).double()
        d = ((g.double() - w.double()).abs() / ulp)[g != w]
        d = torch.nan_to_num(d, nan=float("inf"))  # an infinity against a finite value
        ulps = max(ulps, float(d.max()) if d.numel() else 0.0)
    return ints, ulps, nans


def check_preprocess(pre_in, launches, label: str) -> list:
    """The preprocess kernel (csrc/preprocess.cu) on one view of a model, in
    the render's form (the model's leaves: the 3D filter folded in, the two
    SH tables at degree 3) and the field's (filtered scales and opacities,
    no table, the radius at 3 sigma), each held against its plain version on
    the same CUDA tensors (ints equal, floats within PRE_ULPS ulps, equal
    across launches) and timed beside it. Returns their kernels-line
    entries, with the launches of the serving run."""
    from gof_tpu_torch.model import gaussians as gm
    from gof_tpu_torch.ops import preprocess

    g, s, cam, kernel_size = pre_in
    P = g.xyz.shape[0]
    leaves = preprocess.Leaves.of(g, s)
    forms = {
        "render": ((cam, g.xyz, None, g.rotation, None, None, 3, kernel_size, s.active),
                   dict(leaves=leaves),
                   PRE_READ_BYTES + PRE_FILTER_BYTES + 16 * PRE_COEFF_BYTES),
        "field": ((cam, g.xyz, gm.filtered_scaling(g, s.filter_3d), g.rotation,
                   gm.filtered_opacity(g, s.filter_3d), None, 0, kernel_size, s.active),
                  dict(tight_radius=False), PRE_READ_BYTES),
    }
    entries = []
    for form, (args, kw, read_bytes) in forms.items():
        with torch.no_grad():
            got = preprocess.preprocess_view_cuda(*args, **kw)
            again = preprocess.preprocess_view_cuda(*args, **kw)
            want = preprocess.preprocess_view_reference(*args, **kw)
        torch.cuda.synchronize()
        ints, ulps, nans = pre_mismatch(got, want)
        same = pre_mismatch(got, again) == (0, 0.0, 0)
        name = f"preprocess ({form}, {label})"
        print(f"{name}: {P} gaussians at {cam.width}x{cam.height}, {int(got.pre.valid.sum())} "
              f"valid; integer outputs differing {ints}, NaN placements differing {nans}, "
              f"largest float distance {ulps:.1f} ulps (bound {PRE_ULPS}); bit-identical "
              f"across launches {same}")
        if ints or nans or ulps > PRE_ULPS or not same:
            raise RuntimeError(f"{name} disagrees with its plain version")
        with torch.no_grad():
            ms = cuda_ms(lambda: preprocess.preprocess_view_cuda(*args, **kw), 20)
            plain_ms = cuda_ms(lambda: preprocess.preprocess_view_reference(*args, **kw), 5)
        print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        entries.append(bound({"name": name, "route": "cuda",
                              "source": "gof_tpu_torch/csrc/preprocess.cu",
                              "replaces": "gof_tpu/ops/quadrics.py (preprocess)",
                              "launches": launches["preprocess"], "max_ulps": ulps,
                              "ms": ms, "plain_ms": plain_ms},
                             P * (read_bytes + PRE_WRITE_BYTES)))
    return entries


def sh_model(n: int, seed: int, device: str = "cuda"):
    """bench.py's scene of n gaussians with what a trained model has and its
    recipe lacks: SH bands 1-3 N(0, 0.2) and a 3D filter spread over
    [1e-4, 0.05], drawn from a generator seeded `seed`."""
    from gof_tpu_torch.model import gaussians as gm

    rng = np.random.default_rng(seed)
    params, state = make_model(n, seed)
    params.features_rest = rng.normal(0, 0.2, params.features_rest.shape).astype(np.float32)
    state.filter_3d = rng.uniform(1e-4, 0.05, n).astype(np.float32)
    return gm.from_numpy(params, state, device)


def check_kernels(expand_in, raster_in, launches, with_reg: bool, phase: str,
                  fout=None) -> list:
    """K2 bit-exact against its plain version and K1 (check_fwd) at one
    view's shapes, each timed beside its plain version."""
    from gof_tpu_torch.ops import class_gather
    from gof_tpu_torch.ops import rasterize as rz

    results = []
    tbl, gidx = expand_in
    got = class_gather.expand_kernel_call(tbl, gidx)
    want = class_gather.expand_reference(tbl, gidx)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise RuntimeError(f"expand kernel differs from its plain version in {bad} entries")
    ms = cuda_ms(lambda: class_gather.expand_kernel_call(tbl, gidx), 20)
    plain_ms = cuda_ms(lambda: class_gather.expand_reference(tbl, gidx), 20)
    print(f"expand: tbl {tuple(tbl.shape)}, gidx [{gidx.shape[0]}]: bit-exact; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    g64 = gidx.long()
    results.append(bound({"name": "expand", "route": "cuda",
                          "source": "gof_tpu_torch/csrc/expand.cu",
                          "replaces": "gof_tpu/ops/class_gather.py:56",
                          "launches": launches["expand"], "max_abs_err": 0.0,
                          "ms": ms, "plain_ms": plain_ms},
                         4 * (tbl.numel() + gidx.numel() + tbl.shape[0] * gidx.shape[0]),
                         library_ms=cuda_ms(lambda: tbl[:, g64], 20)))

    return results + [check_fwd(raster_in, launches, with_reg, phase, fout)]


# K1's channels that come from its exact chain (T, the median depth and visit
# index) or from integer counts: bit-exact against the plain version; the
# other float channels are accumulations, held to ATOL / RTOL
FWD_EXACT = {"T": 9, "median depth": 6, "MEDIDX": 11, "LIVEC": 12, "CSTART": 13}
FWD_TOL = [0, 1, 2, 3, 4, 5, 7, 8, 10]


def check_fwd(raster_in, launches, with_reg: bool, phase: str, fout=None) -> dict:
    """K1 in the instance the phase launches against its plain version at
    this view's shapes: T, median depth, MEDIDX, LIVEC and CSTART bit-exact,
    channels 0-5, 7, 8 and 10 within ATOL / RTOL, bit-identical across two
    launches (and to `fout`, the phase's own forward, when given); timed
    beside its plain version. Returns its kernels-line entry."""
    from gof_tpu_torch.ops import rasterize as rz

    payload, b, meta, ntx, ntiles = raster_in
    got = rz.rasterize_fwd(payload, b, meta, ntx, ntiles, with_reg=with_reg)
    again = rz.rasterize_fwd(payload, b, meta, ntx, ntiles, with_reg=with_reg)
    want = rz.rasterize_fwd_reference(payload, b, meta, ntx, ntiles, with_reg=with_reg)
    torch.cuda.synchronize()
    err = (got[:, FWD_TOL] - want[:, FWD_TOL]).abs()
    tol_ok = bool((err <= ATOL + RTOL * want[:, FWD_TOL].abs()).all())
    max_err = float(err.max())
    exact = {n: int((got[:, ch] != want[:, ch]).sum()) for n, ch in FWD_EXACT.items()}
    same = torch.equal(got, again) and (fout is None or torch.equal(got, fout))
    identical = int((got == want).all(dim=(1, 2)).sum())
    print(f"rasterize_fwd ({phase}, REG={int(with_reg)}): payload {tuple(payload.shape)}, "
          f"{ntiles} tiles: max |err| {max_err:.3e} on channels {FWD_TOL}, within atol "
          f"{ATOL}/rtol {RTOL}: {tol_ok}; pixels differing in the exact channels {exact}; "
          f"bit-identical across launches{'' if fout is None else ' and to the step'}s "
          f"{same}; {identical}/{ntiles} tiles bit-identical to the plain version; live "
          f"windows {int(got[:, rz.CH_LIVEC, 0].sum())}")
    if not tol_ok or any(exact.values()) or not same:
        raise RuntimeError(f"rasterize_fwd ({phase}) disagrees with its plain version")
    ms = cuda_ms(lambda: rz.rasterize_fwd(payload, b, meta, ntx, ntiles, with_reg=with_reg), 10)
    plain_ms = cuda_ms(lambda: rz.rasterize_fwd_reference(payload, b, meta, ntx, ntiles,
                                                          with_reg=with_reg), 3)
    print(f"rasterize_fwd ({phase}, REG={int(with_reg)}): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms")
    visited = blend_rows(b.bounds, got[:, rz.CH_LIVEC, 0])
    active = active_pairs(payload, b, got, meta, ntx, ntiles)
    print(f"rasterize_fwd ({phase}) pairs: {visited * rz.NPIX} visited, {active} active "
          f"({active / (visited * rz.NPIX):.4f})")
    return bound({"name": f"rasterize_fwd ({phase})", "route": "cuda",
                  "source": "gof_tpu_torch/csrc/rasterize_fwd.cu",
                  "replaces": "gof_tpu/ops/rasterize_pallas.py:344",
                  "launches": launches["rasterize_fwd"], "max_abs_err": max_err,
                  "ms": ms, "plain_ms": plain_ms},
                 4 * (visited * payload.shape[0] + got.numel() + b.bounds.numel()
                      + meta.numel()),
                 fwd_ops(visited * rz.NPIX, active, with_reg))


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def write_train_scene(root: str, n: int, width: int, height: int):
    """Blender source scene for training: 8 training and 4 test views on the
    orbit, seeded random ground truth, and a points3d.ply of bench's
    n-point recipe (make_model's xyz, random colours). Returns (dir, xyz)."""
    from PIL import Image

    from gof_tpu_torch.utils import ply

    src = os.path.join(root, "train_scene")
    os.makedirs(os.path.join(src, "images"))
    rng = np.random.default_rng(SEED)
    for split, c2ws in (("train", orbit_c2w(TRAIN_VIEWS)), ("test", orbit_c2w(N_VIEWS))):
        frames = []
        for i, c2w in enumerate(c2ws):
            name = f"images/{split}_{i:03d}"
            img = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
            Image.fromarray(img).save(os.path.join(src, name + ".png"), compress_level=1)
            frames.append({"file_path": name, "transform_matrix": c2w.tolist()})
        with open(os.path.join(src, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    params, _ = make_model(n, SEED)
    cols = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    xyz = params.xyz
    ply.write_ply(os.path.join(src, "points3d.ply"),
                  {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
                   "red": cols[:, 0], "green": cols[:, 1], "blue": cols[:, 2]})
    return src, xyz


def train_counters():
    """The launch counters of the train step's kernels: K2, K1, K3, K4."""
    from gof_tpu_torch.ops import class_gather, rasterize, reduce

    return class_gather.EXPAND, rasterize.FWD, rasterize.BWD, reduce.REDUCE


def timed_build(build, steps: list, last: dict | None = None):
    """Wraps train.build_train_step: each step it builds is timed on the host
    clock between synchronisations and appended to `steps` with its
    iteration, loss, active count, capacity, K2/K1/K3/K4 launches and its
    liveness metrics (whether it got a cache row, the key slots, the live
    demand, whether it skipped its update); `last["state"]` holds the state
    the last step returned."""
    counters = train_counters()

    def build_timed(*a, **k):
        step = build(*a, **k)

        def timed(*args, **kw):
            before = [c.launches for c in counters]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = step(*args, **kw)
            loss = float(res[3]["loss"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            gs = res[2]
            packed = res[3]["packed"].tolist()
            steps.append({"iter": int(args[4]), "ms": ms, "loss": loss,
                          "active": int(gs.active.sum()), "cap": int(gs.active.shape[0]),
                          "launches": [c.launches - b for c, b in zip(counters, before)],
                          "culled": kw.get("lim") is not None, "slots": int(packed[2]),
                          "live_demand": int(packed[7]), "skipped": bool(packed[9])})
            if last is not None:
                last["state"] = res[:3]
            return res

        return timed

    return build_timed


def train_entry(src: str, out: str, xyz0: np.ndarray):
    """The training path through its entry point, train.main, with the four
    kernels' launch counts taken over exactly that run and each step timed
    on the host clock between synchronisations."""
    from unittest import mock

    from gof_tpu_torch import train

    steps = []
    counters = train_counters()
    for k in counters:
        k.launches = 0
    argv = ["-s", src, "-m", out, "--iterations", str(TRAIN_ITERS), "--sh_degree", "3",
            "--kernel_size", "0.1", "--distortion_from_iter", str(REG_FROM),
            "--depth_normal_from_iter", str(REG_FROM), "--test_iterations", str(TRAIN_ITERS),
            "--save_iterations", str(TRAIN_ITERS), "--quiet"]
    t0 = time.perf_counter()
    with mock.patch.object(train, "build_train_step", timed_build(train.build_train_step, steps)):
        tp, gstate = train.main(argv)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in counters}
    print(f"train: {TRAIN_ITERS} steps through gof_tpu_torch.train.main in {wall:.2f} s "
          f"(scene read, init, 3D filter, steps, eval, PLY); launches {launches}")
    print(f"  step ms (host clock, synchronised): {[round(r['ms'], 3) for r in steps]}")
    print(f"  loss first {steps[0]['loss']:.6f}, last {steps[-1]['loss']:.6f}")

    recs = [json.loads(line) for line in open(os.path.join(out, "train_log.jsonl"))]
    evals = [r["eval"] for r in recs if "eval" in r]
    logged = [r for r in recs if "loss" in r]
    print(f"  train_log: {len(logged)} step records {[r['iter'] for r in logged]}, eval {evals}")
    if len(steps) != TRAIN_ITERS or not all(np.isfinite(r["loss"]) for r in steps):
        raise RuntimeError(f"train losses: {[r['loss'] for r in steps]}")
    if [r["iter"] for r in logged] != [1, 10] or not all(np.isfinite(r["loss"]) for r in logged):
        raise RuntimeError(f"train_log records: {logged}")
    if len(evals) != 1 or not np.isfinite(evals[0]["psnr"]):
        raise RuntimeError(f"eval records: {evals}")
    low = {k: v for k, v in launches.items() if v < TRAIN_ITERS}
    if low:
        raise RuntimeError(f"kernels launched fewer times than steps: {low}")
    ply = os.path.join(out, "point_cloud", f"iteration_{TRAIN_ITERS}", "point_cloud.ply")
    if not os.path.exists(ply):
        raise RuntimeError(f"no PLY at {ply}")
    n = xyz0.shape[0]
    moved = float((tp.gauss.xyz[:n].detach().cpu() - torch.from_numpy(xyz0)).abs().max())
    finite = all(bool(torch.isfinite(getattr(tp.gauss, f)).all()) for f in train.GAUSS_FIELDS)
    print(f"  params: max |xyz - init| {moved:.3e}, all finite {finite}, active "
          f"{int(gstate.active.sum())} of {gstate.active.shape[0]}")
    if not moved > 0 or not finite:
        raise RuntimeError("training left the params unchanged or non-finite")
    return launches, steps, evals[0]


def serve_trained(out: str, iteration: int = TRAIN_ITERS) -> None:
    from PIL import Image

    from gof_tpu_torch import render_cli

    stats = render_cli.main(["-m", out, "--skip_train"])["test"]
    rdir = os.path.join(out, "test", f"ours_{iteration}", "renders")
    pngs = sorted(os.listdir(rdir))
    if len(pngs) != N_VIEWS or any(np.asarray(Image.open(os.path.join(rdir, p))).std() == 0
                                   for p in pngs):
        raise RuntimeError(f"serving the trained PLY: {pngs}")
    print(f"served the trained PLY: {len(pngs)} views, ms {[round(s['ms'], 2) for s in stats]}")


# ---------------------------------------------------------------------------
# Densification, pool growth, checkpoints and resume
# ---------------------------------------------------------------------------


def state_copy(tp, opt_state, gstate, device="cpu"):
    """A copy of the loop's (TrainParams, AdamState, GaussianState) on
    `device`."""
    from gof_tpu_torch import train
    from gof_tpu_torch.model import gaussians as gm

    def cp(g):
        return gm.GaussianParams(*[getattr(g, f).detach().to(device, copy=True)
                                   for f in train.GAUSS_FIELDS])

    return (train.TrainParams(gauss=cp(tp.gauss)),
            train.AdamState(count=opt_state.count, mu=cp(opt_state.mu), nu=cp(opt_state.nu)),
            gm.GaussianState(*[getattr(gstate, f).to(device, copy=True)
                               for f in train.STATE_FIELDS]))


def state_diff(a, b, rel_fields=()) -> dict:
    """Per field of two (TrainParams, AdamState, GaussianState) triples, on
    the CPU: max |a - b| / max |b| for rel_fields, else the count of
    differing elements (NaNs equal)."""
    from gof_tpu_torch import train

    out = {}
    pairs = [(f"gauss.{f}", getattr(a[0].gauss, f), getattr(b[0].gauss, f))
             for f in train.GAUSS_FIELDS]
    pairs += [(f"{m}.{f}", getattr(getattr(a[1], m), f), getattr(getattr(b[1], m), f))
              for m in ("mu", "nu") for f in train.GAUSS_FIELDS]
    pairs += [(f"gstate.{f}", getattr(a[2], f), getattr(b[2], f)) for f in train.STATE_FIELDS]
    for name, x, y in pairs:
        x, y = x.detach().cpu(), y.detach().cpu()
        if name.split(".")[1] in rel_fields and name.startswith("gauss."):
            fin = torch.isfinite(y)
            scale = float(y[fin].abs().max()) if fin.any() else 1.0
            same_nan = torch.equal(torch.isfinite(x), fin)
            err = float((x[fin] - y[fin]).abs().max()) / max(scale, 1e-30) if fin.any() else 0.0
            out[name] = err if same_nan else float("inf")
        else:
            out[name] = int((~((x == y) | (torch.isnan(x) & torch.isnan(y)))).sum())
    if a[1].count != b[1].count:
        out["count"] = f"{a[1].count} != {b[1].count}"
    return out


def densify_entry(src: str, out: str, smi: str):
    """The densifying run through train.main, at full width: each step and
    each densify_and_prune / grow_capacity / save_checkpoint call timed on
    the host clock between synchronisations, K1-K4's launches counted per
    step. Returns CPU copies of the state the loop saved at step 20 and of
    the densify call's inputs at step 30."""
    from unittest import mock

    from gof_tpu_torch import train
    from gof_tpu_torch.model import gaussians as gm

    counters = train_counters()
    steps, densify, grows, saves, held = [], [], [], [], {}
    densify_fn, grow_fn, save_fn = gm.densify_and_prune, train.grow_capacity, train.save_checkpoint

    def timed_call(fn, record):
        def wrapped(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args)
            torch.cuda.synchronize()
            record(args, res, (time.perf_counter() - t0) * 1e3)
            return res

        return wrapped

    def on_densify(args, res, ms):
        if steps[-1]["iter"] == DENSIFY_AT[-1]:
            held["densify"] = state_copy(train.TrainParams(gauss=args[0]), args[2], args[1])
        rep = [int(x) for x in res[3]]
        densify.append({"iter": steps[-1]["iter"], "ms": ms, "report": rep,
                        "active": [int(args[1].active.sum()), int(res[1].active.sum())],
                        "cap": int(res[1].active.shape[0])})
        print(f"  densify at step {steps[-1]['iter']}: {ms:.3f} ms (host clock, synchronised); "
              f"cloned {rep[0]}, split {rep[1]}, pruned {rep[2]}, overflow {bool(rep[3])}; "
              f"active {densify[-1]['active'][0]} -> {densify[-1]['active'][1]} of "
              f"{densify[-1]['cap']}")

    def on_grow(args, res, ms):
        grows.append((args[3], args[4], ms))
        print(f"  grow_capacity {args[3]} -> {args[4]}: {ms:.3f} ms")

    def on_save(args, res, ms):
        saves.append((args[1], ms, os.path.getsize(res)))
        if args[1] == 20:
            held["state"] = state_copy(*args[2:5])

    for k in counters:
        k.launches = 0
    argv = ["-s", src, "-m", out, "--sh_degree", "3", "--kernel_size", "0.1", "--quiet",
            *DENSIFY_ARGS]
    t0 = time.perf_counter()
    with mock.patch.object(train, "build_train_step", timed_build(train.build_train_step, steps)), \
            mock.patch.object(gm, "densify_and_prune", timed_call(densify_fn, on_densify)), \
            mock.patch.object(train, "grow_capacity", timed_call(grow_fn, on_grow)), \
            mock.patch.object(train, "save_checkpoint", timed_call(save_fn, on_save)):
        tp, gstate = train.main(argv)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in counters}
    print(f"densify run: {DENSIFY_ITERS} steps through gof_tpu_torch.train.main in {wall:.2f} s; "
          f"launches {launches}; card {smi}")
    for r in steps:
        print(f"  step {r['iter']}: {r['ms']:.3f} ms, loss {r['loss']:.6f}, active {r['active']} "
              f"of {r['cap']}, launches K2/K1/K3/K4 {r['launches']}")
    for it, ms, size in saves:
        print(f"  save_checkpoint at step {it}: {ms / 1e3:.3f} s, {size / 2**20:.1f} MiB")

    if [d["iter"] for d in densify] != list(DENSIFY_AT):
        raise RuntimeError(f"densify ran at {[d['iter'] for d in densify]}, not {DENSIFY_AT}")
    if len(steps) != DENSIFY_ITERS or not all(np.isfinite(r["loss"]) for r in steps):
        raise RuntimeError(f"densify run losses: {[r['loss'] for r in steps]}")
    low = [r["iter"] for r in steps if min(r["launches"]) < 1]
    if low:
        raise RuntimeError(f"steps without a launch of each of K1-K4: {low}")
    if int(gstate.active.sum()) == N_GAUSSIANS:
        raise RuntimeError("densification left the active count unchanged")
    for it in (20, 40):
        if not os.path.exists(os.path.join(out, f"chkpnt{it}.pkl")):
            raise RuntimeError(f"no chkpnt{it}.pkl")
    if "state" not in held:
        raise RuntimeError("no checkpoint was saved at step 20")
    serve_trained(out, DENSIFY_ITERS)
    return held["state"], held["densify"]


def write_legacy_checkpoint(path: str, tp, opt_state, gstate, iteration: int) -> str:
    """The state as an older gof_tpu pickled it, without importing gof_tpu:
    {"tp", "opt_state", "gstate", "iter"} under gof_tpu's class names, with
    Adam's moments as TrainParams trees in a 3-field FusedAdamState (the
    layout gof_tpu/train.py:1231-1244 migrates). Returns the path."""
    import pickle
    from collections import namedtuple

    from gof_tpu_torch import train

    names = {cls: key for key, cls in train._GOF_CLASSES.items()}
    legacy_adam = namedtuple("FusedAdamState", "count mu_flat nu_flat")
    names[legacy_adam] = ("gof_tpu.train", "FusedAdamState")
    trees = train._GOF_CLASSES[("gof_tpu.train", "TrainParams")]
    gauss = train._GOF_CLASSES[("gof_tpu.model.gaussians", "GaussianParams")]

    def tree(g):
        return trees(gauss(*[getattr(g, f).detach().cpu().numpy() for f in train.GAUSS_FIELDS]),
                     None, None)

    blob = {"tp": tree(tp.gauss),
            "opt_state": legacy_adam(np.int32(opt_state.count), tree(opt_state.mu),
                                     tree(opt_state.nu)),
            "gstate": train._GOF_CLASSES[("gof_tpu.model.gaussians", "GaussianState")](
                *[getattr(gstate, f).cpu().numpy() for f in train.STATE_FIELDS]),
            "iter": int(iteration)}

    class LegacyPickler(pickle._Pickler):
        """Names the stand-ins by gof_tpu's module and class."""

        def save_global(self, obj, name=None):
            if obj not in names:
                return super().save_global(obj, name)
            for part in names[obj]:
                self.save(part)
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)

    with open(path, "wb") as f:
        LegacyPickler(f, protocol=4).dump(blob)
    return path


def resume_entry(src: str, out: str, held) -> None:
    """load_checkpoint(chkpnt20) equals the state the loop saved at step 20
    bit for bit, and so does load_checkpoint of that state written in an
    older gof_tpu's legacy layout (write_legacy_checkpoint); train.main
    --start_checkpoint runs steps 21-40."""
    from gof_tpu_torch import train

    ckpt = os.path.join(out, "chkpnt20.pkl")
    t0 = time.perf_counter()
    tp, st, gs, it = train.load_checkpoint(ckpt, "cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    diff = state_diff(state_copy(tp, st, gs), held)
    bad = {k: v for k, v in diff.items() if v}
    print(f"resume: load_checkpoint(chkpnt20.pkl) to the card in {secs:.3f} s, iteration {it}; "
          f"fields differing from the state saved: {bad or 'none'}")
    if bad or it != 20:
        raise RuntimeError(f"checkpoint round trip: iteration {it}, {bad}")
    legacy = write_legacy_checkpoint(os.path.join(out, "legacy20.pkl"), *held, 20)
    tp, st, gs, it = train.load_checkpoint(legacy, "cuda")
    diff = state_diff(state_copy(tp, st, gs), held)
    bad = {k: v for k, v in diff.items() if v}
    print(f"  the same state in gof_tpu's legacy layout (moments as TrainParams trees, "
          f"{os.path.getsize(legacy) / 2**20:.1f} MiB): load_checkpoint to the card, iteration "
          f"{it}, on {gs.active.device}; fields differing from the state saved: {bad or 'none'}")
    if bad or it != 20 or gs.active.device.type != "cuda":
        raise RuntimeError(f"legacy checkpoint: iteration {it}, {bad}")
    resumed = os.path.join(os.path.dirname(out), "resumed")
    t0 = time.perf_counter()
    train.main(["-s", src, "-m", resumed, "--sh_degree", "3", "--kernel_size", "0.1", "--quiet",
                *DENSIFY_ARGS, "--start_checkpoint", ckpt])
    wall = time.perf_counter() - t0
    recs = [json.loads(line) for line in open(os.path.join(resumed, "train_log.jsonl"))]
    logged = [r for r in recs if "loss" in r]
    print(f"  resumed run: steps 21-{DENSIFY_ITERS} in {wall:.2f} s, records "
          f"{[(r['iter'], r['loss'], r['points']) for r in logged]}")
    if not logged or logged[0]["iter"] != 21 or not all(np.isfinite(r["loss"]) for r in logged):
        raise RuntimeError(f"resumed run records: {logged}")
    if not os.path.exists(os.path.join(resumed, f"chkpnt{DENSIFY_ITERS}.pkl")):
        raise RuntimeError("the resumed run wrote no final checkpoint")


def densify_both(label: str, card, cpu, noise, consts, smi: str):
    """densify_and_prune on the card state (timed, 3 calls) and on its CPU
    copy with the same noise; the report, masks and every value equal,
    xyz and scaling within 1e-6 of their largest magnitude. Returns the
    card's result."""
    from gof_tpu_torch import train
    from gof_tpu_torch.model import gaussians as gm

    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g2, s2, m2, rep = gm.densify_and_prune(card[0].gauss, card[2], card[1],
                                               [n.cuda() for n in noise], *consts)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    cg, cs, cm, crep = gm.densify_and_prune(cpu[0].gauss, cpu[2], cpu[1], noise, *consts)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    reps = [int(x) for x in rep], [int(x) for x in crep]
    diff = state_diff((train.TrainParams(gauss=g2), m2, s2), (train.TrainParams(gauss=cg), cm, cs),
                      rel_fields=("xyz", "scaling"))
    bad = {k: v for k, v in diff.items()
           if (v > 1e-6 if k in ("gauss.xyz", "gauss.scaling") else v)}
    print(f"  densify_and_prune, {label}, at {card[2].active.shape[0]} slots: card "
          f"{[round(x, 3) for x in ms]} ms (host clock, synchronised), CPU {cpu_ms:.1f} ms; "
          f"report (cloned, split, pruned, overflow) card {reps[0]}, CPU {reps[1]}; active "
          f"{int(card[2].active.sum())} -> {int(s2.active.sum())}; xyz / scaling max |card - "
          f"CPU| / max |CPU| {diff['gauss.xyz']:.3e} / {diff['gauss.scaling']:.3e}; other "
          f"fields differing: {bad or 'none'}; card {smi}")
    if reps[0] != reps[1] or bad:
        raise RuntimeError(f"densify on the card against the CPU ({label}): {reps} {bad}")
    return train.TrainParams(gauss=g2), m2, s2, rep


def densify_card_vs_cpu(src: str, inputs, smi: str) -> list:
    """densify_and_prune at full width on the trained model (the loop's
    inputs at step 30: statistics of steps 21-30, moments), with the
    world-size prune on, on the card and on CPU copies with the same noise;
    then every gaussian of those inputs split, on both, which overflows the
    pool; the pool doubled, one train step on it through build_train_step,
    and K2, K1, K3 and K4 held against their plain versions at that grown
    pool's shapes. Returns those four kernels-line entries."""
    from gof_tpu_torch import config as config_lib
    from gof_tpu_torch import train
    from gof_tpu_torch.data import scene as scene_lib
    from gof_tpu_torch.model import gaussians as gm

    sc = scene_lib.Scene(src, "", shuffle=False)
    opt = config_lib.OptimizationParams()
    card, cpu = state_copy(*inputs, device="cuda"), state_copy(*inputs)
    gs = cpu[2]
    cap = gs.active.shape[0]
    d = torch.clamp_min(gs.denom, 1e-12)
    q = torch.tensor([0.5, 0.9, 0.99, 1.0])
    grads = (gs.grad_accum / d)[gs.active & (gs.denom > 0)]
    gabs = (gs.grad_abs_accum / d)[gs.active & (gs.denom > 0)]
    print(f"card against CPU: the densify inputs of step {DENSIFY_AT[-1]}, active "
          f"{int(gs.active.sum())} of {cap}, statistics on {int((gs.denom > 0).sum())}; "
          f"mean |grad| quantiles 0.5/0.9/0.99/1 {torch.quantile(grads, q).tolist()}, abs "
          f"{torch.quantile(gabs, q).tolist()} (max_grad {DENSIFY_GRAD})")
    gen = torch.Generator().manual_seed(SEED)
    noise = [torch.randn((cap, 3), generator=gen) for _ in range(3)]
    densify_both("the world-size prune on", card, cpu, noise,
                 (DENSIFY_GRAD, 0.05, sc.cameras_extent, opt.percent_dense, True), smi)

    # every active gaussian selected (statistics 1, max_grad 0) and split
    # (percent_dense 0): each split takes two slots, so repeated splitting
    # runs out of slots
    def forced(state):
        tp, st, gs = state
        ones = torch.ones_like(gs.denom)
        return tp, st, gm.GaussianState(gs.active, gs.filter_3d, gs.max_radii2d, ones, ones, ones)

    consts = (0.0, 0.05, sc.cameras_extent, 0.0, False)
    noise = [torch.randn((cap, 3), generator=gen) for _ in range(3)]
    tp, st, gs, rep = densify_both("every gaussian split", forced(card), forced(cpu), noise,
                                   consts, smi)
    for _ in range(5):
        if bool(rep.pool_overflow):
            break
        noise = [torch.randn((cap, 3), device="cuda") for _ in range(3)]
        g2, gs, st, rep = gm.densify_and_prune(tp.gauss, forced((tp, st, gs))[2], st, noise,
                                               *consts)
        tp = train.TrainParams(gauss=g2)
        print(f"  split every gaussian again: active {int(gs.active.sum())} of {cap}, report "
              f"{[int(x) for x in rep]}")
    if not bool(rep.pool_overflow):
        raise RuntimeError("splitting every gaussian never overflowed the pool")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tp, gs, st = train.grow_capacity(tp, gs, st, cap, 2 * cap)
    torch.cuda.synchronize()
    grow_ms = (time.perf_counter() - t0) * 1e3
    cam_meta = sc.all_cameras_meta(sc.train_cameras, device="cuda")
    gs.filter_3d = gm.compute_3d_filter(tp.gauss.xyz, gs.active, *cam_meta)
    if tp.gauss.xyz.shape[0] != 2 * cap or st.mu.xyz.shape[0] != 2 * cap:
        raise RuntimeError("grow_capacity did not double the pool")
    camera, gt = sc.camera(sc.train_cameras[0], device="cuda")
    gt = torch.as_tensor(gt, device="cuda")
    model_cfg = config_lib.ModelParams(sh_degree=3, kernel_size=0.1)
    tx = train.make_optimizer(opt, sc.cameras_extent)
    step = train.build_train_step(opt, model_cfg, config_lib.PipelineParams(), tx)
    counters = train_counters()
    for k in counters:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tp, st, gs, m = step(tp, st, gs, gt, DENSIFY_ITERS + 1, camera, torch.zeros(3, device="cuda"))
    loss = float(m["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = {k.name: k.launches for k in counters}
    print(f"  grew the pool {cap} -> {2 * cap} in {grow_ms:.3f} ms; one step on it: "
          f"{step_ms:.3f} ms (host clock, first at this capacity), loss {loss:.6f}, active "
          f"{int(gs.active.sum())}, launches {launches}; card {smi}")
    if not np.isfinite(loss) or min(launches.values()) < 1:
        raise RuntimeError(f"the step on the grown pool: loss {loss}, launches {launches}")
    bg = torch.zeros(3, device="cuda")
    print(f"  at the grown pool, {int(gs.active.sum())} active of {2 * cap}:")
    _, (tp, st, gs) = profile_steps(step, (tp, st, gs, gt, DENSIFY_ITERS + 1, camera, bg))
    busy = state_copy(*inputs, device="cuda")
    print(f"  at step {DENSIFY_AT[-1]}'s state, {int(busy[2].active.sum())} active of {cap}:")
    profile_steps(step, (*busy, gt, DENSIFY_AT[-1], camera, bg))
    # the step's instance: statistics and regularizers on (build_train_step's
    # defaults); the kernels' inputs are one more step's, cut at its layers
    ins, _, _ = step_inputs(tp.gauss, gs, st, tx, gt, camera, opt, model_cfg, True, True,
                            DENSIFY_ITERS + 2)
    if ins["P"] != 2 * cap:
        raise RuntimeError(f"the grown pool's kernel inputs hold {ins['P']} slots")
    print(f"  kernels against their plain versions on the grown pool ({2 * cap} slots):")
    return train_kernels(ins, "grown pool", True, True, launches)


# ---------------------------------------------------------------------------
# Temporal liveness culling in the late training step
# ---------------------------------------------------------------------------


def live_setup(src: str, state):
    """The liveness phase's fixed inputs: the scene's 8 training views and
    their ground truth on the card, the loop's optimizer settings and a
    copy of `state` (TrainParams, AdamState, GaussianState) there."""
    from gof_tpu_torch import config as config_lib
    from gof_tpu_torch import train
    from gof_tpu_torch.data import scene as scene_lib

    sc = scene_lib.Scene(src, "", shuffle=False)
    views = []
    for info in sc.train_cameras:
        cam, gt = sc.camera(info, device="cuda")
        views.append((cam, torch.as_tensor(gt, device="cuda")))
    opt = config_lib.OptimizationParams(
        densify_until_iter=LIVE_UNTIL, distortion_from_iter=LIVE_UNTIL + 1,
        depth_normal_from_iter=LIVE_UNTIL + 1)
    model_cfg = config_lib.ModelParams(sh_degree=3, kernel_size=0.1)
    tx = train.make_optimizer(opt, sc.cameras_extent)
    return views, opt, model_cfg, tx, state_copy(*state, device="cuda")


def live_render(state, cam, lim=None, with_reg: bool = True):
    """The late step's render (no statistics, SH degree 0, no background)
    of `state`, with an optional liveness limit."""
    from gof_tpu_torch import train
    from gof_tpu_torch.model import gaussians as gm
    from gof_tpu_torch.ops import render as render_lib

    g, s = state[0].gauss, state[2]
    with torch.no_grad():
        return render_lib.render(cam, g.xyz, gm.filtered_scaling(g, s.filter_3d), g.rotation,
                                 gm.filtered_opacity(g, s.filter_3d), train.masked_shs(g, 0, 3),
                                 3, 0.1, torch.zeros(3, device=g.xyz.device),
                                 active_mask=s.active, with_stats=False, with_reg=with_reg,
                                 live_limit_chunks=lim)


def liveness_entry(src: str, out: str, smi: str):
    """(a) The late training step through train.main: LIVE_ITERS steps,
    densification over at LIVE_UNTIL (nothing densifies: densify_from_iter
    keeps its default), culling and the regularizers on from the next step.
    Each step's host ms, key slots, live demand and live fraction, the
    skipped steps; K2 and K1 launched every step, K3 and K4 on every step
    that was not skipped and on no skipped one; finite losses. Returns (the
    launch counts, the last step's state)."""
    from unittest import mock

    from gof_tpu_torch import train

    counters = train_counters()
    steps, last = [], {}
    for k in counters:
        k.launches = 0
    argv = ["-s", src, "-m", out, "--sh_degree", "3", "--kernel_size", "0.1", "--quiet",
            *LIVE_ARGS]
    t0 = time.perf_counter()
    with mock.patch.object(train, "build_train_step",
                           timed_build(train.build_train_step, steps, last)):
        train.main(argv)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in counters}
    print(f"liveness: {LIVE_ITERS} steps through gof_tpu_torch.train.main in {wall:.2f} s "
          f"(densification over at {LIVE_UNTIL}, culling and the regularizers from "
          f"{LIVE_UNTIL + 1}); launches {launches}; card {smi}")
    for r in steps:
        frac = r["live_demand"] / r["slots"] if r["culled"] else 1.0
        print(f"  step {r['iter']}: {r['ms']:.3f} ms, loss {r['loss']:.6f}, key slots "
              f"{r['slots']}, live demand {r['live_demand'] if r['culled'] else '-'} "
              f"({frac:.4f} of the slots){', SKIPPED' if r['skipped'] else ''}, launches "
              f"K2/K1/K3/K4 {r['launches']}")
    culled = [r for r in steps if r["culled"]]
    skipped = [r["iter"] for r in steps if r["skipped"]]
    plain = [r["ms"] for r in steps if not r["culled"] and r["iter"] > 2]
    print(f"  culled steps {len(culled)} (from step {culled[0]['iter'] if culled else '-'}), "
          f"skipped {len(skipped)} {skipped}; median host ms: steps 3-{LIVE_UNTIL} "
          f"(statistics on, no culling) {statistics.median(plain):.3f}, culled steps "
          f"{statistics.median([r['ms'] for r in culled]):.3f}; median live fraction of the "
          f"slots {statistics.median([r['live_demand'] / r['slots'] for r in culled]):.4f}")
    if [r["iter"] for r in culled] != list(range(LIVE_UNTIL + 1, LIVE_ITERS + 1)):
        raise RuntimeError(f"culling ran at {[r['iter'] for r in culled]}")
    if len(steps) != LIVE_ITERS or not all(np.isfinite(r["loss"]) for r in steps):
        raise RuntimeError(f"liveness run losses: {[r['loss'] for r in steps]}")
    bad = [r["iter"] for r in steps
           if min(r["launches"][:2]) < 1
           or (min(r["launches"][2:]) < 1 if not r["skipped"] else max(r["launches"][2:]))]
    if bad:
        raise RuntimeError(f"steps whose launches do not match their skips: {bad}")
    return launches, last["state"]


def liveness_exact(src: str, state, smi: str) -> None:
    """(b) At the trained state, each of the 8 views without a limit and
    with lim = live_counts + LIVE_MARGIN_CHUNKS: the image channels 0-7
    bit-equal; T and channel 8 (the distortion, normalized by T) differing
    only at pixels where both walks' T is below TRANSMITTANCE_EPS (a tile
    whose compacted segment starts at another offset in its 128-key window
    stops at another window boundary after saturation, and T keeps
    shrinking through every row walked; ROADMAP C21). One build_train_step
    from copies of one state, with and without the limit, without and with
    the regularizers: every param, moment, the count and the GaussianState
    bit-equal after it (no gradient the loss takes depends on T when the
    background is black, and K3 writes exact zeros past the cutoff, C20)."""
    from gof_tpu_torch import config as config_lib
    from gof_tpu_torch import train
    from gof_tpu_torch.constants import TRANSMITTANCE_EPS
    from gof_tpu_torch.ops import binning

    views, opt, model_cfg, tx, st0 = live_setup(src, state)
    print(f"liveness, warm limits at the trained state ({int(st0[2].active.sum())} active), "
          f"card {smi}:")
    failures = []
    for i, (cam, gt) in enumerate(views):
        full = live_render(st0, cam)
        lim = full.live_counts + binning.LIVE_MARGIN_CHUNKS
        comp = live_render(st0, cam, lim)
        keys = int(live_render(st0, cam, torch.full_like(lim, binning.LIM_INF)).live_demand)
        diff = [int((full.image[c] != comp.image[c]).sum()) for c in range(9)]
        tf, tc = full.transmittance, comp.transmittance
        moved = (tf != tc) | (full.image[8] != comp.image[8])
        outside = int((moved & ~((tf < TRANSMITTANCE_EPS) & (tc < TRANSMITTANCE_EPS))).sum())
        print(f"  view {i}: keys {keys}, live demand {int(comp.live_demand)} "
              f"({int(comp.live_demand) / max(keys, 1):.4f}), bad tiles {int(comp.live_bad.sum())};"
              f" pixels differing per channel 0-8 {diff}, in T {int((tf != tc).sum())} (max "
              f"|dT| {float((tf - tc).abs().max()):.3e}), of those with either T >= 1e-4: "
              f"{outside}")
        if any(diff[:8]) or outside or bool(comp.live_bad.any()):
            failures.append(f"view {i} render")
        for with_reg in (False, True):
            step = train.build_train_step(opt, model_cfg, config_lib.PipelineParams(), tx,
                                          with_stats=False, with_reg=with_reg)
            bg = torch.zeros(3, device="cuda")
            a = step(*state_copy(*st0, device="cuda"), gt, LIVE_ITERS + 1, cam, bg)[:3]
            b = step(*state_copy(*st0, device="cuda"), gt, LIVE_ITERS + 1, cam, bg, lim=lim)[:3]
            moved = {k: v for k, v in state_diff(b, a).items() if v}
            print(f"    step REG={int(with_reg)} with and without the limit: elements "
                  f"differing per field {moved or 'none'}")
            if moved:
                failures.append(f"view {i} step REG={int(with_reg)}")
    if failures:
        raise RuntimeError(f"warm liveness limits changed the result: {failures}")


def liveness_stale(src: str, state, smi: str, cpu_views=(0, TRAIN_VIEWS - 1)) -> None:
    """(c) A translucent copy of the state (opacity x 0.2) with lim = 1 on
    every tile: live_bad on the card equal to the plain CPU path's on the
    same inputs (views `cpu_views`; the CPU takes seconds a view); on every
    view the step skips, leaving every param, moment, the count and the
    GaussianState bit-equal, and grows the bad tiles' row entries to
    2 * 1 + 4."""
    from gof_tpu_torch import cameras, train
    from gof_tpu_torch import config as config_lib
    from gof_tpu_torch.ops import binning

    views, opt, model_cfg, tx, st0 = live_setup(src, state)
    with torch.no_grad():
        op = torch.sigmoid(st0[0].gauss.opacity) * 0.2
        st0[0].gauss.opacity.copy_(torch.log(op / (1 - op)))
    cpu = state_copy(*st0, device="cpu")
    for i, (cam, gt) in enumerate(views):
        ntiles = int(np.prod(binning.tile_grid(cam.width, cam.height)))
        lim = torch.ones(ntiles, dtype=torch.int32, device="cuda")
        got = live_render(st0, cam, lim)
        if i in cpu_views:
            cam_cpu = cameras.Camera(**{k: (v.cpu() if torch.is_tensor(v) else v)
                                        for k, v in vars(cam).items()})
            bad_cpu = live_render(cpu, cam_cpu, lim.cpu()).live_bad
            want, same = int(bad_cpu.sum()), torch.equal(got.live_bad.cpu(), bad_cpu)
        else:
            want, same = "-", True
        step = train.build_train_step(opt, model_cfg, config_lib.PipelineParams(), tx,
                                      with_stats=False)
        after = step(*state_copy(*st0, device="cuda"), gt, LIVE_ITERS + 1, cam,
                     torch.zeros(3, device="cuda"), lim=lim)
        moved = {k: v for k, v in state_diff(after[:3], cpu).items() if v}
        new = after[3]["live_new_lim"]
        grown = bool((new[got.live_bad] == 6).all())
        kept = bool((new[~got.live_bad] == got.live_counts[~got.live_bad] + 2).all())
        print(f"  stale view {i}: bad tiles card {int(got.live_bad.sum())} of {ntiles}, CPU "
              f"{want}, equal {same}; step skipped "
              f"{bool(after[3]['packed'][9])}, fields moved {moved or 'none'}; new row 6 on the "
              f"bad tiles {grown}, live_counts + 2 elsewhere {kept}; card {smi}")
        if not (same and bool(got.live_bad.any()) and bool(after[3]["packed"][9])
                and not moved and grown and kept):
            raise RuntimeError(f"stale liveness limits on view {i}")


def liveness_kernels(src: str, state, smi: str, launches) -> list:
    """(d) At view 0 of the trained state, with lim = live_counts +
    LIVE_MARGIN_CHUNKS: the whole step without and with the limit on the
    host clock (median of 5, in turns), device busy and idle and each layer
    from torch.profiler and the program's spans; K2 and K1 (on the
    compacted list) and K3 and K4 (on its backward) against their plain
    versions. Returns their kernels-line entries."""
    from gof_tpu_torch import config as config_lib
    from gof_tpu_torch import train
    from gof_tpu_torch.ops import binning

    views, opt, model_cfg, tx, st0 = live_setup(src, state)
    cam, gt = views[0]
    lim = live_render(st0, cam).live_counts + binning.LIVE_MARGIN_CHUNKS
    step_i, bg = LIVE_ITERS + 1, torch.zeros(3, device="cuda")
    print(f"liveness at view 0 ({cam.width}x{cam.height}), card {smi}:")
    g, st, s = state_copy(*st0, device="cuda")
    ins, _, _ = step_inputs(g.gauss, s, st, tx, gt, cam, opt, model_cfg, False, True, step_i,
                            lim=lim)
    print(f"  with the limit: keys {ins['keys']}, blended list {int(ins['b'].num_keys)}, "
          f"compact rows {ins['demand']}")
    step = train.build_train_step(opt, model_cfg, config_lib.PipelineParams(), tx,
                                  with_stats=False)
    ms = {"without": [], "with": []}
    for _ in range(5):
        for key, row in (("without", None), ("with", lim), ("with", lim), ("without", None)):
            st = state_copy(*st0, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(*st, gt, step_i, cam, bg, lim=row)
            torch.cuda.synchronize()
            ms[key].append((time.perf_counter() - t0) * 1e3)
    print(f"  whole step (host clock, synchronised, median of 10 in turns): without the limit "
          f"{statistics.median(ms['without']):.3f} ms, with {statistics.median(ms['with']):.3f} ms")
    for label, row in (("without the limit", None), ("with the limit", lim)):
        print(f"  profile, {label}:")
        profile_steps(lambda *a: step(*a, lim=row), (*state_copy(*st0, device="cuda"), gt,
                                                     step_i, cam, bg))
    print("  kernels on the compacted list against their plain versions:")
    return train_kernels(ins, "liveness", False, True, launches)[1:]  # K1, K3, K4


def oracle_scenes():
    """tests/test_torch_oracle.py's full-cover scene (12 gaussians whose
    rects cover a 96x64 image) and its culled scene (40 gaussians, 64x32),
    as (arrays, camera) pairs on the card."""
    from gof_tpu_torch import cameras, sh

    out = []
    for seed, n, w, h, scale, z_span in ((0, 12, 96, 64, 0.9, (4.0, 7.0)),
                                         (0, 40, 64, 32, 0.15, (3.0, 8.0))):
        rng = np.random.default_rng(seed)
        z = rng.uniform(*z_span, size=n)
        x = rng.uniform(-1.0, 1.0, size=n) * z * 0.2
        y = rng.uniform(-1.0, 1.0, size=n) * z * 0.2
        scales = rng.uniform(0.5, 1.5, size=(n, 3)) * scale
        q = rng.normal(size=(n, 4))
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        opac = rng.uniform(0.3, 0.95, size=n)
        colors = torch.tensor(rng.uniform(0.05, 0.95, size=(n, 3)), dtype=torch.float32)
        arrays = [torch.tensor(a, dtype=torch.float32, device="cuda")
                  for a in (np.stack([x, y, z], -1), scales, q, opac)]
        arrays.append(sh.rgb_to_sh_dc(colors)[:, None, :].cuda())
        out.append((arrays, cameras.look_at_camera(eye=(0, 0, 0), target=(0, 0, 5.0),
                                                   width=w, height=h, device="cuda")))
    return out


def raster_grads(arrays, cam, which: str):
    """Image, T and the gradients of sum(image[:8] * w) with respect to the
    rasterizer's inputs (rgb, opacity, M, u0), from the oracle or a render
    backend: preprocess runs once and its outputs become leaves."""
    import dataclasses
    from unittest import mock

    from gof_tpu_torch.ops import oracle, quadrics
    from gof_tpu_torch.ops import render as render_lib

    m, s, r, o, shs = arrays
    bg = torch.tensor([0.2, 0.3, 0.4], device=m.device)
    pre = quadrics.preprocess(m, s, r, shs, 0, cam, 0.1, opacities=o)
    leaves = {k: getattr(pre, k).detach().clone().requires_grad_(True)
              for k in ("rgb", "v2g_M", "v2g_u0")}
    op = o.clone().requires_grad_(True)
    pre = dataclasses.replace(pre, **leaves)
    with mock.patch.object(quadrics, "preprocess", lambda *a, **k: pre):
        if which == "oracle":
            out = oracle.render_oracle(m, s, r, op, shs, 0, cam, 0.1, bg)
        else:
            out = render_lib.render(cam, m, s, r, op, shs, 0, 0.1, bg, backend=which)
    w = torch.from_numpy(np.random.default_rng(1).normal(0, 0.1, out.image[:8].shape)
                         .astype(np.float32)).to(m.device)
    (out.image[:8] * w).sum().backward()
    return (out.image.detach(), out.transmittance.detach(),
            [leaves["rgb"].grad, op.grad, leaves["v2g_M"].grad, leaves["v2g_u0"].grad])


def backends_on_card(smi: str) -> None:
    """(e) The xla backend and the dense oracle on the card against the CUDA
    path, with the CPU tests' tolerances (tests/test_torch_oracle.py): on
    the full-cover scene the oracle's image and T (rtol 2e-4, atol 2e-5 and
    2e-6) and its autograd gradients into the rasterizer's inputs (1e-4 of
    their largest magnitude); on both scenes the xla backend's image (atol
    1e-5, rtol 1e-4) and gradients (1e-4)."""
    from gof_tpu_torch.ops import rasterize as rz

    failures = []
    for k, (arrays, cam) in enumerate(oracle_scenes()):
        fwd0, bwd0 = rz.FWD.launches, rz.BWD.launches
        img_p, T_p, g_p = raster_grads(arrays, cam, "pallas")
        launched = (rz.FWD.launches - fwd0, rz.BWD.launches - bwd0)
        refs = [("xla", ATOL, RTOL, ATOL)] + ([("oracle", 2e-5, 2e-4, 2e-6)] if k == 0 else [])
        for which, atol, rtol, t_atol in refs:
            img, T, g = raster_grads(arrays, cam, which)
            img_ok = bool(((img_p - img).abs() <= atol + rtol * img.abs()).all())
            t_ok = bool(((T_p - T).abs() <= t_atol + rtol * T.abs()).all())
            gaps = [float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                    for a, b in zip(g_p, g)]
            print(f"  {cam.width}x{cam.height}, {arrays[0].shape[0]} gaussians, CUDA path "
                  f"(K1/K3 launches {launched}) against the {which} on the card: image max "
                  f"|err| {float((img_p - img).abs().max()):.3e} within atol {atol}/rtol "
                  f"{rtol} {img_ok}; T within {t_ok}; gradient gaps (rgb, opacity, M, u0) "
                  f"{[f'{x:.2e}' for x in gaps]} (bound {GRAD_BOUND}); card {smi}")
            if not (img_ok and t_ok and max(gaps) <= GRAD_BOUND and min(launched) >= 1):
                failures.append(f"{which} at {cam.width}x{cam.height}")
    if failures:
        raise RuntimeError(f"the CUDA path against the xla backend or the oracle: {failures}")


def liveness_phase(src: str, root: str, smi: str) -> list:
    """(a)-(e) of the liveness phase. Returns its kernels-line entries."""
    t0 = time.perf_counter()
    launches, state = liveness_entry(src, os.path.join(root, "liveness"), smi)
    marks = [("loop", time.perf_counter())]
    liveness_exact(src, state, smi)
    marks.append(("warm limits", time.perf_counter()))
    liveness_stale(src, state, smi)
    marks.append(("stale limits", time.perf_counter()))
    kernels = liveness_kernels(src, state, smi, launches)
    marks.append(("layers and kernels", time.perf_counter()))
    backends_on_card(smi)
    marks.append(("backends", time.perf_counter()))
    prev, parts = t0, []
    for name, t in marks:
        parts.append(f"{name} {t - prev:.1f}")
        prev = t
    print(f"liveness phase: {prev - t0:.1f} s ({', '.join(parts)} s)")
    return kernels


# ---------------------------------------------------------------------------
# The DTU/TNT chain on the procedural scene
# ---------------------------------------------------------------------------


def dtu_scene(root: str, smi: str) -> tuple:
    """The procedural scene at its defaults (1237x822, 36 train and 6 test
    views, 40k points, gt_mesh.ply) through make_procedural_scene.main.
    Returns (scene dir, the writer's result)."""
    from gof_tpu_torch.scripts import make_procedural_scene as mps

    scene = os.path.join(root, "procedural")
    res = mps.main(["--out", scene])
    print(f"dtu chain: scene {res['train_views']} train + {res['test_views']} test views at "
          f"{res['width']}x{res['height']}, {res['points']} points, gt mesh {res['gt_verts']} vertices, written in "
          f"{res['seconds']:.1f} s (host, {os.cpu_count()} threads); card {smi}")
    return scene, res


def dtu_train_args() -> list:
    return ["--eval", "--use_decoupled_appearance", "--lambda_distortion", "1000",
            "--iterations", str(DTU_ITERS), "--densify_from_iter", str(DTU_DENSIFY_FROM),
            "--densification_interval", str(DTU_DENSIFY_EVERY),
            "--distortion_from_iter", str(DTU_REG_FROM),
            "--depth_normal_from_iter", str(DTU_REG_FROM), "--test_iterations", str(DTU_ITERS),
            "--save_iterations", str(DTU_ITERS), "--checkpoint_iterations",
            *map(str, DTU_HOLD_ITERS), "--quiet"]


def dtu_train(scene: str, model: str, smi: str):
    """train.main with the DTU job's flags (--use_decoupled_appearance
    --lambda_distortion 1000) and --eval for DTU_ITERS steps, densifying at
    the default threshold: each step timed and its K2/K1/K3/K4 launches
    counted; the loss, the appearance state and its checkpoint checked.
    Returns (TrainParams, GaussianState, steps)."""
    from unittest import mock

    from gof_tpu_torch import train
    from gof_tpu_torch.data import scene as scene_lib
    from gof_tpu_torch.model import appearance as app_lib
    from gof_tpu_torch.model import gaussians as gm

    counters = train_counters()
    steps, densify = [], []
    densify_fn = gm.densify_and_prune

    def timed_densify(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = densify_fn(*args)
        torch.cuda.synchronize()
        densify.append((steps[-1]["iter"], (time.perf_counter() - t0) * 1e3,
                        [int(x) for x in res[3]], int(args[1].active.sum()),
                        int(res[1].active.sum()), int(res[1].active.shape[0])))
        return res

    for k in counters:
        k.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(train, "build_train_step", timed_build(train.build_train_step, steps)), \
            mock.patch.object(gm, "densify_and_prune", timed_densify):
        tp, gstate = train.main(["-s", scene, "-m", model, *dtu_train_args()])
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in counters}
    ms = np.array([r["ms"] for r in steps])
    print(f"dtu chain: train.main {len(steps)} steps in {wall:.2f} s ({len(steps) / wall:.2f} "
          f"it/s, scene read, eval and PLY included); launches {launches}; card {smi}")
    for lo, hi in ((1, DTU_DENSIFY_FROM), (DTU_DENSIFY_FROM + 1, DTU_REG_FROM - 1),
                   (DTU_REG_FROM, DTU_ITERS)):
        sel = ms[lo - 1:hi]
        print(f"  steps {lo}-{hi}: median {np.median(sel):.3f} ms (host clock, synchronised; "
              f"{np.min(sel):.3f}-{np.max(sel):.3f}), active {steps[hi - 1]['active']} of "
              f"{steps[hi - 1]['cap']}")
    for it, dms, rep, a0, a1, cap in densify:
        print(f"  densify at step {it}: {dms:.3f} ms; cloned {rep[0]}, split {rep[1]}, pruned "
              f"{rep[2]}, overflow {bool(rep[3])}; active {a0} -> {a1} of {cap}")
    recs = [json.loads(line) for line in open(os.path.join(model, "train_log.jsonl"))]
    evals = [r["eval"] for r in recs if "eval" in r]
    print(f"  loss first {steps[0]['loss']:.6f}, last {steps[-1]['loss']:.6f}; eval {evals}")
    if len(steps) != DTU_ITERS or not all(np.isfinite(r["loss"]) for r in steps):
        raise RuntimeError("the chain's training loss is not finite at every step")
    low = [r["iter"] for r in steps if min(r["launches"]) < 1]
    if low:
        raise RuntimeError(f"steps without a launch of each of K1-K4: {low[:10]}")
    want = list(range(DTU_DENSIFY_FROM + DTU_DENSIFY_EVERY, DTU_ITERS + 1, DTU_DENSIFY_EVERY))
    if [d[0] for d in densify] != want or \
            not any(d[2][0] + d[2][1] for d in densify):
        raise RuntimeError(f"densification at the default threshold: {densify}")
    if len(evals) != 1 or not np.isfinite(evals[0]["psnr"]):
        raise RuntimeError(f"eval records: {evals}")

    # the appearance state: trained embedding rows moved, the others kept
    # their initial bits; every network weight moved
    uids = sorted(c.uid for c in scene_lib.Scene(scene, "", shuffle=False).train_cameras)
    net0, emb0 = app_lib.init_appearance(torch.Generator().manual_seed(0))
    moved = (tp.app_emb.detach().cpu() != emb0).any(dim=1)
    still = [n for (n, p), p0 in zip(tp.app_net.named_parameters(), net0.parameters())
             if torch.equal(p.detach().cpu(), p0)]
    print(f"  appearance: {int(moved.sum())} embedding rows moved (trained uids "
          f"{uids[0]}-{uids[-1]}, {len(uids)}), the other {int((~moved).sum())} bit-equal to "
          f"their init: {bool(moved[uids].all() and moved.sum() == len(uids))}; network "
          f"parameters unchanged: {still or 'none'}")
    if not (moved[uids].all() and int(moved.sum()) == len(uids)) or still:
        raise RuntimeError("the appearance state did not train as expected")
    path = os.path.join(model, f"chkpnt{DTU_ITERS}.pkl")
    tp2, st2, gs2, _ = train.load_checkpoint(path, "cuda")
    leaves, leaves2 = train.app_leaves(tp), train.app_leaves(tp2)
    ok = all(torch.equal(leaves[k].detach(), leaves2[k].detach()) for k in leaves)
    resaved_dir = os.path.join(model, "resaved")
    os.makedirs(resaved_dir)
    tp3, st3, _, _ = train.load_checkpoint(
        train.save_checkpoint(resaved_dir, DTU_ITERS, tp2, st2, gs2), "cuda")
    ok3 = all(torch.equal(leaves2[k].detach(), train.app_leaves(tp3)[k].detach())
              and torch.equal(st2.mu_app[k], st3.mu_app[k])
              and torch.equal(st2.nu_app[k], st3.nu_app[k]) for k in leaves2)
    print(f"  checkpoint {os.path.getsize(path) / 2**20:.1f} MiB: app_net / app_emb equal to "
          f"the trained state bit for bit {ok}; saved again and read back, app_* and their "
          f"moments bit for bit {ok3}")
    if not (ok and ok3):
        raise RuntimeError("the checkpoint does not round-trip the appearance state")
    return tp, gstate, steps


def stage_launches(fn, *args):
    """fn(*args) with K2/K1/K3/K4/K5's launches counted over exactly that
    call; returns (result, {name: launches}, host seconds)."""
    from gof_tpu_torch.ops import integrate

    counters = train_counters() + (integrate.INTEGRATE,)
    for k in counters:
        k.launches = 0
    t0 = time.perf_counter()
    res = fn(*args)
    torch.cuda.synchronize()
    return res, {k.name: k.launches for k in counters}, time.perf_counter() - t0


def dtu_render_metrics(model: str, smi: str) -> dict:
    """render_cli --skip_train, then metrics: a finite PSNR and SSIM, LPIPS
    null with its reason (no VGG weights on the machine)."""
    from gof_tpu_torch import metrics, render_cli

    stats, launches, secs = stage_launches(render_cli.main, ["-m", model, "--skip_train"])
    n = len(stats["test"])
    print(f"dtu chain: render_cli {n} test views in {secs:.2f} s, ms "
          f"{[round(s['ms'], 2) for s in stats['test']]}; launches {launches}; card {smi}")
    if launches["expand"] < n or launches["rasterize_fwd"] < n:
        raise RuntimeError(f"render launches {launches} for {n} views")
    t0 = time.perf_counter()
    metrics.main(["-m", model])
    res = json.load(open(os.path.join(model, "results.json")))[f"ours_{DTU_ITERS}"]
    print(f"dtu chain: metrics in {time.perf_counter() - t0:.2f} s: {res}")
    if not (np.isfinite(res["PSNR"]) and np.isfinite(res["SSIM"]) and res["LPIPS"] is None
            and "LPIPS_reason" in res):
        raise RuntimeError(f"results.json: {res}")
    return res


def dtu_tsdf(model: str, args: list, label: str, smi: str) -> dict:
    """extract_mesh_tsdf.main in one layout: counts, stage seconds and
    launches; a non-empty, finite mesh."""
    from gof_tpu_torch import extract_mesh_tsdf
    from gof_tpu_torch.utils import ply

    res, launches, secs = stage_launches(extract_mesh_tsdf.main, ["-m", model, *args])
    v, f = ply.read_ply(res["path"])
    verts = np.stack([v["x"], v["y"], v["z"]], -1)
    grid = ({k: res[k] for k in ("blocks", "voxels", "samples", "observed")} if "blocks" in res
            else {k: res[k] for k in ("dims", "voxel", "voxels", "observed")})
    print(f"dtu chain: extract_mesh_tsdf {label} ({' '.join(args)}) in {secs:.2f} s: {grid}; "
          f"{res['verts']} vertices, {res['faces']} faces; stage s "
          + ", ".join(f"{k} {s:.3f}" for k, s in res["seconds"].items())
          + f"; launches {launches}; card {smi}")
    if not (res["faces"] > 0 and len(verts) > 0 and np.isfinite(verts).all()
            and f.max() < len(verts)):
        raise RuntimeError(f"TSDF mesh ({label}) empty or not finite")
    if launches["expand"] < res["views"] or launches["rasterize_fwd"] < res["views"]:
        raise RuntimeError(f"TSDF depth renders launched {launches} for {res['views']} views")
    return res


def dtu_geometry(model: str, scene: str, label: str, smi: str, iteration: int = DTU_ITERS,
                 gate: bool = True) -> dict:
    """eval_procedural_geometry.main: each mesh under model/test/ours_N
    against gt_mesh.ply; with `gate`, the TSDF mesh's cropped mean_d2s under
    D2S_GATE."""
    from gof_tpu_torch.scripts import eval_procedural_geometry

    t0 = time.perf_counter()
    res = eval_procedural_geometry.main(["-m", model, "-s", scene, "--iteration",
                                         str(iteration)])
    print(f"dtu chain: eval_procedural_geometry ({label}) in {time.perf_counter() - t0:.2f} s "
          f"(host); card {smi}")
    for name, r in res.items():
        print(f"  {label} {name}: F@{r['tau']} {r['fscore']:.4f}, precision "
              f"{r['precision']:.4f}, recall {r['recall']:.4f}, chamfer {r['chamfer_overall']:.4f}"
              f" (d2s {r['chamfer_mean_d2s']:.4f}, s2d {r['chamfer_mean_s2d']:.4f}); raw F "
              f"{r['raw_fscore']:.4f}, chamfer {r['raw_chamfer_overall']:.4f}; "
              f"{r['cropped_samples']} of {r['pred_samples']} samples in the crop")
    if gate and ("tsdf" not in res or not res["tsdf"]["chamfer_mean_d2s"] < D2S_GATE):
        raise RuntimeError(f"the {label} TSDF mesh's mean_d2s fails the gate {D2S_GATE}")
    return res


def dtu_chain(root: str, smi: str) -> dict:
    """The DTU chain through the CLIs' mains on the card: the scene, train,
    render_cli, metrics, and extract_mesh_tsdf in both layouts (the dense
    mesh moved to a model dir of its own, so each TSDF mesh is scored
    alone). extract_mesh, the geometry scores and the card-against-CPU
    checks follow in main."""
    scene, _ = dtu_scene(root, smi)
    model = os.path.join(root, "dtu_model")
    tp, gstate, _ = dtu_train(scene, model, smi)
    dtu_render_metrics(model, smi)
    dense = dtu_tsdf(model, TSDF_DENSE, "dense", smi)
    dense_model = os.path.join(root, "dtu_dense")
    dense_dir = os.path.join(dense_model, "test", f"ours_{DTU_ITERS}", "tsdf")
    os.makedirs(dense_dir)
    shutil.move(dense["path"], os.path.join(dense_dir, "tsdf.ply"))
    sparse = dtu_tsdf(model, TSDF_SPARSE, "sparse", smi)
    return {"scene": scene, "model": model, "dense_model": dense_model, "tp": tp,
            "gstate": gstate, "dense": dense, "sparse": sparse}


def app_steps(net) -> list:
    """AppearanceNetwork.forward as (name, module or function) steps, in its
    order: conv_in and its ReLU, each block's shuffle, conv and ReLU, the x2
    bilinear, conv_mid and its ReLU, conv_out and the sigmoid."""
    import functools

    import torch.nn.functional as F

    from gof_tpu_torch.model import appearance as app_lib

    steps = [("conv_in", net.conv_in), ("relu conv_in", F.relu)]
    for i, block in enumerate(net.up):
        steps += [(f"up.{i} shuffle", functools.partial(app_lib.pixel_shuffle, factor=2)),
                  (f"up.{i}.conv", block.conv), (f"relu up.{i}", F.relu)]
    return steps + [("bilinear_x2", app_lib.bilinear_x2_align_corners),
                    ("conv_mid", net.conv_mid), ("relu conv_mid", F.relu),
                    ("conv_out", net.conv_out), ("sigmoid", torch.sigmoid)]


def app_pass(net, emb, crop, uid: int, upstream, masks=None):
    """appearance_multiplier step by step (app_steps) on crop's device and
    dtype, then its backward from `upstream`, the gradient into the
    multiplier (a tensor, or a function of the multiplier). With `masks`
    ({ReLU step: bool tensor}) a ReLU passes where its mask is set instead
    of where its input is positive. Returns (multiplier, {leaf: gradient},
    [(step, input, output)] with every output's gradient kept)."""
    from gof_tpu_torch.model import appearance as app_lib

    leaves = {**{f"net.{n}": p for n, p in net.named_parameters()},
              "emb": emb.detach().clone().requires_grad_(True)}
    for p in leaves.values():
        p.grad = None
    x = app_lib.appearance_input(crop, leaves["emb"], uid)[None]
    x.retain_grad()
    acts = []
    for name, fn in app_steps(net):
        y = torch.where(masks[name], x, 0) if masks and name in masks else fn(x)
        y.retain_grad()
        acts.append((name, x, y))
        x = y
    mult = x[0]
    mult.backward(upstream(mult.detach()) if callable(upstream) else upstream)
    return mult.detach(), {k: v.grad.detach() for k, v in leaves.items()}, acts


def rel_err(a, b) -> float:
    """max |a - b| / max |b|, in float64 on the host."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return float((a - b).abs().max() / b.abs().max())


def relu_flips(acts, ref_acts) -> dict:
    """{ReLU step: (entries whose mask differs from the reference's, the
    largest reference |pre-activation| among them in ulps of the layer's
    largest)}."""
    out = {}
    for (name, x, _), (_, xr, _) in zip(acts, ref_acts):
        if name.startswith("relu"):
            xr = xr.detach().cpu().double()
            flip = (x.detach().cpu() > 0) != (xr > 0)
            ulp = 2.0 ** (np.floor(np.log2(float(xr.abs().max()))) - 23)
            out[name] = (int(flip.sum()),
                         float(xr.abs()[flip].max()) / ulp if flip.any() else 0.0)
    return out


def app_reference(net, emb, image, gt, uid: int):
    """The appearance step in float64 on the host, as the gate holds it:
    (crop, upstream, app_pass's result) with upstream appearance_l1's
    gradient into the multiplier, sign(diff) * crop / n."""
    import copy

    from gof_tpu_torch.model import appearance as app_lib

    crop = app_lib.center_crop_32(image.detach().cpu().double())
    gt_crop = app_lib.center_crop_32(torch.as_tensor(gt).cpu().double())
    up = {}

    def upstream(mult):
        up["g"] = (torch.sign(mult * crop - gt_crop) * crop / mult.numel()).detach()
        return up["g"]

    res = app_pass(copy.deepcopy(net).cpu().double(), emb.cpu().double(), crop, uid, upstream)
    return crop, up["g"], res


def app_hold(net, emb, image, gt, uid: int, label: str, smi: str, device: str = "cuda",
             keep_ref: bool = False) -> dict:
    """The appearance step of one (chain state, view) on the card against
    float64 on the host (app_reference): the multiplier, appearance_l1,
    and every leaf's gradient with the reference's gradient into the
    multiplier fed to the card's backward, at the card's own ReLU masks
    and at the reference's; each ReLU's flips; the card's gradients at its
    own signs. appearance_l1's gradient into the multiplier is sign(diff) *
    crop / n, and a ReLU passes where its input is positive: where the
    render times the multiplier meets the gt (C23), or a pre-activation
    lies within an ulp of zero (C31), float32 and float64 can take opposite
    sides, and at a trained state one such pixel or entry moves a weight
    gradient by more than the gate's bound. Prints one line; returns the
    readings (with keep_ref, also the reference as "ref")."""
    from gof_tpu_torch.model import appearance as app_lib

    ref = app_reference(net, emb, image, gt, uid)
    crop64, up64, (m_ref, g_ref, acts64) = ref
    gt64 = app_lib.center_crop_32(torch.as_tensor(gt).cpu().double())
    crop, up, gt_crop = (x.float().to(device) for x in (crop64, up64, gt64))
    m, g, acts = app_pass(net, emb, crop, uid, up)
    masks = {n: (x.detach() > 0).to(device) for n, x, _ in acts64 if n.startswith("relu")}
    g_masks = app_pass(net, emb, crop, uid, up, masks=masks)[1]
    own = app_pass(net, emb, crop, uid,
                   lambda mult: torch.sign(mult * crop - gt_crop) * crop / mult.numel())[1]
    diff, diff64 = (mm.cpu().double() * crop64 - gt64 for mm in (m, m_ref))
    l1, l1_ref = float(diff.abs().mean()), float(diff64.abs().mean())
    r = {"merr": float((m.cpu().double() - m_ref).abs().max()), "lerr": abs(l1 - l1_ref) / l1_ref,
         "grad": {k: rel_err(g[k], g_ref[k]) for k in g_ref},
         "masks": {k: rel_err(g_masks[k], g_ref[k]) for k in g_ref},
         "own": {k: rel_err(own[k], g_ref[k]) for k in g_ref},
         "signs": int(((m * crop - gt_crop).cpu() > 0).ne(diff64 > 0).sum()),
         "flips": relu_flips(acts, acts64),
         "emb_rows": (g["emb"].abs().sum(1) > 0).nonzero().flatten().tolist()}
    w, wm, wo = (max(r[k], key=r[k].get) for k in ("grad", "masks", "own"))
    print(f"dtu chain, appearance step on the card against float64 ({label}, uid {uid}): "
          f"multiplier max |err| {r['merr']:.3e} (bound 1e-5), appearance_l1 rel err "
          f"{r['lerr']:.3e} (bound 1e-5); gradients at the reference's signs, worst of "
          f"{len(r['grad'])} leaves at the card's own ReLU masks {w} {r['grad'][w]:.3e}, at the "
          f"reference's masks {wm} {r['masks'][wm]:.3e}; at the card's own signs {wo} "
          f"{r['own'][wo]:.3e} ({r['signs']} pixels whose sign differs); ReLU flips "
          + ", ".join(f"{n} {c} ({u:.1f} ulps)" for n, (c, u) in r["flips"].items())
          + f"; card {smi}")
    if keep_ref:
        r["ref"] = ref
    return r


def app_trace(net, emb, ref, uid: int, label: str, smi: str, device: str = "cuda") -> dict:
    """C31's trace of the card's appearance step against float64 (ref:
    app_reference's result), printed: along the chain, each step's output
    and the gradient into it; each ReLU's mask flips on the card and on the
    host in float32; op by op at the reference's inputs and upstream
    gradients rounded to float32, each op's forward, input gradient and
    parameter gradients on the card and on the host in float32. Returns the
    host's float32 pass's gradients."""
    import copy

    from gof_tpu_torch.model import appearance as app_lib

    crop, upstream, (_, _, acts64) = ref
    grads, passes = {}, {}
    for where, dev in (("card", device), ("cpu f32", "cpu")):
        _, grads[where], passes[where] = app_pass(copy.deepcopy(net).to(dev), emb.to(dev),
                                                  crop.float().to(dev), uid,
                                                  upstream.float().to(dev))
    card = passes["card"]
    print(f"  C31 trace ({label}), along the chain, card against float64 (output / gradient "
          "into it, max |err| / max |ref|): " + "; ".join(
              f"{n} {rel_err(y, yr):.2e} / {rel_err(y.grad, yr.grad):.2e}"
              for (n, _, y), (_, _, yr) in zip(card, acts64)))
    flips = {w: relu_flips(p, acts64) for w, p in passes.items()}
    print(f"  C31 trace ({label}), ReLU mask flips against float64 (entries, largest "
          "|pre-activation| in ulps of the layer's max), card / CPU f32: " + "; ".join(
              f"{n} {flips['card'][n][0]} ({flips['card'][n][1]:.1f}) / "
              f"{flips['cpu f32'][n][0]} ({flips['cpu f32'][n][1]:.1f})" for n in flips["card"]))
    nets = {"card": copy.deepcopy(net).to(device), "cpu f32": copy.deepcopy(net).cpu(),
            "f64": copy.deepcopy(net).cpu().double()}
    steps = {w: app_steps(m) for w, m in nets.items()}
    dev = {"card": (device, torch.float32), "cpu f32": ("cpu", torch.float32),
           "f64": ("cpu", torch.float64)}
    parts = []
    # the input: the crop's x32 downsample and the embedding row
    got = {}
    for w, (d, dt) in dev.items():
        e = emb.detach().float().to(d, dt).clone().requires_grad_(True)
        x0 = app_lib.appearance_input(crop.float().to(d, dt), e, uid)
        x0.backward(acts64[0][1].grad[0].float().to(d, dt))
        got[w] = (x0.detach(), e.grad[uid])
    parts.append("input " + " ".join(
        f"{k} {rel_err(got['card'][j], got['f64'][j]):.2e}/"
        f"{rel_err(got['cpu f32'][j], got['f64'][j]):.2e}" for j, k in enumerate(("fwd", "emb"))))
    for i, (name, x64, y64) in enumerate(acts64):
        got = {}
        for w, (d, dt) in dev.items():
            fn = steps[w][i][1]
            params = list(fn.parameters()) if isinstance(fn, torch.nn.Module) else []
            for p in params:
                p.grad = None
            x = x64.detach().float().to(d, dt).requires_grad_(True)
            y = fn(x)
            y.backward(y64.grad.float().to(d, dt))
            got[w] = [y.detach(), x.grad] + [p.grad for p in params]
        errs = [f"{rel_err(c, r):.2e}/{rel_err(h, r):.2e}"
                for c, h, r in zip(got["card"], got["cpu f32"], got["f64"])]
        parts.append(f"{name} " + " ".join(
            f"{k} {e}" for k, e in zip(("fwd", "grad", "weight", "bias"), errs)))
    print(f"  C31 trace ({label}), op by op at the reference's inputs rounded to f32, max |err| / "
          f"max |ref| card/CPU f32 against float64: " + "; ".join(parts) + f"; card {smi}")
    return grads["cpu f32"]


def dtu_card_vs_cpu(chain: dict, smi: str) -> None:
    """The chain's two new device paths held against the port's own CPU
    path on the same inputs: the appearance step at full width (1237x822,
    crop 1216x800) with the weights of each chain state of DTU_HOLD_ITERS on
    three views, against the CPU in float64 (app_hold; at step 1000's first
    view also C31's trace, app_trace, and the CPU in float32 and the card
    through cuDNN, which the package turns off, printed beside it, with the
    kernels of each card path and its time), and fuse_blocks /
    fuse_depth_maps (with discover_blocks) on three of the chain's depth
    maps."""
    from torch.profiler import ProfilerActivity, profile

    from gof_tpu_torch import config as config_lib
    from gof_tpu_torch import extract_mesh_tsdf, train
    from gof_tpu_torch.data import scene as scene_lib
    from gof_tpu_torch.mesh import tsdf as tsdf_lib
    from gof_tpu_torch.model import appearance as app_lib
    from gof_tpu_torch.render_cli import render_eval
    from gof_tpu_torch.utils import losses

    cfg, _, _ = config_lib.load_cfg(chain["model"])
    sc = scene_lib.Scene(cfg.source_path, "", eval_split=cfg.eval, shuffle=False)
    tp, gstate = chain["tp"], chain["gstate"]
    bg = torch.zeros(3, device="cuda")
    infos = sc.train_cameras[::12][:3]
    cams = [sc.camera(i, device="cuda") for i in infos]
    outs = [render_eval(tp.gauss, gstate, c, cfg, bg).image for c, _ in cams]

    # the appearance step at each chain state of DTU_HOLD_ITERS and each of
    # the three views, held against float64 at the reference's signs (C23)
    # and ReLU masks (C31; app_hold)
    holds = {}
    for it in DTU_HOLD_ITERS:
        stp, sgs = (tp, gstate) if it == DTU_ITERS else train.load_checkpoint(
            os.path.join(chain["model"], f"chkpnt{it}.pkl"), "cuda")[::2]
        for vi, (c, g) in enumerate(cams):
            image = (outs[vi] if it == DTU_ITERS else render_eval(stp.gauss, sgs, c, cfg, bg)
                     .image)[:3].detach()
            holds[(it, vi)] = app_hold(stp.app_net, stp.app_emb.detach(), image, g, c.uid,
                                       f"step {it}, view {vi}", smi,
                                       keep_ref=(it, vi) == (DTU_ITERS, 0))
        del stp, sgs
    (cam, gt), image, emb = cams[0], outs[0][:3].detach(), tp.app_emb.detach()
    first = holds[(DTU_ITERS, 0)]
    crop64, up64, (_, g_ref, _) = first["ref"]
    g_cpu = app_trace(tp.app_net, emb, first["ref"], cam.uid, f"step {DTU_ITERS}, view 0", smi)

    def cudnn(where):
        """cuDNN on for the card_cudnn pass (forward and backward), TF32 off."""
        return (torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                           allow_tf32=False)
                if where == "card_cudnn" else contextlib.nullcontext())

    with cudnn("card_cudnn"):
        g_dnn = app_pass(tp.app_net, emb, crop64.float().cuda(), cam.uid, up64.float().cuda())[1]
    derr = {k: rel_err(g_dnn[k], g_ref[k]) for k in g_ref}
    cerr = {k: rel_err(g_cpu[k], g_ref[k]) for k in g_ref}
    print(f"  per leaf at step {DTU_ITERS}, view 0 (card at the reference's signs and ReLU masks, "
          "at its own masks, at its own signs, CPU float32, card through cuDNN): " + ", ".join(
              f"{k} {first['masks'][k]:.2e} {first['grad'][k]:.2e} {first['own'][k]:.2e} "
              f"{cerr[k]:.2e} {derr[k]:.2e}" for k in g_ref))

    # the appearance forward + backward (appearance_l1, as the step runs it)
    # and SSIM's through the port's convolutions and through cuDNN: CUDA-event
    # time, and the kernels the appearance pass launches
    net = tp.app_net
    crop_gt = app_lib.center_crop_32(torch.as_tensor(gt, device="cuda"))

    def l1_pass():
        for p in net.parameters():
            p.grad = None
        crop = app_lib.center_crop_32(image)
        mult = app_lib.appearance_multiplier(crop, net, emb.clone().requires_grad_(True),
                                             cam.uid)
        torch.mean(torch.abs(mult * crop - crop_gt)).backward()

    def ssim_pass():
        (1.0 - losses.ssim(image.clone().requires_grad_(True), gt_card)).backward()

    gt_card = torch.as_tensor(gt, device="cuda")
    for where, errs in (("card", first["masks"]), ("card_cudnn", derr)):
        with cudnn(where):
            ms, ssim_ms = cuda_ms(l1_pass, 10, 2), cuda_ms(ssim_pass, 10, 2)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                l1_pass()
                torch.cuda.synchronize()
        dev = sorted((ev for ev in prof.key_averages()
                      if ev.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda ev: ev.self_device_time_total, reverse=True)
        leaf = max(errs, key=errs.get)
        print(f"  appearance forward + backward, {where} (the port's path: {where == 'card'}): "
              f"{ms:.3f} ms (CUDA events, median of 10; SSIM's forward + backward "
              f"{ssim_ms:.3f} ms); worst gradient against float64 "
              f"{leaf} {errs[leaf]:.3e}; busiest kernels: " + "; ".join(
                  f"{ev.key[:60]} {ev.self_device_time_total / 1e3:.3f} ms" for ev in dev[:5]))

    def worst(key):
        return max(((pair, leaf, err) for pair, r in holds.items()
                    for leaf, err in r[key].items()), key=lambda x: x[2])

    at_ref, at_own = worst("masks"), worst("grad")
    flips = [f for r in holds.values() for f in r["flips"].values()]
    far = max(u for _, u in flips)
    merr = max(r["merr"] for r in holds.values())
    lerr = max(r["lerr"] for r in holds.values())
    print(f"dtu chain, appearance step held at {len(holds)} (chain step, view) pairs "
          f"{sorted(holds)}: worst gradient at the reference's signs and ReLU masks "
          f"{at_ref[0]} {at_ref[1]} {at_ref[2]:.3e} (bound 1e-4), at the card's own masks "
          f"{at_own[0]} {at_own[1]} {at_own[2]:.3e}; {sum(n for n, _ in flips)} ReLU entries "
          f"flipped in all, the farthest {far:.2f} ulps of its layer's max (bound 64); "
          f"multiplier worst {merr:.3e}, appearance_l1 worst {lerr:.3e} (bounds 1e-5); card {smi}")
    if merr > 1e-5 or lerr > 1e-5 or at_ref[2] > 1e-4 or far > 64:
        raise RuntimeError("the appearance network on the card disagrees with the CPU")
    bad_rows = {pair: r["emb_rows"] for pair, r in holds.items()
                if r["emb_rows"] != [cams[pair[1]][0].uid]}
    if bad_rows:
        raise RuntimeError(f"embedding gradient rows {bad_rows}, not the views' uids")
    del holds, first

    # the fusion on three depth maps, with the chain's sparse and dense settings
    depths = [extract_mesh_tsdf.masked_depth(o[6], o[7], i.alpha) for o, i in zip(outs, infos)]
    colors = [o[:3] for o in outs]
    cpu_cams = [sc.camera(i, device="cpu")[0] for i in infos]
    card_cams = [c for c, _ in cams]

    def held(label, card, cpu):
        (t_g, w_g), (t_c, w_c) = [tuple(x.cpu() for x in pair) for pair in (card, cpu)]
        differ = int((w_g != w_c).sum())
        same = (w_g == w_c) & (w_g > 0)
        both_obs = (w_g > 0) & (w_c > 0)
        err = float((t_g[same] - t_c[same]).abs().max()) if same.any() else 0.0
        err_obs = float((t_g[both_obs] - t_c[both_obs]).abs().max()) if both_obs.any() else 0.0
        print(f"  {label}: {w_g.numel()} samples, {int((w_g > 0).sum())} observed; weight differs "
              f"at {differ} ({differ / w_g.numel():.2e}, bound 1e-4); tsdf max |err| {err:.3e} "
              f"where the weights agree (bound 1e-5), {err_obs:.3e} where both > 0")
        if differ > 1e-4 * w_g.numel() or err > 1e-5:
            raise RuntimeError(f"{label} on the card disagrees with the CPU")

    blocks = {}
    for where, cs in (("card", card_cams), ("cpu", cpu_cams)):
        blocks[where] = tsdf_lib.discover_blocks([d.to(cs[0].world_view.device) for d in depths],
                                                 cs, SPARSE_VOXEL, 16, SPARSE_TRUNC, DEPTH_MIN,
                                                 DEPTH_MAX)
    same_blocks = torch.equal(blocks["card"].cpu(), blocks["cpu"])
    print(f"dtu chain, card against CPU: discover_blocks on views "
          f"{[i.uid for i in infos]}: {len(blocks['card'])} / {len(blocks['cpu'])} blocks, equal "
          f"{same_blocks}; card {smi}")
    if not same_blocks:
        raise RuntimeError("discover_blocks on the card disagrees with the CPU")
    fused = {}
    for where, cs in (("card", card_cams), ("cpu", cpu_cams)):
        t0 = time.perf_counter()
        d = cs[0].world_view.device
        t, w, _ = tsdf_lib.fuse_blocks([x.to(d) for x in depths], [x.to(d) for x in colors],
                                       cs, blocks[where], SPARSE_VOXEL, 16, SPARSE_TRUNC,
                                       DEPTH_MIN, DEPTH_MAX)
        torch.cuda.synchronize()
        fused[where] = ((t, w), time.perf_counter() - t0)
    print(f"  fuse_blocks: card {fused['card'][1]:.3f} s, CPU {fused['cpu'][1]:.3f} s (host clock)")
    held("fuse_blocks", fused["card"][0], fused["cpu"][0])
    lo, dvox, dims = extract_mesh_tsdf.dense_grid(tp.gauss, gstate, 0.002, DENSE_CHECK_DIM)
    dense = {}
    for where, cs in (("card", card_cams), ("cpu", cpu_cams)):
        t0 = time.perf_counter()
        r = tsdf_lib.fuse_depth_maps([x.to(cs[0].world_view.device) for x in depths], cs, lo,
                                     dvox, dims, DENSE_TRUNC, DEPTH_MIN, DEPTH_MAX)
        torch.cuda.synchronize()
        dense[where] = (r, time.perf_counter() - t0)
    print(f"  fuse_depth_maps on a {dims} grid (voxel {dvox:.4f}): card {dense['card'][1]:.3f} s, "
          f"CPU {dense['cpu'][1]:.3f} s (host clock)")
    held("fuse_depth_maps", dense["card"][0], dense["cpu"][0])


# ---------------------------------------------------------------------------
# Mesh extraction
# ---------------------------------------------------------------------------


def load_model(model: str, device: str):
    """A model directory's gaussians, training cameras and camera meta on
    `device`, as extract_mesh.main loads them."""
    from gof_tpu_torch import config as config_lib
    from gof_tpu_torch.data import scene as scene_lib

    cfg, _, _ = config_lib.load_cfg(model)
    pc = os.path.join(model, "point_cloud")
    it = max(int(d.split("_")[1]) for d in os.listdir(pc))
    sc = scene_lib.Scene(cfg.source_path, "", shuffle=False)
    g, s = scene_lib.load_gaussians_ply(
        os.path.join(pc, f"iteration_{it}", "point_cloud.ply"), cfg.sh_degree, device=device)
    cams = [sc.camera(c, device=device)[0] for c in sc.train_cameras]
    return cfg, g, s, cams, sc.all_cameras_meta(sc.train_cameras, device=device)


def image_margin(points: np.ndarray, cams) -> np.ndarray:
    """Per point, the least distance in pixels to the border of any view's
    image (negative outside an image or behind a camera)."""
    from gof_tpu_torch.transforms import ndc_to_pixel, project_points

    p = torch.from_numpy(np.asarray(points, np.float32)).to(cams[0].world_view.device)
    out = torch.full((p.shape[0],), float("inf"), device=p.device)
    for c in cams:
        ndc = project_points(p, c.full_proj)
        px, py = ndc_to_pixel(ndc[:, 0], c.width), ndc_to_pixel(ndc[:, 1], c.height)
        m = torch.minimum(torch.minimum(px, c.width - px), torch.minimum(py, c.height - py))
        z = p @ c.world_view[2, :3] + c.world_view[2, 3]
        out = torch.minimum(out, torch.where(z > 1e-4, m, torch.full_like(m, -1.0)))
    return out.cpu().numpy()


def mesh_entry(model: str, device: str = "cuda"):
    """The mesh path through its entry point, extract_mesh.main, with K5's,
    K2's and K1's launch counts over exactly that run; then the mesh and
    the field at its vertices are checked. Returns (result, launches), or
    (result, None) when the field crosses 0.5 nowhere."""
    from gof_tpu_torch import extract_mesh
    from gof_tpu_torch.mesh import extract
    from gof_tpu_torch.ops import class_gather, integrate, rasterize
    from gof_tpu_torch.utils import ply

    counters = (integrate.INTEGRATE, class_gather.EXPAND, rasterize.FWD)
    for k in counters:
        k.launches = 0
    argv = ["-m", model, "--texture_mesh"] + (["--cpu"] if device == "cpu" else [])
    t0 = time.perf_counter()
    res = extract_mesh.main(argv)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in counters}
    print(f"mesh: extract_mesh.main in {wall:.2f} s (model and scene load included); "
          f"launches {launches}")
    print(f"  tetra points {res['tetra_points']}, tets {res['tets']}, crossing edges "
          f"{res['crossing_edges']}, faces {res['faces']}, vertices {res['vertices']}")
    print("  stage s: " + ", ".join(f"{k} {v:.3f}" for k, v in res["seconds"].items()))
    if res["crossing_edges"] == 0:
        return res, None

    cfg, g, s, cams, _ = load_model(model, device)
    verts, faces = ply.read_ply(res["path"])
    v = np.stack([verts["x"], verts["y"], verts["z"]], -1)
    finite = bool(np.isfinite(v).all())
    dev_a = np.abs(extract.FieldEvaluator(g, s, cams, cfg.sh_degree, cfg.kernel_size).alpha(v)
                   - 0.5)
    # A point outside any training view's image has T = 1 there, so the field
    # jumps to 1 at every view's image border: bisection converges onto that
    # wall, where the field takes no value near 0.5. gof_tpu's bound is held
    # at the vertices at least one pixel inside every view.
    interior = image_margin(v, cams) >= 1.0
    q90_all = float(np.quantile(dev_a, 0.9))
    q90 = float(np.quantile(dev_a[interior], 0.9)) if interior.any() else 1.0
    print(f"  mesh check: {len(faces)} faces, {len(v)} vertices, all finite {finite}; field at "
          f"the vertices, 0.9-quantile of |alpha - 0.5|: {q90_all:.4f} at all, {q90:.4f} "
          f"(bound 0.15) at the {int(interior.sum())} vertices >= 1 px inside every view "
          f"(median {float(np.median(dev_a[interior])) if interior.any() else 1.0:.4f})")
    if not (len(faces) > 0 and finite and interior.sum() >= 100 and q90 < 0.15):
        raise RuntimeError("extracted mesh fails its checks")
    if device == "cuda":
        need = {"integrate": len(cams) * (1 + 8), "expand": len(cams), "rasterize_fwd": len(cams)}
        low = {k: (launches[k], n) for k, n in need.items() if launches[k] < n}
        if low:
            raise RuntimeError(f"kernels launched fewer times than the mesh path needs: {low}")
    return res, launches


def check_integrate(model: str, launches, name: str, camera=None) -> dict:
    """K5 against its plain version at full size: one view of the model
    (`camera`, by default training view 0) and all of its tetra points; the
    `kernels` entry is `name`."""
    from gof_tpu_torch.mesh import extract
    from gof_tpu_torch.ops import integrate as ti

    cfg, g, s, cams, meta = load_model(model, "cuda")
    pts, _ = extract.get_tetra_points(g, s, meta)
    ev = extract.FieldEvaluator(g, s, cams, cfg.sh_degree, cfg.kernel_size)
    p = torch.from_numpy(pts).cuda()
    payload, b, pb = ev.view_inputs(p, cams[0] if camera is None else camera)
    n = p.shape[0]
    got = ti.integrate_transmittance(payload, b, pb, n)
    again = ti.integrate_transmittance(payload, b, pb, n)
    want = ti.integrate_transmittance_reference(payload, b, pb, n)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    identical = int((got == want).sum())
    same = torch.equal(got, again)
    binned = torch.zeros(n + 1, dtype=torch.bool, device="cuda")
    binned[pb.point_of_slot.long()] = True
    unproj = ~binned[:n]
    unproj_ok = bool((got[unproj] == 1).all())
    # the pairs the data needs: each real point with each row of its tile
    # (padding slots, which fill each tile's last block, are not counted)
    seg_rows = (b.bounds[pb.block_tile.long() + 1] - b.bounds[pb.block_tile.long()]).long()
    real = (pb.point_of_slot < n).reshape(pb.n_blocks, ti.PBLOCK).sum(1)
    pairs = int((seg_rows * real).sum())
    print(f"{name}: {n} tetra points of view 0, payload {tuple(payload.shape)}, "
          f"{pb.n_blocks} point blocks ({int(real.sum())} real slots of "
          f"{pb.n_blocks * ti.PBLOCK}), {pairs} (point, gaussian row) pairs "
          f"({int((seg_rows * ti.PBLOCK).sum())} over all slots): max |err| "
          f"{err:.3e} (bound 1e-6), {identical}/{n} points bit-identical; bit-identical across "
          f"launches {same}; {int(unproj.sum())} unprojected points exactly 1: {unproj_ok}; "
          f"min T {float(got.min()):.4f}")
    if err > 1e-6 or not same or not unproj_ok:
        raise RuntimeError("integrate kernel disagrees with its plain version")
    ms = cuda_ms(lambda: ti.integrate_transmittance(payload, b, pb, n), 10)
    plain_ms = cuda_ms(lambda: ti.integrate_transmittance_reference(payload, b, pb, n), 3)
    print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    moved = (payload.numel() + 3 * pb.rx.numel() + pb.point_of_slot.numel() + b.bounds.numel()
             + n)
    return bound({"name": name, "route": "cuda",
                  "source": "gof_tpu_torch/csrc/integrate.cu",
                  "replaces": "gof_tpu/ops/integrate.py:113", "launches": launches["integrate"],
                  "max_abs_err": err, "ms": ms, "plain_ms": plain_ms},
                 4 * moved, pairs * INTEGRATE_OPS)


def check_small_mesh(device: str = "cuda", steps: int = 4) -> None:
    """The mesh of test_mesh_from_known_gaussians' scene (8 gaussians, 6
    views at 64x64) on `device` against the plain CPU path, both fed the
    same tetra points: the same crossing edges and faces, and >= 99% of the
    vertices within one final bisection interval, once no tetra point's
    field lies within 1e-4 of 0.5 on either path."""
    from types import SimpleNamespace
    from unittest import mock

    from gof_tpu_torch import cameras
    from gof_tpu_torch.mesh import extract, tetmesh
    from gof_tpu_torch.model import gaussians as gm
    from gof_tpu_torch.utils import ply

    rng = np.random.default_rng(0)
    n = 8
    means = rng.normal(size=(n, 3)).astype(np.float32) * 0.4
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    z = np.zeros((n,), np.float32)
    params = SimpleNamespace(xyz=means, features_dc=np.zeros((n, 1, 3), np.float32),
                             features_rest=np.zeros((n, 0, 3), np.float32),
                             scaling=np.log(np.full((n, 3), 0.25, np.float32)),
                             rotation=q.astype(np.float32),
                             opacity=np.full((n,), np.log(0.95 / 0.05), np.float32))
    state = SimpleNamespace(active=np.ones((n,), bool), filter_3d=z + 1e-4, max_radii2d=z,
                            grad_accum=z, grad_abs_accum=z, denom=z)
    eyes = [(3.0 * np.sin(a), 1.0, 3.0 * np.cos(a))
            for a in np.linspace(0, 2 * np.pi, 6, endpoint=False)]
    runs = {}
    root = tempfile.mkdtemp(prefix="gof_small_mesh_")
    try:
        for d in ("cpu", device):
            g, s = gm.from_numpy(params, state, d)
            cams = [cameras.look_at_camera(eye=e, target=(0, 0, 0), width=64, height=64,
                                           uid=i, device=d) for i, e in enumerate(eyes)]
            meta = (torch.stack([c.world_view for c in cams]),
                    torch.stack([c.focal_x for c in cams]), torch.stack([c.focal_y for c in cams]),
                    torch.full((6,), 64.0, device=d), torch.full((6,), 64.0, device=d))
            if d == "cpu":
                pts, pscale = extract.get_tetra_points(g, s, meta)
            alpha = extract.FieldEvaluator(g, s, cams, 0, 0.1).alpha(pts)
            with mock.patch.object(extract, "get_tetra_points", lambda *a, **k: (pts, pscale)):
                res = extract.extract_level_set_mesh(g, s, cams, meta, os.path.join(root, d),
                                                     sh_degree=0, kernel_size=0.1,
                                                     n_binary_steps=steps, quiet=True)
            verts, faces = ply.read_ply(res["path"])
            v = np.stack([verts["x"], verts["y"], verts["z"]], -1)
            q90 = float(np.quantile(np.abs(extract.FieldEvaluator(g, s, cams, 0, 0.1).alpha(v)
                                           - 0.5), 0.9))
            runs[d] = (alpha, v, faces, q90)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    (a_cpu, v_cpu, f_cpu, _), (a_dev, v_dev, f_dev, q90) = runs["cpu"], runs[device]
    margin = float(min(np.abs(a_cpu - 0.5).min(), np.abs(a_dev - 0.5).min()))
    mt = tetmesh.marching_tetrahedra(pts, extract.delaunay(pts), a_cpu - 0.5, pscale)
    interval = float(np.linalg.norm(mt["edge_points"][:, 0] - mt["edge_points"][:, 1],
                                    axis=-1).min()) / 2**steps
    same_faces = ({tuple(f) for f in f_cpu.tolist()} == {tuple(f) for f in f_dev.tolist()}
                  and len(f_cpu) == len(f_dev))
    frac = (float(np.mean(np.abs(v_cpu - v_dev).max(axis=-1) <= interval))
            if v_cpu.shape == v_dev.shape else 0.0)
    print(f"small mesh, {device} vs plain CPU path: {len(pts)} tetra points, min |alpha - 0.5| "
          f"{margin:.3e}, field max |diff| {float(np.abs(a_cpu - a_dev).max()):.3e}; faces "
          f"{len(f_dev)} vs {len(f_cpu)}, same face set {same_faces}; {frac:.4f} of vertices "
          f"within one final interval ({interval:.3e}); field at the {device} vertices: "
          f"0.9-quantile of |alpha - 0.5| {q90:.4f} (bound 0.15)")
    if not (margin > 1e-4 and same_faces and frac >= 0.99 and len(f_cpu) > 0 and q90 < 0.15):
        raise RuntimeError("CUDA mesh disagrees with the plain CPU path")


# ---------------------------------------------------------------------------
# The gather/scatter probes (K6-K13)
# ---------------------------------------------------------------------------

PROBE_REPLACES = {  # the Pallas kernel bodies
    "take_gather": "scripts/pallas_gather_probe.py:38",
    "vidx_gather": "scripts/pallas_gather_probe.py:63",
    "onehot_gather": "scripts/pallas_gather_probe.py:88",
    "scat": "scripts/pallas_gather_probe.py:120",
    "scatmxu": "scripts/pallas_gather_probe.py:152",
    "int8_gather": "scripts/mxu_gather_probe.py:32",
    "rld": "scripts/mxu_gather_probe.py:69",
    "paged_gather": "scripts/mxu_gather_probe.py:126",
}


def probe_phase() -> list:
    """K6-K13 through the probes' entry points at the scripts' shapes: each
    kernel launched (its counter over the two runs), bit-equal to its plain
    version (and to torch.index_select where that computes the same
    function), K9/K10 within rtol 1e-5 / atol 1e-5 x max |plain| of theirs
    and of index_add_ on the card; then K10 bit-equal to its plain version
    on CPU copies and across launches (check_scatmxu_cases), K11/K13 on
    extra cases (check_int8_cases), K8/K9 on skewed indices
    (check_onehot_cases)."""
    from gof_tpu_torch.ops import gather_probes as gp
    from gof_tpu_torch.scripts import mxu_gather_probe, pallas_gather_probe

    for k in gp.COUNTERS:
        k.launches = 0
    t0 = time.perf_counter()
    res = dict(pallas_gather_probe.main([])["kernels"])
    mxu = mxu_gather_probe.main([])
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in gp.COUNTERS}
    res.update(mxu["kernels"])
    print(f"probes: both entry points in {time.perf_counter() - t0:.1f} s (inputs drawn on the "
          f"host included); launches {launches}")
    bad = [n for n, c in launches.items() if c == 0]
    for name, r in res.items():
        if name in ("scat", "scatmxu"):
            ok = r["within_tol"] and r["library_within_tol"] and r.get("deterministic", True)
        else:
            ok = r["exact"] and r.get("library_exact", True) and r.get("spot_exact", True)
        if not ok:
            bad.append(name)
    if bad or not mxu["sort_ordered"]:
        raise RuntimeError(f"probe kernels failed their checks or never launched: {bad}")
    check_scatmxu_cases()
    check_int8_cases()
    check_onehot_cases()
    check_gather_cases()
    check_rld_cases()
    out = []
    for name, r in res.items():
        src = "reduce.cu" if name == "scatmxu" else "gather_probes.cu"
        e = {"name": name, "route": "cuda", "source": f"gof_tpu_torch/csrc/{src}",
             "replaces": PROBE_REPLACES[name], "launches": launches[name],
             "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
             "library": r["library"]}
        if "product_bound_ms" in r:
            e["product_bound_ms"] = r["product_bound_ms"]
        out.append(e)
    return out


def check_scatmxu_cases() -> None:
    """K10 at the script's shapes (PAGE 16384, W 32, 524,288 rows) on the
    script's ids, one id owning 5000+ rows, every row on one id and every
    row on the sentinel: bit-equal to its plain version on CPU copies (both
    fold each id's rows in ascending input row from +0.0) and across two
    launches."""
    from gof_tpu_torch.ops import gather_probes as gp
    from gof_tpu_torch.scripts import pallas_gather_probe

    page = 16384
    _, idx, rows_np = pallas_gather_probe.inputs(page, 2048, 256)
    rows = torch.from_numpy(rows_np)
    skew = idx.copy()
    skew.reshape(-1)[np.random.default_rng(SEED).permutation(idx.size)[:6000]] = 777
    results = []
    for label, ids in (("the script's ids", idx), ("one id owning 5000+ rows", skew),
                       ("every row on one id", np.full_like(idx, 4242)),
                       ("every row on the sentinel", np.full_like(idx, page))):
        i = torch.from_numpy(ids)
        got = gp.scatmxu(i.cuda(), rows.cuda(), page)
        again = gp.scatmxu(i.cuda(), rows.cuda(), page)
        want = gp.scatmxu_reference(i, rows, page)
        results.append((label, torch.equal(got.cpu(), want), torch.equal(got, again)))
    print(f"scatmxu (K10) at the script's shapes (equal to the plain version on CPU copies, "
          f"bit-identical across launches): {results}")
    if not all(r[1] and r[2] for r in results):
        raise RuntimeError("K10 disagrees with its plain version")


def check_int8_cases() -> None:
    """K11 and K13 at the scripts' widths (CH 1024, WG 2048, C8 128, 8
    pages) on the cases the probes do not draw: every chunk on one page,
    fewer chunks (3) than the product's persistent blocks, and pages and
    indices outside the table; each bit-equal to its plain version and, on
    in-range indices, to index_select."""
    from gof_tpu_torch.ops import gather_probes as gp

    rng = np.random.default_rng(SEED)
    ch, wg, c8, npages = 1024, 2048, 128, 8

    def T(x):
        return torch.from_numpy(x).cuda()

    tbl = T(rng.integers(-128, 128, (wg, c8)).astype(np.int8))
    big = T(rng.integers(-128, 128, (npages * wg, c8)).astype(np.int8))
    results = []
    for label, nch, pages in (("every chunk on page 5", 512, np.full(512, 5, np.int32)),
                              ("3 chunks", 3, np.array([6, 0, 6], np.int32)),
                              ("pages outside the table", 64,
                               rng.integers(-2, npages + 2, 64).astype(np.int32))):
        idx = np.stack([rng.integers(p * wg, (p + 1) * wg, ch) for p in pages])[:, None]
        idx = idx.astype(np.int32)
        idx[0, 0, :4] = (-1, -2**31, 2**31 - 1, npages * wg)
        pg, ix = T(pages), T(idx)
        got = gp.paged_gather(pg, ix, big, wg)
        ok = torch.equal(got, gp.paged_gather_reference(pg, ix, big, wg))
        local = T(idx % wg)
        got8 = gp.int8_gather(local, tbl)
        ok8 = torch.equal(got8, gp.int8_gather_reference(local, tbl))
        lib8 = torch.equal(got8, torch.index_select(tbl, 0, local.reshape(-1)).to(torch.int32))
        inside = (pages >= 0) & (pages < npages)
        rows = torch.from_numpy(np.repeat(inside, ch)).cuda()
        flat = ix.reshape(-1).clamp(0, npages * wg - 1)
        lib = torch.equal(got[rows][4:], torch.index_select(big, 0, flat)[rows][4:].to(torch.int32))
        results.append((label, ok, ok8, lib8, lib))
    print("int8 one-hot products on extra cases (K13 exact, K11 exact, K11 = index_select, "
          f"K13 = index_select on its pages): {results}")
    if not all(all(r[1:]) for r in results):
        raise RuntimeError("K11/K13 disagree with their plain versions on the extra cases")


def check_onehot_cases() -> None:
    """K8 and K9 at the script's shapes (PAGE 16384, W 32, 524,288 rows; the
    script's table and rows) on index distributions the probe does not
    draw: sorted, every row on one index, consecutive rows on distinct
    k-steps, every index outside [-PAGE, PAGE), and PAGE / 16 rows each on a
    k-step of its own (each 64 sorted rows hit 64 k-steps, K8's slowest
    tiles). K8 bit-equal to its plain version and to index_select of the
    bf16-rounded table; K9 within rtol 1e-5 / atol 1e-5 x max |plain| of its
    plain version and of index_add_, and with every row on one index, on
    integer rows in [-8, 8] (each f32 add exact in any order), equal to the
    float64 sum. Prints each case's K8 and K9 times (CUDA events)."""
    from gof_tpu_torch.ops import gather_probes as gp
    from gof_tpu_torch.scripts import pallas_gather_probe as pgp
    from gof_tpu_torch.utils.timing import time_ms

    page, n = 16384, 524288
    table_np, _, rows_np = pgp.inputs(page, 2048, 256)
    table, rows = torch.from_numpy(table_np).cuda(), torch.from_numpy(rows_np).cuda()
    tbl_bf = table.bfloat16().float()
    rng = np.random.default_rng(SEED)
    r, nk = np.arange(n), page // 16
    cases = {
        "sorted": np.sort(rng.integers(0, page, n)),
        "every row on one index": np.full(n, page // 3),
        "consecutive rows on distinct k-steps": 16 * (r % nk) + (r // nk + 5 * r) % 16,
        "every index outside the table": rng.choice(
            [-2**31, 2**31 - 1, -page - 1, -2 * page, page, page + 7], n),
        "PAGE / 16 rows, 64 k-steps per sorted tile": 16 * rng.permutation(nk)
        + rng.integers(0, 16, nk)}
    dev = torch.device("cuda")
    results, ok = [], True
    for label, ix in cases.items():
        idx = torch.from_numpy(ix.astype(np.int32).reshape(1, 1, -1)).cuda()
        flat = idx.reshape(-1)
        inside = label != "every index outside the table"
        got = gp.onehot_gather(idx, table)
        lib = torch.index_select(tbl_bf, 0, flat) if inside else torch.zeros_like(got)
        k8 = (torch.equal(got, gp.onehot_gather_reference(idx, table)), torch.equal(got, lib))
        ms8 = time_ms(lambda: gp.onehot_gather(idx, table), [()], dev, 10)
        one = label == "every row on one index"
        rws = (torch.from_numpy(rng.integers(-8, 9, rows.shape).astype(np.float32)).cuda() if one
               else rows[:flat.numel()])
        g9 = gp.scat(idx, rws, page)
        want = gp.scat_reference(idx, rws, page)
        lib9 = (torch.zeros_like(want).index_add_(0, flat, rws) if inside
                else torch.zeros_like(want))
        k9 = [pgp.within(g9, want), pgp.within(g9, lib9)]
        if one:
            k9.append(torch.equal(g9[page // 3].double(), rws.double().sum(0)))
        ms9 = time_ms(lambda: gp.scat(idx, rws, page), [()], dev, 10)
        results.append((label, k8, tuple(k9), round(ms8, 4), round(ms9, 4)))
        ok = ok and all(k8) and all(k9)
    print("one-hot gather (K8: exact, = index_select of the bf16 table) and scat (K9: within tol "
          "of plain, of index_add_[, = float64 sum]) on skewed indices, with K8 / K9 ms: "
          f"{results}")
    if not ok:
        raise RuntimeError("K8/K9 disagree with their plain versions on skewed indices")


def check_gather_cases() -> None:
    """K6 and K7 (one kernel) at the script's shapes (PAGE 16384, W 32,
    524,288 rows; its table and indices) where the probe does not take them:
    W = 30 (4-byte pieces), a table view one float past an aligned buffer
    (4-byte pieces), every index on one row, every index on -PAGE-1, -PAGE,
    -1, PAGE, INT32_MIN and INT32_MAX in turn, and 2^31 + 65,536 output
    elements (8 GiB: offsets past 2^31). Each bit-equal to its plain version
    on the card; prints each case's K6 and K7 times (CUDA events)."""
    from gof_tpu_torch.ops import gather_probes as gp
    from gof_tpu_torch.scripts import pallas_gather_probe as pgp
    from gof_tpu_torch.utils.timing import time_ms

    page, chunk, nchunk = 16384, 2048, 256
    table_np, idx_np, _ = pgp.inputs(page, chunk, nchunk)
    table, idx = torch.from_numpy(table_np).cuda(), torch.from_numpy(idx_np).cuda()
    view = torch.zeros(table.numel() + 1, device="cuda")[1:].view(table.shape)
    view.copy_(table)
    edges = torch.tensor([-page - 1, -page, -1, page, -2**31, 2**31 - 1], dtype=torch.int32)
    big_n = (2**31 + 2**16) // table.shape[1]
    cases = {
        "W = 30": (idx, table[:, :30].contiguous()),
        "table one float past an aligned buffer": (idx, view),
        "every index on one row": (torch.full_like(idx, page // 3), table),
        "edge indices": (edges.repeat(idx.numel() // 6 + 1)[:idx.numel()].view(idx.shape).cuda(),
                         table),
        "2^31 + 65,536 output elements": (
            torch.from_numpy(np.random.default_rng(SEED).integers(-page - 8, page + 8, big_n)
                             .astype(np.int32)).cuda().view(-1, 1, chunk), table)}
    dev = torch.device("cuda")
    results, ok = [], True
    for label, (i, t) in cases.items():
        row = [label]
        for fn, plain in ((gp.take_gather, gp.take_gather_reference),
                          (gp.vidx_gather, gp.vidx_gather_reference)):
            got = fn(i, t)
            same = torch.equal(got, plain(i, t))
            del got
            big = label.startswith("2^31")
            row += [same, round(time_ms(lambda: fn(i, t), [()], dev, 3 if big else 10), 4)]
            ok = ok and same
            torch.cuda.empty_cache()
        results.append(tuple(row))
    print("row gathers (K6: exact, ms; K7: exact, ms) at other widths, views and indices: "
          f"{results}")
    if not ok:
        raise RuntimeError("K6/K7 disagree with their plain versions on the extra cases")


def check_rld_cases() -> None:
    """K12 at the script's shapes (512 chunks of 1024 rows, WG 2048, CV 8)
    on mxu_gather_probe.rld_edge_offsets' cases, where the script's draws
    do not reach: every offset 0 (every k on the last run), one chunk with
    all 2048 offsets inside its 1024 k (dense, with repeats: each row
    searches ~1000 offsets), bases that put k across 2^30 and, on offsets
    over the whole int32 range, across the int32 wrap, a chunk whose first
    offset lies past its first rows, and WG = 65,536 (more than a block's
    shared memory holds); values over the whole int32 range. Each
    bit-equal to its plain version on the card; prints each case's ms."""
    from gof_tpu_torch.ops import gather_probes as gp
    from gof_tpu_torch.scripts import mxu_gather_probe as mgp
    from gof_tpu_torch.utils.timing import time_ms

    a = mgp.parse([])
    rng = np.random.default_rng(SEED)
    i32 = np.iinfo(np.int32)
    dev = torch.device("cuda")
    results, ok = [], True
    for kind in mgp.RLD_EDGE_CASES:
        off, base = mgp.rld_edge_offsets(kind, a.nch, a.ch, a.wg, rng)
        val = rng.integers(i32.min, i32.max, (off.shape[-1], mgp.CV), endpoint=True)
        args = [torch.from_numpy(x.astype(np.int32)).cuda() for x in (off, val, base)]
        same = torch.equal(gp.rld(*args, a.ch), gp.rld_reference(*args, a.ch))
        results.append((kind, same, round(time_ms(lambda: gp.rld(*args, a.ch), [()], dev, 10), 4)))
        ok = ok and same
    print(f"run-length decode (K12: exact, ms) on edge offsets and bases: {results}")
    if not ok:
        raise RuntimeError("K12 disagrees with its plain version on the edge cases")


# ---------------------------------------------------------------------------
# The parallel phase: data parallelism, replicas, NCCL, the sharded field
# ---------------------------------------------------------------------------

DP_REPS = 10  # timed dp steps per bench phase, after 2 warm-up
# the second view of the two-view dp steps: bench's look-at camera moved
# along bench's orbit, its own seeded ground truth
DP_EYE2 = (0.3, 0.1, 0.0)


def dp_cases(phase: str, params, state, gts):
    """Bench's point as parallel.steps cases for one bench phase: the
    two-copies case (both ranks on bench's view) and the two-views case
    (bench's view, then DP_EYE2's); the model and views are shared objects,
    so they are pickled once."""
    from gof_tpu_torch import cameras
    from gof_tpu_torch import config as config_lib
    from gof_tpu_torch.parallel import steps

    with_stats, with_reg, step_i = BENCH_PHASES[phase]
    cams = [cameras.look_at_camera(eye=e, target=(0, 0, 5.0), width=WIDTH, height=HEIGHT,
                                   uid=i).numpy() for i, e in enumerate([(0, 0, 0), DP_EYE2])]
    model_cfg = config_lib.ModelParams(sh_degree=3, kernel_size=0.1)
    return [steps.train_case(params, state, gts, cams, ids,
                             config_lib.OptimizationParams(), model_cfg,
                             config_lib.PipelineParams(), 5.0, step_i, with_stats, with_reg)
            for ids in ([[0, 0]], [[0, 1]])]


BENCH_PHASES = {"densify": (True, False, 5000), "regularize": (False, True, 20000)}


def dp_rank(group, cases, reps: int):
    """One rank of the dp checks: each case's step from its own state
    (parallel.steps.run, launches counted), then `reps` host-clocked steps
    of every two-views case after 2 warm-up, the device idle share over 3
    more (torch.profiler), and the host clock of the step's two collectives
    alone on buffers of their sizes (median of `reps`)."""
    from gof_tpu_torch import train
    from gof_tpu_torch.parallel import steps

    out = {"runs": [steps.run(c, group.device, group) for c in cases], "ms": [], "idle": [],
           "collective_ms": []}
    for c in cases[1::2]:
        b = steps.build(c, group.device, group)
        v = int(c["ids"][0][group.rank])
        args = [b.tp, b.opt_state, b.gstate, b.gts[v], c["step"], b.cams[v], b.bg]
        ms = []
        for i in range(2 + reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            args[0], args[1], args[2], _ = b.step(*args)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out["ms"].append(ms[2:])
        idle, _ = profile_steps(b.step, tuple(args))
        out["idle"].append(idle)
        P = b.tp.gauss.xyz.shape[0]
        n_sum = sum(getattr(b.tp.gauss, f).numel() for f in train.GAUSS_FIELDS) + 6 + 3 * P
        bufs = {"sum": torch.zeros(n_sum, device=group.device),
                "max": torch.zeros(P + 6, dtype=torch.float64, device=group.device)}
        coll = {}
        for op, buf in bufs.items():
            t = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                group.all_reduce(buf, op)
                torch.cuda.synchronize()
                t.append((time.perf_counter() - t0) * 1e3)
            coll[op] = (buf.numel() * buf.element_size(), statistics.median(t))
        out["collective_ms"].append(coll)
    return out


def dp_reference(case, device: str = "cuda"):
    """The two-views dp step computed in one process from the case's state
    on the card: each view's gradients (train.view_grad, as each rank
    computes them), their sum divided by the view count (a device tensor),
    the statistics rows summed and the radii's max over the views, then the
    same Adam step. Returns train.checkpoint_blob."""
    from gof_tpu_torch import train
    from gof_tpu_torch.model import gaussians as gm
    from gof_tpu_torch.parallel import steps

    b = steps.build(case, device)
    tx = train.make_optimizer(case["opt"], case["spatial_lr_scale"])
    gsum = rows = radii = None
    for v in case["ids"][0]:
        vg = train.view_grad(b.tp, b.gstate, b.gts[v], case["step"], b.cams[v], b.bg,
                             case["opt"], case["model_cfg"], case["pipe"].backend,
                             case["with_stats"], case["with_reg"])
        with torch.no_grad():
            grads = [g.clone() for g in vg.grads]
            for f in train.GAUSS_FIELDS:
                getattr(b.tp.gauss, f).grad = None
            vis = vg.out.visibility & b.gstate.active
            zero = torch.zeros((), device=device)
            cg = vg.carrier_grad
            r = torch.stack([torch.where(vis, torch.linalg.norm(cg[:, :2], dim=-1), zero),
                             torch.where(vis, cg[:, 2].abs(), zero), vis.float()])
            rad = torch.where(vis, vg.out.radii, zero)
            gsum = grads if gsum is None else [a + g for a, g in zip(gsum, grads)]
            rows = r if rows is None else rows + r
            radii = rad if radii is None else torch.maximum(radii, rad)
    with torch.no_grad():
        n = torch.tensor(float(len(case["ids"][0])), device=device)
        upd, opt_state = tx.update(gm.GaussianParams(*[g / n for g in gsum]), b.opt_state)
        for f in train.GAUSS_FIELDS:
            getattr(b.tp.gauss, f).add_(getattr(upd, f))
        s = b.gstate
        vis_any = rows[2] > 0
        gstate = gm.GaussianState(
            active=s.active, filter_3d=s.filter_3d,
            max_radii2d=torch.where(vis_any, torch.maximum(s.max_radii2d, radii), s.max_radii2d),
            grad_accum=s.grad_accum + rows[0], grad_abs_accum=s.grad_abs_accum + rows[1],
            denom=s.denom + rows[2])
    return train.checkpoint_blob(b.tp, opt_state, gstate, case["step"])


def dp_compare(label: str, got: dict, want: dict, stats: float) -> None:
    """gof_tpu's dp tolerances (tests/test_sharding.py:88-100): every param
    field within rtol 1e-4 / atol 1e-7, Adam's moments within 1e-4 of
    their largest magnitude, the statistics `stats` x the reference's
    (denom exactly, the gradient sums within rtol 1e-6), the radii equal;
    and whether the params and moments are bit-equal."""
    from gof_tpu_torch import train

    fields = train.GAUSS_FIELDS
    p_ok = all(np.allclose(got["gauss"][f], want["gauss"][f], rtol=1e-4, atol=1e-7)
               for f in fields)
    pdiff = max(float(np.abs(got["gauss"][f] - want["gauss"][f]).max()) for f in fields)
    merr = max(float(np.abs(got["adam"][k] - want["adam"][k]).max()
                     / max(np.abs(want["adam"][k]).max(), 1e-30)) for k in ("mu_flat", "nu_flat"))
    g, w = got["gstate"], want["gstate"]
    denom_ok = np.array_equal(g["denom"], stats * w["denom"])
    s_ok = all(np.allclose(g[k], stats * w[k], rtol=1e-6, atol=0)
               for k in ("grad_accum", "grad_abs_accum"))
    rad_ok = np.array_equal(g["max_radii2d"], w["max_radii2d"])
    bits = (all(np.array_equal(got["gauss"][f], want["gauss"][f]) for f in fields)
            and all(np.array_equal(got["adam"][k], want["adam"][k]) for k in ("mu_flat", "nu_flat")))
    print(f"  {label}: params within rtol 1e-4 / atol 1e-7 {p_ok} (max |d| {pdiff:.3e}), Adam "
          f"moments {merr:.3e} of max (bound 1e-4), statistics {stats:g}x: denom exact "
          f"{denom_ok}, gradient sums within rtol 1e-6 {s_ok}, radii equal {rad_ok}; params and "
          f"moments bit-equal {bits}")
    if not (p_ok and merr <= 1e-4 and denom_ok and s_ok and rad_ok):
        raise RuntimeError(f"{label}: the dp step is outside gof_tpu's dp tolerances")


def dp_phase(smi: str) -> None:
    """(a) two ranks sharing cuda:0 over gloo at bench's point, both bench
    phases: two copies of one view against the single-rank step, two views
    against dp_reference; replicas bit-equal; the dp step's host-clock
    median and views/s beside the single-rank step's, each rank's launches
    and device idle share. (c) a one-rank NCCL group: bit-equal to the
    dp == 1 step."""
    from gof_tpu_torch import train
    from gof_tpu_torch.parallel import sharding, steps

    gts = np.stack([np.random.default_rng(s).uniform(0, 1, (3, HEIGHT, WIDTH))
                    for s in (SEED, SEED + 1)]).astype(np.float32)  # bench's gt first
    params, state = make_model(N_GAUSSIANS, SEED)
    cases = [c for p in BENCH_PHASES for c in dp_cases(p, params, state, gts)]
    t0 = time.perf_counter()
    res = sharding.launch(dp_rank, 2, ["cuda:0", "cuda:0"], (cases, DP_REPS))
    print(f"dp: 2 ranks on cuda:0 over {sharding.backend_for(['cuda:0'] * 2)}, 4 cases and "
          f"{2 * (2 + DP_REPS + 3)} timed steps each, in {time.perf_counter() - t0:.1f} s")
    for i, (phase, kind) in enumerate([(p, k) for p in BENCH_PHASES
                                       for k in ("two copies of one view", "two views")]):
        runs = [r["runs"][i] for r in res]
        same = train.replica_digests(runs[0]["state"]) == train.replica_digests(runs[1]["state"])
        print(f"  {phase} phase, {kind}: loss {runs[0]['metrics']['loss']:.6f}, key slots "
              f"{int(runs[0]['metrics']['num_keys'])}; launches per rank "
              f"{[r['launches'] for r in runs]}; replicas bit-equal {same} ({smi})")
        if not same:
            raise RuntimeError("the dp replicas differ after one step")
        if any(v < 1 for r in runs for v in r["launches"].values()):
            raise RuntimeError("a rank's dp step did not launch K1-K4")
        if kind.startswith("two copies"):
            one = steps.run(train_case_one(cases[i]), "cuda")
            dp_compare(f"{phase}: dp=2 on two copies against the single-rank step",
                       runs[0]["state"], one["state"], 2.0)
        else:
            dp_compare(f"{phase}: dp=2 on two views against one process's mean of their "
                       "gradients", runs[0]["state"], dp_reference(cases[i]), 1.0)
    for j, phase in enumerate(BENCH_PHASES):
        c = train_case_one(cases[2 * j + 1])
        b = steps.build(c, "cuda")
        args = [b.tp, b.opt_state, b.gstate, b.gts[0], c["step"], b.cams[0], b.bg]
        ms = []
        for i in range(2 + DP_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            args[0], args[1], args[2], _ = b.step(*args)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        one_ms = statistics.median(ms[2:])
        dp_ms = [statistics.median(r["ms"][j]) for r in res]
        print(f"  {phase} phase step ms (host clock, synchronised, median of {DP_REPS} after 2 "
              f"warm-up): dp=2 rank 0 / 1 {dp_ms[0]:.3f} / {dp_ms[1]:.3f} ({2e3 / max(dp_ms):.2f} "
              f"views/s), single rank {one_ms:.3f} ({1e3 / one_ms:.2f} views/s); device idle "
              f"share per rank {[r['idle'][j] for r in res]} ({smi})")
        print("    the step's collectives alone (host clock, median of "
              f"{DP_REPS}): " + "; ".join(
                  f"{op} {nb / 2**20:.2f} MiB {ms:.3f} ms" for op, (nb, ms) in
                  res[0]["collective_ms"][j].items()))

    # (c) NCCL: one rank with its own card
    c = train_case_one(cases[0])
    t0 = time.perf_counter()
    ((nccl,),) = sharding.launch(steps.dp_steps, 1, ["cuda:0"], ([c],))
    one = steps.run(c, "cuda")
    same = train.replica_digests(nccl["state"]) == train.replica_digests(one["state"])
    print(f"dp: one rank over {sharding.backend_for(['cuda:0'])} on cuda:0 "
          f"({time.perf_counter() - t0:.1f} s): bit-equal to the dp == 1 step {same}; launches "
          f"{nccl['launches']}")
    if not same:
        raise RuntimeError("the one-rank NCCL dp step differs from the dp == 1 step")


def train_case_one(case: dict) -> dict:
    """The case's first rank's view alone (dp == 1)."""
    return {**case, "ids": case["ids"][:, :1]}


def dp_training(src: str, root: str, smi: str) -> None:
    """(b) train.training(dp=2) with both ranks on cuda:0, over the densify
    phase's 100k-point scene and schedule (densifying at 10, 20 and 30,
    the opacity reset at 35, 40 steps): the ranks' final states bit-equal
    (training compares a sha256 of every field across the ranks and raises
    on a difference), rank 0 alone wrote the log, checkpoints and PLY, and
    the checkpoint resumes in a one-rank run."""
    from gof_tpu_torch import config as config_lib
    from gof_tpu_torch import train

    out = os.path.join(root, "dp_trained")
    o = config_lib.OptimizationParams(
        iterations=DENSIFY_ITERS, densify_from_iter=9, densification_interval=10,
        densify_until_iter=40, densify_grad_threshold=DENSIFY_GRAD, opacity_reset_interval=35,
        distortion_from_iter=15, depth_normal_from_iter=15)
    m = config_lib.ModelParams(source_path=src, model_path=out, sh_degree=3, kernel_size=0.1)
    t0 = time.perf_counter()
    tp, gs = train.training(m, o, config_lib.PipelineParams(), {DENSIFY_ITERS},
                            {DENSIFY_ITERS}, {20, DENSIFY_ITERS}, device="cuda", dp=2,
                            devices=["cuda:0", "cuda:0"])
    wall = time.perf_counter() - t0
    recs = [json.loads(line) for line in open(os.path.join(out, "train_log.jsonl"))]
    iters = [r["iter"] for r in recs]
    files = sorted(os.listdir(out))
    print(f"dp training: train.training(dp=2) on cuda:0 x2, {DENSIFY_ITERS} steps of 2 views, "
          f"densifying at {DENSIFY_AT}, in {wall:.1f} s; active {int(gs.active.sum())} of "
          f"{gs.active.shape[0]}; log records {iters}; files {files} ({smi})")
    if iters != [1, 10, 20, 30, 40, 40] or len(recs) != len(set(map(json.dumps, recs))):
        raise RuntimeError(f"the dp run's log is not one rank's: {iters}")
    ply = os.path.join(out, "point_cloud", f"iteration_{DENSIFY_ITERS}", "point_cloud.ply")
    if not (os.path.exists(ply) and {"chkpnt20.pkl", "chkpnt40.pkl"} <= set(files)):
        raise RuntimeError("the dp run did not write its checkpoints and PLY")
    t0 = time.perf_counter()
    tp2, _ = train.main(["-s", src, "-m", os.path.join(root, "dp_resumed"), "--sh_degree", "3",
                         "--kernel_size", "0.1", "--start_checkpoint",
                         os.path.join(out, "chkpnt40.pkl"), "--iterations", str(DENSIFY_ITERS + 2),
                         "--test_iterations", "0", "--quiet"])
    moved = float((tp2.gauss.xyz - tp.gauss.xyz).detach().abs().max())
    print(f"  chkpnt40 resumed in a one-rank run for 2 steps in {time.perf_counter() - t0:.1f} s: "
          f"max |xyz - dp run's| {moved:.3e}")
    if not (moved > 0 and bool(torch.isfinite(tp2.gauss.xyz).all())):
        raise RuntimeError("the dp checkpoint did not resume")


def sharded_field(model: str, smi: str) -> None:
    """(d) FieldEvaluator(devices=[cuda:0] x 4) against the unsharded one
    at the model's tetra points (gof_tpu's bound rtol 1e-5 / atol 1e-6,
    bit-equality printed), then extract_level_set_mesh sharded and
    unsharded from the mesh path's cells.npy: the same vertices and faces.
    K5's launches per shard."""
    from gof_tpu_torch.mesh import extract
    from gof_tpu_torch.ops import integrate
    from gof_tpu_torch.utils import ply

    cfg, g, s, cams, meta = load_model(model, "cuda")
    pts, _ = extract.get_tetra_points(g, s, meta)
    shards = [torch.device("cuda", 0)] * 4
    t0 = time.perf_counter()
    a1 = extract.FieldEvaluator(g, s, cams, cfg.sh_degree, cfg.kernel_size).alpha(pts)
    t1 = time.perf_counter()
    integrate.INTEGRATE.launches = 0
    a4 = extract.FieldEvaluator(g, s, cams, cfg.sh_degree, cfg.kernel_size,
                                devices=shards).alpha(pts)
    t2 = time.perf_counter()
    per_shard = integrate.INTEGRATE.launches / len(shards)
    ok = bool(np.allclose(a4, a1, rtol=1e-5, atol=1e-6))
    print(f"sharded field: {len(pts)} tetra points, {len(cams)} views: unsharded {t1 - t0:.2f} s, "
          f"4 shards on cuda:0 {t2 - t1:.2f} s (K5 launches per shard {per_shard:g}); max |d| "
          f"{float(np.abs(a4 - a1).max()):.3e}, within rtol 1e-5 / atol 1e-6 {ok}, bit-equal "
          f"{bool(np.array_equal(a4, a1))} ({smi})")
    if not ok or per_shard != len(cams):
        raise RuntimeError("the sharded field disagrees with the unsharded one")
    it = max(int(d.split("_")[1]) for d in os.listdir(os.path.join(model, "point_cloud")))
    cells = os.path.join(model, "test", f"ours_{it}", "fusion", "cells.npy")
    meshes = {}
    for label, shard in (("unsharded", 0), ("4 shards", shards)):
        out = os.path.join(model, "shard_check", label.replace(" ", "_"))
        os.makedirs(out)
        shutil.copy(cells, out)  # Delaunay once, on the mesh path
        t0 = time.perf_counter()
        res = extract.extract_level_set_mesh(g, s, cams, meta, out, cfg.sh_degree,
                                             cfg.kernel_size, quiet=True, shard=shard)
        meshes[label] = ply.read_ply(res["path"])
        print(f"  extract_level_set_mesh {label}: {res['faces']} faces, {res['vertices']} "
              f"vertices in {time.perf_counter() - t0:.2f} s (stages "
              + ", ".join(f"{k} {v:.2f}" for k, v in res["seconds"].items()) + ")")
    (v1, f1), (v4, f4) = meshes["unsharded"], meshes["4 shards"]
    same = all(np.array_equal(v4[k], v1[k]) for k in ("x", "y", "z")) and np.array_equal(f4, f1)
    print(f"  sharded and unsharded meshes: same vertices and faces {same}")
    if not same:
        raise RuntimeError("the sharded mesh differs from the unsharded one")


def dp_lr_scaling(smi: str) -> None:
    """(e) gof_tpu's semantics test (tests/test_sharding.py:120-201) at its
    own size on the card: 128 points, 8 views of 48x48 rendered from a
    target with perturbed colours; dp=2 (two ranks on cuda:0) at lr x1.41
    for 16 steps against dp=1 for 32 steps: both below 0.6 of the starting
    mean L1, and l_dp2 < 1.25 l_dp1."""
    import dataclasses
    from types import SimpleNamespace

    from gof_tpu_torch import cameras
    from gof_tpu_torch import config as config_lib
    from gof_tpu_torch import train
    from gof_tpu_torch.model import gaussians as gm
    from gof_tpu_torch.ops import render as render_lib
    from gof_tpu_torch.parallel import sharding, steps

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(128, 3)).astype(np.float32) * 0.5
    cols = rng.random((128, 3)).astype(np.float32)
    gauss, gstate = gm.init_from_points(pts, cols, 1, 256, device="cuda")
    cams = [cameras.look_at_camera(eye=(3.0 * np.sin(t), 0.8, 3.0 * np.cos(t)), target=(0, 0, 0),
                                   width=48, height=48, uid=i, device="cuda")
            for i, t in enumerate(np.linspace(0, 2 * np.pi, 8, endpoint=False))]
    tgt = dataclasses.replace(gauss, features_dc=gauss.features_dc + 0.6 * torch.from_numpy(
        rng.standard_normal(gauss.features_dc.shape).astype(np.float32)).cuda())

    @torch.no_grad()
    def render_view(g, cam):
        return render_lib.render(cam, g.xyz, gm.filtered_scaling(g, gstate.filter_3d),
                                 g.rotation, gm.filtered_opacity(g, gstate.filter_3d),
                                 gm.get_features(g), 1, 0.1, torch.zeros(3, device="cuda"),
                                 active_mask=gstate.active, with_stats=False,
                                 with_reg=False).image[:3]

    gts = torch.stack([render_view(tgt, c) for c in cams])
    host = lambda x: {f.name: getattr(x, f.name).cpu().numpy()  # noqa: E731
                      for f in dataclasses.fields(x)}
    params, state = SimpleNamespace(**host(gauss)), SimpleNamespace(**host(gstate))

    def loss_of(blob):
        g = train.state_from_blob(blob, "cuda")[0].gauss
        return float(np.mean([float((render_view(g, c) - gts[j]).abs().mean())
                              for j, c in enumerate(cams)]))

    def case(dp, n_steps, lr_mult):
        o = config_lib.OptimizationParams()
        o = dataclasses.replace(
            o, position_lr_init=o.position_lr_init * lr_mult,
            position_lr_final=o.position_lr_final * lr_mult, feature_lr=o.feature_lr * lr_mult,
            scaling_lr=o.scaling_lr * lr_mult, rotation_lr=o.rotation_lr * lr_mult,
            opacity_lr=o.opacity_lr * lr_mult)
        order = np.concatenate([np.random.default_rng(42).permutation(8)
                                for _ in range(n_steps * dp // 8 + 1)])
        return steps.train_case(params, state, gts.cpu().numpy(), [c.numpy() for c in cams],
                                order[:n_steps * dp].reshape(n_steps, dp), o,
                                config_lib.ModelParams(sh_degree=1, kernel_size=0.1),
                                config_lib.PipelineParams(), 1.0, 0, with_reg=False)

    t0 = time.perf_counter()
    l_dp1 = loss_of(steps.run(case(1, 32, 1.0), "cuda")["state"])
    res = sharding.launch(steps.dp_steps, 2, ["cuda:0", "cuda:0"], ([case(2, 16, 1.41)],))
    l_dp2 = loss_of(res[0][0]["state"])
    l0 = float(np.mean([float((render_view(gauss, c) - gts[j]).abs().mean())
                        for j, c in enumerate(cams)]))
    ok = l_dp1 < 0.6 * l0 and l_dp2 < 0.6 * l0 and l_dp2 < 1.25 * l_dp1
    print(f"dp lr scaling ({time.perf_counter() - t0:.1f} s): mean L1 at start {l0:.6f}, dp=1 x32 "
          f"steps {l_dp1:.6f}, dp=2 at lr x1.41 x16 steps {l_dp2:.6f} (gates: both < 0.6 x start, "
          f"dp2 < 1.25 x dp1) {ok} ({smi})")
    if not ok:
        raise RuntimeError("dp=2 at sqrt(2) lr does not track single-camera SGD")


def parallel_phase(src: str, root: str, mesh_model: str, smi: str) -> None:
    """The parallel phase: (a) and (c) dp_phase, (b) dp_training, (d)
    sharded_field, (e) dp_lr_scaling."""
    t0 = time.perf_counter()
    dp_phase(smi)
    dp_training(src, root, smi)
    sharded_field(mesh_model, smi)
    dp_lr_scaling(smi)
    print(f"parallel phase: {time.perf_counter() - t0:.1f} s")


def bench_state():
    """bench.py's bench_config inputs on the card: make_state's model (seed
    1), the look-at camera, a seeded random ground truth."""
    from gof_tpu_torch import bench
    from gof_tpu_torch.model import gaussians as gm

    params, state = make_model(N_GAUSSIANS, SEED)
    g, s = gm.from_numpy(params, state, "cuda")
    cam = bench.headline_camera(WIDTH, HEIGHT, "cuda")
    gt = np.random.default_rng(SEED).uniform(0, 1, (3, HEIGHT, WIDTH)).astype(np.float32)
    return g, s, cam, torch.from_numpy(gt).cuda()


def step_inputs(g, s, st, tx, gt, cam, opt, model_cfg, with_stats, with_reg, step_i, lim=None):
    """One train step cut at its layers (build_train_step's operations, the
    rasterize Function opened up), for the kernels' inputs; the layers'
    times come from the program's own spans (profile_run). With a liveness
    limit `lim` ([NTILES] chunks) the sorted list is compacted
    (binning.compact_live) before the payload gather. Returns (the
    backward kernels' inputs of the step, the optimizer state, the
    GaussianState)."""
    from gof_tpu_torch import train
    from gof_tpu_torch.model import gaussians as gm
    from gof_tpu_torch.ops import binning, quadrics, tiled_ref
    from gof_tpu_torch.ops import rasterize as rz

    sh = model_cfg.sh_degree
    P = g.xyz.shape[0]
    ntx, nty = binning.tile_grid(cam.width, cam.height)
    ntiles = ntx * nty
    bg = torch.zeros(3, device="cuda")
    leaves = [getattr(g, f).requires_grad_(True) for f in train.GAUSS_FIELDS]
    scales_f = gm.filtered_scaling(g, s.filter_3d)
    opac_f = gm.filtered_opacity(g, s.filter_3d)
    shs = train.masked_shs(g, min(step_i // 1000, sh), sh)
    pre = quadrics.preprocess(g.xyz, scales_f, g.rotation, shs, sh, cam,
                              model_cfg.kernel_size, s.active, opacities=opac_f)
    with torch.no_grad():
        rects = binning.gaussian_rects(pre.mean2d, pre.radius, pre.valid, ntx, nty,
                                       radius_xy=pre.radius_xy)
        b = binning.bin_gaussians(pre.depth, rects, ntx, nty, mean2d=pre.mean2d,
                                  radius=pre.radius)
    keys = int(b.num_keys)
    if lim is not None:
        b = binning.compact_live(b, lim, P)[0]
    coef = pre.coef.detach()
    op_eff = opac_f * torch.where(pre.valid, coef, torch.zeros_like(coef))
    with torch.no_grad():
        payload = rz.build_payload16(pre.rgb, op_eff, pre.v2g_M, pre.v2g_u0, b,
                                     conic=pre.conic if with_stats else None,
                                     mean2d=pre.mean2d if with_stats else None)
        meta = rz._meta_vec(cam.focal_x, cam.focal_y, bg, cam.width, cam.height)
        fout = rz.rasterize_fwd(payload, b, meta, ntx, ntiles, with_reg=with_reg)
    tile_out = fout.detach().requires_grad_(True)
    image = tiled_ref.assemble_image(tile_out, ntx, nty, cam.width, cam.height)
    loss = train.train_loss(image[:9], gt, cam, opt, step_i, with_reg)[0]
    loss.backward(inputs=[tile_out])
    gout = tile_out.grad.contiguous()
    last = fout[ntiles - 1]
    demand = int(last[rz.CH_CSTART, 0] + last[rz.CH_LIVEC, 0] * rz.CHUNK_SIZE)
    half = (cam.width / 2.0, cam.height / 2.0)
    rows, gid = rz.bwd_rows(payload, fout, gout, b, meta, ntx, ntiles, *half,
                            with_stats=with_stats, with_reg=with_reg,
                            compact_cap=max(demand, rz.CHUNK_SIZE))
    per_g, per_s = rz.reduce_compact_rows(rows, gid, P)
    dM, du0 = rz.quadric_chain(per_g, pre.v2g_M, pre.v2g_u0)
    torch.autograd.backward([pre.rgb, op_eff, pre.v2g_M, pre.v2g_u0],
                            [per_g[:, 0:3], per_g[:, 3], dM, du0])
    with torch.no_grad():
        radii = torch.where(pre.valid, pre.radius, torch.zeros_like(pre.radius))
        cg = per_s if per_s is not None else torch.zeros((P, 3), device="cuda")
        s = gm.add_densification_stats(s, cg, radii, radii > 0)
        upd, st = tx.update(gm.GaussianParams(*[x.grad for x in leaves]), st)
        for x, f in zip(leaves, train.GAUSS_FIELDS):
            x.add_(getattr(upd, f))
            x.grad = None
    ex = binning.class_expansion(pre.depth.detach(), rects, ntiles, pre.mean2d.detach(),
                                 pre.radius.detach())
    tbl = torch.stack(ex.cols).contiguous()
    gidx = torch.clamp(ex.gidx, 0, P - 1).to(torch.int32).contiguous()
    with torch.no_grad():  # the step's payload with and without the statistics columns
        full = payload if with_stats else rz.build_payload16(
            pre.rgb, op_eff, pre.v2g_M, pre.v2g_u0, b, conic=pre.conic, mean2d=pre.mean2d)
    payloads = {True: full, False: full[:rz.P_COLS].contiguous()}
    ins = dict(payload=payload, payloads=payloads, b=b, meta=meta, ntx=ntx, ntiles=ntiles,
               fout=fout, gout=gout, demand=demand, half=half, P=P, rows=rows, gid=gid,
               expand=(tbl, gidx), keys=keys)
    return ins, st, s


def span_layers(n: int) -> dict:
    """The program's own split of the last n train steps (utils/trace.py's
    spans, recorded while a profiler ran them): span name -> (device ms a
    step, self device ms a step, spans a step); empty without them."""
    from gof_tpu_torch.utils import trace

    sm = trace.summary("step", n)
    if sm["units"] < n or sm["spans"]["step"]["device_ms"] is None:
        return {}
    return {k: (v["device_ms"] / n, v["self_device_ms"] / n, v["count"] / n)
            for k, v in sm["spans"].items()}


def profile_run(run, n: int):
    """torch.profiler over one call of `run`, which takes n steady train
    steps: host wall, device busy time (kernels and copies), idle share,
    busiest device ops. Returns (idle share or None, what run returned)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        print("  profile: no device events recorded; idle share not measured")
        return None, out
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    idle = 1 - busy / wall
    print(f"  profile of {n} steady steps: {wall / n:.3f} ms/step host wall, device busy "
          f"{busy / n:.3f} ms/step, idle share {idle:.3f}, "
          f"{sum(e.count for e in dev) / n:.0f} device ops/step")
    for e in sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
        print(f"    {e.self_device_time_total / 1e3 / n:8.4f} ms/step x{e.count // n:4d}  "
              f"{e.key[:80]}")
    layers = span_layers(n)
    if layers:
        print("  layers (the program's spans; device ms/step [self], spans/step): " + "; ".join(
            f"{k} {d:.3f} [{sf:.3f}] x{c:g}" for k, (d, sf, c) in layers.items()))
    return idle, out


def profile_steps(step, args, n: int = 3):
    """profile_run over n steps of `step` from args (tp, st, s, gt, step_i,
    cam, bg), with their layers from the program's spans. Returns (idle
    share or None, the state after them)."""
    tp, st, s, gt, step_i, cam, bg = args

    def run():
        state = (tp, st, s)
        for _ in range(n):
            state = step(*state, gt, step_i, cam, bg)[:3]
        return state

    return profile_run(run, n)


def check_bwd(ins, payload, with_stats: bool, with_reg: bool):
    """K3 in one (REG, STATS) instance against its plain version at this
    view's shapes: the gaussian-id stream exact, the rows within GRAD_BOUND
    x max |plain| per output group (the 16 gradient columns, the 8
    statistics columns), bit-identical across two launches, and the
    recomputed T equal to the forward's at every pixel. Returns (the
    kernel's row buffer and ids, max |err|, the launch's arguments)."""
    from gof_tpu_torch.ops import rasterize as rz

    args = (payload, ins["fout"], ins["gout"], ins["b"], ins["meta"], ins["ntx"], ins["ntiles"],
            *ins["half"])
    kw = dict(with_stats=with_stats, with_reg=with_reg,
              compact_cap=max(ins["demand"], rz.CHUNK_SIZE))
    miss = torch.zeros(1, dtype=torch.int32, device="cuda")
    got = rz.bwd_rows(*args, **kw, t_mismatch=miss)
    again = rz.bwd_rows(*args, **kw)
    want = rz.bwd_rows_reference(*args, **kw)
    torch.cuda.synchronize()
    gid_exact = torch.equal(got[1], want[1])
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    cols = [("dslot", slice(0, rz.P_COLS))] + ([("stats", slice(rz.P_COLS, None))]
                                               if with_stats else [])
    errs = {n: (float((got[0][:, c] - want[0][:, c]).abs().max()),
                float(want[0][:, c].abs().max())) for n, c in cols}
    ok = (gid_exact and same and int(miss) == 0
          and all(e <= GRAD_BOUND * m for e, m in errs.values()))
    print(f"  rasterize_bwd (REG={int(with_reg)}, STATS={int(with_stats)}): payload "
          f"{tuple(payload.shape)}, compact rows {ins['demand']}: "
          + ", ".join(f"{n} max |err| {e:.3e} (max |plain| {m:.3e})" for n, (e, m) in errs.items())
          + f"; gid stream exact {gid_exact}; bit-identical across launches {same}; pixels whose "
          f"recomputed T differs from the forward's {int(miss)}")
    if not ok:
        raise RuntimeError("rasterize_bwd kernel disagrees with its plain version")
    return got, max(e for e, _ in errs.values()), (args, kw)


def check_backward_kernels(ins, phase: str, with_stats: bool, with_reg: bool, launches) -> list:
    """K3 against its plain version in this phase's instance and in the one
    with the statistics flipped; K4 on the phase's row buffer, also on
    skewed ids, timed beside its column-major entry (which copies the rows
    row-major and must give the same sums) and index_add_."""
    from gof_tpu_torch.ops import rasterize as rz
    from gof_tpu_torch.ops import reduce as red

    (rows, gid), err, (args, kw) = check_bwd(ins, ins["payloads"][with_stats], with_stats,
                                             with_reg)
    check_bwd(ins, ins["payloads"][not with_stats], not with_stats, with_reg)
    ms = cuda_ms(lambda: rz.bwd_rows(*args, **kw), 10)
    plain_ms = cuda_ms(lambda: rz.bwd_rows_reference(*args, **kw), 3)
    print(f"  rasterize_bwd: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    visited = blend_rows(ins["b"].bounds, ins["fout"][:, rz.CH_LIVEC, 0]) * rz.NPIX
    active = active_pairs(args[0], ins["b"], ins["fout"], ins["meta"], ins["ntx"], ins["ntiles"])
    print(f"  rasterize_bwd pairs: {visited} visited, {active} active ({active / visited:.4f})")
    moved = (visited // rz.NPIX * args[0].shape[0] + ins["fout"].numel() + ins["gout"].numel()
             + rows.numel() + gid.numel())
    out = [bound({"name": f"rasterize_bwd ({phase})", "route": "cuda",
                  "source": "gof_tpu_torch/csrc/rasterize_bwd.cu",
                  "replaces": "gof_tpu/ops/rasterize_pallas.py:508",
                  "launches": launches["rasterize_bwd"], "max_abs_err": err, "ms": ms,
                  "plain_ms": plain_ms},
                 4 * moved, bwd_ops(visited, active, with_stats, with_reg))]

    P = ins["P"]
    c = rz.P_COLS + (3 if with_stats else 0)
    err, _ = check_reduce(rows, c, gid, P, "the backward's rows")
    R = gid.shape[0]
    g = torch.Generator().manual_seed(SEED)
    skew = gid.clone()
    skew[torch.randperm(R, generator=g)[:5000].to(skew.device)] = 777
    for label, ids in (("one id owning 5000+ rows", skew),
                       ("every row on one id", torch.full_like(gid, 4242)),
                       ("every row on the sentinel", torch.full_like(gid, P))):
        check_reduce(rows, c, ids, P, label)
    columns = [rows[:, :rz.P_COLS].T.contiguous()] + (
        [rows[:, rz.P_COLS:].T.contiguous()] if with_stats else [])
    cm_equal = torch.equal(red.reduce_row_blocks(columns, gid, P)[:, :c],
                           red.reduce_row_major(rows, gid, P, c))
    print(f"  reduce, column-major entry on the same rows: equal to the row-major entry "
          f"{cm_equal}")
    if not cm_equal:
        raise RuntimeError("reduce's column-major entry disagrees with its row-major entry")
    ms, cm_ms = [], []
    for _ in range(2):  # in turns: the row buffer, the column-major entry
        ms.append(cuda_ms(lambda: rz.reduce_compact_rows(rows, gid, P), 20))
        cm_ms.append(cuda_ms(lambda: red.reduce_row_blocks(columns, gid, P), 20))
    vals = rows[:, :c]
    plain_ms = cuda_ms(lambda: red.reduce_rows_by_gid_reference(vals.T, gid, P), 5)
    print(f"  reduce (count, scan, fill, reduce) on the row buffer: "
          f"{' / '.join(f'{t:.4f}' for t in ms)} ms; on the column-major arrays (the entry "
          f"that copies them row-major): {' / '.join(f'{t:.4f}' for t in cm_ms)} ms; plain "
          f"{plain_ms:.4f} ms")
    acc, g64 = torch.zeros((P + 1, c), device="cuda"), gid.long()
    out.append(bound({"name": f"reduce ({phase})", "route": "cuda",
                      "source": "gof_tpu_torch/csrc/reduce.cu",
                      "replaces": "gof_tpu/ops/reduce.py:53", "launches": launches["reduce"],
                      "max_abs_err": err, "ms": statistics.median(ms), "plain_ms": plain_ms},
                     4 * (R * c + gid.numel() + P * c),
                     library_ms=cuda_ms(lambda: acc.index_add_(0, g64, vals), 20)))
    return out


def check_reduce(rows, c: int, gid, P: int, label: str):
    """K4's row-major entry on the card against its plain version on CPU
    copies of the same inputs (bit for bit: both sum each id's rows in
    ascending row order from +0.0), and against itself across two launches.
    Returns (max |err|, ids with rows)."""
    from gof_tpu_torch.ops import reduce as red

    r1 = red.reduce_row_major(rows, gid, P, c)
    r2 = red.reduce_row_major(rows, gid, P, c)
    want = red.reduce_rows_by_gid_reference(rows[:, :c].T.cpu(), gid.cpu(), P)
    got = r1.cpu()
    equal, same = torch.equal(got, want), torch.equal(r1, r2)
    err = float((got - want).abs().max())
    cnt = torch.bincount(gid.long().clamp(0, P), minlength=P + 1)[:P]
    print(f"  reduce, {label}: rows {tuple(rows.shape)} ({c} columns), P {P}, "
          f"{int((cnt > 0).sum())} ids with rows ({int((cnt > 16).sum())} with more than 16, "
          f"{int(cnt[cnt > 16].sum())} rows; {int((cnt > 128).sum())} with more than 128), the "
          f"longest {int(cnt.max())}: equal to the plain version on CPU copies {equal} (max |err| "
          f"{err:.3e}); bit-identical across launches {same}")
    if not (equal and same):
        raise RuntimeError(f"reduce kernel disagrees with its plain version ({label})")
    return err, int((cnt > 0).sum())


def profile_kernel_calls(ins, probes: bool) -> None:
    """torch.profiler over single calls of K1 (with its wrapper's compact
    layout), K3 and K4 (this phase's inputs),
    K4's column-major entry (which copies the rows row-major)
    and, with `probes`, K8, K9, K10, K11 and K13 (the scripts' shapes): the device
    time of each kernel a call launches, median of 10 calls, each behind a
    device sleep."""
    from torch.profiler import ProfilerActivity, profile

    from gof_tpu_torch.ops import gather_probes as gp
    from gof_tpu_torch.ops import rasterize as rz
    from gof_tpu_torch.ops import reduce as red
    from gof_tpu_torch.scripts import pallas_gather_probe

    rows, gid, P = ins["rows"], ins["gid"], ins["P"]
    with_stats = rows.shape[1] > rz.P_COLS
    columns = [rows[:, :rz.P_COLS].T.contiguous()] + (
        [rows[:, rz.P_COLS:].T.contiguous()] if with_stats else [])
    args = (ins["payload"], ins["fout"], ins["gout"], ins["b"], ins["meta"], ins["ntx"],
            ins["ntiles"], *ins["half"])
    kw = dict(with_stats=with_stats, with_reg=not with_stats,
              compact_cap=max(ins["demand"], rz.CHUNK_SIZE))
    table8, idx10, rows10 = (torch.from_numpy(x).cuda()
                             for x in pallas_gather_probe.inputs(16384, 2048, 256))
    rng = np.random.default_rng(0)
    tbl = torch.from_numpy(rng.integers(-128, 128, (2048, 128)).astype(np.int8)).cuda()
    big = torch.from_numpy(rng.integers(-128, 128, (8 * 2048, 128)).astype(np.int8)).cuda()
    idx = torch.from_numpy(rng.integers(0, 2048, (512, 1, 1024)).astype(np.int32)).cuda()
    pages = torch.from_numpy(rng.integers(0, 8, 512).astype(np.int32)).cuda()
    pidx = (idx + pages[:, None, None] * 2048).contiguous()
    fwd = (ins["payload"], ins["b"], ins["meta"], ins["ntx"], ins["ntiles"])
    calls = (("K1 rasterize_fwd", lambda: rz.rasterize_fwd(*fwd, with_reg=not with_stats)),
             ("K3 rasterize_bwd", lambda: rz.bwd_rows(*args, **kw)),
             ("K4 reduce on the row buffer", lambda: rz.reduce_compact_rows(rows, gid, P)),
             ("K4 reduce, column-major entry", lambda: red.reduce_row_blocks(columns, gid, P)),
             ("K8 onehot_gather", lambda: gp.onehot_gather(idx10, table8)),
             ("K9 scat", lambda: gp.scat(idx10, rows10, 16384)),
             ("K10 scatmxu", lambda: gp.scatmxu(idx10, rows10, 16384)),
             ("K11 int8_gather", lambda: gp.int8_gather(idx, tbl)),
             ("K13 paged_gather", lambda: gp.paged_gather(pages, pidx, big, 2048)))
    for name, fn in calls[:None if probes else 4]:
        fn()
        torch.cuda.synchronize()
        per = {}
        for _ in range(10):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(2_000_000)
                fn()
                torch.cuda.synchronize()
            for e in prof.key_averages():
                if e.self_device_time_total > 0 and "spin_kernel" not in e.key:
                    name_k = e.key.replace("(anonymous namespace)::", "").split("(")[0]
                    per.setdefault(name_k.split("<")[0].split("::")[-1], []).append(
                        e.self_device_time_total / e.count)
        print(f"  profile of one {name} call (device us, median of 10): " + ", ".join(
            f"{k} {statistics.median(v):.1f}" for k, v in per.items()))


def bench_phase(label: str, with_stats: bool, with_reg: bool, step_i: int, launches) -> list:
    """One of bench.py's two phases on the port: step time, layer split,
    idle share, and the kernels against their plain versions."""
    from gof_tpu_torch import config as config_lib
    from gof_tpu_torch import train

    g, s, cam, gt = bench_state()
    bg = torch.zeros(3, device="cuda")
    opt = config_lib.OptimizationParams()
    model_cfg = config_lib.ModelParams(sh_degree=3, kernel_size=0.1)
    tx = train.make_optimizer(opt, 5.0)
    tp = train.TrainParams(gauss=g)
    st = tx.init(tp)
    step = train.build_train_step(opt, model_cfg, config_lib.PipelineParams(), tx,
                                  with_stats=with_stats, with_reg=with_reg)
    print(f"bench phase {label} (with_stats={with_stats}, with_reg={with_reg}, step {step_i}), "
          f"{N_GAUSSIANS} gaussians at {WIDTH}x{HEIGHT}:")
    for _ in range(2):
        tp, st, s, m = step(tp, st, s, gt, step_i, cam, bg)
    torch.cuda.synchronize()
    ms = []
    for _ in range(BENCH_REPS):
        t0 = time.perf_counter()
        tp, st, s, m = step(tp, st, s, gt, step_i, cam, bg)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    loss = float(m["loss"])
    print(f"  step ms (host clock, synchronised, {BENCH_REPS} steps after 2 warm-up): median "
          f"{statistics.median(ms):.3f}, all {[round(x, 3) for x in ms]}; loss {loss:.6f}, "
          f"key slots {int(m['num_keys'])}, compact rows {int(m['compact_demand'])}")
    if not np.isfinite(loss):
        raise RuntimeError("non-finite bench loss")
    ins, st, s = step_inputs(tp.gauss, s, st, tx, gt, cam, opt, model_cfg, with_stats, with_reg,
                             step_i)
    profile_steps(step, (tp, st, s, gt, step_i, cam, bg))
    return ins


def train_kernels(ins, phase: str, with_stats, with_reg, launches) -> list:
    """K2 and K1 in the instance this phase launches (K1 also equal to the
    step's own forward), then K3 and K4 on that forward's output."""
    kernels = check_kernels(ins["expand"], (ins["payload"], ins["b"], ins["meta"], ins["ntx"],
                                            ins["ntiles"]), launches, with_reg, phase,
                            fout=ins["fout"])
    return kernels + check_backward_kernels(ins, phase, with_stats, with_reg, launches)


# the port's bench (gof_tpu_torch.bench) at bench.py's defaults: the points
# whose K1-K4 are held against their plain versions and timed in both phases
BENCH_HELD = ("late", "late3m")
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline",
              *(f"{p}_{k}" for p in ("late", "late3m", "orbit")
                for k in ("iters_per_sec", "keys", "vs_baseline")),
              "orbit_live_frac", "orbit_skip_frac")


def port_bench_phase(smi: str) -> list:
    """gof_tpu_torch.bench.main([]) at bench.py's defaults (100k gaussians at
    1237x822 and 20 reps, late at 1M, late3m at 3M, an 8-camera orbit at
    1M). After each phase of each point (bench's observe hook, after its
    timing): the phase's K1-K4 launches (K2 and K1 at least once per step,
    K3 and K4 once per step not skipped), its mean step ms, device busy
    and idle share over 3 more steps (torch.profiler), the peak memory and,
    at the BENCH_HELD points and on the orbit (camera 3 through its stale
    cache row), K1-K4 held against their plain versions and timed at that
    phase's shapes. The counters are restored after each
    observation, so they count bench's own steps only. Then the JSON line's
    keys and values are checked. Returns the held kernels' entries."""
    from gof_tpu_torch import bench

    t0 = time.perf_counter()
    counters = dict(zip(("expand", "rasterize_fwd", "rasterize_bwd", "reduce"), train_counters()))
    kernels, seen = [], {}
    for c in counters.values():
        c.launches = 0

    def observe(label: str, phase: str, ctx: dict) -> None:
        now = {n: c.launches for n, c in counters.items()}
        got = {n: now[n] - seen.get(n, 0) for n in now}
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps = ctx["steps"]
        skipped = int(ctx["packed"][:, 9].sum()) if "packed" in ctx else 0
        point = label if phase == "orbit" else f"{label} {phase}"
        print(f"bench {point}: {ctx['ms']:.3f} ms/step (bench's mean over async reps), "
              f"{steps} steps ({skipped} skipped), launches {got}, peak memory {peak:.3f} GiB "
              f"({smi})")
        if (got["expand"] < steps or got["rasterize_fwd"] < steps
                or got["rasterize_bwd"] != steps - skipped or got["reduce"] != steps - skipped):
            raise RuntimeError(f"bench {point}: K1-K4 launches {got} for {steps} steps "
                               f"({skipped} skipped)")
        setup = ctx["setup"]

        def hold(tp, st, s, gt, cam, step_i, lim=None):
            ins, _, _ = step_inputs(tp.gauss, s, st, setup.tx, gt, cam, setup.opt,
                                    setup.model_cfg, ctx["with_stats"], ctx["with_reg"], step_i,
                                    lim=lim)
            print(f"  kernels against their plain versions at {point}'s shapes "
                  f"({ins['keys']} keys, blended list {int(ins['b'].num_keys)}, "
                  f"{ins['demand']} compact rows):")
            held = train_kernels(ins, point, ctx["with_stats"], ctx["with_reg"], got)
            held[0]["name"] = f"expand ({point})"
            kernels.extend(held)

        if phase == "orbit":
            # 3 more steps (cameras 0-2) through bench's own epoch loop, then
            # K1-K4 held on camera 3's step through its cache row, which is
            # as stale as the orbit's main path leaves it (n_cams - 1 steps)
            cams, gts, cache = ctx["cams"], ctx["gts"], ctx["cache"]
            k = min(3, len(cams))
            _, (state, step_i, _) = profile_run(
                lambda: bench.orbit_epoch(ctx["step"], ctx["state"], cams[:k], gts[:k],
                                          ctx["bg"], cache[:k], ctx["step_next"]), k)
            i = k % len(cams)
            hold(*state, gts[i], cams[i], step_i, lim=cache[i])
        else:
            profile_steps(ctx["step"], ctx["args"])
            if label in BENCH_HELD:
                tp, st, s, gt, step_i, cam, _ = ctx["args"]
                hold(tp, st, s, gt, cam, step_i)
        for n, c in counters.items():
            c.launches = now[n]
        seen.update(now)
        torch.cuda.empty_cache()

    rec = bench.main([], observe=observe)
    missing = [k for k in BENCH_KEYS if k not in rec]
    rates = [k for k in rec if k.endswith(("iters_per_sec", "vs_baseline")) or k == "value"]
    bad = [k for k in rates if not (np.isfinite(rec[k]) and rec[k] > 0)]
    bad += [k for k in rec if k.endswith("_keys") and not rec[k] > 0]
    if not 0 < rec.get("orbit_live_frac", 0) <= 1 or not 0 <= rec.get("orbit_skip_frac", -1) <= 1:
        bad.append("orbit_live_frac / orbit_skip_frac")
    print(f"port bench: {json.dumps(rec)}; keys missing {missing}, values out of range {bad} "
          f"({smi})")
    if missing or bad or set(rec) != set(BENCH_KEYS):
        raise RuntimeError("the port's bench line lacks bench.py's keys or has bad values")
    print(f"port bench phase: {time.perf_counter() - t0:.1f} s")
    return kernels


# ---------------------------------------------------------------------------
# The full-length run (A.20) and the default smoke's compressed run of its
# schedule
# ---------------------------------------------------------------------------

# gof_tpu's validation run (VALIDATION.md:26-28) with the package swapped:
# the default OptimizationParams (no appearance network, lambda_distortion
# 100) for 30k steps on the procedural scene, with checkpoints at 15k, where
# densification ends and the regularizers and culling begin, and at 30k
FULL_ARGS = ["--eval", "--iterations", "30000", "--test_iterations", "7000", "15000", "30000",
             "--save_iterations", "30000", "--checkpoint_iterations", "15000", "30000"]
# the default smoke's full_run phase: the same schedule compressed so that
# every transition of the 30k run happens (densify every 100 steps at
# 600-3400, SH degree 3 and the opacity reset at 3000, the size prune from
# 3100, the regularizers from 3500, culling from 3501)
SHORT_ARGS = ["--eval", "--iterations", "4500", "--densify_until_iter", "3500",
              "--distortion_from_iter", "3500", "--depth_normal_from_iter", "3500",
              "--test_iterations", "3500", "4500", "--save_iterations", "4500",
              "--checkpoint_iterations", "3500", "4500"]
# the full_run phase holds the card against the CPU on a seeded 1/16 of its
# trained gaussians: the CPU's plain blends took 508 s for one step of the
# whole 157k-gaussian model at 1237x822 and 311 s at 309x205 on the 8 cores
# of an H100 machine's host, and the witness takes six CPU steps
FULL_RUN_CPU_KEEP = 16
# the full run's TSDF: VALIDATION's 512x81x510 dense grid, depths 1-12 as in
# the chain phase
FULL_TSDF = ["--dense", "--max_dim", "512", "--depth_max", "12"]
# the full run's quality bands around gof_tpu's numbers on the same scene
# (VALIDATION.md: eval PSNR 38.68 at 30k, 152,557 gaussians, F@0.02 0.855
# for TSDF and 0.456 for marching tets); the two runs part at the first
# densification (C13), and the bands leave room for that
FULL_GATES = {"eval PSNR at 30k": (38.18, None), "final active gaussians": (137_000, 168_000),
              "TSDF F@0.02": (0.825, None), "marching-tets F@0.02": (0.406, 0.506)}
# active-count bands for densify's host ms
DENSIFY_BANDS = (50_000, 100_000, 150_000)
# the rungs whose schedule --ladder also runs on the full-size scene
FULL_SIZE_RUNGS = (3,)
# the ladder of whole trajectories (ROADMAP C27): the procedural scene from
# the port's writer, cut to size, and a schedule. Rung 0 is
# tests/test_torch_full_run.py's slow test (PARITY): 300 steps at 96x64, 8
# training views, densify every 25 steps in (50, 260), the reset at 200 and
# the size prune after it. Rungs 1 and 2 have the scene's 36 training views
# and SHORT_ARGS's schedule compressed: rung 1 at 96x64 to 600 steps
# (densify every 25 in (100, 500), the reset at 400, the regularizers from
# 500), rung 2 at 128x85 to 2250 (every 50 in (250, 1750), the reset at
# 1500, the regularizers from 1750). Their key capacity, above every run's
# demand, cuts gof_tpu's interpret step at 96x64 from ~7 s (its default 2M)
# to under a second. The port's plain blends on the CPU set the sizes (~2 s
# a step at 6k gaussians, over 30 s at 309x205), so rungs 2 and 3 run
# gof_tpu and the card only. Rung 3 has the full run's shape on rung 2's
# scene: 4000 steps densifying every 50 in (250, 4000) through the resets at
# 1000, 2000 and 3000, 20 calls at SH degree 3, the regularizers at the last
# step; it sets no key capacity (each run passes its own).
RUNG_SCHEDULE = ["--test_iterations", "99999", "--quiet"]
RUNGS = {
    0: {"scene": ["--width", "96", "--height", "64", "--views", "8", "--test-views", "2",
                  "--points", "1000"],
        "argv": ["--iterations", "300", "--densify_from_iter", "50",
                 "--densification_interval", "25", "--densify_until_iter", "260",
                 "--opacity_reset_interval", "200", "--distortion_from_iter", "260",
                 "--depth_normal_from_iter", "260", *RUNG_SCHEDULE]},
    1: {"scene": ["--width", "96", "--height", "64", "--views", "36", "--test-views", "6",
                  "--points", "1000"],
        "argv": ["--iterations", "600", "--densify_from_iter", "100",
                 "--densification_interval", "25", "--densify_until_iter", "500",
                 "--opacity_reset_interval", "400", "--distortion_from_iter", "500",
                 "--depth_normal_from_iter", "500", "--key_capacity", "131072",
                 *RUNG_SCHEDULE]},
    2: {"scene": ["--width", "128", "--height", "85", "--views", "36", "--test-views", "6",
                  "--points", "2000"],
        "argv": ["--iterations", "2250", "--densify_from_iter", "250",
                 "--densification_interval", "50", "--densify_until_iter", "1750",
                 "--opacity_reset_interval", "1500", "--distortion_from_iter", "1750",
                 "--depth_normal_from_iter", "1750", "--key_capacity", "131072",
                 *RUNG_SCHEDULE]},
    3: {"scene": ["--width", "128", "--height", "85", "--views", "36", "--test-views", "6",
                  "--points", "2000"],
        "argv": ["--iterations", "4000", "--densify_from_iter", "250",
                 "--densification_interval", "50", "--densify_until_iter", "4000",
                 "--opacity_reset_interval", "1000", "--distortion_from_iter", "4000",
                 "--depth_normal_from_iter", "4000", *RUNG_SCHEDULE]},
}


def run_schedule(argv: list) -> dict:
    """The iterations at which train.main with `argv` densifies (and uses
    the size prune), resets the opacities, drops the statistics, adds the
    regularizers, turns culling on and steps the SH degree (the loop's
    host control flow, gof_tpu train.py:921-943; the step's
    min(it // 1000, sh_degree)), and the test iterations."""
    import argparse

    from gof_tpu_torch import config as config_lib

    parser = argparse.ArgumentParser()
    for cls in (config_lib.ModelParams, config_lib.OptimizationParams):
        config_lib.add_group(parser, cls)
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[7_000, 30_000])
    ns, _ = parser.parse_known_args(["-s", "", "-m", "", *argv])
    opt = config_lib.extract(config_lib.OptimizationParams, ns)
    sh = config_lib.extract(config_lib.ModelParams, ns).sh_degree
    its = range(1, opt.iterations + 1)
    until = opt.densify_until_iter
    dens = [i for i in its if opt.densify_from_iter < i < until
            and i % opt.densification_interval == 0]
    return {"iterations": opt.iterations, "until": until, "densify": dens,
            "size_prune": [i for i in dens if i > opt.opacity_reset_interval],
            "reset": [i for i in its if i < until and i % opt.opacity_reset_interval == 0],
            "reg_on": min(opt.distortion_from_iter, opt.depth_normal_from_iter),
            "sh_degree": sh, "tests": sorted(ns.test_iterations)}


class Tee:
    """A stdout that also keeps the lines written to it."""

    def __init__(self, out):
        self.out, self.lines, self.part = out, [], ""

    def write(self, s: str) -> int:
        self.out.write(s)
        *done, self.part = (self.part + s).split("\n")
        self.lines += done
        return len(s)

    def flush(self) -> None:
        self.out.flush()


BREAKDOWN = ("before", "after", "classic", "quantile only", "clones", "splits", "dropped",
             "pruned", "pruned opacity", "pruned size", "pruned non-finite")


def densify_breakdown(params, state, new_params, new_state, report, max_grad: float,
                      min_opacity: float, extent: float, percent_dense: float,
                      use_size) -> dict:
    """What one densify_and_prune call did, recomputed in plain torch (on
    the CPU, in float32 as densify computes it) from the call's inputs and
    result; the arguments are either package's (numpy, JAX or torch arrays
    under gof_tpu's field names). The active count before and after; the
    gaussians the classic threshold selects (mean view-space gradient >=
    max_grad) and those only the abs-gradient quantile half of the hybrid
    criterion adds (>= Q, the quantile at 1 - the classic share); Q; the
    report's clones (placed) and splits; the placements a full pool dropped;
    the report's pruned count and, over the gaussians alive before the
    prune (overlapping), those under min_opacity, over 0.1 * extent with
    the size prune on, and non-finite. "accounted" is False where the
    recomputed splits or the three criteria disagree with the report."""

    def t(x):
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
        return x.detach().cpu()

    f32 = torch.float32
    active, denom = t(state.active).bool(), t(state.denom).to(f32)
    safe = torch.clamp_min(denom, 1e-12)
    zero = torch.zeros_like(denom)
    grads = torch.where(denom > 0, t(state.grad_accum).to(f32) / safe, zero)
    grads_abs = torch.where(denom > 0, t(state.grad_abs_accum).to(f32) / safe, zero)
    n_act = max(int(active.sum()), 1)
    classic = (grads >= max_grad) & active
    # the linear-interpolation quantile over the active gaussians
    # (torch.quantile's rule, as the hybrid criterion takes it)
    xs = torch.sort(grads_abs[active]).values
    pos = (torch.tensor(1.0, dtype=f32) - int(classic.sum()) / torch.tensor(n_act, dtype=f32)
           ).clamp(0, 1) * max(len(xs) - 1, 0)
    lo, hi = int(torch.floor(pos)), int(torch.ceil(pos))
    frac = pos - lo
    q = float(xs[lo] * (1 - frac) + xs[hi] * frac) if len(xs) else 0.0
    quantile = (grads_abs >= q) & active
    maxscale = torch.amax(torch.exp(t(params.scaling).to(f32)), dim=-1)
    split = (classic | quantile) & (maxscale > percent_dense * extent)
    clone = (classic | quantile) & ~split
    new_active = t(new_state.active).bool()
    n_cloned, n_split, n_pruned = (int(t(x)) for x in report[:3])
    before, after = int(active.sum()), int(new_active.sum())
    placed = after + n_pruned - before + n_split

    def same_rows(a, b):
        a, b = t(a).reshape(a.shape[0], -1), t(b).reshape(b.shape[0], -1)
        return ((a == b) | (torch.isnan(a) & torch.isnan(b))).all(dim=1)

    kept = torch.ones_like(active)
    for f in ("xyz", "scaling", "rotation", "opacity", "features_dc", "features_rest"):
        kept &= same_rows(getattr(params, f), getattr(new_params, f))
    # alive before the prune: the old gaussians but the split originals, and
    # every slot a placement wrote (an inactive slot whose row changed)
    alive = (active & ~split) | (~active & ~kept) | new_active
    new_scaling = torch.exp(t(new_params.scaling).to(f32))
    opacity = alive & (torch.sigmoid(t(new_params.opacity).to(f32)) < min_opacity)
    size = alive & (torch.amax(new_scaling, dim=-1) > 0.1 * extent) & bool(t(use_size))
    finite = torch.ones_like(active)
    for f in ("xyz", "scaling", "rotation", "opacity"):
        x = t(getattr(new_params, f))
        finite &= torch.isfinite(x.reshape(x.shape[0], -1)).all(dim=1)
    nonfinite = alive & ~finite
    out = dict(zip(BREAKDOWN, (before, after, int(classic.sum()), int((quantile & ~classic).sum()),
                               n_cloned, n_split,
                               int(clone.sum()) + 2 * n_split - placed, n_pruned,
                               int(opacity.sum()), int(size.sum()), int(nonfinite.sum()))))
    out["Q"] = q
    out["accounted"] = (int((opacity | size | nonfinite).sum()) == n_pruned
                        and int(split.sum()) == n_split and out["dropped"] >= 0)
    return out


class RunRecorder:
    """Spies on a train.main run without adding a synchronisation to its
    steps. Per step: the iteration, the built step's flags, whether it got a
    cache row, the SH degree its render used, K2/K1/K3/K4's launches and the
    packed metrics, read in bulk every 1000 steps with the host clock and
    the peak memory. Every densify_and_prune call (host ms between
    synchronisations, its report, the size-prune flag, the active count
    before and after, the pool, densify_breakdown's record), pool growth and
    opacity reset. `last` is the last
    step's (camera, gt, cache row); the row is a view of the loop's cache,
    so after the loop it holds that camera's next bound. With `cpu_noise`
    the densify calls take their offsets from a CPU generator seeded as the
    loop seeds its own, so that a run on the card draws the noise of the
    same run on the CPU."""

    def __init__(self, cpu_noise: bool = False):
        self.counters = train_counters()
        self.steps, self.windows, self.densify, self.grows, self.resets = [], [], [], [], []
        self.pending, self.last, self.degree, self.t_last = [], None, None, None
        self.noise = torch.Generator().manual_seed(0) if cpu_noise else None

    def patches(self) -> list:
        from unittest import mock

        from gof_tpu_torch import train
        from gof_tpu_torch.model import gaussians as gm

        return [mock.patch.object(train, "build_train_step",
                                  self.wrap_build(train.build_train_step)),
                mock.patch.object(train, "masked_shs", self.wrap_shs(train.masked_shs)),
                mock.patch.object(gm, "densify_and_prune", self.wrap_densify(gm.densify_and_prune)),
                mock.patch.object(train, "grow_capacity", self.wrap_grow(train.grow_capacity)),
                mock.patch.object(gm, "reset_opacity", self.wrap_reset(gm.reset_opacity))]

    def wrap_build(self, build):
        import inspect

        sig = inspect.signature(build)

        def built(*a, **k):
            step = build(*a, **k)
            bound = sig.bind(*a, **k)
            bound.apply_defaults()
            flags = {"stats": bound.arguments["with_stats"], "reg": bound.arguments["with_reg"]}

            def recorded(tp, st, gs, gt, it, cam, bg, lim=None):
                if self.t_last is None:
                    self.t_last = time.perf_counter()
                before = [c.launches for c in self.counters]
                self.degree = None
                res = step(tp, st, gs, gt, it, cam, bg, lim=lim)
                self.steps.append({"iter": int(it), **flags, "culled": lim is not None,
                                   "degree": self.degree, "cap": int(res[2].active.shape[0]),
                                   "launches": [c.launches - b for c, b in
                                                zip(self.counters, before)]})
                self.pending.append(res[3]["packed"])
                self.last = (cam, gt, lim)
                if int(it) % 1000 == 0:
                    self.flush()
                return res

            return recorded

        return built

    def wrap_shs(self, masked_shs):
        def spy(params, degree, max_degree):
            self.degree = int(degree)
            return masked_shs(params, degree, max_degree)

        return spy

    def timed(self, fn, record):
        """fn, timed between synchronisations; `record` gets its arguments
        by name, its result and the ms."""
        import inspect

        sig = inspect.signature(fn)

        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args, **kwargs)
            torch.cuda.synchronize()
            record(sig.bind(*args, **kwargs).arguments, res, (time.perf_counter() - t0) * 1e3)
            return res

        return wrapped

    def wrap_densify(self, fn):
        import inspect

        sig = inspect.signature(fn)

        def record(args, res, ms):
            self.densify.append({"iter": self.steps[-1]["iter"], "ms": ms,
                                 "report": [int(x) for x in res.report],
                                 "use_size": bool(args["use_size_prune"]),
                                 "active": (int(args["state"].active.sum()),
                                            int(res.state.active.sum())),
                                 "cap": int(res.state.active.shape[0]),
                                 "breakdown": densify_breakdown(
                                     args["params"], args["state"], res.params, res.state,
                                     res.report, args["max_grad"], args["min_opacity"],
                                     args["extent"], args["percent_dense"],
                                     args["use_size_prune"])})

        timed = self.timed(fn, record)

        def call(*a, **k):
            if self.noise is None:
                return timed(*a, **k)
            args = sig.bind(*a, **k).arguments
            xyz = args["params"].xyz
            args["noise"] = tuple(torch.randn((xyz.shape[0], 3), generator=self.noise).to(
                xyz.device) for _ in range(3))
            return timed(**args)

        return call

    def wrap_grow(self, fn):
        def record(args, res, ms):
            self.grows.append({"iter": self.steps[-1]["iter"], "from": args["old_cap"],
                               "to": args["new_cap"], "ms": ms})

        return self.timed(fn, record)

    def wrap_reset(self, fn):
        def record(args, res, ms):
            self.resets.append(self.steps[-1]["iter"])

        return self.timed(fn, record)

    def flush(self) -> None:
        """Read the pending steps' packed metrics (one host read) and print
        the window's line."""
        if not self.pending:
            return
        mp = torch.stack(self.pending).cpu().numpy()
        now = time.perf_counter()
        self.pending.clear()
        recs = self.steps[-len(mp):]
        for r, m in zip(recs, mp):
            r.update(loss=float(m[0]), keys=int(m[2]), active=int(m[6]), live=int(m[7]),
                     skipped=bool(m[9]))
        culled = [r for r in recs if r["culled"]]
        w = {"from": recs[0]["iter"], "to": recs[-1]["iter"],
             "it_s": len(recs) / (now - self.t_last), "active": recs[-1]["active"],
             "cap": recs[-1]["cap"], "keys_mean": float(np.mean([r["keys"] for r in recs])),
             "keys_max": max(r["keys"] for r in recs), "culled": len(culled),
             "live_frac": (float(np.mean([r["live"] / max(r["keys"], 1) for r in culled]))
                           if culled else None),
             "skipped": sum(r["skipped"] for r in recs),
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        self.t_last = now
        self.windows.append(w)
        live = "" if w["live_frac"] is None else (
            f", live fraction {w['live_frac']:.4f} over {w['culled']} culled steps, "
            f"{w['skipped']} skipped")
        print(f"  steps {w['from']}-{w['to']}: {w['it_s']:.3f} it/s (host clock), active "
              f"{w['active']} of {w['cap']}, keys per step mean {w['keys_mean']:.0f} max "
              f"{w['keys_max']}{live}; peak memory {w['peak_gib']:.3f} GiB", flush=True)


def print_breakdown(label: str, densify: list) -> list:
    """One line per densify call of a RunRecorder (densify_breakdown's
    record) and one of their totals; returns the iterations whose record
    does not account for its call's report."""
    if not densify:
        return []
    for d in densify:
        b = d["breakdown"]
        print(f"  {label} densify {d['iter']}: " + ", ".join(f"{k} {b[k]}" for k in BREAKDOWN)
              + f", Q {b['Q']:.6e}")
    tot = {k: sum(d["breakdown"][k] for d in densify) for k in BREAKDOWN[2:]}
    print(f"  {label} densify totals over {len(densify)} calls: "
          + ", ".join(f"{k} {v}" for k, v in tot.items()))
    return [d["iter"] for d in densify if not d["breakdown"]["accounted"]]


def run_gates(rec: RunRecorder, lines: list, sched: dict, evals: dict) -> list:
    """What a train.main run must show, from its recorded steps, the loop's
    prints and its log; returns the failures. The schedule's transitions at
    the iterations run_schedule gives (those past a resume point): densify
    and its size prune, the opacity resets, the statistics on up to
    densify_until_iter, the regularizers from their first iteration, a
    cache row from densify_until_iter + 1 (and its print), the SH degree;
    the loss finite at every step; K2 and K1 launched every step, K3 and K4
    once on every step not skipped and never on a skipped one; an eval at
    every test iteration, finite, logged and printed."""
    import re

    first = rec.steps[0]["iter"] - 1
    iters = [r["iter"] for r in rec.steps]
    until, bad = sched["until"], []

    def want(name, got, expect):
        ok = got == expect
        at = f"{got[0]}-{got[-1]}" if len(got) > 3 else ", ".join(map(str, got))
        print(f"  {name}: {'as scheduled' if ok else 'NOT as scheduled'} ({len(got)}"
              f"{f': {at}' if got else ''})")
        if not ok:
            bad.append(f"{name}: got {got[:20]}, want {expect[:20]}")

    want("steps", iters, list(range(first + 1, sched["iterations"] + 1)))
    want("densify", [d["iter"] for d in rec.densify], [i for i in sched["densify"] if i > first])
    want("size prune", [d["iter"] for d in rec.densify if d["use_size"]],
         [i for i in sched["size_prune"] if i > first])
    want("opacity resets", rec.resets, [i for i in sched["reset"] if i > first])
    want("statistics in the step", [r["iter"] for r in rec.steps if r["stats"]],
         [i for i in iters if i <= until])
    want("regularizers in the step", [r["iter"] for r in rec.steps if r["reg"]],
         [i for i in iters if i >= sched["reg_on"]])
    want("culled steps", [r["iter"] for r in rec.steps if r["culled"]],
         [i for i in iters if i > until])
    for d in range(1, sched["sh_degree"] + 1):
        want(f"SH degree {d}", [r["iter"] for r in rec.steps if r["degree"] == d],
             [i for i in iters if min(i // 1000, sched["sh_degree"]) == d])
    if until + 1 > first and until < sched["iterations"]:
        want("culling print", [int(m.group(1)) for m in (re.match(r"^\[(\d+)\] liveness "
                                                                  r"culling on$", x)
                                                         for x in lines) if m], [until + 1])
    want("non-finite losses", [r["iter"] for r in rec.steps if not np.isfinite(r["loss"])], [])
    want("steps without K2 and K1", [r["iter"] for r in rec.steps if min(r["launches"][:2]) < 1],
         [])
    want("steps whose K3 / K4 launches differ from one per update",
         [r["iter"] for r in rec.steps if r["launches"][2:] != [1 - r["skipped"]] * 2], [])
    tests = [i for i in sched["tests"] if first < i <= sched["iterations"]]
    printed = [int(m.group(1)) for m in (re.match(r"^\[(\d+)\] eval: ", x) for x in lines) if m]
    want("evals logged, finite", sorted(i for i in evals if i > first
                                        and np.isfinite(evals[i]["psnr"])), tests)
    want("evals printed", printed, tests)
    return bad


def newest_checkpoint(run: str):
    """(iteration, path) of the newest chkpnt<k>.pkl in `run`, or None."""
    if not os.path.isdir(run):
        return None
    ks = [int(f[6:-4]) for f in os.listdir(run) if f.startswith("chkpnt") and f.endswith(".pkl")]
    return (max(ks), os.path.join(run, f"chkpnt{max(ks)}.pkl")) if ks else None


def full_train(scene: str, run: str, argv: list, smi: str, label: str, start=None,
               strict: bool = True, cpu_noise: bool = False) -> dict:
    """train.main(-s scene -m run argv [--start_checkpoint start]) through a
    RunRecorder (`cpu_noise` passed on), its stdout kept, then run_gates and
    the run's records: the windows, pool growths, densify ms by
    active-count band, every densify call's breakdown and their totals, each
    opacity reset and the prune after it, the evals, the wall time. Raises
    on a failed gate if `strict`. Returns {"rec", "launches", "evals", "wall",
    "sched", "bad"}: "bad" lists the failed gates."""
    import contextlib

    from gof_tpu_torch import train

    sched = run_schedule(argv)
    rec = RunRecorder(cpu_noise)
    for c in rec.counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    tee = Tee(sys.stdout)
    args = ["-s", scene, "-m", run, *argv] + (["--start_checkpoint", start] if start else [])
    print(f"{label}: train.main {' '.join(args)} on {smi}")
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for p in rec.patches():
            stack.enter_context(p)
        stack.enter_context(contextlib.redirect_stdout(tee))
        train.main(args)
    rec.flush()
    wall = time.perf_counter() - t0
    launches = {c.name: c.launches for c in rec.counters}
    recs = [json.loads(x) for x in open(os.path.join(run, "train_log.jsonl"))]
    evals = {r["iter"]: r["eval"] for r in recs if "eval" in r}
    n = len(rec.steps)
    print(f"{label}: {n} steps ({rec.steps[0]['iter']}-{rec.steps[-1]['iter']}) in {wall:.2f} s "
          f"({n / wall:.3f} it/s host clock, scene read, evals, checkpoints and PLY included); "
          f"launches {launches}; card {smi}")
    print(f"  peak max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for g in rec.grows:
        print(f"  pool growth at step {g['iter']}: {g['from']} -> {g['to']} slots, "
              f"{g['ms']:.3f} ms")
    bands = {}
    for d in rec.densify:
        band = sum(d["active"][0] >= b for b in DENSIFY_BANDS)
        bands.setdefault(band, []).append(d["ms"])
    for band, ms in sorted(bands.items()):
        lo = ([0] + list(DENSIFY_BANDS))[band]
        hi = (list(DENSIFY_BANDS) + [None])[band]
        print(f"  densify, active {lo}-{hi if hi else ''} before the call: {len(ms)} calls, ms "
              f"(host clock, synchronised) min {min(ms):.3f} median {np.median(ms):.3f} max "
              f"{max(ms):.3f}")
    unaccounted = print_breakdown(label, rec.densify)
    if rec.densify:
        d0, d1 = rec.densify[0], rec.densify[-1]
        peak = max(max(d["active"]) for d in rec.densify)
        print(f"  densify calls {len(rec.densify)} ({d0['iter']}-{d1['iter']}): active "
              f"{d0['active'][0]} -> {d1['active'][1]} (peak {peak}); cloned "
              f"{sum(d['report'][0] for d in rec.densify)}, split "
              f"{sum(d['report'][1] for d in rec.densify)}, pruned "
              f"{sum(d['report'][2] for d in rec.densify)}, overflows "
              f"{sum(d['report'][3] for d in rec.densify)}")
    for r in rec.resets:
        after = next((d for d in rec.densify if d["iter"] > r), None)
        print(f"  opacity reset at step {r}; " + ("no densify after it" if after is None else
              f"the next densify (step {after['iter']}, size prune {after['use_size']}) pruned "
              f"{after['report'][2]}: active {after['active'][0]} -> {after['active'][1]}"))
    for it, e in sorted(evals.items()):
        print(f"  eval at {it}: PSNR {e['psnr']} over {e['views']} test views")
    print(f"{label}: the run against its schedule:")
    bad = run_gates(rec, tee.lines, sched, evals)
    if unaccounted:
        bad.append(f"densify_breakdown does not account for the calls at {unaccounted}")
    if bad and strict:
        raise RuntimeError(f"{label}: the run missed its schedule: {bad}")
    return {"rec": rec, "launches": launches, "evals": evals, "wall": wall, "sched": sched,
            "bad": bad}


def trained_kernels(run: str, trained: dict, label: str, smi: str) -> list:
    """K2, K1, K3 and K4 held against their plain versions and timed at a
    trained run's shapes: (densify) one step in the densify phase's instance
    (statistics on, regularizers off) from the checkpoint at
    densify_until_iter, on training view 0; (regularize) one step from the
    last checkpoint on the last step's training view through its cache row
    as the run left it (the liveness-compacted list). Returns their
    kernels-line entries."""
    from gof_tpu_torch import config as config_lib
    from gof_tpu_torch import train
    from gof_tpu_torch.data import scene as scene_lib
    from gof_tpu_torch.ops import binning

    cfg, _, opt = config_lib.load_cfg(run)
    sc = scene_lib.Scene(cfg.source_path, "", shuffle=False)
    tx = train.make_optimizer(opt, sc.cameras_extent)
    sched, launches = trained["sched"], trained["launches"]
    cam0, gt0 = sc.camera(sc.train_cameras[0], device="cuda")
    last = trained["rec"].last if trained.get("rec") else None
    cam, gt, lim = last if last and last[2] is not None else (cam0, None, None)
    cases = [("densify", sched["until"], True, False, cam0, torch.from_numpy(gt0).cuda(), None),
             ("regularize", sched["iterations"], False, True, cam,
              gt if gt is not None else torch.from_numpy(gt0).cuda(), lim)]
    kernels = []
    for phase, it, with_stats, with_reg, c, g, row in cases:
        tp, st, gs, _ = train.load_checkpoint(os.path.join(run, f"chkpnt{it}.pkl"), "cuda")
        ntiles = int(np.prod(binning.tile_grid(c.width, c.height)))
        if with_reg and row is None:  # no row from the run: one from a render
            row = live_render((tp, st, gs), c).live_counts + binning.LIVE_MARGIN_CHUNKS
            print(f"  {label} {phase}: the run left no cache row; bounds from a render")
        point = f"{label} {phase}"
        lim_c = None if row is None else row[:ntiles]
        print(f"{point} (chkpnt{it}, {int(gs.active.sum())} active of {gs.active.shape[0]}; "
              f"card {smi}):")
        step = train.build_train_step(opt, cfg, config_lib.PipelineParams(), tx,
                                      with_stats=with_stats, with_reg=with_reg)
        _, (tp, st, gs) = profile_steps(lambda *a: step(*a, lim=lim_c),
                                        (tp, st, gs, g, it, c, torch.zeros(3, device="cuda")))
        ins, _, _ = step_inputs(tp.gauss, gs, st, tx, g, c, opt, cfg, with_stats, with_reg, it,
                                lim=lim_c)
        print(f"  {ins['keys']} keys, blended list {int(ins['b'].num_keys)}, {ins['demand']} "
              "compact rows")
        held = train_kernels(ins, point, with_stats, with_reg, launches)
        held[0]["name"] = f"expand ({point})"
        kernels += held
        del tp, st, gs, ins
        torch.cuda.empty_cache()
    return kernels


def trained_integrate(run: str, launches: dict, label: str) -> dict:
    """K5 (check_integrate) at test view 0 with all the tetra points of the
    run's last PLY."""
    from gof_tpu_torch import config as config_lib
    from gof_tpu_torch.data import scene as scene_lib

    cfg, _, _ = config_lib.load_cfg(run)
    sc = scene_lib.Scene(cfg.source_path, "", shuffle=False)
    cam = sc.camera(sc.test_cameras[0], device="cuda")[0]
    return check_integrate(run, launches, f"integrate ({label})", camera=cam)


# the card against the CPU after one step at a trained state. The bounds of
# tests/test_torch_train.py::test_train_step_matches_gof_tpu (the loss and
# the params within rtol 1e-5, Adam's moments and the statistics within
# GRAD_BOUND of their largest magnitude) hold at gof_tpu's gradient-test
# scales (C9); at a trained state the f32 step's scales and rotations
# gradients lie percents of their largest off float64, on the CPU as on the
# card (C29). So both are held against the port's CPU path in float64 from
# the same inputs, and the card passes a quantity where it lies within that
# bound of float64, or no further from float64 than the plain f32 path up
# to the spread of two f32 evaluations whose roundings cross the blend's
# thresholds (T > 1e-4, alpha >= 1/255, the median) at different pixels:
# FP64_RATIO times the CPU's distance in the L2 norm (set before the first
# run), FP64_MAX_RATIO times at the largest slot, where one crossing sets
# the reading (set after the first run, whose largest ratio was 2.52).
STEP_BOUNDS = {"loss": 1e-5, "params": 1e-5, "mu": GRAD_BOUND, "nu": GRAD_BOUND,
               "stats": GRAD_BOUND}
FP64_RATIO = 2.0
FP64_MAX_RATIO = 4.0
# the card-against-CPU steps take the centre 1/CARD_CPU_CROP of each side
# of a view; --full, on the whole model, 1/FULL_CARD_CPU_CROP (the float64
# step took 1.8x the f32 one on the phase's state)
CARD_CPU_CROP = 2
FULL_CARD_CPU_CROP = 3


def crop_view(cam, gt, div: int):
    """The centre of a view, 1/div of each side (rounded so that the margins
    are whole pixels): its camera, with the focal lengths and the principal
    point at the centre kept, and its ground truth [3, h, w]."""
    from dataclasses import replace

    from gof_tpu_torch import transforms
    from gof_tpu_torch.constants import CAMERA_ZFAR, CAMERA_ZNEAR

    w = cam.width // div + (cam.width - cam.width // div) % 2
    h = cam.height // div + (cam.height - cam.height // div) % 2
    x0, y0 = (cam.width - w) // 2, (cam.height - h) // 2
    tx = float(cam.tan_fovx) * w / cam.width
    ty = float(cam.tan_fovy) * h / cam.height
    proj = transforms.projection_matrix(CAMERA_ZNEAR, CAMERA_ZFAR, 2 * np.arctan(tx),
                                        2 * np.arctan(ty))
    full = (proj @ cam.world_view.double().cpu().numpy()).astype(np.float32)
    dev = cam.world_view.device
    crop = replace(cam, width=w, height=h, full_proj=torch.from_numpy(full).to(dev),
                   tan_fovx=torch.tensor(tx, dtype=torch.float32, device=dev),
                   tan_fovy=torch.tensor(ty, dtype=torch.float32, device=dev))
    return crop, gt[:, y0:y0 + h, x0:x0 + w].contiguous()


# the stages of the step that stage_in_float64 can compute in float64
F64_STAGES = ("preprocess", "preprocess backward", "blend forward", "blend backward", "reduce",
              "loss")


@contextlib.contextmanager
def stage_in_float64(*stages):
    """The port's float32 step with the named F64_STAGES computed in float64
    on the CPU path (ROADMAP C29): "preprocess" gives quadrics.preprocess's
    outputs float64's values with its float32 graph's gradients,
    "preprocess backward" the reverse; "blend forward" and "blend backward"
    run the plain versions of K1 (rasterize_fwd) and K3 (bwd_rows),
    "reduce" K4's (reduce_compact_rows), "loss" train.train_loss and its
    backward (L1, SSIM, the regularizers), on float64 copies of their
    inputs; each rounds its results back to the inputs' dtype."""
    import dataclasses
    from unittest import mock

    from gof_tpu_torch import cameras as cameras_lib
    from gof_tpu_torch import train
    from gof_tpu_torch.ops import quadrics, rasterize

    def f64(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.double()
        if isinstance(x, cameras_lib.Camera):
            return dataclasses.replace(x, **{f: getattr(x, f).double()
                                             for f in cameras_lib.TENSOR_FIELDS
                                             if getattr(x, f).is_floating_point()})
        return x

    patches = []
    pre, fwd, bwd, red, loss = (quadrics.preprocess, rasterize.rasterize_fwd, rasterize.bwd_rows,
                                rasterize.reduce_compact_rows, train.train_loss)
    if "preprocess" in stages or "preprocess backward" in stages:
        values, grads = "preprocess" in stages, "preprocess backward" in stages

        def preprocess(*a, **k):
            out32 = pre(*a, **k)
            out64 = pre(*map(f64, a), **{n: f64(v) for n, v in k.items()})
            rep = {}
            for f in dataclasses.fields(out32):
                x, y = getattr(out32, f.name), getattr(out64, f.name)
                if isinstance(x, torch.Tensor) and x.is_floating_point():
                    g = y.to(x.dtype) if grads else x
                    rep[f.name] = (y if values else x).detach().to(x.dtype) + (g - g.detach())
            return dataclasses.replace(out32, **rep)

        patches.append(mock.patch.object(quadrics, "preprocess", preprocess))
    if "blend forward" in stages:
        def rasterize_fwd(payload, binning, mv, *a, **k):
            return fwd(payload.double(), binning, mv.double(), *a, **k).to(payload.dtype)

        patches.append(mock.patch.object(rasterize, "rasterize_fwd", rasterize_fwd))
    if "blend backward" in stages:
        def bwd_rows(payload, fout, gout, binning, mv, *a, **k):
            rows, gid = bwd(payload.double(), fout.double(), gout.double(), binning,
                            mv.double(), *a, **k)
            return rows.to(payload.dtype), gid

        patches.append(mock.patch.object(rasterize, "bwd_rows", bwd_rows))
    if "reduce" in stages:
        def reduce_compact_rows(rows, gid, P):
            per_g, per_s = red(rows.double(), gid, P)
            return per_g.to(rows.dtype), None if per_s is None else per_s.to(rows.dtype)

        patches.append(mock.patch.object(rasterize, "reduce_compact_rows", reduce_compact_rows))
    if "loss" in stages:
        def train_loss(image, gt, camera, *a, **k):
            return tuple(x.to(image.dtype) for x in loss(image.double(), gt.double(),
                                                         f64(camera), *a, **k))

        patches.append(mock.patch.object(train, "train_loss", train_loss))
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        yield


def stage_gaps(run: str, it: int, view, keep, label: str) -> None:
    """ROADMAP C29 at a trained state: one regularizers' step from
    chkpnt<it> on the CPU in float64, in float32, and in float32 with each
    of F64_STAGES in float64 (stage_in_float64), on the view (camera,
    ground truth) with the active slots cut to `keep`; prints the scaling's
    and rotation's first moments' distances from float64."""
    from gof_tpu_torch import config as config_lib
    from gof_tpu_torch import train
    from gof_tpu_torch.data import scene as scene_lib

    cfg, pipe, opt = config_lib.load_cfg(run)
    sc = scene_lib.Scene(cfg.source_path, "", shuffle=False)
    step = train.build_train_step(opt, cfg, pipe, train.make_optimizer(opt, sc.cameras_extent),
                                  with_stats=False, with_reg=True)
    cam, gt = view[0].to("cpu"), view[1].cpu()

    def load():
        tp, st, gs, _ = train.load_checkpoint(os.path.join(run, f"chkpnt{it}.pkl"), "cpu")
        gs.active &= keep
        return tp, st, gs

    st0 = load()[1]
    tp, st, gs, c = train.as_float64(*load(), cam)
    t0 = time.perf_counter()
    res64 = step(tp, st, gs, gt.double(), it + 1, c, torch.zeros(3, dtype=torch.float64))
    act = gs.active
    print(f"{label}: float64 step from chkpnt{it} ({int(act.sum())} active slots, "
          f"{cam.width}x{cam.height}) in {time.perf_counter() - t0:.2f} s (host CPU)")
    for stages in [()] + [(s,) for s in F64_STAGES] + [F64_STAGES]:
        t0 = time.perf_counter()
        with stage_in_float64(*stages):
            res32 = step(*load(), gt, it + 1, cam, torch.zeros(3))
        gap = step_diffs(res32[:3], 0.0, res64[:3], 0.0, st0, act)
        print(f"  {label}: float32 step, in float64 {' + '.join(stages) or 'nothing'} "
              f"({time.perf_counter() - t0:.2f} s): " + ", ".join(
                  f"{k} {gap[k]:.3e} / {gap[k + ' (L2)']:.3e}"
                  for k in ("mu.xyz", "mu.scaling", "mu.rotation", "mu.opacity")) + " (max / L2)")


def witness_step(run: str, it: int, with_stats: bool, with_reg: bool, view, keep, smi: str,
                 label: str):
    """One build_train_step (this instance) from chkpnt<it> on the view
    (camera, ground truth) three times: on the card, through the port's CPU
    path (the plain versions) and through that path in float64, from the
    same inputs; the active slots cut to `keep` where it is given. The
    regularizers' instance gets the cache row of a render of the state on
    the card (live_counts + LIVE_MARGIN_CHUNKS), as a late step does; the
    statistics' instance none. Each quantity of step_diffs (with the
    statistics in the statistics' instance) passes where the card lies no
    further from float64 than STEP_BOUNDS or FP64_RATIO times the CPU's
    distance; the skip flag, Adam's count, the active set, the 3D filter,
    denom and max_radii2d equal on the card and the CPU. Returns (the
    failures, the CPU's post-step state)."""
    from gof_tpu_torch import config as config_lib
    from gof_tpu_torch import train
    from gof_tpu_torch.data import scene as scene_lib
    from gof_tpu_torch.model import gaussians as gm
    from gof_tpu_torch.ops import binning
    from gof_tpu_torch.ops import render as render_lib

    cfg, pipe, opt = config_lib.load_cfg(run)
    sc = scene_lib.Scene(cfg.source_path, "", shuffle=False)
    tx = train.make_optimizer(opt, sc.cameras_extent)
    ckpt = os.path.join(run, f"chkpnt{it}.pkl")
    cam, gt = view

    def load(dev):
        tp, st, gs, _ = train.load_checkpoint(ckpt, dev)
        if keep is not None:
            gs.active &= keep.to(dev)
        return tp, st, gs

    lim = None
    if with_reg:
        tp, _, gs = load("cuda")
        g = tp.gauss
        with torch.no_grad():
            lim = render_lib.render(
                cam, g.xyz, gm.filtered_scaling(g, gs.filter_3d), g.rotation,
                gm.filtered_opacity(g, gs.filter_3d), train.masked_shs(g, cfg.sh_degree,
                                                                       cfg.sh_degree),
                cfg.sh_degree, cfg.kernel_size, torch.zeros(3, device="cuda"),
                active_mask=gs.active, with_stats=False, with_reg=True
            ).live_counts + binning.LIVE_MARGIN_CHUNKS
        del tp, gs, g
    runs = {}
    for name, dev in (("card", "cuda"), ("CPU", "cpu"), ("float64", "cpu")):
        tp, st, gs = load(dev)
        c, g_t, bg = cam.to(dev), gt.to(dev), torch.zeros(3, device=dev)
        if name == "float64":
            tp, st, gs, c = train.as_float64(tp, st, gs, c)
            g_t, bg = g_t.double(), bg.double()
        step = train.build_train_step(opt, cfg, pipe, tx, with_stats=with_stats,
                                      with_reg=with_reg)
        t0 = time.perf_counter()
        res = step(tp, st, gs, g_t, it + 1, c, bg, lim=None if lim is None else lim.to(dev))
        runs[name] = (state_copy(*res[:3]), float(res[3]["loss"]), bool(res[3]["packed"][9]),
                      time.perf_counter() - t0)
        del tp, st, gs, res
    _, st0, _ = load("cpu")
    (card, c_loss, c_skip, c_s), (cpu, p_loss, p_skip, p_s), (f64, q_loss, q_skip, q_s) = (
        runs["card"], runs["CPU"], runs["float64"])
    act = cpu[2].active
    row = "no cache row" if lim is None else "a render's cache row"
    d_card = step_diffs(card, c_loss, f64, q_loss, st0, act, with_stats)
    d_cpu = step_diffs(cpu, p_loss, f64, q_loss, st0, act, with_stats)
    d_cc = step_diffs(card, c_loss, cpu, p_loss, st0, act, with_stats)
    limit = {k: max(STEP_BOUNDS[k.split(".")[0]],
                    (FP64_RATIO if k.endswith("(L2)") else FP64_MAX_RATIO) * d_cpu[k])
             for k in d_card}
    bad = [k for k in d_card if not d_card[k] <= limit[k]]
    exact = ["active", "filter_3d", "denom", "max_radii2d"] + (
        [] if with_stats else ["grad_accum", "grad_abs_accum"])
    same = {f: torch.equal(getattr(card[2], f), getattr(cpu[2], f)) for f in exact}
    print(f"{label}: card, CPU and CPU float64 at chkpnt{it} (one step {it + 1}, statistics "
          f"{with_stats}, regularizers {with_reg}, at {cam.width}x{cam.height}, "
          f"{row}, {int(act.sum())} "
          f"active slots; card {smi}): loss {c_loss:.8f} / {p_loss:.8f} / {q_loss:.10f}; "
          f"skipped {c_skip} / {p_skip} / {q_skip}; host s {c_s:.2f} / {p_s:.2f} / {q_s:.2f}; "
          f"equal on the card and the CPU {same}; Adam count {card[1].count} / {cpu[1].count}")
    print(f"  quantity: card against float64 / CPU against float64 / card against CPU "
          f"(limit: the step test's bound or {FP64_MAX_RATIO}x the CPU's distance, "
          f"{FP64_RATIO}x in the L2 norm)")
    for k in d_card:
        print(f"    {k}: {d_card[k]:.3e} / {d_cpu[k]:.3e} / {d_cc[k]:.3e} (limit "
              f"{limit[k]:.3e}){'  OVER' if k in bad else ''}")
    ids = torch.nonzero(act).flatten()
    for k in [k for k in bad if k.split(".")[0] in ("mu", "nu", "stats")]:
        part, f = k.split(" ")[0].split(".")

        def field(r):
            return (getattr(r[2], f) if part == "stats" else getattr(getattr(r[1], part), f)
                    )[act].double().reshape(len(ids), -1)

        want, got_card, got_cpu = field(f64), field(card), field(cpu)
        j = int((got_card - want).abs().amax(1).argmax())
        g, slot = cpu[0].gauss, int(ids[j])
        print(f"  {k}: largest at slot {slot}: card "
              f"{float((got_card - want)[j].abs().max()):.3e}, CPU "
              f"{float((got_cpu - want)[j].abs().max()):.3e} from float64, whose max is "
              f"{float(want.abs().max()):.3e}; its max scale "
              f"{float(g.scaling[slot].exp().max()):.3e}, opacity "
              f"{float(torch.sigmoid(g.opacity[slot])):.3f}")
    fails = [f"{label}: {k} {d_card[k]:.3e} over {limit[k]:.3e}" for k in bad]
    if c_skip != p_skip or card[1].count != cpu[1].count or not all(same.values()):
        fails.append(f"{label}: skip {c_skip} / {p_skip}, count {card[1].count} / "
                     f"{cpu[1].count}, equal {same}")
    return fails, cpu


def trained_card_vs_cpu(run: str, trained: dict, smi: str, keep_every: int = 1,
                        crop: int = CARD_CPU_CROP) -> None:
    """The card against the CPU and a float64 witness at a trained state
    (witness_step) on the centre 1/crop of each side of a training view
    (crop_view; the CPU's plain blends walk each 32x32 tile to saturation,
    so the CPU's time goes with the tiles), with a seeded
    1/keep_every of the active slots where keep_every > 1:
    (regularize) one step from the last checkpoint on the last step's view;
    (densify) one step with the statistics from the checkpoint at
    densify_until_iter (its accumulators hold the steps since the last
    densification) on training view 0, then densify_and_prune as the loop
    calls it on the CPU's post-step state, on the card and the CPU with the
    same noise (densify_both). Raises after both if either failed."""
    from gof_tpu_torch import config as config_lib
    from gof_tpu_torch.data import scene as scene_lib

    cfg, _, opt = config_lib.load_cfg(run)
    sc = scene_lib.Scene(cfg.source_path, "", shuffle=False)
    sched = trained["sched"]
    last = trained["rec"].last if trained.get("rec") else None
    cam0, gt0 = sc.camera(sc.train_cameras[0], device="cuda")
    gt0 = torch.from_numpy(gt0).cuda()
    keep = None
    if keep_every > 1:
        from gof_tpu_torch import train

        gs = train.load_checkpoint(os.path.join(run, f"chkpnt{sched['iterations']}.pkl"))[2]
        keep = (torch.rand(gs.active.shape[0], generator=torch.Generator().manual_seed(SEED))
                < 1 / keep_every)
    fails, _ = witness_step(run, sched["iterations"], False, True,
                            crop_view(*(last[:2] if last else (cam0, gt0)), crop), keep,
                            smi, "regularize")
    until = sched["until"]
    more, cpu = witness_step(run, until, True, False, crop_view(cam0, gt0, crop), keep,
                             smi, "densify")
    fails += more
    gen = torch.Generator().manual_seed(SEED)
    noise = [torch.randn(cpu[0].gauss.xyz.shape, generator=gen) for _ in range(3)]
    try:
        densify_both(f"as the loop calls it after step {until + 1}", state_copy(*cpu, "cuda"),
                     cpu, noise, (opt.densify_grad_threshold, 0.05, sc.cameras_extent,
                                  opt.percent_dense, until + 1 > opt.opacity_reset_interval), smi)
    except RuntimeError as e:
        fails.append(str(e))
    if fails:
        raise RuntimeError(f"the card against the CPU at the trained state: {fails}")


def step_diffs(a, a_loss, b, b_loss, st0, act, stats: bool = False) -> dict:
    """How far step result `a` lies from `b` (both (TrainParams, AdamState,
    GaussianState) on the CPU), over the active slots: the loss, relative;
    each moment field, max |a - b| / max |b| and, as "(L2)", |a - b| / |b|;
    each param field where b's step gradient ((mu - b1 mu0) / (1 - b1))
    exceeds 1e-3 of its largest, max |a - b| / (|b| + max |b|) and the L2
    form; with
    `stats`, grad_accum and grad_abs_accum as the moments."""
    from gof_tpu_torch import train

    def rel(out, key, x, y):
        out[key] = float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
        out[f"{key} (L2)"] = float((x - y).norm()) / max(float(y.norm()), 1e-30)

    out = {"loss": abs(a_loss - b_loss) / max(abs(b_loss), 1e-30)}
    for f in train.GAUSS_FIELDS:
        for m in ("mu", "nu"):
            rel(out, f"{m}.{f}", getattr(getattr(a[1], m), f)[act].double(),
                getattr(getattr(b[1], m), f)[act].double())
        grad = (getattr(b[1].mu, f)[act].double() - 0.9 * getattr(st0.mu, f)[act].double()) / 0.1
        sel = grad.abs() > 1e-3 * grad.abs().max()
        if sel.any():
            x = getattr(a[0].gauss, f)[act].double()[sel]
            y = getattr(b[0].gauss, f)[act].double()[sel]
            out[f"params.{f}"] = float(((x - y).abs() / (y.abs() + y.abs().max())).max())
            out[f"params.{f} (L2)"] = float((x - y).norm()) / max(float(y.norm()), 1e-30)
    if stats:
        for f in ("grad_accum", "grad_abs_accum"):
            rel(out, f"stats.{f}", getattr(a[2], f)[act].double(), getattr(b[2], f)[act].double())
    return out


# the trajectory phase: rung 0 on the card against the port on the host's
# CPU, both drawing the CPU's densify noise, with the same camera order.
# Set before the phase's first run: at every densify call the active count
# before and after lies within TRAJECTORY_RTOL of the CPU's (the slow
# test's PARITY_RTOL, which the port and gof_tpu met at 0.98% on this rung),
# each other count of the breakdown within TRAJECTORY_RTOL of the CPU's
# active count before the call, and Q within TRAJECTORY_Q_RTOL of the CPU's
TRAJECTORY_RTOL = 0.05
TRAJECTORY_Q_RTOL = 0.25
# the CPU run's threads, beside the card's phases that run meanwhile
TRAJECTORY_THREADS = 4


def rung_argv(rung: int) -> list:
    """A ladder rung's train argv for a run through full_train: --quiet
    dropped, since run_gates reads the loop's culling print."""
    return [a for a in RUNGS[rung]["argv"] if a != "--quiet"]


def rung_scene(rung: int, root: str) -> str:
    """The rung's procedural scene in root/scene_r<rung> (written if absent)."""
    from gof_tpu_torch.scripts import make_procedural_scene as mps

    scene = os.path.join(root, f"scene_r{rung}")
    if not os.path.exists(os.path.join(scene, "gt_mesh.ply")):
        mps.main(["--out", scene, *RUNGS[rung]["scene"]])
    return scene


def trajectory_record(rec: RunRecorder, wall: float) -> dict:
    """A recorded run's densify calls (iteration, size-prune flag,
    breakdown), opacity resets, pool growths, keys per step (the most in
    each 1000-step window and in the run) and wall time, as JSON."""
    return {"wall": wall, "resets": rec.resets, "grows": rec.grows,
            "keys_max": max((w["keys_max"] for w in rec.windows), default=0),
            "keys_windows": [[w["to"], w["keys_max"]] for w in rec.windows],
            "densify": [{"iter": d["iter"], "use_size": d["use_size"], **d["breakdown"]}
                        for d in rec.densify]}


def trajectory_cpu(out: str) -> None:
    """python3 chip_smoke.py --trajectory-cpu OUT: rung 0 (OUT/scene_r0,
    written by the caller) through train.main --cpu with a RunRecorder and
    the loop's own noise, on TRAJECTORY_THREADS threads; writes
    OUT/cpu.json (trajectory_record)."""
    from gof_tpu_torch import train

    torch.set_num_threads(TRAJECTORY_THREADS)
    rec = RunRecorder()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for p in rec.patches():
            stack.enter_context(p)
        train.main(["-s", os.path.join(out, "scene_r0"), "-m", os.path.join(out, "cpu"),
                    *RUNGS[0]["argv"], "--cpu"])
    with open(os.path.join(out, "cpu.json"), "w") as f:
        json.dump(trajectory_record(rec, time.perf_counter() - t0), f)


def trajectory_start(root: str) -> dict:
    """The trajectory phase's first half: rung 0's scene and the CPU run
    (trajectory_cpu) started in a process of its own; the card's phases go
    on meanwhile."""
    t0 = time.perf_counter()
    out = os.path.join(root, "trajectory")
    os.makedirs(out, exist_ok=True)
    rung_scene(0, out)
    with open(os.path.join(out, "cpu.log"), "w") as log:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--trajectory-cpu",
                                 out], stdout=log, stderr=subprocess.STDOUT)
    return {"out": out, "proc": proc, "secs": time.perf_counter() - t0}


def trajectory_card(traj: dict, smi: str) -> None:
    """Rung 0 on the card through full_train (the schedule's gates), drawing
    the CPU's densify noise (RunRecorder's cpu_noise)."""
    t0 = time.perf_counter()
    trained = full_train(os.path.join(traj["out"], "scene_r0"), os.path.join(traj["out"], "card"),
                         rung_argv(0), smi, "trajectory", cpu_noise=True)
    traj["card"] = trajectory_record(trained["rec"], trained["wall"])
    traj["secs"] += time.perf_counter() - t0


def trajectory_finish(traj: dict, smi: str, timeout: float = 600.0) -> None:
    """The trajectory phase's second half: waits for the CPU run and holds
    the card's densify calls to it: the same iterations and size-prune
    flags, each count within the bounds above (TRAJECTORY_RTOL,
    TRAJECTORY_Q_RTOL)."""
    t0 = time.perf_counter()
    proc = traj["proc"]
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    path = os.path.join(traj["out"], "cpu.json")
    if rc != 0 or not os.path.exists(path):
        with open(os.path.join(traj["out"], "cpu.log")) as f:
            log = f.read()[-4000:]
        raise RuntimeError(f"trajectory: the CPU run failed (rc {rc}):\n{log}")
    with open(path) as f:
        cpu = json.load(f)
    card = traj["card"]
    bad = []
    if [(d["iter"], d["use_size"]) for d in card["densify"]] != [
            (d["iter"], d["use_size"]) for d in cpu["densify"]] or card["resets"] != cpu["resets"]:
        bad.append("the densify calls or resets differ")
    worst = {}
    for a, b in zip(card["densify"], cpu["densify"]):
        for k in BREAKDOWN + ("Q",):
            scale = (b[k] if k in ("before", "after", "Q") else b["before"])
            rtol = TRAJECTORY_Q_RTOL if k == "Q" else TRAJECTORY_RTOL
            share = abs(a[k] - b[k]) / max(rtol * abs(scale), 1e-30)
            worst[k] = max(worst.get(k, 0.0), share)
            if share > 1 or not a["accounted"] or not b["accounted"]:
                bad.append(f"densify {b['iter']}: {k} card {a[k]}, CPU {b[k]}")
        print(f"  trajectory densify {b['iter']}: card / CPU " + ", ".join(
            f"{k} {a[k]} / {b[k]}" for k in BREAKDOWN) + f", Q {a['Q']:.6e} / {b['Q']:.6e}")
    final = [r["densify"][-1]["after"] if r["densify"] else None for r in (card, cpu)]
    print(f"trajectory: rung 0 (96x64, 8 views, 300 steps) on the card ({card['wall']:.2f} s) "
          f"against the port on the CPU ({cpu['wall']:.2f} s, {TRAJECTORY_THREADS} threads, "
          f"alongside the card's phases), {len(cpu['densify'])} densify calls, resets "
          f"{cpu['resets']}; final active card {final[0]} / CPU {final[1]}; largest share of "
          f"its bound per quantity "
          + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()) + f"; card {smi}")
    traj["secs"] += time.perf_counter() - t0
    print(f"trajectory phase: {traj['secs']:.1f} s on the main path (the CPU run overlapped)")
    if bad:
        raise RuntimeError(f"trajectory: the card parts from the CPU: {bad[:20]}")


def ladder_main(path: str, rungs=None) -> None:
    """python3 chip_smoke.py --ladder DIR [--rungs N ...]: the ladder's card
    runs (ROADMAP C27): each rung named (all by default) through full_train
    on the card drawing the CPU's densify noise (the same noise as the
    port's CPU runs of the rung), then the full-size procedural scene
    through SHORT_ARGS (the full_run phase's training, the card's own noise,
    and stage_gaps at its last checkpoint) and through each named rung's
    schedule in FULL_SIZE_RUNGS, in a temporary directory;
    DIR/ladder_card.json holds each run's trajectory_record, written after
    every run."""
    smi = preflight()
    build()
    os.makedirs(path, exist_ok=True)
    root = tempfile.mkdtemp(prefix="gof_ladder_")
    out = {"card": smi}
    rungs = list(RUNGS) if rungs is None else rungs

    def record(key, trained):
        out[key] = trajectory_record(trained["rec"], trained["wall"])
        with open(os.path.join(path, "ladder_card.json"), "w") as f:
            json.dump(out, f, indent=1)

    try:
        for rung in rungs:
            record(f"r{rung}", full_train(rung_scene(rung, root),
                                          os.path.join(root, f"card_r{rung}"), rung_argv(rung),
                                          smi, f"ladder rung {rung}", cpu_noise=True))
        scene, _ = dtu_scene(root, smi)
        run = os.path.join(root, "full_run")
        trained = full_train(scene, run, SHORT_ARGS, smi, "ladder full_run")
        record("full_run", trained)
        for rung in (r for r in rungs if r in FULL_SIZE_RUNGS):
            record(f"full_r{rung}", full_train(scene, os.path.join(root, f"full_r{rung}"),
                                               rung_argv(rung), smi,
                                               f"ladder full size, rung {rung}'s schedule"))
        # C29 on the witness's crop and seeded share of the gaussians
        from gof_tpu_torch import train

        it = trained["sched"]["iterations"]
        cap = train.load_checkpoint(os.path.join(run, f"chkpnt{it}.pkl"))[2].active.shape[0]
        keep = (torch.rand(cap, generator=torch.Generator().manual_seed(SEED))
                < 1 / FULL_RUN_CPU_KEEP)
        stage_gaps(run, it, crop_view(*trained["rec"].last[:2], CARD_CPU_CROP), keep,
                   "C29 at the full_run state")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def full_run_phase(scene: str, root: str, smi: str) -> list:
    """The default schedule compressed (SHORT_ARGS) on the chain phase's
    procedural scene through train.main, held to run_gates; then K2, K1,
    K3 and K4 at its shapes (trained_kernels), the mesh path's first field
    evaluation (the tetra points of its PLY over the 36 training views,
    K5's launches counted), K5 at test view 0 and the card against the CPU
    at its last checkpoint. Returns the kernels-line entries."""
    from gof_tpu_torch.mesh import extract

    t0 = time.perf_counter()
    run = os.path.join(root, "full_run")
    trained = full_train(scene, run, SHORT_ARGS, smi, "full_run")
    kernels = trained_kernels(run, trained, "full_run", smi)
    cfg, g, s, cams, meta = load_model(run, "cuda")
    pts, _ = extract.get_tetra_points(g, s, meta)
    ev = extract.FieldEvaluator(g, s, cams, cfg.sh_degree, cfg.kernel_size)
    alpha, launches, secs = stage_launches(ev.alpha, pts)
    print(f"full_run: field at {len(pts)} tetra points over {len(cams)} views in {secs:.2f} s; "
          f"launches {launches}; alpha in [{alpha.min():.4f}, {alpha.max():.4f}]")
    if launches["integrate"] < len(cams) or not np.isfinite(alpha).all():
        raise RuntimeError("full_run: the field evaluation did not run through K5")
    del g, s, ev
    kernels.append(trained_integrate(run, launches, "full_run"))
    trained_card_vs_cpu(run, trained, smi, keep_every=FULL_RUN_CPU_KEEP)
    print(f"full_run phase: {time.perf_counter() - t0:.1f} s")
    return kernels


def full_chain(run: str, scene: str, smi: str) -> dict:
    """The full run's chain, each stage through its CLI's main on the card:
    render_cli --skip_train, metrics, extract_mesh (marching tets and an
    8-step binary search), extract_mesh_tsdf FULL_TSDF, the geometry score of
    both meshes, summarize_run. Returns the stage seconds, the file
    metrics, the mesh and TSDF results, the scores and K5's launches."""
    from gof_tpu_torch import extract_mesh, metrics, render_cli
    from gof_tpu_torch.scripts import summarize_run

    it = 30_000
    secs = {}
    stats, launches, secs["render_cli"] = stage_launches(render_cli.main,
                                                         ["-m", run, "--skip_train"])
    print(f"full run: render_cli {len(stats['test'])} test views in {secs['render_cli']:.2f} s, "
          f"ms {[round(s['ms'], 2) for s in stats['test']]}; launches {launches}; card {smi}")
    t0 = time.perf_counter()
    metrics.main(["-m", run])
    secs["metrics"] = time.perf_counter() - t0
    res = json.load(open(os.path.join(run, "results.json")))[f"ours_{it}"]
    print(f"full run: metrics in {secs['metrics']:.2f} s: {res}")
    mesh, mesh_launches, secs["extract_mesh"] = stage_launches(extract_mesh.main, ["-m", run])
    print(f"full run: extract_mesh in {secs['extract_mesh']:.2f} s: tetra points "
          f"{mesh['tetra_points']}, tets {mesh['tets']}, crossing edges "
          f"{mesh['crossing_edges']}, {mesh['vertices']} vertices, {mesh['faces']} faces; stage s "
          + ", ".join(f"{k} {v:.3f}" for k, v in mesh["seconds"].items())
          + f"; launches {mesh_launches}; card {smi}")
    t0 = time.perf_counter()
    tsdf = dtu_tsdf(run, FULL_TSDF, "full run dense", smi)
    secs["extract_mesh_tsdf"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    geo = dtu_geometry(run, scene, "full run", smi, iteration=it, gate=False)
    secs["eval_procedural_geometry"] = time.perf_counter() - t0
    summarize_run.main([run])
    print("full run: stage s " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    return {"secs": secs, "metrics": res, "mesh": mesh, "tsdf": tsdf, "geometry": geo,
            "mesh_launches": mesh_launches}


def stage(failed: list, name: str, fn, *args):
    """fn(*args), or None with the traceback printed and `name` appended to
    `failed` where it raises."""
    import traceback

    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 -- reported, and the run fails at its end
        traceback.print_exc()
        failed.append(f"{name}: {e}")
        return None


def full_main(path: str | None) -> None:
    """python3 chip_smoke.py --full [DIR]: the full-length run (A.20). The
    procedural scene (DIR/scene, written if absent), train.main with
    FULL_ARGS into DIR/run (resumed from the newest checkpoint there, if
    any), the chain (full_chain), K1-K5 at the trained shapes, the card
    against the CPU and float64 at chkpnt15000 and chkpnt30000, and
    FULL_GATES. DIR defaults to a
    temporary directory, removed at the end."""
    smi = preflight()
    build()
    t_all, failed = time.perf_counter(), []
    root = path or tempfile.mkdtemp(prefix="gof_full_run_")
    os.makedirs(root, exist_ok=True)
    try:
        scene, run = os.path.join(root, "scene"), os.path.join(root, "run")
        if not os.path.exists(os.path.join(scene, "gt_mesh.ply")):
            from gof_tpu_torch.scripts import make_procedural_scene as mps

            res = mps.main(["--out", scene])
            print(f"full run: scene {res['train_views']} train + {res['test_views']} test views "
                  f"at {res['width']}x{res['height']}, {res['points']} points, written in "
                  f"{res['seconds']:.1f} s")
        start = newest_checkpoint(run)
        sched = run_schedule(FULL_ARGS)
        if start and start[0] >= sched["iterations"]:
            print(f"full run: {start[1]} exists; training skipped")
            trained = {"sched": sched, "launches": {c.name: 0 for c in train_counters()},
                       "evals": {}}
        else:
            if start:
                print(f"full run: resuming from {start[1]} (a fresh densify noise stream and "
                      "liveness cache: a split run is another run than an unsplit one)")
            trained = full_train(scene, run, FULL_ARGS, smi, "full run",
                                 start=start[1] if start else None, strict=False)
            failed += [f"schedule: {b}" for b in trained["bad"]]
        recs = [json.loads(x) for x in open(os.path.join(run, "train_log.jsonl"))]
        evals = {r["iter"]: r["eval"] for r in recs if "eval" in r}
        # each stage after training runs even where one before it failed, so
        # that one run of 30k steps reports all it can
        chain = stage(failed, "chain", full_chain, run, scene, smi) or {}
        kernels = stage(failed, "K1-K4", trained_kernels, run, trained, "trained", smi) or []
        if chain.get("mesh_launches"):
            kernels.append(stage(failed, "K5", trained_integrate, run, chain["mesh_launches"],
                                 "trained"))
        stage(failed, "card against CPU", trained_card_vs_cpu, run, trained, smi, 1,
              FULL_CARD_CPU_CROP)
        geo = chain.get("geometry", {})
        got = {"eval PSNR at 30k": evals.get(sched["iterations"], {}).get("psnr", float("nan")),
               "final active gaussians": [r for r in recs if "loss" in r][-1]["points"],
               "TSDF F@0.02": geo.get("tsdf", {}).get("fscore", float("nan")),
               "marching-tets F@0.02": geo.get("marching_tets", {}).get("fscore", float("nan"))}
        for name, (lo, hi) in FULL_GATES.items():
            ok = got[name] >= lo and (hi is None or got[name] <= hi)
            print(f"gate {name}: {got[name]} in [{lo}, {'inf' if hi is None else hi}]: {ok}")
            if not ok:
                failed.append(f"gate {name}")
        print(f"full run: evals {evals}; file metrics {chain.get('metrics')}; wall "
              f"{time.perf_counter() - t_all:.1f} s, build included ({smi})")
    finally:
        if path is None:
            shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"kernels": [k for k in kernels if k]}))
    print(smi)
    if failed:
        raise RuntimeError(f"full run: failed {failed}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def serve_phase(root: str):
    """Steps 3-5: the serving model in `root`, the render CLI over its test
    views, and the forward kernels held against their plain versions at one
    view's shapes (the preprocess kernel also on a 3M model with SH bands
    1-3). Returns (model directory, per-view stats, kernels-line entries)."""
    t0 = time.perf_counter()
    model = write_inputs(root, N_GAUSSIANS, WIDTH, HEIGHT, N_VIEWS)
    print(f"model: {N_GAUSSIANS} gaussians, {N_VIEWS} views at {WIDTH}x{HEIGHT} "
          f"written in {time.perf_counter() - t0:.1f} s")
    stats, launches = serve(model, N_VIEWS, "cuda")
    out, expand_in, raster_in, pre_in = view_inputs(model, "cuda")
    check_render(out, WIDTH, HEIGHT)
    check_small_scene()
    kernels = check_preprocess(pre_in, launches, "serve")
    g3m, s3m = sh_model(PRE_BIG, SEED)
    kernels += check_preprocess((g3m, s3m, pre_in[2], pre_in[3]), launches, "3M, SH bands 1-3")
    del g3m, s3m, pre_in
    kernels.append(check_kernels(expand_in, raster_in, launches, True, "serve")[1])
    profile_renders(model, N_VIEWS)
    return model, stats, kernels


def serve_main() -> None:
    """--serve: steps 1-5 alone."""
    smi = preflight()
    build()
    root = tempfile.mkdtemp(prefix="gof_chip_smoke_")
    try:
        _, stats, kernels = serve_phase(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"render ms per view: {[s['ms'] for s in stats]}")
    print(json.dumps({"kernels": kernels}))
    print(smi)


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--full", nargs="?", const="", default=None, metavar="DIR",
                        help="run only the full-length run (A.20) and its chain, in DIR "
                             "(resumed from its newest checkpoint) or a temporary directory")
    parser.add_argument("--ladder", metavar="DIR",
                        help="run only the C27 ladder's card runs (ladder_main), in DIR")
    parser.add_argument("--rungs", type=int, nargs="+", choices=sorted(RUNGS), metavar="N",
                        help="with --ladder, only these rungs (default: all)")
    parser.add_argument("--serve", action="store_true",
                        help="run only steps 1-5: the build, the serving run and the forward "
                             "kernels' checks")
    parser.add_argument("--trajectory-cpu", metavar="DIR", help=argparse.SUPPRESS)
    ns = parser.parse_args()
    if ns.serve:
        serve_main()
        return
    if ns.trajectory_cpu:
        trajectory_cpu(ns.trajectory_cpu)
        return
    if ns.full is not None:
        full_main(ns.full or None)
        return
    if ns.rungs and not ns.ladder:
        parser.error("--rungs needs --ladder")
    if ns.ladder:
        ladder_main(ns.ladder, ns.rungs)
        return
    smi = preflight()
    build()
    root = tempfile.mkdtemp(prefix="gof_chip_smoke_")
    traj = None
    try:
        traj = trajectory_start(root)
        trajectory_card(traj, smi)
        model, stats, serve_kernels = serve_phase(root)

        t0 = time.perf_counter()
        src, xyz0 = write_train_scene(root, N_GAUSSIANS, WIDTH, HEIGHT)
        print(f"train scene: {TRAIN_VIEWS} + {N_VIEWS} views at {WIDTH}x{HEIGHT}, "
              f"{N_GAUSSIANS} points, written in {time.perf_counter() - t0:.1f} s")
        trained = os.path.join(root, "trained")
        launches, _, _ = train_entry(src, trained, xyz0)
        serve_trained(trained)
        densified = os.path.join(root, "densified")
        saved, densify_inputs = densify_entry(src, densified, smi)
        resume_entry(src, densified, saved)
        grown_kernels = densify_card_vs_cpu(src, densify_inputs, smi)
        live_kernels = liveness_phase(src, root, smi)
        chain = dtu_chain(root, smi)
        mesh_model = chain["model"]
        _, mesh_launches = mesh_entry(mesh_model)
        if mesh_launches is None:
            print("mesh: the chain model's field crosses 0.5 nowhere; extracting the "
                  "serving model instead")
            mesh_model = model
            _, mesh_launches = mesh_entry(model)
            if mesh_launches is None:
                raise RuntimeError("the serving model's field crosses 0.5 nowhere either")
        # K5 at view 0 of the 12-step model of 100k gaussians (the inputs of
        # the "integrate" entry since its redesign) and of the mesh path's model
        integrate_kernels = [check_integrate(trained, mesh_launches, "integrate"),
                             check_integrate(mesh_model, mesh_launches, "integrate (chain model)"
                                             if mesh_model == chain["model"] else
                                             "integrate (serving model)")]
        parallel_phase(src, root, mesh_model, smi)
        check_small_mesh()
        dtu_geometry(chain["model"], chain["scene"], "marching tets and sparse TSDF", smi)
        dtu_geometry(chain["dense_model"], chain["scene"], "dense TSDF", smi)
        dtu_card_vs_cpu(chain, smi)
        full_kernels = full_run_phase(chain["scene"], root, smi)
        del chain
        probe_kernels = probe_phase()
        ins = bench_phase("densify", True, False, 5000, launches)
        print("  kernels against their plain versions at this view's shapes:")
        kernels = train_kernels(ins, "densify", True, False, launches)
        profile_kernel_calls(ins, probes=True)
        ins = bench_phase("regularize", False, True, 20000, launches)
        print("  kernels against their plain versions at this view's shapes:")
        kernels += train_kernels(ins, "regularize", False, True, launches)[1:]
        profile_kernel_calls(ins, probes=False)
        del ins
        bench_kernels = port_bench_phase(smi)
        trajectory_finish(traj, smi)
    finally:
        if traj is not None and traj["proc"].poll() is None:
            traj["proc"].kill()
            traj["proc"].wait()
        shutil.rmtree(root, ignore_errors=True)
    print(f"render ms per view: {[s['ms'] for s in stats]}")
    print(json.dumps({"kernels": kernels + grown_kernels + live_kernels
                      + serve_kernels + integrate_kernels + probe_kernels + bench_kernels
                      + full_kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
