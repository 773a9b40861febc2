"""Benchmark: the full production train step (counterpart of bench.py).

    python -m gof_tpu_torch.bench [--gaussians N] [--width W] [--height H]
        [--reps R] [--late | --no-late] [--orbit N_CAMS] [--cpu]

The step timed is the one train.py runs (`train.build_train_step`: render
forward -> L1 + SSIM (+ regularizers) -> backward through the kernels ->
per-group Adam, the appearance state included -> densification statistics)
on bench.py's synthetic bicycle-like scene: `make_state`'s gaussians, one
look-at camera, a seeded random ground truth, a black background.

Points, as bench.py's: the headline (100k gaussians at 1237x822 by
default); with --late, "late" (1M gaussians, ~3.2M keys) and "late3m" (3M,
~10M keys); with --orbit N, N cameras on an orbit around a 1M-gaussian
state in the late phase, each with its row of the temporal liveness cache,
so every bound is exactly one epoch stale. Each configured point times
bench.py's two phases from fresh copies of the state: statistics on and
the regularizers off at step 5000, then statistics off and the regularizers
on at step 20000; one warm step, then `reps` steps with one
synchronisation at the end, and the mean. Its rate is 1 / the mean of the
two phase means. The orbit takes two warm epochs, one more, then
max(reps // N, 3) timed epochs with one synchronisation at the end.

The last line of stdout is one JSON object with bench.py's keys; every
other line goes to stderr and starts with "#". `vs_baseline` divides by
11.1 it/s, the original CUDA code's bicycle run (30k steps in ~45 min on an
unnamed GPU). A point that fails raises.

What bench.py has and this module does not, since the port sizes its key
slots, compacted rows and live list from each view's demand (ROADMAP C18):
the XLA compile cache, `fit_capacities` and --capacity, the overflow
retries, and the orbit's scan-window dispatch and live-capacity
right-sizing. The demands those sized are printed instead.

Runs on the card unless given --cpu; without CUDA it raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import cameras
from . import config as config_lib
from . import sh
from . import train
from .model import appearance as app_lib
from .model import gaussians as gm
from .ops import binning
from .scripts import pick_device

BASELINE_ITERS_PER_SEC = 11.1
# (key prefix, gaussians, log-scale mean) of the late-training points
LATE_POINTS = (("late", 1_000_000, -4.3), ("late3m", 3_000_000, -4.8))
ORBIT_GAUSSIANS = 1_000_000
ORBIT_SIGMA = -4.3
# bench.py's two phases: (with_stats, with_reg, step)
PHASES = {"densify": (True, False, 5000), "regularize": (False, True, 20000)}
ORBIT_STEP = 20000


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def make_state(n: int, rng: np.random.Generator, spread: float = 1.0, sigma: float = -3.2):
    """bench.py's synthetic scene: n active gaussians (SH degree 3, z in
    [2, 12], random rotations, log-scales N(sigma, 0.5), opacities in
    [0.3, 0.95]), drawn from `rng` in bench.py's order. Returns gof_tpu-format
    numpy (params, state) objects for gm.from_numpy."""
    from types import SimpleNamespace

    z = rng.uniform(2, 12, n)
    xyz = np.stack([rng.uniform(-1, 1, n) * z * 0.45 * spread,
                    rng.uniform(-1, 1, n) * z * 0.3 * spread, z], -1)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    K = sh.num_sh_coeffs(3)
    dc = sh.rgb_to_sh_dc(torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32)))
    op = rng.uniform(0.3, 0.95, n)
    params = SimpleNamespace(
        xyz=xyz.astype(np.float32), features_dc=dc.numpy()[:, None, :],
        features_rest=np.zeros((n, K - 1, 3), np.float32),
        scaling=rng.normal(sigma, 0.5, (n, 3)).astype(np.float32),
        rotation=q.astype(np.float32),
        opacity=np.log(op / (1 - op)).astype(np.float32))
    zf = np.zeros((n,), np.float32)
    state = SimpleNamespace(active=np.ones((n,), bool), filter_3d=zf + 1e-4, max_radii2d=zf,
                            grad_accum=zf, grad_abs_accum=zf, denom=zf)
    return params, state


def headline_camera(width: int, height: int, device="cpu") -> cameras.Camera:
    return cameras.look_at_camera(eye=(0, 0, 0), target=(0, 0, 5.0), width=width,
                                  height=height, device=device)


def orbit_cameras(n_cams: int, width: int, height: int, device="cpu") -> list:
    """bench_orbit's cameras: eyes on an ellipse around the origin, looking
    at (0, 0, 5), uid = index."""
    return [cameras.look_at_camera(eye=(1.2 * np.sin(th), 0.35 * np.cos(th), 0.0),
                                   target=(0, 0, 5.0), width=width, height=height, uid=i,
                                   device=device)
            for i, th in enumerate(np.linspace(-0.7, 0.7, n_cams))]


class Setup:
    """bench.py's optimizer and configs, and a fresh training state from
    numpy (params, state) with an appearance network carried as bench.py
    carries it: without --use_decoupled_appearance it feeds nothing and is
    stepped with zero gradients. `app` (network, embeddings) replaces the
    one drawn from a generator seeded 0."""

    def __init__(self, params, gstate, device, app=None):
        self.params, self.gstate, self.device = params, gstate, device
        self.opt = config_lib.OptimizationParams()
        self.model_cfg = config_lib.ModelParams(sh_degree=3, kernel_size=0.1)
        self.pipe = config_lib.PipelineParams()
        self.tx = train.make_optimizer(self.opt, 5.0)
        self.app = app or app_lib.init_appearance(torch.Generator().manual_seed(0), device)

    def fresh(self):
        """(TrainParams, AdamState, GaussianState), new copies on the device."""
        g, s = gm.from_numpy(self.params, self.gstate, self.device)
        net, emb = self.app
        net_copy = app_lib.AppearanceNetwork().to(self.device)
        net_copy.load_state_dict(net.state_dict())
        tp = train.TrainParams(gauss=g, app_net=net_copy, app_emb=emb.clone())
        return tp, self.tx.init(tp), s

    def step_fn(self, with_stats: bool, with_reg: bool):
        return train.build_train_step(self.opt, self.model_cfg, self.pipe, self.tx,
                                      with_stats=with_stats, with_reg=with_reg)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_gib(device) -> str:
    if torch.device(device).type != "cuda":
        return "peak memory not measured (CPU)"
    return f"peak memory {torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB"


def bench_config(n: int, width: int, height: int, reps: int, label: str, sigma: float = -3.2,
                 verbose: bool = False, device="cuda", observe=None):
    """bench.py's bench_config: both phases at one configuration. Returns
    (iters/s, the densify phase's key count). `observe(label, phase, ctx)`,
    if given, runs after each phase's timing and before the next phase;
    ctx holds that phase's step function, its state and inputs, the number
    of steps it ran and its mean step ms."""
    rng = np.random.default_rng(1)
    params, gstate = make_state(n, rng, sigma=sigma)
    cam = headline_camera(width, height, device)
    gt = torch.from_numpy(rng.uniform(0, 1, (3, height, width)).astype(np.float32)).to(device)
    bg = torch.zeros(3, device=device)
    setup = Setup(params, gstate, device)

    def time_phase(phase):
        with_stats, with_reg, step_idx = PHASES[phase]
        step_fn = setup.step_fn(with_stats, with_reg)
        tp, st, s = setup.fresh()
        reset_peak(device)
        t0 = time.perf_counter()
        tp, st, s, m = step_fn(tp, st, s, gt, step_idx, cam, bg)  # warm
        sync(device)
        nk, demand = int(m["num_keys"]), int(m["compact_demand"])
        log(f"{label}: warm step of phase(stats={with_stats},reg={with_reg}) in "
            f"{time.perf_counter() - t0:.1f}s; slot demand {nk}, compact demand {demand}")
        t0 = time.perf_counter()
        for _ in range(reps):
            tp, st, s, m = step_fn(tp, st, s, gt, step_idx, cam, bg)
        sync(device)
        dt = (time.perf_counter() - t0) / reps
        log(f"{label} {phase}: {dt * 1e3:.3f} ms/step (mean of {reps} after 1 warm), "
            f"loss {float(m['loss']):.6f}, {peak_gib(device)}")
        if observe is not None:
            observe(label, phase, dict(step=step_fn, args=(tp, st, s, gt, step_idx, cam, bg),
                                       setup=setup, steps=reps + 1, ms=dt * 1e3,
                                       with_stats=with_stats, with_reg=with_reg))
        return dt, nk

    d_densify, nk = time_phase("densify")
    d_reg, _ = time_phase("regularize")
    mean_dt = 0.5 * (d_densify + d_reg)
    if verbose:
        log(f"{label}: gaussians={n} keys={nk} densify-phase {d_densify * 1e3:.1f} ms | "
            f"reg-phase {d_reg * 1e3:.1f} ms")
    return 1.0 / mean_dt, nk


def orbit_epoch(step_fn, state: tuple, cams: list, gts, bg, cache, step_i: int):
    """One epoch of the orbit: each camera in turn steps `state` (tp,
    opt_state, gstate) through its row of `cache`, which takes the step's
    live_new_lim. Returns (state, the next step index, packed metrics
    [n_cams, 10])."""
    tp, st, s = state
    packs = []
    for i, cam in enumerate(cams):
        tp, st, s, m = step_fn(tp, st, s, gts[i], step_i, cam, bg, lim=cache[i])
        cache[i] = m["live_new_lim"]
        step_i = m["step_next"]
        packs.append(m["packed"])
    return (tp, st, s), step_i, torch.stack(packs)


def bench_orbit(n: int, width: int, height: int, n_cams: int, reps: int, label: str,
                sigma: float = -3.2, verbose: bool = False, device="cuda", observe=None):
    """bench.py's bench_orbit: the late-training step (regularizers on,
    statistics off, from step 20000) over n_cams cameras in turn, each
    rendering through its row of a [n_cams, ntiles] liveness cache that
    starts at binning.LIM_INF and takes the step's live_new_lim, so each
    bound is exactly one epoch stale. A skipped step (a stale bound) is a
    no-op that heals the bound and counts in skip_frac. Returns (iters/s,
    keys, live_frac, skip_frac); `observe` as in bench_config, once, after
    the timed epochs."""
    rng = np.random.default_rng(1)
    params, gstate = make_state(n, rng, sigma=sigma)
    cams = orbit_cameras(n_cams, width, height, device)
    gts = torch.from_numpy(rng.uniform(0, 1, (n_cams, 3, height, width)).astype(np.float32))
    gts = gts.to(device)
    bg = torch.zeros(3, device=device)
    ntx, nty = binning.tile_grid(width, height)
    setup = Setup(params, gstate, device)
    step_fn = setup.step_fn(False, True)
    state = setup.fresh()
    cache = torch.full((n_cams, ntx * nty), binning.LIM_INF, dtype=torch.int32, device=device)
    step_i = ORBIT_STEP
    reset_peak(device)

    def run_epoch():
        nonlocal state, step_i
        state, step_i, packed = orbit_epoch(step_fn, state, cams, gts, bg, cache, step_i)
        return packed

    warm = [run_epoch() for _ in range(2)]
    packed = warm[-1].cpu().numpy()
    demand, nkeys = int(packed[:, 7].max()), int(packed[:, 2].max())
    log(f"{label}: live demand {demand} / {nkeys} keys ({demand / max(nkeys, 1):.2f})")
    t0 = time.perf_counter()
    warm.append(run_epoch())
    sync(device)
    log(f"{label}: warm epoch in {time.perf_counter() - t0:.1f}s")

    n_epochs = max(reps // n_cams, 3)
    t0 = time.perf_counter()
    packs = [run_epoch() for _ in range(n_epochs)]
    sync(device)
    dt = (time.perf_counter() - t0) / (n_epochs * n_cams)
    packed = torch.cat(packs).cpu().numpy()
    skip_frac = float(packed[:, 9].mean())  # live_inv: skipped (no-op) steps
    live_frac = float((packed[:, 7] / np.maximum(packed[:, 2], 1)).mean())
    if np.any(packed[:, 3] > 0) or np.any(packed[:, 5] > 0):
        raise AssertionError("key/compact overflow during orbit timing")
    ips = 1.0 / dt
    log(f"{label}: {dt * 1e3:.3f} ms/step (mean of {n_epochs * n_cams}), {peak_gib(device)}")
    if verbose:
        log(f"{label}: {ips:.2f} it/s steady-state | live_frac {live_frac:.3f} | skip_frac "
            f"{skip_frac:.4f} | {n_cams}-camera orbit")
    if observe is not None:
        observe(label, "orbit", dict(step=step_fn, state=state, cams=cams, gts=gts,
                                     bg=bg, cache=cache, step_next=step_i, setup=setup,
                                     packed=torch.cat(warm + packs).cpu().numpy(),
                                     steps=(3 + n_epochs) * n_cams, ms=dt * 1e3,
                                     with_stats=False, with_reg=True))
    return ips, nkeys, live_frac, skip_frac


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gaussians", type=int, default=100_000)
    ap.add_argument("--width", type=int, default=1237)
    ap.add_argument("--height", type=int, default=822)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--late", action="store_true", default=True,
                    help="also time the late-training points (1M and 3M gaussians); on by "
                         "default")
    ap.add_argument("--no-late", dest="late", action="store_false")
    ap.add_argument("--orbit", type=int, default=8,
                    help="cameras in the late-phase orbit (liveness culling under one-epoch-"
                         "stale bounds); 0 disables")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the plain versions)")
    return ap.parse_args(argv)


def main(argv=None, observe=None) -> dict:
    """Run the points, print the JSON line and return it as a dict.
    `observe` is passed to every point (bench_config)."""
    args = parse(argv)
    device = pick_device(args.cpu)
    ips, nk = bench_config(args.gaussians, args.width, args.height, args.reps, "bicycle-like",
                           verbose=True, device=device, observe=observe)
    rec = {"metric": "full_train_step_iters_per_sec", "value": round(ips, 3),
           "unit": "iters/s", "vs_baseline": round(ips / BASELINE_ITERS_PER_SEC, 3)}
    if args.late:
        for tag, n_late, sig in LATE_POINTS:
            ips, nk = bench_config(n_late, args.width, args.height, max(args.reps // 2, 5), tag,
                                   sigma=sig, verbose=True, device=device, observe=observe)
            log(f"{tag}: {ips:.2f} it/s at {nk} keys")
            rec[f"{tag}_iters_per_sec"] = round(ips, 3)
            rec[f"{tag}_keys"] = int(nk)
            rec[f"{tag}_vs_baseline"] = round(ips / BASELINE_ITERS_PER_SEC, 3)
    if args.orbit > 0:
        ips, nk, live_frac, skip_frac = bench_orbit(
            ORBIT_GAUSSIANS, args.width, args.height, args.orbit, max(args.reps, 2 * args.orbit),
            "orbit", sigma=ORBIT_SIGMA, verbose=True, device=device, observe=observe)
        rec["orbit_iters_per_sec"] = round(ips, 3)
        rec["orbit_keys"] = int(nk)
        rec["orbit_vs_baseline"] = round(ips / BASELINE_ITERS_PER_SEC, 3)
        rec["orbit_live_frac"] = round(live_frac, 4)
        rec["orbit_skip_frac"] = round(skip_frac, 5)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
