#!/usr/bin/env python3
"""Build and drive gof_tpu_torch's serving path once on one CUDA GPU.

    python3 chip_smoke.py

1. preflight: torch, CUDA, the card's name and power limit, nvcc;
2. build the CUDA kernels of gof_tpu_torch/csrc with nvcc (sm_90a);
3. make a 100k-gaussian model (bench.py's make_state recipe, seed 1, SH
   degree 3, kernel_size 0.1, filter_3d 1e-4) as a gof_tpu-format model
   directory, and a Blender-format source scene with 4 test views at
   1237x822 on bench.py's camera orbit, in a temporary directory;
4. serve: gof_tpu_torch.render_cli.main(["-m", dir, "--skip_train"]) renders
   the 4 views; the PNGs, the image values and each kernel's launch count
   over that run are checked, and a small scene's CUDA render is held
   against the plain CPU path;
5. hold each kernel against its plain PyTorch version on the card, at the
   shapes of one of those views, and time both with CUDA events; time each
   layer of that view's render, and profile a steady pass over the views;
6. print the kernels' JSON line, the card's name and power limit, and as
   the last line {"ok": true, "device": {...}}.

Exits non-zero, with no result line, if there is no CUDA device, if any
kernel fails to build or launch, or if any check fails. Needs no network.
"""

from __future__ import annotations

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
WIDTH, HEIGHT = 1237, 822
N_VIEWS = 4
SEED = 1
# tolerance of the blend kernel against its plain version: gof_tpu's own
# Pallas-vs-XLA tolerance (tests/test_rasterize.py); K2 must be bit-exact
ATOL, RTOL = 1e-5, 1e-4


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


def build() -> None:
    from gof_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    path = cuda_lib.build()
    cuda_lib.library()
    print(f"build: {path} in {time.perf_counter() - t0:.1f} s")
    for line in cuda_lib.build_log().splitlines():
        if "registers" in line or "smem" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")


def make_model(n: int, seed: int, sigma: float = -3.2):
    """bench.py::make_state's recipe in numpy, as gof_tpu-format numpy fields."""
    from gof_tpu_torch import sh

    rng = np.random.default_rng(seed)
    z = rng.uniform(2, 12, n)
    xyz = np.stack([rng.uniform(-1, 1, n) * z * 0.45,
                    rng.uniform(-1, 1, n) * z * 0.3, z], -1)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    K = sh.num_sh_coeffs(3)
    dc = sh.rgb_to_sh_dc(torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32)))
    op = rng.uniform(0.3, 0.95, n)
    from types import SimpleNamespace

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
    from gof_tpu_torch.ops import class_gather, rasterize

    counters = (class_gather.EXPAND, rasterize.FWD)
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
    """Everything the kernels see for test view 0 — the binning and its
    class-expansion inputs, payload and meta vector — plus the full render.
    On CUDA, also the device time of each layer of the render: the stages
    of ops/render.py run `reps` times between CUDA events (medians)."""
    from gof_tpu_torch import config as config_lib
    from gof_tpu_torch import render_cli
    from gof_tpu_torch.data import scene as scene_lib
    from gof_tpu_torch.model import gaussians as gm
    from gof_tpu_torch.ops import binning, quadrics, tiled_ref
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
        scales = gm.filtered_scaling(g, s.filter_3d)
        opac = gm.filtered_opacity(g, s.filter_3d)
        pre = quadrics.preprocess(g.xyz, scales, g.rotation, gm.get_features(g), 3, cam,
                                  cfg.kernel_size, s.active, opacities=opac)
        yield "preprocess", pre
        rects = binning.gaussian_rects(pre.mean2d, pre.radius, pre.valid, ntx, nty,
                                       radius_xy=pre.radius_xy)
        b = binning.bin_gaussians(pre.depth, rects, ntx, nty, mean2d=pre.mean2d,
                                  radius=pre.radius)
        yield "binning (class layout, K2 expand, sorts)", (rects, b)
        op_eff = opac * torch.where(pre.valid, pre.coef, torch.zeros_like(pre.coef))
        payload = rz.build_payload16(pre.rgb, op_eff, pre.v2g_M, pre.v2g_u0, b)
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
    pre = res["preprocess"]
    rects, b = res["binning (class layout, K2 expand, sorts)"]
    payload, meta = res["payload gather"]
    print(f"view 0: {int(b.num_keys)} keys in {int(b.num_slots)} class-padded slots, "
          f"{int(pre.valid.sum())} visible gaussians")
    ex = binning.class_expansion(pre.depth, rects, ntx * nty, pre.mean2d, pre.radius)
    P = pre.depth.shape[0]
    tbl = torch.stack(ex.cols).contiguous()
    gidx = torch.clamp(ex.gidx, 0, P - 1).to(torch.int32).contiguous()
    return out, (tbl, gidx), (payload, b, meta, ntx, ntx * nty)


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
    """Median milliseconds of fn() by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1))
    return statistics.median(ts)


def check_kernels(expand_in, raster_in, launches) -> list:
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
    results.append({"name": "expand", "route": "cuda",
                    "source": "gof_tpu_torch/csrc/expand.cu",
                    "replaces": "gof_tpu/ops/class_gather.py:56",
                    "launches": launches["expand"], "max_abs_err": 0.0,
                    "ms": ms, "plain_ms": plain_ms})

    payload, b, meta, ntx, ntiles = raster_in
    got = rz.rasterize_fwd(payload, b, meta, ntx, ntiles, with_reg=True)
    want = rz.rasterize_fwd_reference(payload, b, meta, ntx, ntiles, with_reg=True)
    torch.cuda.synchronize()
    chans = list(range(9)) + [rz.CH_TFINAL, rz.CH_DFINAL]
    err = (got[:, chans] - want[:, chans]).abs()
    tol_ok = bool((err <= ATOL + RTOL * want[:, chans].abs()).all())
    max_err = float(err.max())
    exact = {ch: int((got[:, ch] != want[:, ch]).sum())
             for ch in (rz.CH_MEDIDX, rz.CH_LIVEC, rz.CH_CSTART)}
    identical = int((got == want).all(dim=(1, 2)).sum())
    print(f"rasterize_fwd: payload {tuple(payload.shape)}, {ntiles} tiles: max |err| "
          f"{max_err:.3e} on channels 0-10, within atol {ATOL}/rtol {RTOL}: {tol_ok}; "
          f"mismatches in MEDIDX/LIVEC/CSTART {list(exact.values())}; "
          f"{identical}/{ntiles} tiles bit-identical; live windows "
          f"{int(got[:, rz.CH_LIVEC, 0].sum())}")
    if not tol_ok or any(exact.values()):
        raise RuntimeError("rasterize_fwd kernel disagrees with its plain version")
    ms = cuda_ms(lambda: rz.rasterize_fwd(payload, b, meta, ntx, ntiles), 10)
    plain_ms = cuda_ms(lambda: rz.rasterize_fwd_reference(payload, b, meta, ntx, ntiles), 3)
    print(f"rasterize_fwd: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    results.append({"name": "rasterize_fwd", "route": "cuda",
                    "source": "gof_tpu_torch/csrc/rasterize_fwd.cu",
                    "replaces": "gof_tpu/ops/rasterize_pallas.py:344",
                    "launches": launches["rasterize_fwd"], "max_abs_err": max_err,
                    "ms": ms, "plain_ms": plain_ms})
    return results


def main() -> None:
    smi = preflight()
    build()
    root = tempfile.mkdtemp(prefix="gof_chip_smoke_")
    try:
        t0 = time.perf_counter()
        model = write_inputs(root, N_GAUSSIANS, WIDTH, HEIGHT, N_VIEWS)
        print(f"model: {N_GAUSSIANS} gaussians, {N_VIEWS} views at {WIDTH}x{HEIGHT} "
              f"written in {time.perf_counter() - t0:.1f} s")
        stats, launches = serve(model, N_VIEWS, "cuda")
        out, expand_in, raster_in = view_inputs(model, "cuda")
        check_render(out, WIDTH, HEIGHT)
        check_small_scene()
        kernels = check_kernels(expand_in, raster_in, launches)
        profile_renders(model, N_VIEWS)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"render ms per view: {[s['ms'] for s in stats]}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
