#!/usr/bin/env python3
"""Time each design step of the forward blend (K1, csrc/rasterize_fwd.cu)
and of the opacity field (K5, csrc/integrate.cu) taken out alone, on one
CUDA GPU, from the repository root:

    python3 blend_steps.py [--rounds 3] [--out build/blend_steps/steps.json]

Each variant is the shipped source with named constants or the body of a
named device function changed (K1_VARIANTS, K5_VARIANTS), or other nvcc
flags: the sources of gof_tpu_torch/csrc are copied into
build/blend_steps/<variant>/, the changes are applied, and each copy is
compiled by its own nvcc (all at once, with the library's flags, or the
variant's) into a library of its own. Every variant runs through the same C
entry point on the same inputs: K1 at bench.py's design point
(chip_smoke.bench_state: 100k gaussians at 1237x822, its look-at view) in
both instances, K5 on that model's tetra points in the same view. The
variants are timed in turns, `rounds` times over the list (CUDA events,
median of 10 calls each), and every variant's T must equal the shipped
kernel's bit for bit. Prints ptxas's registers and the blocks per SM they
allow, K5's point blocks and the spread of their segments, one line per
variant, and writes the numbers as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Each change names what it patches: a constant (`constexpr int NAME = v;`)
# or the body of a device function, from its opening brace to the closing
# brace at column 0. A change that does not match exactly once stops the
# script.


def const(file: str, name: str, value: int):
    return (file, re.compile(rf"constexpr int {name} = \d+;"),
            f"constexpr int {name} = {value};")


def body(file: str, fn: str, text: str):
    return (file, re.compile(rf"(\b{fn}\([^)]*\)\s*\{{\n).*?(?=\n\}})", re.S),
            lambda m: m.group(1) + text)


# a staged row read as 16 scalar loads, not four float4 broadcasts
SCALAR = body("windows.cuh", "load_row", """  const volatile float* f = buf + i * ROW_FLOATS;
  float v[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) v[e] = f[e];
  return {make_float4(v[0], v[1], v[2], v[3]), make_float4(v[4], v[5], v[6], v[7]),
          make_float4(v[8], v[9], v[10], v[11]), make_float4(v[12], v[13], v[14], v[15])};""")
# each staged float copied by a load and a store, not by cp.async
SYNC = body("windows.cuh", "copy4", "  *dst = __ldg(src);")


def k1_shape(ppt: int, min_blocks: int):
    return (const("rasterize_fwd.cu", "PPT", ppt),
            const("rasterize_fwd.cu", "MIN_BLOCKS", min_blocks))


K1_VARIANTS = {  # name: (changes, nvcc flags or None for the library's)
    "as built": ((), None),
    "a: no FMAs (-fmad=false)": ((), ("-fmad=false",)),
    "b: rows as 16 scalar loads": ((SCALAR,), None),
    "c: synchronous staging": ((SYNC,), None),
    "e: 4 px, 2 blocks/SM": (k1_shape(4, 2), None),
    "e: 4 px, 3 blocks/SM": (k1_shape(4, 3), None),
    "e: 2 px, 1 block/SM": (k1_shape(2, 1), None),
    "e: 8 px, 4 blocks/SM": (k1_shape(8, 4), None),
}
K5_VARIANTS = {
    "as built": ((), None),
    "b: rows as 16 scalar loads": ((SCALAR,), None),
    "c: synchronous staging": ((SYNC,), None),
    "g: 1 block of 1024 slots (4 per thread)": (
        (const("integrate.cu", "SPLIT", 1), const("integrate.cu", "PPT", 4),
         const("integrate.cu", "MIN_BLOCKS", 2)), None),
    "g: 4 blocks of 256 slots (2 per thread)": (
        (const("integrate.cu", "SPLIT", 4), const("integrate.cu", "PPT", 2)), None),
    "g: 4 blocks of 256 slots (1 per thread)": (
        (const("integrate.cu", "SPLIT", 4), const("integrate.cu", "MIN_BLOCKS", 4)), None),
    "g: 8 blocks of 128 slots, 6 blocks/SM": ((const("integrate.cu", "MIN_BLOCKS", 6),), None),
    "g: 8 blocks of 128 slots, 12 blocks/SM": ((const("integrate.cu", "MIN_BLOCKS", 12),),
                                               None),
}


def check_t(kern: str, name: str, got, want) -> None:
    """A design step taken out must keep T's bits."""
    diff = int((got != want).sum())
    if diff:
        raise RuntimeError(f"{kern} variant {name!r} changes T at {diff} pixels or points")


def apply(text: str, old: re.Pattern, new) -> str:
    out, n = old.subn(new, text)
    if n != 1:
        raise RuntimeError(f"change {old.pattern!r} matches {n} times")
    return out


def build_variants(kernel: str, variants: dict) -> dict:
    """One library per variant of `kernel` (a csrc source), built in
    parallel. Returns {name: (library path, ptxas output)}."""
    from gof_tpu_torch.ops import cuda_lib

    nvcc = cuda_lib.find_nvcc()
    jobs = {}
    for i, (name, (changes, flags)) in enumerate(variants.items()):
        d = os.path.join(ROOT, "build", "blend_steps", f"{os.path.splitext(kernel)[0]}_{i}")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(cuda_lib.CSRC, d)
        for fname, old, new in changes:
            p = os.path.join(d, fname)
            with open(p) as f:
                text = apply(f.read(), old, new)
            with open(p, "w") as f:
                f.write(text)
        lib = os.path.join(d, "variant.so")
        cmd = [nvcc, *cuda_lib.NVCC_FLAGS, *(flags or cuda_lib.SOURCES[kernel]), "-shared",
               "-o", lib, os.path.join(d, kernel)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, p) in jobs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{kernel} variant {name!r}: nvcc failed\n{log}")
        out[name] = (lib, log)
    return out


def ptxas_kernels(log: str) -> dict:
    """{kernel name: (registers, shared bytes)} from ptxas -v output."""
    res, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and fn:
            res[fn] = (int(m.group(1)), int(m.group(2)))
    return res


def blocks_per_sm(regs: int, smem: int, threads: int) -> int:
    """Resident blocks an H100 SM allows: 64K registers (allocated per warp
    in units of 256), 228 KB of shared memory (1 KB reserved per block),
    2048 threads, 32 blocks."""
    warps = threads // 32
    regs_block = warps * (-(-regs * 32 // 256) * 256)
    return min(65536 // regs_block, 233472 // (smem + 1024), 2048 // threads, 32)


def kernel_threads(src: str) -> int:
    """Threads per block of a variant's blend or field kernel, from its
    constants: 1024 pixels or point slots over SPLIT blocks (K5 only) and
    PPT per thread."""
    def get(name, default):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        return int(m.group(1)) if m else default

    return 1024 // get("SPLIT", 1) // get("PPT", None)


def k1_inputs():
    """bench.py's design point: the payload, binning and meta of its view."""
    import chip_smoke
    from gof_tpu_torch.model import gaussians as gm
    from gof_tpu_torch.ops import binning, quadrics
    from gof_tpu_torch.ops import rasterize as rz

    g, s, cam, _ = chip_smoke.bench_state()
    ntx, nty = binning.tile_grid(cam.width, cam.height)
    with torch.no_grad():
        opac = gm.filtered_opacity(g, s.filter_3d)
        pre = quadrics.preprocess(g.xyz, gm.filtered_scaling(g, s.filter_3d), g.rotation,
                                  gm.get_features(g), 3, cam, 0.1, s.active, opacities=opac)
        rects = binning.gaussian_rects(pre.mean2d, pre.radius, pre.valid, ntx, nty,
                                       radius_xy=pre.radius_xy)
        b = binning.bin_gaussians(pre.depth, rects, ntx, nty, mean2d=pre.mean2d,
                                  radius=pre.radius)
        op_eff = opac * torch.where(pre.valid, pre.coef, torch.zeros_like(pre.coef))
        payload = rz.build_payload16(pre.rgb, op_eff, pre.v2g_M, pre.v2g_u0, b)
        meta = rz._meta_vec(cam.focal_x, cam.focal_y, torch.zeros(3, device="cuda"),
                            cam.width, cam.height)
    return (g, s, cam), payload, b, meta, ntx, ntx * nty


def k5_inputs(g, s, cam):
    """The tetra points of the bench model inside its view, and K5's inputs
    there (FieldEvaluator.view_inputs)."""
    from gof_tpu_torch.mesh import extract

    meta = (cam.world_view[None], cam.focal_x.reshape(1), cam.focal_y.reshape(1),
            torch.full((1,), float(cam.width), device="cuda"),
            torch.full((1,), float(cam.height), device="cuda"))
    pts, _ = extract.get_tetra_points(g, s, meta)
    p = torch.from_numpy(pts).cuda()
    ev = extract.FieldEvaluator(g, s, [cam], 3, 0.1)
    with torch.no_grad():
        payload, b, pb = ev.view_inputs(p, cam)
    return payload, b, pb, p.shape[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "blend_steps", "steps.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("blend_steps: needs a CUDA device")
    sys.path.insert(0, ROOT)
    from gof_tpu_torch.ops import cuda_lib
    from gof_tpu_torch.ops import rasterize as rz
    from gof_tpu_torch.utils.timing import time_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {smi}")
    libs = {"K1": build_variants("rasterize_fwd.cu", K1_VARIANTS),
            "K5": build_variants("integrate.cu", K5_VARIANTS)}
    for k, vs in libs.items():
        for name, (lib, log) in vs.items():
            with open(os.path.join(os.path.dirname(lib), "rasterize_fwd.cu" if k == "K1"
                                   else "integrate.cu")) as f:
                src = f.read()
            threads = kernel_threads(src)
            for fn, (regs, smem) in ptxas_kernels(log).items():
                print(f"  ptxas {k} {name}: {fn}: {regs} registers, {smem} B smem, "
                      f"{threads} threads: {blocks_per_sm(regs, smem, threads)} blocks/SM")
    dev = torch.device("cuda", torch.cuda.current_device())
    (g, s, cam), payload, b, meta, ntx, ntiles = k1_inputs()
    fields = k5_inputs(g, s, cam)
    sig = cuda_lib._SIGNATURES

    def load(path, names):
        lib = ctypes.CDLL(path)
        for n in names:
            fn = getattr(lib, n)
            fn.argtypes = list(sig[n])
            fn.restype = ctypes.c_int
        return lib

    # K1: each variant in both instances
    out = torch.empty((ntiles, rz.OUT_CH, rz.NPIX), device=dev)
    livec = torch.empty(ntiles, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    k1 = {n: load(p, ["gof_rasterize_fwd"]) for n, (p, _) in libs["K1"].items()}

    def k1_call(lib, reg):
        return lambda: cuda_lib.check(lib.gof_rasterize_fwd(
            dev.index, payload.data_ptr(), payload.shape[1], b.bounds.data_ptr(),
            meta.data_ptr(), ntx, ntiles, reg, out.data_ptr(), livec.data_ptr(), stream),
            "variant")

    # K5: each variant
    f_payload, f_b, pb, n_points = fields
    tile = pb.block_tile.long()
    seg_s, seg_e = f_b.bounds[tile].contiguous(), f_b.bounds[tile + 1].contiguous()
    rays = torch.stack([pb.rx, pb.ry, pb.depth]).contiguous()
    tout = torch.ones(n_points, device=dev)
    k5 = {n: load(p, ["gof_integrate"]) for n, (p, _) in libs["K5"].items()}

    def k5_call(name):
        lib = k5[name]
        return lambda: cuda_lib.check(lib.gof_integrate(
            dev.index, f_payload.data_ptr(), f_payload.shape[1], seg_s.data_ptr(),
            seg_e.data_ptr(), pb.n_blocks, rays.data_ptr(), pb.rx.numel(),
            pb.point_of_slot.data_ptr(), n_points, tout.data_ptr(), stream),
            "variant")

    rows = (seg_e - seg_s).cpu().numpy()
    real = (pb.point_of_slot < n_points).reshape(pb.n_blocks, -1).sum(1).cpu().numpy()
    print(f"K5 inputs: {n_points} tetra points in view, {pb.n_blocks} blocks of 1024 slots "
          f"({int(real.sum())} real slots, {pb.n_blocks * 1024 - int(real.sum())} padding); "
          f"segment rows per block: min {rows.min()}, median {int(np.median(rows))}, "
          f"0.9-quantile {int(np.quantile(rows, 0.9))}, max {rows.max()}, sum over blocks "
          f"{int(rows.sum())}; real points per block: median {int(np.median(real))}, "
          f"blocks under a quarter full {int((real < 256).sum())}")

    # each variant's T against the shipped kernel's
    calls = {}
    for reg in (1, 0):
        want = None
        for name, lib in k1.items():
            k1_call(lib, reg)()
            torch.cuda.synchronize()
            got = out.clone()
            if want is None:
                want = got
            check_t(f"K1 REG={reg}", name, got[:, rz.CH_TFINAL], want[:, rz.CH_TFINAL])
            calls[(f"K1 REG={reg}", name)] = k1_call(lib, reg)
    want = None
    for name in k5:
        tout.fill_(1.0)
        k5_call(name)()
        torch.cuda.synchronize()
        if want is None:
            want = tout.clone()
        check_t("K5", name, tout, want)
        calls[("K5", name)] = k5_call(name)

    times = {key: [] for key in calls}
    for _ in range(args.rounds):  # in turns
        for key, fn in calls.items():
            times[key].append(time_ms(fn, [()], dev, 10, 1))
    res = {"device": smi, "rounds": args.rounds, "ms": {}}
    for (kern, name), ts in times.items():
        med = statistics.median(ts)
        res["ms"].setdefault(kern, {})[name] = ts
        base = statistics.median(times[(kern, "as built")])
        print(f"{kern:10s} {name:42s} {med:8.4f} ms ({med / base - 1:+.1%}) rounds "
              f"{[round(t, 4) for t in ts]}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
