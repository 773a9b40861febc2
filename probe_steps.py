#!/usr/bin/env python3
"""Time the shipped designs of K6 (take_gather), K8 (onehot_gather), K9
(scat) and K12 (rld) beside the design steps measured and not shipped, on
one CUDA GPU, from the repository root:

    python3 probe_steps.py [--rounds 3] [--kernels K6 K8 K9 K12]
                           [--out build/probe_steps/steps.json]

- K6 as built: a warp per 32 rows, one index read per row handed out by
  shuffle, 16-byte pieces, no division or multiply in the loop, 4 pieces'
  loads before their stores, streaming stores. Each step left out alone:
  4-byte pieces, 1 piece in flight (also with 4-byte pieces), plain
  stores.
- K8 as built: a counting sort of the rows by k-step, then per 64 sorted
  rows one wgmma per k-step they hit. "no sort": each warp walks the
  distinct k-steps of its own 16 rows (at most 16, found by ballot) on
  mma.sync, with B fragments read from the rounded, transposed table in L2.
- K9 as built: one 16-byte vector reduction per 16 bytes of a row. "bulk":
  rows staged in shared memory, then one cp.reduce.async.bulk of W * 4
  bytes per row.
- K12 as built: a block per 512 rows of a chunk, a warp's search for the
  offsets inside the rows' k range, a search of those per row. Left out:
  full staging (a block per chunk stages all WG offsets in shared memory
  and searches them all), 256 or 1024 rows per block, plain stores.
- The floor of a kernel that writes as much: a device-to-device `copy_`
  (which also reads as much) and a `fill_` (which only writes) of K6's
  output (64 MiB) and of K12's (16 MiB).

Each variant is csrc/gather_probes.cu with kernels added, or with a line
of `launch_gather`, a named constant or the body of a named function
(`store_stream`, `onehot_passes`, `gof_scat`, `gof_rld`) replaced, built as
blend_steps.py builds its variants (one nvcc each, in parallel). All run
through the same C entry point on the probes' inputs (pallas_gather_probe's
for K6-K9, mxu_gather_probe's for K12: their shapes and draws, with buffers
allocated once): K6, K8 and K12 must equal their plain versions bit for
bit, K9 lie within rtol 1e-5 / atol 1e-5 x max |plain| of it. They are
timed in turns, `rounds` times over the list (CUDA events, median of 20
calls each; K9's calls include zeroing the output, as its wrapper's do).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


def insert(text: str):
    """A change that adds `text` at the end of gather_probes.cu's namespace."""
    return ("gather_probes.cu", re.compile(r"\n\}  // namespace\n"),
            lambda m: "\n" + text + "\n}  // namespace\n")


NO_SORT_KERNEL = r"""
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// tT[c][k pair] = bf16(table[2 kp, c]), bf16(table[2 kp + 1, c])
__global__ void __launch_bounds__(THREADS)
onehot_tT_kernel(const float* __restrict__ table, int64_t page, int64_t w,
                 uint32_t* __restrict__ tT) {
  const int64_t half = page / 2;
  for (int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x; t < w * half;
       t += (int64_t)gridDim.x * THREADS) {
    const int64_t c = t / half, kp = t - c * half;
    const __nv_bfloat162 v =
        __floats2bfloat162_rn(__ldg(table + 2 * kp * w + c), __ldg(table + (2 * kp + 1) * w + c));
    tT[t] = *reinterpret_cast<const uint32_t*>(&v);
  }
}

// one warp per 16 rows, a block per 8 warps and 32 columns
__global__ void __launch_bounds__(THREADS)
onehot_mma_kernel(const int32_t* __restrict__ idx, int64_t n, const uint32_t* __restrict__ tT,
                  int64_t page, int64_t w, float* __restrict__ out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int64_t row0 = ((int64_t)blockIdx.x * NWARPS + warp) * 16;
  const int64_t c0 = (int64_t)blockIdx.y * 32;
  const int64_t half = page / 2;
  int ks[2], loc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = row0 + g + 8 * h;
    const int32_t ix = r < n ? idx[r] : -1;
    ks[h] = (ix >= 0 && ix < page) ? ix >> 4 : -1;
    loc[h] = ix & 15;
  }
  float acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] = 0.0f;
  // rows still to serve: bit 4g of m0 (row g), of m1 (row g + 8)
  unsigned m0 = __ballot_sync(~0u, tg == 0 && ks[0] >= 0);
  unsigned m1 = __ballot_sync(~0u, tg == 0 && ks[1] >= 0);
  while (m0 | m1) {
    const int h = m0 ? 0 : 1;
    const int k = __shfl_sync(~0u, h ? ks[1] : ks[0], __ffs(h ? m1 : m0) - 1);
    m0 &= ~__ballot_sync(~0u, tg == 0 && ks[0] == k);
    m1 &= ~__ballot_sync(~0u, tg == 0 && ks[1] == k);
    const uint32_t a[4] = {ks[0] == k ? onehot_bf16x2(loc[0] - 2 * tg) : 0u,
                           ks[1] == k ? onehot_bf16x2(loc[1] - 2 * tg) : 0u,
                           ks[0] == k ? onehot_bf16x2(loc[0] - 2 * tg - 8) : 0u,
                           ks[1] == k ? onehot_bf16x2(loc[1] - 2 * tg - 8) : 0u};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const uint32_t* col = tT + (c0 + nt * 8 + g) * half + k * 8 + tg;
      mma_bf16_16816(acc[nt], a, __ldg(col), __ldg(col + 4));
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = row0 + g + 8 * h;
    if (r >= n) continue;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      *reinterpret_cast<float2*>(out + r * w + c0 + nt * 8 + 2 * tg) =
          make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
  }
}
"""

NO_SORT_PASSES = """  (void)ws;
  (void)srt;
  onehot_tT_kernel<<<(unsigned)stride_blocks(page * w / 2), THREADS, 0, s>>>(table, page, w,
                                                                           (uint32_t*)tB);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + NWARPS * 16 - 1) / (NWARPS * 16)), (unsigned)(w / 32));
  onehot_mma_kernel<<<grid, THREADS, 0, s>>>(idx, n, (const uint32_t*)tB, page, w, out);
  return (int)cudaGetLastError();"""

BULK_KERNEL = r"""
constexpr int BULK_ROWS = 64;  // rows staged per block and step

__global__ void __launch_bounds__(THREADS)
scat_bulk_kernel(const int32_t* __restrict__ idx, int64_t n, const float4* __restrict__ rows,
                 int64_t w4, int64_t page, float4* __restrict__ out) {
  extern __shared__ __align__(128) float4 stage[];  // [2][BULK_ROWS * w4]
  int it = 0;
  for (int64_t r0 = (int64_t)blockIdx.x * BULK_ROWS; r0 < n;
       r0 += (int64_t)gridDim.x * BULK_ROWS, ++it) {
    float4* buf = stage + (it & 1) * BULK_ROWS * w4;
    // this thread's reduction that read the buffer two steps ago is done
    if (threadIdx.x < BULK_ROWS) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    __syncthreads();
    const int64_t nr = n - r0 < BULK_ROWS ? n - r0 : BULK_ROWS;
    for (int64_t t = threadIdx.x; t < nr * w4; t += THREADS) buf[t] = __ldcs(rows + r0 * w4 + t);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x < nr) {
      int64_t j = idx[r0 + threadIdx.x];
      if (j < 0) j += page;
      if (j >= 0 && j < page)
        asm volatile(
            "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
            ::"l"(out + j * w4), "r"(smem_u32(buf + threadIdx.x * w4)), "r"((uint32_t)(w4 * 16))
            : "memory");
    }
    if (threadIdx.x < BULK_ROWS) asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  if (threadIdx.x < BULK_ROWS) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
"""

BULK_SCAT = """  if (n <= 0 || w <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long w4 = w / 4;
  const int smem = (int)(2 * BULK_ROWS * w4 * 16);
  err = cudaFuncSetAttribute(scat_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long groups = (n + BULK_ROWS - 1) / BULK_ROWS;
  scat_bulk_kernel<<<(unsigned)(groups < MAX_BLOCKS ? groups : MAX_BLOCKS), THREADS, smem,
                     (cudaStream_t)stream>>>((const int32_t*)idx, n, (const float4*)rows, w4,
                                             page, (float4*)out);
  return (int)cudaGetLastError();"""


def line(old: str, new: str):
    """A change that replaces the one line of gather_probes.cu holding `old`."""
    return ("gather_probes.cu", re.compile(re.escape(old)), new)


# K12 by full staging: a block per chunk stages all WG offsets and searches them all
STAGED_RLD_KERNEL = r"""
__global__ void __launch_bounds__(THREADS)
rld_staged_kernel(const int32_t* __restrict__ off, int64_t wg, const int32_t* __restrict__ val,
                  int64_t cv, const int32_t* __restrict__ base, int64_t bstride, int64_t ch,
                  int32_t* __restrict__ out) {
  extern __shared__ int32_t soff[];
  const int64_t i = blockIdx.x;
  for (int64_t t = threadIdx.x; t < wg; t += THREADS) soff[t] = off[i * wg + t];
  __syncthreads();
  const uint32_t kbase = (uint32_t)base[i * bstride];
  for (int64_t r = threadIdx.x; r < ch; r += THREADS) {
    const int32_t k = (int32_t)(kbase + (uint32_t)r);
    int64_t lo = 0, hi = wg;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (soff[mid] <= k) lo = mid + 1;
      else hi = mid;
    }
    const int64_t w = lo - 1;
    const bool covered = w >= 0 && (w < wg - 1 || k < (1 << 30));
    const int4* v = reinterpret_cast<const int4*>(val + (covered ? w : 0) * cv);
    int4* o = reinterpret_cast<int4*>(out + (i * ch + r) * cv);
    for (int64_t q = 0; q < cv / 4; ++q) o[q] = covered ? __ldg(v + q) : make_int4(0, 0, 0, 0);
  }
}
"""

STAGED_RLD = """  if (nch <= 0 || ch <= 0 || cv <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int smem = (int)(wg * 4);
  err = cudaFuncSetAttribute(rld_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  rld_staged_kernel<<<(unsigned)nch, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)off, wg, (const int32_t*)val, cv, (const int32_t*)base, bstride, ch,
      (int32_t*)out);
  return (int)cudaGetLastError();"""


def variants():
    from blend_steps import body, const

    return {
        "K6 as built (16-byte pieces, 4 in flight, streaming stores)": ((), None),
        "K6 4-byte pieces": ((line("const bool vec = w % 4", "const bool vec = false && w % 4"),),
                             None),
        "K6 1 piece in flight": ((const("gather_probes.cu", "GATHER_UNROLL", 1),), None),
        "K6 4-byte pieces, 1 in flight": (
            (line("const bool vec = w % 4", "const bool vec = false && w % 4"),
             const("gather_probes.cu", "GATHER_UNROLL", 1)), None),
        "K6 plain stores": ((body("gather_probes.cu", "store_stream", "  *p = v;"),), None),
        "K8 as built (sort, wgmma per hit k-step)": ((), None),
        "K8 no sort (mma.sync per warp's own k-steps)": (
            (insert(NO_SORT_KERNEL), body("gather_probes.cu", "onehot_passes", NO_SORT_PASSES)),
            None),
        "K8 sort blocks of 256 threads": ((const("gather_probes.cu", "OH_SORT_THREADS", 256),),
                                          None),
        "K8 sort blocks of 1024 threads": ((const("gather_probes.cu", "OH_SORT_THREADS", 1024),),
                                           None),
        "K9 as built (16-byte vector reductions)": ((), None),
        "K9 bulk (cp.reduce.async.bulk per row)": (
            (insert(BULK_KERNEL), body("gather_probes.cu", "gof_scat", BULK_SCAT)), None),
        "K12 as built (range search, 512 rows a block)": ((), None),
        "K12 full staging (a block per chunk, all WG offsets)": (
            (insert(STAGED_RLD_KERNEL), body("gather_probes.cu", "gof_rld", STAGED_RLD)), None),
        "K12 256 rows a block": ((const("gather_probes.cu", "RLD_ROWS", 256),), None),
        "K12 1024 rows a block": ((const("gather_probes.cu", "RLD_ROWS", 1024),), None),
        "K12 plain stores": ((body("gather_probes.cu", "store_stream", "  *p = v;"),), None),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--kernels", nargs="+", default=["K6", "K8", "K9", "K12"],
                    help="the kernels whose variants to build and time")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "probe_steps", "steps.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("probe_steps: needs a CUDA device")
    sys.path.insert(0, ROOT)
    from blend_steps import build_variants
    from gof_tpu_torch.ops import cuda_lib
    from gof_tpu_torch.ops import gather_probes as gp
    from gof_tpu_torch.scripts import mxu_gather_probe as mgp
    from gof_tpu_torch.scripts import pallas_gather_probe as pgp
    from gof_tpu_torch.utils.timing import time_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {smi}")
    chosen = {name: v for name, v in variants().items() if name.split()[0] in args.kernels}
    libs = build_variants("gather_probes.cu", chosen)
    family = {"K6": "gather", "K8": "onehot", "K9": "scat", "K12": "rld"}
    for name, (_, log) in libs.items():
        fn = None
        for line_ in log.splitlines():
            m = re.search(r"Compiling entry function '\w*?_cu_\d+(\w+?_kernel\w*)'", line_)
            if "Compiling entry" in line_:
                fn = m.group(1) if m and m.group(1).startswith(family[name.split()[0]]) else None
            elif fn and "registers" in line_:
                print(f"  ptxas {name}: {fn}: {line_.split('info    :')[-1].strip()}")

    page, chunk, nchunk, page_b = 16384, 2048, 256, 2048
    table_np, idx_np, rows_np = pgp.inputs(page, chunk, nchunk)
    dev = torch.device("cuda", torch.cuda.current_device())
    table, idx, rows = (torch.from_numpy(x).to(dev) for x in (table_np, idx_np, rows_np))
    n, w = idx.numel(), table.shape[1]
    nb = page // 16 + 1
    tB = torch.empty(page * w, dtype=torch.bfloat16, device=dev)
    ws = torch.empty(2 * nb + 1, dtype=torch.int32, device=dev)
    srt = torch.empty((n, 2), dtype=torch.int32, device=dev)
    out6 = torch.empty((n, w), device=dev)
    out9 = torch.empty((page, w), device=dev)
    a = mgp.parse([])
    d = mgp.inputs(a)
    off, val, base = (torch.from_numpy(d[k]).to(dev) for k in ("off", "val", "base"))
    out12 = torch.empty((a.nch * a.ch, mgp.CV), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    sig = cuda_lib._SIGNATURES

    def entry(path, name):
        fn = getattr(ctypes.CDLL(path), name)
        fn.argtypes = list(sig[name])
        fn.restype = ctypes.c_int

        def call(*a_):
            rc = fn(dev.index, *a_, stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        return call

    # per kernel: its entry point, the call's arguments, its output, the plain version's
    # output and whether the two must be bit-equal
    setups = {
        "K6": ("gof_take_gather", lambda: (idx.data_ptr(), n, table.data_ptr(), page, w,
                                           out6.data_ptr()), out6,
               lambda: gp.take_gather_reference(idx, table), True),
        "K8": ("gof_onehot_gather", lambda: (idx.data_ptr(), n, table.data_ptr(), page, w,
                                             tB.data_ptr(), ws.data_ptr(), srt.data_ptr(),
                                             out6.data_ptr()), out6,
               lambda: gp.onehot_gather_reference(idx, table, page_b), True),
        "K9": ("gof_scat", lambda: (idx.data_ptr(), n, rows.data_ptr(), w, page,
                                    out9.data_ptr()), out9,
               lambda: gp.scat_reference(idx, rows, page), False),
        "K12": ("gof_rld", lambda: (off.data_ptr(), a.nch, a.wg, val.data_ptr(), mgp.CV,
                                    base.data_ptr(), base.shape[2], a.ch, out12.data_ptr()), out12,
                lambda: gp.rld_reference(off, val, base, a.ch), True),
    }
    calls = {}
    for name, (path, _) in libs.items():
        kern = name.split()[0]
        ename, cargs, out, plain, bit = setups[kern]
        f = entry(path, ename)
        if kern == "K9":
            call = (lambda f=f, c=cargs: (out9.zero_(), f(*c())))
        else:
            call = (lambda f=f, c=cargs: f(*c()))
        call()
        torch.cuda.synchronize()
        want = plain()
        ok = bool(torch.equal(out, want)) if bit else pgp.within(out, want)
        print(f"{name}: {'bit-equal to' if bit else 'within tolerance of'} its plain version: {ok}")
        if not ok:
            raise RuntimeError(f"{name} disagrees with its plain version")
        calls[name] = call
    floors = {}
    for kern, out in (("K6", out6), ("K12", out12)):
        if kern in args.kernels:
            src = torch.empty_like(out)
            mib = out.numel() * out.element_size() / 2**20
            floors[f"{kern} floor: copy_ of its {mib:.0f} MiB output"] = (
                lambda o=out, s_=src: o.copy_(s_))
            floors[f"{kern} floor: fill_ of its {mib:.0f} MiB output"] = (lambda o=out: o.fill_(1))
    calls.update(floors)

    times = {name: [] for name in calls}
    for _ in range(args.rounds):  # in turns
        for name, fn in calls.items():
            times[name].append(time_ms(fn, [()], dev, 20, 2))
    res = {"device": smi, "rounds": args.rounds, "ms": times}
    for name, ts in times.items():
        print(f"{name:78s} {statistics.median(ts):8.4f} ms  rounds {[round(t, 4) for t in ts]}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
