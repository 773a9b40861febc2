#!/usr/bin/env python3
"""Time the shipped designs of K8 (onehot_gather) and K9 (scat) beside the
designs measured and not shipped, on one CUDA GPU, from the repository root:

    python3 probe_steps.py [--rounds 3] [--out build/probe_steps/steps.json]

- K8 as built: a counting sort of the rows by k-step, then per 64 sorted
  rows one wgmma per k-step they hit. "no sort": each warp walks the
  distinct k-steps of its own 16 rows (at most 16, found by ballot) on
  mma.sync, with B fragments read from the rounded, transposed table in L2.
- K9 as built: one 16-byte vector reduction per 16 bytes of a row. "bulk":
  rows staged in shared memory, then one cp.reduce.async.bulk of W * 4
  bytes per row.

Each variant is csrc/gather_probes.cu with kernels added and the body of a
named host function (`onehot_passes`, `gof_scat`) replaced, built as
blend_steps.py builds its variants (one nvcc each, in parallel). All run
through the same C entry point on pallas_gather_probe's inputs (its shapes
and draws, with buffers allocated once): K8 must equal its plain version bit
for bit, K9 lie within rtol 1e-5 / atol 1e-5 x max |plain| of it. They are
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


def variants():
    from blend_steps import body, const

    return {
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
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "probe_steps", "steps.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("probe_steps: needs a CUDA device")
    sys.path.insert(0, ROOT)
    from blend_steps import build_variants
    from gof_tpu_torch.ops import cuda_lib
    from gof_tpu_torch.ops import gather_probes as gp
    from gof_tpu_torch.scripts import pallas_gather_probe as pgp
    from gof_tpu_torch.utils.timing import time_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {smi}")
    libs = build_variants("gather_probes.cu", variants())
    for name, (_, log) in libs.items():
        fn = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '\w*?\d+((onehot|scat)\w*?_kernel)", line)
            if m or "Compiling entry" in line:
                fn = m.group(1) if m else None
            elif fn and "registers" in line:
                print(f"  ptxas {name}: {fn}: {line.split('info    :')[-1].strip()}")

    page, chunk, nchunk, page_b = 16384, 2048, 256, 2048
    table_np, idx_np, rows_np = pgp.inputs(page, chunk, nchunk)
    dev = torch.device("cuda", torch.cuda.current_device())
    table, idx, rows = (torch.from_numpy(x).to(dev) for x in (table_np, idx_np, rows_np))
    n, w = idx.numel(), table.shape[1]
    nb = page // 16 + 1
    tB = torch.empty(page * w, dtype=torch.bfloat16, device=dev)
    ws = torch.empty(2 * nb + 1, dtype=torch.int32, device=dev)
    srt = torch.empty((n, 2), dtype=torch.int32, device=dev)
    out8 = torch.empty((n, w), device=dev)
    out9 = torch.empty((page, w), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    want8 = gp.onehot_gather_reference(idx, table, page_b)
    want9 = gp.scat_reference(idx, rows, page)
    sig = cuda_lib._SIGNATURES

    def entry(path, name):
        fn = getattr(ctypes.CDLL(path), name)
        fn.argtypes = list(sig[name])
        fn.restype = ctypes.c_int

        def call(*a):
            rc = fn(dev.index, *a, stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")
        return call

    calls = {}
    for name, (path, _) in libs.items():
        if name.startswith("K8"):
            f = entry(path, "gof_onehot_gather")
            call = (lambda f=f: f(idx.data_ptr(), n, table.data_ptr(), page, w, tB.data_ptr(),
                                  ws.data_ptr(), srt.data_ptr(), out8.data_ptr()))
            call()
            ok = bool(torch.equal(out8, want8))
        else:
            f = entry(path, "gof_scat")
            call = (lambda f=f: (out9.zero_(), f(idx.data_ptr(), n, rows.data_ptr(), w, page,
                                                 out9.data_ptr())))
            call()
            ok = pgp.within(out9, want9)
        torch.cuda.synchronize()
        print(f"{name}: {'bit-equal to' if name.startswith('K8') else 'within tolerance of'} "
              f"its plain version: {ok}")
        if not ok:
            raise RuntimeError(f"{name} disagrees with its plain version")
        calls[name] = call

    times = {name: [] for name in calls}
    for _ in range(args.rounds):  # in turns
        for name, fn in calls.items():
            times[name].append(time_ms(fn, [()], dev, 20, 2))
    res = {"device": smi, "rounds": args.rounds, "ms": times}
    for name, ts in times.items():
        print(f"{name:48s} {statistics.median(ts):8.4f} ms  rounds {[round(t, 4) for t in ts]}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
