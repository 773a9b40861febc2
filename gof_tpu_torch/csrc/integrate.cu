// Per-point transmittance through the opacity field: each block of 1024
// query point slots (block b holds slots [b * 1024, (b + 1) * 1024), all
// binned to one tile) is walked by SPLIT CUDA blocks of SUB slots.
//
// Replaces gof_tpu/ops/integrate.py::_integrate_kernel (the Pallas kernel
// launched by integrate_transmittance_pallas). Per query point, with ray
// r = (rx, ry, 1) and view depth z, over the rows [seg_s, seg_e) of the
// tile's depth-sorted gaussian list (payload layout of build_payload16: op
// in column 3, M row-major in 4:13, u0 in 13:16):
//   d = M r, t = -(u0.d) / (|d|^2 + 1e-12), t* = min(t, z),
//   a = min(0.99, op * exp(-|u0 + t* d|^2 / 2)),
//   T *= 1 - a  where t > 0.2 and a >= 1/255; no early exit.
// Each point's T is written straight to its index in the [N] output, which
// the wrapper fills with 1 first, so unprojected points stay at 1 and no
// scatter runs after the kernel.
//
// What differs from the TPU kernel: the TPU transposed each chunk on the
// MXU, formed d with a matmul, multiplied a log-doubling cumprod per chunk
// and broadcast T over 8 sublanes for Mosaic's tiling. Here T is a serial
// product in row order, rows outside the segment or inactive are skipped by
// branch (so a non-finite row of a neighbouring tile cannot leak in), and
// the chain is ray_alpha.cuh's (the forward blend's), whose operations
// round one by one, so the kernel rounds exactly as its plain version
// (ops/integrate.py::integrate_transmittance_reference).
//
// What bounds it: arithmetic. About 42 f32 operations, an IEEE divide and
// an expf per (point, gaussian) pair, every pair visited (no early exit).
// At the mesh design point (~900k tetra points of a 100k-gaussian model at
// 1237x822, ~1,300 gaussian rows per tile) that is ~1e9 pairs per view,
// while the payload is 64 bytes per row, read once per CUDA block. A
// point's T is one serial product in row order, so a block's time is its
// segment's length; a tile's points fill a prefix of its last block, and
// the padding after them (26-31% of the slots at the design point,
// PERF.md) costs more than the spread of the segments. Design:
// - each 1024-slot block is split into SPLIT CUDA blocks of SUB slots, each
//   walking the whole segment: more, shorter blocks, which balance;
// - the CUDA blocks run in blockIdx order: ordering them by segment
//   length, longest first, measured no faster (PERF.md), since the
//   padding, not the segments' spread, set the tail;
// - a CUDA block whose slots are all padding (a tile's points fill a prefix
//   of its last block) returns at once;
// - windows are staged as in the forward blend (windows.cuh: cp.async into
//   two buffers, the next window's copies running under the current
//   window's rows, a row read as four float4 broadcasts); the thread's PPT
//   points (slots tid + k * THREADS) share each row read, and their chains
//   are all formed before any point's branch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_alpha.cuh"
#include "windows.cuh"

namespace {

using windows::CHUNK;
constexpr int PBLOCK = 1024;
constexpr int SPLIT = 8;              // CUDA blocks per point block
constexpr int SUB = PBLOCK / SPLIT;   // point slots per CUDA block
constexpr int PPT = 1;                // points per thread
constexpr int THREADS = SUB / PPT;
constexpr int MIN_BLOCKS = 8;         // blocks per SM the registers must allow

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
integrate_kernel(const float* __restrict__ payload, int64_t cap,
                 const int32_t* __restrict__ bseg_s, const int32_t* __restrict__ bseg_e,
                 const float* __restrict__ rays, int64_t nslots,
                 const int32_t* __restrict__ point_of_slot, int64_t n_points,
                 float* __restrict__ out) {
  __shared__ __align__(16) float sp[2][windows::WINDOW_FLOATS];
  const int j = blockIdx.x;
  const int b = j / SPLIT;
  const int tid = threadIdx.x;
  const int64_t slot0 = (int64_t)j * SUB + tid;

  int32_t pid[PPT];
  bool real = false;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    pid[k] = point_of_slot[slot0 + k * THREADS];
    real |= pid[k] >= 0 && pid[k] < n_points;
  }
  if (!__syncthreads_or(real)) return;  // padding slots only

  const int seg_s = bseg_s[b];
  const int seg_e = bseg_e[b];
  const int base = (seg_s / CHUNK) * CHUNK;
  const int nc = windows::count(seg_s, seg_e);
  float rx[PPT], ry[PPT], z[PPT], T[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int64_t s = slot0 + k * THREADS;
    rx[k] = rays[s];
    ry[k] = rays[nslots + s];
    z[k] = rays[2 * nslots + s];
    T[k] = 1.0f;
  }

  if (nc > 0) windows::stage<THREADS>(sp[0], payload, cap, base, tid);
  for (int c = 0; c < nc; ++c) {
    windows::wait_staged();
    // publishes window c and frees the other buffer (window c - 1 is walked)
    __syncthreads();
    if (c + 1 < nc)
      windows::stage<THREADS>(sp[(c + 1) & 1], payload, cap, base + (c + 1) * CHUNK, tid);

    const float* buf = sp[c & 1];
    const int row0 = base + c * CHUNK;
    const int i0 = max(seg_s - row0, 0);
    const int i1 = min(seg_e - row0, CHUNK);
    for (int i = i0; i < i1; ++i) {
      const windows::Row p = windows::load_row(buf, i);
      const float mat[9] = {p.q1.x, p.q1.y, p.q1.z, p.q1.w, p.q2.x,
                            p.q2.y, p.q2.z, p.q2.w, p.q3.x};
      const float u[3] = {p.q3.y, p.q3.z, p.q3.w};
      ray_alpha::RayPeak r[PPT];
#pragma unroll
      for (int k = 0; k < PPT; ++k)
        r[k] = ray_alpha::ray_peak(mat, u, ray_alpha::ray_x(mat[0], mat[3], mat[6], rx[k]), ry[k]);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const ray_alpha::Alpha al = ray_alpha::alpha_at(r[k], u, p.q0.w, fminf(r[k].t, z[k]));
        if (ray_alpha::active(r[k].t, al.a)) T[k] = ray_alpha::transmit(T[k], al.a);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < PPT; ++k)
    if (pid[k] >= 0 && pid[k] < n_points) out[pid[k]] = T[k];
}

}  // namespace

extern "C" int gof_integrate(int device, const void* payload, long long cap,
                             const void* bseg_s, const void* bseg_e, int n_blocks,
                             const void* rays, long long nslots, const void* point_of_slot,
                             long long n_points, void* out, void* stream) {
  if (n_blocks <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  integrate_kernel<<<n_blocks * SPLIT, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)payload, cap, (const int32_t*)bseg_s, (const int32_t*)bseg_e,
      (const float*)rays, nslots, (const int32_t*)point_of_slot, n_points, (float*)out);
  return (int)cudaGetLastError();
}
