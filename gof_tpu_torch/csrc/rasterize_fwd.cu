// Forward ray-Gaussian blend: one block per 32x32 tile.
//
// Replaces gof_tpu/ops/rasterize_pallas.py::_fwd_kernel (the Pallas kernel
// launched by rasterize_fwd_pallas). Per pixel ray r and per gaussian of the
// tile's depth-sorted list: d = M r, t* = -(u0.d)/(d.d),
// alpha = min(0.99, op * exp(-|u0 + t* d|^2 / 2)), active if t* > 0.2 and
// alpha >= 1/255; front-to-back blend with weight alpha * T while T > 1e-4.
// Output channels as in gof_tpu: rgb + T*bg, -normalized normal, median
// depth, sum w, distortion, T, sum w*m, median visit index; CH_LIVEC and
// CH_CSTART are written by the host wrapper from `livec` (see below).
//
// Conventions kept from the TPU kernel (the backward port relies on them):
// - windows of CHUNK rows start at base = floor(seg_s / CHUNK) * CHUNK and
//   rows outside [seg_s, seg_e) are skipped; `livec` counts windows walked;
// - the median visit index is relative to base (c * CHUNK + row);
// - the early exit is a block-wide vote at window boundaries over all 1024
//   pixels of the tile, out-of-image pixels of edge tiles included;
// - inside a window T keeps multiplying through every active row after it
//   drops below 1e-4; only the contributions stop.
// The TPU kernel assigned each tile's compact start from a cursor carried
// across its in-order grid. Blocks here run concurrently, so the kernel only
// writes the per-tile window count and the wrapper takes the exclusive scan.
// Inactive and out-of-segment rows are skipped by branches, never multiplied
// by zero, so a non-finite row of a neighbouring tile cannot leak in.
//
// What bounds it: arithmetic. About 60 f32 operations, an IEEE divide and
// an expf per (pixel, gaussian) pair visited, and per contributing pair the
// accumulations (and with the regularizer channels an rsqrtf and ~30 more);
// the payload is 64 bytes per key, read once per tile. At the design point
// (1237x822, 100k gaussians: ~1.07M keys over 1014 tiles) the early exit
// leaves ~175M visited pairs. Design:
// - only the alpha/T chain has to keep the plain version's bits (T, the
//   median depth and row; the backward recomputes T and counts mismatches):
//   it is ray_alpha.cuh's, written in intrinsics nvcc never contracts, and
//   this source is built with contraction on, so the accumulations, the
//   ndc-depth divide and the distortion epilogue run on FMAs and fast
//   divides, held to the plain version by tolerance;
// - each window's 128 rows are staged by cp.async into one of two shared
//   buffers (windows.cuh) while the block blends the previous window; the
//   exit vote at the boundary is the one barrier per window, and a window
//   is prefetched only if it lies in the tile's segment;
// - a row reads back as four float4 broadcasts at fixed offsets and serves
//   the thread's PPT pixels (one column, PPT rows of the tile), whose
//   chains are all formed before any pixel's branches;
// - pixels per thread and blocks per SM (PPT, MIN_BLOCKS) were chosen by
//   timing the alternatives in each instance (blend_steps.py);
// - tiles run in blockIdx order: ordering them by window count, longest
//   first, measured slower (blend_steps.py), since the early exit, not the
//   segment, sets a tile's walk.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_alpha.cuh"
#include "windows.cuh"

namespace {

using windows::CHUNK;
constexpr int TILE = 32;
constexpr int NPIX = TILE * TILE;
constexpr int OUT_CH = 16;

constexpr float NEAR_PLANE = ray_alpha::NEAR_PLANE;
constexpr float FAR_PLANE = 100.0f;
constexpr float FAR_X_NEAR = (float)(100.0 * 0.2);
constexpr float INV_FAR_MINUS_NEAR = (float)(1.0 / (100.0 - 0.2));
constexpr float T_EPS = 1e-4f;
constexpr float MEDIAN_T = 0.5f;

// pixels per thread and the blocks per SM the registers must allow, in
// both instances (timed per instance, the same shape won in each)
constexpr int PPT = 2;
constexpr int MIN_BLOCKS = 2;
constexpr int THREADS = NPIX / PPT;
constexpr int ROWS_PER_PASS = THREADS / TILE;

template <bool REG>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fwd_kernel(const float* __restrict__ payload, int64_t cap, const int32_t* __restrict__ bounds,
           const float* __restrict__ meta, int ntx, float* __restrict__ out,
           int32_t* __restrict__ livec) {
  __shared__ __align__(16) float sp[2][windows::WINDOW_FLOATS];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int seg_s = bounds[tile];
  const int seg_e = bounds[tile + 1];
  const int base = (seg_s / CHUNK) * CHUNK;
  const int nc = windows::count(seg_s, seg_e);

  const float fx = meta[0], fy = meta[1];
  const float half_w = meta[5], half_h = meta[6];
  const float tx = (float)((tile % ntx) * TILE);
  const float ty = (float)((tile / ntx) * TILE);
  const float rx = ray_alpha::pixel_ray(tx + (float)(tid % TILE), half_w, fx);
  float ry[PPT];
  float T[PPT], r0[PPT], r1[PPT], r2[PPT], m0[PPT], m1[PPT], m2[PPT];
  float acc[PPT], s1[PPT], s2[PPT], depth[PPT];
  int med[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    ry[k] = ray_alpha::pixel_ray(ty + (float)(tid / TILE + k * ROWS_PER_PASS), half_h, fy);
    T[k] = 1.0f;
    r0[k] = r1[k] = r2[k] = m0[k] = m1[k] = m2[k] = 0.0f;
    acc[k] = s1[k] = s2[k] = depth[k] = 0.0f;
    med[k] = -1;
  }

  if (nc > 0) windows::stage<THREADS>(sp[0], payload, cap, base, tid);
  int c = 0;
  while (c < nc) {
    windows::wait_staged();
    int alive = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) alive |= (T[k] >= T_EPS);
    // the vote is also the barrier that publishes window c and frees the
    // other buffer (window c - 1 is blended)
    if (!__syncthreads_or(alive)) break;
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
      const ray_alpha::RayX x = ray_alpha::ray_x(mat[0], mat[3], mat[6], rx);
      ray_alpha::RayPeak rk[PPT];
#pragma unroll
      for (int k = 0; k < PPT; ++k) rk[k] = ray_alpha::ray_peak(mat, u, x, ry[k]);
      ray_alpha::Alpha ak[PPT];
#pragma unroll
      for (int k = 0; k < PPT; ++k) ak[k] = ray_alpha::alpha_at(rk[k], u, p.q0.w, rk[k].t);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const ray_alpha::RayPeak& r = rk[k];
        const ray_alpha::Alpha& al = ak[k];
        if (!ray_alpha::active(r.t, al.a)) continue;
        const float Te = T[k];
        if (Te > T_EPS) {
          // contributions: contracted into FMAs, held by tolerance
          const float w = al.a * Te;
          r0[k] += p.q0.x * w;
          r1[k] += p.q0.y * w;
          r2[k] += p.q0.z * w;
          acc[k] += w;
          if (REG) {
            const float itc = __fdividef(1.0f, fmaxf(r.t, NEAR_PLANE));
            const float m = (FAR_PLANE - FAR_X_NEAR * itc) * INV_FAR_MINUS_NEAR;
            const float wm = w * m;
            const float n0 = mat[0] * r.d0 + mat[3] * r.d1 + mat[6] * r.d2;
            const float n1 = mat[1] * r.d0 + mat[4] * r.d1 + mat[7] * r.d2;
            const float n2 = mat[2] * r.d0 + mat[5] * r.d1 + mat[8] * r.d2;
            const float sneg = rsqrtf(n0 * n0 + n1 * n1 + n2 * n2 + 1e-7f) * w;
            m0[k] -= n0 * sneg;
            m1[k] -= n1 * sneg;
            m2[k] -= n2 * sneg;
            s1[k] += wm;
            s2[k] += wm * m;
            if (Te > MEDIAN_T) {
              depth[k] = r.t;
              med[k] = c * CHUNK + i;
            }
          }
        }
        T[k] = ray_alpha::transmit(Te, al.a);
      }
    }
    ++c;
  }

  const float bg0 = meta[2], bg1 = meta[3], bg2 = meta[4];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const float omT = 1.0f - T[k];
    const float dist = __fdividef(acc[k] * s2[k] - s1[k] * s1[k], omT * omT + 1e-7f);
    float* o = out + (int64_t)tile * OUT_CH * NPIX + tid + k * THREADS;
    o[0 * NPIX] = r0[k] + T[k] * bg0;
    o[1 * NPIX] = r1[k] + T[k] * bg1;
    o[2 * NPIX] = r2[k] + T[k] * bg2;
    o[3 * NPIX] = m0[k];
    o[4 * NPIX] = m1[k];
    o[5 * NPIX] = m2[k];
    o[6 * NPIX] = depth[k];
    o[7 * NPIX] = acc[k];
    o[8 * NPIX] = dist;
    o[9 * NPIX] = T[k];
    o[10 * NPIX] = s1[k];
    o[11 * NPIX] = (float)med[k];
#pragma unroll
    for (int ch = 12; ch < OUT_CH; ++ch) o[ch * NPIX] = 0.0f;
  }
  if (tid == 0) livec[tile] = c;
}

template <bool REG>
cudaError_t launch(const void* payload, long long cap, const void* bounds, const void* meta,
                   int ntx, int ntiles, void* out, void* livec, cudaStream_t s) {
  fwd_kernel<REG><<<ntiles, THREADS, 0, s>>>(
      (const float*)payload, cap, (const int32_t*)bounds, (const float*)meta, ntx, (float*)out,
      (int32_t*)livec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gof_rasterize_fwd(int device, const void* payload, long long cap,
                                 const void* bounds, const void* meta, int ntx, int ntiles,
                                 int with_reg, void* out, void* livec, void* stream) {
  if (ntiles <= 0) return 0;
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(with_reg ? launch<true>(payload, cap, bounds, meta, ntx, ntiles, out, livec, s)
                        : launch<false>(payload, cap, bounds, meta, ntx, ntiles, out, livec, s));
}
