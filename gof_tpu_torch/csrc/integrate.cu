// Per-point transmittance through the opacity field: one block per block of
// 1024 query points (block b holds point slots [b * 1024, (b + 1) * 1024)),
// all binned to one tile.
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
// the library is built with -fmad=false, so the kernel rounds exactly as
// its plain version (ops/integrate.py::integrate_transmittance_reference).
//
// What bounds it: arithmetic. About 40 f32 operations, a divide and an expf
// per (point, gaussian) pair, every pair visited (no early exit). At the
// mesh design point (up to 900k tetra points of a 100k-gaussian model at
// 1237x822, ~1,300 gaussian rows per tile) that is ~1e9 pairs per view,
// while the payload is 64 bytes per row, read once per point block. Design
// as in the forward blend (rasterize_fwd.cu): each 128-row window is staged
// in shared memory (8.5 KB) and read back as broadcasts; 256 threads each
// own 4 points (slots tid + k * 256, coalesced loads), so one row read from
// shared memory serves 4 independent serial chains that hide the divide and
// expf latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 128;
constexpr int PBLOCK = 1024;
constexpr int THREADS = 256;
constexpr int PPT = PBLOCK / THREADS;  // points per thread
constexpr int P_COLS = 16;
constexpr int SROW = P_COLS + 1;  // padded shared-memory row: conflict-free fill

constexpr float NEAR_PLANE = 0.2f;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = 0.99f;

__global__ void __launch_bounds__(THREADS)
integrate_kernel(const float* __restrict__ payload, int64_t cap,
                 const int32_t* __restrict__ bseg_s, const int32_t* __restrict__ bseg_e,
                 const float* __restrict__ rays, int64_t nslots,
                 const int32_t* __restrict__ point_of_slot, int64_t n_points,
                 float* __restrict__ out) {
  __shared__ float sp[CHUNK][SROW];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int seg_s = bseg_s[b];
  const int seg_e = bseg_e[b];
  const int base = (seg_s / CHUNK) * CHUNK;
  const int nc = seg_e > seg_s ? (seg_e - base + CHUNK - 1) / CHUNK : 0;
  const int64_t slot0 = (int64_t)b * PBLOCK + tid;

  float rx[PPT], ry[PPT], z[PPT], T[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int64_t s = slot0 + k * THREADS;
    rx[k] = rays[s];
    ry[k] = rays[nslots + s];
    z[k] = rays[2 * nslots + s];
    T[k] = 1.0f;
  }

  for (int c = 0; c < nc; ++c) {
    __syncthreads();  // every thread is done with the previous window
    const int row0 = base + c * CHUNK;  // row0 + CHUNK <= cap: cap is a multiple
    for (int idx = tid; idx < P_COLS * CHUNK; idx += THREADS) {  // of CHUNK >= seg_e
      const int f = idx / CHUNK;
      const int i = idx % CHUNK;
      sp[i][f] = payload[(int64_t)f * cap + row0 + i];
    }
    __syncthreads();

    const int i0 = max(seg_s - row0, 0);
    const int i1 = min(seg_e - row0, CHUNK);
    for (int i = i0; i < i1; ++i) {
      const float* p = sp[i];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float d0 = p[4] * rx[k] + p[5] * ry[k] + p[6];
        const float d1 = p[7] * rx[k] + p[8] * ry[k] + p[9];
        const float d2 = p[10] * rx[k] + p[11] * ry[k] + p[12];
        const float ud = p[13] * d0 + p[14] * d1 + p[15] * d2;
        const float dd = d0 * d0 + d1 * d1 + d2 * d2 + 1e-12f;
        const float t = -ud / dd;
        const float ts = fminf(t, z[k]);
        const float v0 = p[13] + ts * d0;
        const float v1 = p[14] + ts * d1;
        const float v2 = p[15] + ts * d2;
        const float mv = v0 * v0 + v1 * v1 + v2 * v2;
        const float opE = p[3] * expf(-0.5f * mv);
        const float a = opE > ALPHA_MAX ? ALPHA_MAX : opE;
        if (!(t > NEAR_PLANE && a >= ALPHA_MIN)) continue;
        T[k] = T[k] * (1.0f - a);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int32_t pid = point_of_slot[slot0 + k * THREADS];
    if (pid >= 0 && pid < n_points) out[pid] = T[k];
  }
}

}  // namespace

extern "C" int gof_integrate(int device, const void* payload, long long cap,
                             const void* bseg_s, const void* bseg_e, int n_blocks,
                             const void* rays, long long nslots, const void* point_of_slot,
                             long long n_points, void* out, void* stream) {
  if (n_blocks <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  integrate_kernel<<<n_blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)payload, cap, (const int32_t*)bseg_s, (const int32_t*)bseg_e,
      (const float*)rays, nslots, (const int32_t*)point_of_slot, n_points, (float*)out);
  return (int)cudaGetLastError();
}
