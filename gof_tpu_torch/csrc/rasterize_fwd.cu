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
// What bounds it: arithmetic. About 60 f32 operations, an expf and (with the
// regularizer channels) an rsqrtf per (pixel, gaussian) pair visited; the
// payload is 64 bytes per key, read once per tile. At the serving design
// point (1237x822, 100k gaussians: 1.07M keys over 1014 tiles) the early
// exit leaves about 2000 windows, some 260M pairs. Design: each window's 128 payload rows are staged in shared
// memory (8.5 KB) and read back as broadcasts. 256 threads each own 4 pixels
// (rows ty, ty+8, ty+16, ty+24 of the tile): the 16 payload floats a thread
// reads per row serve 4 pixels, the 4 independent serial chains hide the
// expf/divide latency, and the state (14 registers per pixel) fits the
// 128-register cap that keeps 2 blocks resident per SM. One pixel per
// thread with 1024 threads would cap registers at 64 and re-read each row
// per pixel. Each pixel blends serially in row order; the library is built
// with -fmad=false so every operation rounds as in the plain PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 128;
constexpr int TILE = 32;
constexpr int NPIX = TILE * TILE;
constexpr int P_COLS = 16;
constexpr int OUT_CH = 16;
constexpr int THREADS = 256;
constexpr int PPT = NPIX / THREADS;  // pixels per thread
constexpr int ROWS_PER_PASS = THREADS / TILE;
constexpr int SROW = P_COLS + 1;  // padded shared-memory row: conflict-free fill

constexpr float NEAR_PLANE = 0.2f;
constexpr float FAR_PLANE = 100.0f;
constexpr float FAR_X_NEAR = (float)(100.0 * 0.2);
constexpr float FAR_MINUS_NEAR = (float)(100.0 - 0.2);
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;
constexpr float MEDIAN_T = 0.5f;

template <bool REG>
__global__ void __launch_bounds__(THREADS, 2)
fwd_kernel(const float* __restrict__ payload, int64_t cap, const int32_t* __restrict__ bounds,
           const float* __restrict__ meta, int ntx, float* __restrict__ out,
           int32_t* __restrict__ livec) {
  __shared__ float sp[CHUNK][SROW];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int seg_s = bounds[tile];
  const int seg_e = bounds[tile + 1];
  const int base = (seg_s / CHUNK) * CHUNK;
  const int nc = seg_e > seg_s ? (seg_e - base + CHUNK - 1) / CHUNK : 0;

  const float fx = meta[0], fy = meta[1];
  const float half_w = meta[5], half_h = meta[6];
  const float tx = (float)((tile % ntx) * TILE);
  const float ty = (float)((tile / ntx) * TILE);
  const float lx = (float)(tid % TILE);
  const float rx = ((tx + lx) + 0.5f - half_w) / fx;
  float ry[PPT];
  float T[PPT], r0[PPT], r1[PPT], r2[PPT], m0[PPT], m1[PPT], m2[PPT];
  float acc[PPT], s1[PPT], s2[PPT], depth[PPT];
  int med[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const float ly = (float)(tid / TILE + k * ROWS_PER_PASS);
    ry[k] = ((ty + ly) + 0.5f - half_h) / fy;
    T[k] = 1.0f;
    r0[k] = r1[k] = r2[k] = m0[k] = m1[k] = m2[k] = 0.0f;
    acc[k] = s1[k] = s2[k] = depth[k] = 0.0f;
    med[k] = -1;
  }

  int c = 0;
  while (c < nc) {
    int alive = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) alive |= (T[k] >= T_EPS);
    // the vote is also the barrier before the window buffer is refilled
    if (!__syncthreads_or(alive)) break;

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
        const float d0 = p[4] * rx + p[5] * ry[k] + p[6];
        const float d1 = p[7] * rx + p[8] * ry[k] + p[9];
        const float d2 = p[10] * rx + p[11] * ry[k] + p[12];
        const float ud = p[13] * d0 + p[14] * d1 + p[15] * d2;
        const float dd = d0 * d0 + d1 * d1 + d2 * d2 + 1e-12f;
        const float t = -ud / dd;
        const float v0 = p[13] + t * d0;
        const float v1 = p[14] + t * d1;
        const float v2 = p[15] + t * d2;
        const float mv = v0 * v0 + v1 * v1 + v2 * v2;
        const float opE = p[3] * expf(-0.5f * mv);
        const float a = opE > ALPHA_MAX ? ALPHA_MAX : opE;
        if (!(t > NEAR_PLANE && a >= ALPHA_MIN)) continue;
        const float Te = T[k];
        if (Te > T_EPS) {
          const float w = a * Te;
          r0[k] = r0[k] + p[0] * w;
          r1[k] = r1[k] + p[1] * w;
          r2[k] = r2[k] + p[2] * w;
          acc[k] = acc[k] + w;
          if (REG) {
            const float tc = fmaxf(t, NEAR_PLANE);
            const float m = (FAR_PLANE * tc - FAR_X_NEAR) / (FAR_MINUS_NEAR * tc);
            const float wm = w * m;
            const float n0 = p[4] * d0 + p[7] * d1 + p[10] * d2;
            const float n1 = p[5] * d0 + p[8] * d1 + p[11] * d2;
            const float n2 = p[6] * d0 + p[9] * d1 + p[12] * d2;
            const float inv_len = rsqrtf(n0 * n0 + n1 * n1 + n2 * n2 + 1e-7f);
            const float sneg = inv_len * w;
            m0[k] = m0[k] - n0 * sneg;
            m1[k] = m1[k] - n1 * sneg;
            m2[k] = m2[k] - n2 * sneg;
            s1[k] = s1[k] + wm;
            s2[k] = s2[k] + wm * m;
            if (Te > MEDIAN_T) {
              depth[k] = t;
              med[k] = c * CHUNK + i;
            }
          }
        }
        T[k] = Te * (1.0f - a);
      }
    }
    ++c;
  }

  const float bg0 = meta[2], bg1 = meta[3], bg2 = meta[4];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const float omT = 1.0f - T[k];
    const float dist = (acc[k] * s2[k] - s1[k] * s1[k]) / (omT * omT + 1e-7f);
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

}  // namespace

extern "C" int gof_rasterize_fwd(int device, const void* payload, long long cap,
                                 const void* bounds, const void* meta, int ntx, int ntiles,
                                 int with_reg, void* out, void* livec, void* stream) {
  if (ntiles <= 0) return 0;
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (with_reg) {
    fwd_kernel<true><<<ntiles, THREADS, 0, s>>>(
        (const float*)payload, cap, (const int32_t*)bounds, (const float*)meta, ntx,
        (float*)out, (int32_t*)livec);
  } else {
    fwd_kernel<false><<<ntiles, THREADS, 0, s>>>(
        (const float*)payload, cap, (const int32_t*)bounds, (const float*)meta, ntx,
        (float*)out, (int32_t*)livec);
  }
  return (int)cudaGetLastError();
}
