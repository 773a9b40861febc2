// Backward ray-Gaussian blend: one block per 32x32 tile.
//
// Replaces gof_tpu/ops/rasterize_pallas.py::_bwd_kernel (the Pallas kernel
// launched by rasterize_bwd_pallas). The tile re-walks the windows the
// forward walked (csrc/rasterize_fwd.cu), front to back, and writes one
// 16-column gradient row per visited slot, in quadric-invariant form
// (drgb 3 | dop 1 | dSigma6 6 | db 3 | duu 1 | pad 2), at the compact start
// the forward assigned the tile (fout channels CH_CSTART / CH_LIVEC); the
// slot's gaussian id goes to an int32 stream at the same position, and with
// densification statistics an 8-column row (gx | gy | |gx|+|gy| | pad 5).
//
// Conventions (shared with the plain version, ops/rasterize.py):
// - T is recomputed with the forward kernel's serial arithmetic,
//   T <- T * (1 - a) per active row, so the T > 1e-4 cutoff and the median
//   row (base-relative c * 128 + row == CH_MEDIDX) agree with the forward
//   bit for bit; gof_tpu's T * shift_down(prod_incl) rounds differently;
// - suffix sums come by subtraction from the forward totals:
//   SF = TOT_F - (PwF + sum_{j <= i} w_j F_j),
//   dL/da = T_excl * cutoff * F - (SF + T_final * bg.g_rgb) / (1 - a);
// - the reference's quirks: distortion flows through m only, the median
//   depth gradient goes to the median visit only, the 0.99 alpha clamp is
//   ignored in dop and dL/dmv (and the dilation coef is detached upstream);
// - rows outside [seg_s, seg_e) and inactive pairs are skipped by branch:
//   they write zero gradient rows that carry the window's slot ids, so a
//   non-finite row of a neighbouring tile never leaks into this one;
// - the tile walks min(windows, CH_LIVEC, room left in the compact buffer)
//   windows. The forward's exit vote needs no repeat: T is the forward's,
//   so the vote would pass at every window before CH_LIVEC.
// The per-visit sums over the tile's 1024 pixels are deterministic, without
// atomics: each thread adds its 4 pixels in order, each warp reduces by a
// fixed xor butterfly (lane 0's result), and at the end of the window the
// 8 warp partials are added in warp order.
//
// What bounds it: arithmetic and the per-visit reduction. Per (pixel,
// visit) pair about 130 f32 operations (the forward's ~60, the gradient
// chain, an expf and a divide); per visit, 14 (17 with the statistics) sums
// over 256 threads, 5 shuffles each per warp. At the training design point
// (1237x822, 100k gaussians) the tiles walk ~2000 windows, some 260M pairs
// and 257k visits. Design: as in the forward, 256 threads own 4 pixels
// each, so the 16-24 payload floats a thread reads from shared memory per
// visit serve 4 pixels and the 4 independent serial chains hide latency;
// the per-pixel constants (cotangents, forward totals) stay in registers,
// which is why the block asks for up to 255 registers (one block per SM).
// Warps reduce a visit only when one of their pixels was active. Shared
// memory holds the window's payload (up to 24 x 128 f32), its slot ids and
// the warp partials (8 x 17 x 128 f32), 81 KB in all, above the default
// 48 KB, so the launcher raises the block's dynamic shared-memory limit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 128;
constexpr int TILE = 32;
constexpr int NPIX = TILE * TILE;
constexpr int OUT_CH = 16;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int PPT = NPIX / THREADS;  // pixels per thread
constexpr int ROWS_PER_PASS = THREADS / TILE;
constexpr int GRAD_COLS = 16;
constexpr int NGRAD = 14;  // gradient sums per visit (rows 14, 15 are padding)
constexpr int CH_TFINAL = 9;
constexpr int CH_DFINAL = 10;
constexpr int CH_MEDIDX = 11;
constexpr int CH_LIVEC = 12;
constexpr int CH_CSTART = 13;

constexpr float NEAR_PLANE = 0.2f;
constexpr float FAR_PLANE = 100.0f;
constexpr float FAR_X_NEAR = (float)(100.0 * 0.2);
constexpr float FAR_MINUS_NEAR = (float)(100.0 - 0.2);
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;

template <bool STATS>
struct Layout {
  static constexpr int PC = STATS ? 24 : 16;   // payload columns
  static constexpr int SROW = PC + 1;          // padded shared-memory row
  static constexpr int NS = NGRAD + (STATS ? 3 : 0);
  static constexpr int SMEM_BYTES =
      (CHUNK * SROW + NWARPS * NS * CHUNK) * (int)sizeof(float) + CHUNK * (int)sizeof(int32_t);
};

template <bool REG, bool STATS>
__global__ void __launch_bounds__(THREADS, 1)
bwd_kernel(const float* __restrict__ payload, int64_t cap, const int32_t* __restrict__ slot_gid,
           const int32_t* __restrict__ bounds, const float* __restrict__ fout,
           const float* __restrict__ gout, const float* __restrict__ meta, int ntx, float halfw,
           float halfh, int64_t R, float* __restrict__ dslot, int32_t* __restrict__ gidc,
           float* __restrict__ stats) {
  using L = Layout<STATS>;
  constexpr int PC = L::PC;
  constexpr int SROW = L::SROW;
  constexpr int NS = L::NS;
  extern __shared__ float smem[];
  float* sp = smem;                        // [CHUNK][SROW] payload window
  float* part = sp + CHUNK * SROW;         // [NWARPS][NS][CHUNK] warp partials
  int32_t* sgid = (int32_t*)(part + NWARPS * NS * CHUNK);  // [CHUNK] slot ids

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int seg_s = bounds[tile];
  const int seg_e = bounds[tile + 1];
  const int base = (seg_s / CHUNK) * CHUNK;
  int nc = seg_e > seg_s ? (seg_e - base + CHUNK - 1) / CHUNK : 0;
  const float* fo = fout + (int64_t)tile * OUT_CH * NPIX;
  const float* go = gout + (int64_t)tile * OUT_CH * NPIX;
  const int livec = (int)fo[CH_LIVEC * NPIX];
  const int64_t cst = (int64_t)fo[CH_CSTART * NPIX];
  const int64_t avail = R > cst ? (R - cst) / CHUNK : 0;
  nc = min(nc, livec);
  if ((int64_t)nc > avail) nc = (int)avail;

  const float fx = meta[0], fy = meta[1];
  const float bg0 = meta[2], bg1 = meta[3], bg2 = meta[4];
  const float half_w = meta[5], half_h = meta[6];
  const float tx = (float)((tile % ntx) * TILE);
  const float ty = (float)((tile / ntx) * TILE);
  const float lx = (float)(tid % TILE);
  const float pxc = (tx + lx) + 0.5f;
  const float rx = (pxc - half_w) / fx;
  const float rxx = rx * rx;
  const float pxm = pxc - 0.5f;

  // per-pixel state and constants
  float T[PPT], PwF[PPT], ry[PPT], pym[PPT];
  float gr0[PPT], gr1[PPT], gr2[PPT], ga[PPT], TOT[PPT], Tbg[PPT];
  float gn0[PPT], gn1[PPT], gn2[PPT], gdep[PPT], gdist[PPT], acc_tot[PPT], d1_tot[PPT], med[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int pix = tid + k * THREADS;
    const float ly = (float)(tid / TILE + k * ROWS_PER_PASS);
    const float pyc = (ty + ly) + 0.5f;
    ry[k] = (pyc - half_h) / fy;
    pym[k] = pyc - 0.5f;
    T[k] = 1.0f;
    PwF[k] = 0.0f;
    gr0[k] = go[0 * NPIX + pix];
    gr1[k] = go[1 * NPIX + pix];
    gr2[k] = go[2 * NPIX + pix];
    ga[k] = go[7 * NPIX + pix];
    const float T_fin = fo[CH_TFINAL * NPIX + pix];
    acc_tot[k] = fo[7 * NPIX + pix];
    const float rgbnb0 = fo[0 * NPIX + pix] - T_fin * bg0;
    const float rgbnb1 = fo[1 * NPIX + pix] - T_fin * bg1;
    const float rgbnb2 = fo[2 * NPIX + pix] - T_fin * bg2;
    float tot = gr0[k] * rgbnb0 + gr1[k] * rgbnb1 + gr2[k] * rgbnb2 + ga[k] * acc_tot[k];
    if (REG) {
      gn0[k] = go[3 * NPIX + pix];
      gn1[k] = go[4 * NPIX + pix];
      gn2[k] = go[5 * NPIX + pix];
      gdep[k] = go[6 * NPIX + pix];
      gdist[k] = go[8 * NPIX + pix];
      d1_tot[k] = fo[CH_DFINAL * NPIX + pix];
      med[k] = fo[CH_MEDIDX * NPIX + pix];
      tot = tot + (gn0[k] * fo[3 * NPIX + pix] + gn1[k] * fo[4 * NPIX + pix]
                   + gn2[k] * fo[5 * NPIX + pix]);
    }
    TOT[k] = tot;
    const float bgdot = bg0 * gr0[k] + bg1 * gr1[k] + bg2 * gr2[k];
    Tbg[k] = T_fin * bgdot;
  }

  for (int c = 0; c < nc; ++c) {
    __syncthreads();  // the previous window's partials and ids are written out
    const int row0 = base + c * CHUNK;  // row0 + CHUNK <= cap: cap is a multiple
    for (int idx = tid; idx < PC * CHUNK; idx += THREADS) {  // of CHUNK >= seg_e
      const int f = idx / CHUNK;
      const int i = idx % CHUNK;
      sp[i * SROW + f] = payload[(int64_t)f * cap + row0 + i];
    }
    for (int i = tid; i < CHUNK; i += THREADS) sgid[i] = slot_gid[row0 + i];
    __syncthreads();

    const int i0 = max(seg_s - row0, 0);
    const int i1 = min(seg_e - row0, CHUNK);
    for (int i = i0; i < i1; ++i) {
      const float* p = sp + i * SROW;
      const float glob_row = (float)(c * CHUNK + i);
      float acc[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) acc[j] = 0.0f;
      bool any = false;
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
        const float E = expf(-0.5f * mv);
        const float op = p[3];
        const float opE = op * E;
        const float a = opE > ALPHA_MAX ? ALPHA_MAX : opE;
        if (!(t > NEAR_PLANE && a >= ALPHA_MIN)) continue;
        any = true;
        const float Te = T[k];
        const bool cutoff = Te > T_EPS;
        const float w = cutoff ? a * Te : 0.0f;
        float F = p[0] * gr0[k] + p[1] * gr1[k] + p[2] * gr2[k] + ga[k];
        float n0 = 0.0f, n1 = 0.0f, n2 = 0.0f, inv_len = 0.0f;
        if (REG) {
          n0 = p[4] * d0 + p[7] * d1 + p[10] * d2;
          n1 = p[5] * d0 + p[8] * d1 + p[11] * d2;
          n2 = p[6] * d0 + p[9] * d1 + p[12] * d2;
          inv_len = rsqrtf(n0 * n0 + n1 * n1 + n2 * n2 + 1e-7f);
          const float nh0 = -n0 * inv_len;
          const float nh1 = -n1 * inv_len;
          const float nh2 = -n2 * inv_len;
          F = F + nh0 * gn0[k] + nh1 * gn1[k] + nh2 * gn2[k];
        }
        PwF[k] = PwF[k] + w * F;
        const float SF = TOT[k] - PwF[k];
        const float dL_da = (cutoff ? Te * F : 0.0f) - (SF + Tbg[k]) / (1.0f - a);
        const float dop_pix = E * dL_da;
        const float dL_dmv = -0.5f * E * op * dL_da;
        const float rdd = 1.0f / dd;
        const float s_mv = t * dL_dmv;
        float A_ud, A_dd;
        float dn0 = 0.0f, dn1 = 0.0f, dn2 = 0.0f;
        if (REG) {
          const float tc = fmaxf(t, NEAR_PLANE);
          const float m = (FAR_PLANE * tc - FAR_X_NEAR) / (FAR_MINUS_NEAR * tc);
          const float dL_dm = 2.0f * w * (m * acc_tot[k] - d1_tot[k]) * gdist[k];
          const float dm_dt = FAR_X_NEAR / (FAR_MINUS_NEAR * tc * tc);
          const float dL_dt = dL_dm * dm_dt + (glob_row == med[k] ? gdep[k] : 0.0f);
          const float q_t = dL_dt * rdd;
          A_ud = 2.0f * s_mv - q_t;
          A_dd = t * (s_mv - q_t);
          const float dnh0 = w * gn0[k];
          const float dnh1 = w * gn1[k];
          const float dnh2 = w * gn2[k];
          const float dot_nh = dnh0 * n0 + dnh1 * n1 + dnh2 * n2;
          const float il2 = inv_len * inv_len;
          dn0 = (-dnh0 + dot_nh * n0 * il2) * inv_len;
          dn1 = (-dnh1 + dot_nh * n1 * il2) * inv_len;
          dn2 = (-dnh2 + dot_nh * n2 * il2) * inv_len;
        } else {
          A_ud = 2.0f * s_mv;
          A_dd = t * s_mv;
        }
        const float rxy = rx * ry[k];
        const float ryy = ry[k] * ry[k];
        acc[0] = acc[0] + w * gr0[k];
        acc[1] = acc[1] + w * gr1[k];
        acc[2] = acc[2] + w * gr2[k];
        acc[3] = acc[3] + dop_pix;
        if (REG) {
          acc[4] = acc[4] + (A_dd * rxx + dn0 * rx);
          acc[5] = acc[5] + (2.0f * (A_dd * rxy) + (dn0 * ry[k] + dn1 * rx));
          acc[6] = acc[6] + (2.0f * (A_dd * rx) + (dn0 + dn2 * rx));
          acc[7] = acc[7] + (A_dd * ryy + dn1 * ry[k]);
          acc[8] = acc[8] + (2.0f * (A_dd * ry[k]) + (dn1 + dn2 * ry[k]));
          acc[9] = acc[9] + (A_dd + dn2);
        } else {
          acc[4] = acc[4] + A_dd * rxx;
          acc[5] = acc[5] + 2.0f * (A_dd * rxy);
          acc[6] = acc[6] + 2.0f * (A_dd * rx);
          acc[7] = acc[7] + A_dd * ryy;
          acc[8] = acc[8] + 2.0f * (A_dd * ry[k]);
          acc[9] = acc[9] + A_dd;
        }
        acc[10] = acc[10] + A_ud * rx;
        acc[11] = acc[11] + A_ud * ry[k];
        acc[12] = acc[12] + A_ud;
        acc[13] = acc[13] + dL_dmv;
        if (STATS) {
          const float dxp = p[19] - pxm;
          const float dyp = p[20] - pym[k];
          const float dL_dG2 = op * dL_da;
          const float gx = dL_dG2 * (-E) * (p[16] * dxp + p[17] * dyp) * halfw;
          const float gy = dL_dG2 * (-E) * (p[17] * dxp + p[18] * dyp) * halfh;
          acc[NGRAD + 0] = acc[NGRAD + 0] + gx;
          acc[NGRAD + 1] = acc[NGRAD + 1] + gy;
          acc[NGRAD + 2] = acc[NGRAD + 2] + (fabsf(gx) + fabsf(gy));
        }
        T[k] = Te * (1.0f - a);
      }
      // a warp none of whose pixels was active holds exact zeros
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          float v = acc[j];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
          acc[j] = v;
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < NS; ++j) part[(warp * NS + j) * CHUNK + i] = acc[j];
      }
    }
    __syncthreads();

    // one gradient row per slot of the window, at the tile's compact start
    const int64_t col0 = cst + (int64_t)c * CHUNK;
    for (int idx = tid; idx < NS * CHUNK; idx += THREADS) {
      const int j = idx / CHUNK;
      const int i = idx % CHUNK;
      float s = 0.0f;
      if (i >= i0 && i < i1) {
        s = part[j * CHUNK + i];
#pragma unroll
        for (int w = 1; w < NWARPS; ++w) s = s + part[(w * NS + j) * CHUNK + i];
      }
      if (j < NGRAD) {
        dslot[(int64_t)j * R + col0 + i] = s;
      } else {
        stats[(int64_t)(j - NGRAD) * R + col0 + i] = s;
      }
    }
    for (int i = tid; i < CHUNK; i += THREADS) gidc[col0 + i] = sgid[i];
  }
}

template <bool REG, bool STATS>
int launch(const void* payload, long long cap, const void* slot_gid, const void* bounds,
           const void* fout, const void* gout, const void* meta, int ntx, int ntiles,
           float halfw, float halfh, long long R, void* dslot, void* gidc, void* stats,
           cudaStream_t s) {
  constexpr int smem = Layout<STATS>::SMEM_BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel<REG, STATS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bwd_kernel<REG, STATS><<<ntiles, THREADS, smem, s>>>(
      (const float*)payload, cap, (const int32_t*)slot_gid, (const int32_t*)bounds,
      (const float*)fout, (const float*)gout, (const float*)meta, ntx, halfw, halfh, R,
      (float*)dslot, (int32_t*)gidc, (float*)stats);
  return (int)cudaGetLastError();
}

}  // namespace

// dslot [16, R], gidc [R] and stats [8, R] come zero-filled from the caller:
// the kernel writes rows 0-13 (and stats rows 0-2) of the columns the tiles
// walk, and leaves the padding rows and any unwritten tail at zero.
extern "C" int gof_rasterize_bwd(int device, const void* payload, long long cap,
                                 const void* slot_gid, const void* bounds, const void* fout,
                                 const void* gout, const void* meta, int ntx, int ntiles,
                                 float halfw, float halfh, int with_stats, int with_reg,
                                 long long R, void* dslot, void* gidc, void* stats,
                                 void* stream) {
  if (ntiles <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (with_reg && with_stats)
    return launch<true, true>(payload, cap, slot_gid, bounds, fout, gout, meta, ntx, ntiles,
                              halfw, halfh, R, dslot, gidc, stats, s);
  if (with_reg)
    return launch<true, false>(payload, cap, slot_gid, bounds, fout, gout, meta, ntx, ntiles,
                               halfw, halfh, R, dslot, gidc, stats, s);
  if (with_stats)
    return launch<false, true>(payload, cap, slot_gid, bounds, fout, gout, meta, ntx, ntiles,
                               halfw, halfh, R, dslot, gidc, stats, s);
  return launch<false, false>(payload, cap, slot_gid, bounds, fout, gout, meta, ntx, ntiles,
                              halfw, halfh, R, dslot, gidc, stats, s);
}
