// Backward ray-Gaussian blend: one block per 32x32 tile, longest tiles first.
//
// Replaces gof_tpu/ops/rasterize_pallas.py::_bwd_kernel (the Pallas kernel
// launched by rasterize_bwd_pallas). The tile re-walks the windows the
// forward walked (csrc/rasterize_fwd.cu), front to back, and writes one
// gradient row per visited slot, in quadric-invariant form (drgb 3 | dop 1 |
// dSigma6 6 | db 3 | duu 1 | pad 2), at the compact start the forward
// assigned the tile (fout channels CH_CSTART / CH_LIVEC), into one row-major
// buffer [R, 16], or [R, 24] with the densification statistics in columns
// 16:24 (gx | gy | |gx|+|gy| | pad 5); the slot's gaussian id goes to an
// int32 stream at the same position. Each window's rows are one contiguous
// block of the buffer, which the reduce (csrc/reduce.cu) reads as it is.
//
// Conventions (shared with the plain version, ops/rasterize.py):
// - T is recomputed with the forward kernel's serial arithmetic,
//   T <- T * (1 - a) per active row, so the T > 1e-4 cutoff and the median
//   row (base-relative c * 128 + row == CH_MEDIDX) agree with the forward
//   bit for bit; gof_tpu's T * shift_down(prod_incl) rounds differently;
// - suffix sums come by subtraction from the forward totals:
//   SF = TOT_F - (PwF + sum_{j <= i} w_j F_j), and SF = 0 past the cutoff
//   (exact: every later weight is zero; gof_tpu keeps the subtraction's
//   rounding residue there, which made a row's gradient depend on where
//   the walk's windows end),
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
// fixed shuffle pattern, and the 8 warp partials are added in warp order.
//
// What bounds it: arithmetic, and the instructions that are not: per visited
// (pixel, row) pair the transmittance chain (~40 f32 operations, an IEEE
// divide and an expf, all kept as the forward rounds them); per active pair
// the gradient chain (~55 operations, ~135 with the regularizers, ~75 with
// the statistics); per visit and warp one reduction of 14-17 sums over 32
// lanes. At the training design point (1237x822, 100k gaussians) the tiles
// visit ~175M (pixel, row) pairs, 63% of them active. Design:
// - only the transmittance chain has to keep the forward's bits: it is the
//   forward's own (ray_alpha.cuh), written with __fmul_rn / __fadd_rn /
//   __fsub_rn / __fdiv_rn, which nvcc never contracts, and this source is
//   built with contraction on, so the gradient chain runs on FMAs; its
//   divides (1 / (1 - a), 1 / dd, 1 / t) are __fdividef;
// - each warp reduces its 16 sums of a visit by a reduce-scatter butterfly:
//   at each xor level a lane sends half of the sums it holds and keeps the
//   other half (8 + 4 + 2 + 1 + 1 shuffles, not 5 per sum), and lanes 2j,
//   2j + 1 end up with sum j; the statistics' third sum takes its own
//   butterfly. Each level is its own template instance with its halves
//   picked by bit masks: written as one loop with selects, nvcc kept a
//   loop, indexed the sums through predicated moves and branched on the
//   lane's bit, and that form measured slower than a butterfly per sum;
// - two tiles share an SM (16 warps): the gradient chain's per-pixel
//   constants (cotangents, forward totals: 6, 14 with the regularizers) live
//   in shared memory and are read for active pairs only, the warp partials
//   of 64 visits at a time, so a block asks for at most 103 KB and ptxas
//   for at most 128 registers;
// - a one-block pass orders the tiles by CH_LIVEC, descending (a counting
//   sort on the device, no host read), and block b walks the b-th tile, so
//   the longest tiles start first and the last wave is short. Each tile
//   writes at its own CH_CSTART, so the output does not depend on the order;
// - the per-visit payload rows are staged in shared memory as whole float4s
//   and read back as broadcasts, so the 16-24 floats a thread reads per
//   visit serve its 4 pixels.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_alpha.cuh"

namespace {

constexpr int CHUNK = 128;
constexpr int TILE = 32;
constexpr int NPIX = TILE * TILE;
constexpr int OUT_CH = 16;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int PPT = NPIX / THREADS;  // pixels per thread
constexpr int ROWS_PER_PASS = THREADS / TILE;
constexpr int NGRAD = 14;      // gradient sums per visit
constexpr int GRAD_COLS = 16;  // gradient columns of an output row (14, 15 stay zero)
constexpr int SUB = 64;        // visits whose warp partials are held at once
constexpr int ORDER_THREADS = 1024;  // also the tile order's buckets of CH_LIVEC
constexpr unsigned FULL = 0xffffffffu;
constexpr int CH_TFINAL = 9;
constexpr int CH_DFINAL = 10;
constexpr int CH_MEDIDX = 11;
constexpr int CH_LIVEC = 12;
constexpr int CH_CSTART = 13;

constexpr float NEAR_PLANE = ray_alpha::NEAR_PLANE;
constexpr float FAR_PLANE = 100.0f;
constexpr float FAR_X_NEAR = (float)(100.0 * 0.2);
constexpr float INV_FAR_MINUS_NEAR = (float)(1.0 / (100.0 - 0.2));
constexpr float DM_DT_SCALE = (float)(100.0 * 0.2 / (100.0 - 0.2));
constexpr float T_EPS = 1e-4f;

// the per-pixel constants of the gradient chain, [Q][NPIX] in shared memory
enum { Q_GR0, Q_GR1, Q_GR2, Q_GA, Q_TOT, Q_TBG, Q_GN0, Q_GN1, Q_GN2, Q_GDEP, Q_GDIST, Q_ACC,
       Q_DTOT, Q_MED };

template <bool REG, bool STATS>
struct Layout {
  static constexpr int PC = STATS ? 24 : 16;          // payload columns, whole float4s
  static constexpr int NS = NGRAD + (STATS ? 3 : 0);  // sums per visit
  static constexpr int NSP = NS | 1;                  // odd partial-row stride
  static constexpr int OC = STATS ? 24 : 16;          // output row
  static constexpr int NQ = REG ? 14 : 6;             // per-pixel constants
  static constexpr int BYTES =
      (CHUNK * PC + NQ * NPIX + NWARPS * SUB * NSP) * (int)sizeof(float)
      + CHUNK * (int)sizeof(int32_t);
};

// One level of the reduce-scatter: a lane holds O sums, keeps the upper half
// if its bit O is set (mask all ones), the lower half otherwise, and sends
// its partner the other half. The halves are picked by bit masks, not by a
// select nvcc could turn into a branch.
template <int O>
__device__ __forceinline__ void scatter_level(float (&v)[16], unsigned up) {
#pragma unroll
  for (int k = 0; k < O / 2; ++k) {
    const unsigned lo = __float_as_uint(v[k]), hi = __float_as_uint(v[k + O / 2]);
    const float send = __uint_as_float((lo & up) | (hi & ~up));
    const float keep = __uint_as_float((hi & up) | (lo & ~up));
    v[k] = keep + __shfl_xor_sync(FULL, send, O);
  }
}

// The warp's sums of v[0..15] over its 32 lanes: lanes 2j and 2j + 1 return
// the sum of v[j]. The additions run in a fixed order.
__device__ __forceinline__ float warp_sum16(float (&v)[16], int lane) {
  // reduce-scatter: 8 + 4 + 2 + 1 shuffles leave lanes 2j, 2j + 1 with the
  // pair sums of v[j], one more adds the pair
  const auto mask = [lane](int bit) { return (lane & bit) ? ~0u : 0u; };
  scatter_level<16>(v, mask(16));
  scatter_level<8>(v, mask(8));
  scatter_level<4>(v, mask(4));
  scatter_level<2>(v, mask(2));
  return v[0] + __shfl_xor_sync(FULL, v[0], 1);
}

// Tile order: descending CH_LIVEC (clamped to ORDER_THREADS - 1), by a
// counting sort in one block. Ties land in any order: the output of the
// blend does not depend on it.
__device__ __forceinline__ int order_bucket(const float* fout, int t) {
  const int live = (int)fout[(int64_t)t * OUT_CH * NPIX + CH_LIVEC * NPIX];
  return ORDER_THREADS - 1 - min(max(live, 0), ORDER_THREADS - 1);
}

__global__ void __launch_bounds__(ORDER_THREADS)
order_kernel(const float* __restrict__ fout, int ntiles, int32_t* __restrict__ order) {
  __shared__ int start[ORDER_THREADS];
  __shared__ int warp_tot[ORDER_THREADS / 32];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  start[tid] = 0;
  __syncthreads();
  for (int t = tid; t < ntiles; t += ORDER_THREADS) atomicAdd(start + order_bucket(fout, t), 1);
  __syncthreads();
  const int n = start[tid];
  int x = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  int before = 0;
  for (int i = 0; i < warp; ++i) before += warp_tot[i];
  start[tid] = before + x - n;
  __syncthreads();
  for (int t = tid; t < ntiles; t += ORDER_THREADS)
    order[atomicAdd(start + order_bucket(fout, t), 1)] = t;
}

template <bool REG, bool STATS>
__global__ void __launch_bounds__(THREADS, 2)
bwd_kernel(const float* __restrict__ payload, int64_t cap, const int32_t* __restrict__ slot_gid,
           const int32_t* __restrict__ bounds, const float* __restrict__ fout,
           const float* __restrict__ gout, const float* __restrict__ meta,
           const int32_t* __restrict__ order, int ntx, float halfw, float halfh, int64_t R,
           float* __restrict__ rows, int32_t* __restrict__ gidc, int32_t* __restrict__ t_miss) {
  using L = Layout<REG, STATS>;
  constexpr int PC = L::PC;
  constexpr int NSP = L::NSP;
  constexpr int OC = L::OC;
  extern __shared__ __align__(16) float smem[];
  float* sp = smem;                  // [CHUNK][PC] payload window
  float* cq = sp + CHUNK * PC;       // [NQ][NPIX] per-pixel constants
  float* part = cq + L::NQ * NPIX;   // [NWARPS][SUB][NSP] warp partials
  int32_t* sgid = (int32_t*)(part + NWARPS * SUB * NSP);  // [CHUNK] slot ids

  const int tile = order[blockIdx.x];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int seg_s = bounds[tile];
  const int seg_e = bounds[tile + 1];
  const int base = (seg_s / CHUNK) * CHUNK;
  const int windows = seg_e > seg_s ? (seg_e - base + CHUNK - 1) / CHUNK : 0;
  const float* fo = fout + (int64_t)tile * OUT_CH * NPIX;
  const float* go = gout + (int64_t)tile * OUT_CH * NPIX;
  const int livec = (int)fo[CH_LIVEC * NPIX];
  const int64_t cst = (int64_t)fo[CH_CSTART * NPIX];
  const int64_t avail = R > cst ? (R - cst) / CHUNK : 0;
  int nc = min(windows, livec);
  const bool whole = (int64_t)nc <= avail;  // the forward's walk, all of it
  if (!whole) nc = (int)avail;

  const float fx = meta[0], fy = meta[1];
  const float bg0 = meta[2], bg1 = meta[3], bg2 = meta[4];
  const float half_w = meta[5], half_h = meta[6];
  const float tx = (float)((tile % ntx) * TILE);
  const float ty = (float)((tile / ntx) * TILE);
  const float pxm = tx + (float)(tid % TILE);  // pixel centre - 0.5, exact
  // the rays as the forward computes them
  const float rx = ray_alpha::pixel_ray(pxm, half_w, fx);
  const float rxx = rx * rx;
  float T[PPT], PwF[PPT], ry[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int pix = tid + k * THREADS;
    const float pym = ty + (float)(tid / TILE + k * ROWS_PER_PASS);
    ry[k] = ray_alpha::pixel_ray(pym, half_h, fy);
    T[k] = 1.0f;
    PwF[k] = 0.0f;
    if (nc == 0) continue;
    const float gr0 = go[0 * NPIX + pix], gr1 = go[1 * NPIX + pix], gr2 = go[2 * NPIX + pix];
    const float ga = go[7 * NPIX + pix];
    const float T_fin = fo[CH_TFINAL * NPIX + pix];
    const float acc_tot = fo[7 * NPIX + pix];
    float tot = gr0 * (fo[0 * NPIX + pix] - T_fin * bg0) + gr1 * (fo[1 * NPIX + pix] - T_fin * bg1)
                + gr2 * (fo[2 * NPIX + pix] - T_fin * bg2) + ga * acc_tot;
    if (REG) {
      const float gn0 = go[3 * NPIX + pix], gn1 = go[4 * NPIX + pix], gn2 = go[5 * NPIX + pix];
      tot = tot + (gn0 * fo[3 * NPIX + pix] + gn1 * fo[4 * NPIX + pix]
                   + gn2 * fo[5 * NPIX + pix]);
      cq[Q_GN0 * NPIX + pix] = gn0;
      cq[Q_GN1 * NPIX + pix] = gn1;
      cq[Q_GN2 * NPIX + pix] = gn2;
      cq[Q_GDEP * NPIX + pix] = go[6 * NPIX + pix];
      cq[Q_GDIST * NPIX + pix] = go[8 * NPIX + pix];
      cq[Q_ACC * NPIX + pix] = acc_tot;
      cq[Q_DTOT * NPIX + pix] = fo[CH_DFINAL * NPIX + pix];
      cq[Q_MED * NPIX + pix] = fo[CH_MEDIDX * NPIX + pix];
    }
    cq[Q_GR0 * NPIX + pix] = gr0;
    cq[Q_GR1 * NPIX + pix] = gr1;
    cq[Q_GR2 * NPIX + pix] = gr2;
    cq[Q_GA * NPIX + pix] = ga;
    cq[Q_TOT * NPIX + pix] = tot;
    cq[Q_TBG * NPIX + pix] = T_fin * (bg0 * gr0 + bg1 * gr1 + bg2 * gr2);
  }

  for (int c = 0; c < nc; ++c) {
    __syncthreads();  // the previous window's payload and ids are read
    const int row0 = base + c * CHUNK;  // row0 + CHUNK <= cap: cap is a multiple
    for (int idx = tid; idx < PC * CHUNK; idx += THREADS) {  // of CHUNK >= seg_e
      const int f = idx / CHUNK;
      const int i = idx % CHUNK;
      sp[i * PC + f] = payload[(int64_t)f * cap + row0 + i];
    }
    for (int i = tid; i < CHUNK; i += THREADS) sgid[i] = slot_gid[row0 + i];
    __syncthreads();

    const int i0 = max(seg_s - row0, 0);
    const int i1 = min(seg_e - row0, CHUNK);
    const int64_t out0 = cst + (int64_t)c * CHUNK;  // the window's first output row
    for (int s0 = 0; s0 < CHUNK; s0 += SUB) {
      const int j0 = max(i0, s0), j1 = min(i1, s0 + SUB);
      for (int i = j0; i < j1; ++i) {
        const float4* pr = reinterpret_cast<const float4*>(sp + i * PC);
        const float4 q0 = pr[0], q1 = pr[1], q2 = pr[2], q3 = pr[3];
        const float p0 = q0.x, p1 = q0.y, p2 = q0.z, op = q0.w;
        const float p4 = q1.x, p5 = q1.y, p6 = q1.z, p7 = q1.w;
        const float p8 = q2.x, p9 = q2.y, p10 = q2.z, p11 = q2.w;
        const float p12 = q3.x, p13 = q3.y, p14 = q3.z, p15 = q3.w;
        const float glob_row = (float)(c * CHUNK + i);
        // the forward's M[:, 0] * rx, the same for the thread's 4 pixels
        const float mat[9] = {p4, p5, p6, p7, p8, p9, p10, p11, p12};
        const float u[3] = {p13, p14, p15};
        const ray_alpha::RayX x = ray_alpha::ray_x(p4, p7, p10, rx);
        float v[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) v[j] = 0.0f;
        float v16 = 0.0f;
        bool any = false;
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          // transmittance chain: K1's operations, rounded one by one
          const ray_alpha::RayPeak r = ray_alpha::ray_peak(mat, u, x, ry[k]);
          const ray_alpha::Alpha al = ray_alpha::alpha_at(r, u, op, r.t);
          const float d0 = r.d0, d1 = r.d1, d2 = r.d2, dd = r.dd, t = r.t;
          const float E = al.E, opE = al.opE, a = al.a;
          if (!ray_alpha::active(t, a)) continue;
          any = true;
          const float Te = T[k];
          T[k] = ray_alpha::transmit(Te, a);

          // gradient chain: contracted into FMAs, held to the plain version
          // by tolerance
          const float* q = cq + tid + k * THREADS;
          const bool cutoff = Te > T_EPS;
          const float w = cutoff ? a * Te : 0.0f;
          const float gr0 = q[Q_GR0 * NPIX], gr1 = q[Q_GR1 * NPIX], gr2 = q[Q_GR2 * NPIX];
          float F = p0 * gr0 + p1 * gr1 + p2 * gr2 + q[Q_GA * NPIX];
          float n0 = 0.0f, n1 = 0.0f, n2 = 0.0f, inv_len = 0.0f;
          float gn0 = 0.0f, gn1 = 0.0f, gn2 = 0.0f;
          if (REG) {
            n0 = p4 * d0 + p7 * d1 + p10 * d2;
            n1 = p5 * d0 + p8 * d1 + p11 * d2;
            n2 = p6 * d0 + p9 * d1 + p12 * d2;
            inv_len = rsqrtf(n0 * n0 + n1 * n1 + n2 * n2 + 1e-7f);
            gn0 = q[Q_GN0 * NPIX];
            gn1 = q[Q_GN1 * NPIX];
            gn2 = q[Q_GN2 * NPIX];
            F = F - (n0 * gn0 + n1 * gn1 + n2 * gn2) * inv_len;  // + (-n / |n|) . gn
          }
          PwF[k] = PwF[k] + w * F;
          // past the cutoff every later weight is zero, so the suffix is
          // exactly zero: the subtraction's rounding residue is dropped
          const float SF = cutoff ? q[Q_TOT * NPIX] - PwF[k] : 0.0f;
          const float dL_da =
              (cutoff ? Te * F : 0.0f) - __fdividef(SF + q[Q_TBG * NPIX], 1.0f - a);
          const float dop_pix = E * dL_da;
          const float dL_dmv = (-0.5f * opE) * dL_da;
          const float s_mv = t * dL_dmv;
          float A_ud, A_dd, dn0, dn1, dn2;
          if (REG) {
            // m = (far t - far near) / ((far - near) t) and dm/dt, t >= near
            const float itc = __fdividef(1.0f, fmaxf(t, NEAR_PLANE));
            const float m = (FAR_PLANE - FAR_X_NEAR * itc) * INV_FAR_MINUS_NEAR;
            const float dL_dm =
                2.0f * w * (m * q[Q_ACC * NPIX] - q[Q_DTOT * NPIX]) * q[Q_GDIST * NPIX];
            const float dm_dt = DM_DT_SCALE * itc * itc;
            const float dL_dt =
                dL_dm * dm_dt + (glob_row == q[Q_MED * NPIX] ? q[Q_GDEP * NPIX] : 0.0f);
            const float q_t = __fdividef(dL_dt, dd);
            A_ud = 2.0f * s_mv - q_t;
            A_dd = t * (s_mv - q_t);
            const float dnh0 = w * gn0;
            const float dnh1 = w * gn1;
            const float dnh2 = w * gn2;
            const float dot_il2 = (dnh0 * n0 + dnh1 * n1 + dnh2 * n2) * (inv_len * inv_len);
            dn0 = (dot_il2 * n0 - dnh0) * inv_len;
            dn1 = (dot_il2 * n1 - dnh1) * inv_len;
            dn2 = (dot_il2 * n2 - dnh2) * inv_len;
          } else {
            A_ud = 2.0f * s_mv;
            A_dd = t * s_mv;
            dn0 = dn1 = dn2 = 0.0f;
          }
          const float yk = ry[k];
          v[0] += w * gr0;
          v[1] += w * gr1;
          v[2] += w * gr2;
          v[3] += dop_pix;
          if (REG) {
            v[4] += A_dd * rxx + dn0 * rx;
            v[5] += 2.0f * (A_dd * rx * yk) + (dn0 * yk + dn1 * rx);
            v[6] += 2.0f * (A_dd * rx) + (dn0 + dn2 * rx);
            v[7] += A_dd * yk * yk + dn1 * yk;
            v[8] += 2.0f * (A_dd * yk) + (dn1 + dn2 * yk);
            v[9] += A_dd + dn2;
          } else {  // no zero terms: x + 0 * y is not x in IEEE arithmetic
            v[4] += A_dd * rxx;
            v[5] += 2.0f * (A_dd * rx * yk);
            v[6] += 2.0f * (A_dd * rx);
            v[7] += A_dd * yk * yk;
            v[8] += 2.0f * (A_dd * yk);
            v[9] += A_dd;
          }
          v[10] += A_ud * rx;
          v[11] += A_ud * yk;
          v[12] += A_ud;
          v[13] += dL_dmv;
          if (STATS) {
            const float4 q4 = pr[4];  // conic 16:19, mean2d 19:21
            const float dxp = q4.w - pxm;
            const float dyp = sp[i * PC + 20] - (ty + (float)(tid / TILE + k * ROWS_PER_PASS));
            const float g = -(op * dL_da) * E;
            const float gx = g * (q4.x * dxp + q4.y * dyp) * halfw;
            const float gy = g * (q4.y * dxp + q4.z * dyp) * halfh;
            v[14] += gx;
            v[15] += gy;
            v16 += fabsf(gx) + fabsf(gy);
          }
        }
        // a warp none of whose pixels was active holds exact zeros
        float* pw = part + (warp * SUB + (i - s0)) * NSP;
        if (__any_sync(FULL, any)) {
          const float sj = warp_sum16(v, lane);
          if ((lane & 1) == 0 && (lane >> 1) < L::NS) pw[lane >> 1] = sj;
          if (STATS) {
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) v16 = v16 + __shfl_xor_sync(FULL, v16, o);
            if (lane == 1) pw[16] = v16;
          }
        } else if (lane < L::NS) {
          pw[lane] = 0.0f;
        }
      }
      __syncthreads();

      // rows s0 .. s0 + SUB of the window, whole rows: the partials of the
      // visited rows added in warp order, zeros elsewhere
      float4* dst = reinterpret_cast<float4*>(rows + (out0 + s0) * OC);
      for (int idx = tid; idx < SUB * OC / 4; idx += THREADS) {
        const int r = idx / (OC / 4);
        const int col0 = (idx % (OC / 4)) * 4;
        float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (r + s0 >= j0 && r + s0 < j1) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = col0 + e;
            const int j = col < NGRAD ? col
                                      : (STATS && col >= GRAD_COLS && col < GRAD_COLS + 3
                                             ? col - (GRAD_COLS - NGRAD) : -1);
            if (j >= 0) {
              float acc = part[r * NSP + j];
#pragma unroll
              for (int w = 1; w < NWARPS; ++w) acc = acc + part[(w * SUB + r) * NSP + j];
              s[e] = acc;
            }
          }
        }
        dst[idx] = make_float4(s[0], s[1], s[2], s[3]);
      }
      __syncthreads();  // the partials are read before the next visits write them
    }
    for (int i = tid; i < CHUNK; i += THREADS) gidc[out0 + i] = sgid[i];
  }

  if (t_miss != nullptr && whole) {  // T after the walk against the forward's
    int miss = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) miss += T[k] != fo[CH_TFINAL * NPIX + tid + k * THREADS];
    miss = __reduce_add_sync(FULL, miss);
    if (lane == 0 && miss) atomicAdd(t_miss, miss);
  }
}

template <bool REG, bool STATS>
int launch(const void* payload, long long cap, const void* slot_gid, const void* bounds,
           const void* fout, const void* gout, const void* meta, const int32_t* order, int ntx,
           int ntiles, float halfw, float halfh, long long R, void* rows, void* gidc,
           void* t_miss, cudaStream_t s) {
  constexpr int smem = Layout<REG, STATS>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel<REG, STATS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bwd_kernel<REG, STATS><<<ntiles, THREADS, smem, s>>>(
      (const float*)payload, cap, (const int32_t*)slot_gid, (const int32_t*)bounds,
      (const float*)fout, (const float*)gout, (const float*)meta, order, ntx, halfw, halfh, R,
      (float*)rows, (int32_t*)gidc, (int32_t*)t_miss);
  return (int)cudaGetLastError();
}

}  // namespace

// rows [R, 16] ([R, 24] with_stats) f32 and gidc [R] int32 come zero-filled
// from the caller: the kernel writes whole rows of the windows the tiles
// walk and leaves any unwritten tail at zero. order: [ntiles] int32 scratch
// (the tile order). t_miss: null, or an int32 counter to which the kernel
// adds the pixels whose recomputed T differs from fout's CH_TFINAL.
extern "C" int gof_rasterize_bwd(int device, const void* payload, long long cap,
                                 const void* slot_gid, const void* bounds, const void* fout,
                                 const void* gout, const void* meta, int ntx, int ntiles,
                                 float halfw, float halfh, int with_stats, int with_reg,
                                 long long R, void* rows, void* gidc, void* order, void* t_miss,
                                 void* stream) {
  if (ntiles <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* ord = (const int32_t*)order;
  order_kernel<<<1, ORDER_THREADS, 0, s>>>((const float*)fout, ntiles, (int32_t*)order);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (with_reg && with_stats)
    return launch<true, true>(payload, cap, slot_gid, bounds, fout, gout, meta, ord, ntx, ntiles,
                              halfw, halfh, R, rows, gidc, t_miss, s);
  if (with_reg)
    return launch<true, false>(payload, cap, slot_gid, bounds, fout, gout, meta, ord, ntx,
                               ntiles, halfw, halfh, R, rows, gidc, t_miss, s);
  if (with_stats)
    return launch<false, true>(payload, cap, slot_gid, bounds, fout, gout, meta, ord, ntx,
                               ntiles, halfw, halfh, R, rows, gidc, t_miss, s);
  return launch<false, false>(payload, cap, slot_gid, bounds, fout, gout, meta, ord, ntx, ntiles,
                              halfw, halfh, R, rows, gidc, t_miss, s);
}
