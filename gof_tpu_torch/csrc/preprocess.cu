// The view preprocess in one pass: one thread per gaussian reads its leaves
// and the camera and writes everything binning, the payload and the blend
// read of it (ops/preprocess.py::preprocess_view).
//
// Replaces no Pallas kernel: gof_tpu's preprocess is elementwise jnp that
// XLA fuses on the TPU (gof_tpu/ops/quadrics.py::preprocess). The port ran
// the same math as eager PyTorch over [P] vectors, ~630 launches a view at
// SH degree 3, plus the 3D filter and a torch.cat of the SH table. This
// kernel runs it where autograd records nothing (eval renders, the field);
// the training step keeps the plain version, which autograd differentiates.
//
// Per gaussian, in ops/quadrics.py::preprocess's operation order (built with
// -fmad=false, so each operation rounds once, as PyTorch's elementwise
// kernels round it):
// - the 3D filter where the leaves come raw: scale = sqrt(exp(s)^2 + f^2),
//   opacity = sigmoid(o) * sqrt(prod(exp(s)^2) / prod(exp(s)^2 + f^2));
// - depth, the projected mean (ndc2Pix), the EWA 2D covariance with the
//   1.3 tan(fov) clamp and the Mip dilation, its coefficient, the conic;
// - the screen radius (cut at alpha 1/255, at most 3 sigma, or 3 sigma where
//   the radius is not tightened) and per-axis half-extents, ceiled;
// - SH colour from the DC and rest tables, read where they lie;
// - the factored view->gaussian transform M = S^-1 Q, u0 = S^-1 t;
// - the tile rect (getRect) and op_eff = opacity * (valid ? coef : 0).
// The two small reductions of the plain version (the quaternion's and the
// view direction's norms, the filter's products) round in the order
// PyTorch's CUDA reduction kernel sums a 3- or 4-wide last dimension:
// norm4 = (a^2 + c^2) + (b^2 + d^2), norm3 = (a^2 + c^2) + b^2,
// prod3 = (a * c) * b (each found on the card against 4M random rows, where
// every other order tried differs in 5-35% of them).
//
// What bounds it: bytes. Each gaussian reads 12 (xyz) + 16 (quaternion)
// + 12 (scale) + 4 (opacity) + 4 (filter) + 1 (active) + 12 + 180 (SH at
// degree 3) bytes and writes 1 + 4 + 8 + 12 + 4 + 4 + 8 + 12 + 36 + 12
// (PreprocessOut) + 16 (rect) + 4 (op_eff) bytes: 362 B, 1.09 GB at 3M
// gaussians, 0.32 ms at 3.35 TB/s; ~300 f32 operations a gaussian are far
// below the card's rate. The SH rest rows (180 bytes each, array of
// structs) are staged per block through shared memory as one contiguous
// span, 16-byte loads where the span is aligned, so a warp's loads
// coalesce; each thread then reads its row from shared memory (a row
// stride of 45 or 48 floats; 45 is odd, so its reads hit distinct banks).
// The wide outputs (mean2d, conic, radius_xy, rgb, M, u0: 8-36 bytes a
// gaussian) go back out the same way: each thread puts its fields into the
// same shared buffer, and the block writes each field's rows as one
// contiguous run; the 1- and 4-byte outputs are stored directly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
// the wide outputs (mean2d, conic, radius_xy, rgb, M, u0), staged through
// shared memory: each one's offset in a thread's 22 floats
constexpr int W_MEAN2D = 0, W_CONIC = 2, W_RXY = 5, W_RGB = 7, W_M = 10, W_U0 = 19;
constexpr int WIDE = 22;
constexpr int TILE = 32;  // TILE_W = TILE_H
constexpr float FRUSTUM_NEAR = 0.2f;

// must match ops/preprocess.py::_Args field for field
struct Args {
  long long P;
  const float* xyz;       // [P, 3]
  const float* rot;       // [P, 4] (w, x, y, z), unnormalised
  const float* scale;     // [P, 3] filtered scales, or log-scales if filter3d
  const float* opac;      // [P] filtered opacities, or logits if filter3d
  const float* filter3d;  // [P] or null
  const uint8_t* active;  // [P] bool or null
  const float* dc;        // DC coefficients: row r at dc + r * sh_stride0; null = no table
  const float* rest;      // coefficient k >= 1 at rest + r * sh_stride1 + 3 (k - 1)
  long long sh_stride0;
  long long sh_stride1;
  int degree;
  int tight;              // radius cut at alpha 1/255 (else 3 sigma)
  const float* wv;        // [4, 4] world -> view
  const float* fp;        // [4, 4] full projection
  const float* campos;    // [3]
  const float* tanfx;     // 0-d
  const float* tanfy;
  int width, height, ntx, nty;
  float kernel_size;
  // outputs, each [P, ...] contiguous
  uint8_t* valid;
  float* depth;
  float* mean2d;     // [P, 2]
  float* conic;      // [P, 3]
  float* coef;
  float* radius;
  float* radius_xy;  // [P, 2]
  float* rgb;        // [P, 3]
  float* M;          // [P, 3, 3]
  float* u0;         // [P, 3]
  int32_t* x0;
  int32_t* y0;
  int32_t* w;
  int32_t* h;
  float* op_eff;
};

// PyTorch's clamps pass NaN through
__device__ __forceinline__ float clamp_min_(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max_(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp_(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ float norm4(float a, float b, float c, float d) {
  return sqrtf((a * a + c * c) + (b * b + d * d));
}
__device__ __forceinline__ float norm3(float a, float b, float c) {
  return sqrtf((a * a + c * c) + b * b);
}
__device__ __forceinline__ float prod3(float a, float b, float c) { return (a * c) * b; }

// binning._floor_to_int then the clamp of gaussian_rects
__device__ __forceinline__ int tile_floor(float x, int hi) {
  return clampi((int)clamp_(floorf(x), -1.0f, (float)hi + 1.0f), 0, hi);
}

// ops/sh.py::eval_sh, coefficient k of channel ch at sh(k, ch)
template <class SH>
__device__ __forceinline__ float eval_sh(int degree, float x, float y, float z, int ch,
                                         const SH& sh) {
  constexpr float C0 = 0.28209479177387814f;
  constexpr float C1 = 0.4886025119029199f;
  constexpr float C20 = 1.0925484305920792f, C21 = -1.0925484305920792f,
                  C22 = 0.31539156525252005f, C23 = -1.0925484305920792f,
                  C24 = 0.5462742152960396f;
  constexpr float C30 = -0.5900435899266435f, C31 = 2.890611442640554f,
                  C32 = -0.4570457994644658f, C33 = 0.3731763325901154f,
                  C34 = -0.4570457994644658f, C35 = 1.445305721320277f,
                  C36 = -0.5900435899266435f;
  float r = C0 * sh(0, ch);
  if (degree > 0) {
    r = ((r - (C1 * y) * sh(1, ch)) + (C1 * z) * sh(2, ch)) - (C1 * x) * sh(3, ch);
    if (degree > 1) {
      const float xx = x * x, yy = y * y, zz = z * z;
      const float xy = x * y, yz = y * z, xz = x * z;
      r = r + (C20 * xy) * sh(4, ch);
      r = r + (C21 * yz) * sh(5, ch);
      r = r + (C22 * ((2.0f * zz - xx) - yy)) * sh(6, ch);
      r = r + (C23 * xz) * sh(7, ch);
      r = r + (C24 * (xx - yy)) * sh(8, ch);
      if (degree > 2) {
        r = r + ((C30 * y) * (3.0f * xx - yy)) * sh(9, ch);
        r = r + ((C31 * xy) * z) * sh(10, ch);
        r = r + ((C32 * y) * ((4.0f * zz - xx) - yy)) * sh(11, ch);
        r = r + ((C33 * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy)) * sh(12, ch);
        r = r + ((C34 * x) * ((4.0f * zz - xx) - yy)) * sh(13, ch);
        r = r + ((C35 * z) * (xx - yy)) * sh(14, ch);
        r = r + ((C36 * x) * (xx - 3.0f * yy)) * sh(15, ch);
      }
    }
  }
  return r;
}

struct ShRow {
  const float* dc;    // 3 floats
  const float* rest;  // coefficient k >= 1 at rest[3 (k - 1) + ch]
  __device__ __forceinline__ float operator()(int k, int ch) const {
    return k == 0 ? dc[ch] : rest[3 * (k - 1) + ch];
  }
};

// One gaussian: its scalar and integer outputs to global memory, its wide
// outputs (mean2d, conic, radius_xy, rgb, M, u0) into `wide`. rest_row: its
// staged SH rest coefficients (degree > 0).
__device__ __forceinline__ void preprocess_one(const Args& a, const long long i,
                                               const float* rest_row, float (&wide)[WIDE]) {
  const float mx = a.xyz[3 * i], my = a.xyz[3 * i + 1], mz = a.xyz[3 * i + 2];
  const float q0 = a.rot[4 * i], q1 = a.rot[4 * i + 1], q2 = a.rot[4 * i + 2],
              q3 = a.rot[4 * i + 3];
  float sc[3];
  float op;
  if (a.filter3d != nullptr) {  // model/gaussians.py: filtered_scaling, filtered_opacity
    const float f = a.filter3d[i];
    const float f2 = f * f;
    float s2[3], t2[3];
    for (int k = 0; k < 3; ++k) {
      const float e = expf(a.scale[3 * i + k]);
      s2[k] = e * e;
      t2[k] = s2[k] + f2;
      sc[k] = sqrtf(t2[k]);
    }
    const float det1 = prod3(s2[0], s2[1], s2[2]);
    const float det2 = prod3(t2[0], t2[1], t2[2]);
    const float sig = 1.0f / (1.0f + expf(-a.opac[i]));
    op = sig * sqrtf(det1 / det2);
  } else {
    sc[0] = a.scale[3 * i];
    sc[1] = a.scale[3 * i + 1];
    sc[2] = a.scale[3 * i + 2];
    op = a.opac[i];
  }

  float wv[16], fp[16];
  for (int k = 0; k < 16; ++k) {
    wv[k] = __ldg(a.wv + k);
    fp[k] = __ldg(a.fp + k);
  }
  const float tanfx = __ldg(a.tanfx), tanfy = __ldg(a.tanfy);

  // depth and projected mean
  const float depth = ((wv[8] * mx + wv[9] * my) + wv[10] * mz) + wv[11];
  const bool in_front = depth > FRUSTUM_NEAR;
  const float pw = (((fp[12] * mx + fp[13] * my) + fp[14] * mz) + fp[15]) + 1e-7f;
  const float ndc_x = (((fp[0] * mx + fp[1] * my) + fp[2] * mz) + fp[3]) / pw;
  const float ndc_y = (((fp[4] * mx + fp[5] * my) + fp[6] * mz) + fp[7]) / pw;
  const float px = ((ndc_x + 1.0f) * (float)a.width - 1.0f) * 0.5f;
  const float py = ((ndc_y + 1.0f) * (float)a.height - 1.0f) * 0.5f;

  // rotation (quadrics._rot_comps)
  const float qn = norm4(q0, q1, q2, q3) + 1e-12f;
  const float qw = q0 / qn, qx = q1 / qn, qy = q2 / qn, qz = q3 / qn;
  float R[3][3];
  R[0][0] = 1.0f - 2.0f * (qy * qy + qz * qz);
  R[0][1] = 2.0f * (qx * qy - qw * qz);
  R[0][2] = 2.0f * (qx * qz + qw * qy);
  R[1][0] = 2.0f * (qx * qy + qw * qz);
  R[1][1] = 1.0f - 2.0f * (qx * qx + qz * qz);
  R[1][2] = 2.0f * (qy * qz - qw * qx);
  R[2][0] = 2.0f * (qx * qz - qw * qy);
  R[2][1] = 2.0f * (qy * qz + qw * qx);
  R[2][2] = 1.0f - 2.0f * (qx * qx + qy * qy);

  // world covariance (cov3d_from_scaling_rotation)
  const float s2a = sc[0] * sc[0], s2b = sc[1] * sc[1], s2c = sc[2] * sc[2];
  float cov[6];
  {
    const int ii[6] = {0, 0, 0, 1, 1, 2}, kk[6] = {0, 1, 2, 1, 2, 2};
    for (int e = 0; e < 6; ++e) {
      const float* Ri = R[ii[e]];
      const float* Rk = R[kk[e]];
      cov[e] = ((Ri[0] * Rk[0]) * s2a + (Ri[1] * Rk[1]) * s2b) + (Ri[2] * Rk[2]) * s2c;
    }
  }

  // view-space mean (cov2d_ewa's pv, view_to_gaussian's tg)
  float pv[3];
  for (int r = 0; r < 3; ++r) {
    pv[r] = ((wv[4 * r] * mx + wv[4 * r + 1] * my) + wv[4 * r + 2] * mz) + wv[4 * r + 3];
  }

  // EWA 2D covariance with the dilation (cov2d_ewa)
  const float tz = pv[2];
  const float limx = 1.3f * tanfx, limy = 1.3f * tanfy;
  const float tx = clamp_(pv[0] / tz, -limx, limx) * tz;
  const float ty = clamp_(pv[1] / tz, -limy, limy) * tz;
  const float inv_tz = 1.0f / tz;
  const float fx = (float)a.width / (2.0f * tanfx);  // Camera.focal_x
  const float fy = (float)a.height / (2.0f * tanfy);
  const float j00 = fx * inv_tz;
  const float j02 = ((-fx * tx) * inv_tz) * inv_tz;
  const float j11 = fy * inv_tz;
  const float j12 = ((-fy * ty) * inv_tz) * inv_tz;
  float a0[3], a1[3];
  for (int k = 0; k < 3; ++k) {
    a0[k] = j00 * wv[k] + j02 * wv[8 + k];
    a1[k] = j11 * wv[4 + k] + j12 * wv[8 + k];
  }
  auto quad = [&](const float* u, const float* v) {
    return (((((u[0] * v[0]) * cov[0] + (u[1] * v[1]) * cov[3]) + (u[2] * v[2]) * cov[5])
             + (u[0] * v[1] + u[1] * v[0]) * cov[1])
            + (u[0] * v[2] + u[2] * v[0]) * cov[2])
           + (u[1] * v[2] + u[2] * v[1]) * cov[4];
  };
  const float cxx = quad(a0, a0), cxy = quad(a0, a1), cyy = quad(a1, a1);
  const float ks = a.kernel_size;
  const float raw_det0 = cxx * cyy - cxy * cxy;
  const float raw_det1 = (cxx + ks) * (cyy + ks) - cxy * cxy;
  const float det0 = clamp_min_(raw_det0, 1e-6f);
  const float det1 = clamp_min_(raw_det1, 1e-6f);
  float coef = sqrtf(det0 / (det1 + 1e-6f) + 1e-6f);
  if (raw_det0 <= 1e-6f || raw_det1 <= 1e-6f) coef = 0.0f;
  const float c0 = cxx + ks, c1 = cxy, c2 = cyy + ks;

  // conic and screen extent (preprocess, screen_extent)
  const float det = c0 * c2 - c1 * c1;
  const bool nondegenerate = det != 0.0f;
  const float det_inv = 1.0f / (nondegenerate ? det : 1.0f);
  const float mid = 0.5f * (c0 + c2);
  const float disc = sqrtf(clamp_min_(mid * mid - det, 0.1f));
  const float lambda1 = mid + disc;
  float nsig = 3.0f;
  if (a.tight) {
    nsig = sqrtf(2.0f * logf(clamp_min_((op * coef) * 255.0f, 1.001f)));
    nsig = clamp_max_(nsig, 3.0f);
  }
  const float radius = ceilf(nsig * sqrtf(clamp_min_(lambda1, 1e-12f)));
  const float rx = ceilf(nsig * sqrtf(clamp_min_(c0, 1e-12f)));
  const float ry = ceilf(nsig * sqrtf(clamp_min_(c2, 1e-12f)));

  bool valid = in_front && nondegenerate && radius > 0.0f;
  if (a.active != nullptr) valid = valid && a.active[i] != 0;

  // colour (sh.sh_to_rgb)
  float rgb[3];
  if (a.dc == nullptr) {  // no table: every coefficient 0
    for (int ch = 0; ch < 3; ++ch) rgb[ch] = 0.5f;
  } else {
    const float* campos = a.campos;
    const float dx = mx - __ldg(campos), dy = my - __ldg(campos + 1), dz = mz - __ldg(campos + 2);
    const float dn = norm3(dx, dy, dz) + 1e-12f;
    const float x = dx / dn, y = dy / dn, z = dz / dn;
    const ShRow row{a.dc + i * a.sh_stride0, rest_row};
    for (int ch = 0; ch < 3; ++ch) {
      const float c = eval_sh(a.degree, x, y, z, ch, row) + 0.5f;
      rgb[ch] = isnan(c) ? c : fmaxf(c, 0.0f);
    }
  }

  // factored view -> gaussian transform (view_to_gaussian)
  float Rv[3][3];
  for (int r = 0; r < 3; ++r) {
    for (int j = 0; j < 3; ++j) {
      Rv[r][j] = (wv[4 * r] * R[0][j] + wv[4 * r + 1] * R[1][j]) + wv[4 * r + 2] * R[2][j];
    }
  }
  float se[3];
  for (int k = 0; k < 3; ++k) se[k] = sqrtf(sc[k] * sc[k] + 1e-7f);

  // tile rect (binning.gaussian_rects)
  const float inv_tile = 1.0f / TILE;
  const int x0 = tile_floor((px - rx) * inv_tile, a.ntx);
  const int y0 = tile_floor((py - ry) * inv_tile, a.nty);
  const int x1 = tile_floor(((px + rx) + (float)TILE - 1.0f) * inv_tile, a.ntx);
  const int y1 = tile_floor(((py + ry) + (float)TILE - 1.0f) * inv_tile, a.nty);

  // the scalars and ints go straight out (neighbouring threads, neighbouring
  // addresses); the wider fields through the block's shared buffer
  a.valid[i] = valid;
  a.depth[i] = depth;
  a.coef[i] = coef;
  a.radius[i] = radius;
  a.x0[i] = x0;
  a.y0[i] = y0;
  a.w[i] = valid ? max(x1 - x0, 0) : 0;
  a.h[i] = valid ? max(y1 - y0, 0) : 0;
  a.op_eff[i] = op * (valid ? coef : 0.0f);
  wide[W_MEAN2D] = px;
  wide[W_MEAN2D + 1] = py;
  wide[W_CONIC] = c2 * det_inv;
  wide[W_CONIC + 1] = -c1 * det_inv;
  wide[W_CONIC + 2] = c0 * det_inv;
  wide[W_RXY] = rx;
  wide[W_RXY + 1] = ry;
  for (int ch = 0; ch < 3; ++ch) wide[W_RGB + ch] = rgb[ch];
  for (int r = 0; r < 3; ++r) {
    for (int j = 0; j < 3; ++j) wide[W_M + 3 * r + j] = Rv[j][r] / se[r];
    wide[W_U0 + r] = -((Rv[0][r] * pv[0] + Rv[1][r] * pv[1]) + Rv[2][r] * pv[2]) / se[r];
  }
}

// a thread's W floats at OFF of `wide` into the block's run of the field
template <int W, int OFF>
__device__ __forceinline__ void to_shared(float* out, const float (&wide)[WIDE]) {
#pragma unroll
  for (int j = 0; j < W; ++j) out[OFF * THREADS + threadIdx.x * W + j] = wide[OFF + j];
}

// the block's run of a field, nrows rows of W floats, out to global memory
template <int W, int OFF>
__device__ __forceinline__ void to_global(float* dst, const float* out, long long row0,
                                          long long nrows) {
  float* d = dst + row0 * W;
  const float* src = out + OFF * THREADS;
  for (long long k = threadIdx.x; k < nrows * W; k += THREADS) d[k] = src[k];
}

__global__ void __launch_bounds__(THREADS) preprocess_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* rest_rows = reinterpret_cast<float*>(smem4);
  const long long row0 = (long long)blockIdx.x * THREADS;
  const long long i = row0 + threadIdx.x;
  const bool live = i < a.P;

  // stage the block's rest rows as one contiguous span
  const bool staged = a.degree > 0 && a.dc != nullptr;
  if (staged) {
    // through the last row's last coefficient in use, not its whole stride
    const long long nrows = min((long long)THREADS, a.P - row0);
    const long long n = (nrows - 1) * a.sh_stride1 + 3 * ((a.degree + 1) * (a.degree + 1) - 1);
    const float* src = a.rest + row0 * a.sh_stride1;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const long long n4 = n >> 2;
      const float4* s4 = reinterpret_cast<const float4*>(src);
      for (long long k = threadIdx.x; k < n4; k += THREADS) smem4[k] = __ldg(s4 + k);
      for (long long k = 4 * n4 + threadIdx.x; k < n; k += THREADS) rest_rows[k] = __ldg(src + k);
    } else {
      for (long long k = threadIdx.x; k < n; k += THREADS) rest_rows[k] = __ldg(src + k);
    }
    __syncthreads();
  }

  float wide[WIDE];
  if (live) preprocess_one(a, i, staged ? rest_rows + threadIdx.x * a.sh_stride1 : nullptr, wide);
  // every thread has read its SH row: the buffer now takes the wide outputs,
  // field by field, each a contiguous run of the block's rows
  __syncthreads();
  float* out = rest_rows;
  if (live) {
    to_shared<2, W_MEAN2D>(out, wide);
    to_shared<3, W_CONIC>(out, wide);
    to_shared<2, W_RXY>(out, wide);
    to_shared<3, W_RGB>(out, wide);
    to_shared<9, W_M>(out, wide);
    to_shared<3, W_U0>(out, wide);
  }
  __syncthreads();
  const long long nrows = min((long long)THREADS, a.P - row0);
  to_global<2, W_MEAN2D>(a.mean2d, out, row0, nrows);
  to_global<3, W_CONIC>(a.conic, out, row0, nrows);
  to_global<2, W_RXY>(a.radius_xy, out, row0, nrows);
  to_global<3, W_RGB>(a.rgb, out, row0, nrows);
  to_global<9, W_M>(a.M, out, row0, nrows);
  to_global<3, W_U0>(a.u0, out, row0, nrows);
}

}  // namespace

// args: an Args (a void pointer: a type of this file's unnamed namespace in
// the signature would give the entry internal linkage)
extern "C" int gof_preprocess(int device, const void* argp, void* stream) {
  const Args* args = static_cast<const Args*>(argp);
  if (args->P <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (args->P + THREADS - 1) / THREADS;
  const size_t sh = args->degree > 0 && args->dc != nullptr
                        ? (size_t)THREADS * (size_t)args->sh_stride1 * sizeof(float)
                        : 0;
  const size_t smem = sh > WIDE * THREADS * sizeof(float) ? sh : WIDE * THREADS * sizeof(float);
  preprocess_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
