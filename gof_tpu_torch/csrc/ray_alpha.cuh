// The ray-gaussian alpha and transmittance chain shared by the forward blend
// (rasterize_fwd.cu), its recomputation in the backward (rasterize_bwd.cu)
// and the opacity field (integrate.cu).
//
// Per ray r = (rx, ry, 1) and gaussian row (op, M row-major, u0):
//   d = M r, ud = u0.d, dd = d.d + 1e-12, t = -ud / dd,
//   v = u0 + t* d (t* = t in the blend, min(t, z) in the field),
//   mv = v.v, E = exp(-mv / 2), a = min(0.99, op E),
//   active: t > 0.2 and a >= 1/255;  T <- T (1 - a) per active row.
// Every operation is written as an intrinsic that nvcc never contracts into
// an FMA (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), in the plain
// PyTorch versions' order, so the chain rounds as they do whatever -fmad
// the including source is built with: T, t and the median row keep the
// plain versions' bits, and the backward recomputes the forward's T bit
// for bit.

#pragma once

#include <cuda_runtime.h>

namespace ray_alpha {
namespace {  // one copy per including source

constexpr float NEAR_PLANE = 0.2f;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = 0.99f;

// A pixel's ray slope: ((p + 0.5) - half) / focal, p the pixel's integer
// coordinate (exact in f32).
__device__ __forceinline__ float pixel_ray(float p, float half, float focal) {
  return __fdiv_rn(__fsub_rn(__fadd_rn(p, 0.5f), half), focal);
}

// The ray's terms that depend on rx only, M[:, 0] * rx: a tile's pixels of
// one column share them for every row.
struct RayX {
  float x0, x1, x2;
};

__device__ __forceinline__ RayX ray_x(float m00, float m10, float m20, float rx) {
  return {__fmul_rn(m00, rx), __fmul_rn(m10, rx), __fmul_rn(m20, rx)};
}

// d = M r, dd and the peak t along the ray.
struct RayPeak {
  float d0, d1, d2, dd, t;
};

// m: M row-major (m[0..8]), u: u0; x: ray_x of the row and rx.
__device__ __forceinline__ RayPeak ray_peak(const float (&m)[9], const float (&u)[3], RayX x,
                                            float ry) {
  RayPeak r;
  r.d0 = __fadd_rn(__fadd_rn(x.x0, __fmul_rn(m[1], ry)), m[2]);
  r.d1 = __fadd_rn(__fadd_rn(x.x1, __fmul_rn(m[4], ry)), m[5]);
  r.d2 = __fadd_rn(__fadd_rn(x.x2, __fmul_rn(m[7], ry)), m[8]);
  const float ud = __fadd_rn(__fadd_rn(__fmul_rn(u[0], r.d0), __fmul_rn(u[1], r.d1)),
                             __fmul_rn(u[2], r.d2));
  r.dd = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(r.d0, r.d0), __fmul_rn(r.d1, r.d1)), __fmul_rn(r.d2, r.d2)),
      1e-12f);
  r.t = __fdiv_rn(-ud, r.dd);
  return r;
}

// The gaussian's value along the ray at ts and its alpha.
struct Alpha {
  float E, opE, a;
};

__device__ __forceinline__ Alpha alpha_at(const RayPeak& r, const float (&u)[3], float op,
                                          float ts) {
  const float v0 = __fadd_rn(u[0], __fmul_rn(ts, r.d0));
  const float v1 = __fadd_rn(u[1], __fmul_rn(ts, r.d1));
  const float v2 = __fadd_rn(u[2], __fmul_rn(ts, r.d2));
  const float mv =
      __fadd_rn(__fadd_rn(__fmul_rn(v0, v0), __fmul_rn(v1, v1)), __fmul_rn(v2, v2));
  Alpha al;
  al.E = expf(__fmul_rn(-0.5f, mv));
  al.opE = __fmul_rn(op, al.E);
  al.a = al.opE > ALPHA_MAX ? ALPHA_MAX : al.opE;
  return al;
}

__device__ __forceinline__ bool active(float t, float a) {
  return t > NEAR_PLANE && a >= ALPHA_MIN;
}

// T after an active row.
__device__ __forceinline__ float transmit(float T, float a) {
  return __fmul_rn(T, __fsub_rn(1.0f, a));
}

}  // namespace
}  // namespace ray_alpha
