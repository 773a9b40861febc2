// The CHUNK-row windows that the forward blend (rasterize_fwd.cu) and the
// opacity field (integrate.cu) walk: their count, and their staging in
// shared memory.
//
// An item (a tile, or a block of query points) walks the windows of its
// segment [seg_s, seg_e) of the depth-sorted payload rows from the aligned
// base floor(seg_s / CHUNK) * CHUNK, so its work is known before the
// kernel: the window count.
//
// Staging: the payload is [16, cap] column-major; a window lands in shared
// memory row-major, ROW_FLOATS floats a row (16 and 4 of padding), so a row
// reads back as four float4 broadcasts at fixed offsets. Each float is one
// 4-byte cp.async: a warp's 32 copies take 8 consecutive rows of 4 columns,
// one from each float4 of the row (four whole 32-byte sectors of the
// payload), and the 20-float row pitch puts the 32 copies in 32 different
// banks. The copies run while the block computes the previous window.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace windows {
namespace {  // one copy per including source

constexpr int CHUNK = 128;
constexpr int P_COLS = 16;     // payload columns staged per row
constexpr int ROW_FLOATS = 20;  // a staged row's pitch
constexpr int WINDOW_FLOATS = CHUNK * ROW_FLOATS;

__device__ __forceinline__ int count(int s, int e) {
  return e > s ? (e - (s / CHUNK) * CHUNK + CHUNK - 1) / CHUNK : 0;
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Start copying rows [row0, row0 + CHUNK) of the payload into buf and
// commit them as one group; row0 + CHUNK <= cap (cap is a multiple of CHUNK).
// Warp w's lane (q, r) copies element (q + w) % 4 of float4 q of rows
// 8 (w / 4) + r + 2 W n, for W warps (a multiple of 4): a thread's copies
// lie at fixed strides in both memories.
template <int THREADS>
__device__ __forceinline__ void stage(float* buf, const float* __restrict__ payload, int64_t cap,
                                      int row0, int tid) {
  constexpr int W = THREADS / 32;
  constexpr int COPIES = CHUNK * P_COLS / THREADS;
  static_assert(W % 4 == 0 && COPIES * THREADS == CHUNK * P_COLS, "whole warp quads");
  const int lane = tid & 31, w = tid >> 5;
  const int f = 4 * (lane >> 3) + (((lane >> 3) + w) & 3);  // the column
  const int i0 = (w >> 2) * 8 + (lane & 7);                 // the first row
  const float* src = payload + (int64_t)f * cap + row0 + i0;
  float* dst = buf + i0 * ROW_FLOATS + f;
#pragma unroll
  for (int n = 0; n < COPIES; ++n) copy4(dst + n * 2 * W * ROW_FLOATS, src + n * 2 * W);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for this thread's staged copies; a barrier then publishes them.
__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Row i of a staged window as its four float4s.
struct Row {
  float4 q0, q1, q2, q3;
};

__device__ __forceinline__ Row load_row(const float* buf, int i) {
  const float4* r = reinterpret_cast<const float4*>(buf + i * ROW_FLOATS);
  return {r[0], r[1], r[2], r[3]};
}

}  // namespace
}  // namespace windows
