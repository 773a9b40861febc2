// The row-gather and scatter-add probes: eight kernels that answer, on this
// card, the question gof_tpu's two cost probes asked of the TPU (how fast can
// the chip gather rows from a table and scatter-add rows into one, and which
// way: a plain index, a one-hot product on the matrix unit, int8, a paged
// table?). gof_tpu built K2 (expand.cu) and its payload path on the TPU's
// answer; these kernels give the H100's.
//
// Replaces the Pallas kernels of scripts/pallas_gather_probe.py (K6-K10) and
// scripts/mxu_gather_probe.py (K11-K13). Each computes the TPU kernel's
// function, its edge behaviour included (ops/gather_probes.py states it and
// holds the plain PyTorch versions). On the TPU the table lived in VMEM
// (2 MiB); a block's shared memory holds at most 227 KB, so here the table
// lives in the 50 MB L2 and the one-hot products stage one page (K8) or one
// 64-column slab (K11, K13) at a time.
//
// Index layout as in the scripts: idx [nchunks, 1, chunk] int32 is read as
// one flat [n] stream, except where the chunk matters (K12's base, K13's
// page). Every kernel takes its shapes as arguments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr long long MAX_BLOCKS = 132LL * 32;  // grid-stride beyond 32 blocks per SM

long long stride_blocks(long long work) {
  const long long b = (work + THREADS - 1) / THREADS;
  return b < MAX_BLOCKS ? b : MAX_BLOCKS;
}

// ---------------------------------------------------------------------------
// K6: out[r] = table[idx[r]] with jnp.take's fill mode: an index in
// [-page, 0) wraps, any other index outside [0, page) gives a zero row.
//
// Replaces scripts/pallas_gather_probe.py:38 take_kernel (call :44).
// What bounds it: bytes. The output (n * w * 4 bytes, 64 MiB at the script's
// shapes) is written once; the table (2 MiB) stays in L2. Design: one thread
// per output element with 4-byte loads, so a warp writes one 128-byte row;
// K7 is the same function with 16-byte accesses, and the pair measures what
// the access width costs here.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
take_kernel(const int32_t* __restrict__ idx, int64_t n, const float* __restrict__ table,
            int64_t page, int64_t w, float* __restrict__ out) {
  const int64_t total = n * w;
  for (int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * THREADS) {
    const int64_t r = t / w;
    const int64_t c = t - r * w;
    int64_t j = idx[r];
    if (j < 0) j += page;
    out[t] = (j >= 0 && j < page) ? __ldg(table + j * w + c) : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// K7: out[r] = table[idx[r]] with the TPU ref indexer's semantics: a
// negative index wraps once, then the row is clamped to [0, page - 1].
//
// Replaces scripts/pallas_gather_probe.py:63 vidx_kernel (call :69).
// What bounds it: bytes, as K6. Design: one thread per 16 bytes of a row
// (float4 loads and stores), so a warp moves four 128-byte rows per
// instruction; needs w % 4 == 0 and 16-byte aligned tensors (the wrapper
// checks both).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
vidx_kernel(const int32_t* __restrict__ idx, int64_t n, const float4* __restrict__ table,
            int64_t page, int64_t w4, float4* __restrict__ out) {
  const int64_t total = n * w4;
  for (int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * THREADS) {
    const int64_t r = t / w4;
    const int64_t q = t - r * w4;
    int64_t j = idx[r];
    if (j < 0) j += page;
    j = j < 0 ? 0 : (j >= page ? page - 1 : j);
    out[t] = __ldg(table + j * w4 + q);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core helpers (mma.sync; fragment layouts of the PTX ISA, "Matrix
// Fragments for mma.m16n8k16" and "... m16n8k32"). groupID g = lane / 4 and
// threadID_in_group tg = lane % 4.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 one-hot entries (k, k + 1) of a row whose hit lies e columns
// past k: bf16 1.0 (0x3F80) in the low half for e == 0, the high for e == 1.
__device__ __forceinline__ uint32_t onehot_bf16x2(int e) {
  return e == 0 ? 0x3F80u : (e == 1 ? 0x3F800000u : 0u);
}

// Four int8 one-hot entries (k .. k + 3): byte e is 1 for e in [0, 4).
__device__ __forceinline__ uint32_t onehot_s8x4(int e) {
  return (unsigned)e < 4u ? 1u << (8 * e) : 0u;
}

// A row's position inside a window of `size` rows starting at `start`, or
// NO_HIT when the row lies outside it. Unsigned, so any int32 index wraps as
// the TPU's int32 arithmetic does and never overflows.
constexpr int NO_HIT = -64;  // below every k - kb - offset the fragments test

__device__ __forceinline__ int local_row(int32_t ix, uint32_t start, uint32_t size) {
  const uint32_t l = (uint32_t)ix - start;
  return l < size ? (int)l : NO_HIT;
}

// ---------------------------------------------------------------------------
// K8: out[r] = bf16(table)[idx[r]] as f32, computed as gof_tpu computed it:
// for each page of page_b rows, a one-hot [rows, page_b] bf16 matrix times
// the page in bf16, summed in f32. An index outside [0, npages * page_b)
// gives a zero row. Exact: one-hot times bf16 adds exact zeros.
//
// Replaces scripts/pallas_gather_probe.py:88 onehot_kernel (call :101).
// What bounds it: the product, 2 * n * npages * page_b * w operations
// (5.5e11 at the script's shapes: 0.556 ms at 989 TFLOP/s bf16) against 68
// MiB of bytes (21 us): the one-hot product is what the probe measures, the
// matrix unit used as a gather engine. Design: mma.sync m16n8k16 (bf16 in,
// f32 accumulate). A first pass rounds the table to bf16 and transposes it
// (tT [w][page], 1 MiB at the script's shapes), so a block stages a page
// with 16-byte copies. A block owns 512 rows (8 warps x 4 m-tiles) and one
// slab of 32 columns, 4 n-tiles of 8 (the slabs on grid.y; w % 32 == 0), with
// all its accumulators in registers (64 f32 per thread), and walks the
// pages; each page's slab is staged in dynamic shared memory (32 columns x
// page_b rows, 128 KB at page_b = 2048, padded by 8 rows so the B-fragment
// loads are conflict-free). A is the one-hot tile: each row hits one
// 16-wide k-step of its page, so its two A words are worked out once per
// page and each k-step only selects them or zero; each B fragment serves 4
// m-tiles.
// ---------------------------------------------------------------------------
constexpr int OH_SLAB = 32;
constexpr int OH_NT = OH_SLAB / 8;
constexpr int OH_MT = 4;
constexpr int OH_ROWS = NWARPS * OH_MT * 16;  // 512 rows per block
constexpr int OH_KPAD = 8;                    // pad rows per staged column

// tT[c][k2 pair] = bf16(table[2 k2, c]), bf16(table[2 k2 + 1, c]) (rows k, k + 1)
__global__ void __launch_bounds__(THREADS)
onehot_prep_kernel(const float* __restrict__ table, int64_t page, int64_t w,
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

__global__ void __launch_bounds__(THREADS)
onehot_kernel(const int32_t* __restrict__ idx, int64_t n, const uint32_t* __restrict__ tT,
              int64_t w, int npages, int page_b, float* __restrict__ out) {
  extern __shared__ uint32_t sB[];           // [OH_SLAB][ks] bf16 pairs (rows k, k + 1)
  const int ks = (page_b + OH_KPAD) / 2;      // words per staged column
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int64_t row0 = (int64_t)blockIdx.x * OH_ROWS + warp * (OH_MT * 16);
  const int64_t c0 = (int64_t)blockIdx.y * OH_SLAB;
  const int64_t page = (int64_t)npages * page_b;

  int32_t ix[OH_MT][2];
#pragma unroll
  for (int mt = 0; mt < OH_MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t r = row0 + mt * 16 + g + 8 * h;
      ix[mt][h] = r < n ? idx[r] : -1;
    }
  float acc[OH_MT][OH_NT][4];
#pragma unroll
  for (int mt = 0; mt < OH_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < OH_NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0f;

  const int chunks = page_b / 8;  // 16-byte chunks per staged column
  for (int b = 0; b < npages; ++b) {
    __syncthreads();  // every warp is done with the previous page
    for (int t = threadIdx.x; t < OH_NT * 8 * chunks; t += THREADS) {
      const int c = t / chunks, q = t - c * chunks;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(tT + ((c0 + c) * page + (int64_t)b *
                                                                 page_b) / 2) + q);
      *reinterpret_cast<uint4*>(sB + c * ks + 4 * q) = v;
    }
    __syncthreads();

    // the k-step each row hits (-1: none on this page) and its A words there
    int hit[OH_MT][2];
    uint32_t alo[OH_MT][2], ahi[OH_MT][2];
#pragma unroll
    for (int mt = 0; mt < OH_MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = local_row(ix[mt][h], (uint32_t)b * (uint32_t)page_b, (uint32_t)page_b);
        const int e = (l & 15) - 2 * tg;
        hit[mt][h] = l >= 0 ? (l & ~15) : -1;
        alo[mt][h] = onehot_bf16x2(e);      // k-step rows 2tg, 2tg + 1
        ahi[mt][h] = onehot_bf16x2(e - 8);  // rows 2tg + 8, 2tg + 9
      }

    for (int kb = 0; kb < page_b; kb += 16) {
      uint32_t bf[OH_NT][2];
#pragma unroll
      for (int nt = 0; nt < OH_NT; ++nt) {
        const uint32_t* col = sB + (nt * 8 + g) * ks + kb / 2 + tg;
        bf[nt][0] = col[0];  // rows kb + 2tg, +1
        bf[nt][1] = col[4];  // rows kb + 2tg + 8, +9
      }
#pragma unroll
      for (int mt = 0; mt < OH_MT; ++mt) {
        const bool h0 = hit[mt][0] == kb, h1 = hit[mt][1] == kb;  // rows g, g + 8
        const uint32_t a[4] = {h0 ? alo[mt][0] : 0u, h1 ? alo[mt][1] : 0u,
                               h0 ? ahi[mt][0] : 0u, h1 ? ahi[mt][1] : 0u};
#pragma unroll
        for (int nt = 0; nt < OH_NT; ++nt) mma_bf16_16816(acc[mt][nt], a, bf[nt][0], bf[nt][1]);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < OH_MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t r = row0 + mt * 16 + g + 8 * h;
      if (r >= n) continue;
#pragma unroll
      for (int nt = 0; nt < OH_NT; ++nt)
        *reinterpret_cast<float2*>(out + r * w + c0 + nt * 8 + 2 * tg) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
    }
}

// ---------------------------------------------------------------------------
// K9: out[PAGE, w] = segment sum of rows[r] at idx[r] (a zeroed output the
// wrapper allocates), with `.at[idx].add`'s index semantics: an index in
// [-page, 0) wraps, any other index outside [0, page) is dropped.
//
// Replaces scripts/pallas_gather_probe.py:120 scat_kernel (call :132).
// What bounds it: bytes (the rows, 64 MiB, read once) and the L2's atomic
// rate: 16.8M f32 adds into 524k addresses at the script's shapes. Design:
// one thread per row element, atomicAdd (a fire-and-forget RED in L2);
// neighbouring threads add neighbouring columns of one row. The sums depend
// on the order the adds arrive in; K10 is the deterministic twin.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
scat_kernel(const int32_t* __restrict__ idx, int64_t n, const float* __restrict__ rows,
            int64_t w, int64_t page, float* __restrict__ out) {
  const int64_t total = n * w;
  for (int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * THREADS) {
    const int64_t r = t / w;
    int64_t j = idx[r];
    if (j < 0) j += page;
    if (j >= 0 && j < page) atomicAdd(out + j * w + (t - r * w), __ldg(rows + t));
  }
}

// ---------------------------------------------------------------------------
// K10: the same segment sum, deterministic: the TPU kernel's one-hot
// product drops every index outside [0, page) (no wrap), and here every
// (output row, column) is summed in ascending row order, with no atomics,
// so the result is bit-identical from launch to launch. The wrapper sorts
// the ids with a stable torch.sort (invalid ids to the sentinel `page`) and
// finds each id's run with searchsorted: perm [n] int64, starts [page + 1].
//
// Replaces scripts/pallas_gather_probe.py:152 scatmxu_kernel (call :169).
// What bounds it: bytes (the rows, read once through the permutation; at
// the script's shapes the 64 MiB of rows exceed L2, so each 128-byte row is
// a random DRAM read). A one-hot f32 product on the tensor cores would run
// in TF32 and round the rows, so there is none. Design: one warp per output
// row, lane = column: each step reads one whole 128-byte row.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
scatmxu_kernel(const int64_t* __restrict__ perm, const int64_t* __restrict__ starts,
               const float* __restrict__ rows, int64_t w, int64_t page,
               float* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  for (int64_t o = ((int64_t)blockIdx.x * THREADS + threadIdx.x) / 32; o < page;
       o += (int64_t)gridDim.x * NWARPS) {
    const int64_t s = starts[o], e = starts[o + 1];
    for (int64_t c = lane; c < w; c += 32) {
      float acc = 0.0f;
      for (int64_t j = s; j < e; ++j) acc = acc + __ldg(rows + perm[j] * w + c);
      out[o * w + c] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// K11 and K13 share this device code: rows [0, ch) of one chunk, one
// 64-column slab, out[r] = int32(tbl[idx[r] - start]) when idx[r] lies in
// [start, start + wg), else 0, computed as the one-hot int8 product
// [ch, wg] x [wg, 64] with int32 accumulation (exact).
//
// What bounds it: bytes, barely: the int32 output (256 MiB at the scripts'
// shapes: 81 us) against the product's 2.75e11 int8 operations (0.139 ms at
// 1,979 TOP/s). Design: mma.sync m16n8k32 (s8 in, s32 accumulate). The
// 256 KB page does not fit in shared memory, so each block stages one
// 64-column slab of it, all wg rows, transposed (128 KB at wg = 2048, padded
// by 16 rows per column: conflict-free fragment loads), and its 8 warps walk
// the chunk 32 rows (2 m-tiles, 64 s32 accumulators) at a time. The staging
// reads 4 rows x 4 columns (4-byte loads) per thread and transposes the 4x4
// bytes with byte permutes into one word per column. Needs wg % 64 == 0 and
// c8 % 64 == 0 (the wrapper checks).
// ---------------------------------------------------------------------------
constexpr int S8_SLAB = 64;
constexpr int S8_NT = S8_SLAB / 8;
constexpr int S8_MT = 2;
constexpr int S8_KPAD = 16;  // pad rows (bytes) per staged column

__device__ __forceinline__ void onehot_s8_slab(const int32_t* __restrict__ idx, int64_t ch,
                                               const int8_t* __restrict__ tbl, int64_t wg,
                                               int64_t c8, uint32_t start, bool valid,
                                               int32_t* __restrict__ out, uint32_t* sB) {
  const int ks = (int)((wg + S8_KPAD) / 4);  // words per staged column
  const int64_t c0 = (int64_t)blockIdx.y * S8_SLAB;
  // staging: thread = (k quad: 16 per round, column quad: 16 per slab); a
  // warp holds 16 k quads x 2 column quads, which land in 32 distinct banks
  {
    const int kq = threadIdx.x % 16;
    const int nq = threadIdx.x / 16;
    for (int64_t k40 = 0; k40 < wg / 4; k40 += 16) {
      const int64_t k4 = k40 + kq;
      const int8_t* p = tbl + (k4 * 4) * c8 + c0 + nq * 4;
      const uint32_t r0 = __ldg(reinterpret_cast<const uint32_t*>(p));
      const uint32_t r1 = __ldg(reinterpret_cast<const uint32_t*>(p + c8));
      const uint32_t r2 = __ldg(reinterpret_cast<const uint32_t*>(p + 2 * c8));
      const uint32_t r3 = __ldg(reinterpret_cast<const uint32_t*>(p + 3 * c8));
      const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
      const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
      const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
      const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
      uint32_t* d = sB + (nq * 4) * ks + k4;
      d[0] = __byte_perm(lo01, lo23, 0x5410);       // column nq*4:     rows k4*4 .. +3
      d[ks] = __byte_perm(lo01, lo23, 0x7632);      // column nq*4 + 1
      d[2 * ks] = __byte_perm(hi01, hi23, 0x5410);  // column nq*4 + 2
      d[3 * ks] = __byte_perm(hi01, hi23, 0x7632);  // column nq*4 + 3
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  for (int64_t m0 = warp * (S8_MT * 16); m0 < ch; m0 += NWARPS * S8_MT * 16) {
    int lc[S8_MT][2];
#pragma unroll
    for (int mt = 0; mt < S8_MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t r = m0 + mt * 16 + g + 8 * h;
        lc[mt][h] = (valid && r < ch) ? local_row(idx[r], start, (uint32_t)wg) : NO_HIT;
      }
    int acc[S8_MT][S8_NT][4];
#pragma unroll
    for (int mt = 0; mt < S8_MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < S8_NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0;

    for (int kb = 0; kb < wg; kb += 32) {
      uint32_t a[S8_MT][4];
#pragma unroll
      for (int mt = 0; mt < S8_MT; ++mt) {
        const int e0 = lc[mt][0] - kb - 4 * tg;  // row g
        const int e1 = lc[mt][1] - kb - 4 * tg;  // row g + 8
        a[mt][0] = onehot_s8x4(e0);
        a[mt][1] = onehot_s8x4(e1);
        a[mt][2] = onehot_s8x4(e0 - 16);
        a[mt][3] = onehot_s8x4(e1 - 16);
      }
#pragma unroll
      for (int nt = 0; nt < S8_NT; ++nt) {
        const uint32_t* col = sB + (nt * 8 + g) * ks + kb / 4 + tg;
        const uint32_t b0 = col[0];  // rows kb + 4tg .. +3
        const uint32_t b1 = col[4];  // rows kb + 16 + 4tg .. +3
#pragma unroll
        for (int mt = 0; mt < S8_MT; ++mt) mma_s8_16832(acc[mt][nt], a[mt], b0, b1);
      }
    }

#pragma unroll
    for (int mt = 0; mt < S8_MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t r = m0 + mt * 16 + g + 8 * h;
        if (r >= ch) continue;
#pragma unroll
        for (int nt = 0; nt < S8_NT; ++nt)
          *reinterpret_cast<int2*>(out + r * c8 + c0 + nt * 8 + 2 * tg) =
              make_int2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
  }
}

// K11: out[r] = int32(table[idx[r]]) for idx in [0, wg), else 0.
// Replaces scripts/mxu_gather_probe.py:32 int8_kernel (call :43). Grid:
// (chunk, 64-column slab); every chunk reads the one [wg, c8] table.
__global__ void __launch_bounds__(THREADS)
int8_kernel(const int32_t* __restrict__ idx, int64_t ch, const int8_t* __restrict__ table,
            int64_t wg, int64_t c8, int32_t* __restrict__ out) {
  extern __shared__ uint32_t sB[];
  const int64_t i = blockIdx.x;
  onehot_s8_slab(idx + i * ch, ch, table, wg, c8, 0u, true, out + i * ch * c8, sB);
}

// K13: chunk i gathers from page pages[i] of a [npages * wg, c8] table:
// out[r] = int32(table[idx[r]]) when idx[r] lies in that page, else 0 (a
// page outside [0, npages) gives zero rows).
// Replaces scripts/mxu_gather_probe.py:126 paged_kernel (call :146). The
// TPU read pages[i] by scalar prefetch in its index map; Hopper has none, so
// each block loads its chunk's page number itself, then runs K11's code on
// that page.
__global__ void __launch_bounds__(THREADS)
paged_kernel(const int32_t* __restrict__ pages, const int32_t* __restrict__ idx, int64_t ch,
             const int8_t* __restrict__ table, int64_t npages, int64_t wg, int64_t c8,
             int32_t* __restrict__ out) {
  extern __shared__ uint32_t sB[];
  const int64_t i = blockIdx.x;
  const int64_t pg = pages[i];
  const bool valid = pg >= 0 && pg < npages;
  const int64_t p = valid ? pg : 0;
  onehot_s8_slab(idx + i * ch, ch, table + p * wg * c8, wg, c8, (uint32_t)(p * wg), valid,
                 out + i * ch * c8, sB);
}

// ---------------------------------------------------------------------------
// K12: run-length decode. Chunk i covers k = base[i, 0, 0] + r for r in
// [0, ch); out[k] = val[w] for the run w with off[i, w] <= k < off[i, w + 1]
// (the last run open up to 2^30), 0 where no run covers k. Offsets are
// non-decreasing along each chunk (a run-length table), so the run is the
// last w with off[w] <= k: a binary search. Exact for every int32 value; the
// TPU's f32 indicator product is exact only below 2^24.
//
// Replaces scripts/mxu_gather_probe.py:69 rld_kernel (call :81).
// What bounds it: bytes (20.1 MiB at the script's shapes: the offsets once,
// the output once). Design: one block per chunk stages its wg offsets in
// shared memory (8 KB at wg = 2048); each thread binary-searches its k
// there, then copies the run's cv values with 16-byte loads and stores
// (cv % 4 == 0). val (64 KB) stays in L1/L2.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
rld_kernel(const int32_t* __restrict__ off, int64_t wg, const int32_t* __restrict__ val,
           int64_t cv, const int32_t* __restrict__ base, int64_t bstride, int64_t ch,
           int32_t* __restrict__ out) {
  extern __shared__ int32_t soff[];
  const int64_t i = blockIdx.x;
  for (int64_t t = threadIdx.x; t < wg; t += THREADS) soff[t] = off[i * wg + t];
  __syncthreads();
  const uint32_t kbase = (uint32_t)base[i * bstride];
  for (int64_t r = threadIdx.x; r < ch; r += THREADS) {
    const int32_t k = (int32_t)(kbase + (uint32_t)r);  // int32 arithmetic, as the TPU's
    int64_t lo = 0, hi = wg;                           // first w with off[w] > k
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (soff[mid] <= k) lo = mid + 1;
      else hi = mid;
    }
    const int64_t w = lo - 1;
    const bool covered = w >= 0 && (w < wg - 1 || k < (1 << 30));
    const int4* v = reinterpret_cast<const int4*>(val + (covered ? w : 0) * cv);
    int4* o = reinterpret_cast<int4*>(out + (i * ch + r) * cv);
    for (int64_t q = 0; q < cv / 4; ++q) o[q] = covered ? __ldg(v + q) : make_int4(0, 0, 0, 0);
  }
}

}  // namespace

// Every entry point selects the tensors' device (this library links its own
// CUDA runtime), launches on the caller's stream and returns
// cudaGetLastError().

extern "C" int gof_take_gather(int device, const void* idx, long long n, const void* table,
                               long long page, long long w, void* out, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  take_kernel<<<(unsigned)stride_blocks(n * w), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx, n, (const float*)table, page, w, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int gof_vidx_gather(int device, const void* idx, long long n, const void* table,
                               long long page, long long w, void* out, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  vidx_kernel<<<(unsigned)stride_blocks(n * (w / 4)), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx, n, (const float4*)table, page, w / 4, (float4*)out);
  return (int)cudaGetLastError();
}

// tT: the caller's [w, npages * page_b] bf16 scratch for the rounded,
// transposed table; w % 32 == 0.
extern "C" int gof_onehot_gather(int device, const void* idx, long long n, const void* table,
                                 void* tT, long long w, long long npages, long long page_b,
                                 void* out, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long page = npages * page_b;
  onehot_prep_kernel<<<(unsigned)stride_blocks(w * page / 2), THREADS, 0, s>>>(
      (const float*)table, page, w, (uint32_t*)tT);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = (int)(OH_SLAB * ((page_b + OH_KPAD) / 2) * 4);
  err = cudaFuncSetAttribute(onehot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + OH_ROWS - 1) / OH_ROWS), (unsigned)(w / OH_SLAB));
  onehot_kernel<<<grid, THREADS, smem, s>>>((const int32_t*)idx, n, (const uint32_t*)tT, w,
                                            (int)npages, (int)page_b, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int gof_scat(int device, const void* idx, long long n, const void* rows, long long w,
                        long long page, void* out, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  scat_kernel<<<(unsigned)stride_blocks(n * w), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx, n, (const float*)rows, w, page, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int gof_scatmxu(int device, const void* perm, const void* starts, const void* rows,
                           long long w, long long page, void* out, void* stream) {
  if (page <= 0 || w <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  scatmxu_kernel<<<(unsigned)stride_blocks(page * 32), THREADS, 0, (cudaStream_t)stream>>>(
      (const int64_t*)perm, (const int64_t*)starts, (const float*)rows, w, page, (float*)out);
  return (int)cudaGetLastError();
}

static int s8_smem(long long wg) { return (int)(S8_SLAB * ((wg + S8_KPAD) / 4) * 4); }

extern "C" int gof_int8_gather(int device, const void* idx, long long nch, long long ch,
                               const void* table, long long wg, long long c8, void* out,
                               void* stream) {
  if (nch <= 0 || ch <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int smem = s8_smem(wg);
  const cudaError_t e2 =
      cudaFuncSetAttribute(int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e2 != cudaSuccess) return (int)e2;
  const dim3 grid((unsigned)nch, (unsigned)(c8 / S8_SLAB));
  int8_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)idx, ch, (const int8_t*)table, wg, c8, (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int gof_rld(int device, const void* off, long long nch, long long wg, const void* val,
                       long long cv, const void* base, long long bstride, long long ch, void* out,
                       void* stream) {
  if (nch <= 0 || ch <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int smem = (int)(wg * 4);
  const cudaError_t e2 =
      cudaFuncSetAttribute(rld_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e2 != cudaSuccess) return (int)e2;
  rld_kernel<<<(unsigned)nch, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)off, wg, (const int32_t*)val, cv, (const int32_t*)base, bstride, ch,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int gof_paged_gather(int device, const void* pages, const void* idx, long long nch,
                                long long ch, const void* table, long long npages, long long wg,
                                long long c8, void* out, void* stream) {
  if (nch <= 0 || ch <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int smem = s8_smem(wg);
  const cudaError_t e2 =
      cudaFuncSetAttribute(paged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e2 != cudaSuccess) return (int)e2;
  const dim3 grid((unsigned)nch, (unsigned)(c8 / S8_SLAB));
  paged_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)pages, (const int32_t*)idx, ch, (const int8_t*)table, npages, wg, c8,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
