// The row-gather and scatter-add probes: kernels that answer, on this
// card, the question gof_tpu's two cost probes asked of the TPU (how fast can
// the chip gather rows from a table and scatter-add rows into one, and which
// way: a plain index, a one-hot product on the matrix unit, int8, a paged
// table?). gof_tpu built K2 (expand.cu) and its payload path on the TPU's
// answer; these kernels give the H100's.
//
// Replaces the Pallas kernels of scripts/pallas_gather_probe.py (K6-K9; K10,
// the deterministic segment sum, runs on K4's counting-sort reduce in
// reduce.cu) and scripts/mxu_gather_probe.py (K11-K13). Each computes the TPU kernel's
// function, its edge behaviour included (ops/gather_probes.py states it and
// holds the plain PyTorch versions). On the TPU the table lived in VMEM
// (2 MiB); a block's shared memory holds at most 227 KB, so here the table
// lives in the 50 MB L2 and the one-hot products stage one 16-row k-step of
// a 32-column slab (K8: only the k-steps its rows hit, the rows grouped by
// k-step first) or one 64-column slab of a page (K11, K13) at a time.
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
// K6 and K7 share one body: out[r] = table[idx[r]], each with its TPU
// kernel's edge rule. K6 (CLAMP false), jnp.take's fill mode: an index in
// [-page, 0) wraps, any other index outside [0, page) gives a zero row. K7
// (CLAMP true), the TPU ref indexer's: a negative index wraps once, then the
// row is clamped to [0, page - 1].
//
// Replaces scripts/pallas_gather_probe.py:38 take_kernel (call :44), K6,
// and :63 vidx_kernel (call :69), K7.
// What bounds it: bytes. The output (n * w * 4 bytes, 64 MiB at the script's
// shapes) is written once; the index is read once; the table (2 MiB) stays
// in L2. A thread per 4-byte element spends the time on instructions
// instead: a 64-bit division by w per element, the row's index read again
// by each of its w threads, and one load in flight per thread.
// Design:
// - a warp takes 32 rows: each lane reads one row's index once (one
//   coalesced 128-byte load) and turns it into a table row (or -1, a zero
//   row); the pieces of the 32 rows then get it by shuffle;
// - a piece is 16 bytes (P = float4) where w % 4 == 0 and the table and the
//   output are 16-byte aligned, else 4 bytes (P = float): any width and any
//   alignment, picked per call by launch_gather;
// - lane l's pieces are l, l + 32, ... of the tile's 32 * wp, contiguous
//   in the output: each step adds 32 to its output offset, and (32 / wp
//   rows, 32 % wp pieces) with a carry to its (row, piece); each row's
//   first piece in the table is worked out once, by the lane that read its
//   index (the shuffle hands that out): the loop neither divides nor
//   multiplies;
// - GATHER_UNROLL pieces' loads are issued before any of their stores;
// - stores stream (st.global.cs): the 64 MiB written never evict the table
//   from L2.
// Measured one at a time (probe_steps.py), 4-byte pieces cost 13%, plain
// stores 12% and one piece in flight 3% (6% with 4-byte pieces); offsets
// in 32 bits measured no faster once the loop neither divides nor
// multiplies. At the script's shapes it runs within 5% of a fill_ of its
// output.
// ---------------------------------------------------------------------------
constexpr int GATHER_UNROLL = 4;  // pieces a lane loads before it stores them

template <bool CLAMP>
__device__ __forceinline__ int64_t gather_row(int32_t ix, int64_t page) {
  int64_t j = ix;
  if (j < 0) j += page;
  if (CLAMP) return j < 0 ? 0 : (j >= page ? page - 1 : j);
  return (j >= 0 && j < page) ? j : -1;
}

template <typename P>
__device__ __forceinline__ P zero_piece();
template <>
__device__ __forceinline__ float zero_piece<float>() {
  return 0.0f;
}
template <>
__device__ __forceinline__ float4 zero_piece<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

template <typename P>
__device__ __forceinline__ void store_stream(P* p, P v) {
  __stcs(p, v);
}

template <bool CLAMP, typename P>
__global__ void __launch_bounds__(THREADS)
gather_kernel(const int32_t* __restrict__ idx, int64_t n, const P* __restrict__ table,
              int64_t page, int64_t wp, P* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int64_t dr = 32 / wp, dq = 32 % wp;              // a step of 32 pieces: rows, pieces
  const int64_t row0 = lane / wp, q0 = lane - row0 * wp;  // this lane's first piece of a tile
  const int64_t tiles = (n + 31) / 32;
  for (int64_t tile = (int64_t)blockIdx.x * NWARPS + threadIdx.x / 32; tile < tiles;
       tile += (int64_t)gridDim.x * NWARPS) {
    const int64_t r0 = tile * 32;
    const int64_t pieces = (n - r0 < 32 ? n - r0 : 32) * wp;  // the tile's output pieces
    long long src = -1;  // lane l's row r0 + l: its first piece in the table, -1 a zero row
    if (lane < n - r0) {
      const int64_t j = gather_row<CLAMP>(idx[r0 + lane], page);
      src = j >= 0 ? j * wp : -1;
    }
    P* dst = out + r0 * wp;
    int64_t row = row0, q = q0;
    for (int64_t p = lane; p < 32 * wp; p += 32 * GATHER_UNROLL) {  // the same count per lane
      P v[GATHER_UNROLL];
#pragma unroll
      for (int u = 0; u < GATHER_UNROLL; ++u) {
        const long long s = __shfl_sync(~0u, src, (int)(row & 31));
        v[u] = (p + 32 * u < pieces && s >= 0) ? __ldg(table + s + q) : zero_piece<P>();
        row += dr;
        q += dq;
        if (q >= wp) {
          q -= wp;
          ++row;
        }
      }
#pragma unroll
      for (int u = 0; u < GATHER_UNROLL; ++u)
        if (p + 32 * u < pieces) store_stream(dst + p + 32 * u, v[u]);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core helpers (fragment layouts of the PTX ISA, "Matrix Fragments
// for mma.m16n8k16"; wgmma's register A is, per warp of the warpgroup, that
// of mma.m16n8k16 for bf16 and of mma.m16n8k32 for s8). groupID g =
// lane / 4 and threadID_in_group tg = lane % 4.
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void fence_regs(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One thread: copy `bytes` from global to shared memory by cp.async.bulk,
// completing on the mbarrier at `bar` (which expects them).
__device__ __forceinline__ void bulk_stage(uint32_t dst, const void* src, uint32_t bytes,
                                           uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
}

// ---------------------------------------------------------------------------
// K8: out[r] = bf16(table)[idx[r]] as f32, computed as gof_tpu computed it,
// as a one-hot bf16 product summed in f32, but only over the k-steps some
// row hits. An index outside [0, page) gives a zero row. Exact for a finite
// table: each row's one-hot row has one 1, so every other product is an
// exact zero (a non-finite entry would spread 0 x inf = NaN to the rows
// that share its k-step, as the TPU's dense product spread it over a page).
//
// Replaces scripts/pallas_gather_probe.py:88 onehot_kernel (call :101).
// What bounds it: bytes (the index and the table read once, the output, 64
// MiB at the script's shapes, written once: 21 us), once the product skips
// the k-steps no row hits (the dense product, 2 * n * page * w = 5.5e11
// bf16 operations, would take 0.556 ms). Each output row depends only on
// its own index, and a k-step of 16 table rows is all of the table a row
// needs, so the rows are grouped by k-step and each group meets only its own
// slab. Four passes:
// - prep (onehot_prep_kernel): rounds the table to bf16 once, into wgmma's
//   K-major B layout without swizzle, one contiguous 1 KB block per (k-step,
//   32-column slab): 2 k halves x 4 column groups x 8 columns x 16 bytes;
//   block 0 zeroes the sort's counts;
// - count (onehot_count_kernel): a counting sort of the rows by k-step
//   (idx >> 4; every index outside the table in one sentinel bucket, last),
//   each block counting its OH_SORT_BLOCK rows in a shared histogram and
//   adding it to the global counts; the last block to finish scans them into
//   each bucket's first slot;
// - fill (onehot_fill_kernel): each block ranks its rows in its shared
//   histogram, reserves a run of slots per bucket with one atomic, and
//   writes (row, index) to the slots; the order inside a bucket is the
//   atomics' (no stability is needed: a row's result depends only on it);
// - product (onehot_wgmma_kernel): a warpgroup per 64 sorted rows and
//   32-column slab finds the distinct k-steps its rows hit (1-2 at the
//   script's shapes, at most 64), stages each one's 1 KB slab by
//   cp.async.bulk on an mbarrier, two ahead in a double buffer, and issues
//   one wgmma.mma_async m64n32k16 bf16 -> f32 per k-step with the one-hot A
//   in registers; the accumulators start at +0.0 (so a -0.0 entry comes out
//   +0.0, equal under ==) and leave as 16-byte stores, each row to its own
//   place out[row] (a lane pair swaps halves so each lane holds 4 columns
//   of one row); the sentinel bucket's rows hit no k-step and store zeros.
// Needs w % 32 == 0 and page % 16 == 0 (the wrapper checks).
// ---------------------------------------------------------------------------
constexpr int OH_KSTEP = 16;                             // table rows per k-step: the wgmma K
constexpr int OH_N = 32;                                 // columns per slab: the wgmma N
constexpr int OH_HALF_BYTES = OH_N * 16;                 // one k half of a slab block
constexpr int OH_SLAB_BYTES = 2 * OH_HALF_BYTES;         // a (k-step, slab) block of B
constexpr int OH_MTILE = 64;                             // sorted rows per warpgroup: the M
constexpr int OH_SORT_THREADS = 512;                     // threads per count / fill block
constexpr int OH_SORT_ROWS = 8;                          // rows per thread in count and fill
constexpr int OH_SORT_BLOCK = OH_SORT_THREADS * OH_SORT_ROWS;  // rows per count / fill block

// A row's bucket: its k-step, or `sentinel` (page / 16) off the table.
__device__ __forceinline__ int oh_key(int32_t ix, int64_t page, int sentinel) {
  return (ix >= 0 && ix < page) ? ix >> 4 : sentinel;
}

// tB line t (16 bytes: bf16 of rows 16 K + 8 h .. + 7 of one column) at
// ((K * slabs + slab) * 64 + h * 32 + column in the slab) * 16 bytes
__global__ void __launch_bounds__(THREADS)
onehot_prep_kernel(const float* __restrict__ table, int64_t page, int64_t w,
                   uint4* __restrict__ tB, int32_t* __restrict__ zero, int nzero) {
  const int64_t slabs = w / OH_N;
  const int64_t lines = page * w / 8;
  for (int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x; t < lines;
       t += (int64_t)gridDim.x * THREADS) {
    const int64_t blk = t / (OH_SLAB_BYTES / 16);
    const int q = (int)(t - blk * (OH_SLAB_BYTES / 16));
    const int h = q / OH_N, col = q % OH_N;
    const int64_t k = blk / slabs, slab = blk - k * slabs;
    const float* src = table + (k * OH_KSTEP + h * 8) * w + slab * OH_N + col;
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(__ldg(src + 2 * i * w),
                                                     __ldg(src + (2 * i + 1) * w));
      v[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    tB[t] = make_uint4(v[0], v[1], v[2], v[3]);
  }
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < nzero; i += THREADS) zero[i] = 0;
}

// ws: done [1], cnt [nb] (both zeroed by the prep pass), first [nb]
__global__ void __launch_bounds__(OH_SORT_THREADS)
onehot_count_kernel(const int32_t* __restrict__ idx, int64_t n, int64_t page, int nb,
                    int32_t* __restrict__ ws) {
  extern __shared__ int32_t hist[];  // [nb]
  __shared__ int32_t wsum[OH_SORT_THREADS / 32];
  __shared__ bool last;
  int32_t* done = ws;
  int32_t* cnt = ws + 1;
  int32_t* first = ws + 1 + nb;
  for (int b = threadIdx.x; b < nb; b += OH_SORT_THREADS) hist[b] = 0;
  __syncthreads();
  const int64_t r0 = (int64_t)blockIdx.x * OH_SORT_BLOCK + threadIdx.x;
#pragma unroll
  for (int i = 0; i < OH_SORT_ROWS; ++i) {
    const int64_t r = r0 + i * OH_SORT_THREADS;
    if (r < n) atomicAdd(&hist[oh_key(idx[r], page, nb - 1)], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += OH_SORT_THREADS)
    if (hist[b]) atomicAdd(&cnt[b], hist[b]);
  // the last block to finish turns the counts into each bucket's first slot
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int b = threadIdx.x; b < nb; b += OH_SORT_THREADS) hist[b] = __ldcg(cnt + b);
  __syncthreads();
  const int per = (nb + OH_SORT_THREADS - 1) / OH_SORT_THREADS;
  const int b0 = threadIdx.x * per, b1 = min(b0 + per, nb);
  int sum = 0;
  for (int b = b0; b < b1; ++b) sum += hist[b];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int x = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(~0u, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  int run = x - sum;
  for (int i = 0; i < warp; ++i) run += wsum[i];
  for (int b = b0; b < b1; ++b) {
    first[b] = run;
    run += hist[b];
  }
}

// srt[slot] = (row, idx[row]), the rows grouped by bucket
__global__ void __launch_bounds__(OH_SORT_THREADS)
onehot_fill_kernel(const int32_t* __restrict__ idx, int64_t n, int64_t page, int nb,
                   int32_t* __restrict__ first, int2* __restrict__ srt) {
  extern __shared__ int32_t hist[];  // [nb]: counts, then each bucket's reserved base
  for (int b = threadIdx.x; b < nb; b += OH_SORT_THREADS) hist[b] = 0;
  __syncthreads();
  const int64_t r0 = (int64_t)blockIdx.x * OH_SORT_BLOCK + threadIdx.x;
  int32_t ix[OH_SORT_ROWS];
  int key[OH_SORT_ROWS], rank[OH_SORT_ROWS];
#pragma unroll
  for (int i = 0; i < OH_SORT_ROWS; ++i) {
    const int64_t r = r0 + i * OH_SORT_THREADS;
    ix[i] = r < n ? idx[r] : 0;
    key[i] = oh_key(ix[i], page, nb - 1);
    rank[i] = r < n ? atomicAdd(&hist[key[i]], 1) : 0;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += OH_SORT_THREADS)
    if (hist[b]) hist[b] = atomicAdd(&first[b], hist[b]);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < OH_SORT_ROWS; ++i) {
    const int64_t r = r0 + i * OH_SORT_THREADS;
    if (r < n) srt[hist[key[i]] + rank[i]] = make_int2((int)r, ix[i]);
  }
}

// Shared-memory matrix descriptor of a K-major B block without swizzle: the
// two 16-byte k halves of a k-step lie OH_HALF_BYTES apart (leading byte
// offset), the 8-column core matrices 128 bytes apart (stride byte offset).
__device__ __forceinline__ uint64_t bf16_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(OH_HALF_BYTES >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// d[64 x 32] += A[64 x 16] (registers, bf16) x B[16 x 32] (shared, bf16)
__device__ __forceinline__ void wgmma_bf16_m64n32k16(float (&d)[16], const uint32_t (&a)[4],
                                                     uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__global__ void __launch_bounds__(128)
onehot_wgmma_kernel(const int2* __restrict__ srt, int64_t n, const uint8_t* __restrict__ tB,
                    int64_t w, int64_t page, float* __restrict__ out) {
  __shared__ __align__(128) uint8_t slab_buf[2][OH_SLAB_BYTES];
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ int32_t kstep[OH_MTILE];  // each sorted row's k-step, -1 off the table
  __shared__ uint32_t starts[2];       // the tile's rows where a new k-step starts
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int64_t slabs = w / OH_N, slab = blockIdx.y;
  const int64_t p0 = (int64_t)blockIdx.x * OH_MTILE + warp * 16 + g;  // this lane's rows p0, p0 + 8
  int32_t row[2], ks[2], loc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t p = p0 + 8 * h;
    const int2 e = p < n ? srt[p] : make_int2(-1, -1);
    row[h] = e.x;
    ks[h] = (e.y >= 0 && e.y < page) ? e.y / OH_KSTEP : -1;
    loc[h] = e.y & (OH_KSTEP - 1);
    if (tg == 0) kstep[warp * 16 + g + 8 * h] = ks[h];
  }
  const uint32_t bar0 = smem_u32(&bar[0]), buf0 = smem_u32(&slab_buf[0][0]);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0 + 8) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < OH_MTILE) {
    const int k = kstep[threadIdx.x];
    const unsigned m =
        __ballot_sync(~0u, k >= 0 && (threadIdx.x == 0 || k != kstep[threadIdx.x - 1]));
    if (lane == 0) starts[warp] = m;
  }
  __syncthreads();
  // the hit k-steps, one bit each (the sorted rows' keys never decrease)
  uint64_t todo = starts[0] | (uint64_t)starts[1] << 32;
  const int nhit = __popcll(todo);
  auto slab_src = [&](uint64_t m) {
    return tB + ((int64_t)kstep[__ffsll((long long)m) - 1] * slabs + slab) * OH_SLAB_BYTES;
  };
  if (threadIdx.x == 0) {
    uint64_t m = todo;
    for (int j = 0; j < 2 && j < nhit; ++j, m &= m - 1)
      bulk_stage(buf0 + j * OH_SLAB_BYTES, slab_src(m), OH_SLAB_BYTES, bar0 + 8 * j);
  }
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
  for (int j = 0; j < nhit; ++j) {
    const int k = kstep[__ffsll((long long)todo) - 1];
    todo &= todo - 1;
    const int b = j & 1;
    mbar_wait(bar0 + 8 * b, (j >> 1) & 1);
    // rows g, g + 8 of the warp's 16; k-step columns 2tg, 2tg + 1, then + 8
    const uint32_t a[4] = {ks[0] == k ? onehot_bf16x2(loc[0] - 2 * tg) : 0u,
                           ks[1] == k ? onehot_bf16x2(loc[1] - 2 * tg) : 0u,
                           ks[0] == k ? onehot_bf16x2(loc[0] - 2 * tg - 8) : 0u,
                           ks[1] == k ? onehot_bf16x2(loc[1] - 2 * tg - 8) : 0u};
    fence_regs(acc);
    wgmma_fence();
    wgmma_bf16_m64n32k16(acc, a, bf16_desc(buf0 + b * OH_SLAB_BYTES));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warp's product has read buffer b
    if (threadIdx.x == 0 && j + 2 < nhit)
      bulk_stage(buf0 + b * OH_SLAB_BYTES, slab_src(todo & (todo - 1)), OH_SLAB_BYTES,
                 bar0 + 8 * b);
  }
  // accumulator n-tile q: acc[4q], acc[4q + 1] at row g, columns 8q + 2tg, +1;
  // acc[4q + 2], acc[4q + 3] at row g + 8. Lanes tg, tg ^ 1 swap halves:
  // even tg stores row g, odd tg row g + 8, four columns each.
  const bool odd = tg & 1;
  const int32_t r = odd ? row[1] : row[0];
  float* orow = out + (int64_t)r * w + slab * OH_N + 2 * (tg & ~1);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float s0 = odd ? acc[4 * q] : acc[4 * q + 2];
    const float s1 = odd ? acc[4 * q + 1] : acc[4 * q + 3];
    const float r0 = __shfl_xor_sync(~0u, s0, 1), r1 = __shfl_xor_sync(~0u, s1, 1);
    const float4 val = odd ? make_float4(r0, r1, acc[4 * q + 2], acc[4 * q + 3])
                           : make_float4(acc[4 * q], acc[4 * q + 1], r0, r1);
    if (r >= 0) *reinterpret_cast<float4*>(orow + 8 * q) = val;
  }
}

// ---------------------------------------------------------------------------
// K9: out[PAGE, w] = segment sum of rows[r] at idx[r] (a zeroed output the
// wrapper allocates), with `.at[idx].add`'s index semantics: an index in
// [-page, 0) wraps, any other index outside [0, page) is dropped.
//
// Replaces scripts/pallas_gather_probe.py:120 scat_kernel (call :132).
// What bounds it: bytes (the rows, 64 MiB at the script's shapes, read once;
// 21 us) and the L2's reduction rate. Design: one thread per 16 bytes of a
// row; each row is read once by a streaming load (__ldcs: it is not kept in
// L1) and added by one 16-byte vector reduction (atomicAdd on a float4,
// sm_90's red.global.add.v4.f32): 4.19M reductions at the script's shapes
// where one per float would be 16.8M. The sums depend on the order the
// reductions arrive in; K10 (reduce.cu) is the deterministic twin.
// Needs w % 4 == 0 and 16-byte aligned rows (the wrapper checks).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
scat_kernel(const int32_t* __restrict__ idx, int64_t n, const float4* __restrict__ rows,
            int64_t w4, int64_t page, float4* __restrict__ out) {
  const int64_t total = n * w4;
  for (int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * THREADS) {
    const int64_t r = t / w4;
    int64_t j = idx[r];
    if (j < 0) j += page;
    if (j >= 0 && j < page) atomicAdd(out + j * w4 + (t - r * w4), __ldcs(rows + t));
  }
}

// ---------------------------------------------------------------------------
// K11 and K13 share one kernel: out[r] = int32(tbl[idx[r] - start]) when
// idx[r] lies in its chunk's page [start, start + wg), else 0, computed as
// the one-hot int8 product [rows, wg] x [wg, c8] with int32 accumulation
// (exact). K11 is the case of one page (start 0) for every chunk.
//
// Replaces scripts/mxu_gather_probe.py:32 int8_kernel (call :43), K11, and
// :126 paged_kernel (call :146), K13. The TPU read each chunk's page by
// scalar prefetch in its index map; here a device pass groups the chunks by
// page, and a page outside [0, npages) gives zero rows.
//
// What bounds it: the product, 2 * rows * wg * c8 int8 operations (2.75e11
// at the scripts' shapes: 0.139 ms at 1,979 TOP/s), against the int32
// output (256 MiB: 81 us) and the table (K13 2 MiB, read in 128 KB slabs).
// Design (Hopper):
// - a prep pass (s8_layout_kernel) arranges the table into wgmma's K-major
//   layout without swizzle for an s8 B operand, one contiguous 64 * wg byte
//   block per (page, 64-column slab): per 32-row k-step, 8 column groups x
//   2 halves of 16 k bytes, each a core matrix of 8 columns x 16 bytes;
// - a one-warp pass (page_group_kernel) groups the chunk ids by page, a
//   stable counting sort of `pages` (pages outside the table last);
// - persistent blocks, about one per SM, split the work units (slab, chunk
//   in page order, 64-row m-tile) into contiguous ranges; whenever its range
//   enters a new (page, slab), a block stages that slab once into shared
//   memory by one cp.async.bulk completing on an mbarrier (128 KB at
//   wg = 2048, so one block fills an SM), and its S8_GROUPS consumer
//   warpgroups take its m-tiles in turn;
// - per m-tile, wg / 32 wgmma.mma_async m64n64k32 s32.s8.s8 with the
//   one-hot A in registers (each row's hit k-step and its two A words are
//   worked out once; a k-step selects them or zero) and B from the staged
//   slab by descriptor; A is written S8_KG k-steps at a time into one of
//   two register groups, then one wgmma.fence and the group's S8_KG wgmma,
//   so one group's products run while the next group's A is written (a
//   fence for every k-step measured much slower); the next m-tile's
//   indices are loaded while this one's product runs;
// - the 32 s32 accumulators leave as 16-byte stores (a lane pair swaps
//   halves so each lane holds 4 columns of one row); the stores drain
//   while the warpgroup's next m-tile runs.
// Needs wg % 64 == 0 and c8 % 64 == 0 (the wrapper checks).
// ---------------------------------------------------------------------------
constexpr int S8_SLAB = 64;                      // columns per slab: the wgmma N
constexpr int S8_KSTEP = 32;                     // the wgmma K for s8
constexpr int S8_KBYTES = S8_SLAB * S8_KSTEP;    // bytes of B per k-step
constexpr int S8_MTILE = 64;                     // rows per wgmma: the M
constexpr int S8_GROUPS = 4;                     // consumer warpgroups per block
constexpr int S8_KG = 4;                         // k-steps per A group (one fence each)
constexpr int S8_THREADS = 128 * S8_GROUPS;

// tB line q (16 bytes): k bytes kh * 16 .. + 15 of one column, at
// ((page * slabs + slab) * (wg / 32) + kstep) * 2048 + kh * 1024 + col8 * 16
__global__ void __launch_bounds__(THREADS)
s8_layout_kernel(const int8_t* __restrict__ table, int64_t rows, int64_t wg, int64_t c8,
                 uint4* __restrict__ tB) {
  const int64_t slabs = c8 / S8_SLAB, ksteps = wg / S8_KSTEP;
  const int64_t lines = rows * c8 / 16;
  for (int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x; t < lines;
       t += (int64_t)gridDim.x * THREADS) {
    const int64_t blk = t / (S8_KBYTES / 16);
    const int q = (int)(t - blk * (S8_KBYTES / 16));
    const int kh = q / S8_SLAB, col = q % S8_SLAB;
    const int64_t page = blk / (slabs * ksteps);
    const int64_t rem = blk - page * slabs * ksteps;
    const int64_t slab = rem / ksteps, kstep = rem - slab * ksteps;
    const int8_t* src =
        table + (page * wg + kstep * S8_KSTEP + kh * 16) * c8 + slab * S8_SLAB + col;
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) v |= (uint32_t)(uint8_t)__ldg(src + (4 * i + b) * c8) << (8 * b);
      w[i] = v;
    }
    tB[t] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// One warp: order [nch] = the chunk ids grouped by page, stably, pages in
// [0, npages) ascending and the rest last; starts [npages + 2] = where each
// group starts (starts[npages] for the pages outside the table, then nch).
// The counts live in shared memory, GROUP_BUCKETS groups per sweep (one
// sweep up to 8191 pages); each chunk's page is loaded one step ahead.
constexpr int GROUP_BUCKETS = 8192;

__global__ void __launch_bounds__(32)
page_group_kernel(const int32_t* __restrict__ pages, int64_t nch, int64_t npages,
                  int32_t* __restrict__ order, int32_t* __restrict__ starts) {
  __shared__ int32_t cnt[GROUP_BUCKETS];
  const int lane = threadIdx.x;
  const int64_t nb = npages + 1;
  auto group = [&](int32_t p) -> int64_t { return (p >= 0 && p < npages) ? p : npages; };
  int carry = 0;
  for (int64_t b0 = 0; b0 < nb; b0 += GROUP_BUCKETS) {
    const int nbs = (int)(nb - b0 < GROUP_BUCKETS ? nb - b0 : GROUP_BUCKETS);
    for (int b = lane; b < nbs; b += 32) cnt[b] = 0;
    __syncwarp();
    for (int pass = 0; pass < 2; ++pass) {
      int32_t pnext = lane < nch ? pages[lane] : 0;
      for (int64_t i0 = 0; i0 < nch; i0 += 32) {
        const int64_t i = i0 + lane;
        const int64_t b = group(pnext) - b0;
        pnext = i + 32 < nch ? pages[i + 32] : 0;
        const bool mine = i < nch && b >= 0 && b < nbs;
        const unsigned act = __ballot_sync(~0u, mine);
        if (mine) {
          const unsigned peers = __match_any_sync(act, (int)b);
          const int leader = __ffs(peers) - 1;
          int base = 0;
          if (lane == leader) base = cnt[b];
          base = __shfl_sync(peers, base, leader);
          if (pass == 1) order[base + __popc(peers & ((1u << lane) - 1u))] = (int32_t)i;
          if (lane == leader) cnt[b] = base + __popc(peers);
        }
        __syncwarp();
      }
      if (pass == 0) {  // counts -> exclusive starts, which the second pass advances
        for (int b1 = 0; b1 < nbs; b1 += 32) {
          const int b = b1 + lane;
          const int v = b < nbs ? cnt[b] : 0;
          int x = v;
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(~0u, x, d);
            if (lane >= d) x += y;
          }
          if (b < nbs) starts[b0 + b] = cnt[b] = carry + x - v;
          carry += __shfl_sync(~0u, x, 31);
        }
        __syncwarp();
      }
    }
  }
  if (lane == 0) starts[nb] = carry;
}

// Shared-memory matrix descriptor of a K-major B tile without swizzle: the
// two 16-byte k halves of a k-step lie 1024 bytes apart (leading byte
// offset), the 8-column core matrices 128 bytes apart (stride byte offset).
__device__ __forceinline__ uint64_t s8_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// d[64 x 64] (+)= A[64 x 32] (registers, s8) x B[32 x 64] (shared, s8)
__device__ __forceinline__ void wgmma_s8_m64n64k32(int (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// pages == nullptr: every chunk on page 0 (K11), order and starts unused.
__global__ void __launch_bounds__(S8_THREADS, 1)
s8_onehot_kernel(const int32_t* __restrict__ pages, const int32_t* __restrict__ order,
                 const int32_t* __restrict__ starts, const int32_t* __restrict__ idx,
                 int64_t nch, int64_t ch, const uint8_t* __restrict__ tB, int64_t npages,
                 int64_t wg, int64_t c8, int32_t* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t slab_smem[];  // wg * 64 bytes
  __shared__ __align__(8) uint64_t bar;
  const int64_t slabs = c8 / S8_SLAB;
  const int64_t mtc = (ch + S8_MTILE - 1) / S8_MTILE;  // m-tiles per chunk
  const int64_t per_slab = nch * mtc;
  const int64_t units = slabs * per_slab;
  const int64_t u_end = units * (blockIdx.x + 1) / gridDim.x;
  const int64_t slab_bytes = wg * S8_SLAB;
  const uint32_t bar_a = smem_u32(&bar);
  const uint32_t slab_a = smem_u32(slab_smem);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_a) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int grp = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tg = lane % 4;
  const int nk = (int)(wg / S8_KSTEP);
  uint32_t phase = 0;
  int acc[32];  // written first by a k-step 0 wgmma (scale-d 0)

  for (int64_t u = units * blockIdx.x / gridDim.x; u < u_end;) {
    const int64_t slab = u / per_slab;
    const int64_t j = (u - slab * per_slab) / mtc;  // position in the page-grouped order
    const int64_t chunk = pages ? order[j] : j;
    const int64_t pg = pages ? pages[chunk] : 0;
    const bool valid = pg >= 0 && pg < npages;
    const int64_t j_end = pages ? starts[valid ? pg + 1 : npages + 1] : nch;
    const int64_t seg_stop = slab * per_slab + j_end * mtc;
    const int64_t seg_end = seg_stop < u_end ? seg_stop : u_end;
    if (valid) {
      __syncthreads();  // both warpgroups are done with the slab staged before
      if (threadIdx.x == 0) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar_a),
                     "r"((uint32_t)slab_bytes)
                     : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];\n" ::"r"(slab_a),
            "l"(tB + (pg * slabs + slab) * slab_bytes), "r"((uint32_t)slab_bytes), "r"(bar_a)
            : "memory");
      }
      uint32_t done = 0;
      while (!done)
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar_a), "r"(phase)
            : "memory");
      phase ^= 1u;
    }
    const uint32_t start = (uint32_t)(pg * wg);
    // the index values of an m-tile's two rows of this lane (start - 1, which
    // lies outside the page, past the chunk's end), loaded a tile ahead
    auto fetch = [&](int64_t v, int32_t (&ix)[2]) {
      const int64_t jr = v - slab * per_slab;
      const int64_t jj = jr / mtc, t = jr - jj * mtc;
      const int64_t cj = pages ? order[jj] : jj;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t r = t * S8_MTILE + warp * 16 + g + 8 * h;
        ix[h] = r < ch ? idx[cj * ch + r] : (int32_t)(start - 1u);
      }
    };
    int32_t next[2] = {0, 0};
    if (valid && u + grp < seg_end) fetch(u + grp, next);
    for (int64_t v = u + grp; v < seg_end; v += S8_GROUPS) {
      const int64_t jr = v - slab * per_slab;
      const int64_t jj = jr / mtc, t = jr - jj * mtc;
      const int64_t cj = pages ? order[jj] : jj;
      const int64_t row0 = t * S8_MTILE + warp * 16 + g;  // this lane's rows: row0, row0 + 8
      if (valid) {
        const int32_t ix[2] = {next[0], next[1]};
        if (v + S8_GROUPS < seg_end) fetch(v + S8_GROUPS, next);
        // each row's hit k-step and its A words there (rows g, g + 8 of the warp's 16)
        int hit[2];
        uint32_t lo[2], hi[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int l = local_row(ix[h], start, (uint32_t)wg);
          hit[h] = l >= 0 ? l / S8_KSTEP : -1;
          const int e = (l & (S8_KSTEP - 1)) - 4 * tg;
          lo[h] = onehot_s8x4(e);        // k-step columns 4tg .. 4tg + 3
          hi[h] = onehot_s8x4(e - 16);   // columns 16 + 4tg .. 16 + 4tg + 3
        }
        const uint64_t desc0 = s8_desc(slab_a);
        // A for S8_KG k-steps at a time, then one fence and their wgmma: two
        // groups of A registers, so one group's products run while the
        // next group's A is written
        uint32_t a[2][S8_KG][4];
        for (int k0 = 0; k0 < nk; k0 += 2 * S8_KG) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int kb = k0 + h * S8_KG;
            if (kb < nk) {
              wgmma_wait<1>();  // the group that read a[h] (two groups back) is done
#pragma unroll
              for (int i = 0; i < S8_KG; ++i) {
                const int k = kb + i;
                a[h][i][0] = hit[0] == k ? lo[0] : 0u;
                a[h][i][1] = hit[1] == k ? lo[1] : 0u;
                a[h][i][2] = hit[0] == k ? hi[0] : 0u;
                a[h][i][3] = hit[1] == k ? hi[1] : 0u;
              }
              wgmma_fence();
              // past the last k-step (wg / 32 not a multiple of S8_KG) A is
              // zero: those wgmma read k-step 0 and add exact zeros (a
              // guard around a wgmma would serialise them all)
#pragma unroll
              for (int i = 0; i < S8_KG; ++i)
                wgmma_s8_m64n64k32(acc, a[h][i],
                                   desc0 + (uint64_t)(kb + i < nk ? kb + i : 0) * (S8_KBYTES >> 4),
                                   kb + i > 0);
              wgmma_commit();
            }
          }
        }
        wgmma_wait<0>();
        fence_regs(acc);
      }
      // accumulator n-tile q: acc[4q], acc[4q + 1] at row g, columns 8q + 2tg, +1;
      // acc[4q + 2], acc[4q + 3] at row g + 8. Lanes tg, tg ^ 1 swap halves:
      // even tg stores row g, odd tg row g + 8, four columns each. A page
      // outside the table stores zeros (and never writes the accumulators
      // outside a wgmma, which would serialise the wgmma pipeline).
      int d[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) d[i] = valid ? acc[i] : 0;
      const bool odd = tg & 1;
      const int64_t r = row0 + (odd ? 8 : 0);
      int32_t* orow = out + (cj * ch + r) * c8 + slab * S8_SLAB + 2 * (tg & ~1);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int s0 = odd ? d[4 * q] : d[4 * q + 2];
        const int s1 = odd ? d[4 * q + 1] : d[4 * q + 3];
        const int r0 = __shfl_xor_sync(~0u, s0, 1), r1 = __shfl_xor_sync(~0u, s1, 1);
        const int4 val = odd ? make_int4(r0, r1, d[4 * q + 2], d[4 * q + 3])
                             : make_int4(d[4 * q], d[4 * q + 1], r0, r1);
        if (r < ch) *reinterpret_cast<int4*>(orow + 8 * q) = val;
      }
    }
    u = seg_end;
  }
}

// ---------------------------------------------------------------------------
// K12: run-length decode. Chunk i covers k = base[i, 0, 0] + r for r in
// [0, ch), in int32 arithmetic (wrapping, as the TPU's); out[k] = val[w]
// for the run w with off[i, w] <= k < off[i, w + 1] (the last run open up to
// 2^30), 0 where no run covers k. Offsets are non-decreasing along each
// chunk (a run-length table), so the run is the last w with off[w] <= k, and
// a run whose offset repeats the next one's is empty. Exact for every int32
// value; the TPU's f32 indicator product is exact only below 2^24.
//
// Replaces scripts/mxu_gather_probe.py:69 rld_kernel (call :81).
// What bounds it: bytes, and of the inputs only what the chunks' rows need:
// the output (16 MiB at the script's shapes) written once, each chunk's
// base, the val rows used and the few offsets inside each chunk's k range.
// Staging all wg offsets of a chunk (8 KB; 4 MiB in all) before a block can
// write, then binary-searching all of them per row, reads and searches far
// more than that: about 4 of a chunk's 2048 offsets fall inside its 1024 k
// at the script's draws.
// Design: a block per RLD_ROWS rows of a chunk (1,024 blocks at the
// script's shapes: one wave), whose k lie in [kmin, kmax] (the whole int32
// range where they wrap):
// - warp 0 finds wlo = the last w with off[w] <= kmin and whi = the last
//   with off[w] <= kmax by a 64-ary search of the chunk's offsets in global
//   memory, both keys in lockstep: each round two loads per lane and two
//   ballots, so 2048 offsets take two rounds (one strided, one of 256
//   contiguous bytes, which usually leaves the block's offsets in L1);
// - for every k of the block, w = wlo + #{p in (wlo, whi] : off[p] <= k}:
//   the m = whi - wlo offsets in between are all a row needs, and each
//   row binary-searches those through L1 (2-3 steps at the script's draws;
//   a dense range, up to all wg offsets inside the block's k, takes more
//   steps and is never refused);
// - each thread decodes one 16-byte piece of a row at a time (a warp's
//   pieces contiguous) and writes it by a streaming store; val (64 KB) is
//   read through L1. 4 pieces' loads in flight before their stores
//   measured slower (40 registers a thread leave room for 6 blocks an SM,
//   not 8: two waves), as did 256 rows a block (two waves) and 1024 (half
//   the threads).
// Needs cv % 4 == 0 and a 16-byte aligned val (the wrapper checks).
// ---------------------------------------------------------------------------
constexpr int RLD_ROWS = 512;  // output rows per block

// pos[k] = the first p in off[0, n) with off[p] > key[k] (n if none), for
// both keys, by one warp (every lane gets both). Each round samples 64
// positions of each key's bracket [lo, hi), lo + (s + 1) * step - 1 for s in
// [0, 64), and counts those <= the key (they are a prefix: the offsets are
// sorted); the answer then lies in a bracket of step - 1, or is found where
// step is 1.
__device__ __forceinline__ void warp_upper_bounds(const int32_t* __restrict__ off, int64_t n,
                                                  const int32_t (&key)[2], int64_t (&pos)[2],
                                                  int lane) {
  int64_t lo[2] = {0, 0}, hi[2] = {n, n};
  while (hi[0] > lo[0] || hi[1] > lo[1]) {
    int64_t step[2], p[2][2];
    int32_t v[2][2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int64_t len = hi[k] - lo[k];
      step[k] = len > 64 ? (len + 63) >> 6 : 1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        p[k][h] = lo[k] + (lane + 32 * h + 1) * step[k] - 1;
        v[k][h] = p[k][h] < hi[k] ? __ldg(off + p[k][h]) : 0;
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      int c = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        c += __popc(__ballot_sync(~0u, p[k][h] < hi[k] && v[k][h] <= key[k]));
      const int64_t nhi = lo[k] + (c + 1) * step[k] - 1;
      lo[k] += c * step[k];
      hi[k] = nhi < hi[k] ? nhi : hi[k];
    }
  }
  pos[0] = lo[0];
  pos[1] = lo[1];
}

__global__ void __launch_bounds__(THREADS)
rld_kernel(const int32_t* __restrict__ off, int64_t wg, const int4* __restrict__ val, int cv4,
           const int32_t* __restrict__ base, int64_t bstride, int64_t ch, int64_t segs,
           int4* __restrict__ out) {
  __shared__ int64_t sw[2];
  const int64_t chunk = blockIdx.x / segs;
  const int64_t r0 = (blockIdx.x - chunk * segs) * RLD_ROWS;
  const int rows = (int)(ch - r0 < RLD_ROWS ? ch - r0 : RLD_ROWS);
  const int32_t* o = off + chunk * wg;
  const uint32_t klo = (uint32_t)base[chunk * bstride] + (uint32_t)r0;
  if (threadIdx.x < 32) {
    const uint32_t khi = klo + (uint32_t)(rows - 1);
    const bool wraps = (int32_t)khi < (int32_t)klo;
    const int32_t key[2] = {wraps ? INT32_MIN : (int32_t)klo, wraps ? INT32_MAX : (int32_t)khi};
    int64_t pos[2];
    warp_upper_bounds(o, wg, key, pos, threadIdx.x);
    if (threadIdx.x == 0) {
      sw[0] = pos[0] - 1;
      sw[1] = pos[1] - 1;
    }
  }
  __syncthreads();
  const int64_t wlo = sw[0], m = sw[1] - sw[0];
  const int32_t* b = o + wlo + 1;  // off[wlo + 1 .. whi]: all that decides this block's rows
  // this thread's pieces: threadIdx.x, + THREADS, ... of the block's rows * cv4
  int row = threadIdx.x / cv4, q = threadIdx.x - row * cv4;
  const int dr = THREADS / cv4, dq = THREADS - dr * cv4;
  int4* dst = out + (chunk * ch + r0) * cv4;
  while (row < rows) {
    const int32_t k = (int32_t)(klo + (uint32_t)row);
    int64_t lo = 0, hi = m;  // the first of b[0, m) above k
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (__ldg(b + mid) <= k) lo = mid + 1;
      else hi = mid;
    }
    const int64_t w = wlo + lo;
    const bool covered = w >= 0 && (w < wg - 1 || k < (1 << 30));
    store_stream(dst + (int64_t)row * cv4 + q,
                 covered ? __ldg(val + w * cv4 + q) : make_int4(0, 0, 0, 0));
    row += dr;
    q += dq;
    if (q >= cv4) {
      q -= cv4;
      ++row;
    }
  }
}

}  // namespace

// Every entry point selects the tensors' device (this library links its own
// CUDA runtime), launches on the caller's stream and returns
// cudaGetLastError().

// K6 (CLAMP false) and K7 (CLAMP true): 16-byte pieces where the width and
// both pointers allow them, else 4-byte.
template <bool CLAMP>
static int launch_gather(int device, const void* idx, long long n, const void* table,
                         long long page, long long w, void* out, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool vec = w % 4 == 0 && (uintptr_t)table % 16 == 0 && (uintptr_t)out % 16 == 0;
  const unsigned grid = (unsigned)stride_blocks((n + 31) / 32 * 32);  // a warp per 32 rows
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* ix = (const int32_t*)idx;
  if (vec)
    gather_kernel<CLAMP, float4><<<grid, THREADS, 0, s>>>(ix, n, (const float4*)table, page,
                                                          w / 4, (float4*)out);
  else
    gather_kernel<CLAMP, float><<<grid, THREADS, 0, s>>>(ix, n, (const float*)table, page, w,
                                                         (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int gof_take_gather(int device, const void* idx, long long n, const void* table,
                               long long page, long long w, void* out, void* stream) {
  return launch_gather<false>(device, idx, n, table, page, w, out, stream);
}

extern "C" int gof_vidx_gather(int device, const void* idx, long long n, const void* table,
                               long long page, long long w, void* out, void* stream) {
  return launch_gather<true>(device, idx, n, table, page, w, out, stream);
}

// K8's four passes (prep, count + scan, fill, product) on stream s.
static int onehot_passes(const int32_t* idx, long long n, const float* table, long long page,
                         long long w, uint8_t* tB, int32_t* ws, int2* srt, float* out,
                         cudaStream_t s) {
  const int nb = (int)(page / OH_KSTEP) + 1;  // the k-steps and the sentinel bucket
  onehot_prep_kernel<<<(unsigned)stride_blocks(page * w / 8), THREADS, 0, s>>>(
      table, page, w, (uint4*)tB, ws, nb + 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = nb * 4;
  const unsigned blocks = (unsigned)((n + OH_SORT_BLOCK - 1) / OH_SORT_BLOCK);
  err = cudaFuncSetAttribute(onehot_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  onehot_count_kernel<<<blocks, OH_SORT_THREADS, smem, s>>>(idx, n, page, nb, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(onehot_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  onehot_fill_kernel<<<blocks, OH_SORT_THREADS, smem, s>>>(idx, n, page, nb, ws + 1 + nb, srt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + OH_MTILE - 1) / OH_MTILE), (unsigned)(w / OH_N));
  onehot_wgmma_kernel<<<grid, 128, 0, s>>>(srt, n, tB, w, page, out);
  return (int)cudaGetLastError();
}

// tB: the caller's [page * w] bf16 scratch for the rounded table in wgmma's
// B layout; ws: int32 [2 * (page / 16 + 1) + 1]; srt: int32 [n, 2];
// w % 32 == 0, page % 16 == 0.
extern "C" int gof_onehot_gather(int device, const void* idx, long long n, const void* table,
                                 long long page, long long w, void* tB, void* ws, void* srt,
                                 void* out, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return onehot_passes((const int32_t*)idx, n, (const float*)table, page, w, (uint8_t*)tB,
                       (int32_t*)ws, (int2*)srt, (float*)out, (cudaStream_t)stream);
}

// w % 4 == 0; rows and out 16-byte aligned.
extern "C" int gof_scat(int device, const void* idx, long long n, const void* rows, long long w,
                        long long page, void* out, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long w4 = w / 4;
  scat_kernel<<<(unsigned)stride_blocks(n * w4), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx, n, (const float4*)rows, w4, page, (float4*)out);
  return (int)cudaGetLastError();
}

// cv % 4 == 0; val 16-byte aligned.
extern "C" int gof_rld(int device, const void* off, long long nch, long long wg, const void* val,
                       long long cv, const void* base, long long bstride, long long ch, void* out,
                       void* stream) {
  if (nch <= 0 || ch <= 0 || cv <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long segs = (ch + RLD_ROWS - 1) / RLD_ROWS;
  rld_kernel<<<(unsigned)(nch * segs), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)off, wg, (const int4*)val, (int)(cv / 4), (const int32_t*)base, bstride, ch,
      segs, (int4*)out);
  return (int)cudaGetLastError();
}

static int sm_count(int device) {
  int n = 0;
  return cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) == cudaSuccess ? n
                                                                                          : 132;
}

// tB: the caller's [rows * c8] int8 scratch for the table in wgmma's B layout.
extern "C" int gof_s8_layout(int device, const void* table, long long rows, long long wg,
                             long long c8, void* tB, void* stream) {
  if (rows <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  s8_layout_kernel<<<(unsigned)stride_blocks(rows * c8 / 16), THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)table, rows, wg, c8, (uint4*)tB);
  return (int)cudaGetLastError();
}

// order [nch], starts [npages + 2] int32.
extern "C" int gof_page_group(int device, const void* pages, long long nch, long long npages,
                              void* order, void* starts, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  page_group_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const int32_t*)pages, nch, npages,
                                                        (int32_t*)order, (int32_t*)starts);
  return (int)cudaGetLastError();
}

// The one-hot product of K11 (pages, order, starts null: every chunk on
// page 0 of a [wg, c8] table) and K13 (chunk i on page pages[i]; order and
// starts from gof_page_group), reading the table in gof_s8_layout's layout.
extern "C" int gof_s8_onehot(int device, const void* pages, const void* order,
                             const void* starts, const void* idx, long long nch, long long ch,
                             const void* tB, long long npages, long long wg, long long c8,
                             void* out, void* stream) {
  if (nch <= 0 || ch <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int smem = (int)(wg * S8_SLAB);
  err = cudaFuncSetAttribute(s8_onehot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long units = (c8 / S8_SLAB) * nch * ((ch + S8_MTILE - 1) / S8_MTILE);
  const long long sms = sm_count(device);
  s8_onehot_kernel<<<(unsigned)(units < sms ? units : sms), S8_THREADS, smem,
                     (cudaStream_t)stream>>>(
      (const int32_t*)pages, (const int32_t*)order, (const int32_t*)starts, (const int32_t*)idx,
      nch, ch, (const uint8_t*)tB, npages, wg, c8, (int32_t*)out);
  return (int)cudaGetLastError();
}
