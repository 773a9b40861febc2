// Per-gaussian sum of the backward's compacted gradient rows, with no key sort.
//
// Replaces gof_tpu/ops/reduce.py::_reduce_kernel (launched through
// sorted_segment_reduce / reduce_rows_by_gid) and, through the row-major
// entry, scripts/pallas_gather_probe.py:152 scatmxu_kernel (call :169), K10,
// the probe's deterministic segment sum (ops/gather_probes.py::scatmxu). Output
// out[c, g] = the sum over the rows r with gid[r] == g of the row's column c,
// taken in ascending r from +0.0, for g in [0, P); rows whose id lies outside
// [0, P) (the sentinel P, any negative id) are dropped. That left fold is the
// plain version's order (a sequential index_add_), so the result is
// bit-identical to it and from run to run. Two entries:
//   gof_reduce       one or two column-major arrays [Ca, R] and [Cb, R]
//                    (C = Ca + Cb columns), copied row-major on the way;
//   gof_reduce_rows  rows that are already row-major, vals [R, cp] (cp a
//                    multiple of 4, 16-byte aligned), of which the first c
//                    columns are summed: the backward blend's row buffer and
//                    K10's rows.
//
// Design: a counting sort of the row indices into P buckets, which is all a
// reduce into P ids needs, in four kernels after one memset:
//   count  one thread per row, an int32 atomicAdd into cnt[gid] (exact in
//          any order);
//   scan   an exclusive scan of cnt in tiles of SCAN_TILE ids (the last tile
//          to finish scans the tile sums), so id g's bucket starts at
//          toff[g / SCAN_TILE] + lstart[g]; ids owning more than SHORT rows
//          go to a list (one atomic per block);
//   fill   one thread per row writes its row index into a slot of its
//          bucket (atomicSub on cnt: the order inside a bucket depends on
//          the atomics); for the column-major entry other blocks of the same
//          launch copy the rows' C values to vals, row-major (cp = C rounded
//          up to 4 floats a row), through shared memory so that reads and
//          writes are whole lines;
//   reduce puts each bucket's row indices in ascending order and folds the
//          rows' values in that order: a thread per id for buckets of up to
//          SHORT rows (a bitonic network in registers, each row read as
//          float4s), a warp per id for up to LONG rows (a bitonic network
//          over the warp's registers, then PIECE rows at a time staged into
//          shared memory with all their loads in flight, a lane per
//          column), a block per id beyond that (ranks from a bitmap of the
//          rows, one window of rows at a time). out[c, g] is written along
//          ids.
// No float atomics and no general sort: the integer atomics only place
// rows, and every sum runs in row order.
//
// What bounds it: bytes. Each row value is read once, coalesced (the
// column-major entry also writes it once to vals and reads it back as whole
// rows). At the training design point (~234k rows, 19 columns used of 24,
// 100k ids, ~29k of them with rows, 3.5k with more than SHORT, the longest
// ~340) that is ~22 MB. Reading the values straight from [C, R] arrays by
// row index instead (one 32-byte sector per value) measured slower on the
// H100, hence the copy, and hence the backward writing its rows row-major.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int SCAN_PER_THREAD = 8;
constexpr int SCAN_TILE = THREADS * SCAN_PER_THREAD;  // ids per scan block
constexpr int SHORT = 16;                             // rows a thread sorts in registers
constexpr int LONG = 512;                             // rows a warp sorts in registers
constexpr int WINDOW_BITS = 1 << 15;                  // rows per bitmap window (block path)
constexpr int WINDOW_WORDS = WINDOW_BITS / 32;
constexpr int WORDS_PER_THREAD = WINDOW_WORDS / THREADS;
constexpr long long MAX_BLOCKS = 132LL * 32;

enum { CTR_TILES_DONE, CTR_LONG, CTR_GIANT, CTR_COUNT };

// The int32 workspace: cnt [P + 1] and the counters (zeroed by the entry
// point), lstart [P + 1], toff [tiles], the long-id list [P] (warp ids from
// the front, block ids from the back), bucket [R]; then the block path's
// ordered rows [R].
struct Workspace {
  int32_t *cnt, *ctr, *lstart, *toff, *lists, *bucket;
};

__host__ __device__ inline long long scan_tiles(long long P) {
  return (P + 1 + SCAN_TILE - 1) / SCAN_TILE;
}

__host__ __device__ inline Workspace carve(int32_t* ws, long long P) {
  Workspace w;
  w.cnt = ws;
  w.ctr = w.cnt + (P + 1);
  w.lstart = w.ctr + CTR_COUNT;
  w.toff = w.lstart + (P + 1);
  w.lists = w.toff + scan_tiles(P);
  w.bucket = w.lists + P;
  return w;
}

long long blocks_for(long long work) {
  const long long b = (work + THREADS - 1) / THREADS;
  return b < 1 ? 1 : (b < MAX_BLOCKS ? b : MAX_BLOCKS);
}

__device__ __forceinline__ int64_t bucket_start(const Workspace& w, int64_t g) {
  return (int64_t)__ldcg(w.toff + g / SCAN_TILE) + w.lstart[g];
}

__global__ void __launch_bounds__(THREADS)
count_kernel(const int32_t* __restrict__ gid, int64_t R, int64_t P, Workspace w) {
  for (int64_t r = (int64_t)blockIdx.x * THREADS + threadIdx.x; r < R;
       r += (int64_t)gridDim.x * THREADS) {
    const int32_t g = gid[r];
    if (g >= 0 && g < P) atomicAdd(w.cnt + g, 1);
  }
}

// Exclusive block scan of one int per thread; returns the block total in *total.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_tot[NWARPS];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(~0u, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  int base = 0, tot = 0;
#pragma unroll
  for (int i = 0; i < NWARPS; ++i) {
    base += i < warp ? warp_tot[i] : 0;
    tot += warp_tot[i];
  }
  __syncthreads();  // warp_tot may be reused by the next call
  *total = tot;
  return base + x - v;
}

__global__ void __launch_bounds__(THREADS)
scan_kernel(int64_t P, Workspace w) {
  const int64_t g0 = (int64_t)blockIdx.x * SCAN_TILE + threadIdx.x * SCAN_PER_THREAD;
  int v[SCAN_PER_THREAD];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < SCAN_PER_THREAD; ++i) {
    const int64_t g = g0 + i;
    v[i] = g < P ? w.cnt[g] : 0;  // cnt[P], the sentinel, is never counted
    sum += v[i];
  }
  // the ids with more than SHORT rows, appended to the lists with one
  // atomic per block and list
  int nl = 0, ng = 0;
#pragma unroll
  for (int i = 0; i < SCAN_PER_THREAD; ++i) {
    nl += v[i] > SHORT && v[i] <= LONG;
    ng += v[i] > LONG;
  }
  int tl, tg;
  int pl = block_exclusive_scan(nl, &tl), pg = block_exclusive_scan(ng, &tg);
  __shared__ int base_l, base_g;
  if (threadIdx.x == 0) {
    base_l = tl ? atomicAdd(w.ctr + CTR_LONG, tl) : 0;
    base_g = tg ? atomicAdd(w.ctr + CTR_GIANT, tg) : 0;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < SCAN_PER_THREAD; ++i) {
    if (v[i] > SHORT && v[i] <= LONG) w.lists[base_l + pl++] = (int32_t)(g0 + i);
    if (v[i] > LONG) w.lists[P - 1 - (base_g + pg++)] = (int32_t)(g0 + i);
  }
  int total;
  int run = block_exclusive_scan(sum, &total);
#pragma unroll
  for (int i = 0; i < SCAN_PER_THREAD; ++i) {
    if (g0 + i <= P) w.lstart[g0 + i] = run;
    run += v[i];
  }
  // the last tile to finish turns the tile totals into exclusive offsets
  __shared__ bool last;
  if (threadIdx.x == 0) {
    w.toff[blockIdx.x] = total;
    __threadfence();
    last = atomicAdd(w.ctr + CTR_TILES_DONE, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int carry = 0;
  for (int64_t t0 = 0; t0 < gridDim.x; t0 += THREADS) {
    const int64_t t = t0 + threadIdx.x;
    const int x = t < gridDim.x ? __ldcg(w.toff + t) : 0;
    int tot;
    const int ex = block_exclusive_scan(x, &tot);
    if (t < gridDim.x) w.toff[t] = carry + ex;
    carry += tot;
  }
}

// Two jobs in one launch, so the latency-bound bucket fill runs under the
// copy: blocks [0, copy_blocks) copy the rows' C values (padded to cp, a
// multiple of 4) to vals, row-major, one warp per 32 rows through a
// [32 x 33] shared tile, so the reads (a column of 32 rows) and the writes
// (32 rows x cp floats, contiguous) are both whole lines; the other blocks
// write each row's index into a slot of its bucket (atomicSub on cnt).
__global__ void __launch_bounds__(THREADS)
fill_kernel(const float* __restrict__ a, int ca, const float* __restrict__ b, int cb,
            const int32_t* __restrict__ gid, int64_t R, int64_t P, int cp, Workspace w,
            int copy_blocks, float* __restrict__ vals) {
  if ((int)blockIdx.x >= copy_blocks) {
    const int64_t stride = (int64_t)(gridDim.x - copy_blocks) * THREADS;
    for (int64_t r = (int64_t)(blockIdx.x - copy_blocks) * THREADS + threadIdx.x; r < R;
         r += stride) {
      const int32_t g = gid[r];
      if (g >= 0 && g < P)
        w.bucket[bucket_start(w, g) + atomicSub(w.cnt + g, 1) - 1] = (int32_t)r;
    }
    return;
  }
  __shared__ float tile[NWARPS][32 * 33];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* t = tile[warp];
  for (int64_t base = ((int64_t)blockIdx.x * NWARPS + warp) * 32; base < R;
       base += (int64_t)copy_blocks * NWARPS * 32) {
    const int64_t r = base + lane;
    for (int c0 = 0; c0 < cp; c0 += 32) {
      const int width = cp - c0 < 32 ? cp - c0 : 32;
#pragma unroll 8
      for (int c = 0; c < width; ++c) {
        const int k = c0 + c;
        t[lane * 33 + c] = r >= R ? 0.0f
                           : (k < ca ? __ldg(a + (int64_t)k * R + r)
                                     : (k < ca + cb ? __ldg(b + (int64_t)(k - ca) * R + r) : 0.0f));
      }
      __syncwarp();
      for (int q = lane; q < 32 * width; q += 32) {
        const int row = q / width, col = q - row * width;
        if (base + row < R) vals[(base + row) * cp + c0 + col] = t[row * 33 + col];
      }
      __syncwarp();
    }
  }
}

// Sorts the bucket of n row indices at bucket[0, n) (32 * E >= n) into
// key[0, 32 E), ascending, padded with 0xFFFFFFFF: a bitonic network over
// the warp's registers, E keys a lane (element lane * E + e), shuffles
// across lanes.
template <int E>
__device__ __forceinline__ void warp_sort(const int32_t* bucket, int n, uint32_t* key) {
  const int lane = threadIdx.x % 32;
  uint32_t v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane * E + e;
    v[e] = i < n ? (uint32_t)bucket[i] : 0xFFFFFFFFu;
  }
#pragma unroll
  for (int k = 2; k <= 32 * E; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= E) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const uint32_t pv = __shfl_xor_sync(~0u, v[e], j / E);
          const bool up = ((lane * E + e) & k) == 0, lower = (lane & (j / E)) == 0;
          v[e] = up == lower ? min(v[e], pv) : max(v[e], pv);
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int p = e ^ j;
          if (p > e) {
            const bool up = ((lane * E + e) & k) == 0;
            const uint32_t lo = min(v[e], v[p]), hi = max(v[e], v[p]);
            v[e] = up ? lo : hi;
            v[p] = up ? hi : lo;
          }
        }
      }
    }
#pragma unroll
  for (int e = 0; e < E; ++e) key[lane * E + e] = v[e];
  __syncwarp();
}

// Ascending bitonic network over the first N of SHORT keys in registers.
template <int N>
__device__ __forceinline__ void bitonic_regs(uint32_t (&key)[SHORT]) {
#pragma unroll
  for (int k = 2; k <= N; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1)
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int p = i ^ j;
        if (p > i) {
          const uint32_t lo = min(key[i], key[p]), hi = max(key[i], key[p]);
          key[i] = (i & k) == 0 ? lo : hi;
          key[p] = (i & k) == 0 ? hi : lo;
        }
      }
}

constexpr int PIECE = 32;  // rows a warp stages at a time in the long path

struct WarpSmem {
  uint32_t key[LONG];
  float stage[PIECE * 32];  // PIECE rows x 32 columns
};

struct Bitmap {
  uint32_t bits[WINDOW_WORDS];
  int32_t prefix[WINDOW_WORDS];
};

union ReduceSmem {
  WarpSmem warp[NWARPS];
  Bitmap map;
};

// Folds column c0 + lane of the rows keys[0, n) (ascending) into acc, PIECE
// rows at a time: the warp stages each piece's 32 columns into shared memory
// with every load in flight at once, then each lane adds its column in order.
__device__ __forceinline__ float warp_fold(const float4* __restrict__ vals, int cp,
                                           const uint32_t* keys, int64_t n, int c0,
                                           float* stage) {
  const int lane = threadIdx.x % 32;
  const int q4 = lane % 8;  // this lane's float4 of a staged row
  const bool q_ok = c0 / 4 + q4 < cp / 4;
  float acc = 0.0f;
  for (int64_t p0 = 0; p0 < n; p0 += PIECE) {
    float4 v[PIECE / 4];
#pragma unroll
    for (int i = 0; i < PIECE / 4; ++i) {  // row p0 + lane / 8 + 4 i
      const int64_t k = p0 + lane / 8 + 4 * i;
      v[i] = (k < n && q_ok) ? vals[(int64_t)keys[k] * (cp / 4) + c0 / 4 + q4]
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int i = 0; i < PIECE / 4; ++i)
      reinterpret_cast<float4*>(stage)[(lane / 8 + 4 * i) * 8 + q4] = v[i];
    __syncwarp();
    const int m = n - p0 < PIECE ? (int)(n - p0) : PIECE;
    for (int k = 0; k < m; ++k) acc = acc + stage[k * 32 + lane];
    __syncwarp();
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS)
reduce_kernel(const float4* __restrict__ vals, int64_t R, int64_t P, int c, int cp, Workspace w,
              int long_blocks, int giant_blocks, int32_t* __restrict__ order,
              float* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  ReduceSmem& sm = *reinterpret_cast<ReduceSmem*>(smem_raw);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  if ((int)blockIdx.x < long_blocks) {
    // a warp per id with SHORT < n <= LONG rows: a bitonic sort of its row
    // indices in registers, then the staged fold
    const int nlong = __ldcg(w.ctr + CTR_LONG);
    WarpSmem& ws = sm.warp[warp];
    for (int li = blockIdx.x * NWARPS + warp; li < nlong; li += long_blocks * NWARPS) {
      const int64_t g = w.lists[li];
      const int64_t st = bucket_start(w, g);
      const int n = (int)(bucket_start(w, g + 1) - st);
      const int32_t* bk = w.bucket + st;
      if (n <= 32) warp_sort<1>(bk, n, ws.key);
      else if (n <= 64) warp_sort<2>(bk, n, ws.key);
      else if (n <= 128) warp_sort<4>(bk, n, ws.key);
      else if (n <= 256) warp_sort<8>(bk, n, ws.key);
      else warp_sort<16>(bk, n, ws.key);
      for (int c0 = 0; c0 < c; c0 += 32) {
        const float acc = warp_fold(vals, cp, ws.key, n, c0, ws.stage);
        if (c0 + lane < c) out[(int64_t)(c0 + lane) * P + g] = acc;
      }
    }
    return;
  }

  if ((int)blockIdx.x < long_blocks + giant_blocks) {
    // a block per id with more than LONG rows: each row's rank among its
    // bucket from a bitmap of the rows, one window of rows at a time, gives
    // the bucket in ascending order (in `order`); warp 0 folds it
    const int ngiant = __ldcg(w.ctr + CTR_GIANT);
    Bitmap& bm = sm.map;
    __shared__ int win_total;
    for (int gi = blockIdx.x - long_blocks; gi < ngiant; gi += giant_blocks) {
      const int64_t g = w.lists[P - 1 - gi];
      const int64_t st = bucket_start(w, g);
      const int64_t n = bucket_start(w, g + 1) - st;
      int64_t base = 0;
      for (int64_t w0 = 0; w0 < R; w0 += WINDOW_BITS) {
        for (int i = threadIdx.x; i < WINDOW_WORDS; i += THREADS) bm.bits[i] = 0u;
        __syncthreads();
        for (int64_t i = threadIdx.x; i < n; i += THREADS) {
          const int64_t k = w.bucket[st + i] - w0;
          if (k >= 0 && k < WINDOW_BITS) atomicOr(bm.bits + (k >> 5), 1u << (k & 31));
        }
        __syncthreads();
        int cnt = 0;
#pragma unroll
        for (int q = 0; q < WORDS_PER_THREAD; ++q)
          cnt += __popc(bm.bits[threadIdx.x * WORDS_PER_THREAD + q]);
        int tot;
        int run = block_exclusive_scan(cnt, &tot);
#pragma unroll
        for (int q = 0; q < WORDS_PER_THREAD; ++q) {
          const int word = threadIdx.x * WORDS_PER_THREAD + q;
          bm.prefix[word] = run;
          run += __popc(bm.bits[word]);
        }
        if (threadIdx.x == 0) win_total = tot;
        __syncthreads();
        for (int64_t i = threadIdx.x; i < n; i += THREADS) {
          const int64_t k = w.bucket[st + i] - w0;
          if (k >= 0 && k < WINDOW_BITS) {
            const int rank =
                bm.prefix[k >> 5] + __popc(bm.bits[k >> 5] & ((1u << (k & 31)) - 1u));
            order[st + base + rank] = (int32_t)(w0 + k);
          }
        }
        base += win_total;
        __syncthreads();
      }
      if (warp == 0)
        for (int c0 = 0; c0 < c; c0 += 32) {
          const float acc = warp_fold(vals, cp, reinterpret_cast<const uint32_t*>(order + st), n,
                                      c0, sm.warp[0].stage);
          if (c0 + lane < c) out[(int64_t)(c0 + lane) * P + g] = acc;
        }
      __syncthreads();
    }
    return;
  }

  // a thread per id with at most SHORT rows (every id without rows included)
  const int64_t g = (int64_t)(blockIdx.x - long_blocks - giant_blocks) * THREADS + threadIdx.x;
  if (g >= P) return;
  const int64_t st = bucket_start(w, g);
  const int n = (int)(bucket_start(w, g + 1) - st);
  if (n > SHORT) return;
  uint32_t key[SHORT];
#pragma unroll
  for (int i = 0; i < SHORT; ++i) key[i] = i < n ? (uint32_t)w.bucket[st + i] : 0xFFFFFFFFu;
  if (n > 8) bitonic_regs<16>(key);
  else if (n > 4) bitonic_regs<8>(key);
  else if (n > 1) bitonic_regs<4>(key);
  for (int c0 = 0; c0 < c; c0 += 4) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < SHORT; ++i) {
      if (i < n) {
        const float4 v = vals[(int64_t)key[i] * (cp / 4) + c0 / 4];
        acc.x = acc.x + v.x;
        acc.y = acc.y + v.y;
        acc.z = acc.z + v.z;
        acc.w = acc.w + v.w;
      }
    }
    const float q[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c0 + i < c) out[(int64_t)(c0 + i) * P + g] = q[i];
  }
}

int sm_count(int device) {
  int n = 0;
  return cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) == cudaSuccess ? n
                                                                                          : 132;
}

}  // namespace

// int32 words of the workspace gof_reduce and gof_reduce_rows need for P ids
// and R rows.
extern "C" long long gof_reduce_workspace(long long P, long long R) {
  return 2 * (P + 1) + CTR_COUNT + scan_tiles(P) + P + 2 * R;
}

namespace {

// The four kernels after the memset. When a is null, vals already holds the
// rows and the fill launch only places them.
int reduce_rows(int device, const float* a, int ca, const float* b, int cb, long long R,
                const int32_t* g, long long P, int32_t* ws, float* vals, int cp, int c,
                float* out, cudaStream_t s) {
  if (P <= 0 || c <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Workspace w = carve(ws, P);
  err = cudaMemsetAsync(w.cnt, 0, (size_t)(P + 1 + CTR_COUNT) * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  int32_t* order = w.bucket + R;  // the block path's ordered rows
  if (R > 0) {
    count_kernel<<<(unsigned)blocks_for(R), THREADS, 0, s>>>(g, R, P, w);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  scan_kernel<<<(unsigned)scan_tiles(P), THREADS, 0, s>>>(P, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (R > 0) {
    const long long copy_blocks = a ? blocks_for(R) : 0;
    fill_kernel<<<(unsigned)(copy_blocks + blocks_for(R)), THREADS, 0, s>>>(
        a, ca, b, cb, g, R, P, cp, w, (int)copy_blocks, vals);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int sms = sm_count(device);
  const int long_blocks = 2 * sms, giant_blocks = sms / 4 > 0 ? sms / 4 : 1;
  const long long blocks = long_blocks + giant_blocks + (P + THREADS - 1) / THREADS;
  const int smem = (int)sizeof(ReduceSmem);
  err = cudaFuncSetAttribute(reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  reduce_kernel<<<(unsigned)blocks, THREADS, smem, s>>>((const float4*)vals, R, P, c, cp, w,
                                                        long_blocks, giant_blocks, order, out);
  return (int)cudaGetLastError();
}

}  // namespace

// rows_a [ca, R] and rows_b [cb, R] f32 (cb may be 0), gid [R] int32 ->
// out [ca + cb, P] f32. ws: gof_reduce_workspace(P, R) int32 words; vals:
// [R, cp] f32 scratch, cp = ca + cb rounded up to a multiple of 4.
extern "C" int gof_reduce(int device, const void* rows_a, int ca, const void* rows_b, int cb,
                          long long R, const void* gid, long long P, void* ws, void* vals,
                          void* out, void* stream) {
  const int c = ca + cb;
  return reduce_rows(device, (const float*)rows_a, ca, (const float*)rows_b, cb, R,
                     (const int32_t*)gid, P, (int32_t*)ws, (float*)vals, (c + 3) / 4 * 4, c,
                     (float*)out, (cudaStream_t)stream);
}

// vals [R, cp] f32 row-major (cp a multiple of 4, 16-byte aligned), gid [R]
// int32 -> out [c, P] f32, the sums of the first c <= cp columns. ws:
// gof_reduce_workspace(P, R) int32 words.
extern "C" int gof_reduce_rows(int device, const void* vals, long long R, int cp, int c,
                               const void* gid, long long P, void* ws, void* out, void* stream) {
  return reduce_rows(device, nullptr, 0, nullptr, 0, R, (const int32_t*)gid, P, (int32_t*)ws,
                     (float*)vals, cp, c, (float*)out, (cudaStream_t)stream);
}
