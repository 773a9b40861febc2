// Per-gaussian sum of the backward's compacted gradient rows.
//
// Replaces gof_tpu/ops/reduce.py::_reduce_kernel (launched through
// sorted_segment_reduce / reduce_rows_by_gid). Input: rows [C, R] f32 in the
// backward's compact order, `perm` [R] (a stable sort of the gaussian-id
// stream: perm[j] is the row of the j-th smallest id, equal ids in ascending
// row order) and `starts` [P + 1] (starts[g] = first sorted position with
// id >= g). Output out[c, g] = sum over j in [starts[g], starts[g + 1]) of
// rows[c, perm[j]], summed in ascending j, so the result is bit-identical
// from run to run. Sentinel id P lies at or past starts[P] and is never read.
//
// Design: one thread per (column, id), ids fastest, grid-stride. At the
// training design point (~260k compact rows over a 262,144-slot pool) most
// ids own 0-3 rows, so a warp per id would leave most lanes idle; one
// thread per (column, id) keeps every lane busy and gets the ascending
// order for free. The TPU kernel's sliding indicator-matmul window exists
// to use the MXU; a GPU needs no matmul to add rows.
//
// What bounds it: memory latency. Each row value is read once, through the
// permutation (a random 4-byte read per element; the rows fit in L2 at the
// design point: 24 x 260k x 4 B = 25 MB of the 50 MB), and each output is
// written once, coalesced along ids. No atomics: the original CUDA code's
// atomicAdd accumulation is what made its gradients order-dependent.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
reduce_kernel(const float* __restrict__ rows, int64_t R, int C, const int64_t* __restrict__ perm,
              const int64_t* __restrict__ starts, int64_t P, float* __restrict__ out) {
  const int64_t total = (int64_t)C * P;
  for (int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * THREADS) {
    const int64_t col = t / P;
    const int64_t g = t - col * P;
    const int64_t s = starts[g];
    const int64_t e = starts[g + 1];
    const float* row = rows + col * R;
    float acc = 0.0f;
#pragma unroll 4
    for (int64_t j = s; j < e; ++j) acc = acc + row[perm[j]];
    out[t] = acc;
  }
}

}  // namespace

extern "C" int gof_reduce(int device, const void* rows, long long R, int C, const void* perm,
                          const void* starts, long long P, void* out, void* stream) {
  if (P <= 0 || C <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)C * P;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  reduce_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)rows, R, C, (const int64_t*)perm, (const int64_t*)starts, P, (float*)out);
  return (int)cudaGetLastError();
}
