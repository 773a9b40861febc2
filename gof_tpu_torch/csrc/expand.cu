// Class-expansion gather: out[c][k] = tbl[c][gidx[k]] for int32 columns.
//
// Replaces gof_tpu/ops/class_gather.py::_expand_kernel (the Pallas kernel
// launched by expand_kernel_call). On the TPU the gather was an indicator
// matmul over byte planes, because the MXU was the only fast way to move
// rows there. On Hopper a gather is a plain load, so the kernel is one
// thread per slot in a grid-stride loop, copying 32-bit patterns (float bits
// and negative ints pass through untouched).
//
// What bounds it: bytes. At the serving design point (1237x822, 100k
// gaussians, 1014 tiles) it moves about CAP * 4 * (1 + 2 * ncols) bytes:
// gidx once, then one read and one write per column. gidx is monotone with
// steps of 0 or 1, so neighbouring threads read the same or neighbouring
// table entries: the table reads coalesce like the writes, and the table
// (ncols * P * 4 bytes, 2.8 MB at 100k gaussians) stays in L2.
//
// Also holds gof_error_string, the library's error-message helper.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void expand_kernel(const int32_t* __restrict__ tbl, int ncols, int64_t P,
                              const int32_t* __restrict__ gidx, int64_t cap,
                              int32_t* __restrict__ out) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < cap; k += step) {
    const int64_t g = gidx[k];
    for (int c = 0; c < ncols; ++c) {
      out[c * cap + k] = __ldg(tbl + c * P + g);
    }
  }
}

}  // namespace

extern "C" int gof_expand(int device, const void* tbl, int ncols, long long P,
                          const void* gidx, long long cap, void* out, void* stream) {
  if (cap <= 0 || ncols <= 0) return 0;
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  long long blocks = (cap + threads - 1) / threads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond 32 blocks per SM
  expand_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tbl, ncols, P, (const int32_t*)gidx, cap, (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* gof_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
