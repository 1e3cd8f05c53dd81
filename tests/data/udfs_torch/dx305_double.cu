// User-UDF kernel: o[i] = (float)x[i] * 2.0f, for float32 or int32 x.
//
// Replaces the Pallas kernel tests/data/udfs/dx305_pallas.py::_kernel,
// which that fixture's pallas_call launches as one block over the column.
// Launched through data_accelerator_tpu_torch/kernels/launch.py::cuda_call,
// whose fixed C signature the entry point below follows.
//
// Bound: device memory. Each row reads 4 bytes and writes 4 bytes, one
// multiply; at 262,144 rows that is 2.1 MB, whose least time at the H100
// SXM's published 3.35 TB/s is 0.63 us, so launch latency dominates.
//
// Design: no block layout is carried over. A grid-stride loop lets any
// grid cover any n: neighbouring threads touch neighbouring addresses, so
// loads and stores coalesce, and the loop bound masks the tail. A caller's
// grid (cuda_call's grid=) sets the block count; 0 picks one that gives
// each thread a few rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int64_t kMaxBlocks = 65535;

template <typename XT>
__global__ void double_kernel(const XT* __restrict__ x, float* __restrict__ out,
                              int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = static_cast<float>(x[i]) * 2.0f;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = int32 (kernels/launch.py DTYPE_CODES).
extern "C" int dx305_double(const void* const* inputs, const int* dtypes,
                            int n_inputs, void* out, int out_dtype,
                            long long n, int grid, void* stream) {
  if (n_inputs != 1 || out_dtype != 0 || n < 0 || grid < 0 ||
      dtypes[0] < 0 || dtypes[0] > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  int64_t blocks = grid;
  if (blocks == 0) {
    blocks = (n + kThreads * kRowsPerThread - 1) / (kThreads * kRowsPerThread);
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtypes[0] == 0) {
    double_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(inputs[0]), o, n);
  } else {
    double_kernel<int32_t><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const int32_t*>(inputs[0]), o, n);
  }
  return static_cast<int>(cudaGetLastError());
}
