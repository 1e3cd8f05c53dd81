// User-UDF kernel: o[i] = (float)x[i] * 2.0f, for float32 or int32 x.
//
// Replaces the Pallas kernel tests/data/udfs/dx305_pallas.py::_kernel,
// which that fixture's pallas_call launches as one block over the column.
// Launched through data_accelerator_tpu_torch/kernels/launch.py::cuda_call,
// whose fixed C signature the entry point below follows.
//
// Bound: device memory. Each row reads 4 bytes and writes 4 bytes, one
// multiply: at 262,144 rows 2.1 MB, 0.63 us at the H100 SXM's published
// 3.35 TB/s; at 16,777,216 rows 134 MB, 40 us, beyond the 50 MB L2.
//
// Design: one memory round trip per thread. Each thread loads 4 rows as
// one 16-byte vector, converts and doubles them, and stores one 16-byte
// vector, so a warp moves 512 contiguous bytes each way in one load and
// one store instruction. `out` must start on a 16-byte boundary, as every
// fresh allocation from PyTorch does; the up to 3 rows after the last
// whole vector are a scalar tail, one row to a thread. An `x` that starts
// off a 16-byte boundary, such as a view x[1:], loads its 4 rows one by
// one (still coalesced across the warp) and stores a vector.
// With no grid from the caller the grid is one thread per vector, with no
// loop; a caller's grid (cuda_call's grid=) keeps a grid-stride loop over
// vectors, so any grid of 1 block or more covers every row.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit (PERF.md): 0.0017 ms of device time at 262,144 rows, within 2%
// of torch.mul(x, 2.0), since a launch sets the time at that size; and
// 0.047 ms at 16,777,216 rows, 85% of the bound, as torch.mul.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // rows in one 16-byte vector

template <typename XT>
__device__ __forceinline__ float4 load_rows(const XT* __restrict__ p,
                                            bool vec) {
  if (vec) {
    if constexpr (std::is_same_v<XT, float>) {
      return *reinterpret_cast<const float4*>(p);
    } else {
      const int4 v = *reinterpret_cast<const int4*>(p);
      return make_float4(static_cast<float>(v.x), static_cast<float>(v.y),
                         static_cast<float>(v.z), static_cast<float>(v.w));
    }
  }
  return make_float4(static_cast<float>(p[0]), static_cast<float>(p[1]),
                     static_cast<float>(p[2]), static_cast<float>(p[3]));
}

template <typename XT>
__device__ __forceinline__ void double_vec(const XT* __restrict__ x,
                                           float* __restrict__ out, int64_t i,
                                           bool x_vec) {
  float4 r = load_rows(x + i, x_vec);
  r.x *= 2.0f;
  r.y *= 2.0f;
  r.z *= 2.0f;
  r.w *= 2.0f;
  // one 16-byte store: assigning a float4 compiled to four 4-byte ones
  __stwb(reinterpret_cast<float4*>(out + i), r);
}

// Rows [kVec * n_vec, n) are the scalar tail; vector v holds rows
// [kVec * v, kVec * v + kVec), on a 16-byte boundary of `out`.
template <typename XT, bool kStride>
__global__ void __launch_bounds__(kThreads)
    double_kernel(const XT* __restrict__ x, float* __restrict__ out,
                  int64_t n, int64_t n_vec, bool x_vec) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t tail = kVec * n_vec + t;
  if (t < kVec - 1 && tail < n) {
    out[tail] = static_cast<float>(x[tail]) * 2.0f;
  }
  if constexpr (kStride) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    for (int64_t v = t; v < n_vec; v += stride) {
      double_vec(x, out, kVec * v, x_vec);
    }
  } else if (t < n_vec) {
    double_vec(x, out, kVec * t, x_vec);
  }
}

template <typename XT>
void launch(const void* x, float* out, int64_t n, int64_t n_vec, bool x_vec,
            int64_t blocks, bool stride, cudaStream_t s) {
  const XT* xp = static_cast<const XT*>(x);
  const unsigned g = static_cast<unsigned>(blocks);
  if (stride) {
    double_kernel<XT, true><<<g, kThreads, 0, s>>>(xp, out, n, n_vec, x_vec);
  } else {
    double_kernel<XT, false><<<g, kThreads, 0, s>>>(xp, out, n, n_vec, x_vec);
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
  const uintptr_t xa = reinterpret_cast<uintptr_t>(inputs[0]);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  // x may be a view that starts anywhere on a row; the output is a fresh
  // allocation, on a 16-byte boundary
  if (xa % 4 != 0 || oa % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (n == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t n_vec = n / kVec;
  const bool x_vec = xa % 16 == 0;
  int64_t blocks = grid;
  if (grid == 0) {
    blocks = (n_vec + kThreads - 1) / kThreads;
    if (blocks == 0) blocks = 1;  // the tail alone
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtypes[0] == 0) {
    launch<float>(inputs[0], o, n, n_vec, x_vec, blocks, grid != 0, s);
  } else {
    launch<int32_t>(inputs[0], o, n, n_vec, x_vec, blocks, grid != 0, s);
  }
  return static_cast<int>(cudaGetLastError());
}
