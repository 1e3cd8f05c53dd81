// Row-wise anomaly score: o = 1 / (1 + exp(-|x - mu| / (1 + |mu|))).
//
// Replaces the Pallas kernel data_accelerator_tpu/udf/samples.py
// ::_anomaly_kernel, which data_accelerator_tpu/udf/api.py
// ::PallasUdf._pallas_call launches over 1-D row blocks.
//
// Bound: device memory. Each row reads 4 bytes of x and 4 bytes of mu and
// writes 4 bytes of o, 12 bytes a row and nine flops. At 262,144 rows a
// batch that is about 3.1 MB, 0.94 us at the H100 SXM's published 3.35 TB/s
// (700 W); it fits the 50 MB L2, so at that size a launch and one memory
// latency set the time. At 16,777,216 rows it is 201 MB, 60 us.
//
// Design: one memory round trip per thread. Each thread loads 4 rows of x
// and 4 of mu as two 16-byte vectors, scores them in float32 and stores 4
// scores as one 16-byte vector; all its loads are in flight before its
// first store. `out` must start on a 16-byte boundary, as every fresh
// allocation from PyTorch does; the up to 3 rows after the last whole
// vector are a scalar tail, one row to a thread. An input that starts
// off a 16-byte boundary, such as a view x[1:], loads its 4 rows one by
// one, still coalesced across the warp. One thread per vector,
// with no loop. Both inputs are cast to float32 inside, as the Pallas
// body does; expf and true division are kept (no --use_fast_math): the
// kernel waits on memory, so the fast intrinsics would buy nothing, and
// it matches the plain version exactly.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit (PERF.md): 0.0023 ms of device time at 262,144 rows, where a
// launch sets the time (the grid-stride design before it: 0.0025); and
// 0.068 ms at 16,777,216 rows, 88% of the bound (before: 0.076, 79%).

// Plain C interface for ctypes: pointers and the stream arrive as void*,
// the launch returns cudaGetLastError() and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // rows in one 16-byte vector

template <typename T>
__device__ __forceinline__ float4 load_rows(const T* __restrict__ p,
                                            bool vec) {
  if (vec) {
    if constexpr (std::is_same_v<T, float>) {
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

__device__ __forceinline__ float score(float xv, float m) {
  const float d = fabsf(xv - m) / (1.0f + fabsf(m));
  return 1.0f / (1.0f + expf(-d));
}

// Rows [kVec * n_vec, n) are the scalar tail; vector t holds rows
// [kVec * t, kVec * t + kVec), on a 16-byte boundary of `out`.
template <typename XT, typename MuT>
__global__ void __launch_bounds__(kThreads)
    anomaly_score_kernel(const XT* __restrict__ x, const MuT* __restrict__ mu,
                         float* __restrict__ out, int64_t n, int64_t n_vec,
                         bool x_vec, bool mu_vec) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t tail = kVec * n_vec + t;
  if (t < kVec - 1 && tail < n) {
    out[tail] = score(static_cast<float>(x[tail]),
                      static_cast<float>(mu[tail]));
  }
  if (t < n_vec) {
    const int64_t i = kVec * t;
    const float4 xv = load_rows(x + i, x_vec);
    const float4 m = load_rows(mu + i, mu_vec);
    // one 16-byte store: assigning a float4 compiled to four 4-byte ones
    __stwb(reinterpret_cast<float4*>(out + i),
           make_float4(score(xv.x, m.x), score(xv.y, m.y), score(xv.z, m.z),
                       score(xv.w, m.w)));
  }
}

template <typename XT, typename MuT>
void launch(const void* x, const void* mu, float* out, int64_t n,
            int64_t n_vec, bool x_vec, bool mu_vec, int64_t blocks,
            cudaStream_t stream) {
  anomaly_score_kernel<XT, MuT><<<static_cast<unsigned>(blocks), kThreads, 0,
                                  stream>>>(
      static_cast<const XT*>(x), static_cast<const MuT*>(mu), out, n, n_vec,
      x_vec, mu_vec);
}

}  // namespace

// dtype codes: 0 = float32, 1 = int32.
extern "C" int dx_anomaly_score(const void* x, int x_dtype, const void* mu,
                                int mu_dtype, void* out, long long n,
                                void* stream) {
  if (n < 0 || x_dtype < 0 || x_dtype > 1 || mu_dtype < 0 || mu_dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ma = reinterpret_cast<uintptr_t>(mu);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  // the inputs may be views that start anywhere on a row; the output is
  // a fresh allocation, on a 16-byte boundary
  if (xa % 4 != 0 || ma % 4 != 0 || oa % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (n == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t n_vec = n / kVec;
  const bool x_vec = xa % 16 == 0;
  const bool mu_vec = ma % 16 == 0;
  int64_t blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks == 0) blocks = 1;  // the tail alone
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (x_dtype == 0 && mu_dtype == 0) {
    launch<float, float>(x, mu, o, n, n_vec, x_vec, mu_vec, blocks, s);
  } else if (x_dtype == 0 && mu_dtype == 1) {
    launch<float, int32_t>(x, mu, o, n, n_vec, x_vec, mu_vec, blocks, s);
  } else if (x_dtype == 1 && mu_dtype == 0) {
    launch<int32_t, float>(x, mu, o, n, n_vec, x_vec, mu_vec, blocks, s);
  } else {
    launch<int32_t, int32_t>(x, mu, o, n, n_vec, x_vec, mu_vec, blocks, s);
  }
  return static_cast<int>(cudaGetLastError());
}
