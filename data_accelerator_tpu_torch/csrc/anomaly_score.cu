// Row-wise anomaly score: o = 1 / (1 + exp(-|x - mu| / (1 + |mu|))).
//
// Replaces the Pallas kernel data_accelerator_tpu/udf/samples.py
// ::_anomaly_kernel, which data_accelerator_tpu/udf/api.py
// ::PallasUdf._pallas_call launches over 1-D row blocks.
//
// Bound: device memory. Each row reads 4 bytes of x and 4 bytes of mu and
// writes 4 bytes of o, 12 bytes a row and nine flops. At 262,144 rows a
// batch that is about 3.1 MB, whose least time at the H100 SXM's published
// 3.35 TB/s (700 W) is 0.94 us, so launch latency dominates at this size:
// on an NVIDIA H100 80GB HBM3 at a 700 W limit, chip_smoke.py measured
// 2.6 us on the device and 35 us a call from Python (PERF.md).
//
// Design: the Pallas block layout is not carried over. One thread handles
// a few rows through a grid-stride loop; neighbouring threads touch
// neighbouring addresses, so loads and stores coalesce, and the loop bound
// masks the tail. Both inputs are cast to float32 inside, as the Pallas
// body does. This simple form is right; fusing the score into the
// projection pass that produces x and mu is later work.
//
// Plain C interface for ctypes: pointers and the stream arrive as void*,
// the launch returns cudaGetLastError() and never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kMaxBlocks = 65535;

template <typename XT, typename MuT>
__global__ void anomaly_score_kernel(const XT* __restrict__ x,
                                     const MuT* __restrict__ mu,
                                     float* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float xv = static_cast<float>(x[i]);
    const float m = static_cast<float>(mu[i]);
    const float d = fabsf(xv - m) / (1.0f + fabsf(m));
    out[i] = 1.0f / (1.0f + expf(-d));
  }
}

template <typename XT, typename MuT>
void launch(const void* x, const void* mu, void* out, int64_t n,
            cudaStream_t stream) {
  int64_t blocks = (n + kThreads * kRowsPerThread - 1) /
                   (kThreads * kRowsPerThread);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  anomaly_score_kernel<XT, MuT><<<static_cast<unsigned>(blocks), kThreads, 0,
                                  stream>>>(
      static_cast<const XT*>(x), static_cast<const MuT*>(mu),
      static_cast<float*>(out), n);
}

}  // namespace

// dtype codes: 0 = float32, 1 = int32.
extern "C" int dx_anomaly_score(const void* x, int x_dtype, const void* mu,
                                int mu_dtype, void* out, long long n,
                                void* stream) {
  if (n < 0 || x_dtype < 0 || x_dtype > 1 || mu_dtype < 0 || mu_dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && mu_dtype == 0) {
    launch<float, float>(x, mu, out, n, s);
  } else if (x_dtype == 0 && mu_dtype == 1) {
    launch<float, int32_t>(x, mu, out, n, s);
  } else if (x_dtype == 1 && mu_dtype == 0) {
    launch<int32_t, float>(x, mu, out, n, s);
  } else {
    launch<int32_t, int32_t>(x, mu, out, n, s);
  }
  return static_cast<int>(cudaGetLastError());
}
