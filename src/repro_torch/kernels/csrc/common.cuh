// Helpers shared by the attention and recurrence kernels: element
// conversion to and from float32, the dtype codes of the C interface,
// and the error-string entry every kernel library exports.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace repro {

// dtype codes passed from Python (kernels/_cuda.py DTYPE_CODES)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

constexpr float kNegInf = -1e30f;  // the oracles' NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}

// Copies `rows` rows of HD elements (row r at src + r * stride) into
// float32 shared memory with row pitch `pitch`, 16 bytes per load; rows
// at or past `nvalid` are zero-filled.  src and every row start must be
// 16-byte aligned (the wrappers check the base pointer; HD * sizeof(T)
// is a multiple of 16).
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, int pitch,
                                          const T* src, long long stride,
                                          int rows, int nvalid) {
  constexpr int V = 16 / sizeof(T);
  constexpr int VPR = HD / V;
  static_assert(HD % V == 0, "row must be a whole number of 16 B vectors");
  for (int idx = threadIdx.x; idx < rows * VPR; idx += blockDim.x) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * V;
    float* d = dst + r * pitch + c;
    if (r < nvalid) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          src + (long long)r * stride + c));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) d[i] = to_f32(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) d[i] = 0.f;
    }
  }
}

}  // namespace repro

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
