// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t, for Hopper.
//
// Replaces repro/kernels/rglru_scan.py:rglru_scan_pallas (:62), the
// Pallas kernel _rglru_kernel (:31).  a, b: (B, T, W) in float32 or
// bfloat16; h0: (B, W) float32.  Writes h (B, T, W) in the input dtype
// and h_last (B, W) in float32.
//
// What bounds it: memory.  Each (b, t, w) element reads a and b and
// writes h, one multiply-add apart: 6 bytes per element in bfloat16
// against 2 operations, far below the card's operations-per-byte line.
//
// Design.  The Pallas kernel solves each chunk of T as a log-space
// cumulative product, because a TPU core wants wide vector work per grid
// step; its -40 floor on log a and e^80 cap on the rescale keep that form
// finite where a < e^-40.  Here one thread owns one (b, w) channel and
// runs the recurrence in order over T with a float32 carry, which is the
// recurrence itself: it needs neither clamp, nor T % chunk == 0, nor
// W % wblock == 0.  Neighbouring threads own neighbouring w, so every
// load and store of a warp is one contiguous run.  Each thread loads the
// next kUnroll steps of a and b into registers before it computes the
// current ones, so loads stay in flight while the carry chain runs.
//
// Later work: with B * W = 32K channels the card holds few bytes in
// flight per SM; a chunked two-pass scan over T would add parallelism.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(T* __restrict__ h_out, float* __restrict__ h_last,
                  const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ h0, int T_len, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int row = blockIdx.y;
  if (w >= W) return;
  const long long base = (long long)row * T_len * W + w;
  const T* pa = a + base;
  const T* pb = b + base;
  T* ph = h_out + base;
  float h = h0[(long long)row * W + w];

  float na[kUnroll], nb[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const bool ok = u < T_len;
    na[u] = ok ? repro::to_f32(pa[(long long)u * W]) : 0.f;
    nb[u] = ok ? repro::to_f32(pb[(long long)u * W]) : 0.f;
  }
  for (int t0 = 0; t0 < T_len; t0 += kUnroll) {
    float ca[kUnroll], cb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ca[u] = na[u];
      cb[u] = nb[u];
      const int t = t0 + kUnroll + u;
      const bool ok = t < T_len;
      na[u] = ok ? repro::to_f32(pa[(long long)t * W]) : 0.f;
      nb[u] = ok ? repro::to_f32(pb[(long long)t * W]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < T_len) {
        h = ca[u] * h + cb[u];
        ph[(long long)t * W] = repro::from_f32<T>(h);
      }
    }
  }
  h_last[(long long)row * W + w] = h;
}

template <typename T>
int launch(void* h_out, float* h_last, const void* a, const void* b,
           const float* h0, int batch, int T_len, int W,
           cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, batch);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<T*>(h_out), h_last, static_cast<const T*>(a),
      static_cast<const T*>(b), h0, T_len, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// h_out, a, b: (batch, T_len, W) of `dtype` (repro::kF32 or kBF16);
// h_last, h0: (batch, W) float32.  Launches on `stream`; returns 0 or the
// CUDA error code of the launch.
int repro_rglru_scan(void* h_out, float* h_last, const void* a,
                     const void* b, const float* h0, int batch, int T_len,
                     int W, int dtype, void* stream) {
  if (batch <= 0 || W <= 0) return 0;
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return launch<float>(h_out, h_last, a, b, h0, batch, T_len, W, s);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(h_out, h_last, a, b, h0, batch, T_len, W,
                                 s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
