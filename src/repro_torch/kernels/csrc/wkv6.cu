// RWKV-6 WKV recurrence, for Hopper.
//
// Replaces repro/kernels/wkv6.py:wkv6_pallas (:77), the Pallas kernel
// _wkv_kernel (:25).  r, k, v, logw: (B, T, H, hd) in float32 or
// bfloat16; u: (H, hd); s0: (B, H, hd, hd) float32, indexed [key, value].
// For every step t, with w_t = exp(logw_t),
//
//     y_t = r_t . S + (sum_i r_t[i] u[i] k_t[i]) v_t
//     S   = w_t (rows) * S + k_t v_t^T
//
// as ref.wkv6_reference (:55-70) and _wkv_kernel's state update
// (:162-166).  Writes y (B, T, H, hd) in the input dtype and the final
// state (B, H, hd, hd) in float32.
//
// What bounds it: operations on the CUDA cores.  Each step of a head
// does 5 hd^2 float32 operations on the hd x hd state (the matrix-vector
// product, the decay, the rank-1 update) against 8 hd bytes of bfloat16
// input and output, and the state is float32 throughout, so the bound is
// the float32 rate outside the tensor cores.
//
// Design.  The Pallas kernel walks T in chunks with an intra-chunk
// C x C x hd decay tensor, so that a TPU core gets matrix work; every
// exponent there is kept at or below 0.  Here one block per (b, h) runs
// the recurrence step by step, which is the oracle itself: exp(logw) <= 1
// multiplies a bounded state, so a long strong decay (logw = -3) only
// shrinks it.  The block has hd threads; thread j owns value column j of
// the state, all hd keys of it in registers, so y_t[j] needs no
// reduction across threads.  Each chunk of kChunk steps of r, k, w = exp
// (logw) and v is staged in shared memory, where every thread reads the
// same r, k, w row (a broadcast), and the bonus sum of each step is
// computed once per chunk.
//
// Occupancy: B * H blocks of hd threads (8 * 32 = 256 blocks of 64 at
// rwkv6-1.6b's prefill shape), about two per SM; each SM then runs 4
// warps, one per scheduler, and the step's dependent chain is hidden
// only by the 4 partial sums of y.  A split of the value columns over
// more blocks, or a chunked tensor-core form, is later work.

#include "common.cuh"

namespace {

constexpr int kChunk = 32;

template <int HD>
__host__ __device__ constexpr int smem_floats() {
  return 4 * kChunk * HD + kChunk + HD;
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkv6_kernel(T* __restrict__ y, float* __restrict__ s_out,
            const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ logw,
            const T* __restrict__ u, const float* __restrict__ s0, int T_len,
            int H) {
  extern __shared__ __align__(16) float smem[];
  float* r_s = smem;                  // [kChunk][HD]
  float* k_s = r_s + kChunk * HD;     // [kChunk][HD]
  float* w_s = k_s + kChunk * HD;     // [kChunk][HD]
  float* v_s = w_s + kChunk * HD;     // [kChunk][HD]
  float* bonus_s = v_s + kChunk * HD; // [kChunk]
  float* u_s = bonus_s + kChunk;      // [HD]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int j = threadIdx.x;
  const long long state_off = ((long long)b * H + h) * HD * HD + j;

  float s[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) s[i] = s0[state_off + (long long)i * HD];
  u_s[j] = repro::to_f32(u[(long long)h * HD + j]);

  const long long step = (long long)H * HD;   // between t and t + 1
  const long long base = ((long long)b * T_len * H + h) * HD + j;

  for (int t0 = 0; t0 < T_len; t0 += kChunk) {
    const int n = T_len - t0 < kChunk ? T_len - t0 : kChunk;
    __syncthreads();  // the previous chunk is fully used
#pragma unroll 8
    for (int c = 0; c < n; ++c) {
      const long long at = base + (long long)(t0 + c) * step;
      r_s[c * HD + j] = repro::to_f32(r[at]);
      k_s[c * HD + j] = repro::to_f32(k[at]);
      v_s[c * HD + j] = repro::to_f32(v[at]);
      w_s[c * HD + j] = expf(repro::to_f32(logw[at]));
    }
    __syncthreads();
    for (int c = j; c < n; c += HD) {
      float bonus = 0.f;
#pragma unroll 8
      for (int i = 0; i < HD; ++i)
        bonus += r_s[c * HD + i] * u_s[i] * k_s[c * HD + i];
      bonus_s[c] = bonus;
    }
    __syncthreads();

    for (int c = 0; c < n; ++c) {
      const float vj = v_s[c * HD + j];
      const float4* r4 = reinterpret_cast<const float4*>(r_s + c * HD);
      const float4* k4 = reinterpret_cast<const float4*>(k_s + c * HD);
      const float4* w4 = reinterpret_cast<const float4*>(w_s + c * HD);
      float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
      for (int i = 0; i < HD / 4; ++i) {
        const float4 rr = r4[i], kk = k4[i], ww = w4[i];
        y0 += rr.x * s[4 * i];
        y1 += rr.y * s[4 * i + 1];
        y2 += rr.z * s[4 * i + 2];
        y3 += rr.w * s[4 * i + 3];
        s[4 * i] = ww.x * s[4 * i] + kk.x * vj;
        s[4 * i + 1] = ww.y * s[4 * i + 1] + kk.y * vj;
        s[4 * i + 2] = ww.z * s[4 * i + 2] + kk.z * vj;
        s[4 * i + 3] = ww.w * s[4 * i + 3] + kk.w * vj;
      }
      const float out = (y0 + y1) + (y2 + y3) + bonus_s[c] * vj;
      y[base + (long long)(t0 + c) * step] = repro::from_f32<T>(out);
    }
  }

#pragma unroll
  for (int i = 0; i < HD; ++i) s_out[state_off + (long long)i * HD] = s[i];
}

template <typename T, int HD>
int launch(void* y, float* s_out, const void* r, const void* k,
           const void* v, const void* logw, const void* u, const float* s0,
           int B, int T_len, int H, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<HD>();
  auto kernel = wkv6_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(H, B), HD, smem, stream>>>(
      static_cast<T*>(y), s_out, static_cast<const T*>(r),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(logw), static_cast<const T*>(u), s0, T_len, H);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, void* y, float* s_out, const void* r, const void* k,
             const void* v, const void* logw, const void* u, const float* s0,
             int B, int T_len, int H, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(y, s_out, r, k, v, logw, u, s0, B, T_len,
                                  H, s);
    case 32: return launch<T, 32>(y, s_out, r, k, v, logw, u, s0, B, T_len,
                                  H, s);
    case 64: return launch<T, 64>(y, s_out, r, k, v, logw, u, s0, B, T_len,
                                  H, s);
    case 128: return launch<T, 128>(y, s_out, r, k, v, logw, u, s0, B,
                                    T_len, H, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// y, r, k, v, logw: (B, T_len, H, hd) and u: (H, hd), all of `dtype`;
// s0, s_out: (B, H, hd, hd) float32; hd in {16, 32, 64, 128}.  Launches
// on `stream`; returns 0 or a CUDA error code.
int repro_wkv6(void* y, float* s_out, const void* r, const void* k,
               const void* v, const void* logw, const void* u,
               const float* s0, int B, int T_len, int H, int hd, int dtype,
               void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return dispatch<float>(hd, y, s_out, r, k, v, logw, u, s0, B, T_len, H,
                           s);
  if (dtype == repro::kBF16)
    return dispatch<__nv_bfloat16>(hd, y, s_out, r, k, v, logw, u, s0, B,
                                   T_len, H, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
