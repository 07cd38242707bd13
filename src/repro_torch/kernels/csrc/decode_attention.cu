// Decode attention: one new query token per batch row over a KV cache,
// for Hopper.
//
// Replaces repro/kernels/decode_attention.py:decode_attention_pallas
// (:76), the Pallas kernel _decode_kernel (:30).  q: (B, H, hd); caches:
// (B, S, Hkv, hd), float32 or bfloat16; query head h reads KV head
// h / G with G = H / Hkv (the oracle's q.reshape(Hkv, G, hd)).  Cache
// position p is valid where p < length, and p >= length - window when a
// window is given.  Output (B, H, hd) in the input dtype.
//
// What bounds it: memory.  Every valid cache row is read once and used
// by G query heads for 2 * 2 * hd operations each; at G = 2 (qwen3) that
// is 4 operations per byte, at G = 16 (recurrentgemma) 32, both far below
// the card's line of about 295 bfloat16 operations per byte.
//
// Design.  One block per (b, KV head) streams that head's cache rows
// once for all G query heads, so KV is never read twice.  The valid
// positions form one range [lo, hi), computed on the device from
// `length` (a pointer to a device int64 when the caller passed a CUDA
// tensor, so the host never waits for it); the block walks only that
// range in tiles of kTile rows and reads no masked row at all, where the
// Pallas kernel streams the whole cache against an int8 mask.  Per tile:
// 16-byte loads of K and V into float32 shared memory, G x kTile scores
// (each thread owns one position and up to 16 heads), an online softmax
// per head in float32 (one warp per head: running max m, sum l, rescale
// alpha), and the G x hd accumulator spread over the block's threads.
// Positions of a ragged last tile get weight exactly 0.  With no valid
// position the output is 0, as the Pallas kernel's clamped l gives.
//
// Later work: a tile is loaded, then used, with no overlap inside a
// block (other blocks on the SM hide it); cp.async double buffering and
// a split over S for small B * Hkv would keep more bytes in flight.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;               // cache positions per tile
constexpr int kMaxGroup = 64;
constexpr int kWarps = kThreads / 32;

__host__ __device__ constexpr int smem_floats(int G, int HD) {
  return G * HD + kTile * (HD + 1) + kTile * HD + G * kTile + 3 * G;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// GMAX bounds G at compile time, so that each thread's score and
// accumulator slots are registers with no dead iterations: a thread
// scores kScoreSlots heads and accumulates kAccSlots (head, dim) cells.
template <typename T, int HD, int GMAX>
__global__ void __launch_bounds__(kThreads)
decode_kernel(T* __restrict__ out, const T* __restrict__ q,
              const T* __restrict__ kc, const T* __restrict__ vc,
              const long long* __restrict__ length_dev,
              long long length_host, int S, int Hkv, int G, int window,
              float scale) {
  constexpr int kHeadStep = kThreads / kTile;
  constexpr int kScoreSlots = (GMAX + kHeadStep - 1) / kHeadStep;
  constexpr int kAccStep = kThreads / HD;
  constexpr int kAccSlots = (GMAX + kAccStep - 1) / kAccStep;
  extern __shared__ float smem[];
  float* q_s = smem;                      // [G][HD]
  float* k_s = q_s + G * HD;              // [kTile][HD + 1]
  float* v_s = k_s + kTile * (HD + 1);    // [kTile][HD]
  float* p_s = v_s + kTile * HD;          // [G][kTile]
  float* m_s = p_s + G * kTile;           // [G]
  float* l_s = m_s + G;                   // [G]
  float* alpha_s = l_s + G;               // [G]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int H = Hkv * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const long long length = length_dev ? *length_dev : length_host;
  const long long hi = length < S ? length : (long long)S;
  long long lo = 0;
  if (window >= 0 && length - window > 0) lo = length - window;

  const long long q_off = ((long long)b * H + (long long)kvh * G) * HD;
  repro::load_rows<T, HD>(q_s, HD, q + q_off, HD, G, G);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = repro::kNegInf;
    l_s[g] = 0.f;
  }

  float acc[kAccSlots];
#pragma unroll
  for (int j = 0; j < kAccSlots; ++j) acc[j] = 0.f;

  const long long row_stride = (long long)Hkv * HD;
  const long long kv_off = (long long)b * S * row_stride + (long long)kvh * HD;
  const int s_mine = tid % kTile;         // the position this thread scores
  const int g_first = tid / kTile;        // its heads: g_first + 4 j
  const int d_acc = tid % HD;             // its accumulator cells:
  const int g_acc = tid / HD;             // (g_acc + kAccStep j, d_acc)

  for (long long p0 = lo; p0 < hi; p0 += kTile) {
    const int nvalid = (int)(hi - p0 < kTile ? hi - p0 : kTile);
    __syncthreads();                      // previous tile fully used
    repro::load_rows<T, HD>(k_s, HD + 1, kc + kv_off + p0 * row_stride,
                            row_stride, kTile, nvalid);
    repro::load_rows<T, HD>(v_s, HD, vc + kv_off + p0 * row_stride,
                            row_stride, kTile, nvalid);
    __syncthreads();

    // scores: logits[g][s] = (q[g] . k[s]) * scale
    float sc[kScoreSlots];
#pragma unroll
    for (int j = 0; j < kScoreSlots; ++j) sc[j] = 0.f;
    const float* krow = k_s + s_mine * (HD + 1);
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float kv = krow[d];
#pragma unroll
      for (int j = 0; j < kScoreSlots; ++j) {
        const int g = g_first + kHeadStep * j;
        if (g < G) sc[j] += q_s[g * HD + d] * kv;
      }
    }
#pragma unroll
    for (int j = 0; j < kScoreSlots; ++j) {
      const int g = g_first + kHeadStep * j;
      if (g < G)
        p_s[g * kTile + s_mine] =
            s_mine < nvalid ? sc[j] * scale : repro::kNegInf;
    }
    __syncthreads();

    // online softmax, one warp per head
    for (int g = warp; g < G; g += kWarps) {
      const float x0 = p_s[g * kTile + lane];
      const float x1 = p_s[g * kTile + lane + 32];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      const float e0 = lane < nvalid ? expf(x0 - m_new) : 0.f;
      const float e1 = lane + 32 < nvalid ? expf(x1 - m_new) : 0.f;
      p_s[g * kTile + lane] = e0;
      p_s[g * kTile + lane + 32] = e1;
      const float sum = warp_sum(e0 + e1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g][d] = acc * alpha[g] + sum_s p[g][s] * v[s][d]
#pragma unroll
    for (int j = 0; j < kAccSlots; ++j) {
      const int g = g_acc + kAccStep * j;
      if (g < G) acc[j] *= alpha_s[g];
    }
#pragma unroll 8
    for (int s = 0; s < kTile; ++s) {
      const float v = v_s[s * HD + d_acc];
#pragma unroll
      for (int j = 0; j < kAccSlots; ++j) {
        const int g = g_acc + kAccStep * j;
        if (g < G) acc[j] += p_s[g * kTile + s] * v;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < kAccSlots; ++j) {
    const int g = g_acc + kAccStep * j;
    if (g < G) {
      const float l = fmaxf(l_s[g], 1e-30f);
      out[q_off + g * HD + d_acc] = repro::from_f32<T>(acc[j] / l);
    }
  }
}

template <typename T, int HD, int GMAX>
int launch(void* out, const void* q, const void* kc, const void* vc,
           const long long* length_dev, long long length_host, int B, int S,
           int Hkv, int G, int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(G, HD);
  auto kernel = decode_kernel<T, HD, GMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q),
      static_cast<const T*>(kc), static_cast<const T*>(vc), length_dev,
      length_host, S, Hkv, G, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int by_group(void* out, const void* q, const void* kc, const void* vc,
             const long long* length_dev, long long length_host, int B,
             int S, int Hkv, int G, int window, float scale,
             cudaStream_t s) {
  if (G <= 2)
    return launch<T, HD, 2>(out, q, kc, vc, length_dev, length_host, B, S,
                            Hkv, G, window, scale, s);
  if (G <= 8)
    return launch<T, HD, 8>(out, q, kc, vc, length_dev, length_host, B, S,
                            Hkv, G, window, scale, s);
  if (G <= 16)
    return launch<T, HD, 16>(out, q, kc, vc, length_dev, length_host, B, S,
                             Hkv, G, window, scale, s);
  return launch<T, HD, kMaxGroup>(out, q, kc, vc, length_dev, length_host,
                                  B, S, Hkv, G, window, scale, s);
}

template <typename T>
int dispatch(int hd, void* out, const void* q, const void* kc,
             const void* vc, const long long* length_dev,
             long long length_host, int B, int S, int Hkv, int G, int window,
             float scale, cudaStream_t s) {
  switch (hd) {
    case 32: return by_group<T, 32>(out, q, kc, vc, length_dev, length_host,
                                  B, S, Hkv, G, window, scale, s);
    case 64: return by_group<T, 64>(out, q, kc, vc, length_dev, length_host,
                                  B, S, Hkv, G, window, scale, s);
    case 128: return by_group<T, 128>(out, q, kc, vc, length_dev, length_host,
                                    B, S, Hkv, G, window, scale, s);
    case 256: return by_group<T, 256>(out, q, kc, vc, length_dev, length_host,
                                    B, S, Hkv, G, window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out, q: (B, Hkv * G, hd); k_cache, v_cache: (B, S, Hkv, hd), all of
// `dtype`; hd in {32, 64, 128, 256}, G <= 64.  The valid
// length is *length_dev when length_dev is not null, else length_host;
// window < 0 means none.  Launches on `stream`; returns 0 or a CUDA
// error code.
int repro_decode_attention(void* out, const void* q, const void* k_cache,
                           const void* v_cache, const long long* length_dev,
                           long long length_host, int B, int S, int Hkv,
                           int G, int hd, int window, float scale, int dtype,
                           void* stream) {
  if (B <= 0 || Hkv <= 0 || G <= 0) return 0;
  if (B > 65535 || G > kMaxGroup) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return dispatch<float>(hd, out, q, k_cache, v_cache, length_dev,
                           length_host, B, S, Hkv, G, window, scale, s);
  if (dtype == repro::kBF16)
    return dispatch<__nv_bfloat16>(hd, out, q, k_cache, v_cache, length_dev,
                                   length_host, B, S, Hkv, G, window, scale,
                                   s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
