// Causal GQA flash attention with an optional sliding window, for Hopper.
//
// Replaces repro/kernels/flash_attention.py:flash_attention_pallas
// (:82), the Pallas kernel _flash_kernel (:35).  q: (B, H, S, hd); k, v:
// (B, Hkv, S, hd), float32 or bfloat16; query head h reads KV head
// h / (H / Hkv), and KV is never replicated.  Key position kp is visible
// from query position qp where kp < S, kp <= qp (causal) and
// kp > qp - window (with a window).  Output (B, H, S, hd) in q's dtype.
//
// What bounds it: operations.  At S = 32,768 every K and V tile is used
// by 64 query rows at 4 * hd operations per (query, key) pair, far above
// the card's operations-per-byte line; the bound is the causal (and
// windowed) pair count over the card's bfloat16 tensor-core rate.
//
// Design.  One block per (b, h, tile of kBQ query rows) walks the KV
// tiles its rows can see, and only those: from the window's lower edge
// to the causal diagonal.  The online softmax of the Pallas kernel
// carries over: running max m, sum l and the kBQ x hd accumulator stay
// in float32 registers; a masked entry gets weight exactly 0 (the Pallas
// kernel's explicit p = 0, :66-68), so a tile that the window masks
// whole adds nothing; l is clamped at 1e-30 (:78).  Products run on the
// CUDA cores in float32: the block's 16 x 16 threads each own 4 query
// rows x 2 keys of the score tile and 4 rows x hd/16 columns of the
// accumulator; Q and K sit in shared memory with a pitch of hd + 4
// floats, so 16-byte loads are free of bank conflicts.  Rows of a score
// tile are reduced across the 16 threads that share them with warp
// shuffles.  Causal blocks start from the last query tile, the longest.
//
// Later work: the products belong on the tensor cores (mma.sync, then
// wgmma with TMA-fed tiles); this kernel is the right-and-simple first
// version and sits far above its bound.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per block: 16 row threads x 4
constexpr int kBK = 32;  // keys per tile: 16 column threads x 2

__host__ __device__ constexpr int pitch(int HD) { return HD + 4; }

__host__ __device__ constexpr int smem_floats(int HD) {
  return kBQ * pitch(HD) + kBK * pitch(HD) + kBK * HD + kBQ * (kBK + 1);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

template <int N>
__device__ __forceinline__ void load_vec(float (&dst)[N], const float* src) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x; dst[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(T* __restrict__ out, const T* __restrict__ q,
             const T* __restrict__ k, const T* __restrict__ v, int S, int H,
             int Hkv, int causal, int window, float scale) {
  constexpr int P = pitch(HD);
  constexpr int kCols = HD / 16;              // accumulator columns/thread
  constexpr int kVec = kCols < 4 ? kCols : 4;  // as float4 or float2 runs
  constexpr int kRuns = kCols / kVec;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                  // [kBQ][P]
  float* k_s = q_s + kBQ * P;         // [kBK][P]
  float* v_s = k_s + kBK * P;         // [kBK][HD]
  float* p_s = v_s + kBK * HD;        // [kBQ][kBK + 1]

  const int nq = (S + kBQ - 1) / kBQ;
  const int qt = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // key column / accumulator column group
  const int ty = tid >> 4;   // query row group: rows ty + 16 i
  const int q0 = qt * kBQ;

  const long long q_off = (((long long)b * H + h) * S + q0) * HD;
  const long long kv_off = ((long long)b * Hkv + hk) * S * HD;
  const int q_valid = S - q0 < kBQ ? S - q0 : kBQ;
  repro::load_rows<T, HD>(q_s, P, q + q_off, HD, kBQ, q_valid);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = repro::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  int k_lo = 0;
  if (window >= 0 && q0 - window + 1 > 0) k_lo = q0 - window + 1;
  int k_hi = S;
  if (causal && q0 + kBQ < S) k_hi = q0 + kBQ;

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    const int k_valid = S - k0 < kBK ? S - k0 : kBK;
    __syncthreads();  // the previous tile is fully used (and q_s written)
    repro::load_rows<T, HD>(k_s, P, k + kv_off + (long long)k0 * HD, HD,
                            kBK, k_valid);
    repro::load_rows<T, HD>(v_s, HD, v + kv_off + (long long)k0 * HD, HD,
                            kBK, k_valid);
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float qv[4][4], kv[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_vec(qv[i], q_s + (ty + 16 * i) * P + d);
#pragma unroll
      for (int j = 0; j < 2; ++j) load_vec(kv[j], k_s + (tx + 16 * j) * P + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j] += qv[i][e] * kv[j][e];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      bool ok[2];
      float x[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < S && (!causal || kp <= qp) &&
                (window < 0 || kp > qp - window);
        x[j] = ok[j] ? s[i][j] * scale : repro::kNegInf;
      }
      const float m_new = fmaxf(m[i], half_warp_max(fmaxf(x[0], x[1])));
      const float p0 = ok[0] ? expf(x[0] - m_new) : 0.f;
      const float p1 = ok[1] ? expf(x[1] - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + half_warp_sum(p0 + p1);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
      p_s[(ty + 16 * i) * (kBK + 1) + tx] = p0;
      p_s[(ty + 16 * i) * (kBK + 1) + tx + 16] = p1;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int r = 0; r < kRuns; ++r) {
        float vv[kVec];
        load_vec(vv, v_s + c * HD + r * 16 * kVec + tx * kVec);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            acc[i][r * kVec + e] += pv[i] * vv[e];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    if (row < q_valid) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      T* o = out + q_off + (long long)row * HD;
#pragma unroll
      for (int r = 0; r < kRuns; ++r)
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          o[r * 16 * kVec + tx * kVec + e] =
              repro::from_f32<T>(acc[i][r * kVec + e] * inv);
    }
  }
}

template <typename T, int HD>
int launch(void* out, const void* q, const void* k, const void* v, int B,
           int H, int Hkv, int S, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(HD);
  auto kernel = flash_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), S, H, Hkv, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, void* out, const void* q, const void* k, const void* v,
             int B, int H, int Hkv, int S, int causal, int window,
             float scale, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(out, q, k, v, B, H, Hkv, S, causal, window,
                                  scale, s);
    case 64: return launch<T, 64>(out, q, k, v, B, H, Hkv, S, causal, window,
                                  scale, s);
    case 128: return launch<T, 128>(out, q, k, v, B, H, Hkv, S, causal,
                                    window, scale, s);
    case 256: return launch<T, 256>(out, q, k, v, B, H, Hkv, S, causal,
                                    window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out, q: (B, H, S, hd); k, v: (B, Hkv, S, hd), all of `dtype`, hd in
// {32, 64, 128, 256}, H a multiple of Hkv; window < 0 means none.
// Launches on `stream`; returns 0 or a CUDA error code.
int repro_flash_attention(void* out, const void* q, const void* k,
                          const void* v, int B, int H, int Hkv, int S,
                          int hd, int causal, int window, float scale,
                          int dtype, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || H % Hkv || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return dispatch<float>(hd, out, q, k, v, B, H, Hkv, S, causal, window,
                           scale, s);
  if (dtype == repro::kBF16)
    return dispatch<__nv_bfloat16>(hd, out, q, k, v, B, H, Hkv, S, causal,
                                   window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
