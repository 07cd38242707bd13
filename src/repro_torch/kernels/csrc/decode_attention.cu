// Decode attention: one new query token per batch row over a KV cache,
// for Hopper.
//
// Replaces repro/kernels/decode_attention.py:decode_attention_pallas
// (:76), the Pallas kernel _decode_kernel (:30).  q: (B, H, hd); caches:
// (B, S, Hkv, hd), bfloat16 or float32; query head h reads KV head
// h / G with G = H / Hkv (the oracle's q.reshape(Hkv, G, hd)).  Cache
// position p is valid where p < length, and p >= length - window when a
// window is given.  Output (B, H, hd) in the input dtype.
//
// What bounds it: memory.  Every valid cache row is read once and used
// by G query heads for 2 * 2 * hd operations each; at G = 2 (qwen3) that
// is 4 operations per byte, at G = 16 (recurrentgemma) 32, both far below
// the card's line of about 295 bfloat16 operations per byte.  So the
// design is about keeping enough bytes in flight on every SM.
//
// bfloat16: flash-decoding in two kernels.
//  * decode_split_kernel: one block of 4 warps per (split of the valid
//    range, KV head, chunk of 16 query heads, batch row).  The valid
//    positions form one range [lo, hi), computed on the device from
//    `length` (a pointer to a device int64 when the caller passed a CUDA
//    tensor, so the host never waits for it); each block takes its own
//    part of it, a multiple of `align` rows (the wrapper's SPLIT_ALIGN,
//    a multiple of kTile), and reads no masked row at all, where the
//    Pallas kernel streams the whole cache against an int8 mask.  K and
//    V tiles of 64 rows stay in bf16 in a ring of 3-4 shared-memory
//    stages filled by 16-byte cp.async.cg (tens of KB in flight per SM
//    while the previous tile is used; rows past the range are
//    zero-filled).  Products run on mma.sync.m16n8k16 in bf16 with the
//    query heads as the 16 rows (zero rows below G): each warp scores 16
//    of the tile's rows (ldmatrix of Q and K) and adds P . V for them
//    (ldmatrix.trans of V), with P taken from the score accumulator's
//    layout as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), so
//    that P . V sees p to about 16 bits where the oracle keeps it in
//    float32 (one bf16 rounding errs by up to 2^-9 |v| where a few rows
//    carry the weight; the second product costs nothing in a kernel
//    bound by memory).  The tensor cores are chosen for every
//    G, qwen3's G = 2 included: one code path, and the 8x padding of
//    G = 2 costs tensor-core time far below the time to read the tile.
//    Each warp keeps its own online softmax (m, l, O in float32, m from
//    -1e30, masked rows get p = 0 exactly, the scale folded into exp2),
//    and the block merges its four warps in shared memory and writes
//    float32 partials (m, l, acc[16][hd]) to scratch; an empty split
//    writes m = -1e30, l = 0, acc = 0.
//  * decode_combine_kernel merges the splits of each (b, KV head) with
//    the log-sum-exp rule and writes the output; l is clamped at 1e-30,
//    so with no valid row at all the output is 0, as the Pallas kernel's
//    clamped l gives.
// The wrapper picks the split count from B * Hkv and S so that the grid
// covers the 132 SMs several times (2 splits at qwen3 decode_32k, 8 at
// the recurrentgemma ring cache).
//
// float32: the one-kernel CUDA-core design of the first port
// (decode_kernel), kept as it is: dispatch by dtype, not a fallback.
// One block per (b, KV head) streams the valid range in float32 tiles.

#include "common.cuh"
#include "hopper.cuh"

namespace {

// --- float32: the CUDA-core kernel ------------------------------------
namespace simt {


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


}  // namespace simt

// --- bfloat16: split over S on the tensor cores ------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;     // cache rows per tile, 16 a warp
constexpr int kRows = 16;              // query heads per block (mma rows)

template <int HD>
struct Cfg {
  static constexpr int kPitch = HD * 2 + 16;  // bytes; ldmatrix without
                                              // bank conflicts
  static constexpr int kStages = HD >= 128 ? 3 : 4;
  static constexpr int kTileBytes = kTile * kPitch;
  static constexpr int kSmem = kRows * kPitch + 2 * kStages * kTileBytes +
                               2 * kWarps * kRows * 4;
  static_assert(kWarps * kRows * HD * 4 <= 2 * kStages * kTileBytes,
                "the warps' merge reuses the ring");
};

// Copies cache rows [p0, p0 + kTile) of one KV head into a stage,
// zero-filling rows at or past `end`.
template <int HD>
__device__ __forceinline__ void load_tile(uint8_t* dst, const bf16* src,
                                          long long row_stride, long long p0,
                                          long long end) {
  constexpr int kChunks = HD / 8;     // 16-byte pieces of a row
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const bool ok = p0 + r < end;
    const bf16* s = ok ? src + (p0 + r) * row_stride + 8 * c : src;
    repro::cp_async_16(dst + r * Cfg<HD>::kPitch + 16 * c, s, ok);
  }
}

// part: (B, Hkv, nsplit, G) maxima (log2 units), then the same of sums,
// then (B, Hkv, nsplit, G, HD) unnormalised accumulators.
template <int HD>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(float* __restrict__ part, const bf16* __restrict__ q,
                    const bf16* __restrict__ kc, const bf16* __restrict__ vc,
                    const long long* __restrict__ length_dev,
                    long long length_host, int B, int S, int Hkv, int G,
                    int align, int window, float scale_log2) {
  using C = Cfg<HD>;
  constexpr int P = C::kPitch;
  constexpr int ST = C::kStages;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* q_s = smem;                                // [16][P]
  uint8_t* k_s = q_s + kRows * P;                     // [ST][kTile][P]
  uint8_t* v_s = k_s + ST * C::kTileBytes;            // [ST][kTile][P]
  float* m_s = reinterpret_cast<float*>(v_s + ST * C::kTileBytes);
  float* l_s = m_s + kWarps * kRows;                  // [kWarps][16] each
  float* red_s = reinterpret_cast<float*>(k_s);       // [kWarps][16][HD]

  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int ngc = (G + kRows - 1) / kRows;
  const int kvh = blockIdx.y / ngc;
  const int g0 = (blockIdx.y % ngc) * kRows;
  const int rows = G - g0 < kRows ? G - g0 : kRows;
  const int b = blockIdx.z;
  const int H = Hkv * G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // this split's part of the valid range, `align`-aligned from lo
  const long long length = length_dev ? *length_dev : length_host;
  const long long hi = length < S ? length : (long long)S;
  long long lo = 0;
  if (window >= 0 && length - window > 0) lo = length - window;
  const long long n = hi > lo ? hi - lo : 0;
  long long chunk = (n + nsplit - 1) / nsplit;
  chunk = (chunk + align - 1) / align * align;
  const long long start = lo + split * chunk;
  const long long end = start + chunk < hi ? start + chunk : hi;
  const int n_tiles = end > start ? (int)((end - start + kTile - 1) / kTile)
                                  : 0;

  // Q rows g0 .. g0 + 15 of this KV head, zero past G
  const bf16* qb = q + ((long long)b * H + (long long)kvh * G + g0) * HD;
  for (int idx = threadIdx.x; idx < kRows * HD / 8; idx += kThreads) {
    const int r = idx / (HD / 8);
    const int c = idx % (HD / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows) v = *reinterpret_cast<const uint4*>(qb + r * HD + 8 * c);
    *reinterpret_cast<uint4*>(q_s + r * P + 16 * c) = v;
  }

  const long long row_stride = (long long)Hkv * HD;
  const bf16* kb = kc + (long long)b * S * row_stride + (long long)kvh * HD;
  const bf16* vb = vc + (long long)b * S * row_stride + (long long)kvh * HD;
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < n_tiles) {
      load_tile<HD>(k_s + s * C::kTileBytes, kb, row_stride,
                    start + s * kTile, end);
      load_tile<HD>(v_s + s * C::kTileBytes, vb, row_stride,
                    start + s * kTile, end);
    }
    repro::cp_async_commit();
  }

  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {repro::kNegInf, repro::kNegInf};  // rows g and g + 8
  float l[2] = {0.f, 0.f};
  const int g = lane >> 2;
  const int t2 = 2 * (lane & 3);
  // ldmatrix row addresses: Q and K (non-transposed), V (transposed)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int k_row = 16 * warp + (lane & 7) + (lane >> 4) * 8;
  const int k_col = ((lane >> 3) & 1) * 8;
  const int v_row = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int v_col = (lane >> 4) * 8;

  for (int it = 0; it < n_tiles; ++it) {
    repro::cp_async_wait<ST - 2>();
    __syncthreads();        // tile `it` is in; tile it - 1 is fully used
    {
      const int nx = it + ST - 1;
      if (nx < n_tiles) {
        const int sx = nx % ST;
        load_tile<HD>(k_s + sx * C::kTileBytes, kb, row_stride,
                      start + (long long)nx * kTile, end);
        load_tile<HD>(v_s + sx * C::kTileBytes, vb, row_stride,
                      start + (long long)nx * kTile, end);
      }
      repro::cp_async_commit();
    }
    const uint8_t* kt = k_s + (it % ST) * C::kTileBytes;
    const uint8_t* vt = v_s + (it % ST) * C::kTileBytes;

    // scores of the warp's 16 rows: s[c][e] is row g + 8 (e >> 1), cache
    // row 16 warp + 8 c + t2 + (e & 1) of the tile
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4], bk[4];
      repro::ldmatrix_x4(a, q_s + a_row * P + (kk * 16 + a_col) * 2);
      repro::ldmatrix_x4(bk, kt + k_row * P + (kk * 16 + k_col) * 2);
      repro::mma_bf16_16816(s[0], a, bk[0], bk[1]);
      repro::mma_bf16_16816(s[1], a, bk[2], bk[3]);
    }
    const long long p_base = start + (long long)it * kTile + 16 * warp + t2;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = p_base + 8 * c + (e & 1) < end;
        s[c][e] = ok ? s[c][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[c][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(~0u, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(~0u, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    uint32_t p_hi[4], p_lo[4];   // P as bf16 hi + lo (see the note)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = exp2f(s[c][2 * r] - m[r]);
        const float p1 = exp2f(s[c][2 * r + 1] - m[r]);
        l[r] += p0 + p1;
        repro::split_bf16(p0, p1, p_hi[2 * c + r], p_lo[2 * c + r]);
      }
#pragma unroll
    for (int nn = 0; nn < HD / 16; ++nn) {
      uint32_t bv[4];
      repro::ldmatrix_x4_trans(bv, vt + v_row * P + (nn * 16 + v_col) * 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* d = o[2 * nn + h];
        d[0] *= alpha[0];
        d[1] *= alpha[0];
        d[2] *= alpha[1];
        d[3] *= alpha[1];
        repro::mma_bf16_16816(o[2 * nn + h], p_hi, bv[2 * h], bv[2 * h + 1]);
        repro::mma_bf16_16816(o[2 * nn + h], p_lo, bv[2 * h], bv[2 * h + 1]);
      }
    }
  }
  repro::cp_async_wait<0>();

  // merge the four warps: maxima and sums first, then the accumulators
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(~0u, l[r], 1);
    l[r] += __shfl_xor_sync(~0u, l[r], 2);
  }
  if ((lane & 3) == 0) {
    m_s[warp * kRows + g] = m[0];
    m_s[warp * kRows + g + 8] = m[1];
    l_s[warp * kRows + g] = l[0];
    l_s[warp * kRows + g + 8] = l[1];
  }
  __syncthreads();          // also: every warp is done with the ring
  float f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    float mm = m_s[row];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, m_s[w * kRows + row]);
    f[r] = exp2f(m[r] - mm);
  }
  float* red = red_s + warp * kRows * HD;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + t2;
    red[g * HD + col] = o[j][0] * f[0];
    red[g * HD + col + 1] = o[j][1] * f[0];
    red[(g + 8) * HD + col] = o[j][2] * f[1];
    red[(g + 8) * HD + col + 1] = o[j][3] * f[1];
  }
  __syncthreads();

  const long long bh = (long long)b * Hkv + kvh;
  const long long n_part = (long long)B * Hkv * nsplit * G;
  const long long pidx = (bh * nsplit + split) * G + g0;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    float mm = m_s[r];
    for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, m_s[w * kRows + r]);
    float ll = 0.f;
    for (int w = 0; w < kWarps; ++w)
      ll += l_s[w * kRows + r] * exp2f(m_s[w * kRows + r] - mm);
    part[pidx + r] = mm;
    part[n_part + pidx + r] = ll;
  }
  float* acc = part + 2 * n_part + pidx * HD;
  for (int idx = threadIdx.x; idx < rows * HD; idx += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red_s[w * kRows * HD + idx];
    acc[idx] = sum;
  }
}

// One block per (b, KV head): the splits' partials merged by log-sum-exp.
template <int HD>
__global__ void __launch_bounds__(256)
decode_combine_kernel(bf16* __restrict__ out, const float* __restrict__ part,
                      int B, int Hkv, int G, int nsplit) {
  const long long bh = blockIdx.x;
  const long long n_part = (long long)B * Hkv * nsplit * G;
  const float* pm = part + bh * nsplit * G;
  const float* pl = pm + n_part;
  const float* pacc = part + 2 * n_part + bh * nsplit * G * HD;
  for (int idx = threadIdx.x; idx < G * HD; idx += blockDim.x) {
    const int g = idx / HD;
    float mm = repro::kNegInf;
    for (int j = 0; j < nsplit; ++j) mm = fmaxf(mm, pm[j * G + g]);
    float ll = 0.f, acc = 0.f;
    for (int j = 0; j < nsplit; ++j) {
      const float w = exp2f(pm[j * G + g] - mm);
      ll += pl[j * G + g] * w;
      acc += pacc[(long long)j * G * HD + idx] * w;
    }
    out[bh * G * HD + idx] = __float2bfloat16(acc / fmaxf(ll, 1e-30f));
  }
}

template <int HD>
int launch(void* out, void* part, const void* q, const void* kc,
           const void* vc, const long long* length_dev,
           long long length_host, int B, int S, int Hkv, int G, int nsplit,
           int align, int window, float scale, cudaStream_t stream) {
  using C = Cfg<HD>;
  auto split = decode_split_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      split, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int ngc = (G + kRows - 1) / kRows;
  split<<<dim3(nsplit, Hkv * ngc, B), kThreads, C::kSmem, stream>>>(
      static_cast<float*>(part), static_cast<const bf16*>(q),
      static_cast<const bf16*>(kc), static_cast<const bf16*>(vc),
      length_dev, length_host, B, S, Hkv, G, align, window,
      scale * 1.4426950408889634f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<HD><<<B * Hkv, 256, 0, stream>>>(
      static_cast<bf16*>(out), static_cast<const float*>(part), B, Hkv, G,
      nsplit);
  return (int)cudaGetLastError();
}

int dispatch(int hd, void* out, void* part, const void* q, const void* kc,
             const void* vc, const long long* length_dev,
             long long length_host, int B, int S, int Hkv, int G, int nsplit,
             int align, int window, float scale, cudaStream_t s) {
  if (align < kTile || align % kTile) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32: return launch<32>(out, part, q, kc, vc, length_dev, length_host,
                               B, S, Hkv, G, nsplit, align, window, scale, s);
    case 64: return launch<64>(out, part, q, kc, vc, length_dev, length_host,
                               B, S, Hkv, G, nsplit, align, window, scale, s);
    case 128: return launch<128>(out, part, q, kc, vc, length_dev,
                                 length_host, B, S, Hkv, G, nsplit, align,
                                 window, scale, s);
    case 256: return launch<256>(out, part, q, kc, vc, length_dev,
                                 length_host, B, S, Hkv, G, nsplit, align,
                                 window, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

extern "C" {

// out, q: (B, Hkv * G, hd); k_cache, v_cache: (B, S, Hkv, hd), all of
// `dtype`; hd in {32, 64, 128, 256}, G <= 64.  The valid length is
// *length_dev when length_dev is not null, else length_host; window < 0
// means none.  bfloat16 splits the valid range over `nsplit` blocks per
// (b, KV head), each a multiple of `align` rows (a multiple of the
// kernel's 64-row tile), and needs `part`, float32 scratch of
// B * Hkv * nsplit * G * (hd + 2) elements; float32 ignores the three.
// Launches on `stream`; returns 0 or a CUDA error code.
int repro_decode_attention(void* out, void* part, const void* q,
                           const void* k_cache, const void* v_cache,
                           const long long* length_dev,
                           long long length_host, int B, int S, int Hkv,
                           int G, int hd, int nsplit, int align,
                           int window, float scale, int dtype,
                           void* stream) {
  if (B <= 0 || Hkv <= 0 || G <= 0) return 0;
  if (B > 65535 || G > simt::kMaxGroup || nsplit < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32)
    return simt::dispatch<float>(hd, out, q, k_cache, v_cache, length_dev,
                                 length_host, B, S, Hkv, G, window, scale,
                                 s);
  if (dtype == repro::kBF16)
    return tc::dispatch(hd, out, part, q, k_cache, v_cache, length_dev,
                        length_host, B, S, Hkv, G, nsplit, align, window,
                        scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
