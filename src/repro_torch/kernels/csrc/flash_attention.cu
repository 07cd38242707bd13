// Causal GQA flash attention with an optional sliding window, for Hopper.
//
// Replaces repro/kernels/flash_attention.py:flash_attention_pallas
// (:82), the Pallas kernel _flash_kernel (:35).  q: (B, H, S, hd); k, v:
// (B, Hkv, S, hd), bfloat16 or float32; query head h reads KV head
// h / (H / Hkv), and KV is never replicated.  Key position kp is visible
// from query position qp where kp < S, kp <= qp (causal) and
// kp > qp - window (with a window).  Output (B, H, S, hd) in q's dtype.
//
// What bounds it: operations.  At S = 32,768 every K and V tile is used
// by 128 query rows at 4 * hd operations per (query, key) pair, far above
// the card's operations-per-byte line; the bound is the causal (and
// windowed) pair count over the card's bfloat16 tensor-core rate (the lo
// term of P below is work on top of it).
//
// bfloat16: a warp-specialised tensor-core kernel (flash_tc_kernel).
// One CTA per (b, h, tile of 128 query rows) walks the KV tiles its rows
// can see, and only those: from the window's lower edge to the causal
// diagonal; causal CTAs are issued longest query tile first, every
// head's before any shorter one.  Three warpgroups:
//  * a producer whose one thread loads the Q tile once and fills a ring
//    of K and V stages by TMA (cp.async.bulk.tensor, 128-byte swizzle;
//    64-byte at hd = 32), signalled on mbarriers: a "full" barrier per K
//    and per V slot, and an "empty" one per K and per V slot that all
//    256 consumer threads arrive on, so a K slot is refilled as soon as
//    S has been computed from it, before P . V is done with its V;
//  * two consumers, each owning 64 query rows.  S = Q . K^T is a wgmma
//    with both operands in shared memory; O += P . V is a wgmma with P
//    from registers, converted from S's accumulator layout, and V read
//    MN-major (transposed) through its descriptor.  Tile i's S is issued
//    together with tile i - 1's P . V, and tile i's softmax runs while
//    that P . V is on the tensor cores.
// Tiles are 64 keys (32 at hd = 256) in 3 stages (4 at hd = 256): S, P
// and O of two tiles in flight must fit the 168 registers a thread of a
// 384-thread block has.  setmaxnreg moves registers from the producer
// (40) to the consumers (232) at run time, but ptxas 12.9 allocates the
// consumer code within the 168 of the launch all the same (the same
// spills with and without it), so the tiles are sized for 168.
// The online softmax is the Pallas kernel's: m, l and O stay in float32,
// m starts at -1e30, a masked entry gets p = 0 exactly (its logit is
// -inf, and 2^-inf = 0), l is clamped at 1e-30; the scale is folded into
// exp2 (logits times scale * log2 e).  The mask is evaluated only on
// tiles that cross the diagonal, the window edge or the end of the
// sequence.  Numerics: P goes into P . V as two bf16 terms, hi = bf16(p)
// and lo = bf16(p - hi), so P . V sees p to about 16 bits (the Pallas
// kernel and the plain version keep P in float32).  P rounded once to
// bf16, as most tensor-core flash kernels do, errs by up to 2^-9 |v| on
// rows that see only a few keys (the first rows of a causal sequence):
// at qwen3-0.6b prefill_32k that was up to 0.0156, past the tolerance of
// 2e-2 x the output's RMS (about 5.5e-4).  The lo term costs a second
// P . V product: half as much tensor-core work again.
//
// float32: the CUDA-core kernel of the first port (flash_kernel), kept
// as it is.  It is dispatch by dtype, not a fallback: a float32 check at
// 1e-4 cannot go through bf16 tensor cores.  One block per (b, h, tile
// of 64 query rows), float32 FMAs, Q and K in shared memory at a pitch
// of hd + 4 floats.

#include "common.cuh"
#include "hopper.cuh"

namespace {

// --- float32: the CUDA-core kernel ------------------------------------
namespace simt {

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


}  // namespace simt

// --- bfloat16: the tensor-core kernel ----------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;           // query rows per CTA, 64 per consumer
constexpr int kThreads = 384;      // producer + two consumer warpgroups
constexpr int kConsumers = 256;    // arrivals that free a slot

template <int HD>
struct Cfg {
  // keys per tile: S, P (hi and lo) and O of a tile in flight fit the
  // 168 registers a thread of a 384-thread block has
  static constexpr int kBN = HD == 256 ? 32 : 64;
  static constexpr int kStages = HD == 256 ? 4 : 3;
  static constexpr int kRowBytes = HD >= 64 ? 128 : 64;   // swizzle span
  static constexpr int kSwizzle = HD >= 64 ? 1 : 2;       // descriptor code
  static constexpr int kCols = kRowBytes / 2;   // bf16 per swizzled row
  static constexpr int kBlocks = HD / kCols;    // column blocks of a tile
  static constexpr int kQBytes = kBM * HD * 2;
  static constexpr int kKVBytes = kBN * HD * 2;
  // 1024 B of slack to align the tiles (the swizzle reads address bits)
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 4 * kStages);
  static_assert(kSmem <= 232448, "past the 227 KB a block can have");
};

// S = Q . K^T of one warpgroup's 64 rows against a K tile, issued and
// committed (not waited for).
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[Cfg<HD>::kBN / 2],
                                         const uint8_t* q_wg,
                                         const uint8_t* kt) {
  using C = Cfg<HD>;
  constexpr int RB = C::kRowBytes;
  repro::fence_regs(s);
  repro::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 / C::kCols;
    const int off = (kk * 16 % C::kCols) * 2;
    repro::wgmma_ss<C::kBN>(
        s, repro::gmma_desc(q_wg + c * kBM * RB + off, 16, 8 * RB,
                            C::kSwizzle),
        repro::gmma_desc(kt + c * C::kBN * RB + off, 16, 8 * RB,
                         C::kSwizzle),
        kk > 0);
  }
  repro::wgmma_commit();
}

// O += P . V over a V tile, P from registers as its bf16 high part and
// the bf16 rounding of what is left (P = hi + lo to about 16 bits),
// issued and committed.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         uint32_t (&hi)[Cfg<HD>::kBN / 4],
                                         uint32_t (&lo)[Cfg<HD>::kBN / 4],
                                         const uint8_t* vt) {
  using C = Cfg<HD>;
  constexpr int RB = C::kRowBytes;
  repro::fence_regs(o);
  repro::fence_regs(hi);
  repro::fence_regs(lo);
  repro::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::kBN / 16; ++kk) {
    const uint64_t dv = repro::gmma_desc(vt + kk * 16 * RB, C::kBN * RB,
                                         8 * RB, C::kSwizzle);
    const uint32_t a[4] = {hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2],
                           hi[4 * kk + 3]};
    repro::wgmma_rs<HD>(o, a, dv);
    const uint32_t b[4] = {lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2],
                           lo[4 * kk + 3]};
    repro::wgmma_rs<HD>(o, b, dv);
  }
  repro::wgmma_commit();
}

// Online softmax of one tile's S, in place (rows row_lo and row_lo + 8;
// s[4j + e] is key k0 + 8j + col0 + (e & 1) of row e >> 1): masks when
// `masked`, updates m and l, gives the rescale alpha of each row, and
// leaves p = 2^(x - m) in s.
template <int BN>
__device__ __forceinline__ void softmax_tile(
    float (&s)[BN / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    bool masked, int k0, int row_lo, int col0, int S, int causal,
    int window, float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * scale_log2;
      if (masked) {
        const int kp = k0 + 8 * j + col0 + (e & 1);
        const int qp = row_lo + 8 * (e >> 1);
        const bool ok = kp < S && (!causal || kp <= qp) &&
                        (window <= 0 || kp > qp - window);
        x = ok ? x : -INFINITY;
      }
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(~0u, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(~0u, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = repro::exp2_approx(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = repro::exp2_approx(s[4 * j + e] - m[e >> 1]);
      l[e >> 1] += s[4 * j + e];
    }
}

// p (S's accumulator layout) as bf16 hi and lo parts in the A-operand
// layout of O += P . V: registers 4c .. 4c + 3 are keys 16c .. 16c + 15.
template <int BN>
__device__ __forceinline__ void split_p(const float (&s)[BN / 2],
                                        uint32_t (&hi)[BN / 4],
                                        uint32_t (&lo)[BN / 4]) {
#pragma unroll
  for (int j = 0; j < BN / 4; ++j)
    repro::split_bf16(s[2 * j], s[2 * j + 1], hi[j], lo[j]);
}

// Tiles in shared memory are kBlocks column blocks, each [rows][kCols]
// bf16 rows of kRowBytes bytes, swizzled by TMA.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                bf16* __restrict__ out, int S, int H, int Hkv, int causal,
                int window, float scale_log2) {
  using C = Cfg<HD>;
  constexpr int BN = C::kBN;
  constexpr int ST = C::kStages;
  constexpr int RB = C::kRowBytes;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base =
      smem_raw + ((1024 - (repro::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = base;
  uint8_t* k_s = base + C::kQBytes;                  // [ST][kKVBytes]
  uint8_t* v_s = k_s + ST * C::kKVBytes;             // [ST][kKVBytes]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + ST * C::kKVBytes);
  uint64_t* k_full = q_full + 1;                     // [ST] each
  uint64_t* v_full = k_full + ST;
  uint64_t* k_empty = v_full + ST;
  uint64_t* v_empty = k_empty + ST;

  const int nq = (S + kBM - 1) / kBM;
  const int qt = causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int bh = blockIdx.x;                 // b * H + h
  const int b = bh / H;
  const int kv_row = b * Hkv + (bh - b * H) / (H / Hkv);
  const int q0 = qt * kBM;
  int k_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) k_lo = q0 - window + 1;
  const int kt0 = k_lo / BN;
  const int k_hi = causal && q0 + kBM < S ? q0 + kBM : S;
  const int n_tiles = (k_hi + BN - 1) / BN - kt0;

  if (threadIdx.x == 0) {
    repro::mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      repro::mbar_init(&k_full[s], 1);
      repro::mbar_init(&v_full[s], 1);
      repro::mbar_init(&k_empty[s], kConsumers);
      repro::mbar_init(&v_empty[s], kConsumers);
    }
    repro::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every TMA load; a K (V) slot is
    // refilled as soon as both consumers are done with the K (V) tile
    // in it.  Both setmaxnreg calls are kept for the register experiment
    // of the note at the top; with ptxas 12.9 they change nothing.
    repro::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      repro::mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kBlocks; ++c)
        repro::tma_load_3d(q_s + c * kBM * RB, &tm_q, q_full, c * C::kCols,
                           q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % ST;
        const uint32_t ph = ((i / ST) - 1) & 1;
        const int k0 = (kt0 + i) * BN;
        uint8_t* kd = k_s + st * C::kKVBytes;
        uint8_t* vd = v_s + st * C::kKVBytes;
        if (i >= ST) repro::mbar_wait(&k_empty[st], ph);
        repro::mbar_expect_tx(&k_full[st], C::kKVBytes);
#pragma unroll
        for (int c = 0; c < C::kBlocks; ++c)
          repro::tma_load_3d(kd + c * BN * RB, &tm_k, &k_full[st],
                             c * C::kCols, k0, kv_row);
        if (i >= ST) repro::mbar_wait(&v_empty[st], ph);
        repro::mbar_expect_tx(&v_full[st], C::kKVBytes);
#pragma unroll
        for (int c = 0; c < C::kBlocks; ++c)
          repro::tma_load_3d(vd + c * BN * RB, &tm_v, &v_full[st],
                             c * C::kCols, k0, kv_row);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63.  Tile
  // i's S = Q . K^T runs on the tensor cores together with tile i - 1's
  // O += P . V, while the warpgroup computes tile i's softmax.
  repro::setmaxnreg_inc<232>();         // no effect yet: see the note
  const int cw = wg - 1;
  const int t = threadIdx.x - 128 * wg;
  const int lane = t & 31;
  const int row_lo = q0 + 64 * cw + (t >> 5) * 16 + (lane >> 2);  // +8: hi
  const int col0 = 2 * (lane & 3);
  const int qa = q0 + 64 * cw;
  const int qb = qa + 63;
  const uint8_t* q_wg = q_s + cw * 64 * RB;
  // a tile needs the mask where it crosses the end of the sequence, the
  // diagonal of these rows or their window's edge
  auto masked = [&](int k0) {
    return k0 + BN > S || (causal && k0 + BN - 1 > qa) ||
           (window > 0 && k0 <= qb - window);
  };

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float s[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
  uint32_t p_hi[BN / 4], p_lo[BN / 4];
  float m[2] = {repro::kNegInf, repro::kNegInf};
  float l[2] = {0.f, 0.f};
  float alpha[2];

  repro::mbar_wait(q_full, 0);
  repro::mbar_wait(&k_full[0], 0);
  issue_qk<HD>(s, q_wg, k_s);
  repro::wgmma_wait<0>();
  repro::fence_regs(s);
  repro::mbar_arrive(&k_empty[0]);
  softmax_tile<BN>(s, m, l, alpha, masked(kt0 * BN), kt0 * BN, row_lo, col0,
                   S, causal, window, scale_log2);
  split_p<BN>(s, p_hi, p_lo);
  for (int i = 1; i < n_tiles; ++i) {
    const int st = i % ST;
    const int sp = (i - 1) % ST;
    const int k0 = (kt0 + i) * BN;
    repro::mbar_wait(&k_full[st], (i / ST) & 1);
    issue_qk<HD>(s, q_wg, k_s + st * C::kKVBytes);
    repro::mbar_wait(&v_full[sp], ((i - 1) / ST) & 1);
    issue_pv<HD>(o, p_hi, p_lo, v_s + sp * C::kKVBytes);
    repro::wgmma_wait<1>();                 // S of tile i is in
    repro::fence_regs(s);
    repro::mbar_arrive(&k_empty[st]);
    softmax_tile<BN>(s, m, l, alpha, masked(k0), k0, row_lo, col0, S,
                     causal, window, scale_log2);
    repro::wgmma_wait<0>();                 // O of tile i - 1 is in
    repro::fence_regs(o);
    repro::mbar_arrive(&v_empty[sp]);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    split_p<BN>(s, p_hi, p_lo);
  }
  const int sl = (n_tiles - 1) % ST;
  repro::mbar_wait(&v_full[sl], ((n_tiles - 1) / ST) & 1);
  issue_pv<HD>(o, p_hi, p_lo, v_s + sl * C::kKVBytes);
  repro::wgmma_wait<0>();
  repro::fence_regs(o);

  // epilogue: l summed over the quad that shares a row, clamped
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(~0u, l[r], 1);
    l[r] += __shfl_xor_sync(~0u, l[r], 2);
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    const int qp = row_lo + 8 * r;
    if (qp < S) {
      bf16* orow = out + ((long long)bh * S + qp) * HD + col0;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) = repro::pack_bf16(
            o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

// A (rows3, S, hd) bf16 tensor as a 3-d TMA map whose box is one
// swizzled column block of `box_rows` rows.
bool encode(CUtensorMap* map, const void* ptr, int hd, int S, int rows3,
            int box_rows, int row_bytes) {
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)S,
                              (cuuint64_t)rows3};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)S * hd * 2};
  const cuuint32_t box[3] = {(cuuint32_t)row_bytes / 2,
                             (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                              : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(void* out, const void* q, const void* k, const void* v, int B,
           int H, int Hkv, int S, int causal, int window, float scale,
           cudaStream_t stream) {
  using C = Cfg<HD>;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, HD, S, B * H, kBM, C::kRowBytes) ||
      !encode(&tk, k, HD, S, B * Hkv, C::kBN, C::kRowBytes) ||
      !encode(&tv, v, HD, S, B * Hkv, C::kBN, C::kRowBytes))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_tc_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + kBM - 1) / kBM);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), S, H, Hkv, causal, window,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

int dispatch(int hd, void* out, const void* q, const void* k, const void* v,
             int B, int H, int Hkv, int S, int causal, int window,
             float scale, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<32>(out, q, k, v, B, H, Hkv, S, causal, window,
                               scale, s);
    case 64: return launch<64>(out, q, k, v, B, H, Hkv, S, causal, window,
                               scale, s);
    case 128: return launch<128>(out, q, k, v, B, H, Hkv, S, causal, window,
                                 scale, s);
    case 256: return launch<256>(out, q, k, v, B, H, Hkv, S, causal, window,
                                 scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

extern "C" {

// out, q: (B, H, S, hd); k, v: (B, Hkv, S, hd), all of `dtype`, hd in
// {32, 64, 128, 256}, H a multiple of Hkv; window < 0 means none.
// bfloat16 runs the tensor-core kernel, float32 the CUDA-core one.
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
    return simt::dispatch<float>(hd, out, q, k, v, B, H, Hkv, S, causal,
                                 window, scale, s);
  if (dtype == repro::kBF16)
    return tc::dispatch(hd, out, q, k, v, B, H, Hkv, S, causal, window,
                        scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
