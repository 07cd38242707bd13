// Level-synchronous first-delivery sweep over one TreePlan, for Hopper.
//
// Replaces repro/kernels/tree_sweep.py:tree_sweep_pallas (the Pallas
// kernel _sweep_kernel).  For every row r (seed x message) and every node
// v reached by the tree it computes, level by level,
//
//     t[r, v] = (t[r, parent[v]] + fp[r, v]) + link[r, v]
//
// with t[r, root] = t0[r] and NaN everywhere the tree does not reach.
//
// What bounds it: memory traffic.  Each (row, node) element reads fp and
// link, gathers its parent's time and writes its own, after the init pass
// wrote it once: about 24 bytes per element against two float adds, far
// below the card's operations-per-byte line.
//
// Design.  The Pallas kernel keeps one (block_m, n) tile resident in VMEM
// across a sequential level axis; a 1M-node f32 row is 4 MB, far past a
// block's 227 KB of shared memory, so that design does not carry over.
// Instead the host launches one kernel per level on the caller's stream:
// stream order is the barrier between levels.  Each level kernel runs
// over only that level's nodes, taken from a CSR (nodes grouped by depth
// with their parents, level_ptr on the host), one thread per
// (row, level-node) element.  __fadd_rn pins the reference's
// (t[parent] + fp) + link grouping and forbids contraction, so the result
// is bit-equal to the plain PyTorch sweep; NaN in link rides the adds, as
// a dead edge does under loss.  The root's parent (-1) is never read: the
// root is not in the CSR.  Row offsets are 64-bit.
//
// Later work: fuse the counter-RNG draws into the sweep so the fp/link
// planes are never written, and replace the per-level launches with a
// persistent kernel or a CUDA graph.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr long long kMaxGridX = 1 << 20;

__global__ void sweep_init(float* __restrict__ t, const float* __restrict__ t0,
                           long long rows, long long n, long long root) {
  const float nan = __int_as_float(0x7fc00000);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    float* row = t + r * n;
    const float start = t0[r];
    for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         v < n; v += stride) {
      row[v] = (v == root) ? start : nan;
    }
  }
}

__global__ void sweep_level(float* __restrict__ t, const float* __restrict__ fp,
                            const float* __restrict__ link,
                            const int* __restrict__ nodes,
                            const int* __restrict__ parents, long long count,
                            long long rows, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long off = r * n;
    for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         j < count; j += stride) {
      const long long v = off + nodes[j];
      const long long p = off + parents[j];
      t[v] = __fadd_rn(__fadd_rn(t[p], fp[v]), link[v]);
    }
  }
}

long long blocks_for(long long count) {
  long long b = (count + kThreads - 1) / kThreads;
  return b < kMaxGridX ? b : kMaxGridX;
}

}  // namespace

extern "C" {

// Sweeps `n_levels` levels of one plan over `rows` rows of n nodes.
// out, fp, link: (rows, n) f32; t0: (rows,) f32; nodes, parents: the
// level CSR on the device; level_ptr: (n_levels + 1,) host offsets into
// it.  Launches on `stream`; returns 0 or the first CUDA error code.
int repro_tree_sweep_f32(float* out, const float* fp, const float* link,
                         const float* t0, const int* nodes, const int* parents,
                         const long long* level_ptr, int n_levels,
                         long long rows, long long n, long long root,
                         void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned gy = (unsigned)(rows < kMaxGridY ? rows : kMaxGridY);
  sweep_init<<<dim3((unsigned)blocks_for(n), gy), kThreads, 0, s>>>(
      out, t0, rows, n, root);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int h = 0; h < n_levels; ++h) {
    const long long begin = level_ptr[h];
    const long long count = level_ptr[h + 1] - begin;
    if (count <= 0) continue;
    sweep_level<<<dim3((unsigned)blocks_for(count), gy), kThreads, 0, s>>>(
        out, fp, link, nodes + begin, parents + begin, count, rows, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
