// NN-chain HAC on the device: the fused Lance-Williams row update with a
// masked first-index argmax, used two ways.
//
// Replaces src/repro/kernels/linkage/linkage.py::linkage_step_pallas
// (pallas_call at :88), which the reference calls about 4n times from
// inside the jitted while_loop of core/cluster_engine.py::_nn_chain.
//
//   (a) repro_linkage_step: one launch of the step with the reference's
//       contract (row_a, row_b, size_a, size_b, mask) -> (row, argmax,
//       max), kept so the step can be held against its plain version.
//   (b) repro_nn_chain: one persistent single-block kernel that runs the
//       whole NN-chain loop, so the chain costs one launch instead of a
//       launch and a host round trip per step.
//
// Bound on the H100: the work is a few flops per element, so the bytes
// bound it: R (n^2 fp32) read once.  In practice the loop is latency-bound:
// about 4n dependent steps, each a pass over one n-wide row plus a block
// reduction.  The design keeps every step on one SM with all loop state
// (sizes, alive flags, the chain) in shared memory, so a step costs a row
// read from L2 and three block barriers, and no launch.
//
// Numerics match the plain PyTorch version bit for bit: the average
// linkage is evaluated with round-to-nearest intrinsics in the
// reference's order, (na*a + nb*b) / (na + nb), so the compiler cannot
// contract it into an FMA.  Ties resolve to the smallest index, and NaN
// ranks above every number, as torch.argmax and jnp.argmax do; an
// all--inf row gives index 0.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

enum Linkage { kAverage = 0, kSingle = 1, kComplete = 2 };

__device__ __forceinline__ float lance_williams(float a, float b, float na,
                                                float nb, int linkage) {
  if (linkage == kAverage)
    return __fdiv_rn(__fadd_rn(__fmul_rn(na, a), __fmul_rn(nb, b)),
                     __fadd_rn(na, nb));
  if (isnan(a) || isnan(b)) return a + b;  // NaN propagates, as torch.maximum
  return linkage == kSingle ? fmaxf(a, b) : fminf(a, b);
}

// True when (v, i) ranks before (bv, bi) in argmax order.
__device__ __forceinline__ bool ranks_first(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn != bn) return vn;
  if (!vn && v != bv) return v > bv;
  return i < bi;
}

// Block-wide argmax of each thread's (v, i); every thread gets the result.
__device__ __forceinline__ void block_argmax(float& v, int& i, float* sv,
                                             int* si) {
  const unsigned full = 0xffffffffu;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(full, v, off);
    const int oi = __shfl_down_sync(full, i, off);
    if (ranks_first(ov, oi, v, i)) { v = ov; i = oi; }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { sv[warp] = v; si[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? sv[lane] : -INFINITY;
    i = lane < kWarps ? si[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(full, v, off);
      const int oi = __shfl_down_sync(full, i, off);
      if (ranks_first(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) { sv[kWarps] = v; si[kWarps] = i; }
  }
  __syncthreads();
  v = sv[kWarps];
  i = si[kWarps];
  __syncthreads();  // sv/si are free for the next reduction
}

__global__ void __launch_bounds__(kThreads)
linkage_step_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float na, float nb, const float* __restrict__ mask,
                    float* __restrict__ row, int* idx, float* val, int n,
                    int linkage) {
  __shared__ float sv[kWarps + 1];
  __shared__ int si[kWarps + 1];
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int c = threadIdx.x; c < n; c += kThreads) {
    const float x =
        mask[c] > 0.5f ? lance_williams(a[c], b[c], na, nb, linkage) : -INFINITY;
    row[c] = x;
    if (ranks_first(x, c, bv, bi)) { bv = x; bi = c; }
  }
  block_argmax(bv, bi, sv, si);
  if (threadIdx.x == 0) { *idx = bi; *val = bv; }
}

// The NN-chain loop of core/cluster_engine.py::_nn_chain on one block.
// s (n, n) is the prepared linkage matrix (diagonal -inf); it is updated
// in place, so the caller hands over a copy it owns.  merges (n-1, 2)
// and heights (n-1) are written in chain order; counters = {merges
// done, loop iterations}.
__global__ void __launch_bounds__(kThreads)
nn_chain_kernel(float* s, int n, int linkage, int max_iter, int* merges,
                float* heights, int* counters) {
  extern __shared__ float smem[];
  float* size = smem;                        // (n,)   cluster sizes
  int* alive = reinterpret_cast<int*>(size + n);  // (n,)  1 = live row
  int* chain = alive + n;                    // (n+1,) the NN chain
  __shared__ float sv[kWarps + 1];
  __shared__ int si[kWarps + 1];

  const int tid = threadIdx.x;
  for (int c = tid; c < n; c += kThreads) { size[c] = 1.f; alive[c] = 1; }
  __syncthreads();

  // Control state is uniform across the block: every thread derives it
  // from the same shared values and reduction results.
  int clen = 0, t = 0, it = 0;
  while (t < n - 1 && it < max_iter) {
    if (clen == 0) {  // re-seed an empty chain with the smallest live row
      float bv = -INFINITY;
      int bi = INT_MAX;
      for (int c = tid; c < n; c += kThreads) {
        const float x = alive[c] ? 1.f : 0.f;
        if (ranks_first(x, c, bv, bi)) { bv = x; bi = c; }
      }
      block_argmax(bv, bi, sv, si);
      if (tid == 0) chain[0] = bi;
      clen = 1;
      __syncthreads();
    }
    const int top = chain[clen - 1];
    const int prev = chain[clen >= 2 ? clen - 2 : 0];
    const float* row_top = s + (int64_t)top * n;
    // Read before the barrier in block_argmax: a merge below overwrites it.
    const float prev_sim = clen >= 2 ? row_top[prev] : -INFINITY;

    // Chain extension: the fused step with a == b is a masked argmax.
    float best = -INFINITY;
    int nn = INT_MAX;
    for (int c = tid; c < n; c += kThreads) {
      float x = -INFINITY;
      if (alive[c] && c != top) {
        const float r = row_top[c];
        x = lance_williams(r, r, 1.f, 1.f, linkage);
      }
      if (ranks_first(x, c, best, nn)) { best = x; nn = c; }
    }
    block_argmax(best, nn, sv, si);

    // prev is top's predecessor, so prev_sim >= best means prev attains
    // top's row max: a reciprocal pair.
    if (clen >= 2 && prev_sim >= best) {
      const int i = min(top, prev), j = max(top, prev);
      const float na = size[i], nb = size[j];
      float* row_i = s + (int64_t)i * n;
      float* row_j = s + (int64_t)j * n;
      // Thread c reads only s[i][c], s[j][c] for c outside {i, j}; the
      // cells it writes are never read by another thread in this pass.
      for (int c = tid; c < n; c += kThreads) {
        float x = -INFINITY;
        if (c != i && c != j && alive[c])
          x = lance_williams(row_i[c], row_j[c], na, nb, linkage);
        row_i[c] = x;
        s[(int64_t)c * n + i] = x;
        row_j[c] = -INFINITY;
        s[(int64_t)c * n + j] = -INFINITY;
      }
      __syncthreads();
      if (tid == 0) {
        size[i] = na + nb;
        size[j] = 0.f;
        alive[j] = 0;
        merges[2 * t] = i;
        merges[2 * t + 1] = j;
        heights[t] = prev_sim;
      }
      __syncthreads();
      clen -= 2;
      ++t;
    } else {
      if (clen > n) break;  // chain buffer full: only non-finite input
      if (tid == 0) chain[clen] = nn;
      __syncthreads();
      ++clen;
    }
    ++it;
  }
  if (tid == 0) { counters[0] = t; counters[1] = it; }
}

}  // namespace

REPRO_EXPORT int repro_linkage_step(const float* a, const float* b, float na,
                                    float nb, const float* mask, float* row,
                                    int* idx, float* val, int n, int linkage,
                                    void* stream) {
  linkage_step_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      a, b, na, nb, mask, row, idx, val, n, linkage);
  return (int)cudaGetLastError();
}

// Dynamic shared memory the chain kernel needs for n leaves.
REPRO_EXPORT int64_t repro_nn_chain_smem(int n) {
  return (int64_t)sizeof(float) * n + (int64_t)sizeof(int) * (2 * n + 1);
}

REPRO_EXPORT int repro_nn_chain(float* s, int n, int linkage, int max_iter,
                                int* merges, float* heights, int* counters,
                                void* stream) {
  const int64_t smem = repro_nn_chain_smem(n);
  cudaError_t err = cudaFuncSetAttribute(
      nn_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nn_chain_kernel<<<1, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      s, n, linkage, max_iter, merges, heights, counters);
  return (int)cudaGetLastError();
}
