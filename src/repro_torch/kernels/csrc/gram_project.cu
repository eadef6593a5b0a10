// Fused Gram + cross-projection (paper Eqs. 1-2 without the Gram), a
// whole tile of users in one launch:
//   out[u, q] = || X_u^T (X_u V[:, q]) ||_2
// for X (B, n, d) and V (d, K), out (B, K), all fp32.  The blockwise
// protocol passes every user's signature columns at once, K = N * k; the
// division by max(n_valid, 1) stays in the wrapper (ops.py).
//
// Replaces src/repro/kernels/gram_project/gram_project.py::
// gram_project_pallas (grid variant, pallas_call at :134, and its DMA
// double-buffered variant at :120), which the reference calls once per
// user of a tile (lax.map in core/engine.py::_tile_rows).
//
// Bound on the H100 at the blockwise path's shapes (N = 1024 users in
// all, n = 256, d = 512, K = 8192): 4 N n d K = 4.4e12 floating-point
// operations (X_u V, then X_u^T P), 65.6 ms at the 67 TFLOP/s fp32 peak,
// against 0.57 GB of X, V and out, 0.17 ms at 3.35 TB/s: the operations
// bound it, on plain fp32 FMA (the same bound as eigproject at the dense
// path's shapes).
//
// Design: a 256-thread block owns one user and a slab of BK consecutive
// columns (BK = 32 for d <= 512, 16 for d <= 1024, 8 for d <= 2048).
// It stages its slab of V in shared memory once.  For each tile of 16
// rows it loads X_t into shared memory once and uses it for both
// products: P_t = X_t V_slab (16 x BK; the depth d is split over
// 256 / BK thread groups, 4 x 4 register tile each, then summed through
// shared memory), then acc += X_t^T P_t, where the (d, BK) accumulator
// lives in registers (at most 16 rows x 4 columns per thread).  The
// block ends with the column sums of squares and the square root.  The
// (d, d) Gram and the (n, K) projection never reach device memory.
// Blocks are numbered user-major, so a user's column slabs run together
// and its X is re-read from L2, not from device memory, once per slab.
// Edges are masked with zero fill.  Plain fp32 FMA, no tensor cores yet.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;            // rows of X per tile
constexpr int kMaxRowsPerThread = 16;
constexpr int kPartFloats = 4096;    // (256 / BK) x kRows x BK
constexpr int kMaxSmem = 232448;     // opt-in shared memory of one block

// Shared floats: vs [d][BK] | xs [kRows][d + 1] | part [kPartFloats]
// | ps [kRows][BK + 1].
inline int64_t smem_floats(int d, int bk) {
  return (int64_t)d * bk + (int64_t)kRows * (d + 1) + kPartFloats +
         kRows * (bk + 1);
}

// Slab width for depth d: the widest of 32, 16, 8 whose accumulator fits
// the per-thread register tile and whose buffers fit the shared memory.
int slab_width(int d) {
  for (int bk = 32; bk >= 8; bk /= 2) {
    const int row_groups = kThreads / (bk / 4);
    if (repro_ceil_div(d, row_groups) <= kMaxRowsPerThread &&
        smem_floats(d, bk) * 4 <= kMaxSmem)
      return bk;
  }
  return 0;
}

template <int BK>
__global__ void __launch_bounds__(kThreads)
gram_project_kernel(const float* __restrict__ x, const float* __restrict__ v,
                    float* __restrict__ out, int n, int d, int k_cols,
                    int slabs) {
  constexpr int kGroups = kThreads / BK;      // depth groups of P_t
  constexpr int kColGroups = BK / 4;          // 4 accumulator columns each
  constexpr int kRowGroups = kThreads / kColGroups;
  extern __shared__ __align__(16) float smem[];
  const int ldx = d + 1;
  float* vs = smem;
  float* xs = vs + d * BK;
  float* part = xs + kRows * ldx;
  float* ps = part + kPartFloats;

  const int64_t user = blockIdx.x / slabs;
  const int q0 = (int)(blockIdx.x % slabs) * BK;
  const float* xu = x + user * (int64_t)n * d;
  const int tid = threadIdx.x;

  for (int e = tid; e < d * BK; e += kThreads) {
    const int i = e / BK;
    const int cc = e % BK;
    vs[e] = (q0 + cc < k_cols) ? v[(int64_t)i * k_cols + q0 + cc] : 0.f;
  }

  // P_t: group g sums depths [i_lo, i_hi) of a 4 x 4 tile (tr, tc).
  const int g = tid / BK;
  const int tr = (tid % BK) / (BK / 4);
  const int tc = (tid % BK) % (BK / 4);
  const int depth = repro_ceil_div(d, kGroups);
  const int i_lo = g * depth;
  const int i_hi = min(d, i_lo + depth);
  // acc: rows [a0, a0 + rpt) of d, columns cg * 4 .. + 3 of the slab.
  const int cg = tid % kColGroups;
  const int rg = tid / kColGroups;
  const int rpt = repro_ceil_div(d, kRowGroups);
  const int a0 = rg * rpt;

  float acc[kMaxRowsPerThread][4];
#pragma unroll
  for (int s = 0; s < kMaxRowsPerThread; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[s][q] = 0.f;

  for (int r0 = 0; r0 < n; r0 += kRows) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kRows * d; e += kThreads) {
      const int rr = e / d;
      const int i = e % d;
      const int row = r0 + rr;
      xs[rr * ldx + i] = row < n ? xu[(int64_t)row * d + i] : 0.f;
    }
    __syncthreads();

    float p[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) p[a][b] = 0.f;
    for (int i = i_lo; i < i_hi; ++i) {
      float xa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) xa[a] = xs[(tr * 4 + a) * ldx + i];
      const float4 vb = *reinterpret_cast<const float4*>(&vs[i * BK + tc * 4]);
      const float vv[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) p[a][b] = fmaf(xa[a], vv[b], p[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        part[(g * kRows + tr * 4 + a) * BK + tc * 4 + b] = p[a][b];
    __syncthreads();
    for (int e = tid; e < kRows * BK; e += kThreads) {
      const int rr = e / BK;
      const int cc = e % BK;
      float s = 0.f;
#pragma unroll
      for (int gg = 0; gg < kGroups; ++gg) s += part[(gg * kRows + rr) * BK + cc];
      ps[rr * (BK + 1) + cc] = s;
    }
    __syncthreads();

#pragma unroll 2
    for (int rr = 0; rr < kRows; ++rr) {
      float b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = ps[rr * (BK + 1) + cg * 4 + q];
#pragma unroll
      for (int s = 0; s < kMaxRowsPerThread; ++s) {
        const int i = a0 + s;
        if (s < rpt && i < d) {
          const float xa = xs[rr * ldx + i];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[s][q] = fmaf(xa, b[q], acc[s][q]);
        }
      }
    }
  }

  // Column sums of squares, reduced over the row groups, then sqrt.
  __syncthreads();
  float* red = part;  // [kRowGroups][BK] = 1024 floats
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float sq = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxRowsPerThread; ++s)
      sq = fmaf(acc[s][q], acc[s][q], sq);
    red[rg * BK + cg * 4 + q] = sq;
  }
  __syncthreads();
  if (tid < BK && q0 + tid < k_cols) {
    float s = 0.f;
    for (int r = 0; r < kRowGroups; ++r) s += red[r * BK + tid];
    out[user * (int64_t)k_cols + q0 + tid] = sqrtf(s);
  }
}

template <int BK>
int launch(const float* x, const float* v, float* out, int n_users, int n,
           int d, int k_cols, cudaStream_t stream) {
  const int slabs = repro_ceil_div(k_cols, BK);
  const int64_t blocks = (int64_t)n_users * slabs;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const int smem = (int)(smem_floats(d, BK) * sizeof(float));
  auto kernel = gram_project_kernel<BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, (size_t)smem, stream>>>(
      x, v, out, n, d, k_cols, slabs);
  return (int)cudaGetLastError();
}

}  // namespace

// Column-slab width the kernel uses for depth d; 0 when d is too wide.
REPRO_EXPORT int repro_gram_project_slab(int d) { return slab_width(d); }

// x (n_users, n, d), v (d, k_cols) fp32 contiguous -> out (n_users, k_cols).
REPRO_EXPORT int repro_gram_project(const float* x, const float* v, float* out,
                                    int n_users, int n, int d, int k_cols,
                                    void* stream) {
  if (n_users <= 0 || k_cols <= 0 || d <= 0) return 0;
  const int bk = slab_width(d);
  cudaStream_t s = (cudaStream_t)stream;
  if (bk == 32) return launch<32>(x, v, out, n_users, n, d, k_cols, s);
  if (bk == 16) return launch<16>(x, v, out, n_users, n, d, k_cols, s);
  if (bk == 8) return launch<8>(x, v, out, n_users, n, d, k_cols, s);
  return (int)cudaErrorInvalidValue;
}
