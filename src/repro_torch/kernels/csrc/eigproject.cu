// All-pairs eigen-projection norms (paper Eq. 2) in one launch:
//   out[i, j, c] = || G_i V_j[:, c] ||_2
// for G (NG, d, d) and V (NV, d, k), out (NG, NV, k), all fp32.
//
// Replaces src/repro/kernels/eigproject/eigproject.py::project_norms_pallas
// (pallas_call at :66), which the reference calls once per (i, j) pair,
// NG * NV times, from similarity.relevance_matrix.
//
// Bound on the H100: 2 * NG * NV * d^2 * k floating-point operations
// against (NG d^2 + NV d k + NG NV k) * 4 bytes: compute-bound on plain
// fp32 FMA (at N = 1024, d = 512, k = 8: 4.4e12 flop, about 66 ms at the
// 67 TFLOP/s fp32 peak).
//
// Design: the TPU kernel's fusion is kept: G_i V never goes to device
// memory.  Per user i, the signature columns of every user are one
// stacked matrix W = [V_0 | V_1 | ...] of NV * k columns, and
// out[i] = column norms of G_i W, written flat in (j, c) order.  A
// 256-thread block owns one i and 128 consecutive stacked columns.  It
// walks G_i in 64-row tiles; for each row tile it runs a 64 x 128 x d
// product through shared memory in 16-deep stages (4 x 8 register tile
// per thread), then squares the finished rows and adds them to the
// thread's per-column sum of squares, which stays in registers for the
// whole pass over G_i.  One shared-memory reduction over the 16 row
// groups and a sqrt end the block.  Any k works: a column's owner j and
// position c come from its flat index.  Edges are masked (zero fill), so
// d need not be a multiple of the tile.  Plain fp32 FMA, no TF32.
#include "common.cuh"

namespace {

constexpr int kRows = 64;     // rows of G_i per tile
constexpr int kDepth = 16;    // inner-dimension stage
constexpr int kCols = 128;    // stacked (j, c) columns per block
constexpr int kThreads = 256; // 16 row groups x 16 column groups

__global__ void __launch_bounds__(kThreads)
project_norms_kernel(const float* __restrict__ g, const float* __restrict__ v,
                     float* __restrict__ out, int n_v, int d, int k,
                     int col_tiles) {
  __shared__ float gs[kRows][kDepth + 1];
  __shared__ __align__(16) float ws[kDepth][kCols];
  __shared__ float red[16][kCols];

  const int64_t i = blockIdx.x / col_tiles;
  const int q0 = (int)(blockIdx.x % col_tiles) * kCols;
  const int nq = n_v * k;
  const float* gi = g + i * (int64_t)d * d;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // stacked columns q0 + 8 tx .. + 7
  const int ty = tid / 16;  // rows r0 + 4 ty .. + 3 of each row tile

  float sq[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) sq[q] = 0.f;

  for (int r0 = 0; r0 < d; r0 += kRows) {
    float acc[4][8];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;

    for (int c0 = 0; c0 < d; c0 += kDepth) {
#pragma unroll
      for (int l = 0; l < kRows * kDepth / kThreads; ++l) {
        const int e = tid + l * kThreads;
        const int rr = e / kDepth;
        const int cc = e % kDepth;
        const int row = r0 + rr;
        const int col = c0 + cc;
        gs[rr][cc] = (row < d && col < d) ? gi[(int64_t)row * d + col] : 0.f;
      }
#pragma unroll
      for (int l = 0; l < kDepth * kCols / kThreads; ++l) {
        const int e = tid + l * kThreads;
        const int kr = e / kCols;
        const int qq = e % kCols;
        const int q = q0 + qq;
        const int row = c0 + kr;
        float w = 0.f;
        if (q < nq && row < d) {
          const int j = q / k;
          const int c = q - j * k;
          w = v[((int64_t)j * d + row) * k + c];
        }
        ws[kr][qq] = w;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        float a[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) a[p] = gs[ty * 4 + p][kk];
        const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][tx * 8]);
        const float4 b1 = *reinterpret_cast<const float4*>(&ws[kk][tx * 8 + 4]);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
      }
      __syncthreads();
    }
    // Rows past d were zero-filled, so they add nothing here.
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 8; ++q) sq[q] = fmaf(acc[p][q], acc[p][q], sq[q]);
  }

#pragma unroll
  for (int q = 0; q < 8; ++q) red[ty][tx * 8 + q] = sq[q];
  __syncthreads();
  if (tid < kCols && q0 + tid < nq) {
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < 16; ++t) s += red[t][tid];
    out[i * (int64_t)nq + q0 + tid] = sqrtf(s);
  }
}

}  // namespace

// g (n_g, d, d), v (n_v, d, k) fp32 contiguous -> out (n_g, n_v, k).
REPRO_EXPORT int repro_project_norms(const float* g, const float* v,
                                     float* out, int n_g, int n_v, int d,
                                     int k, void* stream) {
  if (n_g <= 0 || n_v <= 0 || k <= 0) return 0;
  const int col_tiles = repro_ceil_div((int64_t)n_v * k, kCols);
  const int64_t blocks = (int64_t)n_g * col_tiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  project_norms_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(g, v, out, n_v, d, k,
                                                 col_tiles);
  return (int)cudaGetLastError();
}
