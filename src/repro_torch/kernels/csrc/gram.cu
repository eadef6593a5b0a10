// Batched Gram kernel: out[u] = X[u]^T X[u] for X (N, n, d) fp32.
//
// Replaces src/repro/kernels/gram/gram.py::gram_pallas (pallas_call at
// :48), which the reference vmaps over users in similarity.batched_gram.
//
// Bound on the H100: the function needs N * n * d * (d + 1) floating-point
// operations (X^T X is symmetric: one triangle with its diagonal, as a
// syrk counts it) against N * n * d * 4 bytes of input, i.e. about n / 4
// flop per byte read: above the fp32 ridge (67 TFLOP/s over 3.35 TB/s =
// 20 flop/B) for every n the protocol uses, so the function is
// compute-bound on plain fp32 FMA.
//
// Design: the user index and the (i, j) output tile are one flattened
// grid axis (blocks run in any order; nothing carries between them).
// Each 256-thread block owns a 64 x 64 output tile and walks the n axis
// in 16-row stages through shared memory; each thread keeps a 4 x 4
// register tile of accumulators, so every shared-memory value loaded
// feeds four FMAs.  The TPU kernel's sequential n grid axis becomes this
// in-block loop.  Ragged edges (d or n not a multiple of the tile) are
// masked with zero fill on load and skipped on store, instead of the
// Pallas wrapper's padding.  Plain fp32 FMA, no TF32, so the result
// agrees with an fp32 matmul to rounding.  Symmetry of the output is not
// exploited yet: both triangles are computed, twice the operations the
// bound counts.
#include "common.cuh"

namespace {

constexpr int kTile = 64;     // output tile edge (rows and columns)
constexpr int kStage = 16;    // rows of X per shared-memory stage
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
gram_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
            int d, int tiles) {
  __shared__ __align__(16) float xi[kStage][kTile];
  __shared__ __align__(16) float xj[kStage][kTile];

  const int64_t per_user = (int64_t)tiles * tiles;
  const int64_t b = blockIdx.x;
  const int64_t user = b / per_user;
  const int rem = (int)(b - user * per_user);
  const int i0 = (rem / tiles) * kTile;
  const int j0 = (rem % tiles) * kTile;
  const float* xu = x + user * (int64_t)n * d;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns j0 + 4 tx .. + 3
  const int ty = tid / 16;  // output rows    i0 + 4 ty .. + 3

  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;

  for (int r0 = 0; r0 < n; r0 += kStage) {
#pragma unroll
    for (int l = 0; l < kStage * kTile / kThreads; ++l) {
      const int e = tid + l * kThreads;
      const int r = e / kTile;
      const int c = e % kTile;
      const int row = r0 + r;
      const float* xr = xu + (int64_t)row * d;
      xi[r][c] = (row < n && i0 + c < d) ? xr[i0 + c] : 0.f;
      xj[r][c] = (row < n && j0 + c < d) ? xr[j0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kStage; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&xi[r][ty * 4]);
      const float4 bb = *reinterpret_cast<const float4*>(&xj[r][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
    }
    __syncthreads();
  }

  float* ou = out + user * (int64_t)d * d;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int row = i0 + ty * 4 + p;
    if (row >= d) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = j0 + tx * 4 + q;
      if (col < d) ou[(int64_t)row * d + col] = acc[p][q];
    }
  }
}

}  // namespace

// x (n_users, n, d) fp32 contiguous -> out (n_users, d, d) fp32.
REPRO_EXPORT int repro_gram(const float* x, float* out, int n_users, int n,
                            int d, void* stream) {
  if (n_users <= 0 || d <= 0) return 0;
  const int tiles = repro_ceil_div(d, kTile);
  const int64_t blocks = (int64_t)n_users * tiles * tiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  gram_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, out, n, d, tiles);
  return (int)cudaGetLastError();
}
