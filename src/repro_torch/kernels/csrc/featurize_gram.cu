// Fused featurize -> Gram (paper Eq. 1 from raw data), every user of a
// row chunk in one launch:
//   acc[u] += (X_u W)^T (X_u W)
// for X (N, c, m) raw rows, a shared projection W (m, d), and the fp32
// Gram stack acc (N, d, d), which is updated IN PLACE (the streaming
// SignatureEngine folds one row chunk at a time into it).
//
// Replaces src/repro/kernels/featurize_gram/featurize_gram.py::
// featurize_gram_pallas (grid variant, pallas_call at :127, and its DMA
// double-buffered variant at :116), which the reference calls once per
// user for each chunk.
//
// Bound on the H100 at the raw path's shapes (N = 1024 users, n = 252
// rows, m = 3072 pixels, d = 512): the function needs
// N * (2 n m d + n d (d + 1)) = 0.88e12 floating-point operations (the
// projection, then one triangle of the symmetric Gram), 13.1 ms at the
// 67 TFLOP/s fp32 peak, against 3.17 GB of raw rows, 0.95 ms at
// 3.35 TB/s: the operations bound it, on plain fp32 FMA.
//
// Design: one 256-thread block per user walks the chunk in tiles of
// `rows` rows (64, or 32 / 16 where d is too wide for the shared memory).
// For each tile it first computes the whole F_t = X_t W (rows x d) into
// dynamic shared memory, 128 columns at a time (16-deep m stages through
// shared memory, a rows/16 x 8 register tile per thread), and rounds it
// to the input type (bf16 compute path: F is summed in fp32, rounded to
// bf16, and the Gram sums its bf16 products in fp32, as the reference's
// kernel does).  It then adds F_t^T F_t into the user's Gram in device
// memory, one 64 x 64 tile of the upper triangle at a time (4 x 4
// register tile per thread); each off-diagonal tile is also added,
// transposed through shared memory, at its mirror position, so the Gram
// stays symmetric bit for bit.  F never reaches device memory, and it is
// computed once.  Only this block touches this user's Gram, so the
// read-modify-write needs no atomics and the sum order is fixed from run
// to run.  Edges (m, d, rows not multiples of a tile) are masked with
// zero fill.  Plain fp32 FMA, no tensor cores yet: thread-block clusters
// sharing F_t and wgmma are left for later work.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kSlab = 128;     // F columns per pass of the projection
constexpr int kDepth = 16;     // m-stage of the projection
constexpr int kTile = 64;      // Gram output tile edge
constexpr int kTileLd = kTile + 1;
constexpr int kMaxSmem = 232448;  // opt-in shared memory of one block

// Shared floats: f [rows][ldf] | xs [rows][kDepth + 1] | ws [kDepth][kSlab]
// | ts [kTile][kTileLd].
inline int64_t smem_floats(int rows, int ldf) {
  return (int64_t)rows * ldf + (int64_t)rows * (kDepth + 1) +
         kDepth * kSlab + kTile * kTileLd;
}

inline int padded_width(int d) { return repro_ceil_div(d, kSlab) * kSlab; }

// Rows per tile for width d: the largest of 64, 32, 16 whose tile fits.
int tile_rows(int d) {
  const int ldf = padded_width(d);
  for (int rows = 64; rows >= 16; rows /= 2)
    if (smem_floats(rows, ldf) * 4 <= kMaxSmem) return rows;
  return 0;
}

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// The projection's fp32 sum, rounded to the input type.
template <typename T>
__device__ __forceinline__ float to_input(float v) { return v; }
template <>
__device__ __forceinline__ float to_input<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, int RP>  // RP: tile rows each thread projects
__global__ void __launch_bounds__(kThreads)
featurize_gram_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      float* __restrict__ acc, int c, int m, int d, int ldf) {
  constexpr int kRows = 16 * RP;
  extern __shared__ __align__(16) float smem[];
  float* f = smem;
  float* xs = f + kRows * ldf;
  float* ws = xs + kRows * (kDepth + 1);
  float* ts = ws + kDepth * kSlab;

  const int64_t user = blockIdx.x;
  const T* xu = x + user * (int64_t)c * m;
  float* gu = acc + user * (int64_t)d * d;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int tiles = repro_ceil_div(d, kTile);

  for (int r0 = 0; r0 < c; r0 += kRows) {
    // F_t = X_t W into f, kSlab columns at a time.
    for (int j0 = 0; j0 < d; j0 += kSlab) {
      float a[RP][8];
#pragma unroll
      for (int p = 0; p < RP; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q) a[p][q] = 0.f;
      for (int k0 = 0; k0 < m; k0 += kDepth) {
        for (int e = tid; e < kRows * kDepth; e += kThreads) {
          const int rr = e / kDepth;
          const int cc = e % kDepth;
          const int row = r0 + rr;
          const int col = k0 + cc;
          xs[rr * (kDepth + 1) + cc] =
              (row < c && col < m) ? load(xu + (int64_t)row * m + col) : 0.f;
        }
        for (int e = tid; e < kDepth * kSlab; e += kThreads) {
          const int kr = e / kSlab;
          const int qq = e % kSlab;
          const int row = k0 + kr;
          const int col = j0 + qq;
          ws[kr * kSlab + qq] =
              (row < m && col < d) ? load(w + (int64_t)row * d + col) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kDepth; ++kk) {
          float av[RP];
#pragma unroll
          for (int p = 0; p < RP; ++p)
            av[p] = xs[(ty * RP + p) * (kDepth + 1) + kk];
          const float4 b0 =
              *reinterpret_cast<const float4*>(&ws[kk * kSlab + tx * 8]);
          const float4 b1 =
              *reinterpret_cast<const float4*>(&ws[kk * kSlab + tx * 8 + 4]);
          const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int p = 0; p < RP; ++p)
#pragma unroll
            for (int q = 0; q < 8; ++q) a[p][q] = fmaf(av[p], b[q], a[p][q]);
        }
        __syncthreads();
      }
      // Columns past d and rows past c are zero (zero-filled operands).
#pragma unroll
      for (int p = 0; p < RP; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q)
          f[(ty * RP + p) * ldf + j0 + tx * 8 + q] = to_input<T>(a[p][q]);
    }
    __syncthreads();

    // acc[u] += F_t^T F_t: upper-triangle tiles, mirrored.
    for (int ti = 0; ti < tiles; ++ti) {
      for (int tj = ti; tj < tiles; ++tj) {
        const int i0 = ti * kTile;
        const int j0 = tj * kTile;
        float s[4][4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) s[p][q] = 0.f;
#pragma unroll 4
        for (int r = 0; r < kRows; ++r) {
          const float4 av =
              *reinterpret_cast<const float4*>(&f[r * ldf + i0 + ty * 4]);
          const float4 bv =
              *reinterpret_cast<const float4*>(&f[r * ldf + j0 + tx * 4]);
          const float ai[4] = {av.x, av.y, av.z, av.w};
          const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int q = 0; q < 4; ++q) s[p][q] = fmaf(ai[p], bj[q], s[p][q]);
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int row = i0 + ty * 4 + p;
          if (row >= d) continue;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int col = j0 + tx * 4 + q;
            if (col < d) gu[(int64_t)row * d + col] += s[p][q];
          }
        }
        if (ti != tj) {
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              ts[(ty * 4 + p) * kTileLd + tx * 4 + q] = s[p][q];
          __syncthreads();
          for (int e = tid; e < kTile * kTile; e += kThreads) {
            const int rr = e / kTile;  // output row j0 + rr
            const int cc = e % kTile;  // output column i0 + cc
            const int row = j0 + rr;
            const int col = i0 + cc;
            if (row < d && col < d)
              gu[(int64_t)row * d + col] += ts[cc * kTileLd + rr];
          }
          __syncthreads();
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, int RP>
int launch(const void* x, const void* w, float* acc, int n_users, int c, int m,
           int d, cudaStream_t stream) {
  const int ldf = padded_width(d);
  const int smem = (int)(smem_floats(16 * RP, ldf) * sizeof(float));
  auto kernel = featurize_gram_kernel<T, RP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)n_users, kThreads, (size_t)smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), acc, c, m, d, ldf);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(int rows, const void* x, const void* w, float* acc,
                int n_users, int c, int m, int d, cudaStream_t stream) {
  if (rows == 64) return launch<T, 4>(x, w, acc, n_users, c, m, d, stream);
  if (rows == 32) return launch<T, 2>(x, w, acc, n_users, c, m, d, stream);
  return launch<T, 1>(x, w, acc, n_users, c, m, d, stream);
}

}  // namespace

// Rows per tile the kernel uses for width d; 0 when d is too wide.
REPRO_EXPORT int repro_featurize_gram_rows(int d) { return tile_rows(d); }

// x (n_users, c, m), w (m, d): fp32 (bf16 == 0) or bf16 (bf16 != 0),
// contiguous.  acc (n_users, d, d) fp32 contiguous, accumulated in place.
REPRO_EXPORT int repro_featurize_gram(const void* x, const void* w, float* acc,
                                      int n_users, int c, int m, int d,
                                      int bf16, void* stream) {
  if (n_users <= 0 || c <= 0 || m <= 0 || d <= 0) return 0;
  const int rows = tile_rows(d);
  if (rows == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_rows<__nv_bfloat16>(rows, x, w, acc, n_users, c, m, d, s);
  return launch_rows<float>(rows, x, w, acc, n_users, c, m, d, s);
}
