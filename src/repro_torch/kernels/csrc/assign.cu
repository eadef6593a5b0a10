// Cluster assignment against the membership directory: for arrivals
// V (B, d, k) fp32 and a directory of T prototype projectors
// P (T, d, d), the raw affinity, the first-index argmax label and the
// best-minus-second margin of every arrival:
//   aff[b, t] = <V_b V_b^T, P_t> * scale_t   (-inf where t is dead)
//   label[b]  = first t with aff[b, t] == max_t aff[b, t]
//   margin[b] = best - second best  (best alone when T == 1)
// The caller divides aff and margin by k.  Two kernels:
//
// assign_wave (fp32 compute; bf16 compute runs on the tensor cores in
// assign_wave_tc.cu, and the wrapper chooses by compute dtype alone)
// replaces src/repro/kernels/assign/assign.py::assign_wave_pallas
// (pallas_call at :117), the one-matmul form A = S P^T with S (B, d^2)
// the flattened wave projectors, a directory stored in f32, bf16 or int8
// (per-prototype scales applied in the epilogue), fp32 inputs to the
// product and fp32 sums.
//   Bound on the H100: 2 B d^2 (k + T) fp32 operations (67 TFLOP/s)
//   against 4 B d k + s T d^2 + 4 B T bytes (s the stored width).
//   Design: S never reaches device memory (the reference's wrapper builds it
//   with an einsum: 1 MiB per arrival at d = 512).  A block owns up to 8
//   arrivals (fewer when the wave is short, so that a wave of 128 still
//   spreads over 128 SMs) and walks the directory in tiles of prototypes, in
//   order.  For each tile it streams the flattened d^2 axis in steps of `rows`
//   rows of S times 128 columns.  Each thread forms s_ij = sum_c v_ic v_jc for
//   some of the block's (arrival, row) pairs in fp32 and stages it in shared
//   memory: S is the only operand the threads share, double-buffered so a step
//   costs one barrier.  The directory is read straight from device memory into
//   registers, each entry by the one lane that uses it, one step ahead of its
//   use: a warp owns 4 prototypes and one row of the step, a lane 4
//   consecutive entries of that row (one 16-byte load per prototype for f32),
//   as fp32, and a thread keeps an arrivals x 4 block of sums in registers.
//   The loads in flight bound this kernel (a block is latency-bound, not
//   FMA-bound), so a small directory takes more rows a step (8 when T <= 4) to
//   give every warp live prototypes and its own loads; from T = 17 on a step
//   is one row and a tile 32 prototypes.  The block is two groups of 256
//   threads that take alternate steps (named barriers).  At the end of a tile
//   the lanes' sums are added by shuffles, and one thread per arrival adds the
//   row slots, applies scale and liveness and walks the tile's affinities in
//   prototype order, keeping a running (best, second, argmax) in registers and
//   moving the argmax only on strict '>', so the first index wins: any T, no
//   atomics, no second pass.  S is formed again for every tile.  Every block
//   reads the whole directory.
//
// assign_one replaces src/repro/kernels/assign/assign.py::
// assign_one_pallas (pallas_call at :214), the per-arrival form
// a_t = sum((P_t V) o V), with P_t V from inputs cast to the compute
// type and summed in fp32, and V in fp32 in the final product.  The
// reference runs one grid launch per arrival (lax.map); here one launch
// covers the wave, one 256-thread block per arrival.
//   Bound: 2 B T d^2 k operations (0.032 ms at B = 128, T = 4, d = 512,
//   k = 8 on the fp32 cores) against s T d^2 + 4 B d k bytes.
//   Design: the block stages V in shared memory twice (transposed and
//   cast to the compute type for P_t V, row-major in fp32 for the final
//   product), then walks the prototypes in order.  A warp owns 4 rows
//   of P_t at a time; each lane reads a strided slice of the 4 rows
//   (coalesced), keeps 4 x 8 partial sums of P_t V in registers, and
//   folds them into its affinity partial with V in fp32 (the same sum in
//   another order).  One block reduction per prototype; thread 0 keeps
//   the running (best, second, argmax) with strict '>'.
#include <cuda_bf16.h>

#include "common.cuh"
#include "verdict.cuh"

namespace {

constexpr int kGroupThreads = 256;        // one thread group
constexpr int kGroups = 2;                // groups per wave block
constexpr int kWaveThreads = kGroupThreads * kGroups;
constexpr int kMaxArrivals = 8;           // arrivals per wave block, at most
constexpr int kProtos = 32;               // prototypes per tile, at most
constexpr int kChunk = 128;               // S entries per chunk, 4 a lane
constexpr int kOneThreads = 256;
constexpr int kOneRows = 4;               // rows of P_t per warp step
constexpr int kOneCols = 8;               // columns of V per pass
constexpr int kMaxSmem = 232448;          // opt-in shared memory of a block

constexpr int kGroupWarps = kGroupThreads / 32;
constexpr int kMaxRows = 8;               // rows of S a step, at most
constexpr int kGenBatch = 4;              // S entries a thread forms at once
constexpr int kMaxSegment = kMaxArrivals * kMaxRows * kChunk;
constexpr int kWaveSmem = (kGroups * 2 * kMaxSegment +
                           kGroups * kMaxArrivals * (kProtos + 1)) *
                          (int)sizeof(float);

enum TableType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ int tile_at(int group, int a, int q) {
  return (group * kMaxArrivals + a) * (kProtos + 1) + q;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) { return (float)x; }

// The value as the product sees it: fp32, or rounded to bf16 (values
// that are already bf16 or int8 are exact in bf16).
template <bool BF16>
__device__ __forceinline__ float to_compute(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Named barrier for one 256-thread group of a wave block.
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(kGroupThreads)
               : "memory");
}

// Four consecutive directory entries as floats; entries from n on are 0.
// vec: the row is aligned for one vector load (d % 4 == 0).
__device__ __forceinline__ float4 load4(const float* p, int n, bool vec) {
  if (vec && n == 4) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(n > 0 ? p[0] : 0.f, n > 1 ? p[1] : 0.f,
                     n > 2 ? p[2] : 0.f, n > 3 ? p[3] : 0.f);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int n,
                                        bool vec) {
  if (vec && n == 4) {  // bf16 -> fp32 is the bit pattern shifted up
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
  return make_float4(n > 0 ? to_float(p[0]) : 0.f,
                     n > 1 ? to_float(p[1]) : 0.f,
                     n > 2 ? to_float(p[2]) : 0.f,
                     n > 3 ? to_float(p[3]) : 0.f);
}
__device__ __forceinline__ float4 load4(const int8_t* p, int n, bool vec) {
  if (vec && n == 4) {
    const char4 c = __ldg(reinterpret_cast<const char4*>(p));
    return make_float4(c.x, c.y, c.z, c.w);
  }
  return make_float4(n > 0 ? p[0] : 0.f, n > 1 ? p[1] : 0.f,
                     n > 2 ? p[2] : 0.f, n > 3 ? p[3] : 0.f);
}

// s_ij = sum_c v_ic v_jc in fp32, c in order, for rows vi and vj of one
// arrival's V (k columns, 16-byte aligned rows when k % 4 == 0).  Each
// product and each sum is rounded on its own (__fmul_rn, __fadd_rn: no
// contraction to FMA), so the plain version's elementwise torch ops in
// the same order give the same s_ij bit for bit, and under bf16 the
// same rounded operand.
__device__ __forceinline__ float entry(const float* __restrict__ vi,
                                       const float* __restrict__ vj, int k) {
  float s = 0.f;
  if ((k & 3) == 0) {
    const float4* a = reinterpret_cast<const float4*>(vi);
    const float4* b = reinterpret_cast<const float4*>(vj);
#pragma unroll 2
    for (int c = 0; c < k / 4; ++c) {
      const float4 x = __ldg(a + c);
      const float4 y = __ldg(b + c);
      s = __fadd_rn(s, __fmul_rn(x.x, y.x));
      s = __fadd_rn(s, __fmul_rn(x.y, y.y));
      s = __fadd_rn(s, __fmul_rn(x.z, y.z));
      s = __fadd_rn(s, __fmul_rn(x.w, y.w));
    }
  } else {
    for (int c = 0; c < k; ++c)
      s = __fadd_rn(s, __fmul_rn(__ldg(vi + c), __ldg(vj + c)));
  }
  return s;
}

// This lane's four directory entries (columns e .. e + 3 of row i) for
// the warp's four prototypes pw .. pw + 3, as fp32.
template <typename T>
__device__ __forceinline__ void load_slice(const T* __restrict__ table,
                                          int64_t d2, int d, int n_protos,
                                          int pw, int i, int e, int n_e,
                                          bool vec, float4 (&pv)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    pv[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pw + q < n_protos && n_e > 0 && i < d)
      pv[q] = load4(table + (pw + q) * d2 + (int64_t)i * d + e, n_e, vec);
  }
}

template <typename T, int ARR>
__global__ void __launch_bounds__(kWaveThreads, 1)
assign_wave_kernel(const float* __restrict__ v, const T* __restrict__ table,
                   const float* __restrict__ scales,
                   const float* __restrict__ mask, float* __restrict__ aff,
                   int* __restrict__ labels, float* __restrict__ margin,
                   int n_arrivals, int n_protos, int d, int k, int rows) {
  extern __shared__ __align__(16) float wave_smem[];

  const int group = threadIdx.x / kGroupThreads;
  const int gtid = threadIdx.x % kGroupThreads;
  const int warp = gtid / 32;
  const int lane = gtid % 32;     // product: segment entries 4 lane .. + 3
  // A step takes `rows` rows of S; the 8 warps of a group split into
  // `rows` row slots of 8 / rows warps, each warp 4 prototypes of the
  // tile's 32 / rows.
  const int warps_per_row = kGroupWarps / rows;
  const int slot = warp / warps_per_row;
  const int quad = warp % warps_per_row;
  const int tile_protos = 4 * warps_per_row;
  const int col = gtid % kChunk;  // forming S: segment entry col
  const int part = gtid / kChunk; // forming S: (arrival, row) pairs part,
                                  // part + 2, ...
  const int b0 = blockIdx.x * ARR;
  const int64_t d2 = (int64_t)d * d;
  const bool vec = (d & 3) == 0;
  const int step_rows = kGroups * rows;
  const int rows_log2 = __ffs(rows) - 1;  // rows is a power of two
  // Two S buffers per group, [ARR][rows][kChunk] each, then the tiles.
  float* ss = wave_smem + group * 2 * kMaxSegment;
  float* tiles = wave_smem + kGroups * 2 * kMaxSegment;

  Verdict verdict;  // used by threads 0 .. ARR - 1
  int buf = 0;
  for (int p0 = 0; p0 < n_protos; p0 += tile_protos) {
    const int pw = p0 + 4 * quad;  // this warp's first prototype
    const bool live_warp = pw < n_protos;
    float acc[ARR][4];
#pragma unroll
    for (int a = 0; a < ARR; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][q] = 0.f;

    for (int j0 = 0; j0 < d; j0 += kChunk) {
      const int j = j0 + col;
      const int e = j0 + 4 * lane;
      const int n_e = e < d ? min(4, d - e) : 0;
      const int i_first = group * rows;
      float4 pv[4];
      if (live_warp)
        load_slice<T>(table, d2, d, n_protos, pw, i_first + slot, e, n_e,
                      vec, pv);
      for (int i0 = i_first; i0 < d; i0 += step_rows) {
        // s_ij of this thread's (arrival, row) pairs into this step's S
        // buffer.  One barrier a step: a buffer
        // is written again only two steps later, after every thread has
        // passed the next step's barrier and so finished this product.
        float* sb = ss + buf * kMaxSegment;
        for (int p4 = part; p4 < ARR * rows; p4 += 2 * kGenBatch) {
          // kGenBatch pairs at once, so their loads are in flight together.
          float s[kGenBatch];
#pragma unroll
          for (int u = 0; u < kGenBatch; ++u) {
            const int pair = p4 + 2 * u;
            const int b = b0 + (pair >> rows_log2);
            const int i = i0 + (pair & (rows - 1));
            s[u] = 0.f;
            if (pair < ARR * rows && b < n_arrivals && j < d && i < d) {
              const float* vb = v + (int64_t)b * d * k;
              s[u] = entry(vb + (int64_t)i * k, vb + (int64_t)j * k, k);
            }
          }
#pragma unroll
          for (int u = 0; u < kGenBatch; ++u)
            if (p4 + 2 * u < ARR * rows)
              sb[(p4 + 2 * u) * kChunk + col] = s[u];
        }
        group_sync(group);
        if (live_warp) {
          // The next step's directory entries are in flight during this
          // step's product.
          float4 pn[4];
          load_slice<T>(table, d2, d, n_protos, pw, i0 + step_rows + slot, e,
                        n_e, vec, pn);
#pragma unroll
          for (int a = 0; a < ARR; ++a) {
            const float4 sv = *reinterpret_cast<const float4*>(
                &sb[(a * rows + slot) * kChunk + 4 * lane]);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              acc[a][q] = fmaf(sv.x, pv[q].x, acc[a][q]);
              acc[a][q] = fmaf(sv.y, pv[q].y, acc[a][q]);
              acc[a][q] = fmaf(sv.z, pv[q].z, acc[a][q]);
              acc[a][q] = fmaf(sv.w, pv[q].w, acc[a][q]);
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) pv[q] = pn[q];
        }
        buf ^= 1;
      }
    }
    // Sum over the warp's lanes; lane 0 holds the warp's ARR x 4 block.
    if (live_warp) {
#pragma unroll
      for (int a = 0; a < ARR; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float x = acc[a][q];
#pragma unroll
          for (int off = 16; off > 0; off /= 2)
            x += __shfl_xor_sync(0xffffffffu, x, off);
          if (lane == 0) tiles[tile_at(group, a, 4 * warp + q)] = x;
        }
    }
    __syncthreads();
    if (threadIdx.x < ARR) {
      // Prototype p0 + 4 qd + qq sums its row slots' warps, in order.
      const int a = threadIdx.x;
      const int b = b0 + a;
      for (int q = 0; q < tile_protos && p0 + q < n_protos; ++q) {
        const int t = p0 + q;
        float x = 0.f;
        for (int g = 0; g < kGroups; ++g)
          for (int r = 0; r < rows; ++r)
            x += tiles[tile_at(g, a, 4 * (r * warps_per_row + q / 4) + q % 4)];
        if (scales != nullptr) x *= scales[t];
        if (mask != nullptr && !(mask[t] > 0.5f)) x = -INFINITY;
        if (b < n_arrivals) aff[(int64_t)b * n_protos + t] = x;
        verdict.take(x, t);
      }
    }
    __syncthreads();  // the tiles are read before the next tile writes them
  }
  if (threadIdx.x < ARR && b0 + (int)threadIdx.x < n_arrivals) {
    const int b = b0 + threadIdx.x;
    labels[b] = verdict.arg;
    margin[b] = verdict.margin(n_protos);
  }
}

template <typename T, bool BF16>
__global__ void __launch_bounds__(kOneThreads)
assign_one_kernel(const float* __restrict__ v, const T* __restrict__ table,
                  const float* __restrict__ mask, float* __restrict__ aff,
                  int* __restrict__ labels, float* __restrict__ margin,
                  int n_protos, int d, int k) {
  extern __shared__ __align__(16) float one_smem[];
  float* vt = one_smem;                 // [k][d]: V^T, compute type
  float* vf = one_smem + (int64_t)k * d;  // [d][k]: V in fp32
  __shared__ float red[kOneThreads / 32];

  const int64_t b = blockIdx.x;
  const float* vb = v + b * d * k;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int64_t d2 = (int64_t)d * d;
  for (int e = tid; e < d * k; e += kOneThreads) {
    const float x = vb[e];
    vf[e] = x;
    vt[(e % k) * d + e / k] = to_compute<BF16>(x);
  }
  __syncthreads();

  Verdict verdict;  // used by thread 0
  for (int t = 0; t < n_protos; ++t) {
    float a = -INFINITY;
    if (mask == nullptr || mask[t] > 0.5f) {  // uniform across the block
      const T* pt = table + t * d2;
      float part = 0.f;
      for (int i0 = warp * kOneRows; i0 < d;
           i0 += (kOneThreads / 32) * kOneRows) {
        for (int c0 = 0; c0 < k; c0 += kOneCols) {
          float w[kOneRows][kOneCols];
#pragma unroll
          for (int r = 0; r < kOneRows; ++r)
#pragma unroll
            for (int c = 0; c < kOneCols; ++c) w[r][c] = 0.f;
#pragma unroll 4
          for (int j = lane; j < d; j += 32) {
            float pv[kOneRows];
#pragma unroll
            for (int r = 0; r < kOneRows; ++r)
              pv[r] = i0 + r < d
                          ? to_compute<BF16>(to_float(pt[(int64_t)(i0 + r) * d + j]))
                          : 0.f;
#pragma unroll
            for (int c = 0; c < kOneCols; ++c) {
              if (c0 + c < k) {
                const float x = vt[(c0 + c) * d + j];
#pragma unroll
                for (int r = 0; r < kOneRows; ++r)
                  w[r][c] = fmaf(pv[r], x, w[r][c]);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < kOneRows; ++r)
#pragma unroll
            for (int c = 0; c < kOneCols; ++c)
              if (i0 + r < d && c0 + c < k)
                part = fmaf(w[r][c], vf[(i0 + r) * k + c0 + c], part);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) red[warp] = part;
      __syncthreads();
      if (tid == 0) {
        a = 0.f;
        for (int w = 0; w < kOneThreads / 32; ++w) a += red[w];
      }
      __syncthreads();  // red is free for the next prototype
    }
    if (tid == 0) {
      aff[b * n_protos + t] = a;
      verdict.take(a, t);
    }
  }
  if (tid == 0) {
    labels[b] = verdict.arg;
    margin[b] = verdict.margin(n_protos);
  }
}

int64_t one_smem_bytes(int d, int k) {
  return 2 * (int64_t)d * k * (int64_t)sizeof(float);
}

// Arrivals per block: 8 where the wave fills the card with 8-arrival
// blocks, fewer for short waves, so a serving wave of 128 arrivals still
// runs on 128 SMs (each block is latency-bound, not throughput-bound).
int wave_arrivals(int n_arrivals) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int per_sm = repro_ceil_div(n_arrivals, sms > 0 ? sms : 1);
  int arr = 1;
  while (arr < per_sm && arr < kMaxArrivals) arr *= 2;
  return arr;
}

template <typename T, int ARR>
int launch_wave_arr(const float* v, const void* table, const float* scales,
                    const float* mask, float* aff, int* labels, float* margin,
                    int n_arrivals, int n_protos, int d, int k,
                    cudaStream_t stream) {
  const int blocks = repro_ceil_div(n_arrivals, ARR);
  auto kernel = assign_wave_kernel<T, ARR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWaveSmem);
  if (err != cudaSuccess) return (int)err;
  // Rows of S a step: enough that all 8 warps of a group hold live
  // prototypes when the directory is small (serving's T = 4 takes 8 rows
  // a step, one per warp), one row a step from T = 17 on.
  const int rows = n_protos <= 4 ? 8 : n_protos <= 8 ? 4
                 : n_protos <= 16 ? 2 : 1;
  kernel<<<(unsigned)blocks, kWaveThreads, (size_t)kWaveSmem, stream>>>(
      v, static_cast<const T*>(table), scales, mask, aff, labels, margin,
      n_arrivals, n_protos, d, k, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wave(const float* v, const void* table, const float* scales,
                const float* mask, float* aff, int* labels, float* margin,
                int n_arrivals, int n_protos, int d, int k,
                cudaStream_t stream) {
  switch (wave_arrivals(n_arrivals)) {
    case 1:
      return launch_wave_arr<T, 1>(v, table, scales, mask, aff, labels,
                                   margin, n_arrivals, n_protos, d, k, stream);
    case 2:
      return launch_wave_arr<T, 2>(v, table, scales, mask, aff, labels,
                                   margin, n_arrivals, n_protos, d, k, stream);
    case 4:
      return launch_wave_arr<T, 4>(v, table, scales, mask, aff, labels,
                                   margin, n_arrivals, n_protos, d, k, stream);
  }
  return launch_wave_arr<T, 8>(v, table, scales, mask, aff, labels, margin,
                               n_arrivals, n_protos, d, k, stream);
}

template <typename T, bool BF16>
int launch_one(const float* v, const void* table, const float* mask,
               float* aff, int* labels, float* margin, int n_arrivals,
               int n_protos, int d, int k, cudaStream_t stream) {
  const int smem = (int)one_smem_bytes(d, k);
  auto kernel = assign_one_kernel<T, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)n_arrivals, kOneThreads, (size_t)smem, stream>>>(
      v, static_cast<const T*>(table), mask, aff, labels, margin, n_protos,
      d, k);
  return (int)cudaGetLastError();
}

int wave_by_table(int table_type, const float* v, const void* table,
                  const float* scales, const float* mask, float* aff,
                  int* labels, float* margin, int n_arrivals, int n_protos,
                  int d, int k, cudaStream_t s) {
  switch (table_type) {
    case kF32:
      return launch_wave<float>(v, table, scales, mask, aff, labels, margin,
                                n_arrivals, n_protos, d, k, s);
    case kBF16:
      return launch_wave<__nv_bfloat16>(v, table, scales, mask, aff, labels,
                                        margin, n_arrivals, n_protos, d, k,
                                        s);
    case kI8:
      return launch_wave<int8_t>(v, table, scales, mask, aff, labels, margin,
                                 n_arrivals, n_protos, d, k, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool BF16>
int one_by_table(int table_type, const float* v, const void* table,
                 const float* mask, float* aff, int* labels, float* margin,
                 int n_arrivals, int n_protos, int d, int k, cudaStream_t s) {
  switch (table_type) {
    case kF32:
      return launch_one<float, BF16>(v, table, mask, aff, labels, margin,
                                     n_arrivals, n_protos, d, k, s);
    case kBF16:
      return launch_one<__nv_bfloat16, BF16>(v, table, mask, aff, labels,
                                             margin, n_arrivals, n_protos, d,
                                             k, s);
    case kI8:
      return launch_one<int8_t, BF16>(v, table, mask, aff, labels, margin,
                                      n_arrivals, n_protos, d, k, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Shared memory the per-arrival kernel needs at (d, k); 0 when it does
// not fit one block.
REPRO_EXPORT int64_t repro_assign_one_smem(int d, int k) {
  const int64_t bytes = one_smem_bytes(d, k);
  return bytes <= kMaxSmem ? bytes : 0;
}

// v (B, d, k) fp32; table (T, d, d) f32 (table_type 0), bf16 (1) or int8
// (2); scales (T,) fp32 or null (all 1); mask (T,) fp32 or null (all
// live), live where > 0.5.  All contiguous.  Writes the raw aff (B, T)
// fp32, labels (B,) int32 and margin (B,) fp32, with fp32 product inputs
// and sums.
REPRO_EXPORT int repro_assign_wave(const float* v, const void* table,
                                   int table_type, const float* scales,
                                   const float* mask, float* aff, int* labels,
                                   float* margin, int n_arrivals,
                                   int n_protos, int d, int k, void* stream) {
  if (n_arrivals <= 0) return 0;
  if (n_protos <= 0 || d <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  return wave_by_table(table_type, v, table, scales, mask, aff, labels,
                       margin, n_arrivals, n_protos, d, k,
                       (cudaStream_t)stream);
}

// The per-arrival form, one block per arrival, no scales; same layouts.
REPRO_EXPORT int repro_assign_one(const float* v, const void* table,
                                  int table_type, const float* mask,
                                  float* aff, int* labels, float* margin,
                                  int n_arrivals, int n_protos, int d, int k,
                                  int bf16, void* stream) {
  if (n_arrivals <= 0) return 0;
  if (n_protos <= 0 || d <= 0 || k <= 0 || one_smem_bytes(d, k) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return one_by_table<true>(table_type, v, table, mask, aff, labels, margin,
                              n_arrivals, n_protos, d, k, s);
  return one_by_table<false>(table_type, v, table, mask, aff, labels, margin,
                             n_arrivals, n_protos, d, k, s);
}
