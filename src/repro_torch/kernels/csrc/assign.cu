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
// covers the wave.
//   Bound: 2 B T d^2 k operations (0.0022 ms at B = 128, T = 4, d = 512,
//   k = 8 on the bf16 tensor cores) against s T d^2 + 4 B d k bytes.
//   Design: the per-arrival form, batched across arrivals: for a
//   prototype t, every arrival's P_t V_b is one product P_t [V_1 .. V_B]
//   (d x d times d x B k).  A block owns one group of arrivals (128
//   columns of [V_1 .. V_B]: 128 / k arrivals, or one arrival's k columns
//   in tiles of 128) x one slice of 16 or 32 rows of P, and walks the
//   live prototypes (kernels/assign/ops.py::one_plan picks the group and
//   the slice so that the serving wave fills the card).  Its V sits in
//   shared memory in the compute type, transposed (n-major, d contiguous),
//   in chunks of 512 rows of d under bf16 (256 under fp32), staged once
//   where d fits one chunk and again for each prototype where it does not.
//   The P rows stream through a cp.async ring of 3 to 5 steps (the plan's)
//   in their stored type, 64 columns of d a step.  bf16 runs on mma.sync
//   m16n8k16: each landed step is converted to bf16 once, by all threads
//   and one step ahead of its products (f32 by RN, int8 exactly), and the
//   warps read fragments of it and of V with ldmatrix; each of 16 warps
//   owns 8 columns x the slice (the steps are short chains of dependent
//   phases, so the SM needs many warps); the fp32 accumulators fold into a
//   register sum every 128 columns of d.  fp32 runs on the same grid with
//   fp32 FMA on the CUDA cores (a thread 1 or 2 rows x 4 columns).  V
//   in fp32 at a thread's W entries stays in registers; at the end of a
//   prototype each W entry is multiplied by it into shared memory, and
//   one warp per arrival sums its slice x k products in a fixed order
//   into the wrapper's workspace, partial[slice][b][t].
//   A second kernel, one warp per arrival, adds the partials in slice
//   order, applies the mask, keeps the verdict (strict '>' per lane, then
//   the lanes merged preferring the lower index) on the raw sums, and
//   writes aff / k and margin / k.  No atomics: two runs give the same
//   bits.
#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"
#include "verdict.cuh"

namespace {

constexpr int kGroupThreads = 256;        // one thread group
constexpr int kGroups = 2;                // groups per wave block
constexpr int kWaveThreads = kGroupThreads * kGroups;
constexpr int kMaxArrivals = 8;           // arrivals per wave block, at most
constexpr int kProtos = 32;               // prototypes per tile, at most
constexpr int kChunk = 128;               // S entries per chunk, 4 a lane
constexpr int kOneThreads = 512;          // 16 warps
constexpr int kOneCols = 128;             // columns of [V_1 .. V_B] a block
constexpr int kOneStep = 64;              // columns of d a step
constexpr int kOneMaxStages = 5;          // P ring depth, at most
constexpr int kOneFold = 2;               // steps between folds (bf16)
constexpr int kPRowBytes = 288;           // a ring row: 64 f32 + 32 bytes
constexpr int kPbLd = kOneStep + 8;       // a converted P row (bf16)
constexpr int kELd = kOneCols + 8;        // epilogue product rows (fp32)
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

// -- assign_one -----------------------------------------------------------

// A staged P row, in entries of T: 64 plus 16 or 32 bytes, so that rows
// start 16-byte aligned for the copies and on shifted banks.
template <typename T>
__host__ __device__ constexpr int p_ld() {
  return kOneStep + (sizeof(T) == 4 ? 8 : sizeof(T) == 2 ? 8 : 16);
}

// Eight consecutive entries of a staged P row as bf16 (RN from f32, as
// stored, int8 exactly), low index first.
__device__ __forceinline__ uint4 bf16x8(const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  const float4 y = *reinterpret_cast<const float4*>(p + 4);
  return make_uint4(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w),
                    pack_bf16(y.x, y.y), pack_bf16(y.z, y.w));
}
__device__ __forceinline__ uint4 bf16x8(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint4 bf16x8(const int8_t* p) {
  const char4 x = *reinterpret_cast<const char4*>(p);
  const char4 y = *reinterpret_cast<const char4*>(p + 4);
  return make_uint4(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w),
                    pack_bf16(y.x, y.y), pack_bf16(y.z, y.w));
}

// V in shared memory: bf16 under bf16 compute, fp32 under fp32, rows of
// v_rows entries plus padding.
template <bool BF16>
struct OneV {
  using type = float;
  static constexpr int pad = 1;
  static __device__ __forceinline__ float make(float x) { return x; }
};
template <>
struct OneV<true> {
  using type = __nv_bfloat16;
  static constexpr int pad = 8;
  static __device__ __forceinline__ __nv_bfloat16 make(float x) {
    return __float2bfloat16_rn(x);
  }
};

__host__ __device__ inline int64_t one_smem_bytes(int slice_rows, int v_rows,
                                                  int stages, bool bf16) {
  const int64_t v = bf16 ? (int64_t)kOneCols * (v_rows + 8) * 2
                         : (int64_t)kOneCols * (v_rows + 1) * 4;
  const int64_t converted = bf16 ? 2 * (int64_t)slice_rows * kPbLd * 2 : 0;
  return v + (int64_t)stages * slice_rows * kPRowBytes + converted +
         (int64_t)slice_rows * kELd * 4;
}

// The first live prototype from t on (n_protos when none is left).
__device__ __forceinline__ int next_live(const float* __restrict__ mask,
                                         int t, int n_protos) {
  while (t < n_protos && mask != nullptr && !(mask[t] > 0.5f)) ++t;
  return t;
}

// Where column c (0 .. 127) of a block's [V_1 .. V_B] tile comes from:
// arrival b0 + *a, channel *ch; false for a padding column.
__device__ __forceinline__ bool one_column(int c, int k, int n_arr,
                                           int col_tiles, int ctile, int* a,
                                           int* ch) {
  if (col_tiles == 1) {
    *a = c / k;
    *ch = c % k;
    return *a < n_arr;
  }
  *a = 0;
  *ch = ctile * kOneCols + c;
  return *ch < k;
}

template <typename T, bool BF16, int MT>
__global__ void __launch_bounds__(kOneThreads, 1)
assign_one_kernel(const float* __restrict__ v, const T* __restrict__ table,
                  const float* __restrict__ mask, float* __restrict__ partial,
                  int n_arrivals, int n_protos, int d, int k, int group,
                  int col_tiles, int n_groups, int v_rows, int stages,
                  int vec) {
  constexpr int H = 16 * MT;  // rows of P a slice
  constexpr int ld = p_ld<T>();
  using VT = typename OneV<BF16>::type;
  extern __shared__ __align__(16) unsigned char one_smem[];
  const int vld = v_rows + OneV<BF16>::pad;
  VT* vs = reinterpret_cast<VT*>(one_smem);
  unsigned char* ring = one_smem + (int64_t)kOneCols * vld * sizeof(VT);
  // bf16: two buffers of a step's P rows converted to bf16, [H][kPbLd].
  __nv_bfloat16* pb =
      reinterpret_cast<__nv_bfloat16*>(ring + stages * H * kPRowBytes);
  float* ebuf = reinterpret_cast<float*>(
      ring + stages * H * kPRowBytes + (BF16 ? 2 * H * kPbLd * 2 : 0));

  const int grp = blockIdx.x % n_groups;
  const int part = blockIdx.x / n_groups;
  const int ctile = part % col_tiles;
  const int r0 = (part / col_tiles) * H;
  const int b0 = grp * group;
  const int n_arr = col_tiles == 1 ? min(group, n_arrivals - b0) : 1;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int64_t d2 = (int64_t)d * d;
  const int ksteps = repro_ceil_div(d, kOneStep);
  const int chunk_steps = v_rows / kOneStep;
  const int n_chunks = repro_ceil_div(ksteps, chunk_steps);

  // Step ks of prototype t: P rows r0 .. r0 + H - 1, columns 64 ks ..
  // + 63, in the stored type; zero past d.
  auto stage_p = [&](int slot, int t, int ks) {
    T* dst = reinterpret_cast<T*>(ring + slot * H * kPRowBytes);
    const T* src = table + t * d2;
    const int c0 = ks * kOneStep;
    if (vec & 1) {
      constexpr int per = 16 / (int)sizeof(T);  // entries a copy
      constexpr int copies = kOneStep / per;    // copies a row
      for (int e = tid; e < H * copies; e += kOneThreads) {
        const int r = e / copies;
        const int col = c0 + (e % copies) * per;
        const int row = r0 + r;
        const int bytes =
            row < d && col < d ? min(16, (d - col) * (int)sizeof(T)) : 0;
        cp_async16_n(dst + r * ld + (e % copies) * per,
                     bytes ? src + (int64_t)row * d + col : src, bytes);
      }
    } else {
      for (int e = tid; e < H * kOneStep; e += kOneThreads) {
        const int r = e / kOneStep;
        const int col = c0 + e % kOneStep;
        const int row = r0 + r;
        dst[r * ld + e % kOneStep] =
            row < d && col < d ? src[(int64_t)row * d + col] : T{};
      }
    }
  };
  // Rows v_rows ch .. of V for the block's 128 columns, in the compute
  // type, transposed: vs[c][i].  V is read in its own order (the chunk's
  // rows of an arrival are contiguous), W consecutive channels a load
  // (float4 where k % 4 == 0 and V is 16-byte aligned), eight loads in
  // flight a thread; padding columns and rows past d are zero.
  auto stage_v_w = [&](int ch, auto per_load) {
    constexpr int W = decltype(per_load)::value;
    const int i0 = ch * v_rows;
    const int rows = min(v_rows, d - i0);
    const bool tiled = col_tiles > 1;
    const int width = tiled ? kOneCols : k;  // entries a source row
    const int loads = (tiled ? rows : n_arr * rows) * width / W;
    for (int f0 = 0; f0 < loads; f0 += 8 * kOneThreads) {
      float x[8][W];
      int at[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int f = (f0 + u * kOneThreads + tid) * W;
        const int r = f / width;
        const int a = tiled ? 0 : r / rows;
        const int i = tiled ? r : r % rows;
        const int cc = f % width;
        const int chn = tiled ? ctile * kOneCols + cc : cc;
        const bool live = f < loads * W && chn < k;
        at[u] = f < loads * W ? (tiled ? cc : a * k + cc) * vld + i : -1;
        const float* src = v + ((int64_t)(b0 + a) * d + i0 + i) * k + chn;
        if constexpr (W == 4) {
          const float4 q = live ? __ldg(reinterpret_cast<const float4*>(src))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
          x[u][0] = q.x;
          x[u][1] = q.y;
          x[u][2] = q.z;
          x[u][3] = q.w;
        } else {
          x[u][0] = live ? __ldg(src) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (at[u] >= 0)
#pragma unroll
          for (int w = 0; w < W; ++w)
            vs[at[u] + w * vld] = OneV<BF16>::make(x[u][w]);
    }
    const int live_cols = tiled ? kOneCols : n_arr * k;
    for (int e = tid; e < (kOneCols - live_cols) * v_rows; e += kOneThreads)
      vs[(live_cols + e / v_rows) * vld + e % v_rows] = OneV<BF16>::make(0.f);
    const int tail = v_rows - rows;
    for (int e = tid; e < live_cols * tail; e += kOneThreads)
      vs[(e / tail) * vld + rows + e % tail] = OneV<BF16>::make(0.f);
  };
  auto stage_v = [&](int ch) {
    if (vec & 2)
      stage_v_w(ch, std::integral_constant<int, 4>());
    else
      stage_v_w(ch, std::integral_constant<int, 1>());
  };

  // A thread's W entries, MT groups of 4: bf16, a warp owns columns
  // 8 warp .. + 7 (one n8 tile) x the slice's MT m16 tiles, group mt an
  // m16n8 fragment; fp32, warp w owns rows MT w .. and lane l columns l,
  // l + 32, l + 64, l + 96 (group i: row MT w + i).  Sixteen warps keep
  // the SM busy across the steps' short dependent phases.
  constexpr int kAcc = MT;
  auto entry_at = [&](int i, int e, int* row, int* col) {
    if constexpr (BF16) {
      *row = i * 16 + lane / 4 + 8 * (e / 2);
      *col = 8 * warp + 2 * (lane % 4) + e % 2;
    } else {
      *row = kAcc * warp + i;
      *col = lane + 32 * e;
    }
  };
  float acc[kAcc][4], sum[kAcc][4], vf[kAcc][4];
  // V in fp32 at this thread's entries, for the epilogue of every
  // prototype (0 past d and in padding columns).
#pragma unroll
  for (int i = 0; i < kAcc; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[i][e] = sum[i][e] = 0.f;
      int row, c, a, cc;
      entry_at(i, e, &row, &c);
      vf[i][e] = r0 + row < d && one_column(c, k, n_arr, col_tiles, ctile,
                                             &a, &cc)
                     ? __ldg(v + ((int64_t)(b0 + a) * d + r0 + row) * k + cc)
                     : 0.f;
    }

  int tc = next_live(mask, 0, n_protos);  // the prototype computed
  int tl = tc, kl = 0;                    // the step loaded next
  auto advance = [&]() {
    if (++kl == ksteps) {
      kl = 0;
      tl = next_live(mask, tl + 1, n_protos);
    }
  };
  for (int s = 0; s < stages - 1; ++s) {
    if (tl < n_protos) {
      stage_p(s, tl, kl);
      advance();
    }
    cp_async_commit();
  }
  // bf16: all threads convert a landed step's P rows to bf16 once, one
  // step ahead of its products (two buffers), which then read them with
  // ldmatrix.
  auto convert = [&](int slot, int buf) {
    const T* src = reinterpret_cast<const T*>(ring + slot * H * kPRowBytes);
    __nv_bfloat16* dst = pb + buf * H * kPbLd;
    for (int e = tid; e < H * kOneStep / 8; e += kOneThreads) {
      const int r = e / (kOneStep / 8);
      const int c = e % (kOneStep / 8) * 8;
      *reinterpret_cast<uint4*>(dst + r * kPbLd + c) = bf16x8(src + r * ld + c);
    }
  };
  if (BF16 && tc < n_protos) {
    cp_async_wait_n(stages - 2);  // step 0
    __syncthreads();
    convert(0, 0);
  }
  int ks = 0, q = 0;
  bool v_staged = false;
  while (tc < n_protos) {
    if (ks % chunk_steps == 0 && (n_chunks > 1 || !v_staged)) {
      __syncthreads();  // every warp is done with the previous chunk
      stage_v(ks / chunk_steps);
      v_staged = true;
    }
    // bf16: step q + 1 has landed (step q was converted last time round);
    // fp32: step q has landed.
    cp_async_wait_n(BF16 ? stages - 3 : stages - 2);
    __syncthreads();
    // The slot of step q - 1, which every warp has finished.
    if (tl < n_protos) {
      stage_p((q + stages - 1) % stages, tl, kl);
      advance();
    }
    cp_async_commit();

    const int kv0 = (ks % chunk_steps) * kOneStep;
    if constexpr (BF16) {
      // The next step (if any) into the other buffer, whose products
      // finished before the barrier.
      convert((q + 1) % stages, (q + 1) % 2);
      const __nv_bfloat16* pa = pb + (q % 2) * H * kPbLd;
#pragma unroll
      for (int j = 0; j < kOneStep / 16; j += 2) {
        // The warp's n8 tile at k16 steps j and j + 1, two k halves each.
        uint32_t b[4];
        ldmatrix_x4(b, vs + (8 * warp + lane % 8) * vld + kv0 + 16 * j +
                           8 * (lane / 8));
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a[4];
            ldmatrix_x4(a, pa + (mt * 16 + lane % 16) * kPbLd +
                               16 * (j + jj) + 8 * (lane / 16));
            mma_bf16(acc[mt], a, b[2 * jj], b[2 * jj + 1]);
          }
        }
      }
    } else {
      const T* ps =
          reinterpret_cast<const T*>(ring + (q % stages) * H * kPRowBytes);
      const T* pr = ps + kAcc * warp * ld;
      const float* vr = reinterpret_cast<const float*>(vs) + lane * vld + kv0;
#pragma unroll 4
      for (int kk = 0; kk < kOneStep; ++kk) {
        float x[4], p[kAcc];
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = vr[32 * e * vld + kk];
#pragma unroll
        for (int i = 0; i < kAcc; ++i) p[i] = to_float(pr[i * ld + kk]);
#pragma unroll
        for (int i = 0; i < kAcc; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(p[i], x[e], acc[i][e]);
      }
    }
    ++ks;
    ++q;
    // The tensor cores' fp32 sums truncate: fold a chain of at most
    // kOneFold steps (8 mma k-steps) into the IEEE register sum.
    if (ks == ksteps || (BF16 && ks % kOneFold == 0)) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sum[i][e] += acc[i][e];
          acc[i][e] = 0.f;
        }
    }
    if (ks < ksteps) continue;

    // Prototype tc is done: its W times V in fp32 into ebuf, then one
    // warp an arrival sums the slice's products.
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int row, c;
        entry_at(i, e, &row, &c);
        ebuf[row * kELd + c] = sum[i][e] * vf[i][e];
        sum[i][e] = 0.f;
      }
    __syncthreads();
    const int width = col_tiles == 1 ? k : kOneCols;
    for (int a = warp; a < n_arr; a += kOneThreads / 32) {
      float s = 0.f;
      for (int e = lane; e < H * width; e += 32)
        s += ebuf[(e / width) * kELd + (col_tiles == 1 ? a * k : 0) +
                  e % width];
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0)
        partial[((int64_t)part * n_arrivals + b0 + a) * n_protos + tc] = s;
    }
    ks = 0;
    tc = next_live(mask, tc + 1, n_protos);
  }
  cp_async_wait<0>();
}

// One warp an arrival: the partials of each live prototype added in slice
// order, the mask, the verdict on the raw sums, then aff / k and
// margin / k.
__global__ void __launch_bounds__(256)
assign_one_sum_kernel(const float* __restrict__ partial, int n_parts,
                      const float* __restrict__ mask, float* __restrict__ aff,
                      int* __restrict__ labels, float* __restrict__ margin,
                      int n_arrivals, int n_protos, int k) {
  const int b = blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (b >= n_arrivals) return;
  const int64_t plane = (int64_t)n_arrivals * n_protos;
  const float kf = (float)k;
  Verdict verdict;
  for (int t = lane; t < n_protos; t += 32) {
    float x = -INFINITY;
    if (mask == nullptr || mask[t] > 0.5f) {
      const float* p = partial + (int64_t)b * n_protos + t;
      x = p[0];
      for (int s = 1; s < n_parts; ++s) x += p[s * plane];
    }
    aff[(int64_t)b * n_protos + t] = __fdiv_rn(x, kf);
    verdict.take(x, t);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float ob = __shfl_xor_sync(0xffffffffu, verdict.best, off);
    const float os = __shfl_xor_sync(0xffffffffu, verdict.second, off);
    const int oa = __shfl_xor_sync(0xffffffffu, verdict.arg, off);
    verdict.merge(ob, os, oa);
  }
  if (lane == 0) {
    labels[b] = verdict.arg;
    margin[b] = __fdiv_rn(verdict.margin(n_protos), kf);
  }
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

template <typename T, bool BF16, int MT>
int launch_one_mt(const float* v, const void* table, const float* mask,
                  float* work, int n_arrivals, int n_protos, int d, int k,
                  int group, int col_tiles, int v_rows, int stages,
                  cudaStream_t stream) {
  const int64_t smem = one_smem_bytes(16 * MT, v_rows, stages, BF16);
  auto kernel = assign_one_kernel<T, BF16, MT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_groups = repro_ceil_div(n_arrivals, group);
  const int64_t blocks =
      (int64_t)n_groups * col_tiles * repro_ceil_div(d, 16 * MT);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  // Bit 0: P rows take 16-byte copies; bit 1: V takes 16-byte loads.
  const int vec = (((int64_t)d * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0) |
                  (k % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0) << 1;
  kernel<<<(unsigned)blocks, kOneThreads, (size_t)smem, stream>>>(
      v, static_cast<const T*>(table), mask, work, n_arrivals, n_protos, d,
      k, group, col_tiles, n_groups, v_rows, stages, vec);
  return (int)cudaGetLastError();
}

template <typename T, bool BF16>
int launch_one(int slice_rows, const float* v, const void* table,
               const float* mask, float* work, int n_arrivals, int n_protos,
               int d, int k, int group, int col_tiles, int v_rows,
               int stages, cudaStream_t s) {
  switch (slice_rows) {
    case 16:
      return launch_one_mt<T, BF16, 1>(v, table, mask, work, n_arrivals,
                                       n_protos, d, k, group, col_tiles,
                                       v_rows, stages, s);
    case 32:
      return launch_one_mt<T, BF16, 2>(v, table, mask, work, n_arrivals,
                                       n_protos, d, k, group, col_tiles,
                                       v_rows, stages, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool BF16>
int one_by_table(int table_type, int slice_rows, const float* v,
                 const void* table, const float* mask, float* work,
                 int n_arrivals, int n_protos, int d, int k, int group,
                 int col_tiles, int v_rows, int stages, cudaStream_t s) {
  switch (table_type) {
    case kF32:
      return launch_one<float, BF16>(slice_rows, v, table, mask, work,
                                     n_arrivals, n_protos, d, k, group,
                                     col_tiles, v_rows, stages, s);
    case kBF16:
      return launch_one<__nv_bfloat16, BF16>(slice_rows, v, table, mask,
                                             work, n_arrivals, n_protos, d, k,
                                             group, col_tiles, v_rows, stages,
                                             s);
    case kI8:
      return launch_one<int8_t, BF16>(slice_rows, v, table, mask, work,
                                      n_arrivals, n_protos, d, k, group,
                                      col_tiles, v_rows, stages, s);
  }
  return (int)cudaErrorInvalidValue;
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

}  // namespace

// Shared memory of an assign_one block with slices of slice_rows rows of
// P, V chunks of v_rows rows of d and a P ring of `stages` steps
// (kernels/assign/ops.py::one_plan computes the same); 0 when it does
// not fit a block.
REPRO_EXPORT int64_t repro_assign_one_smem(int slice_rows, int v_rows,
                                           int stages, int bf16) {
  const int64_t bytes =
      one_smem_bytes(slice_rows, v_rows, stages, bf16 != 0);
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

// The per-arrival form, no scales; same layouts, and a workspace
// (n_slices x col_tiles, B, T) fp32 for the partial sums.  Blocks: groups
// of `group` arrivals (group k <= 128; or one arrival in col_tiles tiles
// of 128 columns where k > 128) x slices of slice_rows (16 or 32)
// rows of P; V in chunks of v_rows (a multiple of 64) rows of d; a P ring
// of `stages` (3 to 5) steps.  Writes
// aff / k, labels and margin / k, with compute-type product inputs and
// fp32 sums.
REPRO_EXPORT int repro_assign_one(const float* v, const void* table,
                                  int table_type, const float* mask,
                                  float* workspace, float* aff, int* labels,
                                  float* margin, int n_arrivals,
                                  int n_protos, int d, int k, int group,
                                  int col_tiles, int slice_rows, int v_rows,
                                  int stages, int bf16, void* stream) {
  if (n_arrivals <= 0) return 0;
  const bool tiles_ok = k <= kOneCols
                            ? col_tiles == 1 && group >= 1 &&
                                  group * k <= kOneCols
                            : group == 1 &&
                                  col_tiles == repro_ceil_div(k, kOneCols);
  if (n_protos <= 0 || d <= 0 || k <= 0 || !tiles_ok || v_rows <= 0 ||
      v_rows % kOneStep || stages < 3 || stages > kOneMaxStages ||
      repro_assign_one_smem(slice_rows, v_rows, stages, bf16) == 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rc =
      bf16 ? one_by_table<true>(table_type, slice_rows, v, table, mask,
                                workspace, n_arrivals, n_protos, d, k, group,
                                col_tiles, v_rows, stages, s)
           : one_by_table<false>(table_type, slice_rows, v, table, mask,
                                 workspace, n_arrivals, n_protos, d, k, group,
                                 col_tiles, v_rows, stages, s);
  if (rc) return rc;
  const int n_parts = repro_ceil_div(d, slice_rows) * col_tiles;
  assign_one_sum_kernel<<<repro_ceil_div(n_arrivals, 8), 256, 0, s>>>(
      workspace, n_parts, mask, aff, labels, margin, n_arrivals, n_protos, k);
  return (int)cudaGetLastError();
}
