// assign_wave on the tensor cores, for bf16 compute (compute_dtype
// "bf16"); compute_dtype "fp32" keeps the CUDA-core kernel of assign.cu.
// The wrapper chooses by compute dtype alone.
//
// Replaces src/repro/kernels/assign/assign.py::assign_wave_pallas
// (pallas_call at :117): A = S P^T with S (B, d^2) the flattened wave
// projectors S_b = V_b V_b^T and P (T, d^2) the directory, stored in
// f32, bf16 or int8 (per-prototype scales applied in the epilogue), then
// the verdict.  Contract (as assign.cu's): s_ij = sum_c v_ic v_jc in
// fp32, c in order, each product and sum rounded on its own, then
// rounded to bf16 (RN), as the reference's astype; directory entries
// cast to bf16 (f32 by RN, int8 exactly); sums in fp32; dead prototypes
// -inf; the label is the first index of the maximum; the margin is best
// minus second, or best alone when T = 1.  The caller divides by k.
//
// Bound on the H100: 2 B d^2 k fp32 operations forming S (67 TFLOP/s)
// beside 2 B d^2 T on the bf16 tensor cores (989 TFLOP/s), against
// 4 B d k + s T d^2 + 4 B T bytes (s the stored width).  At the landmark
// shape (B = 1024, T = 128, d = 512, k = 8, f32 directory) that is
// 0.064 ms for S, 0.069 ms for the product and 0.045 ms of bytes.
//
// Design: split-K.  The output is only B x T (8 tiles of 128 x 128 at the
// landmark shape), so the d^2 axis is cut into slices and a block owns one
// (64-arrival tile, prototype tile of BN = 8, 32 or 128, slice).  The
// flattened d^2 axis is walked in K-steps of 64 entries, a 4-row x
// 16-column rectangle of S, column chunk by column chunk (K-step q: rows
// 4 (q % ceil(d/4)) .. + 3, columns 16 (q / ceil(d/4)) .. + 15); a slice
// is a run of consecutive K-steps (kernels/assign/ops.py::wave_plan,
// which the wrapper passes in).  Entries past d are 0 on both sides.  For
// each K-step:
//  - every thread forms 4 x 4 entries of one arrival's S on the fp32
//    cores and stores them as bf16 in a double-buffered shared tile
//    [64][64]: S never reaches device memory.  V comes from shared
//    memory, staged with coalesced cp.async: the 16 column rows of each
//    arrival once per column chunk, the 4 rows of each K-step in a ring
//    three K-steps ahead (a warp's threads serve 32 arrivals, whose V
//    lie 4 d k bytes apart: read by each thread from device memory, a
//    load would split into 32 transactions).  k outside {4, 8} reads V
//    through L1 instead;
//  - the directory's 4 x 16 rectangle of BN prototypes arrives through
//    cp.async (16-byte copies, zero-filled past T and d) into a ring of
//    three stages, in its stored type, two K-steps ahead;
//  - 8 warps multiply on mma.sync m16n8k16 (bf16 in, fp32 accumulators):
//    a warp owns 32 arrivals x BN / 2 prototypes and half the K-step's
//    k16 steps (at BN = 8: 32 arrivals x 8 and a quarter), reads S with
//    ldmatrix and builds its directory fragments from the staged entries,
//    casting f32 by RN and int8 exactly.
// One barrier a K-step: the S for K-step q + 1 is formed while other
// warps multiply K-step q.  Each warp folds its mma accumulators into a
// separate fp32 register sum every 4 K-steps (chains of at most 8 mma
// k-steps), so the tensor cores' accumulation never runs over a long
// sum.  At the end of its slice a block adds its warps' sums in a fixed
// order and writes them to the wrapper's workspace, partial[slice][b][t].
// The grid is ordered slice-major, so the arrival tiles of one slice run
// side by side and share its directory rectangles through L2: the
// directory is read from device memory about once.
//
// On the H100 this version stays far from its bound at the landmark
// shape: with one block (8 warps) an SM it is latency-bound, and staging
// the directory as 16-byte copies (2,048 a K-step at BN = 128, f32) is
// its largest single cost, ahead of forming S and the products.  TMA
// copies of whole rectangles, multicast to the arrival tiles of a
// cluster, are its next step.
//
// A second kernel, one warp per arrival, adds the partials in a fixed
// order (four interleaved runs over the slices, then their pairwise sum;
// no atomics: repeated runs are bit-identical), applies scale and
// liveness, writes the affinities and keeps the running (best, second,
// argmax) with strict '>' per lane, then merges the lanes' verdicts
// preferring the lower index on equal values, so the first index wins.
// Registers and spills of each instantiation: build.log (-Xptxas -v).
#include <cuda_bf16.h>

#include "common.cuh"
#include "mma.cuh"
#include "verdict.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;   // 8 warps
constexpr int kBlockM = 64;     // arrivals per block
constexpr int kStep = 64;       // entries per K-step: 4 rows x 16 columns
constexpr int kStepRows = 4;
constexpr int kStepCols = 16;
constexpr int kStages = 3;      // directory ring depth
constexpr int kFold = 4;        // K-steps between folds of the accumulators
constexpr int kSLd = kStep + 8; // S tile row, bf16 (16 bytes of padding)
constexpr int kReduceWarps = 8;
// V staged in shared memory for k in {4, 8} (other k read V through L1):
// a K-step's 4 rows and a column chunk's 16 rows of each arrival, padded
// by 16 bytes so that a warp's 32 arrivals miss each other's banks.
constexpr int kMaxStagedK = 8;
constexpr int kRowsLd = kStepRows * kMaxStagedK + 4;
constexpr int kColsLd = kStepCols * kMaxStagedK + 4;
constexpr int kRowStages = 3;   // ring of the K-steps' V rows

enum TableType { kF32 = 0, kBF16 = 1, kI8 = 2 };

// A staged directory row of one K-step, in entries of T: 64 plus padding
// (32 bytes for f32, 16 otherwise), so fragment reads miss each other's
// banks.
template <typename T>
__host__ __device__ constexpr int p_ld() {
  return kStep + (sizeof(T) == 4 ? 8 : 16 / (int)sizeof(T));
}

// S tiles [2][64][kSLd] bf16, V rows [kRowStages][64][kRowsLd] and V
// columns [64][kColsLd] fp32, then the directory stages (reused at the
// end for the warps' sums).
constexpr int kSBytes = 2 * kBlockM * kSLd * (int)sizeof(bf16);
constexpr int kVBytes =
    (kRowStages * kRowsLd + kColsLd) * kBlockM * (int)sizeof(float);

template <typename T, int BN>
__host__ __device__ constexpr int wave_smem_bytes() {
  constexpr int p_bytes = kStages * BN * p_ld<T>() * (int)sizeof(T);
  constexpr int kg = BN >= 16 ? 2 : 4;
  constexpr int red_bytes = kg * kBlockM * BN * (int)sizeof(float);
  return kSBytes + kVBytes + (p_bytes > red_bytes ? p_bytes : red_bytes);
}

// Two consecutive staged entries as a bf16 pair: f32 by RN, bf16 as
// stored, int8 exactly.
__device__ __forceinline__ uint32_t pair(const float* p) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  return pack_bf16(x.x, x.y);
}
__device__ __forceinline__ uint32_t pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pair(const int8_t* p) {
  const char2 x = *reinterpret_cast<const char2*>(p);
  return pack_bf16((float)x.x, (float)x.y);
}

// Directory rectangle of K-step (i0, j0) for prototypes p0 .. p0 + BN - 1
// into one stage [BN][p_ld]: 16-byte cp.async where a chunk is whole (or
// wholly past T or d, zero-filled), element copies at a ragged edge.
template <typename T, int BN>
__device__ __forceinline__ void stage_directory(
    const T* __restrict__ table, T* dst, int p0, int n_protos, int d,
    int i0, int j0, bool vec) {
  constexpr int EPC = 16 / (int)sizeof(T);          // entries per chunk
  constexpr int CPR = kStepCols / EPC;              // chunks per row
  constexpr int PLD = p_ld<T>();
  const int64_t d2 = (int64_t)d * d;
  for (int e = threadIdx.x; e < BN * kStepRows * CPR; e += kThreads) {
    const int n = e / (kStepRows * CPR);
    const int r = (e / CPR) % kStepRows;
    const int ch = e % CPR;
    const int t = p0 + n, i = i0 + r, j = j0 + ch * EPC;
    T* out = dst + n * PLD + r * kStepCols + ch * EPC;
    const bool live = t < n_protos && i < d;
    const T* src = table + (live ? t * d2 + (int64_t)i * d + j : 0);
    const bool whole = live && j + EPC <= d;
    const bool none = !live || j >= d;
    if (vec && (whole || none)) {
      cp_async16(out, src, whole);
    } else {
#pragma unroll
      for (int u = 0; u < EPC; ++u)
        out[u] = live && j + u < d ? src[u] : T{};
    }
  }
}

// `n` rows of k fp32 values of each of the block's arrivals, from row
// `first` on, into dst [64][ld] with 16-byte cp.async (k % 4 == 0);
// rows past d and arrivals past the wave are zero-filled.
__device__ __forceinline__ void stage_v(const float* __restrict__ v,
                                        float* dst, int ld, int n, int b0,
                                        int n_arrivals, int d, int k,
                                        int first) {
  const int cpr = k / 4;  // chunks per row
  for (int e = threadIdx.x; e < kBlockM * n * cpr; e += kThreads) {
    const int a = e / (n * cpr);
    const int w = e % (n * cpr);
    const int r = w / cpr;
    const bool live = b0 + a < n_arrivals && first + r < d;
    const float* src =
        v + (live ? ((int64_t)(b0 + a) * d + first + r) * k + 4 * (w % cpr)
                  : 0);
    cp_async16(dst + a * ld + 4 * w, src, live);
  }
}

// s[r][c] += sum over four consecutive c of a[r] b[c], each product and
// sum rounded on its own, in order.
__device__ __forceinline__ void accumulate4(float (&s)[kStepRows][4],
                                            const float4 (&a)[kStepRows],
                                            const float4 (&b)[4]) {
#pragma unroll
  for (int r = 0; r < kStepRows; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float x = s[r][c];
      x = __fadd_rn(x, __fmul_rn(a[r].x, b[c].x));
      x = __fadd_rn(x, __fmul_rn(a[r].y, b[c].y));
      x = __fadd_rn(x, __fmul_rn(a[r].z, b[c].z));
      x = __fadd_rn(x, __fmul_rn(a[r].w, b[c].w));
      s[r][c] = x;
    }
}

// This thread's entries as bf16 (RN) at row fb of the S tile.
__device__ __forceinline__ void store_s(bf16* tile, int fb, int fq,
                                        const float (&s)[kStepRows][4]) {
#pragma unroll
  for (int r = 0; r < kStepRows; ++r)
    *reinterpret_cast<uint2*>(tile + fb * kSLd + r * kStepCols + 4 * fq) =
        make_uint2(pack_bf16(s[r][0], s[r][1]), pack_bf16(s[r][2], s[r][3]));
}

// This thread's 4 x 4 entries of S for one arrival (rows i0 .. i0 + 3,
// columns j0 + 4 fq .. + 3), each s_ij = sum_c v_ic v_jc, from V staged in
// shared memory: `rows` holds the 4 rows, `cols` the column chunk's 16.
__device__ __forceinline__ void form_s_staged(const float* rows,
                                              const float* cols, bf16* tile,
                                              int fb, int fq, int k) {
  float s[kStepRows][4] = {};
#pragma unroll
  for (int c4 = 0; c4 < kMaxStagedK; c4 += 4) {
    if (c4 >= k) break;
    float4 a[kStepRows], b[4];
#pragma unroll
    for (int r = 0; r < kStepRows; ++r)
      a[r] = *reinterpret_cast<const float4*>(rows + r * k + c4);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      b[c] = *reinterpret_cast<const float4*>(cols + (4 * fq + c) * k + c4);
    accumulate4(s, a, b);
  }
  store_s(tile, fb, fq, s);
}

// The same entries with V read from device memory through L1, for any k
// (vec: k % 4 == 0 and V 16-byte aligned).
__device__ __forceinline__ void form_s_global(const float* __restrict__ vb,
                                              bool live, bf16* tile, int fb,
                                              int fq, int d, int k, int i0,
                                              int j0, bool vec) {
  float s[kStepRows][4] = {};
  const int jb = j0 + 4 * fq;
  if (live && vec) {
    for (int c4 = 0; c4 < k; c4 += 4) {
      float4 a[kStepRows], b[4];
#pragma unroll
      for (int r = 0; r < kStepRows; ++r)
        a[r] = i0 + r < d ? __ldg(reinterpret_cast<const float4*>(
                                vb + (int64_t)(i0 + r) * k + c4))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        b[c] = jb + c < d ? __ldg(reinterpret_cast<const float4*>(
                                vb + (int64_t)(jb + c) * k + c4))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      accumulate4(s, a, b);
    }
  } else if (live) {
    for (int cc = 0; cc < k; ++cc) {
      float a[kStepRows], b[4];
#pragma unroll
      for (int r = 0; r < kStepRows; ++r)
        a[r] = i0 + r < d ? __ldg(vb + (int64_t)(i0 + r) * k + cc) : 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        b[c] = jb + c < d ? __ldg(vb + (int64_t)(jb + c) * k + cc) : 0.f;
#pragma unroll
      for (int r = 0; r < kStepRows; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[r][c] = __fadd_rn(s[r][c], __fmul_rn(a[r], b[c]));
    }
  }
  store_s(tile, fb, fq, s);
}

// One block resident on each SM at BN = 128 (about 224 registers a
// thread), two below (at most 128): kernels/assign/ops.py::wave_plan
// sizes the split for as many.
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, BN >= 128 ? 1 : 2)
assign_wave_tc_kernel(const float* __restrict__ v,
                      const T* __restrict__ table,
                      float* __restrict__ partial, int n_arrivals,
                      int n_protos, int d, int k, int ksteps_per_slice,
                      int m_tiles, int n_tiles) {
  constexpr int NG = BN >= 16 ? 2 : 1;  // warps across the prototypes
  constexpr int KG = 4 / NG;            // warps across a K-step's k16 steps
  constexpr int NTW = BN / 8 / NG;      // n8 tiles per warp
  constexpr int PLD = p_ld<T>();
  extern __shared__ __align__(16) unsigned char wave_tc_smem[];
  bf16* s_tiles = reinterpret_cast<bf16*>(wave_tc_smem);  // [2][64][kSLd]
  float* v_rows = reinterpret_cast<float*>(wave_tc_smem + kSBytes);
  float* v_cols = v_rows + kRowStages * kBlockM * kRowsLd;
  T* p_stages = reinterpret_cast<T*>(wave_tc_smem + kSBytes + kVBytes);
  float* red = reinterpret_cast<float*>(p_stages);  // [KG][64][BN], at the end

  const int mt = blockIdx.x % m_tiles;
  const int nt = (blockIdx.x / m_tiles) % n_tiles;
  const int slice = blockIdx.x / (m_tiles * n_tiles);
  const int b0 = mt * kBlockM;
  const int p0 = nt * BN;
  const int row_steps = repro_ceil_div(d, kStepRows);
  const int ksteps = row_steps * repro_ceil_div(d, kStepCols);
  const int q_begin = slice * ksteps_per_slice;
  const int nq = min(ksteps, q_begin + ksteps_per_slice) - q_begin;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int fb = tid % kBlockM, fq = tid / kBlockM;  // forming S
  const bool live_b = b0 + fb < n_arrivals;
  const float* vb = v + (int64_t)(b0 + fb) * d * k;
  const bool vec_v =
      (k & 3) == 0 && (reinterpret_cast<uintptr_t>(v) & 15) == 0;
  const bool staged = vec_v && k <= kMaxStagedK;
  const bool vec_p = ((int64_t)d * (int64_t)sizeof(T)) % 16 == 0 &&
                     (reinterpret_cast<uintptr_t>(table) & 15) == 0;
  // K-step q of the slice: column chunk (q_begin + q) / row_steps, row
  // group (q_begin + q) % row_steps.
  auto row0 = [&](int q) { return ((q_begin + q) % row_steps) * kStepRows; };
  auto col0 = [&](int q) { return ((q_begin + q) / row_steps) * kStepCols; };
  auto stage_p = [&](int q) {
    stage_directory<T, BN>(table, p_stages + (q % kStages) * BN * PLD, p0,
                           n_protos, d, row0(q), col0(q), vec_p);
  };
  auto stage_rows = [&](int q) {
    stage_v(v, v_rows + (q % kRowStages) * kBlockM * kRowsLd, kRowsLd,
            kStepRows, b0, n_arrivals, d, k, row0(q));
  };
  auto form = [&](int q) {
    bf16* tile = s_tiles + (q & 1) * kBlockM * kSLd;
    if (staged)
      form_s_staged(v_rows + ((q % kRowStages) * kBlockM + fb) * kRowsLd,
                    v_cols + fb * kColsLd, tile, fb, fq, k);
    else
      form_s_global(vb, live_b, tile, fb, fq, d, k, row0(q), col0(q),
                    vec_v);
  };

  // Copies run ahead in groups: the group committed at K-step q holds the
  // directory of q + 2 and the V rows of q + 3 (S for q + 1 is formed
  // during K-step q); the prologue's two groups hold what K-steps 0-2
  // need, and the first column chunk.
  if (nq > 0) {
    stage_p(0);
    if (staged) {
      stage_rows(0);
      if (nq > 1) stage_rows(1);
      stage_v(v, v_cols, kColsLd, kStepCols, b0, n_arrivals, d, k, col0(0));
    }
  }
  cp_async_commit();
  if (nq > 1) stage_p(1);
  if (staged && nq > 2) stage_rows(2);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  if (nq > 0) form(0);

  const int mg = warp & 1;          // arrivals 32 mg .. + 31
  const int ng = (warp >> 1) % NG;  // prototypes ng NTW 8 .. + NTW 8 - 1
  const int kg = (warp >> 1) / NG;  // k16 steps kg, kg + KG, ...
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int g = lane >> 2, c = 2 * (lane & 3);
  float acc[2][NTW][4], sum[2][NTW][4];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mf][n][e] = sum[mf][n][e] = 0.f;
  auto fold = [&]() {
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int n = 0; n < NTW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sum[mf][n][e] += acc[mf][n][e];
          acc[mf][n][e] = 0.f;
        }
  };

  for (int it = 0; it < nq; ++it) {
    cp_async_wait<1>();  // the directory of it, the V rows of it + 1
    __syncthreads();     // S(it) is formed; K-step it - 1 is done
    if (staged && it + 1 < nq && col0(it + 1) != col0(it)) {
      // A new column chunk: its V columns, once for its row groups.
      stage_v(v, v_cols, kColsLd, kStepCols, b0, n_arrivals, d, k,
              col0(it + 1));
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    if (it + 2 < nq) stage_p(it + 2);
    if (staged && it + 3 < nq) stage_rows(it + 3);
    cp_async_commit();
    if (it + 1 < nq) form(it + 1);
    const bf16* st = s_tiles + (it & 1) * kBlockM * kSLd;
    const T* pt = p_stages + (it % kStages) * BN * PLD;
#pragma unroll
    for (int r = kg; r < kStepRows; r += KG) {
      uint32_t a[2][4];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
        ldmatrix_x4(a[mf], st + (mg * 32 + mf * 16 + a_row) * kSLd +
                               r * kStepCols + a_col);
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const T* row = pt + ((ng * NTW + n) * 8 + g) * PLD + r * kStepCols + c;
        const uint32_t b0f = pair(row), b1f = pair(row + 8);
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) mma_bf16(acc[mf][n], a[mf], b0f, b1f);
      }
    }
    if ((it + 1) % kFold == 0) fold();
  }
  fold();
  cp_async_wait<0>();
  __syncthreads();  // the stages are free: reuse them for the warps' sums

#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = mg * 32 + mf * 16 + g + (e >> 1) * 8;
        const int col = (ng * NTW + n) * 8 + c + (e & 1);
        red[(kg * kBlockM + row) * BN + col] = sum[mf][n][e];
      }
  __syncthreads();
  for (int e = tid; e < kBlockM * BN; e += kThreads) {
    const int row = e / BN, col = e % BN;
    const int b = b0 + row, t = p0 + col;
    if (b >= n_arrivals || t >= n_protos) continue;
    float x = red[row * BN + col];
#pragma unroll
    for (int q = 1; q < KG; ++q) x += red[(q * kBlockM + row) * BN + col];
    partial[((int64_t)slice * n_arrivals + b) * n_protos + t] = x;
  }
}

__global__ void __launch_bounds__(kReduceWarps * 32)
assign_reduce_kernel(const float* __restrict__ partial, int n_slices,
                     const float* __restrict__ scales,
                     const float* __restrict__ mask, float* __restrict__ aff,
                     int* __restrict__ labels, float* __restrict__ margin,
                     int n_arrivals, int n_protos) {
  const int b = blockIdx.x * kReduceWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (b >= n_arrivals) return;
  Verdict verdict;
  const int64_t plane = (int64_t)n_arrivals * n_protos;
  for (int t = lane; t < n_protos; t += 32) {
    const float* p = partial + (int64_t)b * n_protos + t;
    // Four interleaved runs over the slices keep loads in flight; they
    // are added in a fixed order, so repeated runs give the same bits.
    float r[4] = {0.f, 0.f, 0.f, 0.f};
    int s = 0;
#pragma unroll 2
    for (; s + 4 <= n_slices; s += 4)
#pragma unroll
      for (int u = 0; u < 4; ++u) r[u] += p[(s + u) * plane];
    for (; s < n_slices; ++s) r[0] += p[s * plane];
    float x = (r[0] + r[1]) + (r[2] + r[3]);
    if (scales != nullptr) x *= scales[t];
    if (mask != nullptr && !(mask[t] > 0.5f)) x = -INFINITY;
    aff[(int64_t)b * n_protos + t] = x;
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
    margin[b] = verdict.margin(n_protos);
  }
}

template <typename T, int BN>
int launch_wave(const float* v, const void* table, float* partial,
                int n_arrivals, int n_protos, int d, int k, int n_slices,
                int ksteps_per_slice, cudaStream_t stream) {
  constexpr int smem = wave_smem_bytes<T, BN>();
  auto kernel = assign_wave_tc_kernel<T, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int m_tiles = repro_ceil_div(n_arrivals, kBlockM);
  const int n_tiles = repro_ceil_div(n_protos, BN);
  const int64_t blocks = (int64_t)m_tiles * n_tiles * n_slices;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, (size_t)smem, stream>>>(
      v, static_cast<const T*>(table), partial, n_arrivals, n_protos, d, k,
      ksteps_per_slice, m_tiles, n_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wave_bn(int block_n, const float* v, const void* table,
                   float* partial, int n_arrivals, int n_protos, int d, int k,
                   int n_slices, int ksteps_per_slice, cudaStream_t stream) {
  switch (block_n) {
    case 8:
      return launch_wave<T, 8>(v, table, partial, n_arrivals, n_protos, d, k,
                               n_slices, ksteps_per_slice, stream);
    case 32:
      return launch_wave<T, 32>(v, table, partial, n_arrivals, n_protos, d,
                                k, n_slices, ksteps_per_slice, stream);
    case 128:
      return launch_wave<T, 128>(v, table, partial, n_arrivals, n_protos, d,
                                 k, n_slices, ksteps_per_slice, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// v (B, d, k) fp32; table (T, d, d) f32 (table_type 0), bf16 (1) or int8
// (2); scales (T,) fp32 or null (all 1); mask (T,) fp32 or null (all
// live), live where > 0.5; workspace (n_slices, B, T) fp32.  All
// contiguous.  block_n in {8, 32, 128}; the slices of ksteps_per_slice
// K-steps must cover ceil(d / 4) x ceil(d / 16) K-steps.  Writes the raw
// aff (B, T) fp32, labels (B,) int32 and margin (B,) fp32, with bf16
// product inputs and fp32 sums.
REPRO_EXPORT int repro_assign_wave_tc(const float* v, const void* table,
                                      int table_type, const float* scales,
                                      const float* mask, float* workspace,
                                      float* aff, int* labels, float* margin,
                                      int n_arrivals, int n_protos, int d,
                                      int k, int block_n, int n_slices,
                                      int ksteps_per_slice, void* stream) {
  if (n_arrivals <= 0) return 0;
  const int64_t ksteps = (int64_t)repro_ceil_div(d, kStepRows) *
                         repro_ceil_div(d, kStepCols);
  if (n_protos <= 0 || d <= 0 || k <= 0 || n_slices <= 0 ||
      ksteps_per_slice <= 0 ||
      (int64_t)n_slices * ksteps_per_slice < ksteps ||
      (int64_t)(n_slices - 1) * ksteps_per_slice >= ksteps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = (int)cudaErrorInvalidValue;
  switch (table_type) {
    case kF32:
      rc = launch_wave_bn<float>(block_n, v, table, workspace, n_arrivals,
                                 n_protos, d, k, n_slices, ksteps_per_slice,
                                 s);
      break;
    case kBF16:
      rc = launch_wave_bn<bf16>(block_n, v, table, workspace, n_arrivals,
                                n_protos, d, k, n_slices, ksteps_per_slice, s);
      break;
    case kI8:
      rc = launch_wave_bn<int8_t>(block_n, v, table, workspace, n_arrivals,
                                  n_protos, d, k, n_slices, ksteps_per_slice,
                                  s);
      break;
  }
  if (rc) return rc;
  assign_reduce_kernel<<<repro_ceil_div(n_arrivals, kReduceWarps),
                         kReduceWarps * 32, 0, s>>>(
      workspace, n_slices, scales, mask, aff, labels, margin, n_arrivals,
      n_protos);
  return (int)cudaGetLastError();
}
