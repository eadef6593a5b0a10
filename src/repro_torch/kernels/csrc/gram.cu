// Batched Gram kernel: out[u] = X[u]^T X[u] (optionally / max(n_valid[u], 1))
// for X (N, n, d) fp32, on the TF32 tensor cores through wgmma.
//
// Replaces src/repro/kernels/gram/gram.py::gram_pallas (pallas_call at
// :48), which the reference vmaps over users in similarity.batched_gram.
//
// Contract: fp32 in, fp32 out.  The products run as 3xTF32 (mma.cuh: a =
// hi + lo, a b = lo hi + hi lo + hi hi, each term exact in the tensor
// cores' fp32 accumulators), so the result keeps about fp32's accuracy.
// The Gram is symmetric bit for bit, and each output entry is written by
// one thread from one sum: no atomics, two runs give the same bits.  With
// n_valid the epilogue divides by max(n_valid[u], 1) in IEEE fp32, which
// gives the bits of the division done after the kernel.
//
// Bound on the H100 at the dense path's shape (N = 1024, n = 256, d =
// 512): the function needs N n d (d + 1) = 68.9 GFLOP (one triangle and
// its diagonal, as a syrk counts it); as 3xTF32 that is 207 GFLOP at 495
// TFLOP/s, 0.417 ms.  It moves 0.54 GB of X in and 1.07 GB of Grams out,
// 0.480 ms at 3.35 TB/s: the bytes bind.
//
// Design:
//  - One triangle of 128 x 128 output tiles.  A block owns one tile pair
//    (I, J) with I <= J (10 of a d = 512 user's 16); blocks are ordered
//    user-major, so a user's pairs run side by side and its X is read
//    from device memory once and from L2 after that.  An off-diagonal
//    pair stores its tile at (I, J) and its transpose at (J, I); a
//    diagonal pair stores entry (i, j), i <= j, at both places.  Both go
//    through shared memory so that every store is a coalesced 16-byte
//    write (4-byte where d % 4 != 0).  The pair list and the shared
//    memory are kernels/gram/ops.py::gram_plan's.
//  - A producer warp keeps two 32-row stages of the two column slabs of
//    X (one for a diagonal pair) in flight, with mbarriers: TMA copies of
//    a 3-D tensor map (zero-filled past n and d) where the row pitch 4 d
//    is a multiple of 16 bytes, else 4-byte cp.async with zero fill.
//  - Two consumer warpgroups split each landed stage once: every element
//    is read once, split into TF32 hi and lo, and written back K-major
//    (the n axis contiguous, as wgmma takes TF32 operands) in the 128-byte
//    swizzle the descriptors name.  Each warpgroup then issues
//    wgmma.mma_async m64n128k8 .tf32 on its 64 output rows, three a
//    k-step (lo hi, hi lo, hi hi), from shared memory; the split of stage
//    s + 1 overlaps the products of stage s (two split buffers, one
//    barrier a stage).
//  - Every 64 rows of n (24 wgmma a chain) a warpgroup folds its
//    accumulators into an IEEE fp32 register sum: the tensor cores' fp32
//    accumulation truncates, and a long chain drifts.
#include <string.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kTile = 128;                  // output tile edge
constexpr int kBK = 32;                     // rows of X a stage
constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kChain = 2;                   // stages (64 rows) a chain
constexpr int kSlab = kBK * kTile * 4;      // 16 KB: a raw slab, or one
                                            // split operand (128 x 128 B)
constexpr int kSplitStage = 4 * kSlab;      // A hi, A lo, B hi, B lo
constexpr int kRawStage = 2 * kSlab;        // slab I, slab J
constexpr int kRawOff = 2 * kSplitStage;    // two split stages first
constexpr int kBarOff = kRawOff + 2 * kRawStage;
// Barriers (four mbarriers), then slack to align the base to 1024 bytes,
// as the 128-byte swizzle needs.
constexpr int kSmemBytes = kBarOff + 64 + 1024;
// Epilogue staging, over the drained ring: the tile [i][j] and its
// transpose [j][i], rows padded so that fragment writes miss each
// other's banks.
constexpr int kSLd = kTile + 8;
constexpr int kTLd = kTile + 4;
static_assert(kTile * (kSLd + kTLd) * 4 <= kBarOff, "staging fits the ring");

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// -- the kernel -----------------------------------------------------------

// Tile pair p of a user in gram_plan's order: (0, 0), (0, 1), ..., (1, 1),
// (1, 2), ...
__device__ __forceinline__ void pair_of(int p, int tiles, int& i, int& j) {
  i = 0;
  while (p >= tiles - i) {
    p -= tiles - i;
    ++i;
  }
  j = i + p;
}

// Splits one landed slab raw[r][c] (32 rows of n x 128 columns of d) into
// K-major hi and lo operands: column c becomes row c of 128 bytes (32
// TF32 values along n), its 16-byte chunk q at position q ^ (c % 8).  A
// thread takes four consecutive rows of one column a pass: the raw reads
// of a warp are 32 consecutive words, and its 16-byte stores of one pass
// land in 8 distinct chunk positions per 8 lanes.
__device__ __forceinline__ void split_slab(const float* raw, char* hi,
                                           char* lo, int ct) {
#pragma unroll
  for (int pass = 0; pass < kBK * kTile / 4 / kConsumers; ++pass) {
    const int e = ct + pass * kConsumers;
    const int c = e % kTile;
    const int q = e / kTile;
    uint32_t h[4], l[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_tf32(raw[(4 * q + r) * kTile + c], h[r], l[r]);
    const int off = c * 128 + ((q ^ (c % 8)) << 4);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// Four consecutive entries of an output row from column col; entries
// from d on are skipped.  vec: 16-byte stores (d % 4 == 0).
__device__ __forceinline__ void store4(float* row_ptr, int col, int d,
                                       bool vec, float4 v) {
  if (col >= d) return;
  if (vec) {
    *reinterpret_cast<float4*>(row_ptr + col) = v;
    return;
  }
  const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (col + q < d) row_ptr[col + q] = x[q];
}

__global__ void __launch_bounds__(kThreads, 1)
gram_kernel(const __grid_constant__ CUtensorMap map,
            const float* __restrict__ x, float* __restrict__ out,
            const float* __restrict__ n_valid, int n, int d, int tiles,
            int pairs, int tma) {
  extern __shared__ __align__(1024) unsigned char gram_smem[];
  unsigned char* smem =
      gram_smem + ((1024 - (smem_addr(gram_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* empty = full + 2;

  const int64_t user = blockIdx.x / pairs;
  int ti, tj;
  pair_of((int)(blockIdx.x - user * pairs), tiles, ti, tj);
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  const bool diag = ti == tj;
  const int stages = repro_ceil_div(n, kBK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], tma ? 1 : 32);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer warp: stage s into raw slot s % 2 once the consumers have
    // released it.
    const int lane = threadIdx.x % 32;
    const float* xu = x + user * (int64_t)n * d;
    for (int s = 0; s < stages; ++s) {
      const int slot = s % 2;
      mbar_wait(&empty[slot], ((s / 2) & 1) ^ 1);
      float* raw = reinterpret_cast<float*>(smem + kRawOff + slot * kRawStage);
      if (tma) {
        if (lane == 0) {
          mbar_expect_tx(&full[slot], diag ? kSlab : 2 * kSlab);
          tma_load_3d(raw, &map, &full[slot], i0, s * kBK, (int)user);
          if (!diag)
            tma_load_3d(raw + kBK * kTile, &map, &full[slot], j0, s * kBK,
                        (int)user);
        }
      } else {
        for (int e = lane; e < kBK * kTile; e += 32) {
          const int row = s * kBK + e / kTile;
          const int c = e % kTile;
          const float* src = xu + (int64_t)row * d;
          const bool in_row = row < n;
          cp_async4(raw + e, in_row && i0 + c < d ? src + i0 + c : xu,
                    in_row && i0 + c < d);
          if (!diag)
            cp_async4(raw + kBK * kTile + e,
                      in_row && j0 + c < d ? src + j0 + c : xu,
                      in_row && j0 + c < d);
        }
        cp_async_mbar_arrive(&full[slot]);
      }
    }
    if (!tma) cp_async_wait<0>();
    return;
  }

  // Consumers: warpgroup wg owns output rows 64 wg .. 64 wg + 63.
  const int ct = threadIdx.x;
  const int wg = ct / 128;
  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.f;

  for (int s = 0; s < stages; ++s) {
    const int slot = s % 2;
    mbar_wait(&full[slot], (s / 2) & 1);
    char* sp = reinterpret_cast<char*>(smem) + (s % 2) * kSplitStage;
    const float* raw =
        reinterpret_cast<const float*>(smem + kRawOff + slot * kRawStage);
    split_slab(raw, sp, sp + kSlab, ct);
    if (!diag)
      split_slab(raw + kBK * kTile, sp + 2 * kSlab, sp + 3 * kSlab, ct);
    __syncwarp();
    if (ct % 32 == 0) mbar_arrive(&empty[slot]);
    fence_proxy_async();
    if (s > 0) {
      // Stage s - 1's products are done; its split buffer is free once
      // every consumer is past the barrier below.
      wgmma_wait_all();
      fence_acc(acc);
      if ((s - 1) % kChain == kChain - 1) {
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] += acc[i];
      }
    }
    consumer_sync();
    fence_acc(acc);
    wgmma_fence();
    const char* a_hi = sp + wg * (kSlab / 2);
    const char* a_lo = sp + kSlab + wg * (kSlab / 2);
    const char* b_hi = diag ? sp : sp + 2 * kSlab;
    const char* b_lo = diag ? sp + kSlab : sp + 3 * kSlab;
    const uint64_t dah = desc_sw128(a_hi), dal = desc_sw128(a_lo);
    const uint64_t dbh = desc_sw128(b_hi), dbl = desc_sw128(b_lo);
    const int first = s % kChain == 0;
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      wgmma_tf32(acc, dal + 2 * kk, dbh + 2 * kk, first && kk == 0 ? 0 : 1);
      wgmma_tf32(acc, dah + 2 * kk, dbl + 2 * kk, 1);
      wgmma_tf32(acc, dah + 2 * kk, dbh + 2 * kk, 1);
    }
    wgmma_commit();
  }
  if (stages > 0) {
    wgmma_wait_all();
    fence_acc(acc);
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] += acc[i];
  }
  if (n_valid != nullptr) {
    const float nv = fmaxf(n_valid[user], 1.f);
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = __fdiv_rn(sum[i], nv);
  }

  // Epilogue: the tile and its transpose into shared memory (the ring is
  // drained: every stage landed and every product is done), then
  // coalesced rows out.  Fragment of m64n128: value 4 q + 2 h + e is row
  // 16 warp + lane / 4 + 8 h, column 8 q + 2 (lane % 4) + e.
  consumer_sync();
  float* st = reinterpret_cast<float*>(smem);
  float* tt = st + kTile * kSLd;
  const int lane = ct % 32;
  const int r0 = 64 * wg + 16 * ((ct % 128) / 32) + lane / 4;
  const int c0 = 2 * (lane % 4);
#pragma unroll
  for (int q = 0; q < 16; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const int c = 8 * q + c0;
      const float x0 = sum[4 * q + 2 * h];
      const float x1 = sum[4 * q + 2 * h + 1];
      *reinterpret_cast<float2*>(&st[r * kSLd + c]) = make_float2(x0, x1);
      tt[c * kTLd + r] = x0;
      tt[(c + 1) * kTLd + r] = x1;
    }
  }
  consumer_sync();
  float* ou = out + user * (int64_t)d * d;
  const bool vec = d % 4 == 0;
  const int col = 4 * lane;
  for (int r = ct / 32; r < kTile; r += kConsumers / 32) {
    const float4 sv = *reinterpret_cast<const float4*>(&st[r * kSLd + col]);
    const float4 tv = *reinterpret_cast<const float4*>(&tt[r * kTLd + col]);
    if (diag) {
      // Entry (r, col + q) from the upper triangle: (r, c) where r <= c,
      // else the transpose's (r, c), which holds (c, r).
      if (i0 + r < d)
        store4(ou + (int64_t)(i0 + r) * d, i0 + col, d, vec,
               make_float4(r <= col ? sv.x : tv.x, r <= col + 1 ? sv.y : tv.y,
                           r <= col + 2 ? sv.z : tv.z,
                           r <= col + 3 ? sv.w : tv.w));
    } else {
      if (i0 + r < d) store4(ou + (int64_t)(i0 + r) * d, j0 + col, d, vec, sv);
      if (j0 + r < d) store4(ou + (int64_t)(j0 + r) * d, i0 + col, d, vec, tv);
    }
  }
}

}  // namespace

// Shared memory of a gram block (the same at every d); the tile pairs a
// user has, and the load route (1: TMA, 0: 4-byte cp.async), through the
// pointers.  kernels/gram/ops.py::gram_plan computes the same.
REPRO_EXPORT int64_t repro_gram_plan(int d, int* pairs, int* tma) {
  const int tiles = repro_ceil_div(d, kTile);
  *pairs = tiles * (tiles + 1) / 2;
  *tma = (4 * d) % 16 == 0;
  return kSmemBytes;
}

// x (n_users, n, d) fp32 contiguous, 16-byte aligned where 4 d % 16 == 0;
// n_valid (n_users,) fp32 or null -> out (n_users, d, d) fp32, divided by
// max(n_valid, 1) where n_valid is given.
REPRO_EXPORT int repro_gram(const float* x, float* out, const float* n_valid,
                            int n_users, int n, int d, void* stream) {
  if (n_users <= 0 || d <= 0) return 0;
  if (n < 0) return (int)cudaErrorInvalidValue;
  int pairs = 0, tma = 0;
  repro_gram_plan(d, &pairs, &tma);
  const int64_t blocks = (int64_t)n_users * pairs;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (tma && n > 0) {
    if (reinterpret_cast<uintptr_t>(x) % 16)
      return (int)cudaErrorMisalignedAddress;
    const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n,
                                (cuuint64_t)n_users};
    const cuuint64_t strides[2] = {(cuuint64_t)d * 4,
                                   (cuuint64_t)n * d * 4};
    const cuuint32_t box[3] = {kTile, kBK, 1};
    const int rc = encode_f32_3d(&map, x, dims, strides, box,
                                 CU_TENSOR_MAP_SWIZZLE_NONE);
    if (rc) return rc;
  }
  cudaError_t err = cudaFuncSetAttribute(
      gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  gram_kernel<<<(unsigned)blocks, kThreads, kSmemBytes,
                (cudaStream_t)stream>>>(map, x, out, n_valid, n, d,
                                        repro_ceil_div(d, kTile), pairs, tma);
  return (int)cudaGetLastError();
}
