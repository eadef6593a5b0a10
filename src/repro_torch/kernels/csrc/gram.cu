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
#include <cuda.h>
#include <string.h>

#include "common.cuh"
#include "mma.cuh"

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

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// -- mbarriers, TMA and wgmma (PTX) --------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// The barrier's phase completes when this thread's earlier cp.async
// copies have landed (counted as one of its expected arrivals).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_addr(bar))
               : "memory");
}

// A box of the 3-D tensor map at (c0, c1, c2), innermost first.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Generic-proxy writes to shared memory become visible to wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// A K-major operand of 8-row x 128-byte swizzled atoms (1024 bytes apart):
// start address, LBO 16 bytes (unused with the swizzle), SBO 1024 bytes,
// layout 128B.  Adding 2 moves the start by 32 bytes, one k8 step of TF32.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, this warpgroup's rows) += A B^T, A and B K-major TF32
// operands in shared memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
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
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n,
                                (cuuint64_t)n_users};
    const cuuint64_t strides[2] = {(cuuint64_t)d * 4,
                                   (cuuint64_t)n * d * 4};
    const cuuint32_t box[3] = {kTile, kBK, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)x, dims,
               strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  gram_kernel<<<(unsigned)blocks, kThreads, kSmemBytes,
                (cudaStream_t)stream>>>(map, x, out, n_valid, n, d,
                                        repro_ceil_div(d, kTile), pairs, tma);
  return (int)cudaGetLastError();
}
