// All-pairs eigen-projection norms (paper Eq. 2) in one call:
//   out[i, j, c] = || G_i V_j[:, c] ||_2
// for G (NG, d, d) and V (NV, d, k), out (NG, NV, k), all fp32, on the
// TF32 tensor cores through wgmma.
//
// Replaces src/repro/kernels/eigproject/eigproject.py::project_norms_pallas
// (pallas_call at :66), which the reference calls once per (i, j) pair,
// NG * NV times, from similarity.relevance_matrix.
//
// With a group axis (repro_project_norms_grouped, for the hierarchical
// protocol, which the reference vmaps over edge groups): G (B Ng, d, d)
// and V (B Ng, d, k) -> out (B, Ng, Ng, k), each user against the
// signatures of its own group only.
//
// Contract: fp32 in, fp32 out, G_i V never goes to device memory, and G
// need not be symmetric.  The products run as 3xTF32 (mma.cuh: a = hi +
// lo, a b = lo hi + hi lo + hi hi, each term exact in the tensor cores'
// fp32 accumulators), so the result keeps about fp32's accuracy.  Each
// output entry is written by one thread from one sum: no atomics, two
// runs give the same bits.
//
// Bound on the H100 at the dense path's shape (N = 1024, d = 512, k = 8):
// 2 N^2 d^2 k = 4.4e12 flop, 65.6 ms on the fp32 cores; as 3xTF32, three
// TF32 products each, 1.32e13 flop at 495 TFLOP/s, 26.7 ms.  The bytes
// (G, V and the norms once, 1.1 GB) take 0.33 ms: the operations bind.
//
// Design:
//  - W = [V_0 | V_1 | ...] (d x NV k stacked columns) is shared by every
//    user i.  A first small kernel splits it once into TF32 hi and lo and
//    writes both transposed, (2, NV k, dp) with d contiguous (dp = d
//    rounded up to 4): K-major, as wgmma takes a TF32 B operand.  The
//    stacked index's (j, c) arithmetic happens there, once.
//  - A block owns one user i and a slab of 128 stacked columns; blocks
//    are ordered user-major, so a user's slabs run side by side and G_i
//    comes from L2 after the first read.  It walks G_i in passes of 128
//    rows; each pass walks d in 32-deep stages.
//  - A producer warp keeps three stages in flight with mbarriers: TMA
//    loads of a 3-D map over (NG, d, d) (a 128-row x 32-column box of
//    G_i, K-major as it lies) and of a 3-D map over the split W^T (hi and
//    lo, 128 columns x 32 deep), all in the 128-byte swizzle that the
//    wgmma descriptors name.  Where the row pitch 4 d is not a multiple
//    of 16 bytes, G comes by 4-byte cp.async with zero fill, written to
//    the same swizzled positions; W^T always comes by TMA.
//  - Two consumer warpgroups each own 64 rows of the pass.  Each splits
//    its rows of the landed G slab once, in place (hi over the raw
//    values, lo beside them: the split is elementwise, so the swizzle is
//    kept), then issues wgmma.mma_async m64n128k8 .tf32 three times a
//    k-step (lo hi, hi lo, hi hi).  The split of stage s + 1 overlaps the
//    products of stage s.
//  - Every 64 deep (24 wgmma) a warpgroup folds its accumulators into an
//    IEEE fp32 register sum: the tensor cores' fp32 accumulation
//    truncates, and a long chain drifts.  At the end of a pass each
//    thread squares its sums and adds them to its per-column sums of
//    squares, its own slots in shared memory for the whole walk over G_i.
//    One warp-shuffle and one shared-memory reduction over the row owners,
//    in a fixed order, and a sqrt end the block.
//  - Edges are zero-filled (TMA out of bounds, cp.async with zero
//    size), so any d, k, NG and NV run.
//  - Groups: one split of all B Ng k columns, then one norms launch whose
//    blocks are (user, column tile inside its group's Ng k columns).  A
//    tile starts at its group's first column, so each sum runs as in a
//    single call on that group; a tile that runs past the group's last
//    column reads the next group's columns (or TMA's zero fill) there and
//    masks those stores.  The plain call is the case of one group that
//    holds every user and all NV k columns.
#include <string.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kRows = 128;                  // rows of G_i a pass
constexpr int kCols = 128;                  // stacked columns a block
constexpr int kBK = 32;                     // depth a stage (128 bytes)
constexpr int kStages = 3;                  // stages in flight
constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kChain = 2;                   // stages (64 deep) a chain
constexpr int kSlab = kRows * kBK * 4;      // 16 KB: 128 rows x 128 bytes
// A stage: G (raw, then its hi in place), G lo, W^T hi, W^T lo.
constexpr int kStage = 4 * kSlab;
constexpr int kBarOff = kStages * kStage;
// Each consumer thread's 32 per-column sums of squares, slot x of thread
// t at [x][t] (registers would go past the 168 a thread that ptxas gives
// a block of three warpgroups' worth).
constexpr int kSqOff = kBarOff + 64;
// Barriers (2 kStages mbarriers), the sums of squares, then slack to
// align the base to 1024 bytes, as the 128-byte swizzle needs.
constexpr int kSmemBytes = kSqOff + 32 * kConsumers * 4 + 1024;
constexpr int kSplitThreads = 256;
static_assert(kCols == kRows, "one slab size for G and W^T");
static_assert(8 * kCols * 4 <= kStage, "the reduction fits a stage");

// Splits v (NV, d, k) into TF32 hi and lo of W^T: wt[h][j k + c][r] =
// part h of v[j][r][c], rows dp apart, hi (h = 0) then lo (NV k rows
// each).  One thread per (j, r): k contiguous reads, and coalesced
// writes along r.
__global__ void __launch_bounds__(kSplitThreads)
split_w_kernel(const float* __restrict__ v, float* __restrict__ wt, int n_v,
               int d, int k, int dp, int row_blocks) {
  const int64_t j = blockIdx.x / row_blocks;
  const int r = (int)(blockIdx.x % row_blocks) * kSplitThreads + threadIdx.x;
  if (r >= d) return;
  const int64_t nq = (int64_t)n_v * k;
  const float* src = v + (j * d + r) * k;
  for (int c = 0; c < k; ++c) {
    uint32_t hi, lo;
    split_tf32(src[c], hi, lo);
    const int64_t row = j * k + c;
    wt[row * dp + r] = __uint_as_float(hi);
    wt[(nq + row) * dp + r] = __uint_as_float(lo);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
project_norms_kernel(const __grid_constant__ CUtensorMap gmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const float* __restrict__ g, float* __restrict__ out,
                     int d, int group_users, int nq_group, int col_tiles,
                     int tma) {
  extern __shared__ __align__(1024) unsigned char eig_smem[];
  unsigned char* smem =
      eig_smem + ((1024 - (smem_addr(eig_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* empty = full + kStages;

  const int64_t user = blockIdx.x / col_tiles;
  // The group's first stacked column, and this tile's first column.
  const int64_t qg = user / group_users * nq_group;
  const int q0 = (int)(qg + (int64_t)(blockIdx.x % col_tiles) * kCols);
  const int ksteps = repro_ceil_div(d, kBK);
  const int total = repro_ceil_div(d, kRows) * ksteps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // TMA: one arrival (with the bytes); 4-byte route: the 32 lanes'
      // cp.async arrivals and lane 0's, which carries W^T's bytes.
      mbar_init(&full[s], tma ? 1 : 33);
      mbar_init(&empty[s], kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // Producer warp: stage t (pass t / ksteps, depth t % ksteps) into
    // slot t % kStages once the consumers have released it.
    const int lane = threadIdx.x % 32;
    const float* gu = g + user * (int64_t)d * d;
    for (int t = 0; t < total; ++t) {
      const int slot = t % kStages;
      mbar_wait(&empty[slot], ((t / kStages) & 1) ^ 1);
      unsigned char* st = smem + slot * kStage;
      const int r0 = (t / ksteps) * kRows;
      const int c0 = (t % ksteps) * kBK;
      if (lane == 0) {
        mbar_expect_tx(&full[slot], (tma ? 3 : 2) * kSlab);
        if (tma) tma_load_3d(st, &gmap, &full[slot], c0, r0, (int)user);
        tma_load_3d(st + 2 * kSlab, &wmap, &full[slot], c0, q0, 0);
        tma_load_3d(st + 3 * kSlab, &wmap, &full[slot], c0, q0, 1);
      }
      if (!tma) {
        // Lane l copies column c0 + l of each of the 128 rows (a warp
        // reads 128 consecutive bytes of a row), to the swizzled place:
        // row r, 16-byte chunk (l / 4) ^ (r % 8), word l % 4.
        for (int r = 0; r < kRows; ++r) {
          const int row = r0 + r, col = c0 + lane;
          const bool live = row < d && col < d;
          cp_async4(st + r * 128 + ((((lane >> 2) ^ (r & 7))) << 4) +
                        (lane & 3) * 4,
                    live ? gu + (int64_t)row * d + col : gu, live);
        }
        cp_async_mbar_arrive(&full[slot]);
      }
    }
    if (!tma) cp_async_wait<0>();
    return;
  }

  // Consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each pass.
  const int ct = threadIdx.x;
  const int wg = ct / 128;
  const int wt = ct % 128;
  const int lane = ct % 32;
  float acc[64], sum[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) acc[x] = sum[x] = 0.f;
  float* sqs = reinterpret_cast<float*>(smem + kSqOff) + ct;
#pragma unroll
  for (int x = 0; x < 32; ++x) sqs[x * kConsumers] = 0.f;

  for (int t = 0; t <= total; ++t) {
    if (t < total) {
      const int slot = t % kStages;
      mbar_wait(&full[slot], (t / kStages) & 1);
      // Split this warpgroup's 64 rows (8 KB) once, in place.
      float4* hi4 =
          reinterpret_cast<float4*>(smem + slot * kStage + wg * (kSlab / 2));
      float4* lo4 = reinterpret_cast<float4*>(smem + slot * kStage + kSlab +
                                              wg * (kSlab / 2));
#pragma unroll
      for (int m = 0; m < kSlab / 2 / 16 / 128; ++m) {
        const float4 x = hi4[wt + 128 * m];
        uint32_t h[4], l[4];
        split_tf32(x.x, h[0], l[0]);
        split_tf32(x.y, h[1], l[1]);
        split_tf32(x.z, h[2], l[2]);
        split_tf32(x.w, h[3], l[3]);
        hi4[wt + 128 * m] = make_float4(__uint_as_float(h[0]),
                                        __uint_as_float(h[1]),
                                        __uint_as_float(h[2]),
                                        __uint_as_float(h[3]));
        lo4[wt + 128 * m] = make_float4(__uint_as_float(l[0]),
                                        __uint_as_float(l[1]),
                                        __uint_as_float(l[2]),
                                        __uint_as_float(l[3]));
      }
      fence_proxy_async();
    }
    if (t > 0) {
      // Stage t - 1's products are done: fold at a chain's end, square
      // at a pass's end, and release its slot.
      wgmma_wait_all();
      fence_acc(acc);
      const int pk = (t - 1) % ksteps;
      if (pk % kChain == kChain - 1 || pk == ksteps - 1) {
#pragma unroll
        for (int x = 0; x < 64; ++x) sum[x] += acc[x];
      }
      if (pk == ksteps - 1) {
        // Fragment value 4 q + 2 h + e: row 8 h + ..., column 8 q + 2
        // (lane % 4) + e; slot 2 q + e holds that column.
#pragma unroll
        for (int q = 0; q < 16; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = sqs[(2 * q + e) * kConsumers];
            x = fmaf(sum[4 * q + e], sum[4 * q + e], x);
            x = fmaf(sum[4 * q + 2 + e], sum[4 * q + 2 + e], x);
            sqs[(2 * q + e) * kConsumers] = x;
          }
#pragma unroll
        for (int x = 0; x < 64; ++x) sum[x] = 0.f;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(t - 1) % kStages]);
    }
    if (t == total) break;
    // Every thread of the warpgroup has written its split.
    named_sync(1 + wg, 128);
    const int slot = t % kStages;
    const unsigned char* st = smem + slot * kStage;
    fence_acc(acc);
    wgmma_fence();
    const uint64_t dah = desc_sw128(st + wg * (kSlab / 2));
    const uint64_t dal = desc_sw128(st + kSlab + wg * (kSlab / 2));
    const uint64_t dbh = desc_sw128(st + 2 * kSlab);
    const uint64_t dbl = desc_sw128(st + 3 * kSlab);
    const int first = (t % ksteps) % kChain == 0;
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      wgmma_tf32(acc, dal + 2 * kk, dbh + 2 * kk, first && kk == 0 ? 0 : 1);
      wgmma_tf32(acc, dah + 2 * kk, dbl + 2 * kk, 1);
      wgmma_tf32(acc, dah + 2 * kk, dbh + 2 * kk, 1);
    }
    wgmma_commit();
  }

  // Sums of squares over the row owners: the 8 lanes that share lane % 4
  // (butterfly, the same bits on every lane), then the 8 warps through
  // shared memory, added in warp order.  Every stage has landed and every
  // product is done once all consumers pass the barrier.
  float sq[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    sq[x] = sqs[x * kConsumers];
    sq[x] += __shfl_xor_sync(0xffffffffu, sq[x], 4);
    sq[x] += __shfl_xor_sync(0xffffffffu, sq[x], 8);
    sq[x] += __shfl_xor_sync(0xffffffffu, sq[x], 16);
  }
  named_sync(3, kConsumers);
  float* red = reinterpret_cast<float*>(smem);
  if (lane < 4) {
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        red[(ct / 32) * kCols + 8 * q + 2 * lane + e] = sq[2 * q + e];
  }
  named_sync(3, kConsumers);
  const int64_t q = q0 - qg + ct;  // column inside the group
  if (ct < kCols && q < nq_group) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumers / 32; ++w) s += red[w * kCols + ct];
    out[user * (int64_t)nq_group + q] = sqrtf(s);
  }
}

// Row pitch of the split W^T: d rounded up to 4 floats, so that rows are
// 16-byte aligned for TMA.
int split_pitch(int d) { return (d + 3) / 4 * 4; }

int launch_split(const float* v, float* wt, int n_v, int d, int k,
                 cudaStream_t stream) {
  const int row_blocks = repro_ceil_div(d, kSplitThreads);
  const int64_t blocks = (int64_t)n_v * row_blocks;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  split_w_kernel<<<(unsigned)blocks, kSplitThreads, 0, stream>>>(
      v, wt, n_v, d, k, split_pitch(d), row_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// The split W^T alone: v (n_v, d, k) -> wt (2, n_v k, dp) fp32, dp = d
// rounded up to 4 (columns past d are not written).  For tests; the
// norms' entry point runs it itself.
REPRO_EXPORT int repro_eigproject_split(const float* v, float* wt, int n_v,
                                        int d, int k, void* stream) {
  if (n_v <= 0 || d <= 0 || k <= 0) return 0;
  return launch_split(v, wt, n_v, d, k, (cudaStream_t)stream);
}

// Shared memory of a norms block; the row pitch of the split W^T and the
// load route of G (1: TMA, 0: 4-byte cp.async) through the pointers.
// kernels/eigproject/ops.py::eig_plan computes the same.
REPRO_EXPORT int64_t repro_eigproject_plan(int d, int* pitch, int* tma) {
  *pitch = split_pitch(d);
  *tma = (4 * d) % 16 == 0;
  return kSmemBytes;
}

// Users u = 0 .. n_g - 1 in groups of group_users; user u projects the
// n_col = nq_group / k signatures of its group, those of v rows
// u / group_users * n_col onward.  g (n_g, d, d), v (n_v, d, k) fp32
// contiguous, g 16-byte aligned where 4 d % 16 == 0; wt (2, n_v k, dp)
// fp32 scratch, 16-byte aligned -> out (n_g, nq_group).
static int launch_norms(const float* g, const float* v, float* wt,
                        float* out, int n_g, int group_users, int nq_group,
                        int n_v, int d, int k, cudaStream_t st) {
  if (n_g <= 0 || n_v <= 0 || k <= 0 || nq_group <= 0) return 0;
  if (d <= 0 || group_users <= 0) return (int)cudaErrorInvalidValue;
  const int64_t nq = (int64_t)n_v * k;
  const int col_tiles = repro_ceil_div(nq_group, kCols);
  const int64_t blocks = (int64_t)n_g * col_tiles;
  if (nq > 0x7fffffff || blocks > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  if (reinterpret_cast<uintptr_t>(wt) % 16)
    return (int)cudaErrorMisalignedAddress;
  const int tma = (4 * d) % 16 == 0;
  if (tma && reinterpret_cast<uintptr_t>(g) % 16)
    return (int)cudaErrorMisalignedAddress;
  const int dp = split_pitch(d);
  CUtensorMap gmap, wmap;
  memset(&gmap, 0, sizeof(gmap));
  if (tma) {
    const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)d,
                                (cuuint64_t)n_g};
    const cuuint64_t strides[2] = {(cuuint64_t)d * 4,
                                   (cuuint64_t)d * d * 4};
    const cuuint32_t box[3] = {kBK, kRows, 1};
    const int rc = encode_f32_3d(&gmap, g, dims, strides, box,
                                 CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc) return rc;
  }
  {
    const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)nq, 2};
    const cuuint64_t strides[2] = {(cuuint64_t)dp * 4,
                                   (cuuint64_t)nq * dp * 4};
    const cuuint32_t box[3] = {kBK, kCols, 1};
    const int rc = encode_f32_3d(&wmap, wt, dims, strides, box,
                                 CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc) return rc;
  }
  int rc = launch_split(v, wt, n_v, d, k, st);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      project_norms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  project_norms_kernel<<<(unsigned)blocks, kThreads, kSmemBytes, st>>>(
      gmap, wmap, g, out, d, group_users, nq_group, col_tiles, tma);
  return (int)cudaGetLastError();
}

// g (n_g, d, d), v (n_v, d, k) fp32 contiguous, g 16-byte aligned where
// 4 d % 16 == 0; wt (2, n_v k, dp) fp32 scratch, 16-byte aligned
// -> out (n_g, n_v, k).
REPRO_EXPORT int repro_project_norms(const float* g, const float* v,
                                     float* wt, float* out, int n_g, int n_v,
                                     int d, int k, void* stream) {
  if ((int64_t)n_v * k > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  return launch_norms(g, v, wt, out, n_g, n_g, n_v * k, n_v, d, k,
                      (cudaStream_t)stream);
}

// The group axis: g (b ng, d, d), v (b ng, d, k) fp32 contiguous, g
// 16-byte aligned where 4 d % 16 == 0; wt (2, b ng k, dp) fp32 scratch,
// 16-byte aligned -> out (b, ng, ng, k), out[b][i][j][c] = ||G_{b ng + i}
// V_{b ng + j}[:, c]||.  One split and one norms launch for all groups.
REPRO_EXPORT int repro_project_norms_grouped(const float* g, const float* v,
                                             float* wt, float* out, int b,
                                             int ng, int d, int k,
                                             void* stream) {
  const int64_t users = (int64_t)b * ng;
  if (users > 0x7fffffff || (int64_t)ng * k > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  return launch_norms(g, v, wt, out, (int)users, ng, ng * k, (int)users, d,
                      k, (cudaStream_t)stream);
}
