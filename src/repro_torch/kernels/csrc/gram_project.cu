// Fused Gram + cross-projection (paper Eqs. 1-2 without the Gram) on the
// tensor cores, a whole tile of users in one launch:
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
// all, n = 256, d = 512, K = 8192): 4 N n d K = 4.4e12 operations (X_u V,
// then X_u^T P).  Both products run as three TF32 products each
// (3xTF32): 3 x 4.4e12 at 495 TFLOP/s is 26.65 ms; on the fp32 cores the
// same work is 65.6 ms at 67 TFLOP/s.  The bytes (0.57 GB of X, V and
// out, 0.17 ms at 3.35 TB/s) do not bind.  The (d, d) Gram and the
// (n, K) projection never reach device memory; no atomics, so two runs
// give the same bits.
//
// Design: a 256-thread block (8 warps) owns one user and a slab of BK
// consecutive columns (the wrapper's project_plan: BK = 64 at d <= 512,
// 32 at d <= 1024, 16 at d <= 1536, 8 at d <= 2048).  Blocks are numbered
// user-major, so a user's slabs run together and share X_u through L2.
//  - V_slab (d x BK fp32) is staged once and stays resident in shared
//    memory: 128 KB at d = 512, BK = 64.  X_u streams in tiles of 16 rows
//    through a cp.async ring (two stages where they fit, else one), so
//    the next tile's copies are in flight while this one computes.  Each
//    X_u is read from L2 once per slab: about 67 GB at the blockwise
//    shape with BK = 64 (134 GB at the previous kernel's BK = 32), and
//    each V_slab once per block, about 17 GB.
//  - Both products are m16n8k8 TF32 mma through mma_3xtf32 (lo hi + hi lo
//    + hi hi into fp32 accumulators); fragments of X and V are split into
//    hi and lo as they are loaded.
//  - P_t = X_t V_slab (16 x BK) is computed in 8 depth slices, one a warp,
//    each over the whole slab: with only 16 rows beside the resident
//    V_slab, this is what gives each warp BK / 8 n-tiles a fragment of X
//    (one n-tile a warp over the whole depth would split every X fragment
//    8 times over and leave the split arithmetic, not the tensor cores,
//    as the limit).  The slices are added in a fixed order through
//    shared memory, then P_t is split into hi and lo there once.
//  - Q (d x BK) += X_t^T P_t in mma accumulators, a warp owning d / 8 rows
//    of Q x the whole slab (up to 128 fp32 registers a thread).  The
//    block ends with Q's column sums of squares (shuffles across a warp,
//    then a fixed-order sum over warps) and the square root.  The tensor
//    cores' fp32 accumulation truncates, and Q's chains run over all n
//    rows (96 mma at n = 256); folding them into a second sum, as
//    featurize_gram does, would need another 128 registers a thread, so
//    the kernel keeps the chains and its error (about 2e-6 of the largest
//    norm at the blockwise shape, within the 1e-5 limit) shows it.
//  - Shared tiles are XOR-swizzled by row (16-byte granules), so the
//    fragment reads of both products miss each other's banks: X is read
//    as A (rows) in P_t and as A transposed in Q, which no row padding
//    serves at once.
//  - Edges (n, d, K not multiples of a tile) are zero-filled.
// Thread-block clusters that multicast X_u tiles to a user's slabs by
// TMA would cut the L2 re-reads of X further: a later redesign.
// Registers and spills of each instantiation: build.log (-Xptxas -v).
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = 8;
constexpr int kRows = 16;            // rows of X per tile
constexpr int kMaxSmem = 232448;     // opt-in shared memory of one block

// Q rows a warp owns, in 16-row m-tiles, at slab width BK: the register
// budget of the Q accumulators (MT x BK / 2 floats a thread).
__host__ __device__ constexpr int max_mtiles(int bk) {
  return bk == 64 ? 4 : bk == 32 ? 8 : bk == 16 ? 12 : 16;
}

__host__ __device__ inline int padded_depth(int d) { return repro_ceil_div(d, 128) * 128; }

// Dynamic shared memory of a launch: V_slab [d_pad][BK], `stages` x
// X [16][d_pad], partial P [8][16][BK], all fp32.
// kernels/gram_project/ops.py::project_plan computes the same.
int64_t smem_bytes(int d, int bk, int stages) {
  const int64_t dp = padded_depth(d);
  return 4 * (dp * bk + (int64_t)stages * kRows * dp +
              (int64_t)kWarps * kRows * bk);
}

// Column swizzle of row r in a [rows][BK] tile (V_slab, P): B fragments
// (rows t, t + 4; columns 8 nt + g) and the partial P stores (rows g,
// g + 8) then fall in distinct banks.
template <int BK>
__device__ __forceinline__ int swz_n(int r) {
  if constexpr (BK >= 32) return (r & 3) << 3;
  else if constexpr (BK == 16) return ((r >> 1) & 1) << 3;
  else return 0;
}

// Column swizzle of row r of an X tile [16][d_pad]: A reads of P_t (rows
// g, g + 8; columns k + t, k + t + 4) and of Q (rows t, t + 4; columns
// i + g, i + g + 8) both fall in distinct banks.
__device__ __forceinline__ int swz_x(int r) {
  return ((r & 3) << 3) | (r & 4);
}

template <int BK>
__global__ void __launch_bounds__(kThreads, 1)
gram_project_tc_kernel(const float* __restrict__ x,
                       const float* __restrict__ v, float* __restrict__ out,
                       int n, int d, int k_cols, int slabs, int stages,
                       bool vec_x, bool vec_v) {
  constexpr int NT = BK / 8;               // n8 tiles of the slab
  constexpr int MT_MAX = max_mtiles(BK);
  extern __shared__ __align__(16) float gp_smem[];
  const int d_pad = padded_depth(d);
  float* vs = gp_smem;                       // [d_pad][BK]
  float* xring = vs + d_pad * BK;            // stages x [16][d_pad]
  float* part = xring + stages * kRows * d_pad;  // [8][16][BK]

  const int64_t user = blockIdx.x / slabs;
  const int q0 = (int)(blockIdx.x % slabs) * BK;
  const float* xu = x + user * (int64_t)n * d;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt_live = d_pad / 128;           // Q m-tiles a warp
  const int depth = d_pad / kWarps;          // P_t depth slice a warp
  const int tiles = repro_ceil_div(n, kRows);

  // V_slab: rows past d and columns past K are zero.
  if (vec_v) {
    for (int e = tid; e < d_pad * (BK / 4); e += kThreads) {
      const int k = e / (BK / 4), c4 = 4 * (e % (BK / 4));
      const bool live = k < d && q0 + c4 < k_cols;
      cp_async16(vs + k * BK + (c4 ^ swz_n<BK>(k)),
                 live ? v + (int64_t)k * k_cols + q0 + c4 : v, live);
    }
  } else {
    for (int e = tid; e < d_pad * BK; e += kThreads) {
      const int k = e / BK, cc = e % BK;
      const bool live = k < d && q0 + cc < k_cols;
      cp_async4(vs + k * BK + (cc ^ swz_n<BK>(k)),
                live ? v + (int64_t)k * k_cols + q0 + cc : v, live);
    }
  }
  // X tile `tile` into ring slot tile % stages; one commit group a call
  // (the first also holds V_slab), empty past the last tile.
  auto copy_tile = [&](int tile) {
    if (tile < tiles) {
      float* xd = xring + (tile % stages) * kRows * d_pad;
      const int r0 = tile * kRows;
      if (vec_x) {
        for (int e = tid; e < kRows * (d_pad / 4); e += kThreads) {
          const int r = e / (d_pad / 4), c4 = 4 * (e % (d_pad / 4));
          const bool live = r0 + r < n && c4 < d;
          cp_async16(xd + r * d_pad + (c4 ^ swz_x(r)),
                     live ? xu + (int64_t)(r0 + r) * d + c4 : xu, live);
        }
      } else {
        for (int e = tid; e < kRows * d_pad; e += kThreads) {
          const int r = e / d_pad, cc = e % d_pad;
          const bool live = r0 + r < n && cc < d;
          cp_async4(xd + r * d_pad + (cc ^ swz_x(r)),
                    live ? xu + (int64_t)(r0 + r) * d + cc : xu, live);
        }
      }
    }
    cp_async_commit();
  };

  float q[MT_MAX][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT_MAX; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) q[mt][nt][e] = 0.f;

  for (int s = 0; s < stages - 1; ++s) copy_tile(s);
  for (int tile = 0; tile < tiles; ++tile) {
    if (stages > 1) {
      cp_async_wait_n(stages - 2);
      __syncthreads();  // tile has landed; the previous tile is done
      copy_tile(tile + stages - 1);
    } else {
      __syncthreads();
      copy_tile(tile);
      cp_async_wait<0>();
      __syncthreads();
    }
    const float* xd = xring + (tile % stages) * kRows * d_pad;

    // P_t over this warp's depth slice [k_lo, k_lo + depth).
    float p[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nt][e] = 0.f;
    const int k_lo = warp * depth;
#pragma unroll 2
    for (int k0 = k_lo; k0 < k_lo + depth; k0 += 8) {
      uint32_t ah[4], al[4];
      split_tf32(xd[g * d_pad + ((k0 + t) ^ swz_x(g))], ah[0], al[0]);
      split_tf32(xd[(g + 8) * d_pad + ((k0 + t) ^ swz_x(g))], ah[1], al[1]);
      split_tf32(xd[g * d_pad + ((k0 + t + 4) ^ swz_x(g))], ah[2], al[2]);
      split_tf32(xd[(g + 8) * d_pad + ((k0 + t + 4) ^ swz_x(g))], ah[3],
                 al[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bh[2], bl[2];
        const int col = 8 * nt + g;
        split_tf32(vs[(k0 + t) * BK + (col ^ swz_n<BK>(k0 + t))], bh[0],
                   bl[0]);
        split_tf32(vs[(k0 + t + 4) * BK + (col ^ swz_n<BK>(k0 + t + 4))],
                   bh[1], bl[1]);
        mma_3xtf32(p[nt], ah, al, bh, bl);
      }
    }
    float* mine = part + warp * kRows * BK;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(mine + g * BK + (col ^ swz_n<BK>(g))) =
          make_float2(p[nt][0], p[nt][1]);
      *reinterpret_cast<float2*>(mine + (g + 8) * BK +
                                 (col ^ swz_n<BK>(g + 8))) =
          make_float2(p[nt][2], p[nt][3]);
    }
    __syncthreads();
    // P_t = the slices in order, split once: hi into slice 0's place, lo
    // into slice 1's (only this thread touches entry e of every slice).
    for (int e = tid; e < kRows * BK; e += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += part[w * kRows * BK + e];
      uint32_t hi, lo;
      split_tf32(s, hi, lo);
      part[e] = __uint_as_float(hi);
      part[kRows * BK + e] = __uint_as_float(lo);
    }
    __syncthreads();

    // Q[rows of this warp] += X_t^T P_t.
    const float* p_hi = part;
    const float* p_lo = part + kRows * BK;
    const int i_base = warp * 16 * mt_live;
#pragma unroll
    for (int r0 = 0; r0 < kRows; r0 += 8) {
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = 8 * nt + g;
        const int o0 = (r0 + t) * BK + (col ^ swz_n<BK>(r0 + t));
        const int o1 = (r0 + t + 4) * BK + (col ^ swz_n<BK>(r0 + t + 4));
        bh[nt][0] = __float_as_uint(p_hi[o0]);
        bh[nt][1] = __float_as_uint(p_hi[o1]);
        bl[nt][0] = __float_as_uint(p_lo[o0]);
        bl[nt][1] = __float_as_uint(p_lo[o1]);
      }
      const float* xa = xd + (r0 + t) * d_pad;
      const float* xb = xa + 4 * d_pad;
      const int sa = swz_x(r0 + t), sb = swz_x(r0 + t + 4);
#pragma unroll
      for (int mt = 0; mt < MT_MAX; ++mt) {
        if (mt >= mt_live) break;
        const int i = i_base + 16 * mt + g;
        uint32_t ah[4], al[4];
        split_tf32(xa[i ^ sa], ah[0], al[0]);
        split_tf32(xa[(i + 8) ^ sa], ah[1], al[1]);
        split_tf32(xb[i ^ sb], ah[2], al[2]);
        split_tf32(xb[(i + 8) ^ sb], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_3xtf32(q[mt][nt], ah, al, bh[nt], bl[nt]);
      }
    }
  }
  cp_async_commit();  // V_slab's copies, where no tile committed them
  cp_async_wait<0>();

  // Column sums of squares: over this thread's rows, the warp's 8 row
  // groups (shuffles), then the warps in order; then the square root.
  float ss[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = 0.f;
#pragma unroll
      for (int mt = 0; mt < MT_MAX; ++mt) {
        s = fmaf(q[mt][nt][e], q[mt][nt][e], s);
        s = fmaf(q[mt][nt][e + 2], q[mt][nt][e + 2], s);
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      ss[nt][e] = s;
    }
  __syncthreads();
  float* red = part;  // [8][BK]
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        red[warp * BK + 8 * nt + 2 * t + e] = ss[nt][e];
  }
  __syncthreads();
  if (tid < BK && q0 + tid < k_cols) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * BK + tid];
    out[user * (int64_t)k_cols + q0 + tid] = sqrtf(s);
  }
}

template <int BK>
int launch(const float* x, const float* v, float* out, int n_users, int n,
           int d, int k_cols, int stages, cudaStream_t stream) {
  const int slabs = repro_ceil_div(k_cols, BK);
  const int64_t blocks = (int64_t)n_users * slabs;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const int smem = (int)smem_bytes(d, BK, stages);
  auto kernel = gram_project_tc_kernel<BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec_x = d % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vec_v =
      k_cols % 4 == 0 && (reinterpret_cast<uintptr_t>(v) & 15) == 0;
  kernel<<<(unsigned)blocks, kThreads, (size_t)smem, stream>>>(
      x, v, out, n, d, k_cols, slabs, stages, vec_x, vec_v);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared-memory bytes of a launch at depth d, slab width bk, `stages`
// X tiles in flight.
REPRO_EXPORT int64_t repro_gram_project_smem(int d, int bk, int stages) {
  return smem_bytes(d, bk, stages);
}

// x (n_users, n, d), v (d, k_cols) fp32 contiguous -> out (n_users,
// k_cols).  bk (64, 32, 16 or 8) and stages (1 or 2) come from the
// wrapper's project_plan.
REPRO_EXPORT int repro_gram_project(const float* x, const float* v, float* out,
                                    int n_users, int n, int d, int k_cols,
                                    int bk, int stages, void* stream) {
  if (n_users <= 0 || k_cols <= 0 || d <= 0) return 0;
  if (stages < 1 || stages > 2 || padded_depth(d) > 128 * max_mtiles(bk) ||
      smem_bytes(d, bk, stages) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bk == 64) return launch<64>(x, v, out, n_users, n, d, k_cols, stages, s);
  if (bk == 32) return launch<32>(x, v, out, n_users, n, d, k_cols, stages, s);
  if (bk == 16) return launch<16>(x, v, out, n_users, n, d, k_cols, stages, s);
  if (bk == 8) return launch<8>(x, v, out, n_users, n, d, k_cols, stages, s);
  return (int)cudaErrorInvalidValue;
}
