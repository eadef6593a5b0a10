// Fused featurize -> Gram (paper Eq. 1 from raw data) on the tensor
// cores, every user of a row chunk in one launch:
//   acc[u] += (X_u W)^T (X_u W)
// for X (N, c, m) fp32 raw rows, a shared projection W (m, d), and the
// fp32 Gram stack acc (N, d, d), which is updated IN PLACE (the
// streaming SignatureEngine folds one row chunk at a time into it).
//
// Replaces src/repro/kernels/featurize_gram/featurize_gram.py::
// featurize_gram_pallas (grid variant, pallas_call at :127, and its DMA
// double-buffered variant at :116), which the reference calls once per
// user for each chunk.
//
// Contract: fp32 computes the function in fp32; bf16 rounds X and W to
// bf16 (RN), sums F = X W in fp32, rounds F to bf16, and sums the Gram's
// bf16 products in fp32 (the reference's mixed precision).  F never
// reaches device memory.  The Gram is symmetric bit for bit, and only
// this user's block touches its Gram, in a fixed order: no atomics, and
// two runs give the same bits.
//
// Bound on the H100 at the raw path's shapes (N = 1024 users, n = 252
// rows, m = 3072 pixels, d = 512): N (2 n m d + n d (d + 1)) = 0.88e12
// operations (the projection, then one triangle of the Gram).  In fp32
// the products run as three TF32 products each (3xTF32, below):
// 3 x 0.88e12 at 495 TFLOP/s is 5.33 ms; on the fp32 cores the same
// work is 13.1 ms at 67 TFLOP/s.  In bf16 it is 0.89 ms at 989 TFLOP/s.
// The bytes (3.17 GB of raw rows, 0.95 ms at 3.35 TB/s) do not bind.
//
// Design: one 512-thread block (16 warps) per user walks the chunk in row
// tiles of R rows (64, or 32 / 16 where d is too wide for the shared
// memory; the wrapper's featurize_plan picks R and the ring depth).
//  - F_t = X_t W for the R rows across all d columns goes into shared
//    memory, a slab of columns at a time: fp32 slabs of 256, the warps 2
//    along the rows x 8 along the slab (R / 2 rows x 32 columns each; at
//    R = 16, 8 warps of 16 x 32), bf16 slabs of 512, the 16 warps along
//    the slab (R rows x 32 columns each; fp32 would need 64 more
//    registers a thread for that).  They walk m in k-stages 32 deep (16
//    at R = 16).  X and W k-slices arrive through cp.async (16-byte
//    copies; 4-byte ones where m is not a multiple of 4) into a ring of
//    1-4 stages; the copies of the next stages, across slabs and row
//    tiles, are in flight while the current one computes, and during the
//    Gram phase.  One barrier a stage; the walk's cursor advances without
//    divisions.
//  - fp32: m16n8k8 TF32 products through mma_3xtf32 (lo hi + hi lo +
//    hi hi into the fp32 accumulators); each fragment is split into hi
//    and lo as it is loaded, so shared memory holds fp32 once.  The
//    tensor cores' fp32 accumulation truncates, so the accumulators are
//    folded into a register sum with IEEE adds every 32 columns of m
//    (chains of 12 mma): unfolded over m = 3072, the drift broke the
//    1e-5 limit on an H100.  bf16: m16n8k16 bf16 products;
//    X stays fp32 in shared memory and is rounded to bf16 as its
//    fragments are built (so the wrapper needs no cast pass over X), W
//    arrives in bf16 and is read with ldmatrix.  F_t is kept in fp32
//    (fp32) or rounded to bf16 (bf16).
//  - Row strides: X stages depth + 4 floats (fp32: A reads at g ldx + t
//    miss each other's banks) or depth + 8 (bf16: float2 reads); W stages
//    slab + 8 elements (fp32: B reads at t 264 + g; bf16: 1040-byte rows
//    for ldmatrix); F rows d_pad + 8 (both A and B of F^T F read at
//    t ldf + g).
//  - acc[u] += F_t^T F_t, one 128 x 128 tile of the upper triangle at a
//    time (16 warps of 32 x 32; on the diagonal tile the six warps wholly
//    below it are idle).  Each thread adds its accumulators straight into
//    the Gram in device memory, and each off-diagonal entry also at its
//    mirror; a diagonal tile adds i <= j and mirrors i < j.  A Gram entry
//    is thus always read and written by the same thread, with the same
//    value at both positions, so the Gram stays symmetric bit for bit.
//    The old entries are loaded before the tile's products, so that the
//    loads are in flight while the tensor cores run.
// Bytes of one row tile at the raw shape (R = 64): the Gram's
// read-modify-write, 2 MiB (about 4 tiles x 2 MiB x 1024 users = 8.6 GB
// of device memory, 2.6 ms), and W's 6 MiB through L2 (about 25 GB; 3
// MiB and 12.6 GB in bf16); X is read once a slab (twice in fp32).  A
// thread-block cluster of ceil(d / 128) blocks, each holding a 128-column
// slab of a taller F tile and reading its peers' slabs through
// distributed shared memory, would halve both: a later redesign.
// Registers and spills of each instantiation: build.log (-Xptxas -v).
#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;     // 16 warps
constexpr int kTile = 128;        // Gram output tile edge
// F columns a pass of the projection covers (32 a warp): fp32 256 (two
// warps along the rows, for registers), bf16 512 (all 16 along the
// columns: X is read once a row tile, and there are half as many
// stages).  A W stage row holds a slab plus 8 elements of padding.
__host__ __device__ constexpr int slab(bool bf) { return bf ? 512 : 256; }
constexpr int kMaxSmem = 232448;  // opt-in shared memory of one block
constexpr int kMaxStages = 4;
// m-stage of the projection: 32 deep, or 16 for 16-row tiles (the widest
// d, where a 32-deep W stage would not fit beside F).  Deeper stages
// spend fewer barriers and waits per product.
__host__ __device__ constexpr int depth(int rows) { return rows == 16 ? 16 : 32; }
// The fp32 accumulators are folded into F every 32 columns of m (below).
constexpr int kFoldDepth = 32;

// X stage row stride in floats: 4 (mod 32) for the TF32 A reads at
// g ldx + t, 8 (mod 32) for bf16's float2 reads at g ldx + 2 t.
__host__ __device__ constexpr int ldx(bool bf, int rows) {
  return depth(rows) + (bf ? 8 : 4);
}

__host__ __device__ inline int padded_width(int d) { return repro_ceil_div(d, kTile) * kTile; }

// Dynamic shared memory of a launch: F [rows][d_pad + 8] in the compute
// type, then `stages` x (X [rows][ldx] fp32 | W [16][264] in W's type).
// kernels/featurize_gram/ops.py::featurize_plan computes the same.
int64_t smem_bytes(int d, int rows, int stages, bool bf) {
  const int64_t elt = bf ? 2 : 4;
  const int64_t stage =
      (int64_t)rows * ldx(bf, rows) * 4 + depth(rows) * (slab(bf) + 8) * elt;
  return (int64_t)rows * (padded_width(d) + 8) * elt + stages * stage;
}

template <bool BF, int MT>  // MT: 16-row m-tiles of a row tile
__global__ void __launch_bounds__(kThreads, 1)
featurize_gram_tc_kernel(const float* __restrict__ x, int64_t x_user_stride,
                         const typename std::conditional<BF, bf16,
                                                         float>::type* __restrict__ w,
                         int ldw_g, float* __restrict__ acc, int c, int m,
                         int d, int stages, bool vec_x) {
  using WT = typename std::conditional<BF, bf16, float>::type;
  using FT = WT;
  constexpr int R = 16 * MT;
  constexpr int KD = depth(R);
  constexpr int LDX = ldx(BF, R);
  constexpr int kFold = kFoldDepth / KD;  // k-stages between folds
  extern __shared__ __align__(16) unsigned char fg_smem[];
  const int d_pad = padded_width(d);
  const int ldf = d_pad + 8;
  FT* f = reinterpret_cast<FT*>(fg_smem);
  unsigned char* ring = fg_smem + (size_t)R * ldf * sizeof(FT);
  constexpr int kXBytes = R * LDX * 4;
  constexpr int kSlab = slab(BF);
  constexpr int kLdw = kSlab + 8;  // W stage row, in elements
  constexpr int kStageBytes = kXBytes + KD * kLdw * (int)sizeof(WT);

  const int64_t user = blockIdx.x;
  const float* xu = x + user * x_user_stride;
  float* gu = acc + user * (int64_t)d * d;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // Projection: WM warps along the rows x kSlab / 32 along a slab's
  // columns, each MW m-tiles x 32 columns (fp32 at 16 rows: warps 8-15
  // sit it out).
  constexpr int WM = !BF && MT >= 2 ? 2 : 1;
  constexpr int MW = MT / WM;
  const int pn = warp / WM;            // column block of the slab
  const int prow = 16 * MW * (warp % WM);  // first row
  const int nk = repro_ceil_div(m, KD);
  const int total =
      repro_ceil_div(c, R) * repro_ceil_div(d_pad, kSlab) * nk;

  // A step of the flat walk (row tile r0, slab n0, k-stage kk) and its
  // ring slot, advanced without divisions.
  struct Step {
    int r0, n0, kk, slot;
  };
  auto advance = [&](Step& s) {
    if (++s.kk == nk) {
      s.kk = 0;
      s.n0 += kSlab;
      if (s.n0 >= d_pad) {
        s.n0 = 0;
        s.r0 += R;
      }
    }
    if (++s.slot == stages) s.slot = 0;
  };

  // Copies of step `s` into its ring slot; one commit group per step,
  // empty past the end.
  constexpr int kXChunks = KD / 4;  // 16-byte copies of an X row
  auto copy_step = [&](const Step& s, bool live_step) {
    if (live_step) {
      const int k0 = s.kk * KD;
      unsigned char* st = ring + (size_t)s.slot * kStageBytes;
      float* xd = reinterpret_cast<float*>(st);
      WT* wd = reinterpret_cast<WT*>(st + kXBytes);
      for (int e = tid; e < R * kXChunks; e += kThreads) {
        const int r = e / kXChunks, col = k0 + 4 * (e % kXChunks);
        const int row = s.r0 + r;
        float* dst = xd + r * LDX + 4 * (e % kXChunks);
        const float* src = xu + (int64_t)row * m + col;
        if (vec_x) {
          const bool live = row < c && col < m;
          cp_async16(dst, live ? src : xu, live);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const bool live = row < c && col + u < m;
            cp_async4(dst + u, live ? src + u : xu, live);
          }
        }
      }
      constexpr int EPC = 16 / (int)sizeof(WT);  // elements per copy
      constexpr int CPR = kSlab / EPC;
      for (int e = tid; e < KD * CPR; e += kThreads) {
        const int r = e / CPR, col = s.n0 + (e % CPR) * EPC;
        const bool live = k0 + r < m && col < ldw_g;
        cp_async16(wd + r * kLdw + (e % CPR) * EPC,
                   live ? w + (int64_t)(k0 + r) * ldw_g + col : w, live);
      }
    }
    cp_async_commit();
  };

  // This warp's R x 32 block of the F slab: the mma accumulators, and
  // (fp32) their folded sum.  Both are zeroed after each slab's F is
  // stored (and after the Gram phase, so that they hold no registers
  // across it).
  float p[MW][4][4], fs[MW][4][4];
  auto clear = [&]() {
#pragma unroll
    for (int mt = 0; mt < MW; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[mt][nt][e] = fs[mt][nt][e] = 0.f;
  };
  clear();

  // F_t[prow .., n0 + 32 pn ..] += X_t W over one k-stage in slot `slot`.
  auto project = [&](int slot) {
    const unsigned char* st = ring + (size_t)slot * kStageBytes;
    const float* xd = reinterpret_cast<const float*>(st);
    const WT* wd = reinterpret_cast<const WT*>(st + kXBytes);
    if constexpr (BF) {
#pragma unroll
      for (int k16 = 0; k16 < KD; k16 += 16) {
      uint32_t a[MW][4];
#pragma unroll
      for (int mt = 0; mt < MW; ++mt) {
        const float* xr = xd + (prow + 16 * mt + g) * LDX + k16 + 2 * t;
        const float2 v0 = *reinterpret_cast<const float2*>(xr);
        const float2 v1 = *reinterpret_cast<const float2*>(xr + 8 * LDX);
        const float2 v2 = *reinterpret_cast<const float2*>(xr + 8);
        const float2 v3 = *reinterpret_cast<const float2*>(xr + 8 * LDX + 8);
        a[mt][0] = pack_bf16(v0.x, v0.y);
        a[mt][1] = pack_bf16(v1.x, v1.y);
        a[mt][2] = pack_bf16(v2.x, v2.y);
        a[mt][3] = pack_bf16(v3.x, v3.y);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, wd + (k16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdw +
                   32 * pn + 16 * np + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MW; ++mt) {
          mma_bf16(p[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(p[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
      }
    } else {
#pragma unroll
      for (int k8 = 0; k8 < KD; k8 += 8) {
        uint32_t ah[MW][4], al[MW][4];
#pragma unroll
        for (int mt = 0; mt < MW; ++mt) {
          const float* xr = xd + (prow + 16 * mt + g) * LDX + k8 + t;
          split_tf32(xr[0], ah[mt][0], al[mt][0]);
          split_tf32(xr[8 * LDX], ah[mt][1], al[mt][1]);
          split_tf32(xr[4], ah[mt][2], al[mt][2]);
          split_tf32(xr[8 * LDX + 4], ah[mt][3], al[mt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* wr = wd + (k8 + t) * kLdw + 32 * pn + 8 * nt + g;
          uint32_t bh[2], bl[2];
          split_tf32(wr[0], bh[0], bl[0]);
          split_tf32(wr[4 * kLdw], bh[1], bl[1]);
#pragma unroll
          for (int mt = 0; mt < MW; ++mt)
            mma_3xtf32(p[mt][nt], ah[mt], al[mt], bh, bl);
        }
      }
    }
  };

  // acc[u] += F_t^T F_t over the upper-triangle tiles, mirrored.
  auto gram = [&]() {
    const int gm = warp & 3, gn = warp >> 2;  // 32 x 32 of each tile
    const int tiles = d_pad / kTile;
    for (int ti = 0; ti < tiles; ++ti) {
      for (int tj = ti; tj < tiles; ++tj) {
        const bool diag = ti == tj;
        if (diag && gm > gn) continue;  // wholly below the diagonal
        const int i0 = ti * kTile + 32 * gm;
        const int j0 = tj * kTile + 32 * gn;
        if (i0 >= d || j0 >= d) continue;
        // The Gram entries this warp adds to, (i, j) and the mirror (j, i),
        // as offsets from two base pointers; a diagonal tile adds i <= j
        // and mirrors i < j, and entries past d are skipped.
        const bool full = !diag && i0 + 32 <= d && j0 + 32 <= d;
        float* row_base = gu + (int64_t)(i0 + g) * d + j0 + 2 * t;
        float* col_base = gu + (int64_t)(j0 + 2 * t) * d + i0 + g;
        auto entry = [&](int mt, int nt, int e, bool mirror) -> float* {
          const int di = 16 * mt + 8 * (e >> 1), dj = 8 * nt + (e & 1);
          if (!full) {
            const int i = i0 + g + di, j = j0 + 2 * t + dj;
            if (i >= d || j >= d || (diag && (mirror ? i >= j : i > j)))
              return nullptr;
          }
          return mirror ? col_base + dj * d + di : row_base + di * d + dj;
        };
        // The old (i, j) entries are loaded first, so that the loads are in
        // flight while the products run.
        float s[2][4][4], old[2][4][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float* at = entry(mt, nt, e, false);
              old[mt][nt][e] = at ? *at : 0.f;
              s[mt][nt][e] = 0.f;
            }
        if constexpr (BF) {
#pragma unroll
          for (int r0 = 0; r0 < R; r0 += 16) {
            uint32_t a[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              ldmatrix_x4_trans(
                  a[mt], f + (r0 + (lane & 7) + ((lane >> 4) << 3)) * ldf +
                             i0 + 16 * mt + ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int np = 0; np < 2; ++np) {
              uint32_t b[4];
              ldmatrix_x4_trans(
                  b, f + (r0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ldf +
                         j0 + 16 * np + ((lane >> 4) << 3));
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                mma_bf16(s[mt][2 * np], a[mt], b[0], b[1]);
                mma_bf16(s[mt][2 * np + 1], a[mt], b[2], b[3]);
              }
            }
          }
        } else {
#pragma unroll 2
          for (int r0 = 0; r0 < R; r0 += 8) {
            uint32_t ah[2][4], al[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              const float* fr = f + (r0 + t) * ldf + i0 + 16 * mt + g;
              split_tf32(fr[0], ah[mt][0], al[mt][0]);
              split_tf32(fr[8], ah[mt][1], al[mt][1]);
              split_tf32(fr[4 * ldf], ah[mt][2], al[mt][2]);
              split_tf32(fr[4 * ldf + 8], ah[mt][3], al[mt][3]);
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const float* fr = f + (r0 + t) * ldf + j0 + 8 * nt + g;
              uint32_t bh[2], bl[2];
              split_tf32(fr[0], bh[0], bl[0]);
              split_tf32(fr[4 * ldf], bh[1], bl[1]);
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
                mma_3xtf32(s[mt][nt], ah[mt], al[mt], bh, bl);
            }
          }
        }
        // acc[u] += s at (i, j); then the old mirror entries, all loaded
        // before any is written, and acc[u] += s at (j, i).
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (float* at = entry(mt, nt, e, false))
                *at = old[mt][nt][e] + s[mt][nt][e];
            }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float* at = entry(mt, nt, e, true);
              old[mt][nt][e] = at ? *at : 0.f;
            }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (float* at = entry(mt, nt, e, true))
                *at = old[mt][nt][e] + s[mt][nt][e];
            }
      }
    }
  };

  Step ahead{0, 0, 0, 0};  // the next step to copy
  for (int q = 0; q < stages - 1; ++q) {
    copy_step(ahead, q < total);
    advance(ahead);
  }
  Step cur{0, 0, 0, 0};  // the step to compute
  const int wc = 32 * pn;  // this warp's columns within a slab
  for (int q = 0; q < total; ++q) {
    if (stages > 1) {
      cp_async_wait_n(stages - 2);  // step q has landed (this thread)
      __syncthreads();              // ... for every thread; q - 1 is done
      copy_step(ahead, q + stages - 1 < total);  // into the slot q - 1 used
      advance(ahead);
    } else {
      __syncthreads();
      copy_step(cur, true);
      cp_async_wait<0>();
      __syncthreads();
    }
    const int n0 = cur.n0;
    const int kk = cur.kk;
    const bool live = pn < kSlab / 32 && n0 + wc < d_pad;  // warp-uniform
    if (live) project(cur.slot);
    if constexpr (!BF) {
      // fp32: the tensor cores' fp32 accumulation truncates, so a chain of
      // mma over all of m would drift (about 1 ulp an mma, one sign).
      // Every 32 columns of m (12 mma a chain) the accumulators are added
      // into a second register sum with IEEE adds, and restart.
      if (live && (kk % kFold == kFold - 1 || kk == nk - 1)) {
#pragma unroll
        for (int mt = 0; mt < MW; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              fs[mt][nt][e] += p[mt][nt][e];
              if (kk != nk - 1) p[mt][nt][e] = 0.f;
            }
      }
    }
    if (kk == nk - 1) {
      // The slab's F into shared memory (bf16: rounded).  Rows past c and
      // columns past d are zero (zero-filled operands).
      if (live) {
#pragma unroll
        for (int mt = 0; mt < MW; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int col = n0 + wc + 8 * nt + 2 * t;
            FT* lo = f + (prow + 16 * mt + g) * ldf + col;
            if constexpr (BF) {
              *reinterpret_cast<uint32_t*>(lo) =
                  pack_bf16(p[mt][nt][0], p[mt][nt][1]);
              *reinterpret_cast<uint32_t*>(lo + 8 * ldf) =
                  pack_bf16(p[mt][nt][2], p[mt][nt][3]);
            } else {
              *reinterpret_cast<float2*>(lo) =
                  make_float2(fs[mt][nt][0], fs[mt][nt][1]);
              *reinterpret_cast<float2*>(lo + 8 * ldf) =
                  make_float2(fs[mt][nt][2], fs[mt][nt][3]);
            }
          }
      }
      if (n0 + kSlab >= d_pad) {  // the row tile's last slab: F_t is whole
        __syncthreads();
        gram();
      }
      clear();
    }
    advance(cur);
  }
  cp_async_wait<0>();
}

template <bool BF, int MT>
int launch(const float* x, int64_t x_user_stride, const void* w, int ldw_g,
           float* acc, int n_users, int c, int m, int d, int stages,
           cudaStream_t stream) {
  using WT = typename std::conditional<BF, bf16, float>::type;
  const int smem = (int)smem_bytes(d, 16 * MT, stages, BF);
  auto kernel = featurize_gram_tc_kernel<BF, MT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec_x = m % 4 == 0 && x_user_stride % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  kernel<<<(unsigned)n_users, kThreads, (size_t)smem, stream>>>(
      x, x_user_stride, static_cast<const WT*>(w), ldw_g, acc, c, m, d,
      stages, vec_x);
  return (int)cudaGetLastError();
}

template <bool BF>
int launch_rows(int rows, const float* x, int64_t x_user_stride,
                const void* w, int ldw_g, float* acc, int n_users, int c,
                int m, int d, int stages, cudaStream_t stream) {
  if (rows == 64)
    return launch<BF, 4>(x, x_user_stride, w, ldw_g, acc, n_users, c, m, d,
                         stages, stream);
  if (rows == 32)
    return launch<BF, 2>(x, x_user_stride, w, ldw_g, acc, n_users, c, m, d,
                         stages, stream);
  return launch<BF, 1>(x, x_user_stride, w, ldw_g, acc, n_users, c, m, d,
                       stages, stream);
}

}  // namespace

// Shared-memory bytes of a launch with `rows` rows a tile and a ring of
// `stages` k-stages at width d (bf16 != 0: the bf16 compute path).
REPRO_EXPORT int64_t repro_featurize_gram_smem(int d, int rows, int stages,
                                               int bf16) {
  return smem_bytes(d, rows, stages, bf16 != 0);
}

// x (n_users, c, m) fp32, rows contiguous, users x_user_stride floats
// apart; w (m, ldw_g) fp32 (bf16 == 0) or bf16 (bf16 != 0), contiguous,
// 16-byte aligned, ldw_g a multiple of 8 >= d with columns past d zero;
// acc (n_users, d, d) fp32 contiguous, accumulated in place.  rows (64,
// 32 or 16) and stages (1-4) come from the wrapper's featurize_plan.
REPRO_EXPORT int repro_featurize_gram(const float* x, int64_t x_user_stride,
                                      const void* w, int ldw_g, float* acc,
                                      int n_users, int c, int m, int d,
                                      int bf16, int rows, int stages,
                                      void* stream) {
  if (n_users <= 0 || c <= 0 || m <= 0 || d <= 0) return 0;
  if ((rows != 64 && rows != 32 && rows != 16) || stages < 1 ||
      stages > kMaxStages || ldw_g < d || ldw_g % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(w) & 15) != 0 ||
      smem_bytes(d, rows, stages, bf16 != 0) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_rows<true>(rows, x, x_user_stride, w, ldw_g, acc, n_users,
                             c, m, d, stages, s);
  return launch_rows<false>(rows, x, x_user_stride, w, ldw_g, acc, n_users, c,
                            m, d, stages, s);
}
