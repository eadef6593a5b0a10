// Flash attention forward on the tensor cores, for bf16 q, k, v over
// (B, S, H, hd).  fp32 inputs take the CUDA-core kernel of
// flash_attention.cu; the wrapper chooses by dtype alone.
//
// Replaces src/repro/kernels/flash_attention/flash.py::flash_pallas
// (pallas_call at :83), which attention.py reaches with impl="pallas" on
// the training / prefill forward.
//
// Contract (the reference's): s = (q . k) * hd^-0.5 in fp32, masked
// (causal: key <= query; window w: query - key < w; positions from 0 on
// both axes), running row max m and row sum l, p = exp(s - m_new) (0
// where masked), acc = acc corr + p v in fp32, out = acc / max(l, 1e-20)
// in bf16, or in fp32 when the caller asks for it (the card's checks
// hold the fp32 function that way, without the output rounding).
//
// Bound on the H100: q.k runs once and p.v twice (below) on the bf16
// tensor cores, 6 hd operations per visible (query, key) pair at 989
// TFLOP/s, against Q, K, V and O moved once: 0.2085 ms at the dense
// prefill (2, 4096, 16, 128, causal), 0.1564 ms at the hybrid one (1,
// 4096, 16, 256, window 2048); compute-bound.
//
// Design (FlashAttention-2 on mma.sync m16n8k16, bf16 in, fp32 sums):
// a block of 4 warps owns 64 query rows of one (batch, head), 16 rows a
// warp, and walks key tiles of 64 (32 at hd = 256).  Blocks are issued
// longest rows first, so the causal tail is short.
//  - q.k on the bf16 operands: products of bf16 values are exact and the
//    tensor cores sum them in fp32, so s is the reference's up to the
//    order of summation.  Q sits in registers as A fragments (at hd = 256
//    it is read from shared memory each tile, to leave room for the
//    accumulator); K is read with ldmatrix as the B operand.
//  - p.v without giving up fp32 p: each p is split into p_hi = bf16(p)
//    and p_lo = bf16(p - p_hi), and p_hi v + p_lo v go into the same fp32
//    accumulator (v is bf16, so every product is exact).  p keeps about
//    16 significant bits, a relative error under 2^-17 per term; p
//    rounded to bf16 once would be off by up to 2^-9 and is another
//    function.  The score accumulators become the A fragments of p.v in
//    registers (the m16n8 C layout is the A layout of the next product),
//    with no trip through shared memory; V is read with ldmatrix.trans.
//  - K and V tiles arrive through cp.async (16-byte copies) into a ring
//    of two bf16 stages: the next tile's copies are in flight while the
//    current one computes.  Rows are padded by 16 bytes, so the 8 rows
//    of every ldmatrix fall in distinct banks.
//  - Key tiles that the causal mask or the window empties for every row
//    of the block are skipped; the mask arithmetic runs only on tiles
//    that straddle an edge (causal diagonal, window edge, Skv).  Keys
//    past Skv are zero-filled and masked, rows past S are not stored.
//  - Row max and sum: each row's 4 lanes (a quad) reduce the max with 2
//    shuffles; l stays per lane and is reduced once at the end.
//    Masked scores enter as -inf, with m starting at -1e30: p is then 0
//    where masked and a row that sees no key gives 0 (as the CUDA-core
//    kernel does).
// Registers and spills of each instantiation: build.log (-Xptxas -v).
#include <cuda_bf16.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;      // query rows per block, 16 per warp
constexpr int kThreads = 128;  // 4 warps
constexpr int kStages = 2;     // K/V ring depth
constexpr float kNeg = -1e30f;

__host__ __device__ constexpr int tile_keys(int hd) {
  return hd >= 256 ? 32 : 64;
}
// A padded shared-memory row of hd bf16 values (16 bytes of padding).
__host__ __device__ constexpr int row_elems(int hd) { return hd + 8; }
// Q [kRows], then K and V [kStages][tile_keys] rows.
__host__ __device__ constexpr int smem_bytes(int hd) {
  return (kRows + 2 * kStages * tile_keys(hd)) * row_elems(hd) *
         (int)sizeof(bf16);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// p_hi = bf16(p) and p_lo = bf16(p - p_hi) for a pair of probabilities,
// each as an A-fragment register (x in the low half).
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16_bits(h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

template <int HD, typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, OutT* __restrict__ o, int S,
                int Skv, int H, float scale_log2, int causal, int window) {
  constexpr int KN = tile_keys(HD);
  constexpr int LD = row_elems(HD);
  constexpr int KSTEPS = HD / 16;  // k16 steps of q.k
  constexpr int NS = KN / 8;       // n8 tiles of the score tile
  constexpr int NO = HD / 8;       // n8 tiles of the output
  constexpr int CH = HD / 8;       // 16-byte chunks per row
  constexpr bool QREG = HD <= 128;
  extern __shared__ __align__(16) unsigned char flash_tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(flash_tc_smem);  // [kRows][LD]
  bf16* ks = qs + kRows * LD;                         // [kStages][KN][LD]
  bf16* vs = ks + kStages * KN * LD;                  // [kStages][KN][LD]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int64_t rs = (int64_t)H * HD;
  const bf16* qb = q + ((int64_t)b * S * H + h) * HD;
  const bf16* kb = k + ((int64_t)b * Skv * H + h) * HD;
  const bf16* vb = v + ((int64_t)b * Skv * H + h) * HD;
  OutT* ob = o + ((int64_t)b * S * H + h) * HD;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int e = tid; e < kRows * CH; e += kThreads) {
    const int r = e / CH, c = e % CH;
    const bool live = q0 + r < S;
    cp_async16(qs + r * LD + c * 8,
               qb + (live ? (int64_t)(q0 + r) * rs + c * 8 : 0), live);
  }
  cp_async_commit();
  auto load_kv = [&](int kv0, int stage) {
    bf16* kd = ks + stage * KN * LD;
    bf16* vd = vs + stage * KN * LD;
    for (int e = tid; e < KN * CH; e += kThreads) {
      const int r = e / CH, c = e % CH;
      const bool live = kv0 + r < Skv;
      const int64_t off = live ? (int64_t)(kv0 + r) * rs + c * 8 : 0;
      cp_async16(kd + r * LD + c * 8, kb + off, live);
      cp_async16(vd + r * LD + c * 8, vb + off, live);
    }
  };

  // Key tiles that hold a visible key for some row of the block.
  int lo = 0, hi = Skv;
  if (window > 0) lo = max(0, q0 - window + 1);
  if (causal) hi = min(Skv, q0 + kRows);
  const int first = (lo / KN) * KN;
  const int n_tiles = first < hi ? (hi - first + KN - 1) / KN : 0;
  if (n_tiles > 0) load_kv(first, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  // ldmatrix lane offsets: A (Q) rows and columns; B from K (keys x
  // dims, two n8 tiles of one k16 step); B from V, transposed (keys x
  // dims, one k16 step of two n8 tiles).
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + (lane >> 4) * 8;
  const int k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int v_col = (lane >> 4) * 8;
  uint32_t qf[QREG ? KSTEPS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      ldmatrix_x4(qf[kk], qs + a_row * LD + kk * 16 + a_col);
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};
  const int r0 = q0 + warp * 16 + (lane >> 2);  // rows r0 and r0 + 8
  const int c0 = 2 * (lane & 3);                // fragment columns c0, c0 + 1

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = first + t * KN;
    if (t + 1 < n_tiles) load_kv(kv0 + KN, (t + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();
    const bf16* kt = ks + (t % kStages) * KN * LD;
    const bf16* vt = vs + (t % kStages) * KN * LD;

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
      } else {
        ldmatrix_x4(a, qs + a_row * LD + kk * 16 + a_col);
      }
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t bb[4];
        ldmatrix_x4(bb, kt + (j * 8 + k_row) * LD + kk * 16 + k_col);
        mma_bf16(s[j], a, bb[0], bb[1]);
        mma_bf16(s[j + 1], a, bb[2], bb[3]);
      }
    }

    // Scale into log2 units; -inf where masked, on edge tiles only.
    const bool edge = kv0 + KN > Skv || (causal && kv0 + KN - 1 > q0) ||
                      (window > 0 && q0 + kRows - 1 - kv0 >= window);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int row = r0 + (e >> 1) * 8;
          const int key = kv0 + j * 8 + c0 + (e & 1);
          const bool vis = key < Skv && (!causal || key <= row) &&
                           (window <= 0 || row - key < window);
          if (!vis) x = -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        rsum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rsum[i];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += p_hi v + p_lo v, one k16 step (16 keys) at a time.
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_pair(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_pair(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, vt + (kk * 16 + v_row) * LD + n * 8 + v_col);
        mma_bf16(acc[n], ph, bb[0], bb[1]);
        mma_bf16(acc[n], pl, bb[0], bb[1]);
        mma_bf16(acc[n + 1], ph, bb[2], bb[3]);
        mma_bf16(acc[n + 1], pl, bb[2], bb[3]);
      }
    }
    __syncthreads();  // this stage is read before it is loaded again
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float d0 = fmaxf(l[0], 1e-20f);
  const float d1 = fmaxf(l[1], 1e-20f);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (r0 < S)
      store2(ob + (int64_t)r0 * rs + n * 8 + c0, acc[n][0] / d0,
             acc[n][1] / d0);
    if (r0 + 8 < S)
      store2(ob + (int64_t)(r0 + 8) * rs + n * 8 + c0, acc[n][2] / d1,
             acc[n][3] / d1);
  }
}

template <int HD, typename OutT>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int Skv, int H, float scale, int causal, int window,
           cudaStream_t stream) {
  const int smem = smem_bytes(HD);
  auto kernel = flash_tc_kernel<HD, OutT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, repro_ceil_div(S, kRows));
  kernel<<<grid, kThreads, (size_t)smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<OutT*>(o), S, Skv, H,
      scale * 1.4426950408889634f, causal, window);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int B, int S, int Skv, int H, float scale, int causal,
              int window, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<16, OutT>(q, k, v, o, B, S, Skv, H, scale, causal,
                              window, stream);
    case 32:
      return launch<32, OutT>(q, k, v, o, B, S, Skv, H, scale, causal,
                              window, stream);
    case 64:
      return launch<64, OutT>(q, k, v, o, B, S, Skv, H, scale, causal,
                              window, stream);
    case 128:
      return launch<128, OutT>(q, k, v, o, B, S, Skv, H, scale, causal,
                               window, stream);
    case 256:
      return launch<256, OutT>(q, k, v, o, B, S, Skv, H, scale, causal,
                               window, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, S, H, hd), k and v (B, Skv, H, hd), bf16, contiguous and 16-byte
// aligned; o (B, S, H, hd) in bf16, or fp32 when out_fp32 != 0.  hd in
// {16, 32, 64, 128, 256}; S / 64 <= 65535.
REPRO_EXPORT int repro_flash_attention_tc(const void* q, const void* k,
                                          const void* v, void* o, int B,
                                          int S, int Skv, int H, int hd,
                                          float scale, int causal,
                                          int window, int out_fp32,
                                          void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (repro_ceil_div(S, kRows) > 65535)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  if (out_fp32)
    return launch_hd<float>(hd, q, k, v, o, B, S, Skv, H, scale, causal,
                            window, st);
  return launch_hd<bf16>(hd, q, k, v, o, B, S, Skv, H, scale, causal, window,
                         st);
}
