// Recurrent-scan kernels: the RWKV-6 WKV recurrence in the chunk form on
// the tensor cores, and the RG-LRU linear scan stepped token by token.
//
// wkv replaces src/repro/kernels/recurrent_scan/recurrent_scan.py::
// wkv_chunked_pallas (pallas_call at :118), which rwkv6.py reaches with
// impl="pallas" on every prefill chunk.  Per (batch, head), with state
// S (hd_k, hd_v), token by token:
//   o_t = r_t (S + diag(u) k_t v_t^T);  S <- diag(e^{logw_t}) S + k_t v_t^T.
// The chunk form computes the same over sub-chunks of 16 tokens, with cum
// the running sum of logw inside a sub-chunk (<= 0), cum_prev = cum of
// the token before (0 for the first) and cum_last that of the last:
//   o = (r e^{cum_prev}) S + W v + (r . (u k)) v,
//   W[t][s] = sum_i r[t,i] e^{cum_prev[t,i] - cum[s,i]} k[s,i]  (s < t),
//   S' = e^{cum_last} S + (k e^{cum_last - cum})^T v.
// Every exponent is <= 0 (clamped, as the reference's min(diff, 0)), so
// nothing overflows however strong the decay.  Under compute "bf16" the
// operands the reference's kernel rounds are rounded to bf16 (r e^{cum_prev},
// S, r, k, each pairwise decay and W, k e^{cum_last - cum}, v) and the
// products run on bf16 mma.sync m16n8k16 with fp32 accumulators; under
// "fp32" they run as 3xTF32 mma.sync m16n8k8 (mma.cuh), which keeps
// fp32's accuracy.  The state is carried and returned in fp32.  Plain
// version: kernels/recurrent_scan/ref.py::wkv_chunked_ref.
// Bound on the H100 at the serving prefill's chunk (B = 4, S = 64, H = 32,
// hd = 64, bf16 r/k/v): about 4 hd^2 operations a token and head (0.13
// GFLOP) against 10.5 MB of operands and state moved once, 3.1 us: the
// bytes bind, and the token-step recurrence was latency-bound far above
// that.
// Design: one block per (batch, head), hd / 4 warps; state warp w < hd / 8
// owns value columns 8 w .. 8 w + 7 of the state, which stay in its
// registers in the mma accumulator layout for the whole sequence (value
// columns evolve independently, so a warp needs no other's state).  The
// pairwise W of a sub-chunk does not depend on the value column, so the
// block computes it once, elementwise, with every thread; the other warps
// are there for that work, the rounded operands and the bonus.  Each sub-chunk's r, k, v and
// logw come by 16-byte cp.async one sub-chunk ahead (zero-filled past S:
// a zero k and logw is an identity update), so no token waits on device
// memory.  Three barriers a sub-chunk: the operands landed; cum and the
// bonus; the rounded operands and W.  Then each warp runs its products.
//
// linear_scan replaces recurrent_scan.py::linear_scan_pallas (pallas_call
// at :187), which rglru.py reaches with impl="pallas": per channel,
// h_t = e^{log_a_t} h_{t-1} + x_t, with a separately rounded multiply and
// add, as the plain version (bit for bit).  Bound on the H100 at the
// hybrid prefill (B = 1, S = 4096, D = 4096): two reads and one write of
// 64 MiB, 60.1 us at 3.35 TB/s; the recurrence's dependent chain (one
// multiply and one add a token, about 8 cycles) is about 20 us, and the
// exponent does not depend on h.  So the kernel has to keep the memory
// busy: by Little's law over 26 KB in flight on each SM, where a warp's
// own loads a few steps ahead kept about 4 KB.
// Design: one block per (batch, 32-channel tile), one warp, a lane a
// channel.  The operands come through a ring of stages in shared memory
// (128 tokens x 32 channels of log_a and of x, 32 KB a stage, 4 stages):
// a lane issues the TMA loads (a 3-D tensor map over (B, S, D), boxes
// zero-filled past S and D, completion on an mbarrier) for stage k + 4
// as soon as stage k is consumed, so three stages (96 KB) are in flight
// while one is scanned.  The scan reads 16 tokens from shared memory (32
// neighbouring floats a token: no bank conflict), forms their exponents
// ahead of the chain, then steps, writing h into one of two output
// stages in shared memory; a lane stores each full output stage with one
// TMA bulk copy (clipped at S and D), so no store waits on the
// recurrence and the warp issues no store per token (a warp storing its
// own 128-byte row of h a token reaches about a third of the memory's
// rate).
// Where TMA cannot be used (D % 4 != 0, or a base off 16 bytes) every
// lane fills its own channel of the same ring with 4-byte cp.async and
// stores its h directly.  Tokens past S are never stepped or stored.  The
// plan (tokens, stages, route, shared memory) is repro_linear_scan_plan,
// mirrored by kernels/recurrent_scan/ops.py::linear_scan_plan.
#include <cuda_bf16.h>

#include <type_traits>

#include <string.h>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

constexpr int kSub = 16;  // tokens a sub-chunk

// Shared-memory layout of a wkv block (bytes; floats unless stated).
// Rows that mma fragments read are padded so that a warp's 8-byte loads
// of rows g = 0..7 fall in distinct banks.
template <typename T, int HD>
struct WkvSmem {
  static constexpr int kP = HD + 8;    // pitch of [.][HD] operand rows
  static constexpr int kQ = kSub + 8;  // pitch of [.][16] operand rows
  // A raw slot: r, k, v (rows of T), logw (fp32).
  static constexpr int kRaw = 3 * kSub * HD * (int)sizeof(T) + kSub * HD * 4;
  static constexpr int raw = 0;                          // 2 slots
  static constexpr int cum = raw + 2 * kRaw;             // [16][HD]
  static constexpr int rdec = cum + kSub * HD * 4;       // [16][kP]
  static constexpr int kdt = rdec + kSub * kP * 4;       // [HD][kQ]
  static constexpr int vt = kdt + HD * kQ * 4;           // [HD][kQ]
  static constexpr int wm = vt + HD * kQ * 4;            // [16][kQ]
  static constexpr int stt = wm + kSub * kQ * 4;         // [HD][kP]
  static constexpr int obon = stt + HD * kP * 4;         // [16][HD]
  static constexpr int dlast = obon + kSub * HD * 4;     // [HD]
  static constexpr int bonus = dlast + HD * 4;           // [16]
  static constexpr int us = bonus + kSub * 4;            // [HD]
  static constexpr int bytes = us + HD * 4;
};

// x rounded to bf16 under bf16 compute, else x.
template <bool kBF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (kBF16)
    return __bfloat162float(__float2bfloat16(x));
  else
    return x;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// c (16 x 8) += A (16 x K) B (K x 8), K = 16 ksteps16: A row-major at `a`
// (pitch lda, k contiguous), B stored n-major at `bt` (row n, pitch ldb, k
// contiguous); both hold values the compute type represents exactly.
// bf16: one m16n8k16 a step of 16; fp32: two 3xTF32 m16n8k8.
template <bool kBF16>
__device__ __forceinline__ void mma_rows(float (&c)[4], const float* a,
                                         int lda, const float* bt, int ldb,
                                         int ksteps16, int lane) {
  const int g = lane / 4;
  if constexpr (kBF16) {
    const int q = 2 * (lane % 4);
    for (int s = 0; s < ksteps16; ++s) {
      const int k0 = 16 * s + q;
      uint32_t af[4];
      float2 x;
      x = *reinterpret_cast<const float2*>(a + g * lda + k0);
      af[0] = pack_bf16(x.x, x.y);
      x = *reinterpret_cast<const float2*>(a + (g + 8) * lda + k0);
      af[1] = pack_bf16(x.x, x.y);
      x = *reinterpret_cast<const float2*>(a + g * lda + k0 + 8);
      af[2] = pack_bf16(x.x, x.y);
      x = *reinterpret_cast<const float2*>(a + (g + 8) * lda + k0 + 8);
      af[3] = pack_bf16(x.x, x.y);
      const float2 b0 = *reinterpret_cast<const float2*>(bt + g * ldb + k0);
      const float2 b1 =
          *reinterpret_cast<const float2*>(bt + g * ldb + k0 + 8);
      mma_bf16(c, af, pack_bf16(b0.x, b0.y), pack_bf16(b1.x, b1.y));
    }
  } else {
    const int t4 = lane % 4;
    for (int s = 0; s < 2 * ksteps16; ++s) {
      const int k0 = 8 * s + t4;
      uint32_t ah[4], al[4], bh[2], bl[2];
      split_tf32(a[g * lda + k0], ah[0], al[0]);
      split_tf32(a[(g + 8) * lda + k0], ah[1], al[1]);
      split_tf32(a[g * lda + k0 + 4], ah[2], al[2]);
      split_tf32(a[(g + 8) * lda + k0 + 4], ah[3], al[3]);
      split_tf32(bt[g * ldb + k0], bh[0], bl[0]);
      split_tf32(bt[g * ldb + k0 + 4], bh[1], bl[1]);
      mma_3xtf32(c, ah, al, bh, bl);
    }
  }
}

template <typename T, int HD, bool kBF16>
__global__ void __launch_bounds__(8 * HD)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ logw,
           const float* __restrict__ u, const float* __restrict__ s0,
           T* __restrict__ out, float* __restrict__ s_out, int S, int H) {
  using L = WkvSmem<T, HD>;
  constexpr int kNT = 8 * HD;          // hd / 4 warps
  constexpr int kStateWarps = HD / 8;  // the first half hold the state
  constexpr int kP = L::kP, kQ = L::kQ;
  constexpr int kRowT = HD * (int)sizeof(T) / 16;  // 16-byte chunks a row
  constexpr int kRowF = HD * 4 / 16;
  extern __shared__ __align__(16) unsigned char wkv_smem[];
  float* cum = reinterpret_cast<float*>(wkv_smem + L::cum);
  float* rdec = reinterpret_cast<float*>(wkv_smem + L::rdec);
  float* kdt = reinterpret_cast<float*>(wkv_smem + L::kdt);
  float* vt = reinterpret_cast<float*>(wkv_smem + L::vt);
  float* wm = reinterpret_cast<float*>(wkv_smem + L::wm);
  float* stt = reinterpret_cast<float*>(wkv_smem + L::stt);
  float* obon = reinterpret_cast<float*>(wkv_smem + L::obon);
  float* dlast = reinterpret_cast<float*>(wkv_smem + L::dlast);
  float* bonus = reinterpret_cast<float*>(wkv_smem + L::bonus);
  float* us = reinterpret_cast<float*>(wkv_smem + L::us);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int q = 2 * (lane % 4);
  const int j0 = 8 * warp;  // a state warp's value columns
  const int n_sub = (S + kSub - 1) / kSub;

  // Sub-chunk c's r, k, v and logw rows into raw slot c % 2, zero past S.
  auto load = [&](int c) {
    unsigned char* slot = wkv_smem + L::raw + (c % 2) * L::kRaw;
    const T* src[3] = {r, k, v};
#pragma unroll
    for (int a = 0; a < 3; ++a)
      for (int e = tid; e < kSub * kRowT; e += kNT) {
        const int tok = c * kSub + e / kRowT;
        const bool live = tok < S;
        const int64_t off =
            (((int64_t)b * S + (live ? tok : 0)) * H + h) * HD;
        cp_async16(slot + a * kSub * HD * (int)sizeof(T) + e * 16,
                   reinterpret_cast<const char*>(src[a] + off) +
                       (e % kRowT) * 16,
                   live);
      }
    for (int e = tid; e < kSub * kRowF; e += kNT) {
      const int tok = c * kSub + e / kRowF;
      const bool live = tok < S;
      const int64_t off = (((int64_t)b * S + (live ? tok : 0)) * H + h) * HD;
      cp_async16(slot + 3 * kSub * HD * (int)sizeof(T) + e * 16,
                 reinterpret_cast<const char*>(logw + off) + (e % kRowF) * 16,
                 live);
    }
  };

  // Sub-chunk 0's copies first: their latency overlaps the state's load.
  if (n_sub > 0) load(0);
  cp_async_commit();

  // The state: a state warp's columns j0 + q, + 1 of rows 16 m + g (+ 8),
  // in the accumulator layout; S^T rounded for the first products.
  constexpr int kMT = HD / 16;
  float st[kMT][4];
  const bool state_warp = warp < kStateWarps;
  const float* s0b = s0 + (int64_t)bh * HD * HD;
  if (state_warp) {
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 16 * m + g + 8 * hh;
        const float2 x =
            *reinterpret_cast<const float2*>(s0b + i * HD + j0 + q);
        st[m][2 * hh] = x.x;
        st[m][2 * hh + 1] = x.y;
        stt[(j0 + q) * kP + i] = rnd<kBF16>(x.x);
        stt[(j0 + q + 1) * kP + i] = rnd<kBF16>(x.y);
      }
  }
  for (int e = tid; e < HD; e += kNT) us[e] = u[h * HD + e];
  for (int e = tid; e < kSub * kQ; e += kNT) wm[e] = 0.f;

  for (int c = 0; c < n_sub; ++c) {
    if (c + 1 < n_sub) load(c + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // (A) sub-chunk c has landed; the last one is done
    const unsigned char* slot = wkv_smem + L::raw + (c % 2) * L::kRaw;
    const T* rs = reinterpret_cast<const T*>(slot);
    const T* ks = rs + kSub * HD;
    const T* vs = ks + kSub * HD;
    const float* lws = reinterpret_cast<const float*>(vs + kSub * HD);

    // (1) cum along the tokens, one key dim a thread; the bonus
    // r . (u k), a token a warp of the other threads.
    if (tid < HD) {
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        acc += lws[t * HD + tid];
        cum[t * HD + tid] = acc;
      }
      dlast[tid] = expf(acc);
    } else {
      constexpr int kBonusWarps = (kNT - HD) / 32;
      for (int t = (tid - HD) / 32; t < kSub; t += kBonusWarps) {
        float acc = 0.f;
        for (int i = lane; i < HD; i += 32)
          acc += (to_f32(rs[t * HD + i]) * us[i]) * to_f32(ks[t * HD + i]);
#pragma unroll
        for (int o = 16; o > 0; o /= 2)
          acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (lane == 0) bonus[t] = acc;
      }
    }
    __syncthreads();  // (B)

    // (2) The rounded operands, and W elementwise.
#pragma unroll
    for (int m = 0; m < kSub * HD / kNT; ++m) {
      const int e = tid + m * kNT;
      const int t = e / HD, i = e % HD;
      const float cp = t ? cum[(t - 1) * HD + i] : 0.f;
      const float cu = cum[t * HD + i];
      const float cl = cum[(kSub - 1) * HD + i];
      const float vv = to_f32(vs[t * HD + i]);
      rdec[t * kP + i] = rnd<kBF16>(to_f32(rs[t * HD + i]) * expf(cp));
      kdt[i * kQ + t] =
          rnd<kBF16>(to_f32(ks[t * HD + i]) * expf(fminf(cl - cu, 0.f)));
      vt[i * kQ + t] = rnd<kBF16>(vv);
      obon[t * HD + i] = bonus[t] * vv;
    }
    {
      // Pair p = t (t - 1) / 2 + s (s < t; 120 pairs), its key dims
      // split over kParts neighbouring threads.
      constexpr int kParts = kNT / 128;
      static_assert(kParts == 2 || kParts == 4, "pairs fill the block");
      constexpr int kSpan = HD / kParts;
      int p = tid / kParts;
      const int part = tid % kParts;
      const bool live = p < kSub * (kSub - 1) / 2;
      int t = 1;
      while (live && p >= t) {
        p -= t;
        ++t;
      }
      const int s = p;
      // The lanes of a warp read rows t and s of other pairs (rows a
      // multiple of 32 words apart): each starts its walk over its key
      // dims at its own offset, so that the 32 lanes read 32 banks.  The
      // exponent is <= 0 and its weight e^x at most 1, so ex2.approx's
      // error (with x log2 e rounded) stays below 1e-7 of a term.
      constexpr bool kRoundIn = kBF16 && !std::is_same<T, __nv_bfloat16>::value;
      const int rot = lane / kParts + (part / 2) * (32 / kParts);
      float acc = 0.f;
      if (live) {
        const int i0 = part * kSpan;
#pragma unroll 8
        for (int m = 0; m < kSpan; ++m) {
          const int i = i0 + (m + rot) % kSpan;
          const float a =
              __expf(fminf(cum[(t - 1) * HD + i] - cum[s * HD + i], 0.f));
          acc += (rnd<kRoundIn>(to_f32(rs[t * HD + i])) * rnd<kBF16>(a)) *
                 rnd<kRoundIn>(to_f32(ks[s * HD + i]));
        }
      }
#pragma unroll
      for (int o = 1; o < kParts; o *= 2)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (live && part == 0) wm[t * kQ + s] = rnd<kBF16>(acc);
    }
    __syncthreads();  // (C)
    if (!state_warp) continue;

    // (3) This warp's products: o = r_dec S + W v + bonus v, then
    // S = e^{cum_last} S + k_dec^T v, for columns j0 .. j0 + 7.
    float os[4] = {0.f, 0.f, 0.f, 0.f}, oi[4] = {0.f, 0.f, 0.f, 0.f};
    mma_rows<kBF16>(os, rdec, kP, stt + j0 * kP, kP, HD / 16, lane);
    mma_rows<kBF16>(oi, wm, kQ, vt + j0 * kQ, kQ, 1, lane);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = g + 8 * hh, tok = c * kSub + t;
      if (tok < S) {
        const float* ob = obon + t * HD + j0 + q;
        const int64_t off = (((int64_t)b * S + tok) * H + h) * HD + j0 + q;
        store2(out + off, (os[2 * hh] + oi[2 * hh]) + ob[0],
               (os[2 * hh + 1] + oi[2 * hh + 1]) + ob[1]);
      }
    }
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      float pk[4] = {0.f, 0.f, 0.f, 0.f};
      mma_rows<kBF16>(pk, kdt + 16 * m * kQ, kQ, vt + j0 * kQ, kQ, 1, lane);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 16 * m + g + 8 * hh;
        const float dl = dlast[i];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = __fadd_rn(__fmul_rn(dl, st[m][2 * hh + e]),
                                    pk[2 * hh + e]);
          st[m][2 * hh + e] = x;
          stt[(j0 + q + e) * kP + i] = rnd<kBF16>(x);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!state_warp) return;

  float* sb = s_out + (int64_t)bh * HD * HD;
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      store2(sb + (16 * m + g + 8 * hh) * HD + j0 + q, st[m][2 * hh],
             st[m][2 * hh + 1]);
}

template <typename T, int HD, bool kBF16>
int launch_wkv(const void* r, const void* k, const void* v, const float* logw,
               const float* u, const float* s0, void* out, float* s_out,
               int B, int S, int H, cudaStream_t stream) {
  constexpr int bytes = WkvSmem<T, HD>::bytes;
  auto kernel = wkv_kernel<T, HD, kBF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(B * H), 8 * HD, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, s0, static_cast<T*>(out), s_out, S,
      H);
  return (int)cudaGetLastError();
}

template <typename T, bool kBF16>
int launch_wkv_hd(int hd, const void* r, const void* k, const void* v,
                  const float* logw, const float* u, const float* s0,
                  void* out, float* s_out, int B, int S, int H,
                  cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_wkv<T, 32, kBF16>(r, k, v, logw, u, s0, out, s_out, B, S,
                                      H, stream);
    case 64:
      return launch_wkv<T, 64, kBF16>(r, k, v, logw, u, s0, out, s_out, B, S,
                                      H, stream);
  }
  return (int)cudaErrorInvalidValue;
}

constexpr int kScanLanes = 32;    // channels a block: a warp, a lane each
constexpr int kScanUnroll = 16;   // tokens whose exponents go ahead
constexpr int kScanTokens = 128;  // tokens a stage (the plan's)
constexpr int kScanStages = 4;    // stages in the ring (the plan's)

constexpr int kScanStage = kScanTokens * kScanLanes;  // floats an array

// Shared memory of a scan block: the ring (log_a and x, a stage of each
// a slot), two output stages, then one mbarrier a slot.
constexpr int64_t kScanSmem =
    (int64_t)kScanStages * (2 * kScanStage * 4 + 8) + 2 * kScanStage * 4;

// Stage k of a block's operands into its slot of the ring: by TMA (lane
// 0, both boxes on the slot's mbarrier), or each lane its own channel by
// 4-byte cp.async, zero-filled past S and D.
template <bool kTma>
__device__ __forceinline__ void scan_issue(
    const CUtensorMap* map_a, const CUtensorMap* map_x,
    const float* __restrict__ log_a, const float* __restrict__ x, float* ring,
    uint64_t* full, int k, int b, int c0, int S, int D) {
  const int lane = threadIdx.x;
  const int slot = k % kScanStages;
  float* sa = ring + (size_t)slot * 2 * kScanStage;
  float* sx = sa + kScanStage;
  if (kTma) {
    if (lane == 0) {
      fence_proxy_async();  // the slot's earlier reads before the copy
      mbar_expect_tx(&full[slot], 2 * kScanStage * 4);
      tma_load_3d(sa, map_a, &full[slot], c0, k * kScanTokens, b);
      tma_load_3d(sx, map_x, &full[slot], c0, k * kScanTokens, b);
    }
    return;
  }
  const int c = c0 + lane;
  const int64_t row0 = (int64_t)b * S + (int64_t)k * kScanTokens;
  for (int u = 0; u < kScanTokens; ++u) {
    const bool ok = c < D && k * kScanTokens + u < S;
    const int64_t off = ok ? (row0 + u) * D + c : 0;
    cp_async4(sa + u * kScanLanes + lane, log_a + off, ok);
    cp_async4(sx + u * kScanLanes + lane, x + off, ok);
  }
  cp_async_commit();
}

// kTma: operands by TMA, and each stage of h staged in shared memory and
// stored by TMA, one bulk copy a stage; else 4-byte cp.async in and a
// coalesced store a token out.
template <bool kTma>
__global__ void __launch_bounds__(kScanLanes)
linear_scan_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_h,
                   const float* __restrict__ log_a,
                   const float* __restrict__ x, const float* __restrict__ h0,
                   float* __restrict__ h, float* __restrict__ h_last, int S,
                   int D, int tiles) {
  extern __shared__ __align__(128) unsigned char scan_smem[];
  float* ring = reinterpret_cast<float*>(scan_smem);
  float* out = ring + (size_t)kScanStages * 2 * kScanStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(out + 2 * kScanStage);
  const int lane = threadIdx.x;
  const int b = blockIdx.x / tiles;
  const int c0 = (blockIdx.x - b * tiles) * kScanLanes;
  const int c = c0 + lane;
  const bool live = c < D;
  const int n_stages = (S + kScanTokens - 1) / kScanTokens;
  if (kTma && lane == 0) {
    for (int k = 0; k < kScanStages; ++k) mbar_init(&full[k], 1);
    mbar_init_fence();
  }
  __syncwarp();
  for (int k = 0; k < min(kScanStages, n_stages); ++k)
    scan_issue<kTma>(&map_a, &map_x, log_a, x, ring, full, k, b, c0, S, D);

  float hv = live ? h0[(int64_t)b * D + c] : 0.f;
  for (int k = 0; k < n_stages; ++k) {
    const int slot = k % kScanStages;
    if (kTma) {
      mbar_wait(&full[slot], (k / kScanStages) & 1);
      if (lane == 0) bulk_wait_read<1>();  // stage k - 2's store has read
      __syncwarp();                         // its output buffer
    } else {
      cp_async_wait_n(min(kScanStages - 1, n_stages - 1 - k));
    }
    const float* sa = ring + (size_t)slot * 2 * kScanStage + lane;
    const float* sx = sa + kScanStage;
    float* so = out + (size_t)(k % 2) * kScanStage + lane;
    const int count = min(kScanTokens, S - k * kScanTokens);
    float* hp = h + ((int64_t)b * S + (int64_t)k * kScanTokens) * D + c;
    int u0 = 0;
    for (; u0 + kScanUnroll <= count; u0 += kScanUnroll) {
      float e[kScanUnroll], xv[kScanUnroll];
#pragma unroll
      for (int q = 0; q < kScanUnroll; ++q) {
        e[q] = expf(sa[(u0 + q) * kScanLanes]);
        xv[q] = sx[(u0 + q) * kScanLanes];
      }
#pragma unroll
      for (int q = 0; q < kScanUnroll; ++q) {
        hv = __fadd_rn(__fmul_rn(e[q], hv), xv[q]);
        if (kTma)
          so[(u0 + q) * kScanLanes] = hv;
        else if (live)
          hp[(int64_t)(u0 + q) * D] = hv;
      }
    }
    for (; u0 < count; ++u0) {
      hv = __fadd_rn(__fmul_rn(expf(sa[u0 * kScanLanes]), hv),
                     sx[u0 * kScanLanes]);
      if (kTma)
        so[u0 * kScanLanes] = hv;
      else if (live)
        hp[(int64_t)u0 * D] = hv;
    }
    if (kTma) fence_proxy_async();  // this lane's h before the bulk store
    __syncwarp();                   // and every lane is done with the slot
    if (kTma && lane == 0)
      tma_store_3d(&map_h, so - lane, c0, k * kScanTokens, b);
    if (k + kScanStages < n_stages)
      scan_issue<kTma>(&map_a, &map_x, log_a, x, ring, full, k + kScanStages,
                       b, c0, S, D);
  }
  if (live) h_last[(int64_t)b * D + c] = hv;
  if (kTma && lane == 0) bulk_wait_all();
}

}  // namespace

// r, k, v, out (B, S, H, hd) fp32 (bf16 == 0) or bf16, 16-byte aligned;
// logw (B, S, H, hd), u (H, hd), s0 and s_out (B, H, hd, hd) fp32; all
// contiguous.  hd in {32, 64}; compute_bf16: the reference's bf16
// roundings and bf16 products, else fp32 (3xTF32) products.
REPRO_EXPORT int repro_wkv(const void* r, const void* k, const void* v,
                           const float* logw, const float* u, const float* s0,
                           void* out, float* s_out, int B, int S, int H,
                           int hd, int bf16, int compute_bf16, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16 && compute_bf16)
    return launch_wkv_hd<__nv_bfloat16, true>(hd, r, k, v, logw, u, s0, out,
                                              s_out, B, S, H, st);
  if (bf16)
    return launch_wkv_hd<__nv_bfloat16, false>(hd, r, k, v, logw, u, s0, out,
                                               s_out, B, S, H, st);
  if (compute_bf16)
    return launch_wkv_hd<float, true>(hd, r, k, v, logw, u, s0, out, s_out,
                                      B, S, H, st);
  return launch_wkv_hd<float, false>(hd, r, k, v, logw, u, s0, out, s_out, B,
                                     S, H, st);
}

// The scan's plan for (B, S, D): tokens a stage and stages (through the
// pointers), the route (1: TMA, where D % 4 == 0, S > 0 and log_a, x and
// h start 16-byte aligned; 0: 4-byte cp.async), and the block's shared
// memory (returned).  kernels/recurrent_scan/ops.py::linear_scan_plan
// computes the same.
REPRO_EXPORT int64_t repro_linear_scan_plan(int B, int S, int D, int aligned,
                                            int* tokens, int* stages,
                                            int* tma) {
  (void)B;
  *tokens = kScanTokens;
  *stages = kScanStages;
  *tma = aligned && D % 4 == 0 && S > 0;
  return kScanSmem;
}

// log_a, x, h (B, S, D) and h0, h_last (B, D), fp32 contiguous; tma as
// the plan gives it.
REPRO_EXPORT int repro_linear_scan(const float* log_a, const float* x,
                                   const float* h0, float* h, float* h_last,
                                   int B, int S, int D, int tma,
                                   void* stream) {
  if (B <= 0 || D <= 0) return 0;
  if (S < 0) return (int)cudaErrorInvalidValue;
  const int tiles = repro_ceil_div(D, kScanLanes);
  const int64_t blocks = (int64_t)B * tiles;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap map_a, map_x, map_h;
  memset(&map_a, 0, sizeof(map_a));
  memset(&map_x, 0, sizeof(map_x));
  memset(&map_h, 0, sizeof(map_h));
  if (tma) {
    if (D % 4 || S == 0 || reinterpret_cast<uintptr_t>(log_a) % 16 ||
        reinterpret_cast<uintptr_t>(x) % 16 ||
        reinterpret_cast<uintptr_t>(h) % 16)
      return (int)cudaErrorMisalignedAddress;
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)D * 4,
                                   (cuuint64_t)S * D * 4};
    const cuuint32_t box[3] = {kScanLanes, kScanTokens, 1};
    int rc = encode_f32_3d(&map_a, log_a, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_NONE);
    if (!rc)
      rc = encode_f32_3d(&map_x, x, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
    if (!rc)
      rc = encode_f32_3d(&map_h, h, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
    if (rc) return rc;
  }
  auto kernel = tma ? linear_scan_kernel<true> : linear_scan_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kScanSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kScanLanes, (size_t)kScanSmem,
           (cudaStream_t)stream>>>(map_a, map_x, map_h, log_a, x, h0, h,
                                   h_last, S, D, tiles);
  return (int)cudaGetLastError();
}
