// Recurrent-scan kernels: the RWKV-6 WKV recurrence and the RG-LRU
// linear scan, stepped token by token in fp32.
//
// wkv replaces src/repro/kernels/recurrent_scan/recurrent_scan.py::
// wkv_chunked_pallas (pallas_call at :118), which rwkv6.py reaches with
// impl="pallas" on every prefill chunk.  Per (batch, head), with state
// S (hd_k, hd_v):
//   a_t = k_t v_t^T;  o_t = r_t (S + diag(u) a_t);  S <- diag(e^{logw_t}) S + a_t.
// Bound on the H100: about 4 hd^2 fp32 operations per token and head
// against 4 hd values read and hd written, so it is compute-bound once
// hd is above a few; the serving shape (B = 4, S = 64, H = 32, hd = 64)
// is small enough that launch and step latency dominate.
// Design: one block per (batch, head), one thread per value column j,
// which keeps column j of the state in registers (hd floats).  The block
// walks the tokens in order; each step stages r_t, k_t and e^{logw_t}
// in shared memory (double-buffered, one barrier a token).  The TPU
// kernel's chunk form (pairwise decay ratios turned into matrix
// products) is left for the tensor-core redesign.  The state update and
// the rank-1 term use separately rounded products and sums
// (__fmul_rn / __fadd_rn), the plain version's operations, so the final
// state matches it to rounding of the exponential alone.
//
// linear_scan replaces recurrent_scan.py::linear_scan_pallas (pallas_call
// at :187), which rglru.py reaches with impl="pallas": per channel,
// h_t = e^{log_a_t} h_{t-1} + x_t.  Bound: bytes (two reads and one
// write a step, two operations).  Design: one thread per (batch,
// channel), warps of 32 neighbouring channels so every load is
// coalesced, one warp a block so that B * D / 32 blocks spread over the
// SMs, and the next kScanAhead steps' operands loaded before they are
// needed (the recurrence itself is a dependent chain of a multiply and
// an add).  Separately rounded multiply and add, as the plain version.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ logw,
           const float* __restrict__ u, const float* __restrict__ s0,
           T* __restrict__ out, float* __restrict__ s_out, int S, int H) {
  __shared__ float rs[2][HD], ks[2][HD], ws[2][HD], us[HD];
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int j = threadIdx.x;

  float st[HD];  // st[i] = S[i][j]
  const float* s0b = s0 + (int64_t)bh * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) st[i] = s0b[i * HD + j];
  us[j] = u[h * HD + j];

  for (int t = 0; t < S; ++t) {
    const int buf = t & 1;
    const int64_t off = (((int64_t)b * S + t) * H + h) * HD;
    rs[buf][j] = to_f32(r[off + j]);
    ks[buf][j] = to_f32(k[off + j]);
    ws[buf][j] = expf(logw[off + j]);
    const float vj = to_f32(v[off + j]);
    __syncthreads();
    float o = 0.f;
#pragma unroll
    for (int i = 0; i < HD; ++i) {
      const float a = __fmul_rn(ks[buf][i], vj);
      o = fmaf(rs[buf][i], __fadd_rn(st[i], __fmul_rn(us[i], a)), o);
      st[i] = __fadd_rn(__fmul_rn(ws[buf][i], st[i]), a);
    }
    store(&out[off + j], o);
  }

  float* sb = s_out + (int64_t)bh * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) sb[i * HD + j] = st[i];
}

template <typename T, int HD>
int launch_wkv(const void* r, const void* k, const void* v, const float* logw,
               const float* u, const float* s0, void* out, float* s_out,
               int B, int S, int H, cudaStream_t stream) {
  wkv_kernel<T, HD><<<(unsigned)(B * H), HD, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, s0, static_cast<T*>(out), s_out, S,
      H);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wkv_hd(int hd, const void* r, const void* k, const void* v,
                  const float* logw, const float* u, const float* s0,
                  void* out, float* s_out, int B, int S, int H,
                  cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_wkv<T, 32>(r, k, v, logw, u, s0, out, s_out, B, S, H,
                               stream);
    case 64:
      return launch_wkv<T, 64>(r, k, v, logw, u, s0, out, s_out, B, S, H,
                               stream);
  }
  return (int)cudaErrorInvalidValue;
}

constexpr int kScanThreads = 32;  // one warp: 32 neighbouring channels
constexpr int kScanAhead = 16;    // steps whose operands are loaded early

__global__ void __launch_bounds__(kScanThreads)
linear_scan_kernel(const float* __restrict__ log_a,
                   const float* __restrict__ x, const float* __restrict__ h0,
                   float* __restrict__ h, float* __restrict__ h_last, int B,
                   int S, int D) {
  const int64_t idx = (int64_t)blockIdx.x * kScanThreads + threadIdx.x;
  if (idx >= (int64_t)B * D) return;
  const int64_t b = idx / D;
  const int64_t base = b * S * D + (idx - b * D);
  float hv = h0[idx];
  for (int t0 = 0; t0 < S; t0 += kScanAhead) {
    float la[kScanAhead], xv[kScanAhead];
#pragma unroll
    for (int s = 0; s < kScanAhead; ++s) {
      const int t = t0 + s;
      la[s] = t < S ? log_a[base + (int64_t)t * D] : 0.f;
      xv[s] = t < S ? x[base + (int64_t)t * D] : 0.f;
    }
#pragma unroll
    for (int s = 0; s < kScanAhead; ++s) {
      const int t = t0 + s;
      if (t < S) {
        hv = __fadd_rn(__fmul_rn(expf(la[s]), hv), xv[s]);
        h[base + (int64_t)t * D] = hv;
      }
    }
  }
  h_last[idx] = hv;
}

}  // namespace

// r, k, v, out (B, S, H, hd) fp32 (bf16 == 0) or bf16; logw (B, S, H, hd),
// u (H, hd), s0 and s_out (B, H, hd, hd) fp32; all contiguous.
// hd in {32, 64}.
REPRO_EXPORT int repro_wkv(const void* r, const void* k, const void* v,
                           const float* logw, const float* u, const float* s0,
                           void* out, float* s_out, int B, int S, int H,
                           int hd, int bf16, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch_wkv_hd<__nv_bfloat16>(hd, r, k, v, logw, u, s0, out, s_out,
                                        B, S, H, st);
  return launch_wkv_hd<float>(hd, r, k, v, logw, u, s0, out, s_out, B, S, H,
                              st);
}

// log_a, x, h (B, S, D) and h0, h_last (B, D), fp32 contiguous.
REPRO_EXPORT int repro_linear_scan(const float* log_a, const float* x,
                                   const float* h0, float* h, float* h_last,
                                   int B, int S, int D, void* stream) {
  const int64_t n = (int64_t)B * D;
  if (n <= 0) return 0;
  const int64_t blocks = (n + kScanThreads - 1) / kScanThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  linear_scan_kernel<<<(unsigned)blocks, kScanThreads, 0,
                       (cudaStream_t)stream>>>(log_a, x, h0, h, h_last, B, S,
                                               D);
  return (int)cudaGetLastError();
}
