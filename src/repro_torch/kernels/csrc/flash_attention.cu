// Flash attention forward on the CUDA cores, for fp32 q, k, v over
// (B, S, H, hd).  bf16 inputs take the tensor-core kernel of
// flash_attention_tc.cu; the wrapper chooses by dtype alone.  No model
// runs attention in fp32 on the card: this kernel serves fp32 callers and
// the card's fp32 checks.
//
// Replaces src/repro/kernels/flash_attention/flash.py::flash_pallas
// (pallas_call at :83), which attention.py reaches with impl="pallas" on
// the training / prefill forward.
//
// Contract (the reference's): s = (q . k) * hd^-0.5 in fp32, masked to
// -1e30 (causal: key <= query; window w: query - key < w; both as given,
// positions counted from 0 on both axes), running row max m, row sum l
// and an fp32 accumulator; p = exp(s - m_new) (0 where masked),
// corr = exp(m_old - m_new), l = l corr + sum p, acc = acc corr + p v in
// fp32; out = acc / max(l, 1e-20) in fp32.
//
// Bound on the H100: for a causal or windowed prefill the function needs
// 4 hd fp32 operations per visible (query, key) pair (67 TFLOP/s)
// against reading Q, K, V and writing O once, hundreds of operations per
// byte: compute-bound.
//
// Design (fp32 on the CUDA cores): one 128-thread block per (32 query rows,
// batch x head), walking key tiles of 64 (32 at hd = 256, to fit two blocks on
// an SM).  Tiles that the causal mask or the window empties for every row of
// the block are skipped (the reference visits them and adds nothing).  K and V
// tiles are read with 16-byte loads into registers one tile ahead, so the
// loads overlap the previous tile's arithmetic.  Q^T, K^T, V and the tile's
// probabilities (key-major) sit in shared memory as fp32.  Each thread owns 4
// query rows x 4 (or 2) neighbouring keys of the score tile and 4 rows x hd/16
// neighbouring columns of the accumulator, kept in registers, so every
// shared-memory read is a 16-byte vector feeding 8-16 FMAs; rows of Q^T and
// K^T are padded by 4 floats, which keeps those reads aligned.  Row statistics
// are reduced across the 16 lanes of a row group with shuffles.  Ragged S and
// Skv are masked: keys past Skv score -1e30 and rows past S are not stored, in
// place of the reference's padding.
#include "common.cuh"

namespace {

constexpr int kRows = 32;      // query rows per block
constexpr int kThreads = 128;  // 8 row groups x 16 lanes
constexpr int kPad = 4;        // floats of padding on transposed rows
constexpr float kNeg = -1e30f;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// 16 bytes of T (4 fp32) at a 16-byte aligned global address,
// through the read-only cache; zero when `live` is false.
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p, bool live) {
  return live ? __ldg(reinterpret_cast<const uint4*>(p))
              : make_uint4(0u, 0u, 0u, 0u);
}

// The 4 fp32 values of a 16-byte vector.
__device__ __forceinline__ void unpack(uint4 u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// N consecutive floats from 16-byte (N = 4, 8, 16), 8-byte (N = 2) or
// 4-byte aligned shared memory.
template <int N>
__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(src + i);
      dst[i] = t.x;
      dst[i + 1] = t.y;
      dst[i + 2] = t.z;
      dst[i + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x;
    dst[1] = t.y;
  } else {
    dst[0] = src[0];
  }
}

__host__ __device__ constexpr int tile_keys(int hd) {
  return hd >= 256 ? 32 : 64;
}

// Shared memory: Q^T [HD][kRows + kPad], K^T [HD][KEYS + kPad],
// V [KEYS][HD], P^T [KEYS][kRows + kPad], all fp32.
__host__ __device__ constexpr int smem_floats(int hd) {
  return hd * (kRows + kPad) + hd * (tile_keys(hd) + kPad) +
         tile_keys(hd) * hd + tile_keys(hd) * (kRows + kPad);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int Skv,
             int H, float scale, int causal, int window) {
  constexpr int KEYS = tile_keys(HD);
  constexpr int KP = KEYS / 16;   // keys per thread in the score tile
  constexpr int C = HD / 16;      // accumulator columns per thread
  constexpr int LQ = kRows + kPad;
  constexpr int LK = KEYS + kPad;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;               // [HD][LQ]
  float* kt = qt + HD * LQ;       // [HD][LK]
  float* vs = kt + HD * LK;       // [KEYS][HD]
  float* pt = vs + KEYS * HD;     // [KEYS][LQ]

  const int q0 = blockIdx.x * kRows;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int64_t row_stride = (int64_t)H * HD;
  const T* qb = q + ((int64_t)b * S * H + h) * HD;
  const T* kb = k + ((int64_t)b * Skv * H + h) * HD;
  const T* vb = v + ((int64_t)b * Skv * H + h) * HD;
  T* ob = o + ((int64_t)b * S * H + h) * HD;

  constexpr int VEC = 16 / sizeof(T);        // values per 16-byte load
  constexpr int CH = HD / VEC;               // 16-byte chunks per row
  constexpr int NV = KEYS * CH / kThreads;   // K (and V) chunks per thread
  static_assert(KEYS * CH % kThreads == 0,
                "a tile's chunks must divide among the threads");

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty * 4 .. + 3
  const int tx = tid & 15;  // keys tx * KP .. + KP - 1; columns tx * C ..

  // Q^T once: row-fast chunks, so the transposing stores hit
  // neighbouring banks.
  for (int e = tid; e < kRows * CH; e += kThreads) {
    const int r = e % kRows, ch = e / kRows;
    const int row = q0 + r;
    float f[VEC];
    unpack(load16(qb + row * row_stride + ch * VEC, row < S), f, T());
#pragma unroll
    for (int t = 0; t < VEC; ++t) qt[(ch * VEC + t) * LQ + r] = f[t];
  }

  // K and V tiles go through registers: the next tile's loads are issued
  // before the current tile's arithmetic and land while it runs.  K
  // chunks are key-fast (transposing stores), V chunks column-fast.
  uint4 kreg[NV], vreg[NV];
  auto fetch = [&](int kv0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = tid + i * kThreads;
      const int jk = e % KEYS, ck = e / KEYS;
      kreg[i] = load16(kb + (kv0 + jk) * row_stride + ck * VEC,
                       kv0 + jk < Skv);
      const int jv = e / CH, cv = e % CH;
      vreg[i] = load16(vb + (kv0 + jv) * row_stride + cv * VEC,
                       kv0 + jv < Skv);
    }
  };

  float m[4], l[4], acc[4][C];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    m[p] = kNeg;
    l[p] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[p][c] = 0.f;
  }

  // Key tiles that hold a visible key for some row of the block.
  int lo = 0, hi = Skv;
  if (window > 0) lo = max(0, q0 - window + 1);
  if (causal) hi = min(Skv, q0 + kRows);
  const int first = (lo / KEYS) * KEYS;
  if (first < hi) fetch(first);
  for (int kv0 = first; kv0 < hi; kv0 += KEYS) {
    __syncthreads();  // the previous tile's readers are done
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = tid + i * kThreads;
      float f[VEC];
      unpack(kreg[i], f, T());
      const int jk = e % KEYS, ck = e / KEYS;
#pragma unroll
      for (int t = 0; t < VEC; ++t) kt[(ck * VEC + t) * LK + jk] = f[t];
      unpack(vreg[i], f, T());
      float* dst = vs + (e / CH) * HD + (e % CH) * VEC;
#pragma unroll
      for (int t = 0; t < VEC; t += 4)
        *reinterpret_cast<float4*>(dst + t) =
            make_float4(f[t], f[t + 1], f[t + 2], f[t + 3]);
    }
    __syncthreads();
    if (kv0 + KEYS < hi) fetch(kv0 + KEYS);

    float s[4][KP];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int c = 0; c < KP; ++c) s[p][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], bk[KP];
      load_vec<4>(qt + d * LQ + ty * 4, a);
      load_vec<KP>(kt + d * LK + tx * KP, bk);
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int c = 0; c < KP; ++c) s[p][c] = fmaf(a[p], bk[c], s[p][c]);
    }

    float pv[KP][4];  // probabilities, key-major for the transposed store
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int qpos = q0 + ty * 4 + p;
      bool vis[KP];
      float m_cur = kNeg;
#pragma unroll
      for (int c = 0; c < KP; ++c) {
        const int kpos = kv0 + tx * KP + c;
        vis[c] = kpos < Skv && (!causal || kpos <= qpos) &&
                 (window <= 0 || qpos - kpos < window);
        s[p][c] = vis[c] ? s[p][c] * scale : kNeg;
        m_cur = fmaxf(m_cur, s[p][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, off));
      const float m_new = fmaxf(m[p], m_cur);
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < KP; ++c) {
        pv[c][p] = vis[c] ? expf(s[p][c] - m_new) : 0.f;
        rsum += pv[c][p];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      const float corr = expf(m[p] - m_new);
      l[p] = l[p] * corr + rsum;
      m[p] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[p][c] *= corr;
    }
#pragma unroll
    for (int c = 0; c < KP; ++c)
      *reinterpret_cast<float4*>(pt + (tx * KP + c) * LQ + ty * 4) =
          make_float4(pv[c][0], pv[c][1], pv[c][2], pv[c][3]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < KEYS; ++j) {
      float pj[4], vj[C];
      load_vec<4>(pt + j * LQ + ty * 4, pj);
      load_vec<C>(vs + j * HD + tx * C, vj);
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[p][c] = fmaf(pj[p], vj[c], acc[p][c]);
    }
  }

#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int row = q0 + ty * 4 + p;
    if (row >= S) continue;
    const float denom = fmaxf(l[p], 1e-20f);
#pragma unroll
    for (int c = 0; c < C; ++c)
      store(&ob[row * row_stride + tx * C + c], acc[p][c] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Skv, int H, float scale, int causal, int window,
           cudaStream_t stream) {
  const int smem = smem_floats(HD) * (int)sizeof(float);
  auto kernel = flash_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(repro_ceil_div(S, kRows), B * H);
  kernel<<<grid, kThreads, (size_t)smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Skv, H, scale, causal,
      window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int B, int S, int Skv, int H, float scale, int causal,
              int window, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, S, Skv, H, scale, causal, window,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, Skv, H, scale, causal, window,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, Skv, H, scale, causal, window,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, Skv, H, scale, causal, window,
                            stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, S, Skv, H, scale, causal, window,
                            stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o (B, S, H, hd); k, v (B, Skv, H, hd); all fp32, contiguous.  hd in
// {16, 32, 64, 128, 256}; B * H <= 65535.
REPRO_EXPORT int repro_flash_attention(const void* q, const void* k,
                                       const void* v, void* o, int B, int S,
                                       int Skv, int H, int hd, float scale,
                                       int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (B * H > 65535) return (int)cudaErrorInvalidConfiguration;
  return launch_hd<float>(hd, q, k, v, o, B, S, Skv, H, scale, causal,
                          window, (cudaStream_t)stream);
}
