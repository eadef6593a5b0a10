// NN-chain HAC on the device: the fused Lance-Williams row update with a
// masked first-index argmax, and the whole NN-chain loop.
//
// Replaces src/repro/kernels/linkage/linkage.py::linkage_step_pallas
// (pallas_call at :88), which the reference calls about 4n times from
// inside the jitted while_loop of core/cluster_engine.py::_nn_chain.
//
//   (a) repro_linkage_step: one launch of the step with the reference's
//       contract (row_a, row_b, size_a, size_b, mask) -> (row, argmax,
//       max), kept so the step can be held against its plain version.
//   (b) repro_nn_chain: the whole NN-chain in one call, a first pass over
//       R with many blocks, then one persistent block for the chain; over
//       a group axis, B independent chains on s (B, n, n) in one call
//       (the hierarchical protocol's group stage, which the reference
//       vmaps): the first pass over all B n rows, then one block a group,
//       each with its own slice of the scratch, its own merges, heights
//       and counters.  A group whose R holds NaN stops short alone.
//
// Bound on the H100: a few operations an element, so the bytes bound the
// function: R (n^2 fp32) read once, 1.3 us at n = 1024.  The loop itself
// is a dependent chain of about 3n iterations (at the dense cell 2,026
// chain extensions and 1,023 merges): each must know the last one's
// result, so its floor is iterations x the latency of one step, not the
// bytes.
//
// Design (b): every live row's nearest neighbour is cached: the masked
// first-index argmax of its extension values, lance_williams(r, r, 1, 1)
// (r itself but for an average of |r| > FLT_MAX / 2, which overflows as
// the plain loop's step does), kept as an order-preserving rank key.
//  - The first pass (nn_init_kernel, a warp a row, many blocks) fills the
//    cache: at n = 20,000 R is 1.6 GB, which one block would take far
//    longer to read.
//  - A chain extension reads the cache and s[top][prev] and nothing else:
//    no row pass, no reduction, no barrier.
//  - A merge of (i, j) into i is one pass over rows i and j by the block:
//    it writes the new row and column i at live entries (dead rows and
//    columns are never read again, so they are not written), ranks row
//    i's new nearest neighbour, and updates every live row c against its
//    new entry at column i.  Where c's neighbour was i or j and the new
//    entry ranks below it, c goes on a list and is rescanned, a warp a
//    row, the rows side by side (3.3 a merge on the dense cell's R).
//    Three block barriers a merge: before its writes, after the pass,
//    after the rescans.
//  - What bounds a step is latency, so each is short: ranks are unsigned
//    keys reduced across a warp by redux.sync, selects in place of
//    branches, one linkage's code a kernel (a template parameter).
//  - The per-leaf state (cache, sizes, alive flags, chain, rescan list;
//    21 n bytes) lives in shared memory up to 11,019 leaves and in the
//    wrapper's device scratch above, so no n is refused that the card
//    can hold (the plan: repro_nn_chain_plan, linkage/ops.py::chain_plan).
// Plain model of the cache: kernels/linkage/ref.py::nn_chain_cached_ref.
//
// Probe builds (chip_smoke.py phase 4 compiles this file alone into
// build/ with one of these; the library is built with neither):
//  - REPRO_NN_CHAIN_SCRATCH keeps the state in the scratch at every n, to
//    time that route against shared memory at the same n;
//  - REPRO_NN_CHAIN_CLOCKS has thread 0 sum clock64() over each phase of
//    the loop, read back by repro_nn_chain_clocks (the phases are named
//    in chip_smoke.py::CHAIN_PHASES).
//
// Numerics match the plain PyTorch version bit for bit: the average
// linkage is evaluated with round-to-nearest intrinsics in the
// reference's order, (na*a + nb*b) / (na + nb), so the compiler cannot
// contract it into an FMA.  Ties resolve to the smallest index, and NaN
// ranks above every number, as torch.argmax and jnp.argmax do; an
// all--inf row gives index 0.
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

enum Linkage { kAverage = 0, kSingle = 1, kComplete = 2 };

__device__ __forceinline__ float lance_williams(float a, float b, float na,
                                                float nb, int linkage) {
  if (linkage == kAverage)
    return __fdiv_rn(__fadd_rn(__fmul_rn(na, a), __fmul_rn(nb, b)),
                     __fadd_rn(na, nb));
  if (isnan(a) || isnan(b)) return a + b;  // NaN propagates, as torch.maximum
  return linkage == kSingle ? fmaxf(a, b) : fminf(a, b);
}

// True when (v, i) ranks before (bv, bi) in argmax order.
__device__ __forceinline__ bool ranks_first(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn != bn) return vn;
  if (!vn && v != bv) return v > bv;
  return i < bi;
}

// Block-wide argmax of each thread's (v, i); every thread gets the result.
__device__ __forceinline__ void block_argmax(float& v, int& i, float* sv,
                                             int* si) {
  const unsigned full = 0xffffffffu;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(full, v, off);
    const int oi = __shfl_down_sync(full, i, off);
    if (ranks_first(ov, oi, v, i)) { v = ov; i = oi; }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { sv[warp] = v; si[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? sv[lane] : -INFINITY;
    i = lane < kWarps ? si[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(full, v, off);
      const int oi = __shfl_down_sync(full, i, off);
      if (ranks_first(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) { sv[kWarps] = v; si[kWarps] = i; }
  }
  __syncthreads();
  v = sv[kWarps];
  i = si[kWarps];
  __syncthreads();  // sv/si are free for the next reduction
}

__global__ void __launch_bounds__(kThreads)
linkage_step_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float na, float nb, const float* __restrict__ mask,
                    float* __restrict__ row, int* idx, float* val, int n,
                    int linkage) {
  __shared__ float sv[kWarps + 1];
  __shared__ int si[kWarps + 1];
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int c = threadIdx.x; c < n; c += kThreads) {
    const float x =
        mask[c] > 0.5f ? lance_williams(a[c], b[c], na, nb, linkage) : -INFINITY;
    row[c] = x;
    if (ranks_first(x, c, bv, bi)) { bv = x; bi = c; }
  }
  block_argmax(bv, bi, sv, si);
  if (threadIdx.x == 0) { *idx = bi; *val = bv; }
}

// -- the NN-chain ------------------------------------------------------------

constexpr int kChainThreads = 512;
constexpr int kChainWarps = kChainThreads / 32;
constexpr int kInitWarps = 8;  // rows a block of the first pass
constexpr int kPassAhead = 2;  // columns a thread loads before it updates
// Shared memory a block may use (opt-in maximum), less a reserve for the
// chain kernel's static arrays.
constexpr int64_t kSmemLimit = 232448 - 1024;

// The value the chain-extension step ranks for entry r:
// lance_williams(r, r, 1, 1), as the plain loop's step gives it.  For
// the average that is (r + r) / 2: r itself, since r + r is exact, except
// that it overflows to +-inf where |r| > FLT_MAX / 2; NaN stays NaN.  So
// it is formed without the division, bit for bit (a NaN's payload aside,
// which nothing reads).
__device__ __forceinline__ float extension_value(float r, int linkage) {
  return linkage == kAverage && fabsf(r) > 0x1.fffffep126f
             ? copysignf(INFINITY, r)
             : r;
}

// A key that orders values as ranks_first does: NaN above every number
// (one key for all NaNs), -0 and +0 alike.  Every value's key exceeds 0.
__device__ __forceinline__ uint32_t rank_key(float v) {
  const uint32_t b = __float_as_uint(v == 0.f ? 0.f : v);
  return isnan(v) ? 0xffffffffu : (b >> 31) ? ~b : (b | 0x80000000u);
}

// The value of a key (a NaN for NaN's key).
__device__ __forceinline__ float key_value(uint32_t k) {
  return k == 0xffffffffu ? __uint_as_float(0x7fffffffu)
         : (k >> 31)      ? __uint_as_float(k & 0x7fffffffu)
                          : __uint_as_float(~k);
}

constexpr uint32_t kKeyNegInf = 0x007fffffu;  // rank_key(-inf)

// A running argmax over (key, index) pairs visited in increasing index
// order: a later pair wins only by a larger key.  Runs start at (0,
// INT_MAX), below every key.
__device__ __forceinline__ void visit(uint32_t k, int i, uint32_t& bk,
                                      int& bi) {
  const bool take = k > bk;
  bk = take ? k : bk;
  bi = take ? i : bi;
}

// Argmax over the warp's (key, index) pairs, the smallest index among
// the largest key, by two warp reductions; every lane gets it.
__device__ __forceinline__ void warp_argmax(uint32_t& k, int& i) {
  const uint32_t m = __reduce_max_sync(0xffffffffu, k);
  i = (int)__reduce_min_sync(0xffffffffu, k == m ? (uint32_t)i : 0xffffffffu);
  k = m;
}

#ifdef REPRO_NN_CHAIN_CLOCKS
constexpr int kClockPhases = 9;
__device__ unsigned long long chain_clocks[kClockPhases];
// Adds the cycles since the last mark to phase p (thread 0; p is a
// constant at every mark, so the sums stay in registers).
#define CHAIN_CLOCK(p)                       \
  do {                                       \
    const long long now_ = clock64();        \
    clk[p] += now_ - mark;                   \
    mark = now_;                             \
  } while (0)
#else
#define CHAIN_CLOCK(p) \
  do {                 \
  } while (0)
#endif

// Per-leaf state of the chain.  Its layout in words, the same in shared
// memory and in the wrapper's device scratch: nnk (n), the rank key of
// each row's nearest-neighbour value, nni (n), size (n), chain (n + 1),
// rescan list (n), then alive as n bytes.  The first pass writes nnk,
// nni, size and alive to the scratch.
struct ChainState {
  uint32_t* nnk;
  int* nni;
  float* size;
  int* chain;
  int* list;
  unsigned char* alive;
  __device__ ChainState(void* base, int n) {
    int* w = static_cast<int*>(base);
    nnk = reinterpret_cast<uint32_t*>(w);
    nni = w + n;
    size = reinterpret_cast<float*>(w + 2 * n);
    chain = w + 3 * n;
    list = w + 4 * n + 1;
    alive = reinterpret_cast<unsigned char*>(w + 5 * n + 1);
  }
};

__host__ __device__ constexpr int64_t chain_state_bytes(int n) {
  return 4 * (5 * (int64_t)n + 1) + (((int64_t)n + 15) / 16) * 16;
}

// Masked first-index argmax of row c's extension values over the live
// columns other than c, by one warp (every lane gets it).  Every column
// is visited, a masked one as -inf, so an all--inf row gives index 0.
// vec: float4 reads (n % 4 == 0 and s 16-byte aligned), eight groups a
// lane requested before any is ranked.  The ranking is branch-free:
// every key is formed and a masked one replaced by select (a branch per
// element, with its reconvergence, cost several times the arithmetic).
// alive null: every column live (the first pass).
template <int kLinkage>
__device__ __forceinline__ void row_argmax(const float* row, int c, int n,
                                           const unsigned char* alive,
                                           bool vec, uint32_t& bk, int& bi) {
  constexpr int kAhead = 8;
  const int lane = threadIdx.x & 31;
  bk = 0;
  bi = INT_MAX;
  if (vec) {
    const int groups = n / 4;
    for (int g0 = 0; g0 < groups; g0 += 32 * kAhead) {
      float4 r[kAhead];
      uint32_t a[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int g = g0 + 32 * u + lane;
        const bool in = g < groups;
        r[u] = in ? reinterpret_cast<const float4*>(row)[g]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
        a[u] = !in ? 0u
               : alive == nullptr
                   ? 0x01010101u
                   : reinterpret_cast<const uint32_t*>(alive)[g];
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int g = g0 + 32 * u + lane;
        const float rv[4] = {r[u].x, r[u].y, r[u].z, r[u].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = 4 * g + q;
          const uint32_t key = rank_key(extension_value(rv[q], kLinkage));
          const bool live = ((a[u] >> (8 * q)) & 0xff) && k != c;
          visit(g < groups ? (live ? key : kKeyNegInf) : 0u, k, bk, bi);
        }
      }
    }
  } else {
    for (int k = lane; k < n; k += 32) {
      const uint32_t key = rank_key(extension_value(row[k], kLinkage));
      const bool live = (alive == nullptr || alive[k]) && k != c;
      visit(live ? key : kKeyNegInf, k, bk, bi);
    }
  }
  warp_argmax(bk, bi);
}

// First pass: every row's nearest neighbour (all leaves live), a warp a
// row, over the rows of every group of the batch (group b's matrix and
// state words b n^2 and b state_words on); sizes 1, all alive.
template <int kLinkage>
__global__ void __launch_bounds__(kInitWarps * 32)
nn_init_kernel(const float* s, int n, int64_t rows, int64_t state_words,
               int* scratch) {
  const int64_t row = (int64_t)blockIdx.x * kInitWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int64_t b = row / n;
  const int c = (int)(row % n);
  s += b * n * n;
  ChainState st(scratch + b * state_words, n);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(s) % 16 == 0;
  uint32_t bk;
  int bi;
  row_argmax<kLinkage>(s + (int64_t)c * n, c, n, nullptr, vec, bk, bi);
  if (threadIdx.x % 32 == 0) {
    st.nnk[c] = bk;
    st.nni[c] = bi;
    st.size[c] = 1.f;
    st.alive[c] = 1;
  }
}

// The NN-chain loop of core/cluster_engine.py::_nn_chain on one block,
// with every live row's nearest neighbour cached in (nnk, nni); block b
// runs group b's chain on its own slices of s, the outputs and the
// scratch (one block, b = 0, without a group axis).  kSmem:
// the per-leaf state lives in shared memory (copied from the scratch),
// else in the scratch itself.  s (n, n) is the prepared linkage matrix
// (diagonal -inf), updated in place at live entries only; merges (n-1,
// 2) and heights (n-1) are written in chain order; counters = {merges
// done, loop iterations, rows rescanned}.
//
// Control state (chain length, top, prev, merges done) is uniform: every
// thread derives it from the same values.  A chain extension reads the
// cache and one entry of s and crosses no barrier.  A merge crosses
// three: before its writes (a warp may still be reading the cache for an
// earlier extension), after the row pass (the new column i, the rescan
// list and the row's argmax partials), and after the rescans.  Every
// argmax ranks rank_key()s, and a warp reduces them with redux.sync.
template <int kLinkage, bool kSmem>
__global__ void __launch_bounds__(kChainThreads, 1)
nn_chain_kernel(float* s, int n, int max_iter, int* merges, float* heights,
                int* counters, int* scratch, int64_t state_words) {
  constexpr int linkage = kLinkage;
  {
    const int64_t b = blockIdx.x;
    s += b * n * n;
    merges += b * 2 * (n - 1);
    heights += b * (n - 1);
    counters += b * 3;
    scratch += b * state_words;
  }
  extern __shared__ __align__(16) unsigned char chain_smem[];
  __shared__ uint32_t part_k[kChainWarps];
  __shared__ int part_i[kChainWarps];
  __shared__ int n_rescan;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  ChainState st(kSmem ? static_cast<void*>(chain_smem)
                      : static_cast<void*>(scratch),
                n);
  if (kSmem) {
    const ChainState from(scratch, n);
    for (int c = tid; c < n; c += kChainThreads) {
      st.nnk[c] = from.nnk[c];
      st.nni[c] = from.nni[c];
      st.size[c] = 1.f;
      st.alive[c] = 1;
    }
  }
  if (tid == 0) n_rescan = 0;
  __syncthreads();

  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(s) % 16 == 0;
  int clen = 0, t = 0, it = 0, first = 0, top = 0, prev = 0, rescans = 0;
#ifdef REPRO_NN_CHAIN_CLOCKS
  unsigned long long clk[kClockPhases] = {};
  long long mark = clock64();
#endif
  while (t < n - 1 && it < max_iter) {
    if (clen == 0) {  // re-seed an empty chain with the smallest live row
      while (!st.alive[first]) ++first;
      if (tid == 0) st.chain[0] = first;
      top = prev = first;
      clen = 1;
    }
    const float best = key_value(st.nnk[top]);
    const int nn = st.nni[top];
    const float prev_sim = clen >= 2 ? s[(int64_t)top * n + prev] : -INFINITY;
    // prev is top's predecessor, so prev_sim >= best means prev attains
    // top's row max: a reciprocal pair.
    if (clen >= 2 && prev_sim >= best) {
      const int i = min(top, prev), j = max(top, prev);
      const float na = st.size[i], nb = st.size[j];
      float* row_i = s + (int64_t)i * n;
      const float* row_j = s + (int64_t)j * n;
      CHAIN_CLOCK(1);
      __syncthreads();
      CHAIN_CLOCK(2);
      // The row pass: the thread of column c reads s[i][c], s[j][c] and
      // writes s[i][c], s[c][i] and row c's cache; no other thread
      // touches those cells.  A warp walks 32 neighbouring columns a step,
      // kPassAhead steps loaded before any is updated.
      uint32_t bk = 0;
      int bi = INT_MAX;
      for (int c0 = tid - lane; c0 < n; c0 += kPassAhead * kChainThreads) {
        float ri[kPassAhead], rj[kPassAhead];
#pragma unroll
        for (int u = 0; u < kPassAhead; ++u) {
          const int c = c0 + u * kChainThreads + lane;
          ri[u] = c < n ? row_i[c] : 0.f;
          rj[u] = c < n ? row_j[c] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kPassAhead; ++u) {
          const int c = c0 + u * kChainThreads + lane;
          if (c0 + u * kChainThreads >= n) break;  // warp-uniform
          // Branch-free but for the stores: every value is formed and
          // the masked ones replaced by select.
          const bool in = c < n;
          const int cc = in ? c : 0;
          const bool live = in && c != i && c != j && st.alive[cc];
          if (in && c == j) st.alive[c] = 0;
          const float x = lance_williams(ri[u], rj[u], na, nb, linkage);
          if (live) {
            row_i[c] = x;
            s[(int64_t)c * n + i] = x;
          }
          const uint32_t kx = rank_key(extension_value(x, linkage));
          const uint32_t ke = live ? kx : kKeyNegInf;
          visit(in ? ke : 0u, c, bk, bi);
          // Row c's nearest neighbour against its new entry at column i.
          const uint32_t kv = st.nnk[cc];
          const int kc = st.nni[cc];
          const bool at_ij = kc == i || kc == j;
          const bool take =
              live && (at_ij ? ke >= kv : ke > kv || (ke == kv && i < kc));
          if (take) {
            st.nnk[c] = ke;
            st.nni[c] = i;
          }
          const bool redo = live && at_ij && !take;
          const uint32_t flags = __ballot_sync(0xffffffffu, redo);
          if (flags) {
            int base = 0;
            if (lane == 0) base = atomicAdd(&n_rescan, __popc(flags));
            base = __shfl_sync(0xffffffffu, base, 0);
            if (redo) st.list[base + __popc(flags & ((1u << lane) - 1))] = c;
          }
        }
      }
      CHAIN_CLOCK(3);
      warp_argmax(bk, bi);
      if (lane == 0) {
        part_k[warp] = bk;
        part_i[warp] = bi;
      }
      CHAIN_CLOCK(4);
      __syncthreads();
      CHAIN_CLOCK(5);
      // Row i's nearest neighbour from the warps' partials (every warp
      // reduces them alike), then one warp a row to rescan.
      bk = part_k[lane % kChainWarps];
      bi = part_i[lane % kChainWarps];
      warp_argmax(bk, bi);
      const int m = n_rescan;
      if (tid == 0) {
        st.nnk[i] = bk;
        st.nni[i] = bi;
        st.size[i] = na + nb;
        st.size[j] = 0.f;
        merges[2 * t] = i;
        merges[2 * t + 1] = j;
        heights[t] = prev_sim;
      }
      CHAIN_CLOCK(6);
      for (int r = warp; r < m; r += kChainWarps) {
        const int c = st.list[r];
        uint32_t rk;
        int rc;
        row_argmax<kLinkage>(s + (int64_t)c * n, c, n, st.alive, vec, rk,
                             rc);
        if (lane == 0) {
          st.nnk[c] = rk;
          st.nni[c] = rc;
        }
      }
      rescans += m;
      CHAIN_CLOCK(7);
      __syncthreads();
      if (tid == 0) n_rescan = 0;  // read by all before the barrier above
      clen -= 2;
      ++t;
      if (clen > 0) {
        top = st.chain[clen - 1];
        prev = st.chain[clen >= 2 ? clen - 2 : 0];
      }
      CHAIN_CLOCK(8);
    } else {
      if (clen > n) break;  // chain buffer full: only non-finite input
      if (tid == 0) st.chain[clen] = nn;
      ++clen;
      prev = top;
      top = nn;
      CHAIN_CLOCK(0);
    }
    ++it;
  }
  if (tid == 0) {
    counters[0] = t;
    counters[1] = it;
    counters[2] = rescans;
#ifdef REPRO_NN_CHAIN_CLOCKS
    for (int p = 0; p < kClockPhases; ++p) chain_clocks[p] = clk[p];
#endif
  }
}

}  // namespace

REPRO_EXPORT int repro_linkage_step(const float* a, const float* b, float na,
                                    float nb, const float* mask, float* row,
                                    int* idx, float* val, int n, int linkage,
                                    void* stream) {
  linkage_step_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      a, b, na, nb, mask, row, idx, val, n, linkage);
  return (int)cudaGetLastError();
}

// The chain's plan for n leaves: the dynamic shared memory of the chain
// kernel (0 where the per-leaf state stays in the scratch), whether the
// state lives in shared memory (through route_smem), and the bytes of
// device scratch the wrapper allocates (through scratch_bytes).
// kernels/linkage/ops.py::chain_plan computes the same.
REPRO_EXPORT int64_t repro_nn_chain_plan(int n, int* route_smem,
                                         int64_t* scratch_bytes) {
  const int64_t bytes = chain_state_bytes(n);
  *scratch_bytes = bytes;
#ifdef REPRO_NN_CHAIN_SCRATCH
  *route_smem = 0;
#else
  *route_smem = bytes <= kSmemLimit;
#endif
  return *route_smem ? bytes : 0;
}

#ifdef REPRO_NN_CHAIN_CLOCKS
// The last chain's cycles by phase (kClockPhases sums, thread 0's view).
REPRO_EXPORT int repro_nn_chain_clocks(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, chain_clocks, sizeof(chain_clocks));
}
#endif

template <int kLinkage>
int launch_chain(float* s, int batch, int n, int max_iter, int* merges,
                 float* heights, int* counters, int* scratch,
                 cudaStream_t st) {
  int route_smem = 0;
  int64_t scratch_bytes = 0;
  const int64_t smem = repro_nn_chain_plan(n, &route_smem, &scratch_bytes);
  const int64_t rows = (int64_t)batch * n;
  const int64_t init_blocks = (rows + kInitWarps - 1) / kInitWarps;
  if (init_blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  nn_init_kernel<kLinkage><<<(unsigned)init_blocks, kInitWarps * 32, 0, st>>>(
      s, n, rows, scratch_bytes / 4, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto kernel = route_smem ? nn_chain_kernel<kLinkage, true>
                           : nn_chain_kernel<kLinkage, false>;
  if (route_smem) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<batch, kChainThreads, (size_t)smem, st>>>(
      s, n, max_iter, merges, heights, counters, scratch, scratch_bytes / 4);
  return (int)cudaGetLastError();
}

// s (batch, n, n) fp32 contiguous, batch independent chains (1 without a
// group axis), each matrix updated in place; merges (batch, n-1, 2),
// heights (batch, n-1), counters (batch, 3) int32; scratch of batch x
// repro_nn_chain_plan's bytes.  One chain block a matrix.  The linkage is
// a template parameter of the kernels, so each holds one linkage's code:
// the chain is a sequence of short dependent steps, and its time grows
// with the instructions each step has to fetch.
REPRO_EXPORT int repro_nn_chain(float* s, int batch, int n, int linkage,
                                int max_iter, int* merges, float* heights,
                                int* counters, void* scratch, void* stream) {
  if (n < 2 || batch <= 0) return 0;
  int* w = static_cast<int*>(scratch);
  cudaStream_t st = (cudaStream_t)stream;
  switch (linkage) {
    case kAverage:
      return launch_chain<kAverage>(s, batch, n, max_iter, merges, heights,
                                    counters, w, st);
    case kSingle:
      return launch_chain<kSingle>(s, batch, n, max_iter, merges, heights,
                                   counters, w, st);
    case kComplete:
      return launch_chain<kComplete>(s, batch, n, max_iter, merges, heights,
                                     counters, w, st);
  }
  return (int)cudaErrorInvalidValue;
}
