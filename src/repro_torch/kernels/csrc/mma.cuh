// Hopper tensor-core and asynchronous-copy building blocks (PTX), shared
// by the kernels that run their products on the tensor cores with
// mma.sync (fp32 accumulators): bf16 products on m16n8k16, and fp32
// products on m16n8k8 TF32 through the 3xTF32 split below.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, c = 2 (lane % 4)):
//   A (16 x 16, row): a[0] = A[g][c..c+1],   a[1] = A[g+8][c..c+1],
//                     a[2] = A[g][c+8..c+9], a[3] = A[g+8][c+8..c+9];
//   B (16 x 8, col):  b[0] = B[c..c+1][g],   b[1] = B[c+8..c+9][g];
//   C (16 x 8, fp32): d[0..1] = C[g][c..c+1], d[2..3] = C[g+8][c..c+1];
// a bf16 pair holds the lower k index in its low half.
//
// Fragment layouts of mma.m16n8k8 with TF32 operands (g = lane / 4,
// t = lane % 4), one 32-bit value per register:
//   A (16 x 8, row): a[0] = A[g][t],   a[1] = A[g+8][t],
//                    a[2] = A[g][t+4], a[3] = A[g+8][t+4];
//   B (8 x 8, col):  b[0] = B[t][g],   b[1] = B[t+4][g];
//   C (16 x 8, fp32): the same as m16n8k16's.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first `bytes` (0 to 16) of 16 bytes from global to shared memory,
// asynchronously (L2 only); the rest of the 16 is zero-filled.
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src,
                                             int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 16 bytes from global to shared memory, asynchronously (L2 only);
// zero-filled, and nothing read, where `live` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  cp_async16_n(dst, src, live ? 16 : 0);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address
// of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += A B on the tensor cores: bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (lo, hi) rounded to bf16 (RN) as one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bf16_bits(__floats2bfloat162_rn(lo, hi));
}

// 4 bytes from global to shared memory, asynchronously (through L1), for
// rows whose width or alignment rules out 16-byte copies; zero-filled,
// and nothing read, where `live` is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

// Wait until at most n (0 <= n <= 3) of this thread's committed groups
// are pending, for a ring whose depth is a launch parameter.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// ---------------------------------------------------------------------
// 3xTF32: fp32 products on the TF32 tensor cores.
//
// TF32 keeps 10 explicit mantissa bits of fp32's 23.  An fp32 value a is
// split into hi = tf32(a) and lo = tf32(a - hi), each rounded to
// nearest with ties away from zero (cvt.rna.tf32.f32's rounding); a - hi
// is exact in fp32, and hi + lo keeps about 21 significant bits of a.
// A product a b is then lo_a hi_b + hi_a lo_b + hi_a hi_b (lo_a lo_b,
// below 2^-22 of it, is dropped), each term exact in the tensor cores'
// fp32 accumulators.  The rounding is done on the bit pattern with
// integer operations (cvt.rna.tf32.f32's rounding, for finite inputs);
// the low 13 bits are cleared, so a TF32 operand is exactly the value
// the plain version (kernels/tf32.py::split_tf32) computes.

// tf32(a), rounded to nearest, ties away from zero, as an fp32 pattern
// whose low 13 bits are 0.  Finite inputs only (inf and NaN are not
// kept).
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// (hi, lo) of a as TF32 operands.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// d += A B on the tensor cores: TF32 operands, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B in 3xTF32 from split fragments: lo hi, hi lo, then hi hi, the
// small terms first (CUTLASS's OpMultiplyAddFastF32 order).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(d, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(d, a_hi, b_hi[0], b_hi[1]);
}
