// Tensor-core and asynchronous-copy helpers shared by the kernels that
// run on Hopper's tensor cores at full precision: K1's tensor-core
// variant (bsr_spmm.cu) and K8's (bsr_sddmm.cu), in all four value types.
//
// - cp.async copies of 16 bytes or one element into shared memory, with
//   zero fill for the ragged edge, committed and waited for in groups;
// - f64: mma.sync m16n8k4 (DMMA), IEEE products and sums;
// - f32: 3xTF32 on mma.sync m16n8k8.  Each operand x is split as
//   hi = tf32(x), lo = x - hi, and a tile accumulates lo*hi + hi*lo +
//   hi*hi in f32, about 22 bits of each product where plain TF32 keeps
//   11.  The tensor cores round their f32 sums toward zero, a bias that
//   grows with every product accumulated into the same registers, so
//   each k8 step's hi*hi lands in fresh registers and is added to the
//   tile's sum in IEEE f32, and the cross products accumulate apart.
//   Where hi is inf or nan, lo and the copy of hi used in the two cross
//   products are 0, so inf * finite stays inf and no inf * 0 appears.
// - complex (c128 on f64 MMA, c64 on 3xTF32): four real products a step
//   on the real and imaginary parts, read from interleaved complex
//   shared memory: re += Ar Br, re += (-Ai) Bi, im += Ar Bi, im += Ai Br.
//   Each real product is an IEEE product in the MMA, so the nan, +inf
//   and -inf of a sum are those of numpy's component formula summed over
//   k (which the plain versions follow); the 3-multiplication (Gauss)
//   form would not keep them.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace sdt {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; ok == false zero-fills dst and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// One element (4 or 8 bytes), for rows that are not 16-byte aligned.
template <int N>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src,
                                              bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(N), "r"(ok ? N : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 3xTF32 operand: hi for the hi*hi product, hic and lo for the two cross
// products (both 0 where hi is not finite).  hi is x rounded to TF32's 10
// mantissa bits (half away from zero, by an integer add and a mask);
// lo = x - hi is exact in f32 and goes to the tensor cores as it is,
// which read its top 10 mantissa bits.  Integer and f32 arithmetic only:
// cvt.rna.tf32.f32 runs at a fraction of their rate.
struct Tf32x3 {
  unsigned hi, hic, lo;
};

__device__ __forceinline__ Tf32x3 split_tf32(float x) {
  const unsigned hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  const bool finite = (hi & 0x7f800000u) != 0x7f800000u;
  return {hi, finite ? hi : 0u,
          finite ? __float_as_uint(x - __uint_as_float(hi)) : 0u};
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], unsigned a0,
                                         unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_f64(double (&d)[4], double a0,
                                        double a1, double b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b0));
}

// One k8 step of one (m16, n8) tile.  a holds A[g][t], A[g+8][t],
// A[g][t+4], A[g+8][t+4] and b holds B[t][g], B[t+4][g] for the lane's
// group g = lane / 4 and t = lane % 4, the m16n8k8 fragment layout.
// The tensor cores round their f32 sums toward zero, a bias that grows
// with every product accumulated into the same registers.  So the step's
// hi*hi products go to fresh registers and are added to d in IEEE f32,
// and the cross products, 2^-11 as large, accumulate apart in lo.
__device__ __forceinline__ void mma_k8(float (&d)[4], float (&lo)[4],
                                       const Tf32x3 (&a)[4],
                                       const Tf32x3 (&b)[2]) {
  float hh[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(hh, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
  mma_tf32(lo, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hic, b[1].hic);
  mma_tf32(lo, a[0].hic, a[1].hic, a[2].hic, a[3].hic, b[0].lo, b[1].lo);
#pragma unroll
  for (int q = 0; q < 4; ++q) d[q] += hh[q];
}

// f64: the same k8 step as two m16n8k4 products (k = t, then k = t + 4),
// accumulated in IEEE f64 by the tensor cores; lo is not used.
__device__ __forceinline__ void mma_k8(double (&d)[4], double (&)[4],
                                       const double (&a)[4],
                                       const double (&b)[2]) {
  mma_f64(d, a[0], a[1], b[0]);
  mma_f64(d, a[2], a[3], b[1]);
}

// c128: the k8 step of one (m16, n8) tile as four real products per k4
// half, in f64 MMA on the real and imaginary parts; lo is not used.
__device__ __forceinline__ void mma_k8(c128 (&d)[4], c128 (&)[4],
                                       const c128 (&a)[4],
                                       const c128 (&b)[2]) {
  double re[4], im[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    re[q] = d[q].real();
    im[q] = d[q].imag();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // k = t, then k = t + 4
    const c128 a0 = a[2 * h], a1 = a[2 * h + 1], b0 = b[h];
    mma_f64(re, a0.real(), a1.real(), b0.real());
    mma_f64(re, -a0.imag(), -a1.imag(), b0.imag());
    mma_f64(im, a0.real(), a1.real(), b0.imag());
    mma_f64(im, a0.imag(), a1.imag(), b0.real());
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) d[q] = c128(re[q], im[q]);
}

// c64: a 3xTF32 operand for each part.
struct CTf32x3 {
  Tf32x3 re, im;
};

__device__ __forceinline__ Tf32x3 negate(Tf32x3 x) {
  return {x.hi ^ 0x80000000u, x.hic ^ 0x80000000u, x.lo ^ 0x80000000u};
}

// c64: the k8 step as four 3xTF32 real products, each with its hi*hi in
// fresh registers (mma_k8 on floats above).
__device__ __forceinline__ void mma_k8(c64 (&d)[4], c64 (&lo)[4],
                                       const CTf32x3 (&a)[4],
                                       const CTf32x3 (&b)[2]) {
  float re[4], im[4], re_lo[4], im_lo[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    re[q] = d[q].real();
    im[q] = d[q].imag();
    re_lo[q] = lo[q].real();
    im_lo[q] = lo[q].imag();
  }
  const Tf32x3 ar[4] = {a[0].re, a[1].re, a[2].re, a[3].re};
  const Tf32x3 ai[4] = {a[0].im, a[1].im, a[2].im, a[3].im};
  const Tf32x3 nai[4] = {negate(a[0].im), negate(a[1].im), negate(a[2].im),
                         negate(a[3].im)};
  const Tf32x3 br[2] = {b[0].re, b[1].re};
  const Tf32x3 bi[2] = {b[0].im, b[1].im};
  mma_k8(re, re_lo, ar, br);
  mma_k8(re, re_lo, nai, bi);
  mma_k8(im, im_lo, ar, bi);
  mma_k8(im, im_lo, ai, br);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    d[q] = c64(re[q], im[q]);
    lo[q] = c64(re_lo[q], im_lo[q]);
  }
}

template <typename T>
struct IsComplex : std::false_type {};
template <typename R>
struct IsComplex<cuda::std::complex<R>> : std::true_type {};

// Whether a tile keeps 3xTF32 cross products apart (acc_lo), to be added
// to its sum at the end: f32 and c64.
template <typename T>
constexpr bool kSplitSum =
    std::is_same<T, float>::value || std::is_same<T, c64>::value;

// The MMA operand of a value read from shared memory.
template <typename T>
struct Operand {
  using type = T;
  __device__ static T make(T x) { return x; }
};
template <>
struct Operand<float> {
  using type = Tf32x3;
  __device__ static Tf32x3 make(float x) { return split_tf32(x); }
};
template <>
struct Operand<c64> {
  using type = CTf32x3;
  __device__ static CTf32x3 make(c64 x) {
    return {split_tf32(x.real()), split_tf32(x.imag())};
  }
};

}  // namespace sdt
