// Shared pieces of the hand-written Hopper kernels: element arithmetic for
// the four value types, the fused alpha/beta epilogue, and the switch from
// the (dtype, index type) codes of the C interface to template instances.
//
// Every kernel here is built by ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// into one shared library with a plain C interface, loaded through ctypes.
// Each C entry point launches on the stream it is given, allocates nothing
// and returns cudaGetLastError().
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda/std/complex>

namespace sdt {

using c64 = cuda::std::complex<float>;
using c128 = cuda::std::complex<double>;

// Codes shared with ops/_build.py (DTYPE_CODES, ITYPE_CODES).
enum DTypeCode : int { kF32 = 0, kF64 = 1, kC64 = 2, kC128 = 3 };
enum ITypeCode : int { kI32 = 0, kI64 = 1 };

constexpr unsigned kFullMask = 0xffffffffu;

// Members of a batched launch: its grid's y and z dimensions hold at most
// 65,535 blocks, and ops/_build.py (MAX_MEMBERS) cuts a larger batch into
// launches of at most this many.
constexpr int64_t kMaxMembers = 65535;

__device__ __forceinline__ float fma_r(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_r(double a, double b, double c) {
  return ::fma(a, b, c);
}

// Element arithmetic.  Complex products use numpy's component formula
// (no C99 Annex G inf/nan recovery), so results match the plain version.
template <typename T>
struct Arith {
  __host__ __device__ static T make(double re, double) { return T(re); }
  __device__ static T zero() { return T(0); }
  __device__ static T fma(T a, T b, T c) { return fma_r(a, b, c); }  // c + a*b
  __device__ static T mul(T a, T b) { return a * b; }
  __device__ static T add(T a, T b) { return a + b; }
  __device__ static T shfl(T v, int src, int width = 32) {
    return __shfl_sync(kFullMask, v, src, width);
  }
  __device__ static T shfl_down(T v, unsigned delta, int width = 32) {
    return __shfl_down_sync(kFullMask, v, delta, width);
  }
  __device__ static T shfl_xor(T v, int lane_mask,
                               unsigned members = kFullMask) {
    return __shfl_xor_sync(members, v, lane_mask);
  }
};

template <typename R>
struct Arith<cuda::std::complex<R>> {
  using T = cuda::std::complex<R>;
  __host__ __device__ static T make(double re, double im) {
    return T(static_cast<R>(re), static_cast<R>(im));
  }
  __device__ static T zero() { return T(R(0), R(0)); }
  __device__ static T fma(T a, T b, T c) {
    const R re = fma_r(a.real(), b.real(), fma_r(-a.imag(), b.imag(), c.real()));
    const R im = fma_r(a.real(), b.imag(), fma_r(a.imag(), b.real(), c.imag()));
    return T(re, im);
  }
  __device__ static T mul(T a, T b) {
    return T(a.real() * b.real() - a.imag() * b.imag(),
             a.real() * b.imag() + a.imag() * b.real());
  }
  __device__ static T add(T a, T b) {
    return T(a.real() + b.real(), a.imag() + b.imag());
  }
  __device__ static T shfl(T v, int src, int width = 32) {
    return T(__shfl_sync(kFullMask, v.real(), src, width),
             __shfl_sync(kFullMask, v.imag(), src, width));
  }
  __device__ static T shfl_down(T v, unsigned delta, int width = 32) {
    return T(__shfl_down_sync(kFullMask, v.real(), delta, width),
             __shfl_down_sync(kFullMask, v.imag(), delta, width));
  }
  __device__ static T shfl_xor(T v, int lane_mask,
                               unsigned members = kFullMask) {
    return T(__shfl_xor_sync(members, v.real(), lane_mask),
             __shfl_xor_sync(members, v.imag(), lane_mask));
  }
};

// alpha * acc + beta * c0[idx]: the out/out_scalar accumulate of
// dot_product, fused into the store.  c0 == nullptr drops the beta term;
// scale == false skips the multiply by alpha == 1 (so inf/nan in acc do
// not meet a zero imaginary part).
template <typename T>
__device__ __forceinline__ T epilogue(T acc, const T* __restrict__ c0,
                                      int64_t idx, T alpha, T beta,
                                      bool scale) {
  T v = scale ? Arith<T>::mul(alpha, acc) : acc;
  if (c0 != nullptr) v = Arith<T>::fma(beta, c0[idx], v);
  return v;
}

inline bool is_one(double re, double im) { return re == 1.0 && im == 0.0; }

// A load that bypasses L1, for partial sums that other warps wrote.
template <typename T>
__device__ __forceinline__ T load_cg(const T* p) {
  return __ldcg(p);
}
template <>
__device__ __forceinline__ c64 load_cg<c64>(const c64* p) {
  const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
  return c64(v.x, v.y);
}
template <>
__device__ __forceinline__ c128 load_cg<c128>(const c128* p) {
  const double2 v = __ldcg(reinterpret_cast<const double2*>(p));
  return c128(v.x, v.y);
}

// Reduce-scatter (K7, K9): adds each of the E sums v[] across a group of
// L lanes (E <= L, both powers of two) in log2(L) shuffle stages,
// E - 1 + log2(L / E) shuffles in all: each of the first log2(E) stages halves the values a lane holds
// (the lanes with bit `off` set keep the upper half, the others the lower,
// and each adds what its partner kept of the other half); the rest add
// the one value left.  Returns the total of entry entry_of<L, E>(gl),
// which every lane with the same high bits holds; a fixed order, so the
// same bits every run.
template <typename T, int L, int E>
__device__ __forceinline__ T reduce_scatter(T (&v)[E], int gl,
                                            unsigned members) {
  using A = Arith<T>;
#pragma unroll
  for (int half = E / 2, off = L / 2; half > 0; half >>= 1, off >>= 1) {
    const bool upper = gl & off;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const T send = upper ? v[i] : v[i + half];
      const T keep = upper ? v[i + half] : v[i];
      v[i] = A::add(keep, A::shfl_xor(send, off, members));
    }
  }
#pragma unroll
  for (int off = L / (2 * E); off > 0; off >>= 1) {
    v[0] = A::add(v[0], A::shfl_xor(v[0], off, members));
  }
  return v[0];
}

// The entry of a round whose total lane gl holds after reduce_scatter:
// its bits L / 2, L / 4, ... read as a number.
template <int L, int E>
__device__ __forceinline__ int entry_of(int gl) {
  int e = 0;
#pragma unroll
  for (int half = E / 2, off = L / 2; half > 0; half >>= 1, off >>= 1) {
    if (gl & off) e += half;
  }
  return e;
}

}  // namespace sdt

// Expands to a switch that calls FN<T, I>(args...) for the element type
// code DT and the index type code IT, and returns cudaErrorInvalidValue for
// codes it does not know.
#define SDT_DISPATCH(DT, IT, FN, ...)                                      \
  switch ((DT) * 2 + (IT)) {                                               \
    case sdt::kF32 * 2 + sdt::kI32: return FN<float, int32_t>(__VA_ARGS__); \
    case sdt::kF32 * 2 + sdt::kI64: return FN<float, int64_t>(__VA_ARGS__); \
    case sdt::kF64 * 2 + sdt::kI32: return FN<double, int32_t>(__VA_ARGS__); \
    case sdt::kF64 * 2 + sdt::kI64: return FN<double, int64_t>(__VA_ARGS__); \
    case sdt::kC64 * 2 + sdt::kI32: return FN<sdt::c64, int32_t>(__VA_ARGS__); \
    case sdt::kC64 * 2 + sdt::kI64: return FN<sdt::c64, int64_t>(__VA_ARGS__); \
    case sdt::kC128 * 2 + sdt::kI32: return FN<sdt::c128, int32_t>(__VA_ARGS__); \
    case sdt::kC128 * 2 + sdt::kI64: return FN<sdt::c128, int64_t>(__VA_ARGS__); \
    default: return cudaErrorInvalidValue;                                 \
  }
