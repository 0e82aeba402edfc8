// K11: the value gradients of a sparse x sparse product with sparse
// output.  For C = op(A) op(B) on its structural pattern (K4 + K5: every
// product a(i, k) b(k, j) has its entry (i, j) in C, each row's columns
// ascending; only j >= i under `triangular`) and G = dL/dC on that
// pattern, one of two forms for each stored entry p of a CSR P at row r,
// column c (conj only for complex values):
//
//   dA (P = op(A), Y = op(B)):
//     out[p] = sum over (j, v) in row c of Y of G[r, j] conj(v)
//   dB (P = op(B), Y = op(A)^T, `transposed`):
//     out[p] = sum over (i, v) in row r of Y of G[i, c] conj(v)
//
// where G[i, j] is G's value at (i, j) in C's row i, and a product with
// j < i adds nothing under `triangular` (the kernel tests it before any
// search).  They are dL/d(op(A)'s values) and dL/d(op(B)'s values) as
// PyTorch's convention for complex gradients has them
// (ops/spgemm_grad.py, csr_spgemm_sparse_sddmm).
//
// Replaces XLA's transpose of sparse_dot_tpu/ops/_xla.py esc_spgemm_block
// (:1916) and its back half _esc_sort_compress (:1541): jax.grad of the
// expand-sort-compress product in a_vals and b_data, which runs the sort's
// JVP and the doubling sums backwards, so each product's G is gathered
// through the sort's permutation and scattered onto the operands.
//
// Bound: one multiply-add per product and a search for its entry of C;
// the bytes that must move are P's and Y's arrays, C's structure, G and
// the output, each once.  This first design is plain:
//
// - a group of L lanes (1 to 32, ops/spgemm_grad.py's sampled_lanes from
//   Y's mean row) takes one row of P; for each of its entries in turn the
//   lanes walk the named row of Y (lane l its entries l, l + L, ...), each
//   finds its product's entry of C by binary search in C's row and adds
//   G there times conj(v), and a butterfly of shuffles adds the lanes'
//   sums in a fixed order: the same bits on every run, no atomics;
// - dA: every product of a row of P lands in the same row of C, so the
//   group stages that row's columns and G in shared memory (its slot of
//   `cap` entries) where it fits and searches it in place where it does
//   not; dB: each product lands in another row of C (Y's column ids), so
//   rows are searched in place.
#include "common.cuh"

namespace sdt {
namespace {

// Threads a block (ops/spgemm_grad.py's SPARSE_THREADS).
constexpr int kThreads = 256;

__device__ __forceinline__ float conj_of(float v) { return v; }
__device__ __forceinline__ double conj_of(double v) { return v; }
template <typename R>
__device__ __forceinline__ cuda::std::complex<R> conj_of(
    cuda::std::complex<R> v) {
  return cuda::std::complex<R>(v.real(), -v.imag());
}

// Position of `col` among the ascending cols[0, len), or -1.
template <typename I>
__device__ __forceinline__ int64_t find_column(const I* __restrict__ cols,
                                               int64_t len, int64_t col) {
  int64_t lo = 0, hi = len;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(cols[mid]) < col) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < len && static_cast<int64_t>(cols[lo]) == col ? lo : -1;
}

template <typename T, typename I, int L, bool kTransposed>
__global__ void __launch_bounds__(kThreads)
sparse_sampled_kernel(const I* __restrict__ p_indptr,
                      const I* __restrict__ p_indices, int64_t p_rows,
                      const I* __restrict__ y_indptr,
                      const I* __restrict__ y_indices,
                      const T* __restrict__ y_data,
                      const I* __restrict__ c_indptr,
                      const I* __restrict__ c_indices,
                      const T* __restrict__ g, T* __restrict__ out,
                      bool triangular, int cap) {
  using A = Arith<T>;
  // Raw bytes: complex element types may not be declared __shared__.
  // The groups' slots of G's values, then of C's column ids.
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int G = kThreads / L;
  const int slot = static_cast<int>(threadIdx.x) / L;
  const int lane = static_cast<int>(threadIdx.x) % L;
  // The group's lanes in its warp (groups never straddle a warp).
  const unsigned members =
      L == 32 ? kFullMask
              : ((1u << L) - 1u) << ((threadIdx.x & 31) & ~(L - 1));
  const int64_t r = static_cast<int64_t>(blockIdx.x) * G + slot;
  if (r >= p_rows) return;  // the whole group: it shares r
  const int64_t p0 = static_cast<int64_t>(p_indptr[r]);
  const int64_t p1 = static_cast<int64_t>(p_indptr[r + 1]);

  // dA: the group's row of C, staged where it fits its slot.
  const I* cols = nullptr;
  const T* gv = nullptr;
  int64_t c_len = 0;
  if constexpr (!kTransposed) {
    const int64_t c0 = static_cast<int64_t>(c_indptr[r]);
    c_len = static_cast<int64_t>(c_indptr[r + 1]) - c0;
    cols = c_indices + c0;
    gv = g + c0;
    if (c_len <= cap && p1 > p0) {
      T* sv = reinterpret_cast<T*>(smem) + static_cast<int64_t>(slot) * cap;
      I* sc = reinterpret_cast<I*>(reinterpret_cast<T*>(smem) +
                                   static_cast<int64_t>(G) * cap) +
              static_cast<int64_t>(slot) * cap;
      for (int64_t x = lane; x < c_len; x += L) {
        sv[x] = gv[x];
        sc[x] = cols[x];
      }
      __syncwarp(members);
      cols = sc;
      gv = sv;
    }
  }

  for (int64_t p = p0; p < p1; ++p) {
    const int64_t c = static_cast<int64_t>(p_indices[p]);
    // The row of Y the entry names: its column (dA), the group's row (dB).
    const int64_t q = kTransposed ? r : c;
    const int64_t t1 = static_cast<int64_t>(y_indptr[q + 1]);
    T acc = A::zero();
    for (int64_t t = static_cast<int64_t>(y_indptr[q]) + lane; t < t1;
         t += L) {
      const int64_t y = static_cast<int64_t>(y_indices[t]);
      // The product's entry (i, j) of C.
      const int64_t i = kTransposed ? y : r;
      const int64_t j = kTransposed ? c : y;
      if (triangular && j < i) continue;
      int64_t at;
      const T* row_g;
      if constexpr (kTransposed) {
        const int64_t c0 = static_cast<int64_t>(c_indptr[i]);
        at = find_column(c_indices + c0,
                         static_cast<int64_t>(c_indptr[i + 1]) - c0, j);
        row_g = g + c0;
      } else {
        at = find_column(cols, c_len, j);
        row_g = gv;
      }
      if (at >= 0) acc = A::fma(row_g[at], conj_of(y_data[t]), acc);
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
      acc = A::add(acc, A::shfl_xor(acc, off, members));
    }
    if (lane == 0) out[p] = acc;
  }
}

// The launch's arguments past the type codes, as the C entry point takes
// them.
struct Args {
  const void* p_indptr;
  const void* p_indices;
  int64_t p_rows;
  const void* y_indptr;
  const void* y_indices;
  const void* y_data;
  const void* c_indptr;
  const void* c_indices;
  const void* g;
  void* out;
  int transposed, triangular, lanes, cap;
};

template <typename T, typename I, int L, bool kTransposed>
cudaError_t launch_lanes(const Args& a, cudaStream_t stream) {
  constexpr int G = kThreads / L;
  const size_t smem =
      kTransposed ? 0
                  : static_cast<size_t>(G) * a.cap * (sizeof(T) + sizeof(I));
  const int64_t blocks = (a.p_rows + G - 1) / G;
  if (smem > 227 * 1024 || blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = sparse_sampled_kernel<T, I, L, kTransposed>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
          static_cast<const I*>(a.p_indptr),
          static_cast<const I*>(a.p_indices), a.p_rows,
          static_cast<const I*>(a.y_indptr),
          static_cast<const I*>(a.y_indices),
          static_cast<const T*>(a.y_data),
          static_cast<const I*>(a.c_indptr),
          static_cast<const I*>(a.c_indices), static_cast<const T*>(a.g),
          static_cast<T*>(a.out), a.triangular != 0, a.cap);
  return cudaGetLastError();
}

template <typename T, typename I, bool kTransposed>
cudaError_t launch_form(const Args& a, cudaStream_t stream) {
  switch (a.lanes) {
    case 1: return launch_lanes<T, I, 1, kTransposed>(a, stream);
    case 2: return launch_lanes<T, I, 2, kTransposed>(a, stream);
    case 4: return launch_lanes<T, I, 4, kTransposed>(a, stream);
    case 8: return launch_lanes<T, I, 8, kTransposed>(a, stream);
    case 16: return launch_lanes<T, I, 16, kTransposed>(a, stream);
    case 32: return launch_lanes<T, I, 32, kTransposed>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename I>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (a.p_rows < 0 || a.cap < 0) return cudaErrorInvalidValue;
  if (a.p_rows == 0) return cudaSuccess;
  return a.transposed ? launch_form<T, I, true>(a, stream)
                      : launch_form<T, I, false>(a, stream);
}

}  // namespace
}  // namespace sdt

extern "C" int sdt_csr_spgemm_sparse_sddmm(
    int dtype, int itype, const void* p_indptr, const void* p_indices,
    int64_t p_rows, const void* y_indptr, const void* y_indices,
    const void* y_data, const void* c_indptr, const void* c_indices,
    const void* g, void* out, int transposed, int triangular, int lanes,
    int cap, void* stream) {
  const sdt::Args args{p_indptr, p_indices, p_rows, y_indptr, y_indices,
                       y_data, c_indptr, c_indices, g, out,
                       transposed, triangular, lanes, cap};
  SDT_DISPATCH(dtype, itype, sdt::launch, args,
               static_cast<cudaStream_t>(stream))
}
