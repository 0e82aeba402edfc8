// K9: sampled sparse-row product, for each entry p of a CSR P read as
// (r_p, q_p),
//
//   out[p] = alpha * sum over (s, v) in row q_p of a CSR Y of D[r_p, s] * conj(v)
//
// with D dense and row-major (leading dimension ld); conj only for complex
// values.  It is both value gradients of C = alpha op(A) op(B) + beta C0
// with dense output (ops/spgemm_grad.py): dL/dA at A's pattern with D = G
// and Y = op(B), and dL/dB at B's pattern read as (column, row) pairs with
// D = G^T and Y = op(A)^T.  The wrapper hands the kernel each entry's r_p
// and q_p as two id arrays (P's expanded rows and its column ids, swapped
// for the second form).
//
// Replaces XLA's transpose of sparse_dot_tpu/ops/_xla.py
// spgemm_numeric_sorted (:326, through densify_sorted :273): jax.grad of
// that function with respect to a_vals (b_vals) is a dense G @ op(B)^H
// (op(A)^H @ G) gathered at the operand's scatter positions, an m x k
// (k x n) dense product whatever the operands' density.
//
// Bound: each entry walks a row of Y, one multiply-add per entry of the
// row, gathering D[r_p, s] at Y's column ids: the work is the products,
// sum over p of nnz(Y[q_p, :]), each reading 8-16 bytes of Y and a value
// of D's row r_p, which the entries of one row of P share through L1 and
// L2.  It is bound by those gathers, far below the card's multiply-add
// rate.  The design, simple and correct first:
//
// - a group of L lanes (ops/spgemm_grad.py, sampled_lanes: about two
//   entries of a row of mean length a lane, 1 to 32, a power of two) owns
//   an entry at a time; consecutive groups take consecutive entries
//   (entries of one row of P share D's row), and the grid strides over
//   the entries;
// - lane l sums the row's entries l, l + L, l + 2L, ... in that order,
//   then the group adds its L sums by a butterfly of xor shuffles, whose
//   order is fixed: every output is written by one lane, with no atomics,
//   and a run gives the same bits twice.
#include "common.cuh"

namespace sdt {
namespace {

constexpr int kThreads = 256;
// Blocks of the grid at most: the grid strides over the entries.
constexpr int64_t kMaxBlocks = 132 * 16;

__device__ __forceinline__ float conj_of(float v) { return v; }
__device__ __forceinline__ double conj_of(double v) { return v; }
template <typename R>
__device__ __forceinline__ cuda::std::complex<R> conj_of(
    cuda::std::complex<R> v) {
  return cuda::std::complex<R>(v.real(), -v.imag());
}

template <typename T, typename I, int L>
__global__ void __launch_bounds__(kThreads)
sampled_kernel(const I* __restrict__ r_ids, const I* __restrict__ q_ids,
               int64_t nnz, const T* __restrict__ d, int64_t ld,
               const I* __restrict__ y_indptr,
               const I* __restrict__ y_indices,
               const T* __restrict__ y_data, T* __restrict__ out, T alpha,
               bool scale) {
  using A = Arith<T>;
  const int lane = static_cast<int>(threadIdx.x) % L;
  // The group's lanes in its warp (groups never straddle a warp).
  const unsigned members =
      L == 32 ? kFullMask
              : ((1u << L) - 1u) << ((threadIdx.x & 31) & ~(L - 1));
  const int64_t groups = static_cast<int64_t>(gridDim.x) * (kThreads / L);
  for (int64_t p = (static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x) / L;
       p < nnz; p += groups) {
    const int64_t r = static_cast<int64_t>(r_ids[p]);
    const int64_t q = static_cast<int64_t>(q_ids[p]);
    const int64_t t1 = static_cast<int64_t>(y_indptr[q + 1]);
    const T* __restrict__ drow = d + r * ld;
    T acc = A::zero();
    for (int64_t t = static_cast<int64_t>(y_indptr[q]) + lane; t < t1;
         t += L) {
      acc = A::fma(drow[static_cast<int64_t>(y_indices[t])],
                   conj_of(y_data[t]), acc);
    }
#pragma unroll
    for (int off = L / 2; off > 0; off /= 2) {
      acc = A::add(acc, A::shfl_xor(acc, off, members));
    }
    if (lane == 0) out[p] = scale ? A::mul(alpha, acc) : acc;
  }
}

template <typename T, typename I, int L>
void launch_lanes(const void* r_ids, const void* q_ids, int64_t nnz,
                  const void* d, int64_t ld, const void* y_indptr,
                  const void* y_indices, const void* y_data, void* out,
                  T alpha, bool scale, cudaStream_t stream) {
  constexpr int64_t per_block = kThreads / L;
  int64_t blocks = (nnz + per_block - 1) / per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  sampled_kernel<T, I, L><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(
      static_cast<const I*>(r_ids), static_cast<const I*>(q_ids), nnz,
      static_cast<const T*>(d), ld, static_cast<const I*>(y_indptr),
      static_cast<const I*>(y_indices), static_cast<const T*>(y_data),
      static_cast<T*>(out), alpha, scale);
}

template <typename T, typename I>
cudaError_t launch(const void* r_ids, const void* q_ids, int64_t nnz,
                   const void* d, int64_t ld, const void* y_indptr,
                   const void* y_indices, const void* y_data, void* out,
                   int lanes, double alpha_re, double alpha_im,
                   cudaStream_t stream) {
  if (nnz <= 0) return cudaSuccess;
  const T alpha = Arith<T>::make(alpha_re, alpha_im);
  const bool scale = !is_one(alpha_re, alpha_im);
#define SDT_K9_LANES(L)                                                     \
  launch_lanes<T, I, L>(r_ids, q_ids, nnz, d, ld, y_indptr, y_indices,      \
                        y_data, out, alpha, scale, stream)
  switch (lanes) {
    case 1: SDT_K9_LANES(1); break;
    case 2: SDT_K9_LANES(2); break;
    case 4: SDT_K9_LANES(4); break;
    case 8: SDT_K9_LANES(8); break;
    case 16: SDT_K9_LANES(16); break;
    case 32: SDT_K9_LANES(32); break;
    default: return cudaErrorInvalidValue;
  }
#undef SDT_K9_LANES
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdt

extern "C" int sdt_csr_spgemm_sddmm(int dtype, int itype, const void* r_ids,
                                    const void* q_ids, int64_t nnz,
                                    const void* d, int64_t ld,
                                    const void* y_indptr,
                                    const void* y_indices,
                                    const void* y_data, void* out, int lanes,
                                    double alpha_re, double alpha_im,
                                    void* stream) {
  SDT_DISPATCH(dtype, itype, sdt::launch, r_ids, q_ids, nnz, d, ld,
               y_indptr, y_indices, y_data, out, lanes, alpha_re, alpha_im,
               static_cast<cudaStream_t>(stream))
}
