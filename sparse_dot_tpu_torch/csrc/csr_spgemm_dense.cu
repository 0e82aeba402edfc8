// K6 csr_spgemm_dense: C = alpha * op(A) @ op(B) + beta * C0 into a dense
// row-major m x n C, for CSR op(A) and op(B) (the spmmd route of
// dot_product(dense=True) and gram_matrix(dense=True)).  With
// `triangular` only the products of columns j >= i are summed; C0 is
// added everywhere.
//
// Replaces the JAX package's numeric SpGEMM phase, which densified both
// operands and ran a dense matrix product (sparse_dot_tpu/ops/_xla.py
// spgemm_numeric_sorted, reached through host.spgemm_dense).  Nothing is
// densified here: op(B) as k x n can be far larger than the m x n output.
//
// Bound: one read of op(B)'s (column, value) and one accumulator update
// per product, plus m * n stores of C; small outputs are bound by the
// latency of the per-entry synchronisation, large ones by C's bytes.
// Design: one 256-thread block owns one row of C.  Its accumulator is a
// row of n values in shared memory when n * sizeof(T) fits 200 KB, else
// C's own row in device memory.  The block walks the row's entries of
// op(A) in order; its threads split op(B)'s row k, whose columns are
// distinct, so no two threads add to one column within a step, and a
// __syncthreads ends each step: no atomics, and the same bits every run.
// The alpha/beta epilogue is fused into the store.
#include "common.cuh"

namespace sdt {
namespace {

constexpr int kThreads = 256;
constexpr int64_t kSharedBudget = 200 * 1024;

template <typename T, typename I, bool SHARED>
__global__ void __launch_bounds__(kThreads)
spgemm_dense_kernel(const I* __restrict__ a_indptr,
                    const I* __restrict__ a_indices,
                    const T* __restrict__ a_data,
                    const I* __restrict__ b_indptr,
                    const I* __restrict__ b_indices,
                    const T* __restrict__ b_data, const T* __restrict__ c0,
                    T* __restrict__ c, int64_t m, int64_t n, T alpha, T beta,
                    bool scale, bool triangular) {
  using A = Arith<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  for (int64_t i = blockIdx.x; i < m; i += gridDim.x) {
    T* acc = SHARED ? reinterpret_cast<T*>(smem) : c + i * n;
    for (int64_t j = threadIdx.x; j < n; j += kThreads) acc[j] = A::zero();
    __syncthreads();
    const int64_t p_end = a_indptr[i + 1];
    for (int64_t p = a_indptr[i]; p < p_end; ++p) {
      const int64_t k = a_indices[p];
      const T av = a_data[p];
      const int64_t q_end = b_indptr[k + 1];
      for (int64_t q = b_indptr[k] + threadIdx.x; q < q_end; q += kThreads) {
        const int64_t j = b_indices[q];
        if (triangular && j < i) continue;
        acc[j] = A::fma(av, b_data[q], acc[j]);
      }
      __syncthreads();
    }
    for (int64_t j = threadIdx.x; j < n; j += kThreads) {
      const int64_t idx = i * n + j;
      c[idx] = epilogue(acc[j], c0, idx, alpha, beta, scale);
    }
    __syncthreads();
  }
}

template <typename T, typename I>
cudaError_t launch(const void* a_indptr, const void* a_indices,
                   const void* a_data, const void* b_indptr,
                   const void* b_indices, const void* b_data, const void* c0,
                   void* c, int64_t m, int64_t n, double alpha_re,
                   double alpha_im, double beta_re, double beta_im,
                   int triangular, cudaStream_t stream) {
  const int64_t shared = n * static_cast<int64_t>(sizeof(T));
  const bool in_shared = shared <= kSharedBudget;
  auto kernel = in_shared ? spgemm_dense_kernel<T, I, true>
                          : spgemm_dense_kernel<T, I, false>;
  const size_t bytes = in_shared ? static_cast<size_t>(shared) : 0;
  if (in_shared) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const int64_t grid = m < 0x7fffffff ? m : 0x7fffffff;
  kernel<<<static_cast<unsigned>(grid), kThreads, bytes, stream>>>(
      static_cast<const I*>(a_indptr), static_cast<const I*>(a_indices),
      static_cast<const T*>(a_data), static_cast<const I*>(b_indptr),
      static_cast<const I*>(b_indices), static_cast<const T*>(b_data),
      static_cast<const T*>(c0), static_cast<T*>(c), m, n,
      Arith<T>::make(alpha_re, alpha_im), Arith<T>::make(beta_re, beta_im),
      !is_one(alpha_re, alpha_im), triangular != 0);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdt

extern "C" int sdt_csr_spgemm_dense(
    int dtype, int itype, const void* a_indptr, const void* a_indices,
    const void* a_data, const void* b_indptr, const void* b_indices,
    const void* b_data, const void* c0, void* c, int64_t m, int64_t n,
    double alpha_re, double alpha_im, double beta_re, double beta_im,
    int triangular, void* stream) {
  SDT_DISPATCH(dtype, itype, sdt::launch, a_indptr, a_indices, a_data,
               b_indptr, b_indices, b_data, c0, c, m, n, alpha_re, alpha_im,
               beta_re, beta_im, triangular,
               static_cast<cudaStream_t>(stream))
}
