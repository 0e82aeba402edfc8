// K3: CSR SpMV, y = alpha * A @ x + beta * y0, for CSR A.
//
// Replaces sparse_dot_tpu/ops/_xla.py ell_spmv (padded ELL gather and row
// reduction) and coo_spmv (gather and scatter-add).  Here the row
// reduction stays in registers and no padded layout is built.
//
// Bound: every nonzero is one multiply-add against 4 + 2 * sizeof(T)
// bytes of A and one gathered element of x, so the kernel is bound by
// device-memory bandwidth over A's arrays plus the scattered reads of x.
// Design against that: a group of LANES consecutive lanes owns one row
// and strides over it, so the reads of indices and values are coalesced;
// the group reduces with shuffles and one lane stores the result with
// the epilogue fused.  The wrapper picks LANES from the mean row length
// (4 to 32), so short rows do not leave most of a warp idle.
#include "common.cuh"

namespace sdt {
namespace {

constexpr int kThreads = 256;

template <typename T, typename I, int LANES>
__global__ void __launch_bounds__(kThreads)
csr_spmv_kernel(const I* __restrict__ indptr, const I* __restrict__ indices,
                const T* __restrict__ data, const T* __restrict__ x,
                const T* __restrict__ y0, T* __restrict__ y, int64_t m,
                T alpha, T beta, bool scale) {
  using A = Arith<T>;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t row = tid / LANES;
  const int lane = static_cast<int>(tid % LANES);
  // Lanes past the last row stay for the shuffles with an empty range.
  const bool valid = row < m;
  const int64_t start = valid ? static_cast<int64_t>(indptr[row]) : 0;
  const int64_t end = valid ? static_cast<int64_t>(indptr[row + 1]) : 0;

  T acc = A::zero();
  for (int64_t p = start + lane; p < end; p += LANES) {
    acc = A::fma(data[p], x[static_cast<int64_t>(indices[p])], acc);
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) {
    acc = A::add(acc, A::shfl_down(acc, off, LANES));
  }
  if (valid && lane == 0) y[row] = epilogue(acc, y0, row, alpha, beta, scale);
}

template <typename T, typename I, int LANES>
void launch_lanes(const void* indptr, const void* indices, const void* data,
                  const void* x, const void* y0, void* y, int64_t m, T alpha,
                  T beta, bool scale, cudaStream_t stream) {
  const int64_t threads = m * LANES;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  csr_spmv_kernel<T, I, LANES><<<blocks, kThreads, 0, stream>>>(
      static_cast<const I*>(indptr), static_cast<const I*>(indices),
      static_cast<const T*>(data), static_cast<const T*>(x),
      static_cast<const T*>(y0), static_cast<T*>(y), m, alpha, beta, scale);
}

template <typename T, typename I>
cudaError_t launch(const void* indptr, const void* indices, const void* data,
                   const void* x, const void* y0, void* y, int64_t m,
                   int lanes, double alpha_re, double alpha_im,
                   double beta_re, double beta_im, cudaStream_t stream) {
  const T alpha = Arith<T>::make(alpha_re, alpha_im);
  const T beta = Arith<T>::make(beta_re, beta_im);
  const bool scale = !is_one(alpha_re, alpha_im);
  switch (lanes) {
    case 4:
      launch_lanes<T, I, 4>(indptr, indices, data, x, y0, y, m, alpha, beta, scale, stream);
      break;
    case 8:
      launch_lanes<T, I, 8>(indptr, indices, data, x, y0, y, m, alpha, beta, scale, stream);
      break;
    case 16:
      launch_lanes<T, I, 16>(indptr, indices, data, x, y0, y, m, alpha, beta, scale, stream);
      break;
    case 32:
      launch_lanes<T, I, 32>(indptr, indices, data, x, y0, y, m, alpha, beta, scale, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdt

extern "C" int sdt_csr_spmv(int dtype, int itype, const void* indptr,
                            const void* indices, const void* data,
                            const void* x, const void* y0, void* y, int64_t m,
                            int lanes, double alpha_re, double alpha_im,
                            double beta_re, double beta_im, void* stream) {
  SDT_DISPATCH(dtype, itype, sdt::launch, indptr, indices, data, x, y0, y, m,
               lanes, alpha_re, alpha_im, beta_re, beta_im,
               static_cast<cudaStream_t>(stream))
}
