// K2: CSR SpMM, C = alpha * A @ B + beta * C0, for CSR A and row-major B.
//
// Replaces the TPU's CSR SpMM family in sparse_dot_tpu/ops/_xla.py
// (ell_spmm_binned, ell_spmm, coo_spmm) and the Pallas gather probes of
// experiments/exp_pallas_gather.py (run_take, run_loop, run_gather) and
// experiments/exp_pallas_ell_small.py (ell_spmm_pallas_f32).  The TPU
// versions repacked CSR into padded, length-binned ELL because its gathers
// want fixed shapes and its scatters are slow; this kernel reads CSR as it
// is, with no repack and no scatter.
//
// Bound: at the main path's densities (about 1%) each nonzero does one
// multiply-add per output column but reads a whole row of B, so the
// kernel is bound by the bytes of B it gathers from device memory and L2.
// Design against that: one warp owns one row of A and a strip of
// 32 * kColsPerLane columns of B; lane l covers columns l, l + 32, ...
// so every gathered B row is read with coalesced 128-byte transactions.
// The warp loads 32 (column, value) pairs of its row at once and
// broadcasts them with shuffles.  Each output element is written exactly
// once, by the warp that owns it: no atomics, and rows with no nonzeros
// store beta * C0 or 0.
#include "common.cuh"

namespace sdt {
namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kColsPerLane = 4;
constexpr int kStrip = 32 * kColsPerLane;

template <typename T, typename I>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
csr_spmm_kernel(const I* __restrict__ indptr, const I* __restrict__ indices,
                const T* __restrict__ data, const T* __restrict__ b,
                const T* __restrict__ c0, T* __restrict__ c, int64_t m,
                int64_t n, T alpha, T beta, bool scale) {
  using A = Arith<T>;
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= m) return;  // uniform across the warp
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * kStrip + lane;

  T acc[kColsPerLane];
#pragma unroll
  for (int t = 0; t < kColsPerLane; ++t) acc[t] = A::zero();

  const int64_t start = static_cast<int64_t>(indptr[row]);
  const int64_t end = static_cast<int64_t>(indptr[row + 1]);
  for (int64_t base = start; base < end; base += 32) {
    const int64_t p = base + lane;
    long long my_col = 0;
    T my_val = A::zero();
    if (p < end) {
      my_col = static_cast<long long>(indices[p]);
      my_val = data[p];
    }
    const int cnt = static_cast<int>(end - base < 32 ? end - base : 32);
    for (int j = 0; j < cnt; ++j) {
      const long long col = __shfl_sync(kFullMask, my_col, j);
      const T v = A::shfl(my_val, j);
      const T* __restrict__ brow = b + col * n;
#pragma unroll
      for (int t = 0; t < kColsPerLane; ++t) {
        const int64_t cc = col0 + 32 * t;
        if (cc < n) acc[t] = A::fma(v, brow[cc], acc[t]);
      }
    }
  }

#pragma unroll
  for (int t = 0; t < kColsPerLane; ++t) {
    const int64_t cc = col0 + 32 * t;
    if (cc < n) {
      const int64_t idx = row * n + cc;
      c[idx] = epilogue(acc[t], c0, idx, alpha, beta, scale);
    }
  }
}

template <typename T, typename I>
cudaError_t launch(const void* indptr, const void* indices, const void* data,
                   const void* b, const void* c0, void* c, int64_t m,
                   int64_t n, double alpha_re, double alpha_im,
                   double beta_re, double beta_im, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((m + kWarpsPerBlock - 1) / kWarpsPerBlock),
                  static_cast<unsigned>((n + kStrip - 1) / kStrip));
  csr_spmm_kernel<T, I><<<grid, 32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const I*>(indptr), static_cast<const I*>(indices),
      static_cast<const T*>(data), static_cast<const T*>(b),
      static_cast<const T*>(c0), static_cast<T*>(c), m, n,
      Arith<T>::make(alpha_re, alpha_im), Arith<T>::make(beta_re, beta_im),
      !is_one(alpha_re, alpha_im));
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdt

extern "C" int sdt_csr_spmm(int dtype, int itype, const void* indptr,
                            const void* indices, const void* data,
                            const void* b, const void* c0, void* c,
                            int64_t m, int64_t n, double alpha_re,
                            double alpha_im, double beta_re, double beta_im,
                            void* stream) {
  SDT_DISPATCH(dtype, itype, sdt::launch, indptr, indices, data, b, c0, c, m,
               n, alpha_re, alpha_im, beta_re, beta_im,
               static_cast<cudaStream_t>(stream))
}
