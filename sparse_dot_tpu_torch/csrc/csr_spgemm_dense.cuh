// K6's pieces shared by csr_spgemm_dense.cu (one product, and a batch a
// member a block) and csr_spgemm_dense_group.cu (a batch, M members a
// block): the launch's arguments, the search of a sorted row of op(B),
// the loads of a round and the window-start table.  The notes at the top
// of csr_spgemm_dense.cu say what the kernel computes and how.
#pragma once

#include "common.cuh"

namespace sdt {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <typename T, typename I>
struct Args {
  const I* a_indptr;
  const I* a_indices;
  const T* a_data;
  const I* b_indptr;
  const I* b_indices;
  const T* b_data;
  const T* c0;
  T* c;
  // starts[k * (windows + 1) + w]: the first position of op(B)'s row k
  // at or past column w * width (the row's end for w = windows); null
  // when the table is not built.
  I* starts;
  int64_t n, k;
  int64_t width;    // columns of a window
  int64_t windows;  // ceil(n / width)
  int64_t items;    // m * windows
  T alpha, beta;
  int splits;       // warps an item: 1, 2, 4 or 8
  bool scale, triangular;
};

// Member strides, in elements, of a batched launch (0: shared).
struct Strides {
  int64_t a, b, c0, c;
};

// The first q in [lo, hi) with idx[q] >= key (hi when there is none), for
// idx ascending over [lo, hi).
template <typename I>
__device__ __forceinline__ int64_t lower_bound(const I* __restrict__ idx,
                                               int64_t lo, int64_t hi,
                                               int64_t key) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(idx[mid]) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Loads a round of op(B)'s row: a lane's positions t = lane + 32 u below
// cnt of the row from (bj, bv); the slots of u with 32 u >= cnt are left.
template <int U, typename T, typename I>
__device__ __forceinline__ void load_round(const I* __restrict__ bj,
                                           const T* __restrict__ bv, int cnt,
                                           int lane, I (&j)[U], T (&b)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = lane + 32 * u;
    if (t < cnt) {
      j[u] = bj[t];
      b[u] = bv[t];
    }
  }
}

// The window-start table (Args::starts), one thread an entry: the
// searches that the walk would otherwise repeat for every entry of op(A)
// that names the row.
template <typename T, typename I>
__global__ void __launch_bounds__(256)
window_starts_kernel(const Args<T, I> g) {
  const int64_t per_row = g.windows + 1;
  const int64_t total = g.k * per_row;
  for (int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       t < total; t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = t / per_row, w = t % per_row;
    const int64_t end = g.b_indptr[row + 1];
    g.starts[t] = static_cast<I>(
        w == g.windows ? end
                       : lower_bound(g.b_indices, g.b_indptr[row], end,
                                     w * g.width));
  }
}

// The arguments of a launch, validated by the caller; the window-start
// table is dropped where a row is one window.
template <typename T, typename I>
Args<T, I> dense_args(const void* a_indptr, const void* a_indices,
                      const void* a_data, const void* b_indptr,
                      const void* b_indices, const void* b_data,
                      const void* c0, void* c, int64_t m, int64_t n,
                      double alpha_re, double alpha_im, double beta_re,
                      double beta_im, int triangular, int splits,
                      int64_t width, int64_t k, void* starts) {
  Args<T, I> g;
  g.a_indptr = static_cast<const I*>(a_indptr);
  g.a_indices = static_cast<const I*>(a_indices);
  g.a_data = static_cast<const T*>(a_data);
  g.b_indptr = static_cast<const I*>(b_indptr);
  g.b_indices = static_cast<const I*>(b_indices);
  g.b_data = static_cast<const T*>(b_data);
  g.c0 = static_cast<const T*>(c0);
  g.c = static_cast<T*>(c);
  g.starts = static_cast<I*>(starts);
  g.n = n;
  g.k = k;
  g.width = width < n ? width : n;
  g.windows = (n + g.width - 1) / g.width;
  g.items = m * g.windows;
  g.alpha = Arith<T>::make(alpha_re, alpha_im);
  g.beta = Arith<T>::make(beta_re, beta_im);
  g.splits = splits;
  g.scale = !is_one(alpha_re, alpha_im);
  g.triangular = triangular != 0;
  if (g.windows == 1) g.starts = nullptr;
  return g;
}

// Builds the window-start table unless an earlier launch of the call
// did (starts_ready) or there is none.
template <typename T, typename I>
void build_starts(const Args<T, I>& g, int starts_ready,
                  cudaStream_t stream) {
  if (g.starts != nullptr && g.k > 0 && !starts_ready) {
    const int64_t total = g.k * (g.windows + 1);
    const int64_t blocks = (total + 255) / 256;
    window_starts_kernel<T, I><<<static_cast<unsigned>(
        blocks < 65535 * 16 ? blocks : 65535 * 16), 256, 0, stream>>>(g);
  }
}

}  // namespace
}  // namespace sdt
