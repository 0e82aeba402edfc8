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
// Bound: the bytes of op(A), of the entries of op(B) it needs, each once,
// and of C.  What the design meets instead: each product reads its entry
// of op(B) again (12 bytes from L2 for f64 and int32 indices), each entry
// of op(A) names its row of op(B) through a chain of dependent loads
// (op(A)'s column, op(B)'s row start and end, its columns), and random
// columns of a row update shared memory with bank conflicts.
//
// Design.  The unit of work is a warp, and a warp only ever writes its own
// partial row, in shared memory: no block-wide barrier per entry of op(A),
// no atomics.  A work item is one row i of C over one window of `width`
// columns [j0, j0 + width); `splits` warps share an item, each taking one
// contiguous chunk of the row's entries of op(A) (a block of 8 warps
// holds 8 / splits items).  ops/spgemm.py (dense_plan) picks splits and
// width from m, n, the value size and op(A)'s mean row length: few rows
// are split across warps, many rows take a warp each, and a row whose n
// values do not fit a warp's share of shared memory is cut into windows.
//
// A warp walks its entries 32 at a time: each lane loads one entry's
// column k, value and op(B)'s row start and end (so the chain
// a_indices -> b_indptr runs in 32 lanes at once, not once per step), and
// the entries reach the warp by __shfl_sync.  A round then adds up to
// 32 * U products of one op(B) row (U = 4 a lane, 2 for complex128),
// each lane its own columns; the next round's columns and values are
// loaded before this round's updates.  The columns of an op(B) row are
// distinct, so no two lanes of a round update one column, and a
// __syncwarp orders one round's updates before the next.  Registers set
// the warps an SM holds, so a round's lanes are predicated rather than
// cut short, and no more rounds are loaded ahead: on the H100 both cost
// more than they saved.
//
// Where an item covers less than the whole row (windows, or the
// diagonal under `triangular`), op(B)'s rows must list their columns in
// ascending order: the wrapper sorts them once when the caller cannot say
// they are (ops/spgemm.py; the public path caches the sorted copy on the
// container, formats.sorted_csr_arrays).  A row of op(B) is then entered
// at the item's first column (max(j0, i) under `triangular`) and left at
// its last, so columns outside the item are never read.  Each product's
// column is still tested against the item's columns: rows that are not in
// fact sorted give a wrong sum, never a write outside the warp's partial
// row.  Where a row is cut into windows, a first kernel writes where each
// row of op(B) enters every window (`starts`, scratch from the wrapper),
// so an entry of op(A) finds its span with one load instead of two binary
// searches (a search is a chain of dependent loads, each lane of a warp
// on another cache line); the diagonal under `triangular` is still found
// by search.
//
// The same bits on every run: each warp sums its chunk in op(A)'s stored
// order, and the chunks' partial rows are added in chunk order.  The
// alpha/beta epilogue is fused into the store.
//
// A batch of members that share op(A)'s and op(B)'s patterns (jax.vmap of
// spgemm_numeric_sorted over the values; torch.func.vmap, jacfwd and
// hessian of csr_spgemm_dense) is one launch: the member is blockIdx.y,
// and op(A)'s values, op(B)'s values, C0 and C each have a member stride,
// 0 for an operand that all members share (read in place, never copied).
// The plan and the window-start table depend on the patterns alone: the
// wrapper plans once, and the table is built once for the batch (not
// again by a second launch of a batch past kMaxMembers).  A block works
// for one member, so a split row's chunks meet only that member's
// partial rows.  A single product is the instance with BATCH false, whose
// code has no member offsets.  This per-member instance runs a batch
// where the wrapper's group is one member; csr_spgemm_dense_group.cu
// serves a group of members a block from one walk.
#include "csr_spgemm_dense.cuh"

namespace sdt {
namespace {

// One warp adds op(A)[i, pa:pb] @ op(B), restricted to the columns
// [lo, hi) of window w (columns from j0), into acc.  SEARCH: op(B)'s rows
// are sorted and each is cut to [lo, hi), at the window's ends from the
// table when there is one, else (and at a lo inside the window, the
// diagonal) by binary search, and each product's column is tested
// against [lo, hi) all the same; else [lo, hi) is all of op(B)'s columns.
template <bool SEARCH, typename T, typename I>
__device__ __forceinline__ void walk(const Args<T, I>& g, T* acc, int64_t pa,
                                     int64_t pb, int64_t w, int64_t j0,
                                     int64_t lo, int64_t hi, int lane) {
  using A = Arith<T>;
  // Positions of one op(B) row a lane takes in a round, all loaded before
  // any is added.
  constexpr int U = sizeof(T) <= 8 ? 4 : 2;
  constexpr int kSpan = 32 * U;
  const I first = static_cast<I>(j0);
  for (int64_t base = pa; base < pb; base += 32) {
    // Each lane loads one entry of op(A) and the span of op(B)'s row it
    // names.
    const int64_t p = base + lane;
    int64_t qs = 0, qe = 0;
    T av = A::zero();
    if (p < pb) {
      const int64_t k = g.a_indices[p];
      av = g.a_data[p];
      if (SEARCH && g.starts != nullptr) {
        const I* at = g.starts + k * (g.windows + 1) + w;
        qs = at[0];
        qe = at[1];
        if (lo > j0) qs = lower_bound(g.b_indices, qs, qe, lo);
      } else {
        qs = g.b_indptr[k];
        qe = g.b_indptr[k + 1];
        if (SEARCH) {
          if (hi < g.n) qe = lower_bound(g.b_indices, qs, qe, hi);
          if (lo > 0) qs = lower_bound(g.b_indices, qs, qe, lo);
        }
      }
    }
    unsigned live = __ballot_sync(kFullMask, qs < qe);
    if (!live) continue;
    // A round: up to kSpan products of one entry from q0, a lane's at
    // q0 + lane + 32 u.  The first round is the first live entry's.
    int e = __ffs(static_cast<int>(live)) - 1;
    live &= live - 1;
    int64_t q0 = __shfl_sync(kFullMask, qs, e);
    int64_t q1 = __shfl_sync(kFullMask, qe, e);
    T a = A::shfl(av, e);
    int cnt = static_cast<int>(q1 - q0 < kSpan ? q1 - q0 : kSpan);
    I j[U];
    T b[U];
    load_round<U>(g.b_indices + q0, g.b_data + q0, cnt, lane, j, b);
    while (true) {
      // The next round (warp-uniform): the rest of this op(B) row, else
      // the next live entry; its loads go out before this round's updates.
      int64_t n0 = q0 + kSpan, n1 = q1;
      T na = a;
      if (n0 >= q1 && live) {
        e = __ffs(static_cast<int>(live)) - 1;
        live &= live - 1;
        n0 = __shfl_sync(kFullMask, qs, e);
        n1 = __shfl_sync(kFullMask, qe, e);
        na = A::shfl(av, e);
      }
      const int ncnt = static_cast<int>(
          n0 >= n1 ? 0 : (n1 - n0 < kSpan ? n1 - n0 : kSpan));
      I nj[U];
      T nb[U];
      load_round<U>(g.b_indices + n0, g.b_data + n0, ncnt, lane, nj, nb);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (lane + 32 * u < cnt &&
            (!SEARCH || (j[u] >= static_cast<I>(lo) &&
                         j[u] < static_cast<I>(hi)))) {
          T* slot = acc + static_cast<int>(j[u] - first);
          *slot = A::fma(a, b[u], *slot);
        }
      }
      __syncwarp();
      if (ncnt == 0) break;
      q0 = n0;
      q1 = n1;
      a = na;
      cnt = ncnt;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        j[u] = nj[u];
        b[u] = nb[u];
      }
    }
  }
}

// At most 64 registers a thread for values of up to 8 bytes, so 4 blocks
// (32 warps) fit an SM; 128 for complex128.  With BATCH, blockIdx.y is the
// member.
template <typename T, typename I, bool BATCH>
__global__ void __launch_bounds__(kThreads, sizeof(T) <= 8 ? 4 : 2)
spgemm_dense_kernel(Args<T, I> g, const Strides st) {
  using A = Arith<T>;
  if constexpr (BATCH) {
    const int64_t z = blockIdx.y;
    g.a_data += z * st.a;
    g.b_data += z * st.b;
    if (g.c0 != nullptr) g.c0 += z * st.c0;
    g.c += z * st.c;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  T* const rows = reinterpret_cast<T*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = kWarps / g.splits;
  const int group = warp / g.splits, part = warp % g.splits;
  T* const acc = rows + warp * g.width;
  // The loop's trip count is the block's, so the barriers below (splits
  // > 1 only) are reached by every thread.
  for (int64_t first = static_cast<int64_t>(blockIdx.x) * groups;
       first < g.items; first += static_cast<int64_t>(gridDim.x) * groups) {
    const int64_t item = first + group;
    const bool has = item < g.items;
    int64_t i = 0, win = 0, j0 = 0, w = 0;
    if (has) {
      i = item / g.windows;
      win = item % g.windows;
      j0 = win * g.width;
      w = g.n - j0 < g.width ? g.n - j0 : g.width;
      for (int64_t j = lane; j < w; j += 32) acc[j] = A::zero();
      __syncwarp();
      const int64_t lo = g.triangular && i > j0 ? i : j0;
      const int64_t hi = j0 + w;
      if (lo < hi) {
        const int64_t r0 = g.a_indptr[i];
        const int64_t len = g.a_indptr[i + 1] - r0;
        const int64_t pa = r0 + len * part / g.splits;
        const int64_t pb = r0 + len * (part + 1) / g.splits;
        if (lo == 0 && hi == g.n) {
          walk<false>(g, acc, pa, pb, win, j0, lo, hi, lane);
        } else {
          walk<true>(g, acc, pa, pb, win, j0, lo, hi, lane);
        }
      }
    }
    if (g.splits == 1) {
      if (has) {
        T* out = g.c + i * g.n + j0;
        for (int64_t j = lane; j < w; j += 32) {
          out[j] = epilogue(acc[j], g.c0, i * g.n + j0 + j, g.alpha, g.beta,
                            g.scale);
        }
      }
      __syncwarp();
    } else {
      __syncthreads();
      if (has) {
        // The item's warps add its partial rows in chunk order.
        const T* parts = rows + group * g.splits * g.width;
        for (int64_t j = part * 32 + lane; j < w; j += g.splits * 32) {
          T v = parts[j];
          for (int s = 1; s < g.splits; ++s) {
            v = A::add(v, parts[s * g.width + j]);
          }
          const int64_t idx = i * g.n + j0 + j;
          g.c[idx] = epilogue(v, g.c0, idx, g.alpha, g.beta, g.scale);
        }
      }
      __syncthreads();
    }
  }
}

// The walk for one member (BATCH false) or for a batch.
template <typename T, typename I, bool BATCH>
cudaError_t launch_walk(const Args<T, I>& g, int64_t batch, const Strides& st,
                        cudaStream_t stream) {
  const size_t bytes = kWarps * static_cast<size_t>(g.width) * sizeof(T);
  auto kernel = spgemm_dense_kernel<T, I, BATCH>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int groups = kWarps / g.splits;
  const int64_t blocks = (g.items + groups - 1) / groups;
  const int64_t grid = blocks < 0x7fffffff ? blocks : 0x7fffffff;
  kernel<<<dim3(static_cast<unsigned>(grid), static_cast<unsigned>(batch)),
           kThreads, bytes, stream>>>(g, st);
  return cudaGetLastError();
}

template <typename T, typename I>
cudaError_t launch(const void* a_indptr, const void* a_indices,
                   const void* a_data, const void* b_indptr,
                   const void* b_indices, const void* b_data, const void* c0,
                   void* c, int64_t m, int64_t n, double alpha_re,
                   double alpha_im, double beta_re, double beta_im,
                   int triangular, int splits, int64_t width, int64_t k,
                   void* starts, int starts_ready, int64_t batch,
                   int64_t s_a, int64_t s_b, int64_t s_c0, int64_t s_c,
                   cudaStream_t stream) {
  if ((splits != 1 && splits != 2 && splits != 4 && splits != 8) ||
      width < 1 || m < 1 || n < 1 || batch < 1 || batch > kMaxMembers ||
      s_a < 0 || s_b < 0 || s_c0 < 0 || s_c < 0) {
    return cudaErrorInvalidValue;
  }
  const Args<T, I> g = dense_args<T, I>(
      a_indptr, a_indices, a_data, b_indptr, b_indices, b_data, c0, c, m, n,
      alpha_re, alpha_im, beta_re, beta_im, triangular, splits, width, k,
      starts);
  build_starts(g, starts_ready, stream);
  const Strides st{s_a, s_b, s_c0, s_c};
  if (batch == 1) return launch_walk<T, I, false>(g, batch, st, stream);
  return launch_walk<T, I, true>(g, batch, st, stream);
}

}  // namespace
}  // namespace sdt

// batch members (at most kMaxMembers, grid.y's limit), each operand at
// its member stride in elements (0: shared); batch 1 is one product.
// starts_ready: the window-start table was built by an earlier launch of
// the same call (for the same patterns), so this one only reads it.
extern "C" int sdt_csr_spgemm_dense(
    int dtype, int itype, const void* a_indptr, const void* a_indices,
    const void* a_data, const void* b_indptr, const void* b_indices,
    const void* b_data, const void* c0, void* c, int64_t m, int64_t n,
    double alpha_re, double alpha_im, double beta_re, double beta_im,
    int triangular, int splits, int64_t width, int64_t k, void* starts,
    int starts_ready, int64_t batch, int64_t s_a, int64_t s_b, int64_t s_c0,
    int64_t s_c, void* stream) {
  SDT_DISPATCH(dtype, itype, sdt::launch, a_indptr, a_indices, a_data,
               b_indptr, b_indices, b_data, c0, c, m, n, alpha_re, alpha_im,
               beta_re, beta_im, triangular, splits, width, k, starts,
               starts_ready, batch, s_a, s_b, s_c0, s_c,
               static_cast<cudaStream_t>(stream))
}
