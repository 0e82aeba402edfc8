// K6 for a batch whose members share op(A)'s and op(B)'s patterns, M
// members (2 or 4) a block: blockIdx.y is a group of M consecutive
// members, and a warp walks its chunk of op(A)'s row once for all of
// them.  The per-member instance (csr_spgemm_dense.cu, blockIdx.y a
// member) repeats the whole walk for each member: the chain a_indices ->
// starts or b_indptr -> b_indices and each op(B) row's round loads (12
// bytes a product from L2 in f64 with int32 ids), though the members
// differ only in their values.  Here each lane loads an entry's column
// and op(B)'s span once, and one value of op(A) a member; a round loads
// op(B)'s columns once, and its values once where they are shared (else
// one a member), and then adds M products into M partial rows.
//
// What the members share decides the form, from the strides:
// - kBShared: op(B)'s values shared, op(A)'s per member (phase 4's rows,
//   ensembles, jacfwd in a_data): one value of op(B) a position;
// - kBPer: op(B)'s values per member, op(A)'s per member or shared
//   (jacfwd in b_data): M values of op(B) a position, read at their
//   stride, fewer positions a lane a round so that they fit registers;
// - kOneSum: both shared, only C0 or C per member: the product is summed
//   once for the group, into one partial row, and each member gets its
//   own epilogue (4 members a block, whatever the batch).
//
// Random columns make a product's shared-memory update the kernel's
// dearest step (bank conflicts), here as in the per-member instance.  A
// warp's M partial rows lie in planes of V sums side by side, V the
// members 16 bytes hold: plane p holds members [p V, (p + 1) V) of every
// column, so a product's M updates are M / V accesses of 16 bytes, each
// spread over the banks as a 16-byte column would be (two f64 planes at
// M = 4, not one 32-byte column whose halves would meet in half the
// banks).  A block takes kWarps * width * M values of shared memory, M
// times the per-member instance's: the single plan's window cap
// (ops/spgemm.py, DENSE_ROW_BYTES) leaves room for M = 4.
//
// Each member has its single launch's bits under the same splits: a
// warp's chunk of op(A)'s row is summed in op(A)'s stored order, each
// product by the same fma, and a split row's partial rows are added in
// chunk order; a round's length and a window's width do not change which
// products meet a column, nor their order.  A part-full last group's
// missing members read the last member's values and store nothing.  A
// source of its own, so that nvcc builds these instances beside the
// per-member ones.
#include "csr_spgemm_dense.cuh"

namespace sdt {
namespace {

enum Form : int { kBShared = 0, kBPer = 1, kOneSum = 2 };

// V sums of one column, side by side (V * sizeof(T) <= 16).
template <typename T, int V>
struct alignas(V * sizeof(T)) Sums {
  T v[V];
};

// R sums a column in P planes of V: plane p of column j at p * width + j.
template <typename T, int R>
struct Planes {
  static constexpr int V0 = sizeof(T) < 16 ? 16 / static_cast<int>(sizeof(T)) : 1;
  static constexpr int V = R < V0 ? R : V0;
  static constexpr int P = R / V;
  using Vec = Sums<T, V>;
};

template <typename T, int R>
__device__ __forceinline__ void load_sums(
    const typename Planes<T, R>::Vec* row, int64_t width, int64_t j,
    T (&s)[R]) {
  using L = Planes<T, R>;
#pragma unroll
  for (int p = 0; p < L::P; ++p) {
    const typename L::Vec x = row[p * width + j];
#pragma unroll
    for (int v = 0; v < L::V; ++v) s[p * L::V + v] = x.v[v];
  }
}

template <typename T, int R>
__device__ __forceinline__ void store_sums(typename Planes<T, R>::Vec* row,
                                           int64_t width, int64_t j,
                                           const T (&s)[R]) {
  using L = Planes<T, R>;
#pragma unroll
  for (int p = 0; p < L::P; ++p) {
    typename L::Vec x;
#pragma unroll
    for (int v = 0; v < L::V; ++v) x.v[v] = s[p * L::V + v];
    row[p * width + j] = x;
  }
}

template <int FORM, typename T, int M>
struct Group {
  // Sums a column: one a member, one for all in kOneSum.
  static constexpr int R = FORM == kOneSum ? 1 : M;
  // op(B)'s values a position of a round.
  static constexpr int RB = FORM == kBPer ? M : 1;
  // Positions of one op(B) row a lane takes in a round (the single
  // kernel's, fewer where each carries M values).
  static constexpr int U0 = sizeof(T) <= 8 ? 4 : 2;
  static constexpr int U = FORM == kBPer ? (U0 / 2 > 0 ? U0 / 2 : 1) : U0;
  // Blocks an SM the registers are cut for; shared memory may allow
  // fewer.
  static constexpr int kBlocks =
      sizeof(T) <= 8 ? (M == 2 || FORM == kOneSum ? 3 : 2) : (M == 2 ? 2 : 1);
};

// Loads a round of op(B)'s row from position q (columns from bj, member
// r's values from bv + r * sb, r < last being the last live member).
template <int U, int RB, typename T, typename I>
__device__ __forceinline__ void load_group_round(
    const I* __restrict__ bj, const T* __restrict__ bv, int64_t sb,
    int last, int cnt, int lane, I (&j)[U], T (&b)[U][RB]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int t = lane + 32 * u;
    if (t < cnt) {
      j[u] = bj[t];
#pragma unroll
      for (int r = 0; r < RB; ++r) b[u][r] = bv[t + (r < last ? r : last) * sb];
    }
  }
}

// walk (csr_spgemm_dense.cu) for a group: one warp adds op(A)[i, pa:pb] @
// op(B) of each member, restricted to the columns [lo, hi) of window w,
// into the R sums a column of the planes from acc.  `last`: the last live
// member of the group.
template <bool SEARCH, int FORM, int M, typename T, typename I>
__device__ __forceinline__ void walk_group(
    const Args<T, I>& g, const Strides& st, int last,
    typename Planes<T, Group<FORM, T, M>::R>::Vec* acc, int64_t pa,
    int64_t pb, int64_t w, int64_t j0, int64_t lo, int64_t hi, int lane) {
  using A = Arith<T>;
  using G = Group<FORM, T, M>;
  constexpr int R = G::R, RB = G::RB, U = G::U;
  constexpr int kSpan = 32 * U;
  const I first = static_cast<I>(j0);
  for (int64_t base = pa; base < pb; base += 32) {
    // Each lane loads one entry of op(A), its value of each member, and
    // the span of op(B)'s row it names.
    const int64_t p = base + lane;
    int64_t qs = 0, qe = 0;
    T av[R];
#pragma unroll
    for (int r = 0; r < R; ++r) av[r] = A::zero();
    if (p < pb) {
      const int64_t k = g.a_indices[p];
#pragma unroll
      for (int r = 0; r < R; ++r) av[r] = g.a_data[p + (r < last ? r : last) * st.a];
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
    int e = __ffs(static_cast<int>(live)) - 1;
    live &= live - 1;
    int64_t q0 = __shfl_sync(kFullMask, qs, e);
    int64_t q1 = __shfl_sync(kFullMask, qe, e);
    T a[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = A::shfl(av[r], e);
    int cnt = static_cast<int>(q1 - q0 < kSpan ? q1 - q0 : kSpan);
    I j[U];
    T b[U][RB];
    load_group_round<U, RB>(g.b_indices + q0, g.b_data + q0, st.b, last,
                            cnt, lane, j, b);
    while (true) {
      // The next round (warp-uniform), its loads out before this round's
      // updates.
      int64_t n0 = q0 + kSpan, n1 = q1;
      T na[R];
#pragma unroll
      for (int r = 0; r < R; ++r) na[r] = a[r];
      if (n0 >= q1 && live) {
        e = __ffs(static_cast<int>(live)) - 1;
        live &= live - 1;
        n0 = __shfl_sync(kFullMask, qs, e);
        n1 = __shfl_sync(kFullMask, qe, e);
#pragma unroll
        for (int r = 0; r < R; ++r) na[r] = A::shfl(av[r], e);
      }
      const int ncnt = static_cast<int>(
          n0 >= n1 ? 0 : (n1 - n0 < kSpan ? n1 - n0 : kSpan));
      I nj[U];
      T nb[U][RB];
      load_group_round<U, RB>(g.b_indices + n0, g.b_data + n0, st.b, last,
                              ncnt, lane, nj, nb);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (lane + 32 * u < cnt &&
            (!SEARCH || (j[u] >= static_cast<I>(lo) &&
                         j[u] < static_cast<I>(hi)))) {
          const int col = static_cast<int>(j[u] - first);
          T s[R];
          load_sums<T, R>(acc, g.width, col, s);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            s[r] = A::fma(a[r], b[u][RB == 1 ? 0 : r], s[r]);
          }
          store_sums<T, R>(acc, g.width, col, s);
        }
      }
      __syncwarp();
      if (ncnt == 0) break;
      q0 = n0;
      q1 = n1;
      cnt = ncnt;
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = na[r];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        j[u] = nj[u];
#pragma unroll
        for (int r = 0; r < RB; ++r) b[u][r] = nb[u][r];
      }
    }
  }
}

// Stores column j of row i (window from j0) of each live member: the sums
// s through the alpha / beta * C0 epilogue (C0 per member or shared).
template <int FORM, int M, typename T, typename I>
__device__ __forceinline__ void store_members(
    const Args<T, I>& g, const Strides& st, int last,
    const T (&s)[Group<FORM, T, M>::R], int64_t idx) {
#pragma unroll
  for (int r = 0; r < M; ++r) {
    if (r <= last) {
      g.c[r * st.c + idx] = epilogue(
          s[FORM == kOneSum ? 0 : r],
          g.c0 == nullptr ? nullptr : g.c0 + r * st.c0, idx, g.alpha, g.beta,
          g.scale);
    }
  }
}

// spgemm_dense_kernel for a group of M members from blockIdx.y * M.
template <int FORM, typename T, typename I, int M>
__global__ void __launch_bounds__(kThreads, Group<FORM, T, M>::kBlocks)
spgemm_dense_group_kernel(Args<T, I> g, const Strides st, int64_t batch) {
  using A = Arith<T>;
  constexpr int R = Group<FORM, T, M>::R;
  using Vec = typename Planes<T, R>::Vec;
  constexpr int P = Planes<T, R>::P;
  const int64_t z0 = static_cast<int64_t>(blockIdx.y) * M;
  const int last = static_cast<int>(batch - z0 < M ? batch - z0 - 1 : M - 1);
  g.a_data += z0 * st.a;
  g.b_data += z0 * st.b;
  if (g.c0 != nullptr) g.c0 += z0 * st.c0;
  g.c += z0 * st.c;
  extern __shared__ __align__(16) unsigned char smem[];
  Vec* const rows = reinterpret_cast<Vec*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = kWarps / g.splits;
  const int group = warp / g.splits, part = warp % g.splits;
  const int64_t pitch = P * g.width;  // a warp's planes
  Vec* const acc = rows + warp * pitch;
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
      for (int64_t j = lane; j < w; j += 32) {
        T zero[R];
#pragma unroll
        for (int r = 0; r < R; ++r) zero[r] = A::zero();
        store_sums<T, R>(acc, g.width, j, zero);
      }
      __syncwarp();
      const int64_t lo = g.triangular && i > j0 ? i : j0;
      const int64_t hi = j0 + w;
      if (lo < hi) {
        const int64_t r0 = g.a_indptr[i];
        const int64_t len = g.a_indptr[i + 1] - r0;
        const int64_t pa = r0 + len * part / g.splits;
        const int64_t pb = r0 + len * (part + 1) / g.splits;
        if (lo == 0 && hi == g.n) {
          walk_group<false, FORM, M>(g, st, last, acc, pa, pb, win, j0, lo,
                                     hi, lane);
        } else {
          walk_group<true, FORM, M>(g, st, last, acc, pa, pb, win, j0, lo,
                                    hi, lane);
        }
      }
    }
    if (g.splits == 1) {
      if (has) {
        for (int64_t j = lane; j < w; j += 32) {
          T v[R];
          load_sums<T, R>(acc, g.width, j, v);
          store_members<FORM, M>(g, st, last, v, i * g.n + j0 + j);
        }
      }
      __syncwarp();
    } else {
      __syncthreads();
      if (has) {
        // The item's warps add its partial rows in chunk order.
        const Vec* parts = rows + group * g.splits * pitch;
        for (int64_t j = part * 32 + lane; j < w; j += g.splits * 32) {
          T v[R];
          load_sums<T, R>(parts, g.width, j, v);
          for (int s = 1; s < g.splits; ++s) {
            T x[R];
            load_sums<T, R>(parts + s * pitch, g.width, j, x);
#pragma unroll
            for (int r = 0; r < R; ++r) v[r] = A::add(v[r], x[r]);
          }
          store_members<FORM, M>(g, st, last, v, i * g.n + j0 + j);
        }
      }
      __syncthreads();
    }
  }
}

template <int FORM, typename T, typename I, int M>
cudaError_t launch_group_walk(const Args<T, I>& g, int64_t batch,
                              const Strides& st, cudaStream_t stream) {
  constexpr int R = Group<FORM, T, M>::R;
  const size_t bytes = kWarps * static_cast<size_t>(g.width) * R * sizeof(T);
  auto kernel = spgemm_dense_group_kernel<FORM, T, I, M>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int groups = kWarps / g.splits;
  const int64_t blocks = (g.items + groups - 1) / groups;
  const int64_t grid = blocks < 0x7fffffff ? blocks : 0x7fffffff;
  kernel<<<dim3(static_cast<unsigned>(grid),
                static_cast<unsigned>((batch + M - 1) / M)),
           kThreads, bytes, stream>>>(g, st, batch);
  return cudaGetLastError();
}

template <typename T, typename I>
cudaError_t launch_group(const void* a_indptr, const void* a_indices,
                         const void* a_data, const void* b_indptr,
                         const void* b_indices, const void* b_data,
                         const void* c0, void* c, int64_t m, int64_t n,
                         double alpha_re, double alpha_im, double beta_re,
                         double beta_im, int triangular, int splits,
                         int64_t width, int64_t k, void* starts,
                         int starts_ready, int64_t batch, int64_t s_a,
                         int64_t s_b, int64_t s_c0, int64_t s_c, int group,
                         cudaStream_t stream) {
  if ((splits != 1 && splits != 2 && splits != 4 && splits != 8) ||
      width < 1 || m < 1 || n < 1 || batch < 1 || batch > kMaxMembers ||
      s_a < 0 || s_b < 0 || s_c0 < 0 || s_c < 0 ||
      (group != 2 && group != 4)) {
    return cudaErrorInvalidValue;
  }
  const Args<T, I> g = dense_args<T, I>(
      a_indptr, a_indices, a_data, b_indptr, b_indices, b_data, c0, c, m, n,
      alpha_re, alpha_im, beta_re, beta_im, triangular, splits, width, k,
      starts);
  build_starts(g, starts_ready, stream);
  const Strides st{s_a, s_b, s_c0, s_c};
  if (s_b > 0) {
    return group == 2 ? launch_group_walk<kBPer, T, I, 2>(g, batch, st, stream)
                      : launch_group_walk<kBPer, T, I, 4>(g, batch, st, stream);
  }
  if (s_a > 0) {
    return group == 2
               ? launch_group_walk<kBShared, T, I, 2>(g, batch, st, stream)
               : launch_group_walk<kBShared, T, I, 4>(g, batch, st, stream);
  }
  return group == 4 ? launch_group_walk<kOneSum, T, I, 4>(g, batch, st, stream)
                    : cudaErrorInvalidValue;
}

}  // namespace
}  // namespace sdt

// sdt_csr_spgemm_dense for a batch of members (at most kMaxMembers),
// `group` (2 or 4; 4 where both operands' values are shared) of them a
// block; op(B)'s stride s_b, then op(A)'s s_a, says which form serves
// them (any stride 0: shared).
extern "C" int sdt_csr_spgemm_dense_group(
    int dtype, int itype, const void* a_indptr, const void* a_indices,
    const void* a_data, const void* b_indptr, const void* b_indices,
    const void* b_data, const void* c0, void* c, int64_t m, int64_t n,
    double alpha_re, double alpha_im, double beta_re, double beta_im,
    int triangular, int splits, int64_t width, int64_t k, void* starts,
    int starts_ready, int64_t batch, int64_t s_a, int64_t s_b, int64_t s_c0,
    int64_t s_c, int group, void* stream) {
  SDT_DISPATCH(dtype, itype, sdt::launch_group, a_indptr, a_indices, a_data,
               b_indptr, b_indices, b_data, c0, c, m, n, alpha_re, alpha_im,
               beta_re, beta_im, triangular, splits, width, k, starts,
               starts_ready, batch, s_a, s_b, s_c0, s_c, group,
               static_cast<cudaStream_t>(stream))
}
