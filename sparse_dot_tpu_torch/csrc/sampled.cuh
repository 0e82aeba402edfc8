// The sampled sparse-row kernel of K9 (csr_spgemm_sddmm.cu) and K11
// (csr_spgemm_sparse_sddmm.cu): a group of lanes serves a run of P's
// entries (sampled_runs) against one row of Y and lines of G, read from a
// dense D (K9) or staged from C's sparse storage (K11's kSparse modes).
// Each source file instantiates its own modes.
//
// A batch of members that share P's, Y's (and K11: C's) patterns is one
// launch (the backward of a vmap over the values, jacrev's cotangents, a
// batch of tangents): D (K11: G's values), Y's values and the output each
// have a member stride, 0 for an operand that all members share.  The
// runs are the patterns', shared by every member.  Where lines are
// staged and the members share Y's values, a block serves a group of 2 or
// 4 members (sampled_group_kernel, blockIdx.y the group): it walks the
// runs and loads each run's row of Y once for the group.  Otherwise, and
// where the plan (ops/spgemm_grad.py, group_plan) keeps one member a
// block, blockIdx.y is the member (sampled_kernel's BATCH instance).  Staging copies one element at a
// time (cp_async_elem of sizeof(T) bytes), so a member at any element
// stride stays aligned.  A single product is sampled_kernel's instance
// with BATCH false, whose code has no member offsets.
#pragma once

#include "mma.cuh"

namespace sdt {
namespace {

// Threads a block (ops/spgemm_grad.py's _THREADS), and blocks of that
// size an SM holds at least: 64 registers a thread.
constexpr int kThreads = 512;
constexpr int kMinBlocks = 2;
// Entries of a row of Y a lane holds in registers for the whole run.
constexpr int kHold = 4;
// Entries of a run a group sums at once (a round), at most its lanes.
constexpr int kRound = 4;

// Where a block reads D's lines: staged in shared memory, or in place as
// rows (dA) or as columns (dB); K11's lines of G staged from C's storage,
// rows (dA) or columns (dB) of G.
enum Mode : int {
  kStagedLines = 0,
  kRowsInPlace = 1,
  kColumnsInPlace = 2,
  kSparseRows = 3,
  kSparseColumns = 4
};

__device__ __forceinline__ float conj_of(float v) { return v; }
__device__ __forceinline__ double conj_of(double v) { return v; }
template <typename R>
__device__ __forceinline__ cuda::std::complex<R> conj_of(
    cuda::std::complex<R> v) {
  return cuda::std::complex<R>(v.real(), -v.imag());
}

// A staged element that C lacks: a quiet nan of a payload of its own in
// the real part.  A staged G value with that payload becomes the
// canonical nan, which gives the same nan parts in every product.
constexpr unsigned kAbsent32 = 0x7fd1ab5eu;
constexpr unsigned long long kAbsent64 = 0x7ffab5e0ab5e0001ull;

__device__ __forceinline__ bool absent(float v) {
  return __float_as_uint(v) == kAbsent32;
}
__device__ __forceinline__ bool absent(double v) {
  return static_cast<unsigned long long>(__double_as_longlong(v)) ==
         kAbsent64;
}
template <typename R>
__device__ __forceinline__ bool absent(cuda::std::complex<R> v) {
  return absent(v.real());
}
__device__ __forceinline__ float absent_value(float) {
  return __uint_as_float(kAbsent32);
}
__device__ __forceinline__ double absent_value(double) {
  return __longlong_as_double(static_cast<long long>(kAbsent64));
}
template <typename R>
__device__ __forceinline__ cuda::std::complex<R> absent_value(
    cuda::std::complex<R>) {
  return cuda::std::complex<R>(absent_value(R(0)), R(0));
}
__device__ __forceinline__ float staged(float v) {
  return absent(v) ? __uint_as_float(0x7fc00000u) : v;
}
__device__ __forceinline__ double staged(double v) {
  return absent(v) ? __longlong_as_double(0x7ff8000000000000ll) : v;
}
template <typename R>
__device__ __forceinline__ cuda::std::complex<R> staged(
    cuda::std::complex<R> v) {
  return cuda::std::complex<R>(staged(v.real()), v.imag());
}

// acc + x v where the staged element x is present.
template <typename T>
__device__ __forceinline__ T add_present(T acc, T x, T v) {
  return absent(x) ? acc : Arith<T>::fma(x, v, acc);
}

// For each of the K keys, how many of the ascending cols[0, len) lie
// below it: K searches of one shared length, by halving steps, so that
// their loads are in flight together.  P, the positions' and keys' type,
// may be 32 bits where C's ids are.
template <int K, typename I, typename P>
__device__ __forceinline__ void count_below(const I* __restrict__ cols,
                                            P len, const P (&key)[K],
                                            P (&at)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) at[k] = 0;
  for (P step = len > 0 ? P(1) << (63 - __clzll(len)) : 0; step > 0;
       step >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (at[k] + step <= len &&
          static_cast<P>(cols[at[k] + step - 1]) < key[k]) {
        at[k] += step;
      }
    }
  }
}

// Member strides, in elements, of a batched launch (0: shared): D (K11:
// G's values on C's pattern), Y's values, the output.
struct Strides {
  int64_t d, y, out;
};

// Entries of C a thread (dA) or rows of C a warp (dB) reads at once while
// it stages lines of G.
constexpr int kStageBatch = 8;
// The most lines a staged panel holds (ops/spgemm_grad.py's
// SAMPLED_MAX_PANEL): at most a warp's width of a row of C falls in a
// panel of columns.
constexpr int kMaxPanel = 32;

// The panel's `lines` lines of G from e0 on, `pitch` elements apart in
// dp: every element marked absent, then G's value written where C has
// the entry (and, under `triangular`, its column is at least its row).
// dA: lines are rows of G, C's rows e0 .. e0 + lines, whose entries lie
// together in C: the block's threads take them in turn, kStageBatch
// loads in flight a thread, each entry's row found in the panel's row
// bounds (`bounds`, in shared memory).  dB: lines are columns of G, m =
// ny long: each lane finds the panel's first column in one row i of C,
// then its warp reads its 32 rows' next 32 entries kStageBatch rows at a
// time, a lane an entry, so that a load touches one row of C and not 32.
//
// A member group's block (sampled_group_kernel) stages `count` panels at
// once, `dp_stride` elements apart, member z's from g + z * g_stride:
// C's row bounds (dA) or each row's first column in the panel (dB) are
// found once for all of them.  `threads` is the block's size.
template <typename T, typename I, bool kTransposed>
__device__ __forceinline__ void stage_lines(
    T* __restrict__ dp, int64_t* __restrict__ bounds, int64_t e0,
    int lines, int ny, int pitch, const I* __restrict__ c_indptr,
    const I* __restrict__ c_indices, const T* __restrict__ g,
    bool triangular, int threads = kThreads, int count = 1,
    int64_t g_stride = 0, int dp_stride = 0) {
  const T none = absent_value(T());
  for (int z = 0; z < count; ++z) {
    for (int x = threadIdx.x; x < lines * pitch; x += threads) {
      dp[z * dp_stride + x] = none;
    }
  }
  if constexpr (!kTransposed) {
    if (threadIdx.x <= lines) {
      bounds[threadIdx.x] = static_cast<int64_t>(c_indptr[e0 + threadIdx.x]);
    }
    __syncthreads();
    for (int z = 0; z < count; ++z) {
      const T* __restrict__ gz = g + z * g_stride;
      T* __restrict__ dz = dp + z * dp_stride;
      int e = 0;
      for (int64_t t = bounds[0] + threadIdx.x; t < bounds[lines];
           t += threads * kStageBatch) {
        int64_t col[kStageBatch];
        T val[kStageBatch];
#pragma unroll
        for (int b = 0; b < kStageBatch; ++b) {
          const int64_t tb = t + b * threads;
          const bool in = tb < bounds[lines];
          col[b] = in ? static_cast<int64_t>(c_indices[tb]) : -1;
          val[b] = in ? gz[tb] : T();
        }
#pragma unroll
        for (int b = 0; b < kStageBatch; ++b) {
          const int64_t tb = t + b * threads;
          while (e < lines && tb >= bounds[e + 1]) ++e;
          if (col[b] >= 0 && (!triangular || col[b] >= e0 + e)) {
            dz[e * pitch + col[b]] = staged(val[b]);
          }
        }
      }
    }
  } else {
    __syncthreads();
    const int lane = static_cast<int>(threadIdx.x) % 32;
    for (int i0 = static_cast<int>(threadIdx.x) / 32 * 32; i0 < ny;
         i0 += threads) {
      const int i = i0 + lane;
      int64_t t0 = 0, t1 = 0;
      if (i < ny) {
        const int64_t c0 = static_cast<int64_t>(c_indptr[i]);
        t1 = static_cast<int64_t>(c_indptr[i + 1]);
        const int64_t key[1] = {triangular && i > e0 ? i : e0};
        int64_t at[1];
        count_below<1>(c_indices + c0, t1 - c0, key, at);
        t0 = c0 + at[0];
      }
      for (int z = 0; z < count; ++z) {
        const T* __restrict__ gz = g + z * g_stride;
        T* __restrict__ dz = dp + z * dp_stride;
        for (int s = 0; s < 32 && i0 + s < ny; s += kStageBatch) {
          int col[kStageBatch];  // e0 + col, or -1
          T val[kStageBatch];
#pragma unroll
          for (int b = 0; b < kStageBatch; ++b) {
            // Every lane shuffles: a lane that skipped one would hang it.
            const int64_t tb = __shfl_sync(kFullMask, t0, s + b) + lane;
            const int64_t end = __shfl_sync(kFullMask, t1, s + b);
            const bool in = lane < lines && tb < end;
            const int64_t c = in ? static_cast<int64_t>(c_indices[tb]) : -1;
            col[b] =
                c >= e0 && c < e0 + lines ? static_cast<int>(c - e0) : -1;
            val[b] = in ? gz[tb] : T();
          }
#pragma unroll
          for (int b = 0; b < kStageBatch; ++b) {
            if (col[b] >= 0) {
              dz[col[b] * pitch + i0 + s + b] = staged(val[b]);
            }
          }
        }
      }
    }
  }
  __syncthreads();
}

// K9's kernel, and K11's where it stages lines (kSparseRows,
// kSparseColumns: d is G's values on C's pattern (c_indptr, c_indices),
// staged by stage_lines, a product added only where its element is
// present; se, sy, alpha and scale unused).
//
// items: (n_items + 1) int64, the first run of each work item; run_ptr:
// (n_runs + 1) positions in run order where each run starts; run_q: each
// run's row of Y; perm and line: each position's entry of P and line of
// D.  A line e's element y is d[e * se + y * sy], or dp[(e - e0) * pitch
// + y] once staged.  Columns read in place (kColumnsInPlace, L = 32) give
// each lane an entry of the run and read the row of Y by all lanes at
// once: the lanes' elements of D then lie side by side in one of its
// rows, where a group of lanes walking the row of Y would read 32 rows.
// With BATCH, blockIdx.y is the member (st: its strides).
template <typename T, typename I, int L, int kMode, bool BATCH>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sampled_kernel(const int64_t* __restrict__ items,
               const I* __restrict__ run_ptr, const I* __restrict__ run_q,
               const I* __restrict__ perm, const I* __restrict__ line,
               const T* __restrict__ d, int64_t se, int64_t sy, int64_t ne,
               int ny, int panel, int pitch,
               const I* __restrict__ y_indptr,
               const I* __restrict__ y_indices,
               const T* __restrict__ y_data, T* __restrict__ out, T alpha,
               bool scale, const I* __restrict__ c_indptr,
               const I* __restrict__ c_indices, bool triangular,
               const Strides st) {
  using A = Arith<T>;
  if constexpr (BATCH) {
    const int64_t z = blockIdx.y;
    d += z * st.d;
    y_data += z * st.y;
    out += z * st.out;
  }
  // Raw bytes: complex element types may not be declared __shared__.
  extern __shared__ __align__(16) unsigned char smem[];
  T* dp = reinterpret_cast<T*>(smem);
  const int64_t r0 = items[blockIdx.x];
  const int64_t r1 = items[blockIdx.x + 1];
  const int64_t e0 =
      static_cast<int64_t>(line[run_ptr[r0]]) / panel * panel;
  constexpr bool kSparse = kMode == kSparseRows || kMode == kSparseColumns;
  constexpr bool kStaged = kMode == kStagedLines || kSparse;
  if constexpr (kMode == kStagedLines) {
    const int lines = static_cast<int>(ne - e0 < panel ? ne - e0 : panel);
    const int total = lines * ny;
    // Every element's copy is issued before any is waited for.
    if (sy == 1) {  // lines are rows of d: read along them
      for (int x = threadIdx.x; x < total; x += kThreads) {
        const int e = x / ny;
        const int y = x - e * ny;
        cp_async_elem<sizeof(T)>(dp + e * pitch + y, d + (e0 + e) * se + y,
                                 true);
      }
    } else {  // lines are columns of d: read along d's rows
      for (int x = threadIdx.x; x < total; x += kThreads) {
        const int y = x / lines;
        const int e = x - y * lines;
        cp_async_elem<sizeof(T)>(dp + e * pitch + y, d + y * sy + e0 + e,
                                 true);
      }
    }
    cp_async_commit();
  }

  constexpr int E = kRound < L ? kRound : L;
  // Lines of D lie se apart, a line's elements step apart.
  const int64_t step = kStaged ? 1 : sy;
  const int lane = static_cast<int>(threadIdx.x) % L;
  // The group's lanes in its warp (groups never straddle a warp).
  const unsigned members =
      L == 32 ? kFullMask
              : ((1u << L) - 1u) << ((threadIdx.x & 31) & ~(L - 1));
  // A group's runs are r0 + group, r0 + group + G, ...; the next run's
  // bounds are loaded while the current one is summed.
  constexpr int G = kThreads / L;
  int64_t r = r0 + threadIdx.x / L;
  int64_t t0 = 0, t1 = 0, u0 = 0, u1 = 0;
  if (r < r1) {
    const int64_t q = static_cast<int64_t>(run_q[r]);
    t0 = static_cast<int64_t>(y_indptr[q]);
    t1 = static_cast<int64_t>(y_indptr[q + 1]);
    u0 = static_cast<int64_t>(run_ptr[r]);
    u1 = static_cast<int64_t>(run_ptr[r + 1]);
  }
  if constexpr (kMode == kStagedLines) {  // the first run's bounds came
    cp_async_wait<0>();                    // meanwhile
    __syncthreads();
  }
  if constexpr (kSparse) {  // while the first run's bounds load
    __shared__ int64_t bounds[kMaxPanel + 1];
    stage_lines<T, I, kMode == kSparseColumns>(
        dp, bounds, e0, static_cast<int>(ne - e0 < panel ? ne - e0 : panel),
        ny, pitch, c_indptr, c_indices, d, triangular);
  }
  for (; r < r1; r += G) {
    const int64_t rn = r + G;
    const bool more = rn < r1;
    const int64_t qn = more ? static_cast<int64_t>(run_q[rn]) : 0;
    const int64_t un0 = more ? static_cast<int64_t>(run_ptr[rn]) : 0;
    const int64_t un1 = more ? static_cast<int64_t>(run_ptr[rn + 1]) : 0;
    int64_t tn0 = 0, tn1 = 0;
    if constexpr (kMode == kColumnsInPlace) {
      if (more) {
        tn0 = static_cast<int64_t>(y_indptr[qn]);
        tn1 = static_cast<int64_t>(y_indptr[qn + 1]);
      }
      for (int64_t ub = u0; ub < u1; ub += L) {
        const int n = u1 - ub < L ? static_cast<int>(u1 - ub) : L;
        const T* __restrict__ col =
            d + (lane < n ? static_cast<int64_t>(line[ub + lane]) : e0);
        T acc = A::zero();
#pragma unroll 4
        for (int64_t t = t0; t < t1; ++t) {
          acc = A::fma(col[static_cast<int64_t>(y_indices[t]) * sy],
                       conj_of(y_data[t]), acc);
        }
        if (lane < n) {
          out[static_cast<int64_t>(perm[ub + lane])] =
              scale ? A::mul(alpha, acc) : acc;
        }
      }
    } else {
      // The run's row of Y in registers when it is short enough, and its
      // first L entries' lines and outputs, one a lane, loaded together;
      // a lane past the run takes the panel's first line.
      const bool hold = t1 - t0 <= static_cast<int64_t>(kHold) * L;
      int yi[kHold];
      T yv[kHold];
      if (hold) {
#pragma unroll
        for (int h = 0; h < kHold; ++h) {
          const int64_t t = t0 + lane + h * L;
          yi[h] = t < t1 ? static_cast<int>(y_indices[t]) : 0;
          yv[h] = t < t1 ? conj_of(y_data[t]) : A::zero();
        }
      }
      int n = u1 - u0 < L ? static_cast<int>(u1 - u0) : L;
      int64_t my_e = lane < n ? static_cast<int64_t>(line[u0 + lane]) : e0;
      int64_t my_p = lane < n ? static_cast<int64_t>(perm[u0 + lane]) : 0;
      // The next run's row of Y, once its row number has come.
      if (more) {
        tn0 = static_cast<int64_t>(y_indptr[qn]);
        tn1 = static_cast<int64_t>(y_indptr[qn + 1]);
      }
      for (int64_t ub = u0; ub < u1;) {
        for (int k = 0; k < n; k += E) {
          // A round of E entries: their products against the row of Y
          // interleaved, then one reduce-scatter.
          const T* base[E];
          T acc[E];
#pragma unroll
          for (int j = 0; j < E; ++j) {
            const int64_t e = __shfl_sync(members, my_e, k + j, L);
            base[j] = kStaged ? dp + (e - e0) * pitch : d + e * se;
            acc[j] = A::zero();
          }
          if (hold) {
#pragma unroll
            for (int h = 0; h < kHold; ++h) {
              if (t0 + lane + h * L < t1) {
                const int64_t y = static_cast<int64_t>(yi[h]) * step;
#pragma unroll
                for (int j = 0; j < E; ++j) {
                  acc[j] = kSparse ? add_present(acc[j], base[j][y], yv[h])
                                   : A::fma(base[j][y], yv[h], acc[j]);
                }
              }
            }
          } else {
            for (int64_t t = t0 + lane; t < t1; t += L) {
              const int64_t y = static_cast<int64_t>(y_indices[t]) * step;
              const T v = conj_of(y_data[t]);
#pragma unroll
              for (int j = 0; j < E; ++j) {
                acc[j] = kSparse ? add_present(acc[j], base[j][y], v)
                                 : A::fma(base[j][y], v, acc[j]);
              }
            }
          }
          const T total = reduce_scatter<T, L, E>(acc, lane, members);
          const int j = k + entry_of<L, E>(lane);
          const int64_t p = __shfl_sync(members, my_p, j, L);
          if (j < n && (lane & (L / E - 1)) == 0) {
            out[p] = scale ? A::mul(alpha, total) : total;
          }
        }
        ub += L;
        if (ub < u1) {
          n = u1 - ub < L ? static_cast<int>(u1 - ub) : L;
          my_e = lane < n ? static_cast<int64_t>(line[ub + lane]) : e0;
          my_p = lane < n ? static_cast<int64_t>(perm[ub + lane]) : 0;
        }
      }
    }
    t0 = tn0;
    t1 = tn1;
    u0 = un0;
    u1 = un1;
  }
}

// The batched launch's staged modes with a group of M members a block
// (kStagedLines, kSparseRows, kSparseColumns; M = 2 or 4, at most the
// lanes): blockIdx.y is the group, members z0 .. z0 + M - 1, the last
// group part full where the batch is not a multiple of M (its missing
// members read the last member's panel and write nothing).  The block
// stages the members' panels of `panel` lines each (one panel where D,
// or G, is shared: st.d == 0), then walks the item's runs once for all of
// them: each run's bounds, lines and output positions and its row of Y
// (indices and values) are loaded once, and a round takes E' = max(1, E /
// M) entries of the run, whose M * E' sums against the one row of Y go
// through one reduce-scatter, as K7's shared kernel does.  Y's values are
// the members' shared row (st.y == 0); the wrapper hands Y's rows in
// bank order (ops/spgemm_grad.py, bank_order: a row's entries dealt over
// the banks of a staged line, so that lanes reading one line at once
// mostly hit distinct banks), its values gathered into that order once a
// call (reading them through the order here ran 10% slower, PERF.md).
// With a row of values a member held in registers, 2 members a group ran
// slower than the per-member kernel (PERF.md), so the wrapper keeps one
// member a block there.  So a run
// costs its loads once for M members where the per-member kernel
// (sampled_kernel, BATCH) pays them M times, and at M = 4 no round is
// part empty.  The block has kGroupThreads threads, one block an SM
// holding up to 227 KB of panels, 64 registers a thread.
constexpr int kGroupThreads = 1024;

template <typename T, typename I, int L, int kMode, int M>
__global__ void __launch_bounds__(kGroupThreads, 1)
sampled_group_kernel(const int64_t* __restrict__ items,
                     const I* __restrict__ run_ptr,
                     const I* __restrict__ run_q, const I* __restrict__ perm,
                     const I* __restrict__ line, const T* __restrict__ d,
                     int64_t se, int64_t sy, int64_t ne, int ny, int panel,
                     int pitch, const I* __restrict__ y_indptr,
                     const I* __restrict__ y_indices,
                     const T* __restrict__ y_data, T* __restrict__ out,
                     T alpha, bool scale, const I* __restrict__ c_indptr,
                     const I* __restrict__ c_indices, bool triangular,
                     const Strides st, int64_t batch) {
  using A = Arith<T>;
  constexpr bool kSparse = kMode == kSparseRows || kMode == kSparseColumns;
  static_assert(kMode == kStagedLines || kSparse, "staged modes only");
  static_assert(M >= 2 && M <= L, "a group's sums fit one reduce-scatter");
  constexpr int threads = kGroupThreads;
  const int64_t z0 = static_cast<int64_t>(blockIdx.y) * M;
  const int count = batch - z0 < M ? static_cast<int>(batch - z0) : M;
  extern __shared__ __align__(16) unsigned char smem[];
  T* dp = reinterpret_cast<T*>(smem);
  const int64_t r0 = items[blockIdx.x];
  const int64_t r1 = items[blockIdx.x + 1];
  const int64_t e0 =
      static_cast<int64_t>(line[run_ptr[r0]]) / panel * panel;
  const int lines = static_cast<int>(ne - e0 < panel ? ne - e0 : panel);
  // One panel a member, or one for all where D (G) is shared.
  const int panels = st.d == 0 ? 1 : count;
  const int ps = st.d == 0 ? 0 : panel * pitch;
  // Member m's panel: a missing member of a part-full group reads the
  // last member's, which is staged.
  int off[M];
#pragma unroll
  for (int m = 0; m < M; ++m) off[m] = (m < count ? m : count - 1) * ps;
  if constexpr (kMode == kStagedLines) {
    const int total = lines * ny;
    for (int z = 0; z < panels; ++z) {
      const T* __restrict__ dz = d + (z0 + z) * st.d;
      T* __restrict__ pz = dp + z * ps;
      if (sy == 1) {  // lines are rows of d: read along them
        for (int x = threadIdx.x; x < total; x += threads) {
          const int e = x / ny;
          const int y = x - e * ny;
          cp_async_elem<sizeof(T)>(pz + e * pitch + y,
                                   dz + (e0 + e) * se + y, true);
        }
      } else {  // lines are columns of d: read along d's rows
        for (int x = threadIdx.x; x < total; x += threads) {
          const int y = x / lines;
          const int e = x - y * lines;
          cp_async_elem<sizeof(T)>(pz + e * pitch + y, dz + y * sy + e0 + e,
                                   true);
        }
      }
    }
    cp_async_commit();
  }

  constexpr int E = kRound < L ? kRound : L;
  constexpr int EP = E / M > 0 ? E / M : 1;  // entries a round
  constexpr int S = M * EP;                  // sums a round
  const int lane = static_cast<int>(threadIdx.x) % L;
  const unsigned mask =
      L == 32 ? kFullMask
              : ((1u << L) - 1u) << ((threadIdx.x & 31) & ~(L - 1));
  const int G = threads / L;
  int64_t r = r0 + threadIdx.x / L;
  int64_t t0 = 0, t1 = 0, u0 = 0, u1 = 0;
  if (r < r1) {
    const int64_t q = static_cast<int64_t>(run_q[r]);
    t0 = static_cast<int64_t>(y_indptr[q]);
    t1 = static_cast<int64_t>(y_indptr[q + 1]);
    u0 = static_cast<int64_t>(run_ptr[r]);
    u1 = static_cast<int64_t>(run_ptr[r + 1]);
  }
  if constexpr (kMode == kStagedLines) {
    cp_async_wait<0>();
    __syncthreads();
  }
  if constexpr (kSparse) {
    __shared__ int64_t bounds[kMaxPanel + 1];
    stage_lines<T, I, kMode == kSparseColumns>(
        dp, bounds, e0, lines, ny, pitch, c_indptr, c_indices,
        d + z0 * st.d, triangular, threads, panels, st.d, ps);
  }
  for (; r < r1; r += G) {
    const int64_t rn = r + G;
    const bool more = rn < r1;
    const int64_t qn = more ? static_cast<int64_t>(run_q[rn]) : 0;
    const int64_t un0 = more ? static_cast<int64_t>(run_ptr[rn]) : 0;
    const int64_t un1 = more ? static_cast<int64_t>(run_ptr[rn + 1]) : 0;
    int64_t tn0 = 0, tn1 = 0;
    const bool hold = t1 - t0 <= static_cast<int64_t>(kHold) * L;
    int yi[kHold];
    T yv[kHold];
    if (hold) {
#pragma unroll
      for (int h = 0; h < kHold; ++h) {
        const int64_t t = t0 + lane + h * L;
        yi[h] = t < t1 ? static_cast<int>(y_indices[t]) : 0;
        yv[h] = t < t1 ? conj_of(y_data[t]) : A::zero();
      }
    }
    int n = u1 - u0 < L ? static_cast<int>(u1 - u0) : L;
    int64_t my_e = lane < n ? static_cast<int64_t>(line[u0 + lane]) : e0;
    int64_t my_p = lane < n ? static_cast<int64_t>(perm[u0 + lane]) : 0;
    if (more) {
      tn0 = static_cast<int64_t>(y_indptr[qn]);
      tn1 = static_cast<int64_t>(y_indptr[qn + 1]);
    }
    for (int64_t ub = u0; ub < u1;) {
      for (int k = 0; k < n; k += EP) {
        // A round: EP entries of the run for each of the M members, the
        // sum of member m's entry k + j in acc[m * EP + j].
        const T* base[EP];
        T acc[S];
#pragma unroll
        for (int j = 0; j < EP; ++j) {
          const int64_t e = __shfl_sync(mask, my_e, k + j, L);
          base[j] = dp + (e - e0) * pitch;
        }
#pragma unroll
        for (int s = 0; s < S; ++s) acc[s] = A::zero();
        if (hold) {
#pragma unroll
          for (int h = 0; h < kHold; ++h) {
            if (t0 + lane + h * L < t1) {
              const int y = yi[h];
              const T v = yv[h];
#pragma unroll
              for (int m = 0; m < M; ++m) {
#pragma unroll
                for (int j = 0; j < EP; ++j) {
                  const T x = base[j][off[m] + y];
                  T& a = acc[m * EP + j];
                  a = kSparse ? add_present(a, x, v) : A::fma(x, v, a);
                }
              }
            }
          }
        } else {
          for (int64_t t = t0 + lane; t < t1; t += L) {
            const int y = static_cast<int>(y_indices[t]);
            const T v = conj_of(y_data[t]);
#pragma unroll
            for (int m = 0; m < M; ++m) {
#pragma unroll
              for (int j = 0; j < EP; ++j) {
                const T x = base[j][off[m] + y];
                T& a = acc[m * EP + j];
                a = kSparse ? add_present(a, x, v) : A::fma(x, v, a);
              }
            }
          }
        }
        const T total = reduce_scatter<T, L, S>(acc, lane, mask);
        const int s = entry_of<L, S>(lane);
        const int m = s / EP;
        const int j = k + s % EP;
        const int64_t p = __shfl_sync(mask, my_p, j, L);
        if (j < n && m < count && (lane & (L / S - 1)) == 0) {
          out[(z0 + m) * st.out + p] = scale ? A::mul(alpha, total) : total;
        }
      }
      ub += L;
      if (ub < u1) {
        n = u1 - ub < L ? static_cast<int>(u1 - ub) : L;
        my_e = lane < n ? static_cast<int64_t>(line[ub + lane]) : e0;
        my_p = lane < n ? static_cast<int64_t>(perm[ub + lane]) : 0;
      }
    }
    t0 = tn0;
    t1 = tn1;
    u0 = un0;
    u1 = un1;
  }
}
}  // namespace
}  // namespace sdt
