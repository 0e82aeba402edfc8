// K9: sampled sparse-row product, for each entry p of a CSR P at row r_p,
// column c_p, one of two forms (conj only for complex values):
//
//   dA: out[p] = alpha * sum over (s, v) in row c_p of Y of D[r_p, s] conj(v)
//   dB: out[p] = alpha * sum over (i, v) in row r_p of Y of D[i, c_p] conj(v)
//
// with D dense and row-major (leading dimension ld) and Y a CSR.  They
// are the value gradients of C = alpha op(A) op(B) + beta C0 with dense
// output (ops/spgemm_grad.py), with D = G: dL/dA at A's pattern with
// Y = op(B), dL/dB at B's pattern with Y = op(A)^T.  Call D's row r_p
// (dA) or column c_p (dB) entry p's line, and the other id, the row of Y
// it names, q_p; a line is read at Y's column ids.
//
// Replaces XLA's transpose of sparse_dot_tpu/ops/_xla.py
// spgemm_numeric_sorted (:326, through densify_sorted :273): jax.grad of
// that function with respect to a_vals (b_vals) is a dense G @ op(B)^H
// (op(A)^H @ G) gathered at the operand's scatter positions, an m x k
// (k x n) dense product whatever the operands' density.
//
// Bound: one multiply-add per entry of P and entry of the row of Y it
// names, far below the card's multiply-add rate; the bytes that must
// move are P's arrays, each named row of Y and each named line of D once,
// and the output.  What the work pulls through L2 is larger: the design
// it replaces gave each entry its own group of lanes to walk its row of
// Y, so a row of Y was read once per entry naming it (at the demo's
// X @ X.T, 56.6 M products, ~680 MB of Y through L2 for 6.4 MB of Y),
// D's line was gathered through L1 and, for dL/dB, D was G^T, a copy.
// This design:
//
// - Runs (ops/spgemm_grad.py, sampled_runs, built once per pattern): D's
//   lines are cut into panels of `panel` lines, and P's entries sorted by
//   (panel of their line, q); a run is the entries of one panel that name
//   one row of Y.  A group of L lanes (sampled_lanes, 1 to 32) serves a
//   run: it loads the row of Y once (into registers when it has at most
//   kHold * L entries, else through L1 for each round after the first)
//   and sums the run's entries against it in rounds of E = kRound: the
//   round's lines and output positions loaded by the group's lanes
//   together (one a lane, then shuffled), lane l taking the row's entries
//   l, l + L, ... in order for each of the E entries at once, and one
//   reduce-scatter (common.cuh) adding the round's sums, E - 1 +
//   log2(L / E) shuffles where a butterfly an entry takes E log2(L).  The
//   loads and products of a round's entries are in flight together, and
//   the next run's bounds load while a run is summed.
// - A thread block takes a work item, a span of runs of one panel of
//   about equal entries, and stages the panel's lines in shared memory
//   first where several fit the plan's budget (sampled_plan; lines at an
//   odd pitch; every element's cp.async issued before any is waited for):
//   rows of D for dA, columns of D (read down the rows of G, no
//   transposed copy) for dB.  Longer lines are read in place through L1,
//   in panels of a few lines: runs in q order then touch the same columns
//   of those lines while the rows of Y they name share columns.
// - 512 threads a block at 64 registers a thread, so 2 blocks share an SM
//   where shared memory allows.
// - Every output is written by one lane, in a fixed order, with no
//   atomics: a run gives the same bits twice.
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
// rows (dA) or as columns (dB).
enum Mode : int { kStagedLines = 0, kRowsInPlace = 1, kColumnsInPlace = 2 };

__device__ __forceinline__ float conj_of(float v) { return v; }
__device__ __forceinline__ double conj_of(double v) { return v; }
template <typename R>
__device__ __forceinline__ cuda::std::complex<R> conj_of(
    cuda::std::complex<R> v) {
  return cuda::std::complex<R>(v.real(), -v.imag());
}

// items: (n_items + 1) int64, the first run of each work item; run_ptr:
// (n_runs + 1) positions in run order where each run starts; run_q: each
// run's row of Y; perm and line: each position's entry of P and line of
// D.  A line e's element y is d[e * se + y * sy], or dp[(e - e0) * pitch
// + y] once staged.  Columns read in place (kColumnsInPlace, L = 32) give
// each lane an entry of the run and read the row of Y by all lanes at
// once: the lanes' elements of D then lie side by side in one of its
// rows, where a group of lanes walking the row of Y would read 32 rows.
template <typename T, typename I, int L, int kMode>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sampled_kernel(const int64_t* __restrict__ items,
               const I* __restrict__ run_ptr, const I* __restrict__ run_q,
               const I* __restrict__ perm, const I* __restrict__ line,
               const T* __restrict__ d, int64_t se, int64_t sy, int64_t ne,
               int ny, int panel, int pitch,
               const I* __restrict__ y_indptr,
               const I* __restrict__ y_indices,
               const T* __restrict__ y_data, T* __restrict__ out, T alpha,
               bool scale) {
  using A = Arith<T>;
  // Raw bytes: complex element types may not be declared __shared__.
  extern __shared__ __align__(16) unsigned char smem[];
  T* dp = reinterpret_cast<T*>(smem);
  const int64_t r0 = items[blockIdx.x];
  const int64_t r1 = items[blockIdx.x + 1];
  const int64_t e0 =
      static_cast<int64_t>(line[run_ptr[r0]]) / panel * panel;
  constexpr bool kStaged = kMode == kStagedLines;
  if constexpr (kStaged) {
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
  if constexpr (kStaged) {  // the first run's bounds came meanwhile
    cp_async_wait<0>();
    __syncthreads();
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
                  acc[j] = A::fma(base[j][y], yv[h], acc[j]);
                }
              }
            }
          } else {
            for (int64_t t = t0 + lane; t < t1; t += L) {
              const int64_t y = static_cast<int64_t>(y_indices[t]) * step;
              const T v = conj_of(y_data[t]);
#pragma unroll
              for (int j = 0; j < E; ++j) {
                acc[j] = A::fma(base[j][y], v, acc[j]);
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

// The launch's arguments past the type codes, as the C entry point takes
// them.
struct Args {
  const void* items;
  int64_t n_items;
  const void* run_ptr;
  const void* run_q;
  const void* perm;
  const void* line;
  const void* d;
  int64_t se, sy, ne, ny;
  int panel, pitch, staged;
  const void* y_indptr;
  const void* y_indices;
  const void* y_data;
  void* out;
  int lanes;
};

template <typename T, typename I, int L, int kMode>
cudaError_t launch_lanes(const Args& a, T alpha, bool scale,
                         cudaStream_t stream) {
  auto kernel = sampled_kernel<T, I, L, kMode>;
  const size_t smem = kMode == kStagedLines
                          ? sizeof(T) * static_cast<size_t>(a.panel) * a.pitch
                          : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(a.n_items), kThreads, smem, stream>>>(
      static_cast<const int64_t*>(a.items), static_cast<const I*>(a.run_ptr),
      static_cast<const I*>(a.run_q), static_cast<const I*>(a.perm),
      static_cast<const I*>(a.line), static_cast<const T*>(a.d), a.se, a.sy,
      a.ne, static_cast<int>(a.ny), a.panel, a.pitch,
      static_cast<const I*>(a.y_indptr), static_cast<const I*>(a.y_indices),
      static_cast<const T*>(a.y_data), static_cast<T*>(a.out), alpha, scale);
  return cudaGetLastError();
}

template <typename T, typename I, int kMode>
cudaError_t launch_mode(const Args& a, T alpha, bool scale,
                        cudaStream_t stream) {
  switch (a.lanes) {
    case 1: return launch_lanes<T, I, 1, kMode>(a, alpha, scale, stream);
    case 2: return launch_lanes<T, I, 2, kMode>(a, alpha, scale, stream);
    case 4: return launch_lanes<T, I, 4, kMode>(a, alpha, scale, stream);
    case 8: return launch_lanes<T, I, 8, kMode>(a, alpha, scale, stream);
    case 16: return launch_lanes<T, I, 16, kMode>(a, alpha, scale, stream);
    case 32: return launch_lanes<T, I, 32, kMode>(a, alpha, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename I>
cudaError_t launch(const Args& a, double alpha_re, double alpha_im,
                   cudaStream_t stream) {
  if (a.n_items < 0 || a.n_items > 0x7fffffff || a.panel < 1 || a.ny < 0 ||
      a.ny > 0x7fffffff ||
      (a.staged && (a.pitch < a.ny ||
                    static_cast<int64_t>(a.panel) * a.pitch > 0x7fffffff))) {
    return cudaErrorInvalidValue;
  }
  if (a.n_items == 0) return cudaSuccess;
  const T alpha = Arith<T>::make(alpha_re, alpha_im);
  const bool scale = !is_one(alpha_re, alpha_im);
  if (a.staged) {
    return launch_mode<T, I, kStagedLines>(a, alpha, scale, stream);
  }
  if (a.sy == 1) {
    return launch_mode<T, I, kRowsInPlace>(a, alpha, scale, stream);
  }
  if (a.lanes != 32 || a.se != 1) return cudaErrorInvalidValue;
  return launch_lanes<T, I, 32, kColumnsInPlace>(a, alpha, scale, stream);
}

}  // namespace
}  // namespace sdt

extern "C" int sdt_csr_spgemm_sddmm(
    int dtype, int itype, const void* items, int64_t n_items,
    const void* run_ptr, const void* run_q, const void* perm,
    const void* line, const void* d, int64_t se, int64_t sy, int64_t ne,
    int64_t ny, int panel, int pitch, int staged, const void* y_indptr,
    const void* y_indices, const void* y_data, void* out, int lanes,
    double alpha_re, double alpha_im, void* stream) {
  const sdt::Args args{items, n_items, run_ptr, run_q, perm, line,
                       d, se, sy, ne, ny, panel, pitch, staged,
                       y_indptr, y_indices, y_data, out, lanes};
  SDT_DISPATCH(dtype, itype, sdt::launch, args, alpha_re, alpha_im,
               static_cast<cudaStream_t>(stream))
}
