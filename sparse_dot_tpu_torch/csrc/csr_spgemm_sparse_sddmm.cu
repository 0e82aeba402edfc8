// K11: the value gradients of a sparse x sparse product with sparse
// output.  For C = op(A) op(B) on its structural pattern (K4 + K5: every
// product a(i, k) b(k, j) has its entry (i, j) in C, each row's columns
// distinct and ascending; only j >= i under `triangular`) and G = dL/dC
// on that pattern, one of two forms for each stored entry p of a CSR P at
// row r, column c (conj only for complex values):
//
//   dA (P = op(A), Y = op(B)):
//     out[p] = sum over (j, v) in row c of Y of G[r, j] conj(v)
//   dB (P = op(B), Y = op(A)^T, `transposed`):
//     out[p] = sum over (i, v) in row r of Y of G[i, c] conj(v)
//
// where G[i, j] is G's value at (i, j) in C's row i.  A product whose
// entry C lacks adds nothing (not 0 conj(v), which an inf or nan in Y
// would turn into nan), and under `triangular` neither does one with
// j < i.  They are dL/d(op(A)'s values) and dL/d(op(B)'s values) as
// PyTorch's convention for complex gradients has them
// (ops/spgemm_grad.py, csr_spgemm_sparse_sddmm).
//
// Replaces XLA's transpose of sparse_dot_tpu/ops/_xla.py esc_spgemm_block
// (:1916) and its back half _esc_sort_compress (:1541): jax.grad of the
// expand-sort-compress product in a_vals and b_data, which runs the sort's
// JVP and the doubling sums backwards, so each product's G is gathered
// through the sort's permutation and scattered onto the operands.
//
// Bound: one multiply-add per product and the lookup of its entry of C;
// the bytes that must move are P's and Y's arrays, C's structure, G and
// the output, each once.  These are K9's sums (csr_spgemm_sddmm.cu) with
// G on C's sparse pattern in place of a dense D, and the design is K9's
// with another loader of G's lines (a line: G's row r in the dA form, its
// column c in the dB form; the other id names the row of Y, q):
//
// - Staged lines (ops/spgemm_grad.py, sparse_plan: where at least 4 lines
//   fit 112 KB) run K9's kernel (sampled.cuh) in its kSparse modes: K9's
//   runs (sampled_runs, built once per P's pattern, never per C), one
//   work item a resident block.  The block marks its panel's elements
//   absent (a nan whose payload no arithmetic makes; a G value of that
//   payload is staged as the canonical nan), then writes G from C's
//   storage (stage_lines): in the dA form the entries of C's rows e0 ..
//   e0 + panel, which lie together, 8 loads in flight a thread, scattered
//   at their column ids; in the dB form each row i of C searched once for
//   the panel's first column, then read a lane an entry, so no transposed
//   copy of C or G.  A group of L lanes serves a run as K9 does: the row
//   of Y loaded once, the run's entries summed in rounds of kRound with
//   one reduce-scatter, each product added only where its element is
//   present.
// - Lines in place (longer lines, as the 1M^2 A @ A's): a group of L
//   lanes takes a row of P, 256 / L rows a block, so short rows share a
//   warp, and no shared memory bounds how many an SM holds.  dA: the
//   row's products all land in C's row r, searched where it lies, a
//   binary search a product (its few lines stay in L1; staging the row in
//   shared memory first took 1.5x as long at the 1M^2 A @ A, where a row
//   of C holds 4 entries).  dB: the row's entries in rounds of kRound
//   share the group's row of Y, so the lane holding Y's entry i reads row
//   i of C's bounds once and searches it for the round's columns at once
//   (count_below).  Positions in a row of C take C's id type (32 bits
//   where C's ids are: fewer registers, more threads an SM).
//
// Every output is written by one lane, in a fixed order, with no atomics:
// the same inputs give the same bits twice.
//
// A batch of members that share op(A)'s, op(B)'s and C's patterns (the
// backward of a vmap over the values, jacrev's cotangents, a batch of
// tangents) is one launch in either mode: Y's values, G's values and the
// output each have a member stride, 0 for an operand that all members
// share; blockIdx.y is the member.  Where the members share Y's values
// and the lines are staged, csr_spgemm_sparse_sddmm_group.cu launches a
// group of 2 or 4 members a block instead.  The runs are P's, shared.  A
// single product is the instance with BATCH false, whose code has no
// member offsets.
#include "sampled.cuh"

namespace sdt {
namespace {

// Threads a block of the in-place kernel; the staged lines run
// sampled.cuh's kernel, K9's.
constexpr int kInPlaceThreads = 256;

// Position of `col` among the ascending cols[0, len), or -1.
template <typename I>
__device__ __forceinline__ I find_column(const I* __restrict__ cols, I len,
                                         I col) {
  I lo = 0, hi = len;
  while (lo < hi) {
    const I mid = (lo + hi) >> 1;
    if (cols[mid] < col) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < len && cols[lo] == col ? lo : I(-1);
}

// Lines in place: a group of L lanes a row r of P.  With BATCH,
// blockIdx.y is the member (st.d: G's stride).
template <typename T, typename I, int L, bool kTransposed, bool BATCH>
__global__ void __launch_bounds__(kInPlaceThreads)
sparse_in_place_kernel(const I* __restrict__ p_indptr,
                       const I* __restrict__ p_indices, int64_t p_rows,
                       const I* __restrict__ y_indptr,
                       const I* __restrict__ y_indices,
                       const T* __restrict__ y_data,
                       const I* __restrict__ c_indptr,
                       const I* __restrict__ c_indices,
                       const T* __restrict__ g, T* __restrict__ out,
                       bool triangular, const Strides st) {
  using A = Arith<T>;
  if constexpr (BATCH) {
    const int64_t z = blockIdx.y;
    y_data += z * st.y;
    g += z * st.d;
    out += z * st.out;
  }
  constexpr int G = kInPlaceThreads / L;
  const int lane = static_cast<int>(threadIdx.x) % L;
  const unsigned members =
      L == 32 ? kFullMask
              : ((1u << L) - 1u) << ((threadIdx.x & 31) & ~(L - 1));
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * G + static_cast<int>(threadIdx.x) / L;
  if (r >= p_rows) return;  // the whole group: it shares r
  const int64_t p0 = static_cast<int64_t>(p_indptr[r]);
  const int64_t p1 = static_cast<int64_t>(p_indptr[r + 1]);

  if constexpr (!kTransposed) {
    // Every product of the row lands in C's row r, searched where it lies
    // (through L1: its few lines stay there while the group works).
    const int64_t c0 = static_cast<int64_t>(c_indptr[r]);
    const I c_len = c_indptr[r + 1] - c_indptr[r];
    const I* __restrict__ cols = c_indices + c0;
    const T* __restrict__ gv = g + c0;
    for (int64_t p = p0; p < p1; ++p) {
      const int64_t q = static_cast<int64_t>(p_indices[p]);
      const int64_t t1 = static_cast<int64_t>(y_indptr[q + 1]);
      T acc = A::zero();
      for (int64_t t = static_cast<int64_t>(y_indptr[q]) + lane; t < t1;
           t += L) {
        const I j = y_indices[t];
        if (triangular && j < r) continue;
        const I at = find_column(cols, c_len, j);
        if (at >= 0) acc = A::fma(gv[at], conj_of(y_data[t]), acc);
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) {
        acc = A::add(acc, A::shfl_xor(acc, off, members));
      }
      if (lane == 0) out[p] = acc;
    }
  } else {
    const int64_t t0 = static_cast<int64_t>(y_indptr[r]);
    const int64_t t1 = static_cast<int64_t>(y_indptr[r + 1]);
    for (int64_t pb = p0; pb < p1; pb += kRound) {
      // A round: the columns of up to kRound entries (-1 past the row),
      // in C's id type, as are positions in a row of C.
      I col[kRound];
      T acc[kRound];
#pragma unroll
      for (int e = 0; e < kRound; ++e) {
        col[e] = pb + e < p1 ? p_indices[pb + e] : I(-1);
        acc[e] = A::zero();
      }
      for (int64_t t = t0 + lane; t < t1; t += L) {
        const int64_t i = static_cast<int64_t>(y_indices[t]);
        const T v = conj_of(y_data[t]);
        const int64_t c0 = static_cast<int64_t>(c_indptr[i]);
        const I len = c_indptr[i + 1] - c_indptr[i];
        const I* __restrict__ cols = c_indices + c0;
        // Row i searched for the round's columns at once.
        I at[kRound];
        count_below<kRound>(cols, len, col, at);
#pragma unroll
        for (int e = 0; e < kRound; ++e) {
          if (col[e] >= 0 && !(triangular && col[e] < i) && at[e] < len &&
              cols[at[e]] == col[e]) {
            acc[e] = A::fma(g[c0 + at[e]], v, acc[e]);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < kRound; ++e) {
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1) {
          acc[e] = A::add(acc[e], A::shfl_xor(acc[e], off, members));
        }
        if (lane == 0 && pb + e < p1) out[pb + e] = acc[e];
      }
    }
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
  int64_t ne, ny;
  int panel, pitch, staged;
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
  int transposed, triangular, lanes;
  int64_t batch;
  Strides st;  // d: G's values
};

template <typename T, typename I, int L, bool kTransposed, bool BATCH>
cudaError_t launch_members(const Args& a, cudaStream_t stream) {
  const unsigned members = static_cast<unsigned>(a.batch);
  if (a.staged) {
    auto kernel = sampled_kernel<T, I, L,
                                 kTransposed ? kSparseColumns : kSparseRows,
                                 BATCH>;
    // Beside the panel, the kernel's own row bounds (kMaxPanel + 1).
    const size_t smem = sizeof(T) * static_cast<size_t>(a.panel) * a.pitch;
    if (smem + sizeof(int64_t) * (kMaxPanel + 1) > 227 * 1024) {
      return cudaErrorInvalidValue;
    }
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    kernel<<<dim3(static_cast<unsigned>(a.n_items), members), kThreads,
             smem, stream>>>(
        static_cast<const int64_t*>(a.items),
        static_cast<const I*>(a.run_ptr), static_cast<const I*>(a.run_q),
        static_cast<const I*>(a.perm), static_cast<const I*>(a.line),
        static_cast<const T*>(a.g), 0, 0, a.ne, static_cast<int>(a.ny),
        a.panel, a.pitch, static_cast<const I*>(a.y_indptr),
        static_cast<const I*>(a.y_indices), static_cast<const T*>(a.y_data),
        static_cast<T*>(a.out), Arith<T>::make(0.0, 0.0), false,
        static_cast<const I*>(a.c_indptr), static_cast<const I*>(a.c_indices),
        a.triangular != 0, a.st);
    return cudaGetLastError();
  }
  constexpr int G = kInPlaceThreads / L;
  const int64_t blocks = (a.p_rows + G - 1) / G;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  sparse_in_place_kernel<T, I, L, kTransposed, BATCH>
      <<<dim3(static_cast<unsigned>(blocks), members), kInPlaceThreads, 0,
         stream>>>(
      static_cast<const I*>(a.p_indptr), static_cast<const I*>(a.p_indices),
      a.p_rows, static_cast<const I*>(a.y_indptr),
      static_cast<const I*>(a.y_indices), static_cast<const T*>(a.y_data),
      static_cast<const I*>(a.c_indptr), static_cast<const I*>(a.c_indices),
      static_cast<const T*>(a.g), static_cast<T*>(a.out), a.triangular != 0,
      a.st);
  return cudaGetLastError();
}

// The instance for one member (BATCH false) or for a batch.
template <typename T, typename I, int L, bool kTransposed>
cudaError_t launch_lanes(const Args& a, cudaStream_t stream) {
  if (a.batch == 1) {
    return launch_members<T, I, L, kTransposed, false>(a, stream);
  }
  return launch_members<T, I, L, kTransposed, true>(a, stream);
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
  if (a.batch < 1 || a.batch > kMaxMembers || a.st.d < 0 || a.st.y < 0 ||
      a.st.out < 0) {
    return cudaErrorInvalidValue;
  }
  if (a.staged) {
    if (a.n_items < 0 || a.n_items > 0x7fffffff || a.panel < 1 ||
        a.panel > kMaxPanel ||
        a.ny < 0 || a.ny > 0x7fffffff || a.pitch < a.ny ||
        static_cast<int64_t>(a.panel) * a.pitch > 0x7fffffff) {
      return cudaErrorInvalidValue;
    }
    if (a.n_items == 0) return cudaSuccess;
  } else {
    if (a.p_rows < 0) return cudaErrorInvalidValue;
    if (a.p_rows == 0) return cudaSuccess;
  }
  return a.transposed ? launch_form<T, I, true>(a, stream)
                      : launch_form<T, I, false>(a, stream);
}

}  // namespace
}  // namespace sdt

// batch members (at most kMaxMembers, grid.y's limit), y_data, g and out
// at their member strides in elements (0: shared); batch 1 is one
// product.
extern "C" int sdt_csr_spgemm_sparse_sddmm(
    int dtype, int itype, const void* items, int64_t n_items,
    const void* run_ptr, const void* run_q, const void* perm,
    const void* line, int64_t ne, int64_t ny, int panel, int pitch,
    int staged, const void* p_indptr, const void* p_indices, int64_t p_rows,
    const void* y_indptr, const void* y_indices, const void* y_data,
    const void* c_indptr, const void* c_indices, const void* g, void* out,
    int transposed, int triangular, int lanes, int64_t batch, int64_t s_y,
    int64_t s_g, int64_t s_out, void* stream) {
  const sdt::Args args{items,     n_items,   run_ptr,   run_q,  perm,
                       line,      ne,        ny,        panel,  pitch,
                       staged,    p_indptr,  p_indices, p_rows, y_indptr,
                       y_indices, y_data,    c_indptr,  c_indices, g,
                       out,       transposed, triangular, lanes, batch,
                       sdt::Strides{s_g, s_y, s_out}};
  SDT_DISPATCH(dtype, itype, sdt::launch, args,
               static_cast<cudaStream_t>(stream))
}
