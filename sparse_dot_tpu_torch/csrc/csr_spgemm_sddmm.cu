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
//
// The kernel itself is in sampled.cuh, which K11
// (csr_spgemm_sparse_sddmm.cu) shares for the lines it stages from a
// sparse G; this file launches K9's modes.  A batch of members that share
// P and Y's pattern is one launch there (D, Y's values and the output at
// member strides), one member a block (blockIdx.y); where the members
// share Y's values and the lines are staged, csr_spgemm_sddmm_group.cu
// launches a group of 2 or 4 members a block instead.  The wrapper sizes
// the work items over the member groups (ops/spgemm_grad.py, group_plan,
// sampled_batched).
#include "sampled.cuh"

namespace sdt {
namespace {

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
  int64_t batch;
  Strides st;
};

template <typename T, typename I, int L, int kMode, bool BATCH>
cudaError_t launch_members(const Args& a, T alpha, bool scale,
                           cudaStream_t stream) {
  auto kernel = sampled_kernel<T, I, L, kMode, BATCH>;
  const size_t smem = kMode == kStagedLines
                          ? sizeof(T) * static_cast<size_t>(a.panel) * a.pitch
                          : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(static_cast<unsigned>(a.n_items),
                static_cast<unsigned>(a.batch)),
           kThreads, smem, stream>>>(
      static_cast<const int64_t*>(a.items), static_cast<const I*>(a.run_ptr),
      static_cast<const I*>(a.run_q), static_cast<const I*>(a.perm),
      static_cast<const I*>(a.line), static_cast<const T*>(a.d), a.se, a.sy,
      a.ne, static_cast<int>(a.ny), a.panel, a.pitch,
      static_cast<const I*>(a.y_indptr), static_cast<const I*>(a.y_indices),
      static_cast<const T*>(a.y_data), static_cast<T*>(a.out), alpha, scale,
      nullptr, nullptr, false, a.st);
  return cudaGetLastError();
}

// The instance for one member (BATCH false) or for a batch.
template <typename T, typename I, int L, int kMode>
cudaError_t launch_lanes(const Args& a, T alpha, bool scale,
                         cudaStream_t stream) {
  if (a.batch == 1) {
    return launch_members<T, I, L, kMode, false>(a, alpha, scale, stream);
  }
  return launch_members<T, I, L, kMode, true>(a, alpha, scale, stream);
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
      a.ny > 0x7fffffff || a.batch < 1 || a.batch > kMaxMembers ||
      a.st.d < 0 || a.st.y < 0 || a.st.out < 0 ||
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

// batch members (at most kMaxMembers, grid.y's limit), d, y_data and out
// at their member strides in elements (0: shared); batch 1 is one
// product.
extern "C" int sdt_csr_spgemm_sddmm(
    int dtype, int itype, const void* items, int64_t n_items,
    const void* run_ptr, const void* run_q, const void* perm,
    const void* line, const void* d, int64_t se, int64_t sy, int64_t ne,
    int64_t ny, int panel, int pitch, int staged, const void* y_indptr,
    const void* y_indices, const void* y_data, void* out, int lanes,
    double alpha_re, double alpha_im, int64_t batch, int64_t s_d,
    int64_t s_y, int64_t s_out, void* stream) {
  const sdt::Args args{items,    n_items,   run_ptr, run_q, perm,
                       line,     d,         se,      sy,    ne,
                       ny,       panel,     pitch,   staged, y_indptr,
                       y_indices, y_data,   out,     lanes, batch,
                       sdt::Strides{s_d, s_y, s_out}};
  SDT_DISPATCH(dtype, itype, sdt::launch, args, alpha_re, alpha_im,
               static_cast<cudaStream_t>(stream))
}
