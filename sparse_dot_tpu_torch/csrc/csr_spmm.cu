// K2: CSR SpMM, C = alpha * A @ B + beta * C0, for CSR A and row-major B.
//
// Replaces the TPU's CSR SpMM family in sparse_dot_tpu/ops/_xla.py
// (ell_spmm_binned :648, ell_spmm :732, coo_spmm :495) and the Pallas
// gather probes of experiments/exp_pallas_gather.py (run_take :43,
// run_loop :65, run_gather :88) and experiments/exp_pallas_ell_small.py
// (ell_spmm_pallas_f32 :35).  The TPU versions repacked CSR into padded,
// length-binned ELL because its gathers want fixed shapes and its scatters
// are slow; this kernel reads CSR as it is, with no repack and no scatter.
//
// Bound: each nonzero does one multiply-add per output column against a
// whole gathered row of B, so at the main path's densities the kernel is
// bound by bytes (A's arrays, the B rows it gathers, C), far below the
// card's FMA rate.  What keeps it from that bound is latency: a gather
// depends on an index load, and narrow n leaves lanes idle.  The design:
//
// - Lane mapping from n and the value type (ops/csr.py, spmm_schedule): a
//   lane reads V adjacent columns in one 16-byte load (V = 4 f32, 2 f64,
//   2 c64, 1 c128) when every row of B, C0 and C is whole 16-byte units
//   and the pointers are 16-byte aligned, else one column; a row takes
//   L lanes, the power of two at or above its loads, at most 32, each lane
//   up to two loads (PER); wider n runs strips on grid.y.  The 32 / L lane
//   groups left in a warp either hold more rows or split a long row's
//   nonzeros P ways (every P-th nonzero each), added with shuffles at the
//   end in a fixed order.  At n = 1 that is a vector CSR SpMV.
// - Loads in flight: a lane takes U of its nonzeros at a time (4 for a
//   row of one lane, else 2), issues their B loads together and loads the
//   next U (index, value) pairs while those are in flight, so no gather
//   waits on an index load.  A row that a whole warp owns (wide n) loads
//   32 pairs at a time, one a lane, and hands them out by shuffles.  More
//   loads a thread measured slower: registers cost warps in flight.
// - Long rows: rows longer than the plan's S nonzeros (formats.csr_plan,
//   cached per matrix) are cut into chunks of S, each done by a group of
//   the first blocks of the launch into a workspace row; the group that
//   finishes a row's last chunk (an integer atomic count per row, in the
//   plan, set back to 0 after use) adds the row's partial rows in chunk
//   order and applies the epilogue.  One launch, and no float atomics: a
//   run gives the same bits twice.  A plan's counts serve one launch at a
//   time, as the port's launches on one stream are.
//
// Every output element is written once, by the group that owns it, with
// the alpha / beta * C0 epilogue fused; rows with no nonzeros store
// beta * C0 or 0.
//
// A batch of members that share A's pattern (torch.func.vmap over the
// values, per-sample gradients, jacrev, jacfwd) is one launch: the member
// is blockIdx.z, and the values, B, C0 and C each have a member stride,
// 0 for an operand that all members share (never copied per member).
// indptr, indices and the row plan are read by every member; the plan's
// counts and the workspace are each member's own (counts + z * n_chunks,
// work + z * n_chunks * n), so the last-chunk test of a split row counts
// that member's chunks only.  A single product is the instance with
// BATCH false, whose code has no member offsets.
//
// Where B is shared (stride 0) and the values are not (vmap over A's
// values: an ensemble, a batched tangent in the values), every member
// gathers the same strips of B, the kernel's dominant traffic (1 GB
// through L2 a member at config 1).  There csr_spmm_group.cu serves M
// members a block from one gather (csr_spmm.cuh, M > 1); the wrapper
// (ops/csr.py, spmm_group) picks M.  The code lives in csr_spmm.cuh;
// this source builds the instances of one member a block.
#include "csr_spmm.cuh"

namespace sdt {
namespace {

// One product (batch 1: BATCH false), or a batch a member a block.
template <typename T, typename I>
struct PerMember {
  template <int V, int PER, int U, bool WARP>
  struct Launch {
    static cudaError_t run(const LaunchArgs<T>& a, cudaStream_t stream) {
      if (a.batch == 1) {
        return launch_mapped<T, I, V, PER, U, WARP, false, 1>(a, stream);
      }
      return launch_mapped<T, I, V, PER, U, WARP, true, 1>(a, stream);
    }
  };
};

template <typename T, typename I>
cudaError_t launch(const void* indptr, const void* indices, const void* data,
                   const void* b, const void* c0, void* c, void* work,
                   void* counts, const void* chunks, int64_t n_chunks,
                   int64_t m, int64_t n, int64_t max_row, int vec, int lanes,
                   int split, int per_lane, double alpha_re, double alpha_im,
                   double beta_re, double beta_im, int64_t batch,
                   int64_t s_data, int64_t s_b, int64_t s_c0, int64_t s_c,
                   cudaStream_t stream) {
  if (!valid_launch(vec, lanes, split, n_chunks, work, counts, batch, s_data,
                    s_b, s_c0, s_c, sizeof(T))) {
    return cudaErrorInvalidValue;
  }
  const LaunchArgs<T> a{indptr, indices, data, b, c0, c, work, counts,
                        chunks, n_chunks, m, n, max_row, lanes, split,
                        Arith<T>::make(alpha_re, alpha_im),
                        Arith<T>::make(beta_re, beta_im),
                        !is_one(alpha_re, alpha_im), batch,
                        Strides{s_data, s_b, s_c0, s_c, batch}};
  return dispatch_mapping<T, PerMember<T, I>::template Launch>(
      vec, per_lane, a, stream);
}

}  // namespace
}  // namespace sdt

// batch members (at most kMaxMembers, grid.z's limit), each operand at
// its member stride in elements (0: shared); batch 1 is one product.
extern "C" int sdt_csr_spmm(int dtype, int itype, const void* indptr,
                            const void* indices, const void* data,
                            const void* b, const void* c0, void* c,
                            void* work, void* counts, const void* chunks,
                            int64_t n_chunks, int64_t m, int64_t n,
                            int64_t max_row, int vec, int lanes, int split,
                            int per_lane, double alpha_re, double alpha_im,
                            double beta_re, double beta_im, int64_t batch,
                            int64_t s_data, int64_t s_b, int64_t s_c0,
                            int64_t s_c, void* stream) {
  SDT_DISPATCH(dtype, itype, sdt::launch, indptr, indices, data, b, c0, c,
               work, counts, chunks, n_chunks, m, n, max_row, vec, lanes,
               split, per_lane, alpha_re, alpha_im, beta_re, beta_im, batch,
               s_data, s_b, s_c0, s_c, static_cast<cudaStream_t>(stream))
}
