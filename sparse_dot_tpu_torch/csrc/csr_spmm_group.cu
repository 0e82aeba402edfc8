// K2 for a batch whose members share B (stride 0) and not their values:
// blockIdx.z is a group of M consecutive members (2 or 4), and each lane
// loads an entry's index and its strip of B once for the group, the M
// members' values at their stride, and keeps M sums (csr_spmm.cuh with
// M > 1).  The lane mapping, the U-ahead pairs, the split of long rows
// (each member's own workspace rows, added in chunk order) and the
// alpha / beta * C0 epilogue (C0 per member or shared) are the single
// kernel's, so each member's output has its single launch's bits.  The
// strips of B are the kernel's dominant traffic, through L2: the group
// gathers them once for M members where the per-member instance
// (csr_spmm.cu) gathers them M times.  The wrapper (ops/csr.py,
// spmm_group) picks M by the lanes, the loads a lane, the value type
// and the index width; a batch with B per member, or with the values
// shared, runs the per-member instance.  A source of its own, so that
// nvcc builds these instances beside the per-member ones.
#include "csr_spmm.cuh"

namespace sdt {
namespace {

template <typename T, typename I, int M>
struct Group {
  template <int V, int PER, int U, bool WARP>
  struct Launch {
    static cudaError_t run(const LaunchArgs<T>& a, cudaStream_t stream) {
      return launch_mapped<T, I, V, PER, U, WARP, true, M>(a, stream);
    }
  };
};

template <typename T, typename I>
cudaError_t launch_group(const void* indptr, const void* indices,
                         const void* data, const void* b, const void* c0,
                         void* c, void* work, void* counts,
                         const void* chunks, int64_t n_chunks, int64_t m,
                         int64_t n, int64_t max_row, int vec, int lanes,
                         int split, int per_lane, double alpha_re,
                         double alpha_im, double beta_re, double beta_im,
                         int64_t batch, int64_t s_data, int64_t s_c0,
                         int64_t s_c, int group, cudaStream_t stream) {
  if (!valid_launch(vec, lanes, split, n_chunks, work, counts, batch, s_data,
                    0, s_c0, s_c, sizeof(T))) {
    return cudaErrorInvalidValue;
  }
  const LaunchArgs<T> a{indptr, indices, data, b, c0, c, work, counts,
                        chunks, n_chunks, m, n, max_row, lanes, split,
                        Arith<T>::make(alpha_re, alpha_im),
                        Arith<T>::make(beta_re, beta_im),
                        !is_one(alpha_re, alpha_im), batch,
                        Strides{s_data, 0, s_c0, s_c, batch}};
  if (group == 2) {
    return dispatch_mapping<T, Group<T, I, 2>::template Launch>(
        vec, per_lane, a, stream);
  }
  if (group == 4) {
    return dispatch_mapping<T, Group<T, I, 4>::template Launch>(
        vec, per_lane, a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace sdt

// batch members (at most kMaxMembers) sharing b, `group` (2 or 4) of them
// a block, the values, c0 and c at their member strides in elements
// (c0's 0: shared).
extern "C" int sdt_csr_spmm_group(int dtype, int itype, const void* indptr,
                                  const void* indices, const void* data,
                                  const void* b, const void* c0, void* c,
                                  void* work, void* counts,
                                  const void* chunks, int64_t n_chunks,
                                  int64_t m, int64_t n, int64_t max_row,
                                  int vec, int lanes, int split,
                                  int per_lane, double alpha_re,
                                  double alpha_im, double beta_re,
                                  double beta_im, int64_t batch,
                                  int64_t s_data, int64_t s_c0, int64_t s_c,
                                  int group, void* stream) {
  SDT_DISPATCH(dtype, itype, sdt::launch_group, indptr, indices, data, b, c0,
               c, work, counts, chunks, n_chunks, m, n, max_row, vec, lanes,
               split, per_lane, alpha_re, alpha_im, beta_re, beta_im, batch,
               s_data, s_c0, s_c, group, static_cast<cudaStream_t>(stream))
}
