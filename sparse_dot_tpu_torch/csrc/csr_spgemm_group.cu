// K5 for a batch of fills whose members share op(A)'s and op(B)'s
// patterns, M members (2 or 4) a block: blockIdx.y is a group of M
// consecutive members, and every thread does the row's structural work
// once for the group (csr_spgemm.cuh with M > 1).  In the register bins,
// where a random 1M x 1M A @ A puts almost every row (about 4 products
// each), that work is nearly all of a row's time: the row id, op(A)'s
// indptr and entries, op(B)'s indptr, the scan and binary search,
// op(B)'s column ids, the bitonic sort and the head ballot, a chain of
// dependent loads and shuffles that the per-member instance repeats for
// each member.  Only each member's a_data / b_data loads, its shuffles,
// its fold (in the same product order) and its stores are done M times.
// The sorted-product bins stage each product's entries and sort its key
// once for the group, and each member's fold reads its own values through
// them (the region does not grow with M).  The hash-block and
// dense-shared bins give the keys (or flags) one table and the values M
// slots each, where the plan's shared memory holds that.
// Each member's values equal its single fill's bits.  The wrapper
// (ops/spgemm.py, fill_groups) chooses M for each bin before the launch,
// by value type, index width and shared memory, and launches each M's
// bins on their own (other bins marked kSkip); a bin of one member a
// block (M = 1, the dense rows in the device workspace among them) runs
// csr_spgemm.cu's per-member instance.  A source of its own, so that
// nvcc builds these instances beside the per-member ones.
#include "csr_spgemm.cuh"

namespace sdt {
namespace {

template <typename T, typename I>
cudaError_t fill_group(const void* a_indptr, const void* a_indices,
                       const void* a_data, const void* b_indptr,
                       const void* b_indices, const void* b_data,
                       const void* rows, const void* offsets,
                       const int64_t* bins, int nbins, int64_t n,
                       int triangular, const void* c_indptr, void* c_indices,
                       void* c_data, int64_t batch, int64_t s_a, int64_t s_b,
                       int64_t s_c, int write_indices, int group,
                       cudaStream_t stream) {
  if (batch < 1 || batch > kMaxMembers || s_a < 0 || s_b < 0 || s_c < 0) {
    return cudaErrorInvalidValue;
  }
  const Args<T, I> args = fill_args<T, I>(
      a_indptr, a_indices, a_data, b_indptr, b_indices, b_data, rows,
      offsets, n, triangular, c_indptr, c_indices, c_data);
  const Batch members{batch,
                      Members{s_a, s_b, s_c, write_indices != 0, batch}};
  if (group == 2) {
    return launch_bins<T, I, true, true, 2>(args, bins, nbins, nullptr, 0,
                                            members, stream);
  }
  if (group == 4) {
    return launch_bins<T, I, true, true, 4>(args, bins, nbins, nullptr, 0,
                                            members, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace sdt

// batch members (at most kMaxMembers, grid.y's limit) in groups of
// `group` (2 or 4) a block, op(A)'s, op(B)'s and C's values at their
// member strides in elements (0: shared); write_indices: member 0 writes
// C's column ids.  No bin may be kDenseGlobal.
extern "C" int sdt_csr_spgemm_fill_group(
    int dtype, int itype, const void* a_indptr, const void* a_indices,
    const void* a_data, const void* b_indptr, const void* b_indices,
    const void* b_data, const void* rows, const void* offsets,
    const void* bins, int nbins, int64_t n, int triangular,
    const void* c_indptr, void* c_indices, void* c_data, int64_t batch,
    int64_t s_a, int64_t s_b, int64_t s_c, int write_indices, int group,
    void* stream) {
  SDT_DISPATCH(dtype, itype, sdt::fill_group, a_indptr, a_indices, a_data,
               b_indptr, b_indices, b_data, rows, offsets,
               static_cast<const int64_t*>(bins), nbins, n, triangular,
               c_indptr, c_indices, c_data, batch, s_a, s_b, s_c,
               write_indices, group, static_cast<cudaStream_t>(stream))
}
