// The block-sorted bins' instances (csr_spgemm_block.cuh) of a batched
// K5 fill, a member a block, which csr_spgemm.cu's launch_bins launches
// through launch_block_batched: a source of their own, so that nvcc
// builds them beside the single fill's.
#include "csr_spgemm_block.cuh"

namespace sdt {
namespace {

template <typename T, typename I>
cudaError_t batched_block(const BlockLaunch& launch) {
  return run_block<T, I, true, true, 1>(launch);
}

}  // namespace

cudaError_t launch_block_batched(const BlockLaunch& launch) {
  SDT_DISPATCH(launch.dtype, launch.itype, batched_block, launch)
}

}  // namespace sdt
