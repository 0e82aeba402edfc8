// The block-sorted bins' instances (csr_spgemm_block.cuh) of a batched
// K5 fill, 4 members a block, which csr_spgemm_group.cu's launch_bins
// launches through launch_block_group4: a source of their own, so that
// nvcc builds them beside the other member groups'.
#include "csr_spgemm_block.cuh"

namespace sdt {
namespace {

template <typename T, typename I>
cudaError_t group_block(const BlockLaunch& launch) {
  return run_block<T, I, true, true, 4>(launch);
}

}  // namespace

cudaError_t launch_block_group4(const BlockLaunch& launch) {
  SDT_DISPATCH(launch.dtype, launch.itype, group_block, launch)
}

}  // namespace sdt
