// The block-sorted bins' instances (csr_spgemm_block.cuh) of K4 and of a
// single K5 fill, which csr_spgemm.cu's launch_bins launches through
// launch_block_count and launch_block_fill: a source of their own, so
// that nvcc builds them beside csr_spgemm.cu's other bins.
#include "csr_spgemm_block.cuh"

namespace sdt {
namespace {

template <typename T, typename I>
cudaError_t fill_block(const BlockLaunch& launch) {
  return run_block<T, I, true, false, 1>(launch);
}

}  // namespace

cudaError_t launch_block_count(const BlockLaunch& launch) {
  switch (launch.itype) {
    case kI32:
      return run_block<float, int32_t, false, false, 1>(launch);
    case kI64:
      return run_block<float, int64_t, false, false, 1>(launch);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_block_fill(const BlockLaunch& launch) {
  SDT_DISPATCH(launch.dtype, launch.itype, fill_block, launch)
}

}  // namespace sdt
