// K9 for a batch whose members share Y's values: a thread block serves a
// group of 2 or 4 members (sampled.cuh, sampled_group_kernel), on the runs
// and staged panels of K9's plan (csr_spgemm_sddmm.cu), the members'
// panels of D side by side in shared memory.  The block walks its work
// item's runs once for the group: each run's row of Y, indices and
// values, is loaded once and summed against the M members' lines, M * E'
// sums a round through one reduce-scatter.  ops/spgemm_grad.py
// (group_plan) chooses the group (a block of kGroupThreads threads, one
// block an SM holding up to 227 KB); a batch whose members have their
// own values of Y, or whose lines are read in place, runs
// csr_spgemm_sddmm.cu's per-member instance.  The wrapper hands Y's rows
// in bank order (bank_order), its values gathered into that order.
// A source of its own, so that nvcc builds these instances beside the
// per-member ones.
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
  int panel, pitch;
  const void* y_indptr;
  const void* y_indices;
  const void* y_data;
  void* out;
  int lanes;
  int64_t batch;
  Strides st;  // y: 0, Y's values shared
  int group;
};

template <typename T, typename I, int L, int M>
cudaError_t launch_group(const Args& a, T alpha, bool scale,
                         cudaStream_t stream) {
  auto kernel = sampled_group_kernel<T, I, L, kStagedLines, M>;
  const size_t panels = a.st.d == 0 ? 1 : M;
  const size_t smem =
      sizeof(T) * panels * static_cast<size_t>(a.panel) * a.pitch;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(static_cast<unsigned>(a.n_items),
                static_cast<unsigned>((a.batch + M - 1) / M)),
           kGroupThreads, smem, stream>>>(
      static_cast<const int64_t*>(a.items), static_cast<const I*>(a.run_ptr),
      static_cast<const I*>(a.run_q), static_cast<const I*>(a.perm),
      static_cast<const I*>(a.line), static_cast<const T*>(a.d), a.se, a.sy,
      a.ne, static_cast<int>(a.ny), a.panel, a.pitch,
      static_cast<const I*>(a.y_indptr), static_cast<const I*>(a.y_indices),
      static_cast<const T*>(a.y_data), static_cast<T*>(a.out), alpha, scale,
      nullptr, nullptr, false, a.st, a.batch);
  return cudaGetLastError();
}

// M = 2 and M = 4, at most the lanes.
template <typename T, typename I, int L>
cudaError_t launch_lanes(const Args& a, T alpha, bool scale,
                         cudaStream_t stream) {
  if constexpr (L >= 2) {
    if (a.group == 2) return launch_group<T, I, L, 2>(a, alpha, scale, stream);
  }
  if constexpr (L >= 4) {
    if (a.group == 4) return launch_group<T, I, L, 4>(a, alpha, scale, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename I>
cudaError_t launch(const Args& a, double alpha_re, double alpha_im,
                   cudaStream_t stream) {
  if (a.n_items < 0 || a.n_items > 0x7fffffff || a.panel < 1 || a.ny < 0 ||
      a.ny > 0x7fffffff || a.batch < 2 || a.batch > kMaxMembers ||
      a.st.d < 0 || a.st.out < 0 || a.pitch < a.ny ||
      static_cast<int64_t>(a.group) * a.panel * a.pitch > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  if (a.n_items == 0) return cudaSuccess;
  const T alpha = Arith<T>::make(alpha_re, alpha_im);
  const bool scale = !is_one(alpha_re, alpha_im);
  switch (a.lanes) {
    case 2: return launch_lanes<T, I, 2>(a, alpha, scale, stream);
    case 4: return launch_lanes<T, I, 4>(a, alpha, scale, stream);
    case 8: return launch_lanes<T, I, 8>(a, alpha, scale, stream);
    case 16: return launch_lanes<T, I, 16>(a, alpha, scale, stream);
    case 32: return launch_lanes<T, I, 32>(a, alpha, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace sdt

// batch members (2 to kMaxMembers), `group` (2 or 4) a block; d and out
// at their member strides in elements (d's 0: shared), y_data shared by
// all members (Y's rows in any order within each row: bank_order's); the
// other arguments as sdt_csr_spgemm_sddmm's with
// its lines staged.
extern "C" int sdt_csr_spgemm_sddmm_group(
    int dtype, int itype, const void* items, int64_t n_items,
    const void* run_ptr, const void* run_q, const void* perm,
    const void* line, const void* d, int64_t se, int64_t sy, int64_t ne,
    int64_t ny, int panel, int pitch, const void* y_indptr,
    const void* y_indices, const void* y_data, void* out, int lanes,
    double alpha_re, double alpha_im, int64_t batch, int64_t s_d,
    int64_t s_out, int group, void* stream) {
  const sdt::Args args{items,     n_items, run_ptr, run_q,   perm,
                       line,      d,       se,      sy,      ne,
                       ny,        panel,   pitch,   y_indptr, y_indices,
                       y_data,    out,     lanes,   batch,
                       sdt::Strides{s_d, 0, s_out}, group};
  SDT_DISPATCH(dtype, itype, sdt::launch, args, alpha_re, alpha_im,
               static_cast<cudaStream_t>(stream))
}
