// K11 for a batch whose members share Y's values, where its plan stages
// lines of G: a thread block serves a group of 2 or 4 members (sampled.cuh,
// sampled_group_kernel in its kSparse modes), the members' panels of G
// staged side by side from C's storage (C's row bounds, or each row of C's
// first column in the panel, found once for the group), the runs walked and
// each row of Y loaded once for the group.  ops/spgemm_grad.py
// (group_plan) chooses the group (a block of kGroupThreads threads, one
// block an SM); other batches run csr_spgemm_sparse_sddmm.cu's
// per-member instances.  The wrapper hands Y's rows in bank order
// (bank_order), its values gathered into that order.  A source of its own,
// so that nvcc builds these instances beside the per-member ones.
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
  int64_t ne, ny;
  int panel, pitch;
  const void* y_indptr;
  const void* y_indices;
  const void* y_data;
  const void* c_indptr;
  const void* c_indices;
  const void* g;
  void* out;
  int transposed, triangular, lanes;
  int64_t batch;
  Strides st;  // d: G's values; y: 0, Y's values shared
  int group;
};

template <typename T, typename I, int L, bool kTransposed, int M>
cudaError_t launch_group(const Args& a, cudaStream_t stream) {
  auto kernel = sampled_group_kernel<
      T, I, L, kTransposed ? kSparseColumns : kSparseRows, M>;
  const size_t panels = a.st.d == 0 ? 1 : M;
  const size_t smem =
      sizeof(T) * panels * static_cast<size_t>(a.panel) * a.pitch;
  // Beside the panels, the kernel's own row bounds (kMaxPanel + 1).
  if (smem + sizeof(int64_t) * (kMaxPanel + 1) > 227 * 1024) {
    return cudaErrorInvalidValue;
  }
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
      static_cast<const I*>(a.line), static_cast<const T*>(a.g), 0, 0, a.ne,
      static_cast<int>(a.ny), a.panel, a.pitch,
      static_cast<const I*>(a.y_indptr), static_cast<const I*>(a.y_indices),
      static_cast<const T*>(a.y_data), static_cast<T*>(a.out),
      Arith<T>::make(0.0, 0.0), false, static_cast<const I*>(a.c_indptr),
      static_cast<const I*>(a.c_indices), a.triangular != 0, a.st, a.batch);
  return cudaGetLastError();
}

// M = 2 and M = 4, at most the lanes.
template <typename T, typename I, int L, bool kTransposed>
cudaError_t launch_lanes(const Args& a, cudaStream_t stream) {
  if constexpr (L >= 2) {
    if (a.group == 2) return launch_group<T, I, L, kTransposed, 2>(a, stream);
  }
  if constexpr (L >= 4) {
    if (a.group == 4) return launch_group<T, I, L, kTransposed, 4>(a, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename I, bool kTransposed>
cudaError_t launch_form(const Args& a, cudaStream_t stream) {
  switch (a.lanes) {
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
  if (a.n_items < 0 || a.n_items > 0x7fffffff || a.panel < 1 ||
      a.panel > kMaxPanel || a.ny < 0 || a.ny > 0x7fffffff ||
      a.pitch < a.ny || a.batch < 2 || a.batch > kMaxMembers ||
      a.st.d < 0 || a.st.out < 0 ||
      static_cast<int64_t>(a.group) * a.panel * a.pitch > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  if (a.n_items == 0) return cudaSuccess;
  return a.transposed ? launch_form<T, I, true>(a, stream)
                      : launch_form<T, I, false>(a, stream);
}

}  // namespace
}  // namespace sdt

// batch members (2 to kMaxMembers), `group` (2 or 4) a block; g and out
// at their member strides in elements (g's 0: shared), y_data shared by
// all members (Y's rows in any order within each row: bank_order's); the
// other arguments as
// sdt_csr_spgemm_sparse_sddmm's with its lines staged.
extern "C" int sdt_csr_spgemm_sparse_sddmm_group(
    int dtype, int itype, const void* items, int64_t n_items,
    const void* run_ptr, const void* run_q, const void* perm,
    const void* line, int64_t ne, int64_t ny, int panel, int pitch,
    const void* y_indptr, const void* y_indices, const void* y_data,
    const void* c_indptr, const void* c_indices, const void* g, void* out,
    int transposed, int triangular, int lanes, int64_t batch, int64_t s_g,
    int64_t s_out, int group, void* stream) {
  const sdt::Args args{items,    n_items,   run_ptr, run_q,    perm,
                       line,     ne,        ny,      panel,    pitch,
                       y_indptr, y_indices, y_data,  c_indptr, c_indices,
                       g,        out,       transposed, triangular, lanes,
                       batch,    sdt::Strides{s_g, 0, s_out}, group};
  SDT_DISPATCH(dtype, itype, sdt::launch, args,
               static_cast<cudaStream_t>(stream))
}
