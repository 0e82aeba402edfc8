// K1's tensor-core pieces shared by bsr_spmm.cu (one product, and a batch
// a member a block) and bsr_spmm_group.cu (a batch whose members share B,
// M members a block): the tile shapes, the member strides, the kernel
// that adds the partial tiles of split block rows, and the launch of
// that kernel.  The notes at the top of bsr_spmm.cu say what K1 computes
// and how.
#pragma once

#include <type_traits>

#include "mma.cuh"

namespace sdt {
namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBN = 64;        // columns of B per thread block
constexpr int kStages = 3;     // depth of the cp.async ring

// Member strides, in elements, of a batched launch (0: shared), and the
// elements of one member's workspace.
struct Strides {
  int64_t data, b, c0, c, work;
};

// Moves C0, C and the workspace to member blockIdx.z of a batch (BATCH).
#define SDT_K1_TO_MEMBER                        \
  if constexpr (BATCH) {                        \
    const int64_t z = blockIdx.z;               \
    if (c0 != nullptr) c0 += z * st.c0;         \
    c += z * st.c;                              \
    if (work != nullptr) work += z * st.work;   \
  }

// Tile shape for element type T and thread-block height BM (16, 32, 64 or
// 128 rows; complex 16 or 32).  The inner chunk is 128 bytes of a row of
// A (BK elements; 16 complex elements); the shared-memory pitches are
// padded so that the fragment loads below hit distinct banks in each
// phase of a warp's load (32 lanes of 4 bytes, 16 of 8, 8 of 16).
template <typename T, int BM>
struct Tile {
  static constexpr int kBK0 =
      IsComplex<T>::value ? 16 : 128 / static_cast<int>(sizeof(T));
  static constexpr int BK = kBK0 < BM ? kBK0 : BM;
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // per 16 B
  static constexpr int kWarpsM = BM >= 64 ? 4 : BM / 16;
  static constexpr int kWarpsN = 8 / kWarpsM;
  static constexpr int WM = BM / kWarpsM;  // rows per warp
  static constexpr int WN = kBN / kWarpsN;  // columns per warp
  static constexpr int MT = WM / 16;        // m16 tiles per warp
  static constexpr int NT = WN / 8;         // n8 tiles per warp
  static constexpr int kAPitch = BK + 4;
  static constexpr int kBPitch = kBN + 32 / static_cast<int>(sizeof(T));
  static constexpr int kAStage = BM * kAPitch;
  static constexpr int kBStage = BK * kBPitch;
  static constexpr size_t kSmem = sizeof(T) * kStages * (kAStage + kBStage);
};

// splits: (n_splits, 3) int64 rows of (block row, first workspace slot,
// number of chunks); rows with block row -1 are padding.  Sums the
// partial tiles of each split block row in chunk order and writes C.
// With BATCH, blockIdx.z is the member.
template <typename T, bool BATCH>
__global__ void __launch_bounds__(kThreads)
bsr_reduce_kernel(const int64_t* __restrict__ splits,
                  const T* __restrict__ work, const T* __restrict__ c0,
                  T* __restrict__ c, int64_t tile, T alpha, T beta,
                  bool scale, Strides st) {
  SDT_K1_TO_MEMBER
  const int64_t brow = splits[blockIdx.x * 3];
  if (brow < 0) return;
  const T* part = work + splits[blockIdx.x * 3 + 1] * tile;
  const int64_t nch = splits[blockIdx.x * 3 + 2];
  for (int64_t e = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
       e < tile; e += static_cast<int64_t>(gridDim.y) * kThreads) {
    T acc = part[e];
    for (int64_t j = 1; j < nch; ++j) acc += part[j * tile + e];
    const int64_t idx = brow * tile + e;
    c[idx] = epilogue(acc, c0, idx, alpha, beta, scale);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Launches bsr_reduce_kernel for the n_splits split block rows of each of
// `batch` members (none: nothing to do).
template <typename T>
cudaError_t launch_reduce(const void* splits, int64_t n_splits,
                          const void* work, const void* c0, void* c,
                          int64_t bs, int64_t n, T alpha, T beta, bool scale,
                          int64_t batch, const Strides& st,
                          cudaStream_t stream) {
  if (n_splits == 0) return cudaSuccess;
  const int64_t tile = bs * n;
  const int64_t per_split = (tile + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(n_splits),
                  static_cast<unsigned>(per_split < 1024 ? per_split : 1024),
                  static_cast<unsigned>(batch));
  auto reduce =
      batch == 1 ? bsr_reduce_kernel<T, false> : bsr_reduce_kernel<T, true>;
  reduce<<<grid, kThreads, 0, stream>>>(
      static_cast<const int64_t*>(splits), static_cast<const T*>(work),
      static_cast<const T*>(c0), static_cast<T*>(c), tile, alpha, beta,
      scale, st);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdt
