// K13: masked compaction, the CSR of a dense C (r x n, row-major) at the
// positions where a structural count P (r x n, bf16, row-major) is > 0, and
// with `triangular` only at columns j >= row0 + i.  Each row's columns come
// in ascending order and every position of the mask is stored, exact zeros
// of C included (an entry whose products cancel), as K5 writes a
// sparse-output product.
//
// Replaces sparse_dot_tpu/ops/_xla.py extract_structure (:1301) and
// extract_sparse_masked (:1460), the last step of spgemm_structural_extract
// (:1495): there a prefix sum over the flattened mask gives each stored
// position its slot, and scatters place the columns and values.  Here the
// prefix sum runs over rows (torch.cumsum of this file's row counts, on the
// device, in ops/compact.py) and each warp finds its slots within a row by
// itself, so no (r * n)-long prefix or scatter index is ever written.
//
// Two launches around the running sum, with no host read between them:
// - compact_count_kernel: a warp a row.  Each lane reads kGroup = 8
//   consecutive bf16 of P (one 16-byte load where the row allows it, else
//   eight scalar ones), makes an 8-bit mask of the positives, and adds its
//   popcount; a warp covers 256 columns a step, and with `triangular` starts
//   at the group that holds column row0 + i.  The lanes' counts are summed
//   by shuffles into the row's count, written to starts[i + 1] (and 0 to
//   starts[0]); ops/compact.py turns them into the rows' starts with
//   torch.cumsum on the device.
// - compact_fill_kernel: a warp a row again, 32 consecutive columns at a
//   time, lane l on column j0 + l, so that the loads of P and of C and the
//   stores of the entries are coalesced: a __ballot_sync of the lanes'
//   P > 0 gives the 32 columns' mask, each lane's slot is the row's start
//   plus the entries before in the row plus the popcount of the mask's
//   lower lanes, and a step of 256 columns loads its 8 values of P a lane
//   before it ballots them.  It writes the row's start to indptr too.  The
//   wrapper sizes indices and data for every position of the (triangle of
//   the) r x n area, since the total is read on the host only after this
//   launch (with the route's finite flags, in one copy).
//
#include "common.cuh"

namespace sdt {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Columns of P a lane reads at once (16 bytes of bf16) and a warp a step.
constexpr int kGroup = 8;
constexpr int64_t kStep = 32 * kGroup;

// A bf16 is > 0 where its sign bit is clear and its other bits are not all
// zero: as a signed 16-bit integer, > 0.
__device__ __forceinline__ unsigned positive(uint32_t half_bits) {
  return static_cast<int16_t>(half_bits & 0xffffu) > 0 ? 1u : 0u;
}

// Bit b set where P[row][j + b] > 0 and j + b lies in [lo, n).  With kVec
// the group is one aligned 16-byte load (n % kGroup == 0, so a group that
// starts inside the row ends inside it).
template <bool kVec>
__device__ __forceinline__ unsigned group_mask(const uint16_t* __restrict__ row,
                                               int64_t j, int64_t n,
                                               int64_t lo) {
  unsigned m = 0;
  if (j >= n) return 0;
  if (kVec) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + j));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      m |= positive(w[q]) << (2 * q);
      m |= positive(w[q] >> 16) << (2 * q + 1);
    }
  } else {
#pragma unroll
    for (int b = 0; b < kGroup; ++b) {
      if (j + b < n) m |= positive(__ldg(row + j + b)) << b;
    }
  }
  if (lo > j) m &= lo - j >= kGroup ? 0u : ~((1u << (lo - j)) - 1u);
  return m;
}

// The first column a row's walk reads: 0, or with `triangular` the start of
// the group that holds column lo (clamped to n).
__device__ __forceinline__ int64_t first_group(int64_t lo, int64_t n) {
  const int64_t c = lo < n ? lo : n;
  return c > 0 ? c / kGroup * kGroup : 0;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    compact_count_kernel(const uint16_t* __restrict__ p, int64_t r,
                         int64_t n, int triangular, int64_t row0,
                         int64_t* __restrict__ starts) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (i == 0 && lane == 0) starts[0] = 0;
  if (i >= r) return;  // the whole warp: one row a warp
  const uint16_t* row = p + i * n;
  const int64_t lo = triangular ? row0 + i : 0;
  long long count = 0;
  for (int64_t j0 = first_group(lo, n); j0 < n; j0 += kStep) {
    count += __popc(group_mask<kVec>(row, j0 + lane * kGroup, n, lo));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    count += __shfl_xor_sync(kFullMask, count, off);
  }
  if (lane == 0) starts[i + 1] = count;
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
    compact_fill_kernel(const T* __restrict__ c,
                        const uint16_t* __restrict__ p, int64_t r, int64_t n,
                        int triangular, int64_t row0,
                        const int64_t* __restrict__ starts,
                        I* __restrict__ indptr, I* __restrict__ indices,
                        T* __restrict__ data) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (i >= r) return;
  int64_t base = starts[i];
  if (lane == 0) {
    indptr[i] = static_cast<I>(base);
    if (i == r - 1) indptr[r] = static_cast<I>(starts[r]);
  }
  const uint16_t* row = p + i * n;
  const T* c_row = c + i * n;
  const int64_t lo = triangular ? row0 + i : 0;
  const unsigned lower = (1u << lane) - 1u;
  const int64_t first = (lo < n ? lo : n) / 32 * 32;
  for (int64_t j0 = first; j0 < n; j0 += kStep) {
    uint16_t v[kGroup];
#pragma unroll
    for (int b = 0; b < kGroup; ++b) {
      const int64_t j = j0 + 32 * b + lane;
      v[b] = j < n ? __ldg(row + j) : uint16_t(0);
    }
#pragma unroll
    for (int b = 0; b < kGroup; ++b) {
      const int64_t j = j0 + 32 * b + lane;
      const bool keep = positive(v[b]) && j >= lo;
      const unsigned mask = __ballot_sync(kFullMask, keep);
      if (keep) {
        const int64_t pos = base + __popc(mask & lower);
        indices[pos] = static_cast<I>(j);
        data[pos] = c_row[j];
      }
      base += __popc(mask);
    }
  }
}

// Whether P's rows take 16-byte loads: every row starts on 16 bytes.
bool vector_rows(const void* p, int64_t n) {
  return n % kGroup == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool grid_of(int64_t r, unsigned* blocks) {
  const int64_t b = (r + kWarps - 1) / kWarps;
  if (r < 1 || b > 0x7fffffff) return false;
  *blocks = static_cast<unsigned>(b);
  return true;
}

cudaError_t launch_count(const void* p, int64_t r, int64_t n, int triangular,
                         int64_t row0, void* starts, cudaStream_t stream) {
  unsigned blocks;
  if (n < 1 || row0 < 0 || !grid_of(r, &blocks)) return cudaErrorInvalidValue;
  const uint16_t* pp = static_cast<const uint16_t*>(p);
  int64_t* out = static_cast<int64_t*>(starts);
  if (vector_rows(p, n)) {
    compact_count_kernel<true><<<blocks, kThreads, 0, stream>>>(
        pp, r, n, triangular, row0, out);
  } else {
    compact_count_kernel<false><<<blocks, kThreads, 0, stream>>>(
        pp, r, n, triangular, row0, out);
  }
  return cudaGetLastError();
}

template <typename T, typename I>
cudaError_t launch_fill(const void* c, const void* p, int64_t r, int64_t n,
                        int triangular, int64_t row0, const void* starts,
                        void* indptr, void* indices, void* data,
                        cudaStream_t stream) {
  unsigned blocks;
  if (n < 1 || row0 < 0 || !grid_of(r, &blocks)) return cudaErrorInvalidValue;
  compact_fill_kernel<T, I><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(c), static_cast<const uint16_t*>(p), r, n,
      triangular, row0, static_cast<const int64_t*>(starts),
      static_cast<I*>(indptr), static_cast<I*>(indices),
      static_cast<T*>(data));
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdt

extern "C" int sdt_csr_compact_count(const void* p, int64_t r, int64_t n,
                                     int triangular, int64_t row0,
                                     void* starts, void* stream) {
  return sdt::launch_count(p, r, n, triangular, row0, starts,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int sdt_csr_compact_fill(int dtype, int itype, const void* c,
                                    const void* p, int64_t r, int64_t n,
                                    int triangular, int64_t row0,
                                    const void* starts, void* indptr,
                                    void* indices, void* data, void* stream) {
  SDT_DISPATCH(dtype, itype, sdt::launch_fill, c, p, r, n, triangular, row0,
               starts, indptr, indices, data,
               static_cast<cudaStream_t>(stream))
}
