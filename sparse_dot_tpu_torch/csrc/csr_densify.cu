// K12: CSR densify, out = dense(A) as a row-major m x k matrix, for CSR A
// (indptr, indices, data).  Repeated columns in a row are summed, columns
// may come in any order, and explicit zeros are kept (they add 0).
//
// Replaces sparse_dot_tpu/ops/_xla.py densify (:199; expanded COO scattered
// into zeros) and densify_sorted (:273, through sorted_set_scatter :224),
// the first half of spmm_densified_sorted (:426) and of
// spgemm_numeric_sorted (:326).  The product that follows is a dense matrix
// product outside any kernel (ops/host.py), as the JAX package left it to
// XLA's dot.  A CSC is densified from its stored arrays (the CSR of its
// transpose) and read through the transposed view: there is no transposed
// variant.
//
// Bound: the m * k * sizeof(T) bytes of the dense output, written once,
// plus A's arrays read once; no arithmetic to speak of.  Writing zeros
// first and scattering after would write every touched line twice, so:
//
// - Rows of at most kTileBytes are built in shared memory: a block takes a
//   tile of consecutive rows (ops/densify.densify_plan picks how many: the
//   tile's rows, row-major, are one contiguous run of the output), zeroes
//   its tile with 16-byte stores, adds each row's entries with shared-memory
//   atomics (a warp a row when the tile holds a row for each warp, else all
//   the block's threads on each row in turn, so that wide rows keep every
//   warp busy; complex values as two real adds), and writes the tile out
//   once with 16-byte stores.
//   The tile sits in shared memory at the output's address modulo 16, so
//   the two line up for vector copies whatever the row width.
// - Wider rows take a block each: the block zeroes its row in device memory
//   with 16-byte stores, fences, and adds the entries with atomics in L2,
//   where the row is still hot.  Each thread loads kUnroll of its entries
//   before it adds them, so that their loads are in flight together.
//
// Duplicates make the sums' order depend on the atomics; a position that
// receives one entry holds exactly that entry's bits (0 + v).  Column ids
// outside [0, k) are skipped (no stray write).
//
// The indicator template (sdt_csr_indicator, T = Indicator) writes bf16 1.0
// at every stored position, explicit zeros included, and reads no values:
// the operand of the structural count P = ind(A) @ ind(B) of the densify
// route of sparse-output products (ops/host.py), the counterpart of
// _xla.py _indicator_sorted (:881).  Its "add" is a plain 16-bit store, as
// every entry writes the same 1.0; it is bound by its 2 * m * k bytes.
#include "common.cuh"

namespace sdt {
namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// Entries a thread loads before it adds them: their loads in flight
// together.
constexpr int kUnroll = 4;
// Shared memory of the largest tile; ops/densify.py (TILE_BYTES) holds the
// same number.  Tiles of rows up to 112 KB stay within 112 KB, so two
// blocks share an SM (ops/densify.py, PAIR_BYTES); a row up to 200 KB (a
// c128 row of 12,800 columns) is a tile of one row, one block an SM.
constexpr int64_t kTileBytes = 200 * 1024;

__device__ __forceinline__ void add_to(float* p, float v) { atomicAdd(p, v); }
__device__ __forceinline__ void add_to(double* p, double v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void add_to(c64* p, c64 v) {
  float* q = reinterpret_cast<float*>(p);
  atomicAdd(q, v.real());
  atomicAdd(q + 1, v.imag());
}
__device__ __forceinline__ void add_to(c128* p, c128 v) {
  double* q = reinterpret_cast<double*>(p);
  atomicAdd(q, v.real());
  atomicAdd(q + 1, v.imag());
}

// A bf16 of the structural indicator; T() is its 0.
struct Indicator {
  uint16_t bits;
};
constexpr uint16_t kBf16One = 0x3f80;
__device__ __forceinline__ void add_to(Indicator* p, Indicator v) { *p = v; }

// Entry q's value: the data, or for the indicator 1.0 (no value read).
template <typename T>
__device__ __forceinline__ T entry(const T* __restrict__ data, int64_t q) {
  return data[q];
}
__device__ __forceinline__ Indicator entry(const Indicator*, int64_t) {
  return Indicator{kBf16One};
}

// Adds the entries of row r to row (k elements), skipping column ids out
// of range; `first` and `stride` spread the entries over the caller's
// threads, each loading kUnroll of its entries before it adds them.
template <typename T, typename I>
__device__ __forceinline__ void scatter_row(const I* __restrict__ indptr,
                                            const I* __restrict__ indices,
                                            const T* __restrict__ data,
                                            int64_t r, int64_t k, T* row,
                                            int first, int stride) {
  const int64_t s = static_cast<int64_t>(indptr[r]);
  const int64_t e = static_cast<int64_t>(indptr[r + 1]);
  for (int64_t p = s + first; p < e; p += kUnroll * stride) {
    int64_t c[kUnroll];
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t q = p + u * stride;
      c[u] = q < e ? static_cast<int64_t>(indices[q]) : -1;
      v[u] = q < e ? entry(data, q) : T();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c[u] >= 0 && c[u] < k) add_to(row + c[u], v[u]);
    }
  }
}

// Rows of at most kTileBytes: a tile of rows_per_tile rows a block, built
// in shared memory and written once.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
    densify_tile_kernel(const I* __restrict__ indptr,
                        const I* __restrict__ indices,
                        const T* __restrict__ data, T* __restrict__ out,
                        int64_t m, int64_t k, int64_t rows_per_tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_tile;
  const int64_t r1 = r0 + rows_per_tile < m ? r0 + rows_per_tile : m;
  const int64_t count = (r1 - r0) * k;
  T* dst = out + r0 * k;
  // The tile starts at the output's address modulo 16.
  const int pad = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
  T* tile = reinterpret_cast<T*>(smem + pad);

  const int64_t zero_vecs = (pad + count * static_cast<int64_t>(sizeof(T)) +
                             15) / 16;
  uint4* z = reinterpret_cast<uint4*>(smem);
  for (int64_t v = threadIdx.x; v < zero_vecs; v += kThreads) {
    z[v] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  if (r1 - r0 >= kWarps) {
    // Many rows: a warp a row.
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x & 31;
    for (int64_t r = r0 + warp; r < r1; r += kWarps) {
      scatter_row(indptr, indices, data, r, k, tile + (r - r0) * k, lane,
                  32);
    }
  } else {
    // Few (wide) rows: the whole block on each row in turn.
    for (int64_t r = r0; r < r1; ++r) {
      scatter_row(indptr, indices, data, r, k, tile + (r - r0) * k,
                  threadIdx.x, kThreads);
    }
  }
  __syncthreads();

  // Out: scalars up to the first 16-byte boundary, 16-byte stores, then
  // the scalars after the last boundary.
  constexpr int64_t kPerVec = 16 / static_cast<int64_t>(sizeof(T));
  const int64_t head_max = ((16 - pad) & 15) / static_cast<int64_t>(sizeof(T));
  const int64_t head = head_max < count ? head_max : count;
  if (threadIdx.x < head) dst[threadIdx.x] = tile[threadIdx.x];
  const int64_t vecs = (count - head) / kPerVec;
  const uint4* src4 = reinterpret_cast<const uint4*>(tile + head);
  uint4* dst4 = reinterpret_cast<uint4*>(dst + head);
  for (int64_t v = threadIdx.x; v < vecs; v += kThreads) dst4[v] = src4[v];
  for (int64_t i = head + vecs * kPerVec + threadIdx.x; i < count;
       i += kThreads) {
    dst[i] = tile[i];
  }
}

// Rows wider than kTileBytes: a block a row, zeroed in device memory, then
// the entries added with atomics.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
    densify_wide_kernel(const I* __restrict__ indptr,
                        const I* __restrict__ indices,
                        const T* __restrict__ data, T* __restrict__ out,
                        int64_t k) {
  const int64_t r = blockIdx.x;
  T* dst = out + r * k;
  constexpr int64_t kPerVec = 16 / static_cast<int64_t>(sizeof(T));
  const int pad = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
  const int64_t head_max = ((16 - pad) & 15) / static_cast<int64_t>(sizeof(T));
  const int64_t head = head_max < k ? head_max : k;
  const T zero = T();
  if (threadIdx.x < head) dst[threadIdx.x] = zero;
  const int64_t vecs = (k - head) / kPerVec;
  uint4* dst4 = reinterpret_cast<uint4*>(dst + head);
  for (int64_t v = threadIdx.x; v < vecs; v += kThreads) {
    dst4[v] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int64_t i = head + vecs * kPerVec + threadIdx.x; i < k;
       i += kThreads) {
    dst[i] = zero;
  }
  // The zeros reach L2, where the atomics below add, before any thread of
  // the block adds.
  __threadfence();
  __syncthreads();
  scatter_row(indptr, indices, data, r, k, dst, threadIdx.x, kThreads);
}

template <typename T, typename I>
cudaError_t launch(const void* indptr, const void* indices, const void* data,
                   void* out, int64_t m, int64_t k, int64_t rows_per_tile,
                   cudaStream_t stream) {
  if (m < 1 || k < 1 || rows_per_tile < 0) return cudaErrorInvalidValue;
  const I* ip = static_cast<const I*>(indptr);
  const I* ix = static_cast<const I*>(indices);
  const T* dv = static_cast<const T*>(data);
  T* c = static_cast<T*>(out);
  if (rows_per_tile == 0) {
    if (k * static_cast<int64_t>(sizeof(T)) <= kTileBytes || m > 0x7fffffff) {
      return cudaErrorInvalidValue;
    }
    densify_wide_kernel<T, I><<<static_cast<unsigned>(m), kThreads, 0,
                                stream>>>(ip, ix, dv, c, k);
    return cudaGetLastError();
  }
  const int64_t tile_bytes = rows_per_tile * k * static_cast<int64_t>(sizeof(T));
  const int64_t tiles = (m + rows_per_tile - 1) / rows_per_tile;
  if (tile_bytes > kTileBytes || tiles > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  // The tile, rounded up to 16 bytes, and up to 16 bytes ahead of it.
  const size_t smem = static_cast<size_t>((tile_bytes + 15) / 16 * 16 + 16);
  auto kernel = densify_tile_kernel<T, I>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kTileBytes + 16));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(tiles), kThreads, smem, stream>>>(
      ip, ix, dv, c, m, k, rows_per_tile);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdt

extern "C" int sdt_csr_densify(int dtype, int itype, const void* indptr,
                               const void* indices, const void* data,
                               void* out, int64_t m, int64_t k,
                               int64_t rows_per_tile, void* stream) {
  SDT_DISPATCH(dtype, itype, sdt::launch, indptr, indices, data, out, m, k,
               rows_per_tile, static_cast<cudaStream_t>(stream))
}

extern "C" int sdt_csr_indicator(int itype, const void* indptr,
                                 const void* indices, void* out, int64_t m,
                                 int64_t k, int64_t rows_per_tile,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (itype) {
    case sdt::kI32:
      return sdt::launch<sdt::Indicator, int32_t>(indptr, indices, nullptr,
                                                  out, m, k, rows_per_tile, s);
    case sdt::kI64:
      return sdt::launch<sdt::Indicator, int64_t>(indptr, indices, nullptr,
                                                  out, m, k, rows_per_tile, s);
    default:
      return cudaErrorInvalidValue;
  }
}
