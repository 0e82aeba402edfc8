// K4 csr_spgemm_count and K5 csr_spgemm_fill: C = op(A) @ op(B) with
// sparse output, row by row (Gustavson), on the CSR arrays of op(A) and
// op(B).  K4 writes the number of distinct columns of each row of C; the
// wrapper sums them into C's indptr; K5 writes each row's columns in
// ascending order with their values.  With `triangular` only columns
// j >= i count.
//
// Replaces the JAX package's XLA-level SpGEMM: the densify + pattern
// matmul family of sparse_dot_tpu/ops/_xla.py (spgemm_numeric_sorted,
// _pattern_matmul, spgemm_structural_sorted, extract_structure) and its
// expand-sort-compress path (_xla.esc_spgemm_block, _esc_sort_compress,
// host._spgemm_esc_arrays_impl).  The TPU densified both operands for its
// matrix unit, or expanded and sorted every product; here each row of C
// is built once in an accumulator sized to that row, and nothing of size
// m x n or (number of products) is ever written to device memory.
//
// Bound: each product costs one read of op(B)'s (column, value) and one
// accumulator update in shared memory, and every entry of op(A) ends in a
// synchronisation of the threads that share the row; rows are bound by
// that latency, not by bytes.  The row bins of ops/spgemm.py
// (spgemm_bins) choose, per row, by min(ub, n) with ub the row's number
// of products:
//   - kHashWarp: one warp per row, 8 per block, a hash table of 64, 256
//     or 1024 slots in shared memory (load at most 1/2);
//   - kHashBlock: one 256-thread block per row, a table of 4096 slots or
//     the largest that 200 KB hold (8192 or 16384);
//   - kDenseShared: one block per row, a dense row of width n (values and
//     one flag byte per column) in shared memory, where it fits 200 KB;
//   - kDenseGlobal: the same dense row in a device workspace of
//     `work_groups` rows of round16(n * (sizeof(T) + 1)) bytes, at most
//     256 MB in all (ops/spgemm.py GLOBAL_WORKSPACE; at least one row),
//     for rows too long for a hash table when n is too wide for shared
//     memory.
// Each bin is one launch of a persistent grid that walks the bin's rows
// (read from the device), so the host never waits for the bin sizes.
//
// Determinism: a row's entries of op(A) are walked one after another;
// the threads of the row split op(B)'s row k, whose columns are distinct,
// so no two threads touch one accumulator slot within a step, and a sync
// ends each step.  Only a hash table's key insertion needs atomicCAS.
// Every value is thus summed in op(A)'s stored order with no float
// atomics: the same bits on every run.
#include <type_traits>

#include "common.cuh"

namespace sdt {
namespace {

// Codes shared with ops/spgemm.py.
enum BinKind : int64_t {
  kSkip = 0,
  kHashWarp = 1,
  kHashBlock = 2,
  kDenseShared = 3,
  kDenseGlobal = 4,
};
enum Mode : int { kHash = 0, kDense = 1 };
constexpr int kThreads = 256;

template <typename T, typename I>
struct Args {
  const I* a_indptr;
  const I* a_indices;
  const T* a_data;  // K5 only
  const I* b_indptr;
  const I* b_indices;
  const T* b_data;  // K5 only
  const int64_t* rows;     // row ids grouped by bin
  const int64_t* offsets;  // bin b's rows: rows[offsets[b] : offsets[b+1]]
  int64_t n;
  bool triangular;
  int64_t* counts;     // K4 output
  const I* c_indptr;   // K5 input
  I* c_indices;        // K5 output
  T* c_data;           // K5 output
};

template <int G>
__device__ __forceinline__ void group_sync() {
  if constexpr (G == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Exclusive prefix sum of v over the G threads of a group (a warp, or the
// whole 256-thread block); *total receives the group's sum.  Every thread
// of the group must call it.
template <int G>
__device__ __forceinline__ int group_scan(int v, int* scratch, int* total) {
  const int wl = threadIdx.x & 31;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, d);
    if (wl >= d) x += y;
  }
  if constexpr (G == 32) {
    *total = __shfl_sync(kFullMask, x, 31);
    return x - v;
  } else {
    const int w = threadIdx.x >> 5;
    if (wl == 31) scratch[w] = x;
    __syncthreads();
    int base = 0, sum = 0;
#pragma unroll
    for (int t = 0; t < G / 32; ++t) {
      const int s = scratch[t];
      base += t < w ? s : 0;
      sum += s;
    }
    __syncthreads();  // scratch is reused by the next call
    *total = sum;
    return base + x - v;
  }
}

__device__ __forceinline__ int32_t cas(int32_t* p, int32_t cmp, int32_t v) {
  return atomicCAS(reinterpret_cast<int*>(p), cmp, v);
}
__device__ __forceinline__ int64_t cas(int64_t* p, int64_t cmp, int64_t v) {
  return static_cast<int64_t>(atomicCAS(
      reinterpret_cast<unsigned long long*>(p),
      static_cast<unsigned long long>(cmp),
      static_cast<unsigned long long>(v)));
}

// Slot of `key` in a linear-probing table of mask + 1 slots (empty = -1),
// inserting it if absent; *fresh says whether this call inserted it.
template <typename I>
__device__ __forceinline__ int64_t hash_slot(I* keys, int64_t mask, I key,
                                             bool* fresh) {
  uint64_t h = static_cast<uint64_t>(key) * 0x9E3779B97F4A7C15ull;
  int64_t s = static_cast<int64_t>((h ^ (h >> 29)) & mask);
  for (;;) {
    const I cur = *reinterpret_cast<volatile I*>(keys + s);
    if (cur == key) break;
    if (cur == I(-1)) {
      const I prev = cas(keys + s, I(-1), key);
      if (prev == I(-1)) {
        *fresh = true;
        return s;
      }
      if (prev == key) break;
    }
    s = (s + 1) & mask;
  }
  *fresh = false;
  return s;
}

// Sorts the S (a power of two) slots of a table by key, empty slots
// (-1, largest as unsigned) last: a bitonic network over the group.
template <typename T, typename I, int G>
__device__ void sort_table(I* keys, T* vals, int64_t S, int lane) {
  using U = std::make_unsigned_t<I>;
  for (int64_t size = 2; size <= S; size <<= 1) {
    for (int64_t stride = size >> 1; stride > 0; stride >>= 1) {
      for (int64_t t = lane; t < S / 2; t += G) {
        const int64_t lo = 2 * t - (t & (stride - 1));
        const int64_t hi = lo + stride;
        const bool up = (lo & size) == 0;
        const I ka = keys[lo], kb = keys[hi];
        if ((static_cast<U>(ka) > static_cast<U>(kb)) == up) {
          keys[lo] = kb;
          keys[hi] = ka;
          const T va = vals[lo];
          vals[lo] = vals[hi];
          vals[hi] = va;
        }
      }
      group_sync<G>();
    }
  }
}

// Bytes of one group's accumulator: values (K5 only), then the hash keys
// or the dense row's flag bytes; rounded up to 16.
template <typename T, typename I, int MODE, bool FILL>
__host__ __device__ int64_t region_bytes(int64_t slots) {
  const int64_t tail = MODE == kHash ? slots * int64_t(sizeof(I)) : slots;
  const int64_t bytes = (FILL ? slots * int64_t(sizeof(T)) : 0) + tail;
  return (bytes + 15) / 16 * 16;
}

// One group of G threads builds one row of C at a time, walking the rows
// of bin `bin`.  `slots` is the hash table's size, or n for a dense row;
// `work` (kDenseGlobal) holds one region per group, else the regions are
// in dynamic shared memory.
template <typename T, typename I, int MODE, int G, bool FILL>
__global__ void __launch_bounds__(kThreads)
spgemm_rows_kernel(Args<T, I> args, int bin, int64_t slots,
                   unsigned char* work) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int scratch[kThreads / 32];
  constexpr int kGroups = kThreads / G;
  const int lane = threadIdx.x % G;
  const int64_t gid =
      static_cast<int64_t>(blockIdx.x) * kGroups + threadIdx.x / G;
  const int64_t ngroups = static_cast<int64_t>(gridDim.x) * kGroups;
  const int64_t region = region_bytes<T, I, MODE, FILL>(slots);
  unsigned char* base = work != nullptr
                            ? work + gid * region
                            : smem + (threadIdx.x / G) * region;
  T* vals = reinterpret_cast<T*>(base);
  unsigned char* tail = base + (FILL ? slots * int64_t(sizeof(T)) : 0);
  I* keys = reinterpret_cast<I*>(tail);
  unsigned char* flags = tail;
  const int64_t S = slots;

  const int64_t r_end = args.offsets[bin + 1];
  for (int64_t r = args.offsets[bin] + gid; r < r_end; r += ngroups) {
    const int64_t i = args.rows[r];
    for (int64_t s = lane; s < S; s += G) {
      if constexpr (MODE == kHash) {
        keys[s] = I(-1);
      } else {
        flags[s] = 0;
      }
      if constexpr (FILL) vals[s] = Arith<T>::zero();
    }
    group_sync<G>();

    int fresh = 0;
    const int64_t p_end = args.a_indptr[i + 1];
    for (int64_t p = args.a_indptr[i]; p < p_end; ++p) {
      const int64_t k = args.a_indices[p];
      const int64_t q_end = args.b_indptr[k + 1];
      T av;
      if constexpr (FILL) av = args.a_data[p];
      for (int64_t q = args.b_indptr[k] + lane; q < q_end; q += G) {
        const I j = args.b_indices[q];
        if (args.triangular && j < i) continue;
        int64_t slot;
        if constexpr (MODE == kHash) {
          bool is_new;
          slot = hash_slot(keys, S - 1, j, &is_new);
          fresh += is_new;
        } else {
          slot = j;
          if (!flags[j]) {
            flags[j] = 1;
            ++fresh;
          }
        }
        if constexpr (FILL) {
          vals[slot] = Arith<T>::fma(av, args.b_data[q], vals[slot]);
        }
      }
      group_sync<G>();
    }

    if constexpr (!FILL) {
      int total;
      group_scan<G>(fresh, scratch, &total);
      if (lane == 0) args.counts[i] = total;
    } else if constexpr (MODE == kDense) {
      // Compact the flagged columns in order, G columns at a time.
      int64_t out = args.c_indptr[i];
      for (int64_t j0 = 0; j0 < S; j0 += G) {
        const int64_t j = j0 + lane;
        const int f = j < S && flags[j];
        int total;
        const int pos = group_scan<G>(f, scratch, &total);
        if (f) {
          args.c_indices[out + pos] = static_cast<I>(j);
          args.c_data[out + pos] = vals[j];
        }
        out += total;
      }
    } else {
      sort_table<T, I, G>(keys, vals, S, lane);
      const int64_t c0 = args.c_indptr[i];
      const int64_t cnt = args.c_indptr[i + 1] - c0;
      for (int64_t t = lane; t < cnt; t += G) {
        args.c_indices[c0 + t] = keys[t];
        args.c_data[c0 + t] = vals[t];
      }
    }
    group_sync<G>();
  }
}

template <typename T, typename I, int MODE, int G, bool FILL>
cudaError_t launch_bin(const Args<T, I>& args, int bin, int64_t slots,
                       int64_t m, unsigned char* work, int64_t work_groups,
                       int sms, cudaStream_t stream) {
  auto kernel = spgemm_rows_kernel<T, I, MODE, G, FILL>;
  constexpr int kGroups = kThreads / G;
  int64_t grid = work_groups;
  size_t shared = 0;
  if (work == nullptr) {
    shared = static_cast<size_t>(region_bytes<T, I, MODE, FILL>(slots)) *
             kGroups;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, shared);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const int64_t wanted = (m + kGroups - 1) / kGroups;
    const int64_t resident = static_cast<int64_t>(per_sm) * sms;
    grid = wanted < resident ? wanted : resident;
  }
  if (grid < 1) grid = 1;
  kernel<<<static_cast<unsigned>(grid), kThreads, shared, stream>>>(
      args, bin, slots, work);
  return cudaGetLastError();
}

// Launches every bin of `bins` ((kind, slots, u_max) rows, host memory).
template <typename T, typename I, bool FILL>
cudaError_t launch_bins(const Args<T, I>& args, const int64_t* bins,
                        int nbins, int64_t m, unsigned char* work,
                        int64_t work_groups, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  for (int b = 0; b < nbins; ++b) {
    const int64_t kind = bins[3 * b];
    const int64_t slots = bins[3 * b + 1];
    switch (kind) {
      case kSkip:
        err = cudaSuccess;
        break;
      case kHashWarp:
        err = launch_bin<T, I, kHash, 32, FILL>(args, b, slots, m, nullptr,
                                                0, sms, stream);
        break;
      case kHashBlock:
        err = launch_bin<T, I, kHash, kThreads, FILL>(args, b, slots, m,
                                                      nullptr, 0, sms, stream);
        break;
      case kDenseShared:
        err = launch_bin<T, I, kDense, kThreads, FILL>(
            args, b, slots, m, nullptr, 0, sms, stream);
        break;
      case kDenseGlobal:
        if (work == nullptr || work_groups < 1) return cudaErrorInvalidValue;
        err = launch_bin<T, I, kDense, kThreads, FILL>(
            args, b, slots, m, work, work_groups, sms, stream);
        break;
      default:
        return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

template <typename I>
cudaError_t count(const void* a_indptr, const void* a_indices,
                  const void* b_indptr, const void* b_indices,
                  const void* rows, const void* offsets, const int64_t* bins,
                  int nbins, int64_t m, int64_t n, int triangular,
                  void* counts, void* work, int64_t work_groups,
                  cudaStream_t stream) {
  // The count pass reads no values; float stands in for the value type.
  Args<float, I> args{};
  args.a_indptr = static_cast<const I*>(a_indptr);
  args.a_indices = static_cast<const I*>(a_indices);
  args.b_indptr = static_cast<const I*>(b_indptr);
  args.b_indices = static_cast<const I*>(b_indices);
  args.rows = static_cast<const int64_t*>(rows);
  args.offsets = static_cast<const int64_t*>(offsets);
  args.n = n;
  args.triangular = triangular != 0;
  args.counts = static_cast<int64_t*>(counts);
  return launch_bins<float, I, false>(args, bins, nbins, m,
                                      static_cast<unsigned char*>(work),
                                      work_groups, stream);
}

template <typename T, typename I>
cudaError_t fill(const void* a_indptr, const void* a_indices,
                 const void* a_data, const void* b_indptr,
                 const void* b_indices, const void* b_data, const void* rows,
                 const void* offsets, const int64_t* bins, int nbins,
                 int64_t m, int64_t n, int triangular, const void* c_indptr,
                 void* c_indices, void* c_data, void* work,
                 int64_t work_groups, cudaStream_t stream) {
  Args<T, I> args{};
  args.a_indptr = static_cast<const I*>(a_indptr);
  args.a_indices = static_cast<const I*>(a_indices);
  args.a_data = static_cast<const T*>(a_data);
  args.b_indptr = static_cast<const I*>(b_indptr);
  args.b_indices = static_cast<const I*>(b_indices);
  args.b_data = static_cast<const T*>(b_data);
  args.rows = static_cast<const int64_t*>(rows);
  args.offsets = static_cast<const int64_t*>(offsets);
  args.n = n;
  args.triangular = triangular != 0;
  args.c_indptr = static_cast<const I*>(c_indptr);
  args.c_indices = static_cast<I*>(c_indices);
  args.c_data = static_cast<T*>(c_data);
  return launch_bins<T, I, true>(args, bins, nbins, m,
                                 static_cast<unsigned char*>(work),
                                 work_groups, stream);
}

}  // namespace
}  // namespace sdt

extern "C" int sdt_csr_spgemm_count(int itype, const void* a_indptr,
                                    const void* a_indices,
                                    const void* b_indptr,
                                    const void* b_indices, const void* rows,
                                    const void* offsets, const void* bins,
                                    int nbins, int64_t m, int64_t n,
                                    int triangular, void* counts, void* work,
                                    int64_t work_groups, void* stream) {
  const auto* b = static_cast<const int64_t*>(bins);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (itype) {
    case sdt::kI32:
      return sdt::count<int32_t>(a_indptr, a_indices, b_indptr, b_indices,
                                 rows, offsets, b, nbins, m, n, triangular,
                                 counts, work, work_groups, s);
    case sdt::kI64:
      return sdt::count<int64_t>(a_indptr, a_indices, b_indptr, b_indices,
                                 rows, offsets, b, nbins, m, n, triangular,
                                 counts, work, work_groups, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int sdt_csr_spgemm_fill(
    int dtype, int itype, const void* a_indptr, const void* a_indices,
    const void* a_data, const void* b_indptr, const void* b_indices,
    const void* b_data, const void* rows, const void* offsets,
    const void* bins, int nbins, int64_t m, int64_t n, int triangular,
    const void* c_indptr, void* c_indices, void* c_data, void* work,
    int64_t work_groups, void* stream) {
  SDT_DISPATCH(dtype, itype, sdt::fill, a_indptr, a_indices, a_data,
               b_indptr, b_indices, b_data, rows, offsets,
               static_cast<const int64_t*>(bins), nbins, m, n, triangular,
               c_indptr, c_indices, c_data, work, work_groups,
               static_cast<cudaStream_t>(stream))
}
