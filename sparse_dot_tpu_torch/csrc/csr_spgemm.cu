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
// accumulator update, and every entry of op(A) ends in a synchronisation
// of the threads that share the row; rows are bound by that latency, not
// by bytes.  The row bins of ops/spgemm.py (spgemm_bins) choose, per row,
// by ub, the row's number of products:
//   - kTiny4, kTiny8, kTiny16, kTiny32 (1 <= ub <= G for the group width
//     G): a group of G lanes of a warp, 32 / G rows a warp, each lane one
//     product, in registers (no shared memory, no atomics).  The lanes
//     scan the op(B) row lengths of the row's op(A) entries (G entries at
//     a time, carrying the prefix), find their product by a binary search
//     over shuffles, sort (column, product index) keys with a bitonic
//     network of __shfl_xor_sync, and let the first lane of each column
//     count it (K4) or fold its run in order and write it (K5).  The four
//     widths run in one launch.  Rows of few products, as in a random
//     1M x 1M A @ A, are bound by the chain of about five dependent loads
//     (row id, op(A)'s indptr and entry, op(B)'s indptr and column), so
//     this path keeps many rows in flight and does nothing else;
//   - kHashWarp: one warp per row, 8 per block, a hash table of 256 or
//     1024 slots in shared memory (load at most 1/2);
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
// (read from the device), so K4 never waits for the bin sizes; K5 runs
// after the output's size was read, and its wrapper, which reads the bin
// sizes with it, marks the empty bins kSkip and bounds each grid by its
// bin's rows.
//
// Determinism: a row's entries of op(A) are walked one after another;
// the threads of the row split op(B)'s row k, whose columns are distinct,
// so no two threads touch one accumulator slot within a step, and a sync
// ends each step.  Only a hash table's key insertion needs atomicCAS.
// The register path sorts on (column, product index), so a column's
// products stay in op(A)'s stored order, and folds them with the same
// fma from zero.  Every value is thus summed in op(A)'s stored order with
// no float atomics: the same bits on every run, and on either path.
//
// A batch of K5 fills whose members share op(A)'s and op(B)'s patterns
// (jax.vmap of esc_spgemm_block over the values; torch.func.vmap, jacfwd
// and hessian of csr_spgemm) is one launch a bin, the member on
// blockIdx.y: the plan, the bins and C's indptr are the patterns' and
// shared, op(A)'s and op(B)'s values and C's values have member strides
// (0 for an operand that all members share; C's values nnz(C) apart), and
// a kDenseGlobal group's workspace row is its member's own.  Every member
// builds each row from the same columns in the same order (the same
// sorted keys and hash tables, the same flags), so C's column ids, which
// member 0 alone writes, are every member's.  The persistent grids give
// each member resident / batch blocks (at least one).  A single fill is
// the instance with BATCH false, whose code has no member offsets.
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
  kTiny4 = 5,
  kTiny8 = 6,
  kTiny16 = 7,
  kTiny32 = 8,
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

// A batched K5 launch: member strides of op(A)'s, op(B)'s and C's values
// in elements (0: shared), and whether member 0 writes C's column ids (a
// later launch of the same batch does not write them again).
struct Members {
  int64_t a, b, c;
  bool indices;
};

// Moves args and work to member blockIdx.y of a batch (BATCH, K5 only):
// its values, and its groups' workspace rows past the `stride` bytes of
// each member before it.  C's column ids stay with member 0.
#define SDT_K5_TO_MEMBER(stride)                         \
  if constexpr (BATCH) {                                 \
    const int64_t z = blockIdx.y;                        \
    args.a_data += z * mb.a;                             \
    args.b_data += z * mb.b;                             \
    args.c_data += z * mb.c;                             \
    if (z != 0 || !mb.indices) args.c_indices = nullptr; \
    if (work != nullptr) work += z * (stride);           \
  }

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
// `work` (kDenseGlobal) holds one region per group (per member's group
// with BATCH, blockIdx.y the member), else the regions are in dynamic
// shared memory.
template <typename T, typename I, int MODE, int G, bool FILL, bool BATCH>
__global__ void __launch_bounds__(kThreads)
spgemm_rows_kernel(Args<T, I> args, int bin, int64_t slots,
                   unsigned char* work, const Members mb) {
  static_assert(FILL || !BATCH, "a batch is K5's alone");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int scratch[kThreads / 32];
  constexpr int kGroups = kThreads / G;
  const int lane = threadIdx.x % G;
  const int64_t gid =
      static_cast<int64_t>(blockIdx.x) * kGroups + threadIdx.x / G;
  const int64_t ngroups = static_cast<int64_t>(gridDim.x) * kGroups;
  const int64_t region = region_bytes<T, I, MODE, FILL>(slots);
  SDT_K5_TO_MEMBER(ngroups * region)
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
          if (!BATCH || args.c_indices != nullptr) {
            args.c_indices[out + pos] = static_cast<I>(j);
          }
          args.c_data[out + pos] = vals[j];
        }
        out += total;
      }
    } else {
      sort_table<T, I, G>(keys, vals, S, lane);
      const int64_t c0 = args.c_indptr[i];
      const int64_t cnt = args.c_indptr[i + 1] - c0;
      for (int64_t t = lane; t < cnt; t += G) {
        if (!BATCH || args.c_indices != nullptr) {
          args.c_indices[c0 + t] = keys[t];
        }
        args.c_data[c0 + t] = vals[t];
      }
    }
    group_sync<G>();
  }
}

// A store that L2 may evict first: the output streams past the inputs,
// whose random gathers want L2 to keep them.
template <typename T>
__device__ __forceinline__ void store_streaming(T* p, T v) {
  if constexpr (std::is_same_v<T, c64>) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v.real(), v.imag()));
  } else if constexpr (std::is_same_v<T, c128>) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(v.real(), v.imag()));
  } else if constexpr (std::is_integral_v<T> && sizeof(T) == 8) {
    __stcs(reinterpret_cast<long long*>(p), static_cast<long long>(v));
  } else {
    __stcs(p, v);
  }
}

// The register path.  A key is (column << 5) | product index, of 32 bits
// when n < 2^27 (fewer shuffles), else of 64; an empty lane (no product,
// or a column below the diagonal with `triangular`) holds all ones, which
// sorts last.
constexpr int64_t kNarrowKeyColumns = int64_t(1) << 27;

// The bits of a warp's ballot that belong to the group of lane wl.
template <int G>
__device__ __forceinline__ unsigned group_bits(int wl) {
  if constexpr (G == 32) {
    return kFullMask;
  } else {
    return ((1u << G) - 1u) << (wl & ~(G - 1));
  }
}

// The rows of bin `bin` (at most G products each), 32 / G a warp at a
// time.  Every lane of the warp runs every loop to the same count (rows
// past the bin's end take part with no product), as the shuffles need.
// With BATCH, args.c_indices is null where this member writes no ids.
template <typename T, typename I, typename K, int G, bool FILL, bool BATCH>
__device__ __forceinline__ void tiny_bin(const Args<T, I>& args, int bin,
                                         int64_t warp, int64_t nwarps) {
  constexpr int kRows = 32 / G;
  constexpr K kNoKey = ~K(0);
  const int wl = threadIdx.x & 31;
  const int lane = wl & (G - 1);
  const int64_t r_end = args.offsets[bin + 1];
  const int64_t step_rows = nwarps * kRows;
  int64_t base = args.offsets[bin] + warp * kRows;
  // The next row id is loaded one round ahead.
  int64_t i_next = base + wl / G < r_end ? args.rows[base + wl / G] : 0;
  for (; base < r_end; base += step_rows) {
    const int64_t r = base + wl / G;
    const bool valid = r < r_end;
    const int64_t i = i_next;
    if (r + step_rows < r_end) i_next = args.rows[r + step_rows];
    const int64_t p0 = valid ? static_cast<int64_t>(args.a_indptr[i]) : 0;
    const int64_t p1 = valid ? static_cast<int64_t>(args.a_indptr[i + 1])
                             : 0;
    int64_t c0 = 0;
    if constexpr (FILL) c0 = valid ? static_cast<int64_t>(args.c_indptr[i]) : 0;

    // Lane t takes the row's product t (t < ub <= G): the op(A) entries
    // are read G at a time (a row may hold many entries over empty op(B)
    // rows), their op(B) row lengths scanned, and the lane's entry found
    // by a binary search of the exclusive scan through shuffles.
    int64_t q = -1;  // the op(B) entry of the lane's product
    int64_t pa = 0;  // and its op(A) entry
    int carry = 0;   // products of the entries before this chunk
    for (int64_t c = p0; __any_sync(kFullMask, c < p1); c += G) {
      const int64_t p = c + lane;
      I start = 0;
      int len = 0;
      if (p < p1) {
        const int64_t k = args.a_indices[p];
        start = args.b_indptr[k];
        len = static_cast<int>(args.b_indptr[k + 1] - start);
      }
      int incl = len;
#pragma unroll
      for (int d = 1; d < G; d <<= 1) {
        const int y = __shfl_up_sync(kFullMask, incl, d, G);
        if (lane >= d) incl += y;
      }
      const int excl = incl - len;
      const int total = __shfl_sync(kFullMask, incl, G - 1, G);
      const int t = lane - carry;
      // The last entry whose products start at or before t holds it.
      int s = 0;
#pragma unroll
      for (int step = G / 2; step > 0; step >>= 1) {
        if (__shfl_sync(kFullMask, excl, s + step, G) <= t) s += step;
      }
      const int64_t qs =
          static_cast<int64_t>(__shfl_sync(kFullMask, start, s, G)) + t -
          __shfl_sync(kFullMask, excl, s, G);
      if (t >= 0 && t < total) {
        q = qs;
        pa = c + s;
      }
      carry += total;
    }

    K key = kNoKey;
    T av = Arith<T>::zero(), bv = Arith<T>::zero();
    if (q >= 0) {
      const int64_t j = args.b_indices[q];
      if (!args.triangular || j >= i) {
        key = (static_cast<K>(j) << 5) | static_cast<K>(lane);
      }
      if constexpr (FILL) {
        av = args.a_data[pa];
        bv = args.b_data[q];
      }
    }

    // Bitonic sort of the group's keys, ascending.
#pragma unroll
    for (int size = 2; size <= G; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const K other = __shfl_xor_sync(kFullMask, key, stride, G);
        const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
        key = keep_min ? (other < key ? other : key)
                       : (other > key ? other : key);
      }
    }
    const bool live = key != kNoKey;
    const K prev = __shfl_up_sync(kFullMask, key, 1, G);
    const bool head = live && (lane == 0 || (prev >> 5) != (key >> 5));
    const unsigned group = group_bits<G>(wl);
    const unsigned heads = __ballot_sync(kFullMask, head) & group;
    if constexpr (!FILL) {
      if (valid && lane == 0) {
        store_streaming(args.counts + i, static_cast<int64_t>(__popc(heads)));
      }
    } else {
      // Each lane takes the pair of the product its key names; a head
      // folds its column's run (up to the next head, or the last live
      // lane: empty keys sort last) in product order, from zero.
      const int src = static_cast<int>(key & 31);
      const T a = Arith<T>::shfl(av, src, G);
      const T b = Arith<T>::shfl(bv, src, G);
      const unsigned lives = __ballot_sync(kFullMask, live) & group;
      const unsigned above = heads & ~((2u << wl) - 1u);
      const int end = above ? __ffs(above) - 1
                            : (wl & ~(G - 1)) + __popc(lives);
      const int run = head ? end - wl : 0;
      T acc = Arith<T>::fma(a, b, Arith<T>::zero());
      for (int d = 1; __any_sync(kFullMask, d < run); ++d) {
        const T an = Arith<T>::shfl(a, lane + d, G);
        const T bn = Arith<T>::shfl(b, lane + d, G);
        if (d < run) acc = Arith<T>::fma(an, bn, acc);
      }
      if (head) {
        const int64_t pos = c0 + __popc(heads & ((1u << wl) - 1u));
        if (!BATCH || args.c_indices != nullptr) {
          store_streaming(args.c_indices + pos, static_cast<I>(key >> 5));
        }
        store_streaming(args.c_data + pos, acc);
      }
    }
  }
}

// The four register bins, bin .. bin + 3 (G = 4, 8, 16, 32), in one
// persistent launch: every warp walks its share of each bin in turn.
// Latency bounds it, so registers are capped for many warps an SM: 6
// blocks of 8 for K4, 5 for K5 (at 6 it spills), 4 for complex double's
// wider values.  With BATCH, blockIdx.y is the member.
template <typename T, typename I, typename K, bool FILL, bool BATCH>
__global__ void __launch_bounds__(kThreads,
                                  FILL ? (sizeof(T) > 8 ? 4 : 5) : 6)
spgemm_tiny_kernel(Args<T, I> args, int bin, const Members mb) {
  static_assert(FILL || !BATCH, "a batch is K5's alone");
  unsigned char* work = nullptr;  // the register path has no workspace
  SDT_K5_TO_MEMBER(0)
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  tiny_bin<T, I, K, 4, FILL, BATCH>(args, bin, warp, nwarps);
  tiny_bin<T, I, K, 8, FILL, BATCH>(args, bin + 1, warp, nwarps);
  tiny_bin<T, I, K, 16, FILL, BATCH>(args, bin + 2, warp, nwarps);
  tiny_bin<T, I, K, 32, FILL, BATCH>(args, bin + 3, warp, nwarps);
}

// Resident blocks an SM of `device` holds of `kernel` with `shared` bytes
// of dynamic shared memory, remembered per (kernel, device, size), so the
// runtime is asked once.  The kernel's dynamic shared memory limit is
// only ever raised (to `shared`): it is a ceiling, and lowered to a small
// row's size it would refuse a size asked for before.
template <typename Kernel>
cudaError_t blocks_per_sm(Kernel kernel, size_t shared, int device,
                          int* per_sm) {
  struct Seen {
    const void* kernel;
    int device;
    size_t shared;
    int blocks;
  };
  constexpr int kSeen = 32;
  thread_local Seen seen[kSeen] = {};
  thread_local int next = 0;
  const void* key = reinterpret_cast<const void*>(kernel);
  for (const Seen& e : seen) {
    if (e.kernel == key && e.device == device && e.shared == shared) {
      *per_sm = e.blocks;
      return cudaSuccess;
    }
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (shared > static_cast<size_t>(attr.maxDynamicSharedSizeBytes)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                      kThreads, shared);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  seen[next] = Seen{key, device, shared, *per_sm};
  next = (next + 1) % kSeen;
  return cudaSuccess;
}

// A persistent grid for `rows` rows, `per_block` a block at once, for
// each of `batch` members (the resident blocks shared out among them).
inline int64_t grid_for(int64_t rows, int64_t per_block, int per_sm,
                        int sms, int64_t batch) {
  const int64_t wanted = (rows + per_block - 1) / per_block;
  const int64_t resident = static_cast<int64_t>(per_sm) * sms / batch;
  const int64_t grid = wanted < resident ? wanted : resident;
  return grid < 1 ? 1 : grid;
}

// A launch's members (one for a single product) and their Members.
struct Batch {
  int64_t size;
  Members mb;
};

template <typename T, typename I, typename K, bool FILL, bool BATCH>
cudaError_t launch_tiny(const Args<T, I>& args, int bin, int64_t rows,
                        int device, int sms, const Batch& batch,
                        cudaStream_t stream) {
  auto kernel = spgemm_tiny_kernel<T, I, K, FILL, BATCH>;
  int per_sm = 0;
  cudaError_t err = blocks_per_sm(kernel, 0, device, &per_sm);
  if (err != cudaSuccess) return err;
  // A block holds at least 8 rows at once (G = 32).
  const int64_t grid =
      grid_for(rows, kThreads / 32, per_sm, sms, batch.size);
  kernel<<<dim3(static_cast<unsigned>(grid),
                static_cast<unsigned>(batch.size)),
           kThreads, 0, stream>>>(args, bin, batch.mb);
  return cudaGetLastError();
}

template <typename T, typename I, int MODE, int G, bool FILL, bool BATCH>
cudaError_t launch_bin(const Args<T, I>& args, int bin, int64_t slots,
                       int64_t rows, unsigned char* work, int64_t work_groups,
                       int device, int sms, const Batch& batch,
                       cudaStream_t stream) {
  auto kernel = spgemm_rows_kernel<T, I, MODE, G, FILL, BATCH>;
  constexpr int kGroups = kThreads / G;
  int64_t grid = work_groups < 1 ? 1 : work_groups;
  size_t shared = 0;
  if (work == nullptr) {
    shared = static_cast<size_t>(region_bytes<T, I, MODE, FILL>(slots)) *
             kGroups;
    int per_sm = 0;
    const cudaError_t err = blocks_per_sm(kernel, shared, device, &per_sm);
    if (err != cudaSuccess) return err;
    grid = grid_for(rows, kGroups, per_sm, sms, batch.size);
  }
  kernel<<<dim3(static_cast<unsigned>(grid),
                static_cast<unsigned>(batch.size)),
           kThreads, shared, stream>>>(args, bin, slots, work, batch.mb);
  return cudaGetLastError();
}

// The plan on the card (ops/spgemm.spgemm_plan's, built in K4's launch):
// ub per row, each row's bin (the first whose u_max >= ub), and the row
// ids grouped by bin, ascending within a bin (a stable partition), with
// the bins' offsets.  Three kernels over tiles of `tile_rows` rows, L
// lanes a row (the host picks L and the tile from the mean op(A) row, so
// a tile holds about 2048 entries whatever the rows): ub and the rows per
// bin of each tile, one block's scan of those, and the scatter.  No
// atomics but integer adds in shared memory: the same plan on every run.
constexpr int kMaxBins = 16;

struct Thresholds {
  int64_t u_max[kMaxBins];  // of every bin but the last
  int nbins;
};

__device__ __forceinline__ int bin_of(const Thresholds& th, int64_t u) {
  int b = 0;
  while (b < th.nbins - 1 && u > th.u_max[b]) ++b;
  return b;
}

// ub of each row of a tile (its L lanes add the op(B) row lengths of its
// op(A) entries, then shuffle-add; a group of L lanes takes every
// (256 / L)-th row of the tile), and the tile's rows per bin, stored
// bin-major: tile_bins[b * tiles + tile].
template <typename I>
__global__ void __launch_bounds__(kThreads)
plan_count_kernel(const I* a_indptr, const I* a_indices, const I* b_indptr,
                  int64_t m, int lanes, int tile_rows, Thresholds th,
                  int64_t* ub, int64_t* tile_bins) {
  __shared__ int s_bins[kMaxBins];
  const int t = threadIdx.x;
  if (t < kMaxBins) s_bins[t] = 0;
  __syncthreads();
  const int groups = kThreads / lanes;
  const int lane = t & (lanes - 1);
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * tile_rows;
  // tile_rows is a multiple of groups: every warp loops alike.
  for (int x = t / lanes; x < tile_rows; x += groups) {
    const int64_t r = r0 + x;
    int64_t sum = 0;
    if (r < m) {
      const int64_t p1 = a_indptr[r + 1];
      for (int64_t p = a_indptr[r] + lane; p < p1; p += lanes) {
        const int64_t k = a_indices[p];
        sum += static_cast<int64_t>(b_indptr[k + 1] - b_indptr[k]);
      }
    }
    for (int d = lanes >> 1; d > 0; d >>= 1) {
      sum += __shfl_xor_sync(kFullMask, sum, d, lanes);
    }
    if (r < m && lane == 0) {
      ub[r] = sum;
      atomicAdd(&s_bins[bin_of(th, sum)], 1);
    }
  }
  __syncthreads();
  if (t < th.nbins) tile_bins[t * gridDim.x + blockIdx.x] = s_bins[t];
}

// One block: each bin's rows per tile become the tile's first position
// in `rows` (in place), bin by bin, tile by tile; offsets[b] is bin b's
// first position and offsets[nbins] = m.  A thread takes a run of tiles,
// so a bin is one scan over the block.
__global__ void __launch_bounds__(1024)
plan_scan_kernel(int64_t* tile_bins, int64_t tiles, int nbins,
                 int64_t* offsets) {
  __shared__ int64_t s_warp[32];
  const int t = threadIdx.x, wl = t & 31, w = t >> 5;
  const int64_t per = (tiles + 1023) / 1024;
  const int64_t j0 = t * per < tiles ? t * per : tiles;
  const int64_t j1 = j0 + per < tiles ? j0 + per : tiles;
  int64_t start = 0;  // rows in the bins before b
  for (int b = 0; b < nbins; ++b) {
    int64_t* bin = tile_bins + b * tiles;
    int64_t mine = 0;
    for (int64_t j = j0; j < j1; ++j) mine += bin[j];
    int64_t x = mine;  // inclusive scan over the block
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t y = __shfl_up_sync(kFullMask, x, d);
      if (wl >= d) x += y;
    }
    if (wl == 31) s_warp[w] = x;
    __syncthreads();
    if (w == 0) {
      int64_t v = s_warp[wl];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int64_t y = __shfl_up_sync(kFullMask, v, d);
        if (wl >= d) v += y;
      }
      s_warp[wl] = v;
    }
    __syncthreads();
    int64_t pos = start + (w > 0 ? s_warp[w - 1] : 0) + x - mine;
    for (int64_t j = j0; j < j1; ++j) {
      const int64_t c = bin[j];
      bin[j] = pos;
      pos += c;
    }
    if (t == 0) offsets[b] = start;
    start += s_warp[31];
    __syncthreads();  // s_warp is reused by the next bin
  }
  if (t == 0) offsets[nbins] = start;
}

// Each row's id at its tile's first position in its bin, plus the rows of
// the same bin before it in the tile (rows in order): a block a tile, a
// thread a row, 256 rows a round.
__global__ void __launch_bounds__(kThreads)
plan_scatter_kernel(const int64_t* ub, int64_t m, int tile_rows,
                    Thresholds th, const int64_t* tile_bins, int64_t* rows) {
  __shared__ int s_warp[kThreads / 32][kMaxBins + 1];
  __shared__ int64_t s_done[kMaxBins];  // rows of the bin in past rounds
  const int t = threadIdx.x, wl = t & 31, w = t >> 5;
  if (t < kMaxBins) s_done[t] = 0;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * tile_rows;
  for (int x0 = 0; x0 < tile_rows; x0 += kThreads) {
    const int64_t r = r0 + x0 + t;
    const bool valid = x0 + t < tile_rows && r < m;
    const int bin = valid ? bin_of(th, ub[r]) : kMaxBins;
    const unsigned same = __match_any_sync(kFullMask, bin);
    const int rank = __popc(same & ((1u << wl) - 1u));
    for (int x = wl; x <= kMaxBins; x += 32) s_warp[w][x] = 0;
    __syncwarp();
    if (rank == 0) s_warp[w][bin] = __popc(same);
    __syncthreads();
    if (valid) {
      int64_t pos = tile_bins[bin * static_cast<int64_t>(gridDim.x) +
                              blockIdx.x] + s_done[bin] + rank;
      for (int v = 0; v < w; ++v) pos += s_warp[v][bin];
      rows[pos] = r;
    }
    __syncthreads();
    if (t < th.nbins) {
      int round = 0;
      for (int v = 0; v < kThreads / 32; ++v) round += s_warp[v][t];
      s_done[t] += round;
    }
    __syncthreads();
  }
}

// `lanes`: a power of two from 1 to 32; `tile_rows`: a multiple of
// 256 / lanes; tile_bins holds nbins * ceil(m / tile_rows) int64.
template <typename I>
cudaError_t build_plan(const I* a_indptr, const I* a_indices,
                       const I* b_indptr, int64_t m, int lanes,
                       int tile_rows, const int64_t* u_max, int nbins,
                       int64_t* ub, int64_t* rows, int64_t* offsets,
                       int64_t* tile_bins, cudaStream_t stream) {
  if (nbins < 1 || nbins > kMaxBins || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0 || tile_rows < 1 ||
      tile_rows % (kThreads / lanes) != 0) {
    return cudaErrorInvalidValue;
  }
  Thresholds th{};
  th.nbins = nbins;
  for (int b = 0; b + 1 < nbins; ++b) th.u_max[b] = u_max[b];
  const int64_t tiles = (m + tile_rows - 1) / tile_rows;
  if (tiles > 0) {
    plan_count_kernel<I><<<static_cast<unsigned>(tiles), kThreads, 0,
                           stream>>>(a_indptr, a_indices, b_indptr, m, lanes,
                                     tile_rows, th, ub, tile_bins);
  }
  plan_scan_kernel<<<1, 1024, 0, stream>>>(tile_bins, tiles, nbins, offsets);
  if (tiles > 0) {
    plan_scatter_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                          stream>>>(ub, m, tile_rows, th, tile_bins, rows);
  }
  return cudaGetLastError();
}

// Launches every bin of `bins` ((kind, slots, rows) rows in host memory;
// rows bounds the bin's rows, to size its grid: m where it is not known).
// A bin whose kind is kSkip launches nothing.  A batch's kDenseGlobal
// workspace holds work_groups rows for each member.
template <typename T, typename I, bool FILL, bool BATCH>
cudaError_t launch_bins(const Args<T, I>& args, const int64_t* bins,
                        int nbins, unsigned char* work, int64_t work_groups,
                        const Batch& batch, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  for (int b = 0; b < nbins; ++b) {
    const int64_t kind = bins[3 * b];
    const int64_t slots = bins[3 * b + 1];
    const int64_t rows = bins[3 * b + 2];
    switch (kind) {
      case kSkip:
        err = cudaSuccess;
        break;
      case kTiny4: {  // launches kTiny4 .. kTiny32, which must follow it
        int64_t most = rows;
        for (int t = 1; t < 4; ++t) {
          if (b + t >= nbins || bins[3 * (b + t)] != kTiny4 + t) {
            return cudaErrorInvalidValue;
          }
          const int64_t r = bins[3 * (b + t) + 2];
          most = r > most ? r : most;
        }
        if (args.n < kNarrowKeyColumns) {
          err = launch_tiny<T, I, uint32_t, FILL, BATCH>(
              args, b, most, device, sms, batch, stream);
        } else {
          err = launch_tiny<T, I, uint64_t, FILL, BATCH>(
              args, b, most, device, sms, batch, stream);
        }
        break;
      }
      case kTiny8:
      case kTiny16:
      case kTiny32:  // in kTiny4's launch
        if (b < 1 || bins[3 * (b - 1)] != kind - 1) {
          return cudaErrorInvalidValue;
        }
        err = cudaSuccess;
        break;
      case kHashWarp:
        err = launch_bin<T, I, kHash, 32, FILL, BATCH>(
            args, b, slots, rows, nullptr, 0, device, sms, batch, stream);
        break;
      case kHashBlock:
        err = launch_bin<T, I, kHash, kThreads, FILL, BATCH>(
            args, b, slots, rows, nullptr, 0, device, sms, batch, stream);
        break;
      case kDenseShared:
        err = launch_bin<T, I, kDense, kThreads, FILL, BATCH>(
            args, b, slots, rows, nullptr, 0, device, sms, batch, stream);
        break;
      case kDenseGlobal:
        if (work == nullptr || work_groups < 1) return cudaErrorInvalidValue;
        err = launch_bin<T, I, kDense, kThreads, FILL, BATCH>(
            args, b, slots, rows, work, work_groups, device, sms, batch,
            stream);
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
                  int nbins, int64_t n, int triangular, void* counts,
                  void* work, int64_t work_groups, const int64_t* u_max,
                  int64_t m, int lanes, int tile_rows, void* ub,
                  void* tile_bins, cudaStream_t stream) {
  if (u_max != nullptr) {
    const cudaError_t err = build_plan<I>(
        static_cast<const I*>(a_indptr), static_cast<const I*>(a_indices),
        static_cast<const I*>(b_indptr), m, lanes, tile_rows, u_max, nbins,
        static_cast<int64_t*>(ub),
        static_cast<int64_t*>(const_cast<void*>(rows)),
        static_cast<int64_t*>(const_cast<void*>(offsets)),
        static_cast<int64_t*>(tile_bins), stream);
    if (err != cudaSuccess) return err;
  }
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
  return launch_bins<float, I, false, false>(
      args, bins, nbins, static_cast<unsigned char*>(work), work_groups,
      Batch{1, Members{}}, stream);
}

template <typename T, typename I>
cudaError_t fill(const void* a_indptr, const void* a_indices,
                 const void* a_data, const void* b_indptr,
                 const void* b_indices, const void* b_data, const void* rows,
                 const void* offsets, const int64_t* bins, int nbins,
                 int64_t n, int triangular, const void* c_indptr,
                 void* c_indices, void* c_data, void* work,
                 int64_t work_groups, int64_t batch, int64_t s_a,
                 int64_t s_b, int64_t s_c, int write_indices,
                 cudaStream_t stream) {
  if (batch < 1 || batch > kMaxMembers || s_a < 0 || s_b < 0 || s_c < 0) {
    return cudaErrorInvalidValue;
  }
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
  auto* ws = static_cast<unsigned char*>(work);
  const Batch members{batch, Members{s_a, s_b, s_c, write_indices != 0}};
  // One member that writes C's ids is a single fill.
  if (batch == 1 && write_indices) {
    return launch_bins<T, I, true, false>(args, bins, nbins, ws, work_groups,
                                          members, stream);
  }
  return launch_bins<T, I, true, true>(args, bins, nbins, ws, work_groups,
                                       members, stream);
}

}  // namespace
}  // namespace sdt

// With `u_max` (host, the u_max of every bin but the last) K4 first
// builds the plan: ub (m), rows (m), offsets (nbins + 1), `lanes` lanes a
// row in tiles of `tile_rows` rows, with `tile_bins` (nbins *
// ceil(m / tile_rows) int64) as scratch.
extern "C" int sdt_csr_spgemm_count(int itype, const void* a_indptr,
                                    const void* a_indices,
                                    const void* b_indptr,
                                    const void* b_indices, const void* rows,
                                    const void* offsets, const void* bins,
                                    int nbins, int64_t n, int triangular,
                                    void* counts, void* work,
                                    int64_t work_groups, const void* u_max,
                                    int64_t m, int lanes, int tile_rows,
                                    void* ub, void* tile_bins,
                                    void* stream) {
  const auto* b = static_cast<const int64_t*>(bins);
  const auto* u = static_cast<const int64_t*>(u_max);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (itype) {
    case sdt::kI32:
      return sdt::count<int32_t>(a_indptr, a_indices, b_indptr, b_indices,
                                 rows, offsets, b, nbins, n, triangular,
                                 counts, work, work_groups, u, m, lanes,
                                 tile_rows, ub, tile_bins, s);
    case sdt::kI64:
      return sdt::count<int64_t>(a_indptr, a_indices, b_indptr, b_indices,
                                 rows, offsets, b, nbins, n, triangular,
                                 counts, work, work_groups, u, m, lanes,
                                 tile_rows, ub, tile_bins, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// batch members (at most kMaxMembers, grid.y's limit), op(A)'s, op(B)'s
// and C's values at their member strides in elements (0: shared), work
// holding work_groups rows for each member; write_indices: member 0
// writes C's column ids (0 for a later launch of the same batch).  batch 1
// with write_indices is one fill.
extern "C" int sdt_csr_spgemm_fill(
    int dtype, int itype, const void* a_indptr, const void* a_indices,
    const void* a_data, const void* b_indptr, const void* b_indices,
    const void* b_data, const void* rows, const void* offsets,
    const void* bins, int nbins, int64_t n, int triangular,
    const void* c_indptr, void* c_indices, void* c_data, void* work,
    int64_t work_groups, int64_t batch, int64_t s_a, int64_t s_b,
    int64_t s_c, int write_indices, void* stream) {
  SDT_DISPATCH(dtype, itype, sdt::fill, a_indptr, a_indices, a_data,
               b_indptr, b_indices, b_data, rows, offsets,
               static_cast<const int64_t*>(bins), nbins, n, triangular,
               c_indptr, c_indices, c_data, work, work_groups, batch, s_a,
               s_b, s_c, write_indices, static_cast<cudaStream_t>(stream))
}
