// K4's and K5's row kernels and their launches, shared by csr_spgemm.cu
// (K4, the plan, and K5 for one product or a batch a member a block) and
// csr_spgemm_group.cu (K5 for a batch, M members a block).  The notes at
// the top of csr_spgemm.cu say what they compute and how; this header
// holds the code, so that nvcc builds the two sources' instances side by
// side.
//
// M, the members a group of threads serves, is 1 for a single fill, for
// K4 and for the per-member batch.  With M > 1 blockIdx.y is a group of M
// consecutive members, which share everything that depends on the
// patterns alone: in the register bins (tiny_bin) the row id, op(A)'s
// indptr and entries, op(B)'s indptr, the scan and search, op(B)'s column
// ids, the bitonic sort and the head ballot are done once, and then each
// member's a_data / b_data loads (at its stride; a shared operand reads
// one address), the shuffles by the same source lanes, the fold in the
// same product order and its value store; in the sorted-product bins
// (spgemm_sorted_kernel) the keys, the staged product entries and the
// sort serve the group and each member's fold reads its own values
// through the entries; in
// the hash-block and dense-shared bins one table of keys (or flags)
// serves M value slots a key.  Each member's values are its single
// fill's bits.  A part-full last group's missing members read the last
// member's values and store nothing.  The dense rows in the device
// workspace keep one member a block (M = 1).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace sdt {
namespace {

// Codes shared with ops/spgemm.py.
enum BinKind : int64_t {
  kSkip = 0,
  kSortedWarp = 1,
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
// in elements (0: shared), whether member 0 writes C's column ids (a
// later launch of the same batch does not write them again), and the
// launch's members (read only with M > 1).
struct Members {
  int64_t a, b, c;
  bool indices;
  int64_t size;
};

// A group of M members' offsets from the group's first member, in
// elements, of op(A)'s, op(B)'s and C's values, and how many of the M
// are members (the last group may be part full; the missing ones read
// the last member's values and store nothing).
template <int M>
struct Group {
  int count;
  int64_t a[M], b[M], c[M];
};

// The group of blockIdx.y (M > 1), or member 0 alone (M == 1: offsets 0).
template <int M>
__device__ __forceinline__ Group<M> group_of(const Members& mb) {
  Group<M> gr;
  gr.count = 1;
#pragma unroll
  for (int i = 0; i < M; ++i) gr.a[i] = gr.b[i] = gr.c[i] = 0;
  if constexpr (M > 1) {
    const int64_t left = mb.size - static_cast<int64_t>(blockIdx.y) * M;
    gr.count = static_cast<int>(left < M ? left : M);
#pragma unroll
    for (int i = 1; i < M; ++i) {
      const int64_t at = i < gr.count ? i : gr.count - 1;
      gr.a[i] = at * mb.a;
      gr.b[i] = at * mb.b;
      gr.c[i] = at * mb.c;
    }
  }
  return gr;
}

// Moves args and work to member blockIdx.y of a batch (BATCH, K5 only),
// or with M > 1 to the first member of group blockIdx.y: its values, and
// its groups' workspace rows past the `stride` bytes of each member
// before it.  C's column ids stay with member 0.
#define SDT_K5_TO_MEMBER(stride)                         \
  if constexpr (BATCH) {                                 \
    const int64_t z = static_cast<int64_t>(blockIdx.y) * M; \
    args.a_data += z * mb.a;                             \
    args.b_data += z * mb.b;                             \
    args.c_data += z * mb.c;                             \
    if (z != 0 || !mb.indices) args.c_indices = nullptr; \
    if (work != nullptr) work += z * (stride);           \
  }

// Exclusive prefix sum of v over the block's G threads; *total receives
// the block's sum.  Every thread of the block must call it.
template <int G>
__device__ __forceinline__ int group_scan(int v, int* scratch, int* total) {
  const int wl = threadIdx.x & 31;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, d);
    if (wl >= d) x += y;
  }
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
// (-1, largest as unsigned) last: a bitonic network over the block's G
// threads.  With M > 1, vals holds M members' values of S slots each,
// moved with their keys.
template <typename T, typename I, int G, int M = 1>
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
#pragma unroll
          for (int i = 0; i < M; ++i) {
            const T va = vals[i * S + lo];
            vals[i * S + lo] = vals[i * S + hi];
            vals[i * S + hi] = va;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Bytes of one group's accumulator: values (K5 only; M members' with
// M > 1), then the hash keys or the dense row's flag bytes; rounded up to
// 16.
template <typename T, typename I, int MODE, bool FILL, int M = 1>
__host__ __device__ int64_t region_bytes(int64_t slots) {
  const int64_t tail = MODE == kHash ? slots * int64_t(sizeof(I)) : slots;
  const int64_t bytes = (FILL ? M * slots * int64_t(sizeof(T)) : 0) + tail;
  return (bytes + 15) / 16 * 16;
}

// A block (G = kThreads threads) builds one row of C at a time, walking
// the rows of bin `bin`.  `slots` is the hash table's size, or n for a
// dense row; `work` (kDenseGlobal) holds one region per group (per
// member's group with BATCH, blockIdx.y the member), else the regions are
// in dynamic shared memory.  With M > 1 (a batch, regions in shared
// memory), blockIdx.y is a group of M members whose values share the
// row's keys or flags.
template <typename T, typename I, int MODE, int G, bool FILL, bool BATCH,
          int M = 1>
__global__ void __launch_bounds__(kThreads)
spgemm_rows_kernel(Args<T, I> args, int bin, int64_t slots,
                   unsigned char* work, const Members mb) {
  static_assert(FILL || !BATCH, "a batch is K5's alone");
  static_assert(M == 1 || BATCH, "a group of members is a batch");
  static_assert(G == kThreads, "a block a row: the syncs are the block's");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int scratch[kThreads / 32];
  constexpr int kGroups = kThreads / G;
  const int lane = threadIdx.x % G;
  const int64_t gid =
      static_cast<int64_t>(blockIdx.x) * kGroups + threadIdx.x / G;
  const int64_t ngroups = static_cast<int64_t>(gridDim.x) * kGroups;
  const int64_t region = region_bytes<T, I, MODE, FILL, M>(slots);
  SDT_K5_TO_MEMBER(ngroups * region)
  const Group<M> gr = group_of<M>(mb);
  unsigned char* base = work != nullptr
                            ? work + gid * region
                            : smem + (threadIdx.x / G) * region;
  T* vals = reinterpret_cast<T*>(base);
  unsigned char* tail = base + (FILL ? M * slots * int64_t(sizeof(T)) : 0);
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
      if constexpr (FILL) {
#pragma unroll
        for (int w = 0; w < M; ++w) vals[w * S + s] = Arith<T>::zero();
      }
    }
    __syncthreads();

    int fresh = 0;
    const int64_t p_end = args.a_indptr[i + 1];
    for (int64_t p = args.a_indptr[i]; p < p_end; ++p) {
      const int64_t k = args.a_indices[p];
      const int64_t q_end = args.b_indptr[k + 1];
      T av[M];
      if constexpr (FILL) {
#pragma unroll
        for (int w = 0; w < M; ++w) av[w] = args.a_data[p + gr.a[w]];
      }
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
#pragma unroll
          for (int w = 0; w < M; ++w) {
            vals[w * S + slot] = Arith<T>::fma(
                av[w], args.b_data[q + gr.b[w]], vals[w * S + slot]);
          }
        }
      }
      __syncthreads();
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
#pragma unroll
          for (int w = 0; w < M; ++w) {
            if (M > 1 && w >= gr.count) break;
            args.c_data[gr.c[w] + out + pos] = vals[w * S + j];
          }
        }
        out += total;
      }
    } else {
      sort_table<T, I, G, M>(keys, vals, S, lane);
      const int64_t c0 = args.c_indptr[i];
      const int64_t cnt = args.c_indptr[i + 1] - c0;
      for (int64_t t = lane; t < cnt; t += G) {
        if (!BATCH || args.c_indices != nullptr) {
          args.c_indices[c0 + t] = keys[t];
        }
#pragma unroll
        for (int w = 0; w < M; ++w) {
          if (M > 1 && w >= gr.count) break;
          args.c_data[gr.c[w] + c0 + t] = vals[w * S + t];
        }
      }
    }
    __syncthreads();
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
// With BATCH, args.c_indices is null where this member writes no ids;
// with M > 1 the structural work serves the M members of `gr`.
template <typename T, typename I, typename K, int G, bool FILL, bool BATCH,
          int M>
__device__ __forceinline__ void tiny_bin(const Args<T, I>& args, int bin,
                                         int64_t warp, int64_t nwarps,
                                         const Group<M>& gr) {
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
    // The product's values, of each member of the group with M > 1.
    T av = Arith<T>::zero(), bv = Arith<T>::zero();
    T avs[M], bvs[M];
    if constexpr (M > 1) {
#pragma unroll
      for (int w = 0; w < M; ++w) avs[w] = bvs[w] = Arith<T>::zero();
    }
    if (q >= 0) {
      const int64_t j = args.b_indices[q];
      if (!args.triangular || j >= i) {
        key = (static_cast<K>(j) << 5) | static_cast<K>(lane);
      }
      if constexpr (FILL && M == 1) {
        av = args.a_data[pa];
        bv = args.b_data[q];
      } else if constexpr (FILL) {
#pragma unroll
        for (int w = 0; w < M; ++w) {
          avs[w] = args.a_data[pa + gr.a[w]];
          bvs[w] = args.b_data[q + gr.b[w]];
        }
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
    } else if constexpr (M == 1) {
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
    } else {
      // The same for each member of the group: its pair by the same
      // source lane, its fold in the same product order, its store.
      const int src = static_cast<int>(key & 31);
      T a[M], b[M];
#pragma unroll
      for (int w = 0; w < M; ++w) {
        a[w] = Arith<T>::shfl(avs[w], src, G);
        b[w] = Arith<T>::shfl(bvs[w], src, G);
      }
      const unsigned lives = __ballot_sync(kFullMask, live) & group;
      const unsigned above = heads & ~((2u << wl) - 1u);
      const int end = above ? __ffs(above) - 1
                            : (wl & ~(G - 1)) + __popc(lives);
      const int run = head ? end - wl : 0;
      T acc[M];
#pragma unroll
      for (int w = 0; w < M; ++w) {
        acc[w] = Arith<T>::fma(a[w], b[w], Arith<T>::zero());
      }
      for (int d = 1; __any_sync(kFullMask, d < run); ++d) {
#pragma unroll
        for (int w = 0; w < M; ++w) {
          const T an = Arith<T>::shfl(a[w], lane + d, G);
          const T bn = Arith<T>::shfl(b[w], lane + d, G);
          if (d < run) acc[w] = Arith<T>::fma(an, bn, acc[w]);
        }
      }
      if (head) {
        const int64_t pos = c0 + __popc(heads & ((1u << wl) - 1u));
        if (args.c_indices != nullptr) {
          store_streaming(args.c_indices + pos, static_cast<I>(key >> 5));
        }
#pragma unroll
        for (int w = 0; w < M; ++w) {
          if (w >= gr.count) break;
          store_streaming(args.c_data + gr.c[w] + pos, acc[w]);
        }
      }
    }
  }
}

// Blocks of 8 warps an SM the register bins' kernel asks registers for:
// latency bounds it, so registers are capped for many warps an SM: 6 for
// K4, 5 for K5 (at 6 it spills), 4 for complex double's wider values;
// a group of M members keeps 2 M values a lane more, and asks for fewer.
template <typename T, bool FILL, int M>
constexpr int tiny_blocks() {
  if (!FILL) return 6;
  const int one = sizeof(T) > 8 ? 4 : 5;
  return M == 1 ? one : (M == 2 ? one - 1 : one - 2);
}

// The four register bins, bin .. bin + 3 (G = 4, 8, 16, 32), in one
// persistent launch: every warp walks its share of each bin in turn.
// With BATCH, blockIdx.y is the member, or with M > 1 the group of M
// members.
template <typename T, typename I, typename K, bool FILL, bool BATCH,
          int M = 1>
__global__ void __launch_bounds__(kThreads, tiny_blocks<T, FILL, M>())
spgemm_tiny_kernel(Args<T, I> args, int bin, const Members mb) {
  static_assert(FILL || !BATCH, "a batch is K5's alone");
  static_assert(M == 1 || BATCH, "a group of members is a batch");
  unsigned char* work = nullptr;  // the register path has no workspace
  SDT_K5_TO_MEMBER(0)
  const Group<M> gr = group_of<M>(mb);
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  tiny_bin<T, I, K, 4, FILL, BATCH, M>(args, bin, warp, nwarps, gr);
  tiny_bin<T, I, K, 8, FILL, BATCH, M>(args, bin + 1, warp, nwarps, gr);
  tiny_bin<T, I, K, 16, FILL, BATCH, M>(args, bin + 2, warp, nwarps, gr);
  tiny_bin<T, I, K, 32, FILL, BATCH, M>(args, bin + 3, warp, nwarps, gr);
}

// The sorted-product bins (kSortedWarp): rows of more than 32 and at
// most U products (U = 128 or 512, the bin's u_max), one warp a row.  A
// key is (column << 9) | product index, of 32 bits when n < 2^23, else of
// 64; an empty position (no product, or a column below the diagonal with
// `triangular`) holds all ones, which sorts last and names no column.
constexpr int kProductBits = 9;
constexpr int kProductMask = (1 << kProductBits) - 1;
constexpr int64_t kSortedNarrowColumns = int64_t(1) << (32 - kProductBits);
// A sorted position's entry in K5's order: its product index, with
// kRunHead set where a column's run starts, kNoProduct past the live
// keys.
constexpr uint16_t kRunHead = 0x8000;
constexpr uint16_t kNoProduct = 0xFFFF;

// Bytes of one warp's region in a sorted-product bin of U products (K5
// only; K4 keeps its keys in registers and asks for none): each product's
// op(A) and op(B) entries (I each), then the sorted order (16 bits a
// position); rounded up to 16.  No member's values: a group of members
// shares the region.
template <typename I>
__host__ __device__ constexpr int64_t sorted_region_bytes(int64_t U) {
  return (U * (2 * int64_t(sizeof(I)) + 2) + 15) / 16 * 16;
}

// Bitonic sort, ascending, of a warp's 32 R keys, lane l's key r at
// position 32 r + l: strides below 32 between lanes (shuffles), wider
// ones between a lane's registers.  The array holds RM >= R keys.
template <typename K, int R, int RM>
__device__ __forceinline__ void sort_warp_keys(K (&key)[RM], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * R; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        const int rs = stride >> 5;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if ((r & rs) == 0) {
            const bool up = ((r << 5) & size) == 0;
            const K a = key[r], b = key[r | rs];
            const K lo = a < b ? a : b, hi = a < b ? b : a;
            key[r] = up ? lo : hi;
            key[r | rs] = up ? hi : lo;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const K other = __shfl_xor_sync(kFullMask, key[r], stride);
          const int e = (r << 5) | lane;
          const bool keep_min = ((e & stride) == 0) == ((e & size) == 0);
          key[r] = keep_min ? (other < key[r] ? other : key[r])
                            : (other > key[r] ? other : key[r]);
        }
      }
    }
  }
}

// Row i's end in a sorted-product bin, its keys in the first R of the RM
// registers a lane (32 R at or above its products): the sort, the heads
// (a live key whose column differs from the key before it), then K4
// stores their number, or K5 writes the sorted order to `order`, and each
// head folds its column's run (up to the next head or the first empty
// position) from zero in product order, reading each product's values
// through its staged entries (`ids`: op(A)'s at [pid], op(B)'s at
// [U + pid]), and stores the column and the sum at c0 plus the heads
// before it.
template <typename T, typename I, typename K, int U, int R, int RM,
          bool FILL, bool BATCH, int M>
__device__ __forceinline__ void sorted_finish(const Args<T, I>& args,
                                              int64_t i, int64_t c0,
                                              K (&key)[RM], const I* ids,
                                              uint16_t* order,
                                              const Group<M>& gr, int lane) {
  constexpr K kNoKey = ~K(0);
  sort_warp_keys<K, R>(key, lane);
  bool head[R];
  unsigned heads[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const K up = __shfl_up_sync(kFullMask, key[r], 1);
    const K wrap = __shfl_sync(kFullMask, key[r > 0 ? r - 1 : 0], 31);
    const K prev = lane > 0 ? up : wrap;
    head[r] = key[r] != kNoKey &&
              ((r == 0 && lane == 0) ||
               (prev >> kProductBits) != (key[r] >> kProductBits));
    heads[r] = __ballot_sync(kFullMask, head[r]);
  }
  if constexpr (!FILL) {
    if (lane == 0) {
      int total = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) total += __popc(heads[r]);
      store_streaming(args.counts + i, static_cast<int64_t>(total));
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      order[(r << 5) | lane] =
          key[r] == kNoKey
              ? kNoProduct
              : static_cast<uint16_t>((key[r] & kProductMask) |
                                      (head[r] ? kRunHead : 0));
    }
    __syncwarp();
    const unsigned below = (1u << lane) - 1u;
    int64_t before = c0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (head[r]) {
        const int64_t pos = before + __popc(heads[r] & below);
        T acc[M];
#pragma unroll
        for (int w = 0; w < M; ++w) acc[w] = Arith<T>::zero();
        int pid = static_cast<int>(key[r] & kProductMask);
        for (int e = (r << 5) | lane;;) {
          const int64_t pa = ids[pid], q = ids[U + pid];
#pragma unroll
          for (int w = 0; w < M; ++w) {
            acc[w] = Arith<T>::fma(args.a_data[pa + gr.a[w]],
                                   args.b_data[q + gr.b[w]], acc[w]);
          }
          if (++e >= 32 * R) break;
          const int next = order[e];
          if (next & kRunHead) break;
          pid = next;
        }
        if (!BATCH || args.c_indices != nullptr) {
          store_streaming(args.c_indices + pos,
                          static_cast<I>(key[r] >> kProductBits));
        }
#pragma unroll
        for (int w = 0; w < M; ++w) {
          if (M > 1 && w >= gr.count) break;
          store_streaming(args.c_data + gr.c[w] + pos, acc[w]);
        }
      }
      before += __popc(heads[r]);
    }
    __syncwarp();  // the warp's next row rewrites the region
  }
}

// The rows of sorted-product bin `bin`, one a warp at a time.  The warp
// takes the row's products 32 at a time (round r: products 32 r ..
// 32 r + 31, product t on lane t % 32), in op(A)'s stored order and then
// op(B)'s: op(A)'s entries are read 32 at a time, their op(B) row lengths
// scanned, and each lane's entry found by a binary search of the scan
// through shuffles, the count carried across chunks (tiny_bin's walk,
// its G = 32, over up to U / 32 rounds).  A lane keeps each of its
// products' column in a register and K5 stages its entries in the warp's
// region; the keys are sorted in registers, pow2 of the row's products
// (U / 2 or U) at once.  With BATCH, blockIdx.y is the member, or with
// M > 1 the group of M members.
template <typename T, typename I, typename K, int U, bool FILL, bool BATCH,
          int M = 1>
__global__ void __launch_bounds__(kThreads)
spgemm_sorted_kernel(Args<T, I> args, int bin, const Members mb) {
  static_assert(FILL || !BATCH, "a batch is K5's alone");
  static_assert(M == 1 || BATCH, "a group of members is a batch");
  static_assert(U % 64 == 0 && U <= (1 << kProductBits), "U products");
  constexpr int RM = U / 32;
  constexpr K kNoKey = ~K(0);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* work = nullptr;  // the regions are in shared memory
  SDT_K5_TO_MEMBER(0)
  const Group<M> gr = group_of<M>(mb);
  const int lane = threadIdx.x & 31;
  I* ids = reinterpret_cast<I*>(smem + (threadIdx.x >> 5) *
                                           sorted_region_bytes<I>(U));
  uint16_t* order = reinterpret_cast<uint16_t*>(ids + 2 * U);
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  const int64_t r_end = args.offsets[bin + 1];
  int64_t r = args.offsets[bin] +
              ((static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >>
               5);
  // The next row id is loaded one row ahead.
  int64_t i_next = r < r_end ? args.rows[r] : 0;
  for (; r < r_end; r += nwarps) {
    const int64_t i = i_next;
    if (r + nwarps < r_end) i_next = args.rows[r + nwarps];
    const int64_t p0 = args.a_indptr[i], p1 = args.a_indptr[i + 1];
    int64_t c0 = 0;
    if constexpr (FILL) c0 = args.c_indptr[i];
    I col[RM];  // the column of the lane's product of each round
#pragma unroll
    for (int t = 0; t < RM; ++t) col[t] = I(-1);
    int carry = 0;  // products of the entries before this chunk
    for (int64_t c = p0; c < p1; c += 32) {
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
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFullMask, incl, d);
        if (lane >= d) incl += y;
      }
      const int excl = incl - len;
      const int total = __shfl_sync(kFullMask, incl, 31);
#pragma unroll
      for (int t = 0; t < RM; ++t) {
        // Round t's products that this chunk holds (the same on every
        // lane): the last entry whose products start at or before the
        // lane's holds it.
        if (carry < 32 * (t + 1) && carry + total > 32 * t) {
          const int u = 32 * t + lane - carry;
          int s = 0;
#pragma unroll
          for (int step = 16; step > 0; step >>= 1) {
            if (__shfl_sync(kFullMask, excl, s + step) <= u) s += step;
          }
          const int64_t q =
              static_cast<int64_t>(__shfl_sync(kFullMask, start, s)) + u -
              __shfl_sync(kFullMask, excl, s);
          if (u >= 0 && u < total) {
            col[t] = args.b_indices[q];
            if constexpr (FILL) {
              ids[32 * t + lane] = static_cast<I>(c + s);
              ids[U + 32 * t + lane] = static_cast<I>(q);
            }
          }
        }
      }
      carry += total;
    }
    K key[RM];
#pragma unroll
    for (int t = 0; t < RM; ++t) {
      const bool live = col[t] >= 0 && (!args.triangular || col[t] >= i);
      key[t] = live ? (static_cast<K>(col[t]) << kProductBits) |
                          static_cast<K>(32 * t + lane)
                    : kNoKey;
    }
    // pow2(ub) keys: U / 2 or U.  Sorting U keys in the bin of 512 alone
    // (one network a kernel) ran faster where nearly every row held
    // 129-512 products, and slower in K4, K5 and their batch at a
    // 100,000^2 Poisson(10) A @ A (PERF.md).
    if (carry <= 16 * RM) {
      sorted_finish<T, I, K, U, RM / 2, RM, FILL, BATCH, M>(
          args, i, c0, key, ids, order, gr, lane);
    } else {
      sorted_finish<T, I, K, U, RM, RM, FILL, BATCH, M>(
          args, i, c0, key, ids, order, gr, lane);
    }
  }
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

// The blocks along grid.y: the members, or their groups of M.
template <int M>
inline int64_t groups_of(const Batch& batch) {
  return (batch.size + M - 1) / M;
}

template <typename T, typename I, typename K, bool FILL, bool BATCH, int M>
cudaError_t launch_tiny(const Args<T, I>& args, int bin, int64_t rows,
                        int device, int sms, const Batch& batch,
                        cudaStream_t stream) {
  auto kernel = spgemm_tiny_kernel<T, I, K, FILL, BATCH, M>;
  int per_sm = 0;
  cudaError_t err = blocks_per_sm(kernel, 0, device, &per_sm);
  if (err != cudaSuccess) return err;
  // A block holds at least 8 rows at once (G = 32).
  const int64_t groups = groups_of<M>(batch);
  const int64_t grid = grid_for(rows, kThreads / 32, per_sm, sms, groups);
  kernel<<<dim3(static_cast<unsigned>(grid), static_cast<unsigned>(groups)),
           kThreads, 0, stream>>>(args, bin, batch.mb);
  return cudaGetLastError();
}

template <typename T, typename I, typename K, int U, bool FILL, bool BATCH,
          int M>
cudaError_t launch_sorted_as(const Args<T, I>& args, int bin, int64_t rows,
                             int device, int sms, const Batch& batch,
                             cudaStream_t stream) {
  auto kernel = spgemm_sorted_kernel<T, I, K, U, FILL, BATCH, M>;
  const size_t shared =
      FILL ? static_cast<size_t>(sorted_region_bytes<I>(U)) * (kThreads / 32)
           : 0;
  int per_sm = 0;
  const cudaError_t err = blocks_per_sm(kernel, shared, device, &per_sm);
  if (err != cudaSuccess) return err;
  const int64_t groups = groups_of<M>(batch);
  const int64_t grid = grid_for(rows, kThreads / 32, per_sm, sms, groups);
  kernel<<<dim3(static_cast<unsigned>(grid), static_cast<unsigned>(groups)),
           kThreads, shared, stream>>>(args, bin, batch.mb);
  return cudaGetLastError();
}

// A sorted-product bin of `products` (128 or 512) a row, its keys of 32
// bits when n < 2^23.
template <typename T, typename I, bool FILL, bool BATCH, int M>
cudaError_t launch_sorted(const Args<T, I>& args, int bin, int64_t products,
                          int64_t rows, int device, int sms,
                          const Batch& batch, cudaStream_t stream) {
  const bool narrow = args.n < kSortedNarrowColumns;
  if (products == 128) {
    return narrow ? launch_sorted_as<T, I, uint32_t, 128, FILL, BATCH, M>(
                        args, bin, rows, device, sms, batch, stream)
                  : launch_sorted_as<T, I, uint64_t, 128, FILL, BATCH, M>(
                        args, bin, rows, device, sms, batch, stream);
  }
  if (products == 512) {
    return narrow ? launch_sorted_as<T, I, uint32_t, 512, FILL, BATCH, M>(
                        args, bin, rows, device, sms, batch, stream)
                  : launch_sorted_as<T, I, uint64_t, 512, FILL, BATCH, M>(
                        args, bin, rows, device, sms, batch, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename I, int MODE, int G, bool FILL, bool BATCH,
          int M>
cudaError_t launch_bin(const Args<T, I>& args, int bin, int64_t slots,
                       int64_t rows, unsigned char* work, int64_t work_groups,
                       int device, int sms, const Batch& batch,
                       cudaStream_t stream) {
  auto kernel = spgemm_rows_kernel<T, I, MODE, G, FILL, BATCH, M>;
  constexpr int kGroups = kThreads / G;
  const int64_t groups = groups_of<M>(batch);
  int64_t grid = work_groups < 1 ? 1 : work_groups;
  size_t shared = 0;
  if (work == nullptr) {
    shared =
        static_cast<size_t>(region_bytes<T, I, MODE, FILL, M>(slots)) *
        kGroups;
    int per_sm = 0;
    const cudaError_t err = blocks_per_sm(kernel, shared, device, &per_sm);
    if (err != cudaSuccess) return err;
    grid = grid_for(rows, kGroups, per_sm, sms, groups);
  }
  kernel<<<dim3(static_cast<unsigned>(grid), static_cast<unsigned>(groups)),
           kThreads, shared, stream>>>(args, bin, slots, work, batch.mb);
  return cudaGetLastError();
}

// Launches every bin of `bins` ((kind, slots, rows) rows in host memory;
// rows bounds the bin's rows, to size its grid: m where it is not known).
// A bin whose kind is kSkip launches nothing.  A batch's kDenseGlobal
// workspace holds work_groups rows for each member; with M > 1 (groups of
// M members) every bin's accumulator is in registers or shared memory.
template <typename T, typename I, bool FILL, bool BATCH, int M = 1>
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
          err = launch_tiny<T, I, uint32_t, FILL, BATCH, M>(
              args, b, most, device, sms, batch, stream);
        } else {
          err = launch_tiny<T, I, uint64_t, FILL, BATCH, M>(
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
      case kSortedWarp:
        err = launch_sorted<T, I, FILL, BATCH, M>(args, b, slots, rows,
                                                  device, sms, batch, stream);
        break;
      case kHashBlock:
        err = launch_bin<T, I, kHash, kThreads, FILL, BATCH, M>(
            args, b, slots, rows, nullptr, 0, device, sms, batch, stream);
        break;
      case kDenseShared:
        err = launch_bin<T, I, kDense, kThreads, FILL, BATCH, M>(
            args, b, slots, rows, nullptr, 0, device, sms, batch, stream);
        break;
      case kDenseGlobal:
        if constexpr (M > 1) {
          return cudaErrorInvalidValue;
        } else {
          if (work == nullptr || work_groups < 1) return cudaErrorInvalidValue;
          err = launch_bin<T, I, kDense, kThreads, FILL, BATCH, 1>(
              args, b, slots, rows, work, work_groups, device, sms, batch,
              stream);
        }
        break;
      default:
        return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// K5's arguments as the C entry points take them.
template <typename T, typename I>
Args<T, I> fill_args(const void* a_indptr, const void* a_indices,
                     const void* a_data, const void* b_indptr,
                     const void* b_indices, const void* b_data,
                     const void* rows, const void* offsets, int64_t n,
                     int triangular, const void* c_indptr, void* c_indices,
                     void* c_data) {
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
  return args;
}

}  // namespace
}  // namespace sdt
