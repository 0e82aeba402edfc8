// K4's and K5's block-sorted bins (kSortedBlock): the kernel, its sort
// and its launches.  csr_spgemm.cu's notes say what the bins compute and
// how.  Each launch form's instances are built in a source of its own,
// so that nvcc builds them beside each other and beside csr_spgemm.cu's
// other bins: csr_spgemm_block.cu (K4 and a single fill),
// csr_spgemm_block_batched.cu (a batch, a member a block) and
// csr_spgemm_block_group2.cu / _group4.cu (a batch, 2 or 4 members a
// block).  launch_bins (csr_spgemm.cuh) hands them their launches as a
// BlockLaunch.
#pragma once

#include "csr_spgemm.cuh"

namespace sdt {
namespace {

// Rows of more than U / 4 and at most U products (U = 2048 or 8192, the
// bin's u_max), one block of kThreads threads a row, R = U / kThreads
// products a thread.  A key is (column << P) | product index with
// P = log2(U), of 32 bits when n < 2^(32 - P), else of 64; an empty
// position (no product, or a column below the diagonal with
// `triangular`) holds all ones.
constexpr int kBlockWarps = kThreads / 32;

__host__ __device__ constexpr int log2_of(int64_t v) {
  return v > 1 ? 1 + log2_of(v >> 1) : 0;
}

template <int U>
__host__ __device__ constexpr int64_t block_narrow_columns() {
  return int64_t(1) << (32 - log2_of(U));
}

// Bytes of one block's region in a block bin of U products.  K5: each
// product's op(A) and op(B) entries (I each), then U keys of up to 8
// bytes, exchanged across warps during the sort and then overwritten by
// the sorted order (16 bits a position); no member's values, so a group
// of members shares it.  K4: its table of up to 2 U columns.  Rounded up
// to 16.
template <typename I, bool FILL>
__host__ __device__ constexpr int64_t block_region_bytes(int64_t U) {
  const int64_t bytes =
      FILL ? U * (2 * int64_t(sizeof(I)) + 8) : 2 * U * int64_t(sizeof(I));
  return (bytes + 15) / 16 * 16;
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

// Inserts `key` into a linear-probing table of mask + 1 slots (empty =
// -1) if it is absent; true if this call inserted it.
template <typename I>
__device__ __forceinline__ bool table_insert(I* keys, int64_t mask, I key) {
  uint64_t h = static_cast<uint64_t>(key) * 0x9E3779B97F4A7C15ull;
  int64_t s = static_cast<int64_t>((h ^ (h >> 29)) & mask);
  for (;;) {
    const I cur = *reinterpret_cast<volatile I*>(keys + s);
    if (cur == key) return false;
    if (cur == I(-1)) {
      const I prev = cas(keys + s, I(-1), key);
      if (prev == I(-1)) return true;
      if (prev == key) return false;
    }
    s = (s + 1) & mask;
  }
}

// One compare-exchange stage of a bitonic network over a block's keys,
// a warp's 32 RR of them at positions base + 32 r + lane (r < RR): the
// pairs `stride` apart, ascending in the blocks of `size` positions whose
// (position & size) is 0.  Strides below 32 are between lanes
// (shuffles), wider ones between a lane's registers.
template <typename K, int RR, int RM>
__device__ __forceinline__ void bitonic_stage(K (&key)[RM], int base,
                                              int lane, int size,
                                              int stride) {
  if (stride >= 32) {
    const int rs = stride >> 5;
#pragma unroll
    for (int r = 0; r < RR; ++r) {
      if ((r & rs) == 0) {
        const bool up = ((base + (r << 5)) & size) == 0;
        const K a = key[r], b = key[r | rs];
        const K lo = a < b ? a : b, hi = a < b ? b : a;
        key[r] = up ? lo : hi;
        key[r | rs] = up ? hi : lo;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < RR; ++r) {
      const K other = __shfl_xor_sync(kFullMask, key[r], stride);
      const int e = base + (r << 5) + lane;
      const bool keep_min = ((e & stride) == 0) == ((e & size) == 0);
      key[r] = keep_min ? (other < key[r] ? other : key[r])
                        : (other > key[r] ? other : key[r]);
    }
  }
}

// Bitonic sort, ascending, of a block's kThreads RR keys, the first RR
// of each lane's RM registers, warp w's at positions 32 RR w + 32 r +
// lane.  Each size's strides that cross warps (sizes past 32 RR) go
// through shared memory (`xs`, kThreads RR keys: stored once, each
// stage's pairs compared and swapped in place by the block, a block sync
// a stage), the rest between a lane's registers and between lanes.  A
// register stage's code depends on its stride alone, so the sizes are a
// loop, not unrolled, over one unrolled copy of the register strides:
// log2(32 RR) stages of code where the unrolled network has about
// (log2(32 RR))^2 / 2 plus log2(32 RR) for each size that crosses warps.
// Every thread of the block must call it.
template <typename K, int RR, int RM>
__device__ __forceinline__ void sort_block_keys(K (&key)[RM], K* xs,
                                                int lane, int warp) {
  const int base = warp * 32 * RR;
#pragma unroll 1
  for (int size = 2; size <= kThreads * RR; size <<= 1) {
    if (size > 32 * RR) {
      if (size > 64 * RR) __syncthreads();  // the last size's reads are done
#pragma unroll
      for (int r = 0; r < RR; ++r) xs[base + (r << 5) + lane] = key[r];
      __syncthreads();
      for (int stride = size >> 1; stride >= 32 * RR; stride >>= 1) {
#pragma unroll
        for (int j = 0; j < RR / 2; ++j) {
          const int t = static_cast<int>(threadIdx.x) + kThreads * j;
          const int lo = 2 * t - (t & (stride - 1));
          const int hi = lo + stride;
          const bool up = (lo & size) == 0;
          const K a = xs[lo], b = xs[hi];
          if ((a > b) == up) {
            xs[lo] = b;
            xs[hi] = a;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < RR; ++r) key[r] = xs[base + (r << 5) + lane];
    }
#pragma unroll
    for (int stride = 16 * RR; stride > 0; stride >>= 1) {
      if (stride < size) bitonic_stage<K, RR>(key, base, lane, size, stride);
    }
  }
}

// K5's end of row i in a block bin, its keys made from the columns `col`
// of its products (the first RR of each thread's RM rounds: kThreads RR
// keys, at or above its products): the sort, the heads (a live key whose
// column differs from the key before it, across warps through `last`),
// the sorted order written over the keys' exchange space, and each head
// folds its column's run (up to the next head or the first empty
// position, in whichever warp's part) from zero in product order,
// reading each product's values through its staged entries (`ids`:
// op(A)'s at [pid], op(B)'s at [U + pid]), and stores the column and the
// sum at C's row start plus the heads before it.
template <typename T, typename I, typename K, int U, int RR, int RM,
          bool BATCH, int M>
__device__ __forceinline__ void block_finish(
    const Args<T, I>& args, int64_t i, const I (&col)[RM], const I* ids,
    K* xs, uint64_t* last, int* heads_of, const Group<M>& gr) {
  constexpr K kNoKey = ~K(0);
  constexpr int P = log2_of(U);
  constexpr K kPid = (K(1) << P) - 1;
  constexpr int N = kThreads * RR;  // positions sorted
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  K key[RM];
#pragma unroll
  for (int t = 0; t < RM; ++t) {
    const bool live =
        t < RR && col[t] >= 0 && (!args.triangular || col[t] >= i);
    key[t] = live ? (static_cast<K>(col[t]) << P) |
                        static_cast<K>(kThreads * t + tid)
                  : kNoKey;
  }
  sort_block_keys<K, RR>(key, xs, lane, warp);
  if (lane == 31) last[warp] = key[RR - 1];
  __syncthreads();  // every read of xs is done, `last` written
  bool head[RR];
  unsigned heads[RR];
  int count = 0;
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    const K up = __shfl_up_sync(kFullMask, key[r], 1);
    const K wrap = __shfl_sync(kFullMask, key[r > 0 ? r - 1 : 0], 31);
    K prev = lane > 0 ? up : wrap;
    if (r == 0 && lane == 0) {
      prev = warp > 0 ? static_cast<K>(last[warp - 1]) : kNoKey;
    }
    head[r] = key[r] != kNoKey && (prev == kNoKey ||
                                   (prev >> P) != (key[r] >> P));
    heads[r] = __ballot_sync(kFullMask, head[r]);
    count += __popc(heads[r]);
  }
  const int base = warp * 32 * RR;
  uint16_t* order = reinterpret_cast<uint16_t*>(xs);
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    order[base + (r << 5) + lane] =
        key[r] == kNoKey
            ? kNoProduct
            : static_cast<uint16_t>((key[r] & kPid) |
                                    (head[r] ? kRunHead : 0));
  }
  if (lane == 0) heads_of[warp] = count;
  __syncthreads();  // the order and every warp's heads are written
  int64_t before = args.c_indptr[i];
#pragma unroll
  for (int w = 0; w < kBlockWarps; ++w) {
    before += w < warp ? heads_of[w] : 0;
  }
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    if (head[r]) {
      const int64_t pos = before + __popc(heads[r] & below);
      T acc[M];
#pragma unroll
      for (int w = 0; w < M; ++w) acc[w] = Arith<T>::zero();
      int pid = static_cast<int>(key[r] & kPid);
      for (int e = base + (r << 5) + lane;;) {
        const int64_t pa = ids[pid], q = ids[U + pid];
#pragma unroll
        for (int w = 0; w < M; ++w) {
          acc[w] = Arith<T>::fma(args.a_data[pa + gr.a[w]],
                                 args.b_data[q + gr.b[w]], acc[w]);
        }
        if (++e >= N) break;
        const int next = order[e];
        if (next & kRunHead) break;
        pid = next;
      }
      if (!BATCH || args.c_indices != nullptr) {
        store_streaming(args.c_indices + pos, static_cast<I>(key[r] >> P));
      }
#pragma unroll
      for (int w = 0; w < M; ++w) {
        if (M > 1 && w >= gr.count) break;
        store_streaming(args.c_data + gr.c[w] + pos, acc[w]);
      }
    }
    before += __popc(heads[r]);
  }
}

// K4's count of row i in a block bin: the columns of the row's ub
// products (R a thread, in `col`) inserted into a table of pow2(2 ub)
// slots (`table`, only those cleared first) by linear probing; the fresh
// inserts are the distinct columns.  The heads of K5's sort counted them
// more slowly (compare_k7_k13.py block, PERF.md).
template <typename I, int R>
__device__ __forceinline__ void block_count_by_table(
    const Args<float, I>& args, int64_t i, int ub, const I (&col)[R],
    I* table, int* heads_of) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t S = ub > 1 ? int64_t(1) << (33 - __clz(ub - 1)) : 2;
  for (int64_t s = tid; s < S; s += kThreads) table[s] = I(-1);
  __syncthreads();
  int fresh = 0;
#pragma unroll
  for (int t = 0; t < R; ++t) {
    if (col[t] >= 0 && (!args.triangular || col[t] >= i)) {
      fresh += table_insert(table, S - 1, col[t]);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    fresh += __shfl_xor_sync(kFullMask, fresh, d);
  }
  if (lane == 0) heads_of[warp] = fresh;
  __syncthreads();  // every insert is done
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kBlockWarps; ++w) total += heads_of[w];
    store_streaming(args.counts + i, static_cast<int64_t>(total));
  }
}

// The rows of block bin `bin`, one a block at a time.  The block takes
// the row's op(A) entries kThreads at a time, scans their op(B) row
// lengths across the block (the count carried across chunks), and puts
// product t = kThreads r + tid on thread tid (round r), its op(B) entry
// found by a binary search of the scan in shared memory: products in
// op(A)'s stored order and then op(B)'s, no thread waiting on a short
// op(B) row and no block sync an op(A) entry (spgemm_sorted_kernel's walk
// over a block).  A thread keeps each of its products' column in a
// register and K5 stages its entries in the block's region; then K5 sorts
// pow2 of the row's products (U / 2 or U) keys (block_finish), or K4
// counts by a table (block_count_by_table).  The next row id is loaded
// one row ahead.  With BATCH, blockIdx.y is the member, or with M > 1 the
// group of M members.
template <typename T, typename I, typename K, int U, bool FILL, bool BATCH,
          int M = 1>
__global__ void __launch_bounds__(kThreads)
spgemm_block_kernel(Args<T, I> args, int bin, const Members mb) {
  static_assert(FILL || !BATCH, "a batch is K5's alone");
  static_assert(M == 1 || BATCH, "a group of members is a batch");
  static_assert(U % (2 * kThreads) == 0 && U < int(kRunHead), "U products");
  constexpr int R = U / kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_excl[kThreads];
  __shared__ I s_start[kThreads];
  __shared__ int s_sums[kBlockWarps];
  __shared__ int s_heads[kBlockWarps];
  __shared__ uint64_t s_last[kBlockWarps];
  unsigned char* work = nullptr;  // the regions are in shared memory
  SDT_K5_TO_MEMBER(0)
  const Group<M> gr = group_of<M>(mb);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  I* ids = reinterpret_cast<I*>(smem);  // K5's staged entries
  K* xs = reinterpret_cast<K*>(smem + 2 * U * sizeof(I));
  const int64_t r_end = args.offsets[bin + 1];
  int64_t r = args.offsets[bin] + blockIdx.x;
  int64_t i_next = r < r_end ? args.rows[r] : 0;
  for (; r < r_end; r += gridDim.x) {
    const int64_t i = i_next;
    if (r + gridDim.x < r_end) i_next = args.rows[r + gridDim.x];
    const int64_t p0 = args.a_indptr[i], p1 = args.a_indptr[i + 1];
    I col[R];  // the column of the thread's product of each round
#pragma unroll
    for (int t = 0; t < R; ++t) col[t] = I(-1);
    int carry = 0;  // products of the entries before this chunk
    for (int64_t c = p0; c < p1; c += kThreads) {
      const int64_t p = c + tid;
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
      if (lane == 31) s_sums[warp] = incl;
      __syncthreads();
      int below = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kBlockWarps; ++w) {
        const int x = s_sums[w];
        below += w < warp ? x : 0;
        total += x;
      }
      s_excl[tid] = below + incl - len;
      s_start[tid] = start;
      __syncthreads();
#pragma unroll
      for (int t = 0; t < R; ++t) {
        // The last entry whose products start at or before the thread's
        // product u of this chunk holds it.
        const int u = kThreads * t + tid - carry;
        if (u >= 0 && u < total) {
          int s = 0;
#pragma unroll
          for (int step = kThreads / 2; step > 0; step >>= 1) {
            if (s_excl[s + step] <= u) s += step;
          }
          const int64_t q = static_cast<int64_t>(s_start[s]) + u - s_excl[s];
          col[t] = args.b_indices[q];
          if constexpr (FILL) {
            ids[kThreads * t + tid] = static_cast<I>(c + s);
            ids[U + kThreads * t + tid] = static_cast<I>(q);
          }
        }
      }
      carry += total;
    }
    if constexpr (!FILL) {
      block_count_by_table<I, R>(args, i, carry, col,
                                 reinterpret_cast<I*>(smem), s_heads);
    } else {
      // pow2(ub) keys: U / 2 or U.
      if (carry <= U / 2) {
        block_finish<T, I, K, U, R / 2, R, BATCH, M>(
            args, i, col, ids, xs, s_last, s_heads, gr);
      } else {
        block_finish<T, I, K, U, R, R, BATCH, M>(args, i, col, ids, xs,
                                                 s_last, s_heads, gr);
      }
      __syncthreads();  // the next row rewrites the region
    }
  }
}

template <typename T, typename I, typename K, int U, bool FILL, bool BATCH,
          int M>
cudaError_t launch_block_as(const Args<T, I>& args, int bin, int64_t rows,
                            int device, int sms, const Batch& batch,
                            cudaStream_t stream) {
  auto kernel = spgemm_block_kernel<T, I, K, U, FILL, BATCH, M>;
  const size_t shared = static_cast<size_t>(block_region_bytes<I, FILL>(U));
  int per_sm = 0;
  const cudaError_t err = blocks_per_sm(kernel, shared, device, &per_sm);
  if (err != cudaSuccess) return err;
  const int64_t groups = groups_of<M>(batch);
  const int64_t grid = grid_for(rows, 1, per_sm, sms, groups);
  kernel<<<dim3(static_cast<unsigned>(grid), static_cast<unsigned>(groups)),
           kThreads, shared, stream>>>(args, bin, batch.mb);
  return cudaGetLastError();
}

// A block bin's launch (`launch`, its Args<T, I> and Batch) at U
// products a row, its keys of 32 bits when n < 2^(32 - log2 U); K4 keeps
// no keys, so it has the one instance.
template <typename T, typename I, int U, bool FILL, bool BATCH, int M>
cudaError_t run_block_at(const BlockLaunch& launch) {
  const auto& args = *static_cast<const Args<T, I>*>(launch.args);
  const auto& batch = *static_cast<const Batch*>(launch.batch);
  if constexpr (FILL) {
    if (args.n >= block_narrow_columns<U>()) {
      return launch_block_as<T, I, uint64_t, U, FILL, BATCH, M>(
          args, launch.bin, launch.rows, launch.device, launch.sms, batch,
          launch.stream);
    }
  }
  return launch_block_as<T, I, uint32_t, U, FILL, BATCH, M>(
      args, launch.bin, launch.rows, launch.device, launch.sms, batch,
      launch.stream);
}

// A block bin's launch, of launch.products (2048 or 8192) a row.
template <typename T, typename I, bool FILL, bool BATCH, int M>
cudaError_t run_block(const BlockLaunch& launch) {
  if (launch.products == 2048) {
    return run_block_at<T, I, 2048, FILL, BATCH, M>(launch);
  }
  if (launch.products == 8192) {
    return run_block_at<T, I, 8192, FILL, BATCH, M>(launch);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace sdt
