// K2's kernel, shared by csr_spmm.cu (one product, and a batch a member a
// block) and csr_spmm_group.cu (a batch whose members share B, M members
// a block).  The notes at the top of csr_spmm.cu say what it computes and
// how; this header holds the code, so that nvcc builds the two sources'
// instances side by side.
//
// M, the members a group of lanes serves, is 1 for a single product and
// for the per-member batch.  With M > 1 (B shared, stride 0) blockIdx.z
// is a group of M consecutive members: each lane loads an entry's index
// and its strip of B once, the M members' values at their stride, and
// keeps M sums; everything else (the lane mapping, the U-ahead pairs,
// the split of long rows and its chunk order, the epilogue) is the
// single kernel's, so each member's output has the bits of its single
// launch.  A part-full last group's missing members read the last
// member's values and store nothing.
#pragma once

#include <cstring>

#include "common.cuh"

namespace sdt {
namespace {

constexpr int kThreads = 128;
// Blocks that walk the chunks of split rows: one per SM of an H100.
constexpr int kChunkBlocks = 132;

// V adjacent values of a row of B or C: one 16-byte access when V > 1
// (V * sizeof(T) == 16).
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_vec(const T* __restrict__ p) {
  Vec<T, V> out;
  if constexpr (V > 1) {  // 16 bytes
    const int4 raw = __ldg(reinterpret_cast<const int4*>(p));
    memcpy(&out, &raw, 16);
  } else {
    out.v[0] = p[0];
  }
  return out;
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const Vec<T, V>& v) {
  if constexpr (V > 1) {  // 16 bytes
    int4 raw;
    memcpy(&raw, &v, 16);
    *reinterpret_cast<int4*>(p) = raw;
  } else {
    p[0] = v.v[0];
  }
}

// col[u], val[i][u] = the nonzero q0 + u * split, for those below p1, of
// member i (its values at data + at[i]).
template <typename T, typename I, int U, int M>
__device__ __forceinline__ void load_pairs(const I* __restrict__ indices,
                                           const T* __restrict__ data,
                                           const int64_t (&at)[M],
                                           int64_t q0, int64_t p1, int split,
                                           I (&col)[U], T (&val)[M][U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t q = q0 + static_cast<int64_t>(u) * split;
    if (q < p1) {
      col[u] = indices[q];
#pragma unroll
      for (int i = 0; i < M; ++i) val[i][u] = data[at[i] + q];
    }
  }
}

// acc[i] += the products of the nonzeros p0 + sub, p0 + sub + split, ...
// below p1 with the columns cols[] of their B rows, in nonzero order, for
// each member i of M.  A lane takes U of its nonzeros at a time, issues
// their B loads together, and loads the next U (index, value) pairs while
// they are in flight, so no B load waits on an index load.
template <typename T, typename I, int V, int PER, int U, int M>
__device__ __forceinline__ void accumulate(
    const I* __restrict__ indices, const T* __restrict__ data,
    const int64_t (&at)[M], const T* __restrict__ b, int64_t p0, int64_t p1,
    int sub, int split,
    const int64_t (&cols)[PER], int64_t n, T (&acc)[M][PER][V]) {
  using A = Arith<T>;
  const int64_t step = static_cast<int64_t>(split) * U;
  I col[U];
  T val[M][U];
  load_pairs<T, I, U, M>(indices, data, at, p0 + sub, p1, split, col, val);
  for (int64_t p = p0 + sub; p < p1; p += step) {
    Vec<T, V> bv[U][PER];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (p + static_cast<int64_t>(u) * split >= p1) continue;
      const T* __restrict__ row = b + static_cast<int64_t>(col[u]) * n;
#pragma unroll
      for (int s = 0; s < PER; ++s) {
        if (cols[s] < n) bv[u][s] = load_vec<T, V>(row + cols[s]);
      }
    }
    T v[M][U];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int u = 0; u < U; ++u) v[i][u] = val[i][u];
    load_pairs<T, I, U, M>(indices, data, at, p + step, p1, split, col,
                           val);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (p + static_cast<int64_t>(u) * split >= p1) continue;
#pragma unroll
      for (int s = 0; s < PER; ++s) {
        if (cols[s] >= n) continue;
#pragma unroll
        for (int i = 0; i < M; ++i)
#pragma unroll
          for (int e = 0; e < V; ++e) {
            acc[i][s][e] = A::fma(v[i][u], bv[u][s].v[e], acc[i][s][e]);
          }
      }
    }
  }
}

// The same for a row that a whole warp owns alone (lanes == 32, split ==
// 1, wide n): the warp loads 32 (index, value) pairs at a time, one a
// lane, and hands each to every lane by shuffles.  (Shuffling 4 at a time
// to issue their loads together took registers, and measured slower.)
template <typename T, typename I, int V, int PER, int M>
__device__ __forceinline__ void accumulate_warp(
    const I* __restrict__ indices, const T* __restrict__ data,
    const int64_t (&at)[M], const T* __restrict__ b, int64_t p0, int64_t p1,
    int lane,
    const int64_t (&cols)[PER], int64_t n, T (&acc)[M][PER][V]) {
  using A = Arith<T>;
  for (int64_t base = p0; base < p1; base += 32) {
    const int64_t q = base + lane;
    I my_col = 0;
    T my_val[M];
#pragma unroll
    for (int i = 0; i < M; ++i) my_val[i] = A::zero();
    if (q < p1) {
      my_col = indices[q];
#pragma unroll
      for (int i = 0; i < M; ++i) my_val[i] = data[at[i] + q];
    }
    const int cnt = static_cast<int>(p1 - base < 32 ? p1 - base : 32);
    for (int j = 0; j < cnt; ++j) {
      const int64_t col = __shfl_sync(kFullMask, my_col, j);
      T v[M];
#pragma unroll
      for (int i = 0; i < M; ++i) v[i] = A::shfl(my_val[i], j);
      const T* __restrict__ row = b + col * n;
#pragma unroll
      for (int s = 0; s < PER; ++s) {
        if (cols[s] >= n) continue;
        const Vec<T, V> bv = load_vec<T, V>(row + cols[s]);
#pragma unroll
        for (int i = 0; i < M; ++i)
#pragma unroll
          for (int e = 0; e < V; ++e) {
            acc[i][s][e] = A::fma(v[i], bv.v[e], acc[i][s][e]);
          }
      }
    }
  }
}

// Adds the sums of the split groups of a row (lanes l, l + lanes, ...) by
// shuffles in a fixed order; every lane of the row's group ends with it.
template <typename T, int V, int PER>
__device__ __forceinline__ void reduce_split(T (&acc)[PER][V], int lanes,
                                             int group, unsigned members) {
  using A = Arith<T>;
  for (int off = group / 2; off >= lanes; off >>= 1) {
#pragma unroll
    for (int s = 0; s < PER; ++s) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        acc[s][v] = A::add(acc[s][v], A::shfl_xor(acc[s][v], off, members));
      }
    }
  }
}

// Member strides, in elements, of a batched launch (0: shared), and the
// launch's members (read only by a group launch, M > 1).
struct Strides {
  int64_t data, b, c0, c;
  int64_t size;
};

// Blocks [0, chunk_blocks) walk the chunks of split rows into work; the
// others take one row per group of lanes * split lanes and write C.
// With BATCH, blockIdx.z is the member, or with M > 1 the group of M
// members from blockIdx.z * M (B shared).
template <typename T, typename I, int V, int PER, int U, bool WARP,
          bool BATCH, int M = 1>
__global__ void __launch_bounds__(kThreads)
csr_spmm_kernel(const I* __restrict__ indptr, const I* __restrict__ indices,
                const T* __restrict__ data, const T* __restrict__ b,
                const T* __restrict__ c0, T* __restrict__ c, T* work,
                unsigned* counts, const int64_t* __restrict__ chunks,
                int64_t n_chunks, int chunk_blocks, int64_t m, int64_t n,
                int64_t max_row, int lanes, int split, T alpha, T beta,
                bool scale, Strides st) {
  static_assert(M == 1 || BATCH, "a group of members is a batch");
  using A = Arith<T>;
  if constexpr (BATCH) {
    const int64_t z = static_cast<int64_t>(blockIdx.z) * M;
    data += z * st.data;
    b += z * st.b;
    if (c0 != nullptr) c0 += z * st.c0;
    c += z * st.c;
    if (n_chunks > 0) {
      work += z * n_chunks * n;
      counts += z * n_chunks;
    }
  }
  // Member i of the group: its values at data + od[i], C0 at c0 + oc0[i],
  // C at c + oc[i], partial rows at work + ow[i].
  int count = 1;
  int64_t od[M], oc0[M], oc[M], ow[M];
#pragma unroll
  for (int i = 0; i < M; ++i) od[i] = oc0[i] = oc[i] = ow[i] = 0;
  if constexpr (M > 1) {
    const int64_t left = st.size - static_cast<int64_t>(blockIdx.z) * M;
    count = static_cast<int>(left < M ? left : M);
#pragma unroll
    for (int i = 1; i < M; ++i) {
      const int64_t at = i < count ? i : count - 1;
      od[i] = at * st.data;
      oc0[i] = c0 == nullptr ? 0 : at * st.c0;
      oc[i] = at * st.c;
      ow[i] = at * n_chunks * n;
    }
  }
  const int group = lanes * split;
  const int per_block = kThreads / group;
  const int g = static_cast<int>(threadIdx.x) % group;
  const int sub = g / lanes;
  const int lane = threadIdx.x & 31;
  const unsigned members =
      group == 32 ? kFullMask
                  : ((1u << group) - 1u) << (lane & ~(group - 1));
  int64_t cols[PER];
#pragma unroll
  for (int s = 0; s < PER; ++s) {
    cols[s] = (static_cast<int64_t>(blockIdx.y) * PER * lanes + s * lanes +
               g % lanes) * V;
  }
  T acc[M][PER][V];

  if (static_cast<int>(blockIdx.x) < chunk_blocks) {
    // The chunks fill slots 0, 1, ... and padding follows the last one.
    for (int64_t item = static_cast<int64_t>(blockIdx.x) * per_block +
                        threadIdx.x / group;
         item < n_chunks;
         item += static_cast<int64_t>(chunk_blocks) * per_block) {
      const int64_t* it = chunks + 4 * item;
      if (it[0] < 0) break;
#pragma unroll
      for (int i = 0; i < M; ++i)
#pragma unroll
        for (int s = 0; s < PER; ++s)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[i][s][v] = A::zero();
      if constexpr (WARP) {
        accumulate_warp<T, I, V, PER, M>(indices, data, od, b, it[1], it[2],
                                         lane, cols, n, acc);
      } else {
        accumulate<T, I, V, PER, U, M>(indices, data, od, b, it[1], it[2],
                                       sub, split, cols, n, acc);
      }
#pragma unroll
      for (int i = 0; i < M; ++i) {
        reduce_split<T, V, PER>(acc[i], lanes, group, members);
      }
      if (sub == 0) {
#pragma unroll
        for (int i = 0; i < M; ++i) {
          if (M > 1 && i >= count) break;
#pragma unroll
          for (int s = 0; s < PER; ++s) {
            if (cols[s] >= n) continue;
            Vec<T, V> out;
#pragma unroll
            for (int v = 0; v < V; ++v) out.v[v] = acc[i][s][v];
            store_vec<T, V>(work + ow[i] + it[3] * n + cols[s], out);
          }
        }
      }
      // The group that finishes the last (chunk, strip) of the row adds
      // all the row's partial rows in chunk order; counts[first slot]
      // counts them and is set back to 0 for the next launch.
      const int64_t row = it[0];
      const int64_t start = static_cast<int64_t>(indptr[row]);
      const int64_t count_row =
          (static_cast<int64_t>(indptr[row + 1]) - start + max_row - 1) /
          max_row;
      const int64_t first = it[3] - (it[1] - start) / max_row;
      __threadfence();
      __syncwarp(members);
      int last = 0;
      if (g == 0) {
        last = atomicAdd(counts + first, 1u) ==
               count_row * static_cast<int64_t>(gridDim.y) - 1;
      }
      if (!__shfl_sync(members, last, lane & ~(group - 1))) continue;
      __threadfence();
      for (int64_t col = g; col < n; col += group) {
#pragma unroll
        for (int i = 0; i < M; ++i) {
          if (M > 1 && i >= count) break;
          T sum = load_cg(work + ow[i] + first * n + col);
          for (int64_t j = 1; j < count_row; ++j) {
            sum = A::add(sum,
                         load_cg(work + ow[i] + (first + j) * n + col));
          }
          const int64_t idx = row * n + col;
          c[oc[i] + idx] =
              epilogue(sum, c0 + oc0[i], idx, alpha, beta, scale);
        }
      }
      if (g == 0) counts[first] = 0;
    }
    return;
  }

  const int64_t row =
      static_cast<int64_t>(blockIdx.x - chunk_blocks) * per_block +
      threadIdx.x / group;
  if (row >= m) return;  // the whole group
  const int64_t start = static_cast<int64_t>(indptr[row]);
  const int64_t end = static_cast<int64_t>(indptr[row + 1]);
  if (end - start > max_row) return;  // split: its chunks write it
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int s = 0; s < PER; ++s)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[i][s][v] = A::zero();
  if constexpr (WARP) {
    accumulate_warp<T, I, V, PER, M>(indices, data, od, b, start, end, lane,
                                     cols, n, acc);
  } else {
    accumulate<T, I, V, PER, U, M>(indices, data, od, b, start, end, sub,
                                   split, cols, n, acc);
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    reduce_split<T, V, PER>(acc[i], lanes, group, members);
  }
  if (sub != 0) return;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (M > 1 && i >= count) break;
#pragma unroll
    for (int s = 0; s < PER; ++s) {
      if (cols[s] >= n) continue;
      const int64_t idx = row * n + cols[s];
      Vec<T, V> out;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        out.v[v] = epilogue(acc[i][s][v], c0 + oc0[i], idx + v, alpha, beta,
                            scale);
      }
      store_vec<T, V>(c + oc[i] + idx, out);
    }
  }
}

// A launch's arguments past the type codes, alpha and beta made T.
template <typename T>
struct LaunchArgs {
  const void* indptr;
  const void* indices;
  const void* data;
  const void* b;
  const void* c0;
  void* c;
  void* work;
  void* counts;
  const void* chunks;
  int64_t n_chunks, m, n, max_row;
  int lanes, split;
  T alpha, beta;
  bool scale;
  int64_t batch;
  Strides st;
};

// One launch of a.batch members, M a block (grid.z: the groups).
template <typename T, typename I, int V, int PER, int U, bool WARP,
          bool BATCH, int M>
cudaError_t launch_mapped(const LaunchArgs<T>& a, cudaStream_t stream) {
  const int per_block = kThreads / (a.lanes * a.split);
  const int64_t row_blocks = (a.m + per_block - 1) / per_block;
  const int64_t wanted = (a.n_chunks + per_block - 1) / per_block;
  const int chunk_blocks =
      static_cast<int>(wanted < kChunkBlocks ? wanted : kChunkBlocks);
  const int64_t strip = static_cast<int64_t>(PER) * a.lanes * V;
  const dim3 grid(static_cast<unsigned>(row_blocks + chunk_blocks),
                  static_cast<unsigned>((a.n + strip - 1) / strip),
                  static_cast<unsigned>((a.batch + M - 1) / M));
  csr_spmm_kernel<T, I, V, PER, U, WARP, BATCH, M>
      <<<grid, kThreads, 0, stream>>>(
      static_cast<const I*>(a.indptr), static_cast<const I*>(a.indices),
      static_cast<const T*>(a.data), static_cast<const T*>(a.b),
      static_cast<const T*>(a.c0), static_cast<T*>(a.c),
      static_cast<T*>(a.work), static_cast<unsigned*>(a.counts),
      static_cast<const int64_t*>(a.chunks), a.n_chunks, chunk_blocks, a.m,
      a.n, a.max_row, a.lanes, a.split, a.alpha, a.beta, a.scale, a.st);
  return cudaGetLastError();
}

// Picks the kernel for a launch's lane mapping: Launch<V, PER, U,
// WARP>::run(a, stream) launches one instance.  A row that a
// whole warp owns takes the shuffle path, a row of one lane (n of at most
// one 16-byte load) 4 nonzeros at a time, other groups 2: more registers
// a thread cost more warps in flight than the loads gain (measured on the
// H100), and each path is its own kernel, so that it gets its own
// register count.
template <typename T, template <int, int, int, bool> class Launch>
cudaError_t dispatch_mapping(int vec, int per_lane, const LaunchArgs<T>& a,
                             cudaStream_t stream) {
  const int lanes = a.lanes, split = a.split;
  constexpr int kVec = static_cast<int>(16 / sizeof(T));
  if (lanes == 32 && split == 1) {
    if (vec == kVec && per_lane == 2)
      return Launch<kVec, 2, 1, true>::run(a, stream);
    if (vec == kVec && per_lane == 1)
      return Launch<kVec, 1, 1, true>::run(a, stream);
    if (vec == 1 && per_lane == 2) return Launch<1, 2, 1, true>::run(a, stream);
    if (vec == 1 && per_lane == 1) return Launch<1, 1, 1, true>::run(a, stream);
    return cudaErrorInvalidValue;
  }
  if (lanes == 1 && vec == kVec) return Launch<kVec, 1, 4, false>::run(a, stream);
  if (lanes == 1 && vec == 1) return Launch<1, 1, 4, false>::run(a, stream);
  if (vec == kVec && per_lane == 2)
    return Launch<kVec, 2, 2, false>::run(a, stream);
  if (vec == kVec && per_lane == 1)
    return Launch<kVec, 1, 2, false>::run(a, stream);
  if (vec == 1 && per_lane == 2) return Launch<1, 2, 2, false>::run(a, stream);
  if (vec == 1 && per_lane == 1) return Launch<1, 1, 2, false>::run(a, stream);
  return cudaErrorInvalidValue;
}

// What every launch checks: a lane mapping of powers of two within a
// warp, the split rows' workspace and counts, the batch's size and
// strides, and 16-byte rows of every member where loads are 16 bytes.
inline bool valid_launch(int vec, int lanes, int split, int64_t n_chunks,
                         const void* work, const void* counts, int64_t batch,
                         int64_t s_data, int64_t s_b, int64_t s_c0,
                         int64_t s_c, size_t itemsize) {
  const bool pow2 = lanes > 0 && split > 0 && !(lanes & (lanes - 1)) &&
                    !(split & (split - 1)) && lanes * split <= 32;
  if (!pow2 || (n_chunks > 0 && (work == nullptr || counts == nullptr)) ||
      batch < 1 || batch > kMaxMembers || s_data < 0 || s_b < 0 ||
      s_c0 < 0 || s_c < 0) {
    return false;
  }
  // 16-byte loads need every member's rows on 16 bytes too.
  return !(vec > 1 && batch > 1 &&
           ((s_b | s_c0 | s_c) * static_cast<int64_t>(itemsize)) % 16 != 0);
}

}  // namespace
}  // namespace sdt
