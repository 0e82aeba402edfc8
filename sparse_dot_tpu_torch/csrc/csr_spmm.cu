// K2: CSR SpMM, C = alpha * A @ B + beta * C0, for CSR A and row-major B.
//
// Replaces the TPU's CSR SpMM family in sparse_dot_tpu/ops/_xla.py
// (ell_spmm_binned :648, ell_spmm :732, coo_spmm :495) and the Pallas
// gather probes of experiments/exp_pallas_gather.py (run_take :43,
// run_loop :65, run_gather :88) and experiments/exp_pallas_ell_small.py
// (ell_spmm_pallas_f32 :35).  The TPU versions repacked CSR into padded,
// length-binned ELL because its gathers want fixed shapes and its scatters
// are slow; this kernel reads CSR as it is, with no repack and no scatter.
//
// Bound: each nonzero does one multiply-add per output column against a
// whole gathered row of B, so at the main path's densities the kernel is
// bound by bytes (A's arrays, the B rows it gathers, C), far below the
// card's FMA rate.  What keeps it from that bound is latency: a gather
// depends on an index load, and narrow n leaves lanes idle.  The design:
//
// - Lane mapping from n and the value type (ops/csr.py, spmm_schedule): a
//   lane reads V adjacent columns in one 16-byte load (V = 4 f32, 2 f64,
//   2 c64, 1 c128) when every row of B, C0 and C is whole 16-byte units
//   and the pointers are 16-byte aligned, else one column; a row takes
//   L lanes, the power of two at or above its loads, at most 32, each lane
//   up to two loads (PER); wider n runs strips on grid.y.  The 32 / L lane
//   groups left in a warp either hold more rows or split a long row's
//   nonzeros P ways (every P-th nonzero each), added with shuffles at the
//   end in a fixed order.  At n = 1 that is a vector CSR SpMV.
// - Loads in flight: a lane takes U of its nonzeros at a time (4 for a
//   row of one lane, else 2), issues their B loads together and loads the
//   next U (index, value) pairs while those are in flight, so no gather
//   waits on an index load.  A row that a whole warp owns (wide n) loads
//   32 pairs at a time, one a lane, and hands them out by shuffles.  More
//   loads a thread measured slower: registers cost warps in flight.
// - Long rows: rows longer than the plan's S nonzeros (formats.csr_plan,
//   cached per matrix) are cut into chunks of S, each done by a group of
//   the first blocks of the launch into a workspace row; the group that
//   finishes a row's last chunk (an integer atomic count per row, in the
//   plan, set back to 0 after use) adds the row's partial rows in chunk
//   order and applies the epilogue.  One launch, and no float atomics: a
//   run gives the same bits twice.  A plan's counts serve one launch at a
//   time, as the port's launches on one stream are.
//
// Every output element is written once, by the group that owns it, with
// the alpha / beta * C0 epilogue fused; rows with no nonzeros store
// beta * C0 or 0.
//
// A batch of members that share A's pattern (torch.func.vmap over the
// values, per-sample gradients, jacrev, jacfwd) is one launch: the member
// is blockIdx.z, and the values, B, C0 and C each have a member stride,
// 0 for an operand that all members share (never copied per member).
// indptr, indices and the row plan are read by every member; the plan's
// counts and the workspace are each member's own (counts + z * n_chunks,
// work + z * n_chunks * n), so the last-chunk test of a split row counts
// that member's chunks only.  A single product is the instance with
// BATCH false, whose code has no member offsets.
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

// col[u], val[u] = the nonzero q0 + u * split, for those below p1.
template <typename T, typename I, int U>
__device__ __forceinline__ void load_pairs(const I* __restrict__ indices,
                                           const T* __restrict__ data,
                                           int64_t q0, int64_t p1, int split,
                                           I (&col)[U], T (&val)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t q = q0 + static_cast<int64_t>(u) * split;
    if (q < p1) {
      col[u] = indices[q];
      val[u] = data[q];
    }
  }
}

// acc += the products of the nonzeros p0 + sub, p0 + sub + split, ...
// below p1 with the columns cols[] of their B rows, in nonzero order.  A
// lane takes U of its nonzeros at a time, issues their B loads together,
// and loads the next U (index, value) pairs while they are in flight, so
// no B load waits on an index load.
template <typename T, typename I, int V, int PER, int U>
__device__ __forceinline__ void accumulate(
    const I* __restrict__ indices, const T* __restrict__ data,
    const T* __restrict__ b, int64_t p0, int64_t p1, int sub, int split,
    const int64_t (&cols)[PER], int64_t n, T (&acc)[PER][V]) {
  using A = Arith<T>;
  const int64_t step = static_cast<int64_t>(split) * U;
  I col[U];
  T val[U];
  load_pairs<T, I, U>(indices, data, p0 + sub, p1, split, col, val);
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
    T v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = val[u];
    load_pairs<T, I, U>(indices, data, p + step, p1, split, col, val);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (p + static_cast<int64_t>(u) * split >= p1) continue;
#pragma unroll
      for (int s = 0; s < PER; ++s) {
        if (cols[s] >= n) continue;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          acc[s][e] = A::fma(v[u], bv[u][s].v[e], acc[s][e]);
        }
      }
    }
  }
}

// The same for a row that a whole warp owns alone (lanes == 32, split ==
// 1, wide n): the warp loads 32 (index, value) pairs at a time, one a
// lane, and hands each to every lane by shuffles.  (Shuffling 4 at a time
// to issue their loads together took registers, and measured slower.)
template <typename T, typename I, int V, int PER>
__device__ __forceinline__ void accumulate_warp(
    const I* __restrict__ indices, const T* __restrict__ data,
    const T* __restrict__ b, int64_t p0, int64_t p1, int lane,
    const int64_t (&cols)[PER], int64_t n, T (&acc)[PER][V]) {
  using A = Arith<T>;
  for (int64_t base = p0; base < p1; base += 32) {
    const int64_t q = base + lane;
    I my_col = 0;
    T my_val = A::zero();
    if (q < p1) {
      my_col = indices[q];
      my_val = data[q];
    }
    const int cnt = static_cast<int>(p1 - base < 32 ? p1 - base : 32);
    for (int j = 0; j < cnt; ++j) {
      const int64_t col = __shfl_sync(kFullMask, my_col, j);
      const T v = A::shfl(my_val, j);
      const T* __restrict__ row = b + col * n;
#pragma unroll
      for (int s = 0; s < PER; ++s) {
        if (cols[s] >= n) continue;
        const Vec<T, V> bv = load_vec<T, V>(row + cols[s]);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          acc[s][e] = A::fma(v, bv.v[e], acc[s][e]);
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

// Member strides, in elements, of a batched launch (0: shared).
struct Strides {
  int64_t data, b, c0, c;
};

// Blocks [0, chunk_blocks) walk the chunks of split rows into work; the
// others take one row per group of lanes * split lanes and write C.
// With BATCH, blockIdx.z is the member.
template <typename T, typename I, int V, int PER, int U, bool WARP,
          bool BATCH>
__global__ void __launch_bounds__(kThreads)
csr_spmm_kernel(const I* __restrict__ indptr, const I* __restrict__ indices,
                const T* __restrict__ data, const T* __restrict__ b,
                const T* __restrict__ c0, T* __restrict__ c, T* work,
                unsigned* counts, const int64_t* __restrict__ chunks,
                int64_t n_chunks, int chunk_blocks, int64_t m, int64_t n,
                int64_t max_row, int lanes, int split, T alpha, T beta,
                bool scale, Strides st) {
  using A = Arith<T>;
  if constexpr (BATCH) {
    const int64_t z = blockIdx.z;
    data += z * st.data;
    b += z * st.b;
    if (c0 != nullptr) c0 += z * st.c0;
    c += z * st.c;
    if (n_chunks > 0) {
      work += z * n_chunks * n;
      counts += z * n_chunks;
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
  T acc[PER][V];

  if (static_cast<int>(blockIdx.x) < chunk_blocks) {
    // The chunks fill slots 0, 1, ... and padding follows the last one.
    for (int64_t item = static_cast<int64_t>(blockIdx.x) * per_block +
                        threadIdx.x / group;
         item < n_chunks;
         item += static_cast<int64_t>(chunk_blocks) * per_block) {
      const int64_t* it = chunks + 4 * item;
      if (it[0] < 0) break;
#pragma unroll
      for (int s = 0; s < PER; ++s)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[s][v] = A::zero();
      if constexpr (WARP) {
        accumulate_warp<T, I, V, PER>(indices, data, b, it[1], it[2], lane,
                                      cols, n, acc);
      } else {
        accumulate<T, I, V, PER, U>(indices, data, b, it[1], it[2], sub, split,
                                 cols, n, acc);
      }
      reduce_split<T, V, PER>(acc, lanes, group, members);
      if (sub == 0) {
#pragma unroll
        for (int s = 0; s < PER; ++s) {
          if (cols[s] >= n) continue;
          Vec<T, V> out;
#pragma unroll
          for (int v = 0; v < V; ++v) out.v[v] = acc[s][v];
          store_vec<T, V>(work + it[3] * n + cols[s], out);
        }
      }
      // The group that finishes the last (chunk, strip) of the row adds
      // all the row's partial rows in chunk order; counts[first slot]
      // counts them and is set back to 0 for the next launch.
      const int64_t row = it[0];
      const int64_t start = static_cast<int64_t>(indptr[row]);
      const int64_t count =
          (static_cast<int64_t>(indptr[row + 1]) - start + max_row - 1) /
          max_row;
      const int64_t first = it[3] - (it[1] - start) / max_row;
      __threadfence();
      __syncwarp(members);
      int last = 0;
      if (g == 0) {
        last = atomicAdd(counts + first, 1u) ==
               count * static_cast<int64_t>(gridDim.y) - 1;
      }
      if (!__shfl_sync(members, last, lane & ~(group - 1))) continue;
      __threadfence();
      for (int64_t col = g; col < n; col += group) {
        T sum = load_cg(work + first * n + col);
        for (int64_t j = 1; j < count; ++j) {
          sum = A::add(sum, load_cg(work + (first + j) * n + col));
        }
        const int64_t idx = row * n + col;
        c[idx] = epilogue(sum, c0, idx, alpha, beta, scale);
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
  for (int s = 0; s < PER; ++s)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[s][v] = A::zero();
  if constexpr (WARP) {
    accumulate_warp<T, I, V, PER>(indices, data, b, start, end, lane, cols, n,
                                  acc);
  } else {
    accumulate<T, I, V, PER, U>(indices, data, b, start, end, sub, split, cols,
                             n, acc);
  }
  reduce_split<T, V, PER>(acc, lanes, group, members);
  if (sub != 0) return;
#pragma unroll
  for (int s = 0; s < PER; ++s) {
    if (cols[s] >= n) continue;
    const int64_t idx = row * n + cols[s];
    Vec<T, V> out;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      out.v[v] = epilogue(acc[s][v], c0, idx + v, alpha, beta, scale);
    }
    store_vec<T, V>(c + idx, out);
  }
}

template <typename T, typename I, int V, int PER, int U, bool WARP,
          bool BATCH>
cudaError_t launch_mapped(const void* indptr, const void* indices,
                          const void* data, const void* b, const void* c0,
                          void* c, void* work, void* counts,
                          const void* chunks, int64_t n_chunks, int64_t m,
                          int64_t n, int64_t max_row, int lanes, int split,
                          T alpha, T beta, bool scale, int64_t batch,
                          Strides st, cudaStream_t stream) {
  const int per_block = kThreads / (lanes * split);
  const int64_t row_blocks = (m + per_block - 1) / per_block;
  const int64_t wanted = (n_chunks + per_block - 1) / per_block;
  const int chunk_blocks =
      static_cast<int>(wanted < kChunkBlocks ? wanted : kChunkBlocks);
  const int64_t strip = static_cast<int64_t>(PER) * lanes * V;
  const dim3 grid(static_cast<unsigned>(row_blocks + chunk_blocks),
                  static_cast<unsigned>((n + strip - 1) / strip),
                  static_cast<unsigned>(batch));
  csr_spmm_kernel<T, I, V, PER, U, WARP, BATCH>
      <<<grid, kThreads, 0, stream>>>(
      static_cast<const I*>(indptr), static_cast<const I*>(indices),
      static_cast<const T*>(data), static_cast<const T*>(b),
      static_cast<const T*>(c0), static_cast<T*>(c), static_cast<T*>(work),
      static_cast<unsigned*>(counts), static_cast<const int64_t*>(chunks),
      n_chunks, chunk_blocks, m, n, max_row, lanes, split, alpha, beta,
      scale, st);
  return cudaGetLastError();
}

// The instance for one member (BATCH false) or for a batch.
template <typename T, typename I, int V, int PER, int U, bool WARP = false>
cudaError_t launch_members(const void* indptr, const void* indices,
                           const void* data, const void* b, const void* c0,
                           void* c, void* work, void* counts,
                           const void* chunks, int64_t n_chunks, int64_t m,
                           int64_t n, int64_t max_row, int lanes, int split,
                           T alpha, T beta, bool scale, int64_t batch,
                           Strides st, cudaStream_t stream) {
#define SDT_K2_MAPPED_ARGS                                               \
  indptr, indices, data, b, c0, c, work, counts, chunks, n_chunks, m, n, \
      max_row, lanes, split, alpha, beta, scale, batch, st, stream
  if (batch == 1) {
    return launch_mapped<T, I, V, PER, U, WARP, false>(SDT_K2_MAPPED_ARGS);
  }
  return launch_mapped<T, I, V, PER, U, WARP, true>(SDT_K2_MAPPED_ARGS);
#undef SDT_K2_MAPPED_ARGS
}

template <typename T, typename I>
cudaError_t launch(const void* indptr, const void* indices, const void* data,
                   const void* b, const void* c0, void* c, void* work,
                   void* counts, const void* chunks, int64_t n_chunks,
                   int64_t m, int64_t n, int64_t max_row, int vec, int lanes,
                   int split, int per_lane, double alpha_re, double alpha_im,
                   double beta_re, double beta_im, int64_t batch,
                   int64_t s_data, int64_t s_b, int64_t s_c0, int64_t s_c,
                   cudaStream_t stream) {
  constexpr int kVec = static_cast<int>(16 / sizeof(T));
  const bool pow2 = lanes > 0 && split > 0 && !(lanes & (lanes - 1)) &&
                    !(split & (split - 1)) && lanes * split <= 32;
  if (!pow2 || (n_chunks > 0 && (work == nullptr || counts == nullptr)) ||
      batch < 1 || batch > kMaxMembers || s_data < 0 || s_b < 0 ||
      s_c0 < 0 || s_c < 0) {
    return cudaErrorInvalidValue;
  }
  // 16-byte loads need every member's rows on 16 bytes too.
  if (vec > 1 && batch > 1 &&
      ((s_b | s_c0 | s_c) * static_cast<int64_t>(sizeof(T))) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const Strides st{s_data, s_b, s_c0, s_c};
  const T alpha = Arith<T>::make(alpha_re, alpha_im);
  const T beta = Arith<T>::make(beta_re, beta_im);
  const bool scale = !is_one(alpha_re, alpha_im);
#define SDT_K2_ARGS                                                      \
  indptr, indices, data, b, c0, c, work, counts, chunks, n_chunks, m, n, \
      max_row, lanes, split, alpha, beta, scale, batch, st, stream
  // A row that a whole warp owns takes the shuffle path, a row of one lane
  // (n of at most one 16-byte load) 4 nonzeros at a time, other groups 2:
  // more registers a thread cost more warps in flight than the loads gain
  // (measured on the H100), and each path is its own kernel, so that it
  // gets its own register count.
  if (lanes == 32 && split == 1) {
    if (vec == kVec && per_lane == 2)
      return launch_members<T, I, kVec, 2, 1, true>(SDT_K2_ARGS);
    if (vec == kVec && per_lane == 1)
      return launch_members<T, I, kVec, 1, 1, true>(SDT_K2_ARGS);
    if (vec == 1 && per_lane == 2)
      return launch_members<T, I, 1, 2, 1, true>(SDT_K2_ARGS);
    if (vec == 1 && per_lane == 1)
      return launch_members<T, I, 1, 1, 1, true>(SDT_K2_ARGS);
    return cudaErrorInvalidValue;
  }
  if (lanes == 1 && vec == kVec)
    return launch_members<T, I, kVec, 1, 4>(SDT_K2_ARGS);
  if (lanes == 1 && vec == 1) return launch_members<T, I, 1, 1, 4>(SDT_K2_ARGS);
  if (vec == kVec && per_lane == 2)
    return launch_members<T, I, kVec, 2, 2>(SDT_K2_ARGS);
  if (vec == kVec && per_lane == 1)
    return launch_members<T, I, kVec, 1, 2>(SDT_K2_ARGS);
  if (vec == 1 && per_lane == 2)
    return launch_members<T, I, 1, 2, 2>(SDT_K2_ARGS);
  if (vec == 1 && per_lane == 1)
    return launch_members<T, I, 1, 1, 2>(SDT_K2_ARGS);
#undef SDT_K2_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace sdt

// batch members (at most kMaxMembers, grid.z's limit), each operand at
// its member stride in elements (0: shared); batch 1 is one product.
extern "C" int sdt_csr_spmm(int dtype, int itype, const void* indptr,
                            const void* indices, const void* data,
                            const void* b, const void* c0, void* c,
                            void* work, void* counts, const void* chunks,
                            int64_t n_chunks, int64_t m, int64_t n,
                            int64_t max_row, int vec, int lanes, int split,
                            int per_lane, double alpha_re, double alpha_im,
                            double beta_re, double beta_im, int64_t batch,
                            int64_t s_data, int64_t s_b, int64_t s_c0,
                            int64_t s_c, void* stream) {
  SDT_DISPATCH(dtype, itype, sdt::launch, indptr, indices, data, b, c0, c,
               work, counts, chunks, n_chunks, m, n, max_row, vec, lanes,
               split, per_lane, alpha_re, alpha_im, beta_re, beta_im, batch,
               s_data, s_b, s_c0, s_c, static_cast<cudaStream_t>(stream))
}
