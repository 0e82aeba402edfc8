// K7: CSR SDDMM, out[p] = alpha * sum_n G[r_p, n] * conj(B[c_p, n]) for each
// stored entry p = (r_p, c_p) of a CSR A, with row-major G (m, n) and B
// (k, n); conj only for complex values.  It is the gradient of C = A @ B
// with respect to A's values (G = dL/dC), and at n = 1 that of y = A @ x.
//
// Replaces XLA's transpose of the scatter in sparse_dot_tpu/ops/_xla.py
// (coo_spmm_raw :178, coo_spmv :138): jax.grad of those functions with
// respect to the values is two gathers, a product and a sum over n per
// nonzero, which XLA runs as separate passes through an nnz x n
// intermediate (1 GB at BASELINE config 1 in f64).  Here it is one fused
// gather, multiply and reduce, with nothing but the output written.
//
// Bound: each entry reads a row of G and a row of B, n multiply-adds, so
// the kernel is bound by bytes, far below the card's FMA rate.  The HBM
// bound counts A's indices, G, the rows of B that A names (each once) and
// the output: 32.5 MB, 0.0097 ms at config 1.  What sets the time is the
// gather through L2: every entry reads its whole row of B, nnz * n *
// itemsize bytes (1.02 GB at config 1: G and B, 10 MB each, sit in the
// 50 MB L2), each gather behind an index load.  K2 (csr_spmm.cu) gathers
// the same rows for the same A.  The design:
//
// - Lane mapping from n and the value type (ops/sddmm.py, sddmm_schedule,
//   which takes K2's spmm_schedule): a lane reads V adjacent columns in
//   one 16-byte load when every row of G and B is whole 16-byte units and
//   both pointers are aligned, else one column; an entry takes L lanes,
//   the power of two at or above its loads, at most 32, each lane up to
//   two loads (PER); wider n is walked in strips of PER * L * V columns by
//   the same group, each strip adding to what the earlier wrote.
// - Work: a group of L lanes owns a span of consecutive entries, one wave
//   of groups for the card (the span from the schedule), issues its first
//   round's B loads, finds the row of its first entry by a search of
//   indptr that probes L rows at once (row_of_group: log_{L+1} m loads,
//   not log_2 m) while they are in flight, and keeps its strip of
//   that row of G in registers while it walks the span, loading a new
//   strip only where the span enters the next row (row_from).  Spans
//   balance long rows by themselves: an entry's output depends on no
//   other entry, so a row needs no chunks and no second pass.
// - Rounds of E entries (round_entries: 4, or 2 where a lane loads 32
//   bytes of an entry's B row, at most L), software-pipelined: a round's
//   products are taken, then the next round's B loads are issued into the
//   same registers, and only then are the round's E sums added across the
//   group by one reduce-scatter (E - 1 + log2(L / E) shuffles, leaving
//   entry e's total with the lanes whose bits spell e, one of which
//   writes out[p + e]).  So a warp's gathers stay in flight while it
//   reduces, at no register cost; indices are loaded two rounds ahead.
//   With 32-bit indices, entry and row numbers are 32-bit (unsigned, so a
//   round past 2^31 - 1 cannot wrap): fewer registers, and the kernel fits
//   the 64-register cap that keeps 32 warps on an SM without spilling.
// - Registers decide: 32 warps an SM with 64 registers each beat fewer
//   warps with more loads in flight.  Staging B in shared memory by
//   asynchronous copies (cp.async, or TMA bulk copies on an mbarrier ring)
//   to keep more rows in flight without registers measured no faster at
//   any width: with a lane per entry the transposed rows cost L1 and
//   shared-memory bandwidth, and a ring of each lane's own 16-byte pieces
//   only matched this kernel (PERF.md).
// - An entry whose G and B rows are one load (n == V, or n == 1; L == 1)
//   takes a thread of its own: a warp a tile of 32 * 8 consecutive
//   entries, a thread every 32nd, the tile's first row found by the warp
//   together (row_of_group) and each thread's next from its last (forward
//   steps of 1, 2, 4, ..., then a binary search), so runs of empty rows
//   cost their logarithm.
//
// Every output is written by one lane, with no atomics: a run gives the
// same bits twice.
//
// A batch of members that share A's pattern (the backward of a vmap over
// values or over b, jacrev's cotangents, a batched tangent) is one
// launch: the member is blockIdx.y, and G, B and the output each have a
// member stride, 0 for the operand that all members share (jacrev
// batches G alone, per-sample gradients G and B, a batched tangent B
// alone).  The wrapper sizes the spans over all members' entries
// (sddmm_schedule).  A single product is the instance with BATCH false,
// whose code has no member offsets.  Blocks are scheduled as SMs free
// up, so a last wave that is part full costs little: spans sized to fill
// whole waves measured 1% slower at 16 members of config 1 (PERF.md).
//
// Where B is shared (stride 0) and G is not, the gather of B's rows, the
// kernel's dominant traffic, serves M members at once
// (csr_sddmm_shared_kernel): blockIdx.y is a group of M consecutive
// members, each lane keeps the M members' strips of G's row in registers,
// and each entry's B strip, loaded once, meets all M of them.  A round
// then takes E' = max(1, E / M) entries: its M * E' sums go through one
// reduce-scatter, whose lanes each end with one member's total of one
// entry.  M (2 or 4) is the wrapper's choice (ops/sddmm.py,
// shared_members): the most that one reduce-scatter holds, 4 wherever
// the lanes allow, though the registers then spill (60 bytes a lane at
// f64 n = 128), since the spill costs less than a second gather of B;
// 2 for c128 with 64-bit indices, where 4 timed slower (PERF.md).  Where
// no M fits, the per-member kernel runs.  A batched tangent, G shared and
// B not, reaches this kernel through A's transpose (ops/sddmm.py,
// sddmm_batched).
#include <cstring>
#include <type_traits>

#include "common.cuh"

namespace sdt {
namespace {

constexpr int kThreads = 128;

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

__device__ __forceinline__ float conj_of(float v) { return v; }
__device__ __forceinline__ double conj_of(double v) { return v; }
template <typename R>
__device__ __forceinline__ cuda::std::complex<R> conj_of(
    cuda::std::complex<R> v) {
  return cuda::std::complex<R>(v.real(), -v.imag());
}

// The row of entry p (the last r with indptr[r] <= p, so that indptr[r] <=
// p < indptr[r + 1] even across empty rows), found by the L lanes of a
// group together: each step probes L evenly spaced rows of [lo, hi) in one
// load a lane, and the count of probes at or below p (a prefix, indptr
// being sorted) narrows the range (L + 1)-fold.  Every lane of the group
// must call it and gets the same row.
template <typename I, int L>
__device__ __forceinline__ int64_t row_of_group(const I* __restrict__ indptr,
                                                int64_t m, int64_t p, int gl,
                                                unsigned members) {
  const int shift = static_cast<int>(threadIdx.x & 31) & ~(L - 1);
  constexpr unsigned kGroup = L == 32 ? kFullMask : (1u << L) - 1u;
  int64_t lo = 0, hi = m;  // indptr[lo] <= p < indptr[hi]
  while (hi - lo > 1) {
    const int64_t step = (hi - lo + L) / (L + 1);
    const int64_t pos = lo + (gl + 1) * step;
    const bool at_or_below =
        pos < hi && static_cast<int64_t>(indptr[pos]) <= p;
    const unsigned below =
        (__ballot_sync(members, at_or_below) >> shift) & kGroup;
    const int64_t count = __popc(below);
    const int64_t next_hi = lo + (count + 1) * step;
    lo += count * step;
    if (next_hi < hi) hi = next_hi;
  }
  return lo;
}

// The row of entry p >= indptr[lo], searching forward from row lo: steps
// of 1, 2, 4, ... past rows that end at or before p, then a binary search
// of the last step, so a row reached across many empty rows costs their
// logarithm, not their number.
template <typename I>
__device__ __forceinline__ int64_t row_from(const I* __restrict__ indptr,
                                            int64_t m, int64_t p,
                                            int64_t lo) {
  int64_t hi = lo + 1;
  for (int64_t step = 1; hi < m && static_cast<int64_t>(indptr[hi]) <= p;
       step <<= 1) {
    lo = hi;
    hi = lo + step;
  }
  if (hi > m) hi = m;
  while (hi - lo > 1) {  // indptr[lo] <= p < indptr[hi]
    const int64_t mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(indptr[mid]) <= p) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Entries a thread of the entry kernel takes, 32 apart: a warp covers
// 32 * kPerThread consecutive entries.
constexpr int kPerThread = 8;

// Member strides, in elements, of a batched launch (0: shared).
struct Strides {
  int64_t g, b, out;
};

// Moves g, b and out to member blockIdx.y of a batch (BATCH).
#define SDT_K7_TO_MEMBER          \
  if constexpr (BATCH) {          \
    const int64_t z = blockIdx.y; \
    g += z * st.g;                \
    b += z * st.b;                \
    out += z * st.out;            \
  }

// A thread an entry at a time: G's and B's rows are one load (n == V, or
// n == 1).  A thread takes the entries p, p + 32, ... of its warp's tile;
// the tile's first row is found by the warp together, each thread's first
// and each next one's forward from the last (row_from).
template <typename T, typename I, int V, bool BATCH>
__global__ void __launch_bounds__(kThreads)
csr_sddmm_entry_kernel(const I* __restrict__ indptr,
                       const I* __restrict__ indices,
                       const T* __restrict__ g, const T* __restrict__ b,
                       T* __restrict__ out, int64_t m, int64_t n,
                       int64_t nnz, T alpha, bool scale, Strides st) {
  using A = Arith<T>;
  SDT_K7_TO_MEMBER
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int64_t tile = (static_cast<int64_t>(blockIdx.x) * kThreads +
                        (threadIdx.x & ~31)) * kPerThread;
  if (tile >= nnz) return;  // the whole warp
  int64_t row = row_of_group<I, 32>(indptr, m, tile, lane, kFullMask);
  const int64_t first = tile + lane;
  if (first >= nnz) return;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t p = first + 32 * j;
    if (p >= nnz) break;
    const int64_t col = static_cast<int64_t>(indices[p]);
    row = row_from(indptr, m, p, row);
    T acc = A::zero();
    if constexpr (V > 1) {
      const Vec<T, V> gv = load_vec<T, V>(g + row * V);
      const Vec<T, V> bv = load_vec<T, V>(b + col * V);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        acc = A::fma(gv.v[e], conj_of(bv.v[e]), acc);
      }
    } else {
      acc = A::fma(g[row], conj_of(b[col]), acc);
    }
    out[p] = scale ? A::mul(alpha, acc) : acc;
  }
}

// Entries a round for groups of L lanes that load `bytes` of an entry's B
// row a lane: 4, fewer for narrow groups, and 2 where four rounds' loads
// would pass 64 bytes a lane (they took registers, and so warps).
// ops/sddmm.py (round_entries) mirrors it; the launch refuses a schedule
// whose round differs.
constexpr int round_entries(int lanes, int bytes) {
  int e = 4;
  while (e > 2 && e * bytes > 64) e >>= 1;
  return e < lanes ? e : lanes;
}

// Blocks an SM must hold of the span kernel: 8 of 128 threads (32 warps)
// cap its registers at 64 a thread.  ops/sddmm.py sizes one wave of spans
// from it (_SPAN_GROUPS).
constexpr int kSpanBlocks = 8;

// A group of L lanes a span of `span` entries (see the top), E entries a
// round, the next round's B loads issued between a round's products and
// its reduce-scatter.  L, V, PER and E are compile-time, so shuffles,
// masks and offsets are too.  P holds entry and row numbers: int32_t
// with 32-bit indices (nnz and m below 2^31), else int64_t; an entry past
// the span is tested as an offset against p1 - p, so no sum passes p1.
// (Unsigned 32-bit numbers spilled: their wrap-around kept the compiler
// from widening the addresses.)
template <typename T, typename I, int L, int V, int PER, int E, bool BATCH>
__global__ void __launch_bounds__(kThreads, kSpanBlocks)
csr_sddmm_span_kernel(const I* __restrict__ indptr,
                      const I* __restrict__ indices,
                      const T* __restrict__ g, const T* __restrict__ b,
                      T* out, int64_t m, int64_t n, int64_t nnz,
                      int64_t span, T alpha, bool scale, Strides st) {
  using A = Arith<T>;
  SDT_K7_TO_MEMBER
  using P = std::conditional_t<sizeof(I) == 4, int32_t, int64_t>;
  constexpr int kPerBlock = kThreads / L;
  constexpr int kStrip = PER * L * V;
  const int gl = static_cast<int>(threadIdx.x) % L;
  const unsigned members =
      L == 32 ? kFullMask
              : ((1u << L) - 1u) << ((threadIdx.x & 31) & ~(L - 1));
  const int64_t start =
      (static_cast<int64_t>(blockIdx.x) * kPerBlock + threadIdx.x / L) *
      span;
  if (start >= nnz) return;  // the whole group
  const P p0 = static_cast<P>(start);
  const P p1 = static_cast<P>(start + span < nnz ? start + span : nnz);
  const int mine = entry_of<L, E>(gl);
  const bool writer = (gl & (L / E - 1)) == 0;
  auto index_at = [&](P p, int k) {
    return k < p1 - p ? indices[p + k] : I(0);
  };

  // Columns are int: the wrapper refuses n of 2^31 or more.
  const int nn = static_cast<int>(n);
  // A round's B pieces, from the columns in cols[] at this lane's strip
  // offset c.  Entries past the span load B's row 0 (index_at), unused:
  // no branch between a round's loads.
  Vec<T, V> bv[E][PER];
  I next[E];
  auto load_b = [&](const I (&cols)[E], int c) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const T* __restrict__ brow = b + static_cast<int64_t>(cols[e]) * n + c;
#pragma unroll
      for (int s = 0; s < PER; ++s) {
        if (c + s * L * V < nn) bv[e][s] = load_vec<T, V>(brow + s * L * V);
      }
    }
  };
  // The first strip's first round needs no row: its loads go in flight
  // before the row search.
#pragma unroll
  for (int e = 0; e < E; ++e) next[e] = index_at(p0, e);
  load_b(next, gl * V);
  const P first_row =
      static_cast<P>(row_of_group<I, L>(indptr, m, start, gl, members));
  for (int s0 = 0; s0 < nn; s0 += kStrip) {
    // This lane's columns: c + s * L * V for s < PER, those below n.
    const int c = s0 + gl * V;
    P row = first_row;
    P row_end = static_cast<P>(indptr[row + 1]);
    Vec<T, V> gv[PER];
    auto load_g = [&]() {
#pragma unroll
      for (int s = 0; s < PER; ++s) {
        if (c + s * L * V < nn) {
          gv[s] = load_vec<T, V>(g + static_cast<int64_t>(row) * n + c +
                                 s * L * V);
        }
      }
    };
    load_g();
    if (s0 > 0) {
#pragma unroll
      for (int e = 0; e < E; ++e) next[e] = index_at(p0, e);
      load_b(next, c);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) next[e] = index_at(p0, E + e);
    for (P p = p0;; p += E) {
      T sum[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        sum[e] = A::zero();
        if (e >= p1 - p) continue;  // the whole group
        if (p + e >= row_end) {  // the span enters a later row
          row = static_cast<P>(row_from(indptr, m, p + e, row));
          row_end = static_cast<P>(indptr[row + 1]);
          load_g();
        }
#pragma unroll
        for (int s = 0; s < PER; ++s) {
          if (c + s * L * V >= nn) continue;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            sum[e] = A::fma(gv[s].v[k], conj_of(bv[e][s].v[k]), sum[e]);
          }
        }
      }
      // This round's B registers are free: the next round's loads go in
      // flight before the reduce-scatter, then the indices of the one
      // after.
      const bool more = E < p1 - p;
      if (more) {
        load_b(next, c);
#pragma unroll
        for (int e = 0; e < E; ++e) next[e] = index_at(p, 2 * E + e);
      }
      const T total = reduce_scatter<T, L, E>(sum, gl, members);
      if (writer && mine < p1 - p) {
        const P q = p + mine;
        T v = s0 == 0 ? total : A::add(out[q], total);
        if (s0 + kStrip >= nn && scale) v = A::mul(alpha, v);
        out[q] = v;
      }
      if (!more) break;
    }
  }
}

#undef SDT_K7_TO_MEMBER

// Entries a round of the shared kernel: round_entries' count split over
// the M members, at least 1.  ops/sddmm.py (shared_round) mirrors it.
constexpr int shared_round(int lanes, int bytes, int members) {
  const int e = round_entries(lanes, bytes) / members;
  return e > 1 ? e : 1;
}

// The span kernel for M members with B shared (see the top): member group
// blockIdx.y takes members M * blockIdx.y onward, `batch` in all; G and
// the output advance by their member strides, B does not move.  A lane's
// registers hold M strips of G (M * PER * V values), E rounds' B pieces
// and M * E sums.  The rest is the span kernel's: rounds pipelined the
// same way, one lane writes each output, no atomics.
template <typename T, typename I, int L, int V, int PER, int E, int M>
__global__ void __launch_bounds__(kThreads, kSpanBlocks)
csr_sddmm_shared_kernel(const I* __restrict__ indptr,
                        const I* __restrict__ indices,
                        const T* __restrict__ g, const T* __restrict__ b,
                        T* out, int64_t m, int64_t n, int64_t nnz,
                        int64_t span, T alpha, bool scale, int64_t batch,
                        int64_t s_g, int64_t s_out) {
  using A = Arith<T>;
  using P = std::conditional_t<sizeof(I) == 4, int32_t, int64_t>;
  constexpr int kPerBlock = kThreads / L;
  constexpr int kStrip = PER * L * V;
  constexpr int kSums = E * M;
  const int64_t first = static_cast<int64_t>(blockIdx.y) * M;
  const int count = batch - first < M ? static_cast<int>(batch - first) : M;
  g += first * s_g;
  out += first * s_out;
  const int gl = static_cast<int>(threadIdx.x) % L;
  const unsigned members =
      L == 32 ? kFullMask
              : ((1u << L) - 1u) << ((threadIdx.x & 31) & ~(L - 1));
  const int64_t start =
      (static_cast<int64_t>(blockIdx.x) * kPerBlock + threadIdx.x / L) *
      span;
  if (start >= nnz) return;  // the whole group
  const P p0 = static_cast<P>(start);
  const P p1 = static_cast<P>(start + span < nnz ? start + span : nnz);
  // The sum this lane holds after the reduce-scatter: sums are laid out
  // member-major, sum[k * E + e].
  const int mine = entry_of<L, kSums>(gl);
  const int mine_k = mine / E;
  const int mine_e = mine % E;
  const bool writer = (gl & (L / kSums - 1)) == 0 && mine_k < count;
  T* const my_out = out + mine_k * s_out;
  auto index_at = [&](P p, int k) {
    return k < p1 - p ? indices[p + k] : I(0);
  };

  const int nn = static_cast<int>(n);
  Vec<T, V> bv[E][PER];
  I next[E];
  auto load_b = [&](const I (&cols)[E], int c) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const T* __restrict__ brow = b + static_cast<int64_t>(cols[e]) * n + c;
#pragma unroll
      for (int s = 0; s < PER; ++s) {
        if (c + s * L * V < nn) bv[e][s] = load_vec<T, V>(brow + s * L * V);
      }
    }
  };
#pragma unroll
  for (int e = 0; e < E; ++e) next[e] = index_at(p0, e);
  load_b(next, gl * V);
  const P first_row =
      static_cast<P>(row_of_group<I, L>(indptr, m, start, gl, members));
  for (int s0 = 0; s0 < nn; s0 += kStrip) {
    const int c = s0 + gl * V;
    P row = first_row;
    P row_end = static_cast<P>(indptr[row + 1]);
    Vec<T, V> gv[M][PER];
    // Members past the batch read member 0's row and write nothing.
    auto load_g = [&]() {
#pragma unroll
      for (int k = 0; k < M; ++k) {
        const T* __restrict__ grow =
            g + (k < count ? k : 0) * s_g + static_cast<int64_t>(row) * n + c;
#pragma unroll
        for (int s = 0; s < PER; ++s) {
          if (c + s * L * V < nn) gv[k][s] = load_vec<T, V>(grow + s * L * V);
        }
      }
    };
    load_g();
    if (s0 > 0) {
#pragma unroll
      for (int e = 0; e < E; ++e) next[e] = index_at(p0, e);
      load_b(next, c);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) next[e] = index_at(p0, E + e);
    for (P p = p0;; p += E) {
      T sum[kSums];
#pragma unroll
      for (int e = 0; e < E; ++e) {
#pragma unroll
        for (int k = 0; k < M; ++k) sum[k * E + e] = A::zero();
        if (e >= p1 - p) continue;  // the whole group
        if (p + e >= row_end) {  // the span enters a later row
          row = static_cast<P>(row_from(indptr, m, p + e, row));
          row_end = static_cast<P>(indptr[row + 1]);
          load_g();
        }
#pragma unroll
        for (int s = 0; s < PER; ++s) {
          if (c + s * L * V >= nn) continue;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const T bc = conj_of(bv[e][s].v[v]);
#pragma unroll
            for (int k = 0; k < M; ++k) {
              sum[k * E + e] = A::fma(gv[k][s].v[v], bc, sum[k * E + e]);
            }
          }
        }
      }
      const bool more = E < p1 - p;
      if (more) {
        load_b(next, c);
#pragma unroll
        for (int e = 0; e < E; ++e) next[e] = index_at(p, 2 * E + e);
      }
      const T total = reduce_scatter<T, L, kSums>(sum, gl, members);
      if (writer && mine_e < p1 - p) {
        const P q = p + mine_e;
        T v = s0 == 0 ? total : A::add(my_out[q], total);
        if (s0 + kStrip >= nn && scale) v = A::mul(alpha, v);
        my_out[q] = v;
      }
      if (!more) break;
    }
  }
}

template <typename T, typename I, int V, bool BATCH>
cudaError_t launch_entries(const void* indptr, const void* indices,
                           const void* g, const void* b, void* out,
                           int64_t m, int64_t n, int64_t nnz, T alpha,
                           bool scale, int64_t batch, Strides st,
                           cudaStream_t stream) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * kPerThread;
  const int64_t blocks = (nnz + per_block - 1) / per_block;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(batch));
  csr_sddmm_entry_kernel<T, I, V, BATCH><<<grid, kThreads, 0, stream>>>(
      static_cast<const I*>(indptr), static_cast<const I*>(indices),
      static_cast<const T*>(g), static_cast<const T*>(b),
      static_cast<T*>(out), m, n, nnz, alpha, scale, st);
  return cudaGetLastError();
}

template <typename T, typename I, int L, int V, int PER, bool BATCH>
cudaError_t launch_span_kernel(const void* indptr, const void* indices,
                               const void* g, const void* b, void* out,
                               int64_t m, int64_t n, int64_t nnz,
                               int64_t span, T alpha, bool scale,
                               int64_t batch, Strides st,
                               cudaStream_t stream) {
  constexpr int E = round_entries(L, PER * V * static_cast<int>(sizeof(T)));
  const int64_t groups = (nnz + span - 1) / span;
  const int64_t blocks = (groups + kThreads / L - 1) / (kThreads / L);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(batch));
  csr_sddmm_span_kernel<T, I, L, V, PER, E, BATCH>
      <<<grid, kThreads, 0, stream>>>(
          static_cast<const I*>(indptr), static_cast<const I*>(indices),
          static_cast<const T*>(g), static_cast<const T*>(b),
          static_cast<T*>(out), m, n, nnz, span, alpha, scale, st);
  return cudaGetLastError();
}

// M members a group with B shared (csr_sddmm_shared_kernel): member
// groups on grid.y.
template <typename T, typename I, int L, int V, int PER, int M>
cudaError_t launch_shared(const void* indptr, const void* indices,
                          const void* g, const void* b, void* out, int64_t m,
                          int64_t n, int64_t nnz, int round_len,
                          int64_t span, T alpha, bool scale, int64_t batch,
                          Strides st, cudaStream_t stream) {
  constexpr int E =
      shared_round(L, PER * V * static_cast<int>(sizeof(T)), M);
  if constexpr (E * M > L) {
    return cudaErrorInvalidValue;
  } else {
    if (round_len != E || st.b != 0) {
      return cudaErrorInvalidValue;
    }
    const int64_t groups = (nnz + span - 1) / span;
    const int64_t blocks = (groups + kThreads / L - 1) / (kThreads / L);
    const dim3 grid(static_cast<unsigned>(blocks),
                    static_cast<unsigned>((batch + M - 1) / M));
    csr_sddmm_shared_kernel<T, I, L, V, PER, E, M>
        <<<grid, kThreads, 0, stream>>>(
            static_cast<const I*>(indptr), static_cast<const I*>(indices),
            static_cast<const T*>(g), static_cast<const T*>(b),
            static_cast<T*>(out), m, n, nnz, span, alpha, scale, batch, st.g,
            st.out);
    return cudaGetLastError();
  }
}

// One member (BATCH false), a batch, or a batch M members a group with B
// shared (`shared` == M, 2 or 4).
template <typename T, typename I, int L, int V, int PER>
cudaError_t launch_spans(const void* indptr, const void* indices,
                         const void* g, const void* b, void* out, int64_t m,
                         int64_t n, int64_t nnz, int round_len,
                         int64_t span, T alpha, bool scale, int64_t batch,
                         Strides st, int shared, cudaStream_t stream) {
  if (shared == 2 || shared == 4) {
    return shared == 2
               ? launch_shared<T, I, L, V, PER, 2>(
                     indptr, indices, g, b, out, m, n, nnz, round_len, span,
                     alpha, scale, batch, st, stream)
               : launch_shared<T, I, L, V, PER, 4>(
                     indptr, indices, g, b, out, m, n, nnz, round_len, span,
                     alpha, scale, batch, st, stream);
  }
  constexpr int E = round_entries(L, PER * V * static_cast<int>(sizeof(T)));
  if (round_len != E || shared != 1) return cudaErrorInvalidValue;
  if (batch == 1) {
    return launch_span_kernel<T, I, L, V, PER, false>(
        indptr, indices, g, b, out, m, n, nnz, span, alpha, scale, batch, st,
        stream);
  }
  return launch_span_kernel<T, I, L, V, PER, true>(
      indptr, indices, g, b, out, m, n, nnz, span, alpha, scale, batch, st,
      stream);
}

template <typename T, typename I>
cudaError_t launch(const void* indptr, const void* indices, const void* g,
                   const void* b, void* out, int64_t m, int64_t n,
                   int64_t nnz, int vec, int lanes, int per_lane,
                   int round_len, int64_t span, double alpha_re, double alpha_im,
                   int64_t batch, int64_t s_g, int64_t s_b, int64_t s_out,
                   int shared, cudaStream_t stream) {
  constexpr int kVec = static_cast<int>(16 / sizeof(T));
  if (m <= 0 || n <= 0 || nnz <= 0 || span <= 0 || batch < 1 ||
      batch > kMaxMembers || s_g < 0 || s_b < 0 || s_out < 0) {
    return cudaErrorInvalidValue;
  }
  // 16-byte loads need every member's rows on 16 bytes too.
  if (vec > 1 && batch > 1 &&
      ((s_g | s_b) * static_cast<int64_t>(sizeof(T))) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const T alpha = Arith<T>::make(alpha_re, alpha_im);
  const bool scale = !is_one(alpha_re, alpha_im);
  const Strides st{s_g, s_b, s_out};
  if (lanes == 1) {
    if (round_len != 1 || span != 32 * kPerThread || shared != 1) {
      return cudaErrorInvalidValue;
    }
#define SDT_K7_ENTRY(V)                                                     \
  return batch == 1                                                         \
             ? launch_entries<T, I, V, false>(indptr, indices, g, b, out, m, \
                                              n, nnz, alpha, scale, batch,   \
                                              st, stream)                    \
             : launch_entries<T, I, V, true>(indptr, indices, g, b, out, m,  \
                                             n, nnz, alpha, scale, batch,    \
                                             st, stream);
    if (vec == kVec && n == kVec) SDT_K7_ENTRY(kVec)
    if (vec == 1 && n == 1) SDT_K7_ENTRY(1)
#undef SDT_K7_ENTRY
    return cudaErrorInvalidValue;
  }
  // Two loads a lane only where 32 lanes do not cover n in one
  // (ops/csr.spmm_schedule).
#define SDT_K7_ARGS \
  indptr, indices, g, b, out, m, n, nnz, round_len, span, alpha, scale, \
      batch, st, shared, stream
#define SDT_K7_LANES(V)                                                    \
  switch (lanes) {                                                         \
    case 2: return launch_spans<T, I, 2, V, 1>(SDT_K7_ARGS);               \
    case 4: return launch_spans<T, I, 4, V, 1>(SDT_K7_ARGS);               \
    case 8: return launch_spans<T, I, 8, V, 1>(SDT_K7_ARGS);               \
    case 16: return launch_spans<T, I, 16, V, 1>(SDT_K7_ARGS);             \
    case 32:                                                               \
      return per_lane == 2 ? launch_spans<T, I, 32, V, 2>(SDT_K7_ARGS)     \
                           : launch_spans<T, I, 32, V, 1>(SDT_K7_ARGS);    \
    default: return cudaErrorInvalidValue;                                 \
  }
  if (per_lane != 1 && (per_lane != 2 || lanes != 32)) {
    return cudaErrorInvalidValue;
  }
  if (vec == kVec) SDT_K7_LANES(kVec)
  if (vec == 1) SDT_K7_LANES(1)
#undef SDT_K7_LANES
#undef SDT_K7_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace sdt

// batch members (at most kMaxMembers, grid.y's limit), each operand at
// its member stride in elements (0: shared); batch 1 is one product.
// shared: 1, or the members a group serves at once with B shared (2, 4).
extern "C" int sdt_csr_sddmm(int dtype, int itype, const void* indptr,
                             const void* indices, const void* g,
                             const void* b, void* out, int64_t m, int64_t n,
                             int64_t nnz, int vec, int lanes, int per_lane,
                             int round_len, int64_t span, double alpha_re,
                             double alpha_im, int64_t batch, int64_t s_g,
                             int64_t s_b, int64_t s_out, int shared,
                             void* stream) {
  SDT_DISPATCH(dtype, itype, sdt::launch, indptr, indices, g, b, out, m, n,
               nnz, vec, lanes, per_lane, round_len, span, alpha_re, alpha_im,
               batch, s_g, s_b, s_out, shared,
               static_cast<cudaStream_t>(stream))
}
