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
// accumulator update (a sorted key, or a dense row's slot), after a chain
// of dependent loads (row id, op(A)'s indptr and entry, op(B)'s indptr
// and column); rows are bound by that latency, not by bytes.  The row bins of ops/spgemm.py (spgemm_bins) choose, per row,
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
//   - kSortedWarp (32 < ub <= U, U = 128 or 512): one warp a row, 8 a
//     block, every lane on a product.  The warp takes the row's products
//     32 at a time with the register path's scan and search (op(A)'s
//     entries 32 at a time, the count carried across chunks), so no
//     lane waits on an op(A) entry whose op(B) row is short.  Each
//     product's key (column << 9) | product index stays in a register
//     (32-bit keys when n < 2^23), and K5 stages its op(A) and op(B)
//     entries in the warp's region of shared memory, sized to the bin's
//     U products (nothing zeroed); the warp sorts pow2(ub) keys (U / 2
//     or U) in registers by a bitonic network of shuffles and register
//     exchanges, and the first key of each column's run counts it (K4)
//     or folds the run in product order from zero, reading the values
//     through the staged entries, and writes it (K5).  No atomics, no
//     table to clear, no sort of a hash table's empty slots;
//   - kSortedBlock (U / 4 < ub <= U, U = 2048 or 8192): the same over a
//     256-thread block, one row a block, every thread on a product.  The
//     block takes op(A)'s entries 256 at a time, scans their op(B) row
//     lengths across the block (the count carried across chunks) and
//     finds each thread's product by a binary search of the scan in
//     shared memory, 256 products a round; a thread keeps each of its
//     products' key (column << log2 U) | product index in a register
//     (32-bit keys when n < 2^(32 - log2 U)), and K5 stages its op(A) and
//     op(B) entries in the block's region (nothing zeroed).  K5 sorts
//     pow2(ub) keys (U / 2 or U): each warp its part in registers and
//     shuffles, the strides that cross warps in shared memory, a block
//     sync a stage; the heads fold their runs in product order as in
//     kSortedWarp, a run crossing from one warp's part into the next.  K4
//     needs no order: it inserts the columns into a table of pow2(2 ub)
//     slots in shared memory (only those cleared) and counts the fresh
//     inserts;
//   - kDenseShared: one block per row, a dense row of width n (values and
//     one flag byte per column) in shared memory, where it fits 200 KB;
//   - kDenseGlobal: the same dense row in a device workspace of
//     `work_groups` rows of round16(n * (sizeof(T) + 1)) bytes, at most
//     256 MB in all (ops/spgemm.py GLOBAL_WORKSPACE; at least one row),
//     for rows past the largest block bin when n is too wide for shared
//     memory.
// Each bin is one launch of a persistent grid that walks the bin's rows
// (read from the device), so K4 never waits for the bin sizes; K5 runs
// after the output's size was read, and its wrapper, which reads the bin
// sizes with it, marks the empty bins kSkip and bounds each grid by its
// bin's rows.
//
// Determinism: in the dense bins a row's entries of op(A) are walked one
// after another; the threads of the row split op(B)'s row k, whose
// columns are distinct, so no two threads touch one accumulator slot
// within a step, and a sync ends each step.  The register and
// sorted-product paths (of a warp or of a block) sort on (column,
// product index), so a column's products stay in op(A)'s stored order,
// and fold them with the same fma from zero.  Every value is thus summed
// in op(A)'s stored order with no float atomics: the same bits on every
// run, and on every path.  Only K4's block count inserts by atomicCAS,
// and a count does not depend on the order of the inserts.
//
// A batch of K5 fills whose members share op(A)'s and op(B)'s patterns
// (jax.vmap of esc_spgemm_block over the values; torch.func.vmap, jacfwd
// and hessian of csr_spgemm) is one launch a bin, the member on
// blockIdx.y: the plan, the bins and C's indptr are the patterns' and
// shared, op(A)'s and op(B)'s values and C's values have member strides
// (0 for an operand that all members share; C's values nnz(C) apart), and
// a kDenseGlobal group's workspace row is its member's own.  Every member
// builds each row from the same columns in the same order (the same
// sorted keys, the same flags), so C's column ids, which
// member 0 alone writes, are every member's.  The persistent grids give
// each member resident / batch blocks (at least one).  A single fill is
// the instance with BATCH false, whose code has no member offsets.
//
// A batch whose members can share the patterns' work takes
// csr_spgemm_group.cu's instances (M members a block); the code of the
// row kernels lives in csr_spgemm.cuh, and that of the block-sorted bins
// in csr_spgemm_block.cuh, whose instances csr_spgemm_block.cu,
// csr_spgemm_block_batched.cu and csr_spgemm_block_group2.cu / _group4.cu
// build beside these (kSortedBlock's launches go through them).
#include "csr_spgemm.cuh"

namespace sdt {
namespace {

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
  const Args<T, I> args = fill_args<T, I>(
      a_indptr, a_indices, a_data, b_indptr, b_indices, b_data, rows,
      offsets, n, triangular, c_indptr, c_indices, c_data);
  auto* ws = static_cast<unsigned char*>(work);
  const Batch members{batch,
                      Members{s_a, s_b, s_c, write_indices != 0, batch}};
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
