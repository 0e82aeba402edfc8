// K3: CSR SpMV, y = alpha * A @ x + beta * y0, for CSR A.
//
// Replaces sparse_dot_tpu/ops/_xla.py ell_spmv (:769; padded ELL gather and
// row reduction) and coo_spmv (:138; gather and scatter-add).  No padded
// layout is built and nothing is scattered.
//
// Bound: every nonzero is one multiply-add against sizeof(I) + sizeof(T)
// bytes of A and one gathered element of x, so the kernel is bound by
// device-memory bytes (A's arrays, x, y).  A group of lanes per row stalls
// on three dependent round trips (indptr, then an index, then x) with one
// nonzero per lane in flight, too few bytes to fill HBM, and idles lanes
// on short rows.  The design, after CSR-Stream / CSR-Adaptive (Greathouse
// and Daga, SC'14):
//
// - Tiles of nonzeros on row boundaries (formats.csr_plan, built on the
//   device once per matrix and cached): tile t holds the rows whose first
//   nonzero lies in [t * kTile, (t + 1) * kTile), and the plan stores each
//   tile's first and end row and nonzero, so one load starts a tile.  A
//   row of at most kTile nonzeros that starts in a tile ends within
//   2 * kTile of the tile's start, so a tile's short rows span at most
//   kSpan nonzeros.
// - A warp takes a tile: it loads the tile's indices and values with
//   coalesced loads, kRound a lane issued together (a second round when
//   the span is longer), with the first rows' bounds beside them, then the x elements they name, again together,
//   and stores the products in its part of shared memory.  Then lanes sum
//   each row's segment of products in a fixed order (a row per lane, or G
//   lanes per row and shuffles when the tile has fewer rows than lanes)
//   and write y with the epilogue fused.  Warps need no block barrier, so
//   one warp's loads overlap another's sums.
// - A row longer than kTile can only be the last row of its tile.  It is
//   cut into chunks of kTile, each summed by a warp of the first blocks of
//   the launch into a workspace slot; the warp that finishes a row's last
//   chunk (an integer atomic count per row, in the plan, set back to 0 after
//   use) adds the row's partial sums in chunk order.  One launch, and no
//   float atomics: a run gives the same bits twice.  A plan's counts serve
//   one launch at a time, as the port's launches on one stream are.
#include "common.cuh"

namespace sdt {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// Nonzeros per tile; formats.SPMV_TILE holds the same number.
constexpr int kTile = 128;
constexpr int kSpan = 2 * kTile;
constexpr int kRound = kTile / 32;
constexpr int kUnroll = 2;
// Blocks that walk the chunks of long rows: one per SM of an H100.
constexpr int kChunkBlocks = 132;

// A warp a chunk: the chunk's partial sum goes to its workspace slot, and
// the last chunk of a row to finish (counts[first slot of the row] counts
// them) adds the row's partial sums in chunk order, writes y and sets the
// count back to 0 for the next launch.  So long rows need no second
// kernel, and the sum does not depend on which chunk finished last.
template <typename T, typename I>
__device__ __forceinline__ void long_row_chunks(
    const I* __restrict__ indptr, const I* __restrict__ indices,
    const T* __restrict__ data, const T* __restrict__ x,
    const T* __restrict__ y0, T* __restrict__ y, T* work,
    unsigned* counts, const int64_t* __restrict__ chunks, int64_t n_chunks,
    int chunk_blocks, T alpha, T beta, bool scale) {
  using A = Arith<T>;
  const int lane = threadIdx.x & 31;
  // The chunks fill slots 0, 1, ... and padding follows the last one.
  for (int64_t item = static_cast<int64_t>(blockIdx.x) * kWarps +
                      threadIdx.x / 32;
       item < n_chunks; item += static_cast<int64_t>(chunk_blocks) * kWarps) {
    const int64_t* it = chunks + 4 * item;
    const int64_t row = it[0];
    if (row < 0) break;
    const int64_t p1 = it[2];
    T acc = A::zero();
    for (int64_t p = it[1] + lane; p < p1; p += 32 * kUnroll) {
      I col[kUnroll];
      T val[kUnroll];
      T xv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p + 32 * u < p1) {
          col[u] = indices[p + 32 * u];
          val[u] = data[p + 32 * u];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p + 32 * u < p1) xv[u] = x[static_cast<int64_t>(col[u])];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p + 32 * u < p1) acc = A::add(acc, A::mul(val[u], xv[u]));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc = A::add(acc, A::shfl_xor(acc, off));
    }
    const int64_t start = static_cast<int64_t>(indptr[row]);
    const int64_t count =
        (static_cast<int64_t>(indptr[row + 1]) - start + kTile - 1) / kTile;
    const int64_t first = it[3] - (it[1] - start) / kTile;
    int last = 0;
    if (lane == 0) {
      work[it[3]] = acc;
      __threadfence();
      last = atomicAdd(counts + first, 1u) == count - 1;
    }
    if (!__shfl_sync(kFullMask, last, 0)) continue;
    __threadfence();
    T sum = A::zero();
    for (int64_t j = lane; j < count; j += 32) {
      sum = A::add(sum, load_cg(work + first + j));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum = A::add(sum, A::shfl_xor(sum, off));
    }
    if (lane == 0) {
      y[row] = epilogue(sum, y0, row, alpha, beta, scale);
      counts[first] = 0;
    }
  }
}

// Blocks [0, chunk_blocks) sum the chunks of long rows into work; warp w
// of the later blocks does tile (block - chunk_blocks) * kWarps + w.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
csr_spmv_kernel(const I* __restrict__ indptr, const I* __restrict__ indices,
                const T* __restrict__ data, const T* __restrict__ x,
                const T* __restrict__ y0, T* __restrict__ y,
                T* work, unsigned* counts,
                const int64_t* __restrict__ tiles, int64_t n_tiles,
                const int64_t* __restrict__ chunks, int64_t n_chunks,
                int chunk_blocks, T alpha, T beta, bool scale) {
  using A = Arith<T>;
  if (static_cast<int>(blockIdx.x) < chunk_blocks) {
    long_row_chunks<T, I>(indptr, indices, data, x, y0, y, work, counts,
                          chunks, n_chunks, chunk_blocks, alpha, beta, scale);
    return;
  }
  // Raw storage: complex element types have constructors.
  __shared__ __align__(16) unsigned char raw[kWarps * kSpan * sizeof(T)];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  T* prod = reinterpret_cast<T*>(raw) + warp * kSpan;

  const int64_t t =
      (static_cast<int64_t>(blockIdx.x) - chunk_blocks) * kWarps + warp;
  if (t >= n_tiles) return;
  const int64_t rb = tiles[4 * t];
  const int64_t rend = tiles[4 * t + 1];
  const int64_t lo = tiles[4 * t + 2];
  const int64_t hi = tiles[4 * t + 3];
  const int64_t nr = rend - rb;
  if (nr <= 0) return;  // the whole warp

  // G lanes per row: the largest power of two, at most 32, with G * nr
  // lanes fitting in the warp; then passes of 32 / G rows.
  int G = 1;
  while (G < 32 && 2 * G * nr <= 32) G *= 2;
  const int gl = lane % G;
  const int per_pass = 32 / G;
  // The first pass's row bounds, loaded beside the tile's entries.
  int64_t r = rb + lane / G;
  int64_t s = r < rend ? static_cast<int64_t>(indptr[r]) : 0;
  int64_t e = r < rend ? static_cast<int64_t>(indptr[r + 1]) : 0;

  // Rounds of kRound nonzeros a lane, a second only when the span needs
  // it: fewer registers, so more warps in flight.
  for (int64_t p0 = lo; p0 < hi; p0 += 32 * kRound) {
    I col[kRound];
    T val[kRound];
    T xv[kRound];
#pragma unroll
    for (int k = 0; k < kRound; ++k) {
      const int64_t p = p0 + lane + 32 * k;
      if (p < hi) {
        col[k] = indices[p];
        val[k] = data[p];
      }
    }
#pragma unroll
    for (int k = 0; k < kRound; ++k) {
      if (p0 + lane + 32 * k < hi) xv[k] = x[static_cast<int64_t>(col[k])];
    }
#pragma unroll
    for (int k = 0; k < kRound; ++k) {
      const int64_t p = p0 + lane + 32 * k;
      if (p < hi) prod[p - lo] = A::mul(val[k], xv[k]);
    }
  }
  __syncwarp();

  for (int64_t base = 0; base < nr; base += per_pass) {
    if (base > 0) {
      r = rb + base + lane / G;
      s = r < rend ? static_cast<int64_t>(indptr[r]) : 0;
      e = r < rend ? static_cast<int64_t>(indptr[r + 1]) : 0;
    }
    T acc = A::zero();
    for (int64_t q = s - lo + gl; q < e - lo; q += G) {
      acc = A::add(acc, prod[q]);
    }
    for (int off = G / 2; off > 0; off >>= 1) {
      acc = A::add(acc, A::shfl_down(acc, off, G));
    }
    if (r < rend && gl == 0) y[r] = epilogue(acc, y0, r, alpha, beta, scale);
  }
}

template <typename T, typename I>
cudaError_t launch(const void* indptr, const void* indices, const void* data,
                   const void* x, const void* y0, void* y, void* work,
                   void* counts, const void* tiles, int64_t n_tiles,
                   const void* chunks, int64_t n_chunks, int64_t m, int tile,
                   double alpha_re, double alpha_im, double beta_re,
                   double beta_im, cudaStream_t stream) {
  if (tile != kTile || m <= 0 || n_tiles <= 0 ||
      (n_chunks > 0 && (work == nullptr || counts == nullptr))) {
    return cudaErrorInvalidValue;
  }
  const int64_t wanted = (n_chunks + kWarps - 1) / kWarps;
  const int chunk_blocks =
      static_cast<int>(wanted < kChunkBlocks ? wanted : kChunkBlocks);
  const int64_t tile_blocks = (n_tiles + kWarps - 1) / kWarps;
  csr_spmv_kernel<T, I>
      <<<static_cast<unsigned>(chunk_blocks + tile_blocks), kThreads, 0,
         stream>>>(
          static_cast<const I*>(indptr), static_cast<const I*>(indices),
          static_cast<const T*>(data), static_cast<const T*>(x),
          static_cast<const T*>(y0), static_cast<T*>(y),
          static_cast<T*>(work), static_cast<unsigned*>(counts),
          static_cast<const int64_t*>(tiles), n_tiles,
          static_cast<const int64_t*>(chunks), n_chunks, chunk_blocks,
          Arith<T>::make(alpha_re, alpha_im), Arith<T>::make(beta_re, beta_im),
          !is_one(alpha_re, alpha_im));
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdt

extern "C" int sdt_csr_spmv(int dtype, int itype, const void* indptr,
                            const void* indices, const void* data,
                            const void* x, const void* y0, void* y,
                            void* work, void* counts, const void* tiles,
                            int64_t n_tiles, const void* chunks,
                            int64_t n_chunks, int64_t m, int tile,
                            double alpha_re, double alpha_im, double beta_re,
                            double beta_im, void* stream) {
  SDT_DISPATCH(dtype, itype, sdt::launch, indptr, indices, data, x, y0, y,
               work, counts, tiles, n_tiles, chunks, n_chunks, m, tile,
               alpha_re, alpha_im, beta_re, beta_im,
               static_cast<cudaStream_t>(stream))
}
