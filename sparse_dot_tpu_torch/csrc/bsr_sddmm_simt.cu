// K8, CUDA-core variant: block SDDMM, for each stored block b of a BSR A
// with square bs x bs blocks at block coordinates (r_b, c_b),
//
//   out[b] = alpha * G[r_b bs : (r_b + 1) bs, :] @ conj(B[c_b bs : (c_b + 1) bs, :])^T
//
// a bs x bs block, with row-major G (m, n) and B (k, n); conj only for
// complex values.  It is the gradient of C = A @ B (K1) with respect to
// A's blocks (G = dL/dC), as PyTorch's convention for complex gradients
// has it.  It serves complex values and block sizes that are not a
// multiple of 8; real values with bs % 8 == 0 take the tensor-core
// variant in bsr_sddmm.cu (the choice is made in ops/bsr.py,
// uses_tensor_cores).
//
// Replaces the transpose of sparse_dot_tpu/ops/_xla.py bsr_spmm (:799)
// under jax.grad: XLA turns its batched dot_general over gathered B
// panels into a second batched product of the gathered G block rows and
// B panels, through an nblocks x bs x n intermediate for each.
//
// Bound: bs * bs * n multiply-adds a stored block against bs * n values of
// G and of B read and bs * bs written, so at bs = 64 and n = 256 the
// operations bound it; below about bs = 8 the bytes do.  The design:
//
// - a thread block owns one tile (at most 64 x 64) of one stored block's
//   output, found from blockIdx: x the stored block, y the tile; the block
//   row r_b is the last row whose indptr is at or below b (a binary search
//   of indptr by every thread, on the same addresses);
// - it walks n in chunks of kTK columns, staging the chunk of the tile's
//   rows of G and of B in shared memory (rows padded by one element, so a
//   warp's reads of B's rows fall in distinct banks), and each thread keeps
//   R x R sums, reusing each value it reads from shared memory R times;
//   tiles of 8, 16, 32 and 64 rows (8 x 8 or 16 x 16 threads, R of 1, 2 or
//   4) follow bs, and ragged rows and columns are masked;
// - plain IEEE FMA in the value type (no TF32), each sum in ascending
//   column order in one register: every output is written by one thread,
//   with no atomics, and a run gives the same bits twice.
//
// A batch of members that share A's pattern (the backward of a vmap over
// the blocks or over b, jacrev's cotangents, a batched tangent) is one
// launch: the member is blockIdx.z (gridDim.y already holds up to 255^2
// tiles), and G, B and the output each have a member stride, 0 for the
// operand that all members share.  A single product is the instance with
// BATCH false, whose code has no member offsets.
#include "common.cuh"

namespace sdt {
namespace {

constexpr int kTK = 16;         // columns of n staged at once
constexpr int kPad = kTK + 1;   // a staged row's stride, in elements
constexpr int kMaxTiles = 255;  // tiles a side: gridDim.y holds 255^2

// Member strides, in elements, of a batched launch (0: shared).
struct Strides {
  int64_t g, b, out;
};

__device__ __forceinline__ float conj_of(float v) { return v; }
__device__ __forceinline__ double conj_of(double v) { return v; }
template <typename R>
__device__ __forceinline__ cuda::std::complex<R> conj_of(
    cuda::std::complex<R> v) {
  return cuda::std::complex<R>(v.real(), -v.imag());
}

// The block row of stored block b: the last r with indptr[r] <= b (so
// indptr[r] <= b < indptr[r + 1], across empty block rows).
template <typename I>
__device__ __forceinline__ int64_t block_row(const I* __restrict__ indptr,
                                             int64_t nbrows, int64_t b) {
  int64_t lo = 0, hi = nbrows;  // indptr[lo] <= b < indptr[hi]
  while (hi - lo > 1) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (static_cast<int64_t>(indptr[mid]) <= b) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// With BATCH, blockIdx.z is the member.
template <typename T, typename I, int TX, int R, bool BATCH>
__global__ void __launch_bounds__(TX * TX)
bsr_sddmm_kernel(const I* __restrict__ indptr, int64_t nbrows,
                 const I* __restrict__ indices, const T* __restrict__ g,
                 const T* __restrict__ b, T* __restrict__ out, int bs,
                 int tiles, int64_t n, T alpha, bool scale, Strides st) {
  if constexpr (BATCH) {
    const int64_t z = blockIdx.z;
    g += z * st.g;
    b += z * st.b;
    out += z * st.out;
  }
  using A = Arith<T>;
  constexpr int kThreads = TX * TX;
  constexpr int TS = TX * R;  // the tile's side
  // Raw bytes: complex element types may not be declared __shared__.
  extern __shared__ __align__(16) unsigned char smem[];
  T* Gs = reinterpret_cast<T*>(smem);  // [TS][kPad]
  T* Bs = Gs + TS * kPad;              // [TS][kPad]

  const int64_t blk = blockIdx.x;
  const int i0 = static_cast<int>(blockIdx.y / tiles) * TS;
  const int j0 = static_cast<int>(blockIdx.y % tiles) * TS;
  const int64_t brow = block_row(indptr, nbrows, blk);
  const T* __restrict__ gstrip = g + (brow * bs + i0) * n;
  const T* __restrict__ bstrip =
      b + (static_cast<int64_t>(indices[blk]) * bs + j0) * n;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;

  T acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = A::zero();
  }

  for (int64_t k0 = 0; k0 < n; k0 += kTK) {
    for (int e = threadIdx.x; e < TS * kTK; e += kThreads) {
      const int r = e / kTK;
      const int c = e % kTK;
      const bool col_ok = k0 + c < n;
      const int64_t off = static_cast<int64_t>(r) * n + k0 + c;
      Gs[r * kPad + c] = (col_ok && i0 + r < bs) ? gstrip[off] : A::zero();
      Bs[r * kPad + c] =
          (col_ok && j0 + r < bs) ? conj_of(bstrip[off]) : A::zero();
    }
    __syncthreads();
    const int kmax = n - k0 < kTK ? static_cast<int>(n - k0) : kTK;
    for (int kk = 0; kk < kmax; ++kk) {
      T av[R], bv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) av[i] = Gs[(ty + TX * i) * kPad + kk];
#pragma unroll
      for (int j = 0; j < R; ++j) bv[j] = Bs[(tx + TX * j) * kPad + kk];
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i][j] = A::fma(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  T* __restrict__ oblk = out + blk * bs * bs;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = i0 + ty + TX * i;
    if (row >= bs) continue;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int col = j0 + tx + TX * j;
      if (col < bs) {
        oblk[static_cast<int64_t>(row) * bs + col] =
            scale ? A::mul(alpha, acc[i][j]) : acc[i][j];
      }
    }
  }
}

template <typename T, typename I, int TX, int R>
cudaError_t launch_tiles(const void* indptr, int64_t nbrows,
                         const void* indices, int64_t nblocks, const void* g,
                         const void* b, void* out, int bs, int64_t n,
                         T alpha, bool scale, int64_t batch, Strides st,
                         cudaStream_t stream) {
  constexpr int TS = TX * R;
  const int tiles = (bs + TS - 1) / TS;
  if (tiles > kMaxTiles) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(nblocks),
                  static_cast<unsigned>(tiles * tiles),
                  static_cast<unsigned>(batch));
  const size_t smem = sizeof(T) * 2 * TS * kPad;
  auto kernel = batch == 1 ? bsr_sddmm_kernel<T, I, TX, R, false>
                           : bsr_sddmm_kernel<T, I, TX, R, true>;
  kernel<<<grid, TX * TX, smem, stream>>>(
      static_cast<const I*>(indptr), nbrows, static_cast<const I*>(indices),
      static_cast<const T*>(g), static_cast<const T*>(b),
      static_cast<T*>(out), bs, tiles, n, alpha, scale, st);
  return cudaGetLastError();
}

template <typename T, typename I>
cudaError_t launch(const void* indptr, int64_t nbrows, const void* indices,
                   int64_t nblocks, const void* g, const void* b, void* out,
                   int64_t bs, int64_t n, double alpha_re, double alpha_im,
                   int64_t batch, int64_t s_g, int64_t s_b, int64_t s_out,
                   cudaStream_t stream) {
  if (bs < 1 || bs > (1 << 20) || nblocks > 0x7fffffff || n < 1 ||
      batch < 1 || batch > kMaxMembers || s_g < 0 || s_b < 0 || s_out < 0) {
    return cudaErrorInvalidValue;
  }
  if (nblocks == 0) return cudaSuccess;
  const T alpha = Arith<T>::make(alpha_re, alpha_im);
  const bool scale = !is_one(alpha_re, alpha_im);
  const Strides st{s_g, s_b, s_out};
  const int ibs = static_cast<int>(bs);
  // The smallest tile that covers the block, 64 rows at most (larger
  // blocks take several tiles).
  if (ibs <= 8) {
    return launch_tiles<T, I, 8, 1>(indptr, nbrows, indices, nblocks, g, b,
                                    out, ibs, n, alpha, scale, batch, st, stream);
  }
  if (ibs <= 16) {
    return launch_tiles<T, I, 16, 1>(indptr, nbrows, indices, nblocks, g, b,
                                     out, ibs, n, alpha, scale, batch, st, stream);
  }
  if (ibs <= 32) {
    return launch_tiles<T, I, 16, 2>(indptr, nbrows, indices, nblocks, g, b,
                                     out, ibs, n, alpha, scale, batch, st, stream);
  }
  return launch_tiles<T, I, 16, 4>(indptr, nbrows, indices, nblocks, g, b,
                                   out, ibs, n, alpha, scale, batch, st, stream);
}

}  // namespace
}  // namespace sdt

// batch members (at most kMaxMembers, grid.z's limit), each operand at
// its member stride in elements (0: shared); batch 1 is one product.
extern "C" int sdt_bsr_sddmm_simt(int dtype, int itype,
                                  const void* indptr, int64_t nbrows,
                                  const void* indices,
                                  int64_t nblocks, const void* g,
                                  const void* b, void* out, int64_t bs,
                                  int64_t n, double alpha_re,
                                  double alpha_im, int64_t batch,
                                  int64_t s_g, int64_t s_b, int64_t s_out,
                                  void* stream) {
  SDT_DISPATCH(dtype, itype, sdt::launch, indptr, nbrows, indices, nblocks,
               g, b, out, bs, n, alpha_re, alpha_im, batch, s_g, s_b, s_out,
               static_cast<cudaStream_t>(stream))
}
