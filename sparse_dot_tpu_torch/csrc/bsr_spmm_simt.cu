// K1, CUDA-core variant: BSR SpMM, C = alpha * A @ B + beta * C0, for BSR
// A with square bs x bs blocks and row-major B.  ops/bsr.py sends here the
// cases the tensor-core variant (bsr_spmm.cu) does not take: complex
// values, and block sizes that are not multiples of 8.
//
// Replaces sparse_dot_tpu/ops/pallas_bsr.py bsr_spmm_pallas (Pallas body
// _kernel).  On the TPU the grid walked (128-column B panel, stored block)
// in order on one core, with block coordinates scalar-prefetched and the
// C tile kept resident in VMEM across a block row; unvisited block rows
// were zero-filled after the call.  Hopper runs blocks in parallel and in
// no order, so here one thread block owns one output tile (up to 64 rows
// of one block row x 64 columns of B) and walks that block row's stored
// blocks through indptr, in CSR block order.  The tile's sum lives in
// registers for the whole walk: no atomics, no ordering across blocks,
// and every output element is written once, so block rows with no stored
// block get beta * C0 or 0 without a fix-up pass.
//
// Bound: the CUDA cores' multiply-add rate and shared-memory traffic
// (each inner step reads MAXR values of A and 2 of B from shared memory
// for 2 * MAXR multiply-adds), and the longest block row, which one
// thread block walks alone.  Design: A's sub-block and B's panel are
// staged in shared memory in chunks of kTK rows of the inner dimension,
// each thread keeps MAXR x 2 accumulators and reuses every B value it
// loads from shared memory for MAXR rows.  Plain FMA in the element type,
// no tensor cores.  Any square bs and any n are taken; ragged rows, inner
// chunks and columns are masked, and B is not padded to a panel width.
//
// A batch of members that share A's pattern is one launch: the member is
// blockIdx.z, and the blocks, B, C0 and C each have a member stride (0
// for an operand all members share).  A single product is the instance
// with BATCH false, whose code has no member offsets.
#include "common.cuh"

namespace sdt {
namespace {

constexpr int kThreads = 256;
constexpr int kTX = 32;             // threads across the columns of a tile
constexpr int kTY = kThreads / kTX;  // thread rows
constexpr int kTN = 2 * kTX;        // columns of B per tile
constexpr int kTK = 16;             // inner-dimension chunk staged at once

// Member strides, in elements, of a batched launch (0: shared).
struct Strides {
  int64_t data, b, c0, c;
};

// With BATCH, blockIdx.z is the member.
template <typename T, typename I, int MAXR, bool BATCH>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const I* __restrict__ indptr, const I* __restrict__ indices,
                const T* __restrict__ data, const T* __restrict__ b,
                const T* __restrict__ c0, T* __restrict__ c, int bs,
                int row_tiles, int64_t n, T alpha, T beta, bool scale,
                Strides st) {
  using A = Arith<T>;
  if constexpr (BATCH) {
    const int64_t z = blockIdx.z;
    data += z * st.data;
    b += z * st.b;
    if (c0 != nullptr) c0 += z * st.c0;
    c += z * st.c;
  }
  constexpr int TM = kTY * MAXR;  // rows of the block row per thread block
  // Raw bytes: complex element types may not be declared __shared__.
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);  // [TM][kTK]
  T* Bs = As + TM * kTK;               // [kTK][kTN]

  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int64_t brow = blockIdx.x / row_tiles;
  const int r0 = (blockIdx.x % row_tiles) * TM;
  const int64_t col_base = static_cast<int64_t>(blockIdx.y) * kTN;
  const int64_t bs2 = static_cast<int64_t>(bs) * bs;

  T acc[MAXR][2];
#pragma unroll
  for (int i = 0; i < MAXR; ++i) acc[i][0] = acc[i][1] = A::zero();

  const int64_t pend = static_cast<int64_t>(indptr[brow + 1]);
  for (int64_t p = static_cast<int64_t>(indptr[brow]); p < pend; ++p) {
    const T* __restrict__ blk = data + p * bs2;
    const T* __restrict__ bpanel =
        b + static_cast<int64_t>(indices[p]) * bs * n + col_base;
    for (int k0 = 0; k0 < bs; k0 += kTK) {
      for (int e = threadIdx.x; e < TM * kTK; e += kThreads) {
        const int r = r0 + e / kTK;
        const int k = k0 + e % kTK;
        As[e] = (r < bs && k < bs) ? blk[static_cast<int64_t>(r) * bs + k]
                                   : A::zero();
      }
      for (int e = threadIdx.x; e < kTK * kTN; e += kThreads) {
        const int k = k0 + e / kTN;
        const int cc = e % kTN;
        Bs[e] = (k < bs && col_base + cc < n)
                    ? bpanel[static_cast<int64_t>(k) * n + cc]
                    : A::zero();
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kTK; ++kk) {
        const T b0 = Bs[kk * kTN + tx];
        const T b1 = Bs[kk * kTN + tx + kTX];
#pragma unroll
        for (int i = 0; i < MAXR; ++i) {
          const T a = As[(ty + kTY * i) * kTK + kk];
          acc[i][0] = A::fma(a, b0, acc[i][0]);
          acc[i][1] = A::fma(a, b1, acc[i][1]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < MAXR; ++i) {
    const int r = r0 + ty + kTY * i;
    if (r >= bs) continue;
    const int64_t row = brow * bs + r;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int64_t col = col_base + tx + kTX * j;
      if (col < n) {
        const int64_t idx = row * n + col;
        c[idx] = epilogue(acc[i][j], c0, idx, alpha, beta, scale);
      }
    }
  }
}

template <typename T, typename I, int MAXR>
void launch_rows(const void* indptr, const void* indices, const void* data,
                 const void* b, const void* c0, void* c, int64_t nbrows,
                 int bs, int64_t n, T alpha, T beta, bool scale,
                 int64_t batch, Strides st, cudaStream_t stream) {
  constexpr int TM = kTY * MAXR;
  const int row_tiles = (bs + TM - 1) / TM;
  const dim3 grid(static_cast<unsigned>(nbrows * row_tiles),
                  static_cast<unsigned>((n + kTN - 1) / kTN),
                  static_cast<unsigned>(batch));
  const size_t smem = sizeof(T) * (TM * kTK + kTK * kTN);
  auto kernel = batch == 1 ? bsr_spmm_kernel<T, I, MAXR, false>
                           : bsr_spmm_kernel<T, I, MAXR, true>;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const I*>(indptr), static_cast<const I*>(indices),
      static_cast<const T*>(data), static_cast<const T*>(b),
      static_cast<const T*>(c0), static_cast<T*>(c), bs, row_tiles, n, alpha,
      beta, scale, st);
}

template <typename T, typename I>
cudaError_t launch(const void* indptr, const void* indices, const void* data,
                   const void* b, const void* c0, void* c, int64_t nbrows,
                   int64_t bs, int64_t n, double alpha_re, double alpha_im,
                   double beta_re, double beta_im, int64_t batch,
                   int64_t s_data, int64_t s_b, int64_t s_c0, int64_t s_c,
                   cudaStream_t stream) {
  if (bs < 1 || bs > (1 << 20) || batch < 1 || batch > kMaxMembers ||
      s_data < 0 || s_b < 0 || s_c0 < 0 || s_c < 0)
    return cudaErrorInvalidValue;
  const T alpha = Arith<T>::make(alpha_re, alpha_im);
  const T beta = Arith<T>::make(beta_re, beta_im);
  const bool scale = !is_one(alpha_re, alpha_im);
  const int ibs = static_cast<int>(bs);
  const Strides st{s_data, s_b, s_c0, s_c};
  // Fewest thread rows that cover the block: small blocks keep one
  // accumulator row per thread, blocks of 64 and more take 64 rows per
  // thread block and split taller blocks across thread blocks.
  if (ibs <= kTY) {
    launch_rows<T, I, 1>(indptr, indices, data, b, c0, c, nbrows, ibs, n, alpha, beta, scale, batch, st, stream);
  } else if (ibs <= 2 * kTY) {
    launch_rows<T, I, 2>(indptr, indices, data, b, c0, c, nbrows, ibs, n, alpha, beta, scale, batch, st, stream);
  } else if (ibs <= 4 * kTY) {
    launch_rows<T, I, 4>(indptr, indices, data, b, c0, c, nbrows, ibs, n, alpha, beta, scale, batch, st, stream);
  } else {
    launch_rows<T, I, 8>(indptr, indices, data, b, c0, c, nbrows, ibs, n, alpha, beta, scale, batch, st, stream);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdt

// batch members (at most kMaxMembers, grid.z's limit), each operand at
// its member stride in elements (0: shared); batch 1 is one product.
extern "C" int sdt_bsr_spmm_simt(int dtype, int itype, const void* indptr,
                                 const void* indices, const void* data,
                                 const void* b, const void* c0, void* c,
                                 int64_t nbrows, int64_t bs, int64_t n,
                                 double alpha_re, double alpha_im,
                                 double beta_re, double beta_im,
                                 int64_t batch, int64_t s_data, int64_t s_b,
                                 int64_t s_c0, int64_t s_c, void* stream) {
  SDT_DISPATCH(dtype, itype, sdt::launch, indptr, indices, data, b, c0, c,
               nbrows, bs, n, alpha_re, alpha_im, beta_re, beta_im, batch,
               s_data, s_b, s_c0, s_c, static_cast<cudaStream_t>(stream))
}
