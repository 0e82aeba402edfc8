// K8, tensor-core variant: block SDDMM, for each stored block b of a BSR A
// with square bs x bs blocks at block coordinates (r_b, c_b),
//
//   out[b] = alpha * G[r_b bs : (r_b + 1) bs, :] @ B[c_b bs : (c_b + 1) bs, :]^T
//
// a bs x bs block, with row-major G (m, n) and B (k, n), real values (f32,
// f64) and bs % 8 == 0.  It is the gradient of C = A @ B (K1) with respect
// to A's blocks (G = dL/dC).  Complex values and other block sizes take
// the CUDA-core variant in bsr_sddmm_simt.cu (the choice is made in
// ops/bsr.py, uses_tensor_cores, before the launch).
//
// Replaces the transpose of sparse_dot_tpu/ops/_xla.py bsr_spmm (:799)
// under jax.grad: XLA turns its batched dot_general over gathered B
// panels into a second batched product of the gathered G block rows and
// B panels, through an nblocks x bs x n intermediate for each.
//
// What bounds it.  Each stored block is a bs x bs x n product:
// 2 * nblocks * bs^2 * n FLOPs, 1.72 GFLOP at BASELINE config 3 (8192^2,
// 5% of 64 x 64 blocks, n = 256), against G's and B's strips (each block
// row once, 8-17 MB) and the blocks written (27 MB in f64).  That is
// 0.026 ms of f64 tensor-core work at 67 TFLOP/s against 0.013 ms of
// memory: the tensor cores bound it, as they bound K1 on the same FLOPs.
// The CUDA-core variant it replaces at these shapes reached 11.6 TFLOP/s
// in f64, a third of the CUDA cores' peak, a sixth of the tensor cores'.
//
// The design, K1's tensor-core arithmetic (mma.cuh) on K8's layout:
// - f64 on mma.sync m16n8k4 (DMMA, IEEE products and sums); f32 on
//   3xTF32 with each k8 step's hi*hi added in IEEE f32 in fresh
//   registers, so the tensor cores' round-toward-zero sums do not drift
//   over the n / 8 steps of a tile; where hi is inf or nan, lo is 0.
// - A thread block owns a BM x BM tile of one stored block's output (BM
//   16, 32 or 64 from bs; larger blocks take several tiles): G's strip
//   (BM rows x n, row-major) times B's strip transposed.  B's row-major
//   strip is already the .col operand of the MMA, so both strips are
//   staged the same way, 128 bytes of n a row at a time, and neither is
//   transposed.
// - A ring of kStages such chunks of both strips in dynamic shared
//   memory (40 KB for f64's 64-row tile), filled by cp.async: the next
//   chunk is in flight while the tensor cores work on the current one.
//   16-byte copies where n and the pointers allow them, element copies
//   otherwise; rows past bs and columns past n are zero-filled.
// - Each sum is taken in one fixed order in one set of registers, each
//   output written by one thread, no atomics: a run gives the same bits
//   twice.
//
// A batch of members that share A's pattern (the backward of a vmap over
// the blocks or over b, jacrev's cotangents, a batched tangent) is one
// launch: the member is blockIdx.z (gridDim.y already holds up to 255^2
// tiles), and G, B and the output each have a member stride, 0 for the
// operand that all members share.  A single product is the instance with
// BATCH false, whose code has no member offsets.
#include <type_traits>

#include "mma.cuh"

namespace sdt {
namespace {

constexpr int kMaxTiles = 255;  // tiles a side: gridDim.y holds 255^2
// Depth of the cp.async ring: two chunks measured faster than three at
// config 3 in f64 and f32 (more blocks an SM).
constexpr int kStages = 2;

// Member strides, in elements, of a batched launch (0: shared).
struct Strides {
  int64_t g, b, out;
};

// Tile shape for element type T and BM x BM outputs.  The inner chunk is
// 128 bytes of n (BK elements); a staged row's pitch of BK + 4 puts a
// fragment load's 32 lanes on distinct banks (two halves of 16 for 8-byte
// values).
template <typename T, int BM>
struct Tile {
  static constexpr int BK = 128 / static_cast<int>(sizeof(T));
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // per 16 B
  static constexpr int kWarpsM = BM >= 32 ? 2 : 1;
  static constexpr int kWarpsN = 2;
  static constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  // Blocks an SM holds at least: 4 (128 registers a thread), 3 for f32's
  // 64-tile, whose operand splits need up to 170.
  static constexpr int kMinBlocks = BM == 64 && sizeof(T) == 4 ? 3 : 4;
  static constexpr int WM = BM / kWarpsM;  // rows per warp
  static constexpr int WN = BM / kWarpsN;  // columns per warp
  static constexpr int MT = WM / 16;       // m16 tiles per warp
  static constexpr int NT = WN / 8;        // n8 tiles per warp
  static constexpr int kPitch = BK + 4;
  static constexpr int kStage = BM * kPitch;
  static constexpr size_t kSmem = sizeof(T) * kStages * 2 * kStage;
};

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
template <typename T, typename I, int BM, bool BATCH>
__global__ void __launch_bounds__(Tile<T, BM>::kThreads,
                                  Tile<T, BM>::kMinBlocks)
bsr_sddmm_tc_kernel(const I* __restrict__ indptr, int64_t nbrows,
                    const I* __restrict__ indices, const T* __restrict__ g,
                    const T* __restrict__ b, T* __restrict__ out, int bs,
                    int tiles, int64_t n, T alpha, bool scale, bool vec,
                    Strides st) {
  if constexpr (BATCH) {
    const int64_t z = blockIdx.z;
    g += z * st.g;
    b += z * st.b;
    out += z * st.out;
  }
  using L = Tile<T, BM>;
  constexpr int BK = L::BK;
  constexpr int V = L::kVec;
  constexpr int kThreads = L::kThreads;
  using Op = Operand<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int S = kStages;
  T* Gs = reinterpret_cast<T*>(smem);  // [S][BM][kPitch]
  T* Bs = Gs + S * L::kStage;          // [S][BM][kPitch]

  const int64_t blk = blockIdx.x;
  const int i0 = static_cast<int>(blockIdx.y / tiles) * BM;
  const int j0 = static_cast<int>(blockIdx.y % tiles) * BM;
  const int64_t brow = block_row(indptr, nbrows, blk);
  const T* __restrict__ gstrip = g + (brow * bs + i0) * n;
  const T* __restrict__ bstrip =
      b + (static_cast<int64_t>(indices[blk]) * bs + j0) * n;
  const int64_t nsteps = (n + BK - 1) / BK;

  // Issue the copies of chunk s (columns [s BK, (s + 1) BK) of n) of both
  // strips into ring stage `stage`.
  auto load = [&](int64_t s, int stage) {
    const int64_t k0 = s * BK;
    T* gs = Gs + stage * L::kStage;
    T* bsm = Bs + stage * L::kStage;
    constexpr int kVecs = BM * BK / V;  // 16-byte vectors of a chunk
#pragma unroll
    for (int i = 0; i < (kVecs + kThreads - 1) / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (kVecs % kThreads != 0 && e >= kVecs) break;
      const int r = e / (BK / V);
      const int kv = (e % (BK / V)) * V;
      const bool g_ok = i0 + r < bs;
      const bool b_ok = j0 + r < bs;
      const int64_t off = static_cast<int64_t>(r) * n + k0 + kv;
      T* gd = gs + r * L::kPitch + kv;
      T* bd = bsm + r * L::kPitch + kv;
      if (vec) {  // n % V == 0: a vector is wholly inside or outside
        const bool in = k0 + kv < n;
        cp_async16(gd, g_ok && in ? gstrip + off : g, g_ok && in);
        cp_async16(bd, b_ok && in ? bstrip + off : b, b_ok && in);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const bool in = k0 + kv + v < n;
          cp_async_elem<sizeof(T)>(gd + v, g_ok && in ? gstrip + off + v : g,
                                   g_ok && in);
          cp_async_elem<sizeof(T)>(bd + v, b_ok && in ? bstrip + off + v : b,
                                   b_ok && in);
        }
      }
    }
  };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp % L::kWarpsM) * L::WM;
  const int wn = (warp / L::kWarpsM) * L::WN;
  const int gq = lane / 4;
  const int t = lane % 4;

  T acc[L::MT][L::NT][4], acc_lo[L::MT][L::NT][4];
#pragma unroll
  for (int i = 0; i < L::MT; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = acc_lo[i][j][q] = T(0);

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nsteps) load(s, s);
    cp_async_commit();
  }
  for (int64_t s = 0; s < nsteps; ++s) {
    cp_async_wait<S - 2>();
    __syncthreads();  // chunk s has landed; chunk s - 1's stage is free
    if (s + S - 1 < nsteps)
      load(s + S - 1, static_cast<int>((s + S - 1) % S));
    cp_async_commit();
    const int stage = static_cast<int>(s % S);
    const T* gs = Gs + stage * L::kStage;
    const T* bsm = Bs + stage * L::kStage;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      typename Op::type af[L::MT][4], bf[L::NT][2];
#pragma unroll
      for (int i = 0; i < L::MT; ++i) {
        const T* ap = gs + (wm + i * 16 + gq) * L::kPitch + kk + t;
        af[i][0] = Op::make(ap[0]);
        af[i][1] = Op::make(ap[8 * L::kPitch]);
        af[i][2] = Op::make(ap[4]);
        af[i][3] = Op::make(ap[8 * L::kPitch + 4]);
      }
      // B[k][col] of the MMA is B's strip at row col, column k.
#pragma unroll
      for (int j = 0; j < L::NT; ++j) {
        const T* bp = bsm + (wn + j * 8 + gq) * L::kPitch + kk + t;
        bf[j][0] = Op::make(bp[0]);
        bf[j][1] = Op::make(bp[4]);
      }
#pragma unroll
      for (int i = 0; i < L::MT; ++i)
#pragma unroll
        for (int j = 0; j < L::NT; ++j)
          mma_k8(acc[i][j], acc_lo[i][j], af[i], bf[j]);
    }
  }

  // Accumulator q of tile (i, j) is row gq (+8 for q >= 2), column
  // 2t + (q & 1) of that tile.
  T* __restrict__ oblk = out + blk * bs * bs;
#pragma unroll
  for (int i = 0; i < L::MT; ++i) {
#pragma unroll
    for (int q2 = 0; q2 < 2; ++q2) {
      const int row = i0 + wm + i * 16 + gq + 8 * q2;
      if (row >= bs) continue;
#pragma unroll
      for (int j = 0; j < L::NT; ++j) {
#pragma unroll
        for (int q1 = 0; q1 < 2; ++q1) {
          const int col = j0 + wn + j * 8 + 2 * t + q1;
          if (col >= bs) continue;
          const int q = 2 * q2 + q1;
          T v = acc[i][j][q];
          if constexpr (std::is_same<T, float>::value) v += acc_lo[i][j][q];
          oblk[static_cast<int64_t>(row) * bs + col] = scale ? alpha * v : v;
        }
      }
    }
  }
}

template <typename T, typename I, int BM>
cudaError_t launch_tiles(const void* indptr, int64_t nbrows,
                         const void* indices, int64_t nblocks, const void* g,
                         const void* b, void* out, int bs, int64_t n,
                         T alpha, bool scale, bool vec, int64_t batch,
                         Strides st, cudaStream_t stream) {
  using L = Tile<T, BM>;
  const int tiles = (bs + BM - 1) / BM;
  if (tiles > kMaxTiles) return cudaErrorInvalidValue;
  auto kernel = batch == 1 ? bsr_sddmm_tc_kernel<T, I, BM, false>
                           : bsr_sddmm_tc_kernel<T, I, BM, true>;
  if (L::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kSmem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(nblocks),
                  static_cast<unsigned>(tiles * tiles),
                  static_cast<unsigned>(batch));
  kernel<<<grid, L::kThreads, L::kSmem, stream>>>(
      static_cast<const I*>(indptr), nbrows, static_cast<const I*>(indices),
      static_cast<const T*>(g), static_cast<const T*>(b),
      static_cast<T*>(out), bs, tiles, n, alpha, scale, vec, st);
  return cudaGetLastError();
}

// The smallest tile that covers the block, 64 rows at most (larger
// blocks take several tiles).
template <typename T, typename I>
cudaError_t launch_tile(const void* indptr, int64_t nbrows,
                        const void* indices, int64_t nblocks, const void* g,
                        const void* b, void* out, int bs, int64_t n,
                        T alpha, bool scale, bool vec, int64_t batch,
                        Strides st, cudaStream_t stream) {
  if (bs <= 16) {
    return launch_tiles<T, I, 16>(indptr, nbrows, indices, nblocks,
                                           g, b, out, bs, n, alpha, scale,
                                           vec, batch, st, stream);
  }
  if (bs <= 32) {
    return launch_tiles<T, I, 32>(indptr, nbrows, indices, nblocks,
                                           g, b, out, bs, n, alpha, scale,
                                           vec, batch, st, stream);
  }
  return launch_tiles<T, I, 64>(indptr, nbrows, indices, nblocks,
                                         g, b, out, bs, n, alpha, scale, vec,
                                         batch, st, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, typename I>
cudaError_t launch(const void* indptr, int64_t nbrows, const void* indices,
                   int64_t nblocks, const void* g, const void* b, void* out,
                   int64_t bs, int64_t n, double alpha_re, double alpha_im,
                   int64_t batch, int64_t s_g, int64_t s_b, int64_t s_out,
                   cudaStream_t stream) {
  if constexpr (!std::is_floating_point<T>::value) {
    return cudaErrorInvalidValue;  // complex values take the SIMT variant
  } else {
    if (bs < 8 || bs % 8 || bs > (1 << 20) || nblocks > 0x7fffffff ||
        n < 1 || batch < 1 || batch > kMaxMembers || s_g < 0 || s_b < 0 ||
        s_out < 0) {
      return cudaErrorInvalidValue;
    }
    if (nblocks == 0) return cudaSuccess;
    const T alpha = static_cast<T>(alpha_re);  // real values
    const bool scale = !is_one(alpha_re, alpha_im);
    // 16-byte copies need every member's rows on 16 bytes too.
    const bool vec = aligned16(g) && aligned16(b) &&
                     n % (16 / static_cast<int64_t>(sizeof(T))) == 0 &&
                     ((s_g | s_b) * static_cast<int64_t>(sizeof(T))) % 16 == 0;
    return launch_tile<T, I>(indptr, nbrows, indices, nblocks, g, b, out,
                             static_cast<int>(bs), n, alpha, scale, vec,
                             batch, Strides{s_g, s_b, s_out}, stream);
  }
}

}  // namespace
}  // namespace sdt

// batch members (at most kMaxMembers, grid.z's limit), each operand at
// its member stride in elements (0: shared); batch 1 is one product.
extern "C" int sdt_bsr_sddmm_tc(int dtype, int itype, const void* indptr,
                                int64_t nbrows, const void* indices,
                                int64_t nblocks, const void* g, const void* b,
                                void* out, int64_t bs, int64_t n,
                                double alpha_re, double alpha_im,
                                int64_t batch, int64_t s_g, int64_t s_b,
                                int64_t s_out, void* stream) {
  SDT_DISPATCH(dtype, itype, sdt::launch, indptr, nbrows, indices, nblocks,
               g, b, out, bs, n, alpha_re, alpha_im, batch, s_g, s_b, s_out,
               static_cast<cudaStream_t>(stream))
}
