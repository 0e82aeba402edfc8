// K1, tensor-core variant: BSR SpMM, C = alpha * A @ B + beta * C0, for
// BSR A with square bs x bs blocks, bs % 8 == 0, in every value type
// (f32, f64, c64, c128), and row-major B.  Other block sizes go to the
// CUDA-core variant in bsr_spmm_simt.cu (the choice is made in ops/bsr.py,
// uses_tensor_cores).
//
// Replaces sparse_dot_tpu/ops/pallas_bsr.py bsr_spmm_pallas (Pallas body
// _kernel), which walked (128-column B panel, stored block) in order on
// one TPU core with the C tile resident in VMEM and needed
// Precision.HIGHEST for f32.
//
// What bounds it.  BASELINE config 3 (8192 x 8192, 5% of blocks, n = 256)
// is 2 * nblocks * bs^2 * n = 1.72 GFLOP per call and moves ~40 MB (f32)
// or ~80 MB (f64) of A, C0 and C through device memory, with B (8-17 MB)
// mostly read from L2.  On the H100 that is 0.026 ms of f64 tensor-core
// work (67 TFLOP/s) against 0.024 ms of memory (3.35 TB/s) in f64, and
// three TF32 products per multiply-add (5.2 GFLOP) plus the operand split
// in f32: the kernel is bound by the tensor cores' issue rate and by how
// evenly the work spreads over the 132 SMs, not by bytes.
//
// The design it replaces (PR 1, now bsr_spmm_simt.cu) gave one thread
// block a 64-row x 64-column tile of one block row and walked that row's
// stored blocks serially with plain FMA on the CUDA cores, staging each
// 16-deep chunk synchronously in shared memory.  It reached 8-11 TFLOP/s
// at config 3 and lost to one batched cuBLAS product at bs = 128, because
// (1) the kernel's time was that of the longest block row (8-9 blocks
// where the mean is 3.2), (2) every global load was waited for, (3) the
// CUDA cores do a quarter (f32) to a half (f64) of the tensor cores' work
// per cycle, and (4) a 128-row block row loaded each B panel twice.
//
// This design:
// - Tensor cores at full precision.  f64 uses mma.sync m16n8k4 f64 (IEEE
//   products and sums).  f32 uses 3xTF32 on mma.sync m16n8k8: each
//   operand x is split as hi = tf32(x), lo = x - hi (read by the tensor
//   cores to 11 bits) and the tile accumulates lo*hi + hi*lo + hi*hi in
//   f32, about 22 bits of each product where plain TF32 keeps 11 (which
//   fails the f32 tolerance).
//   The tensor cores' f32 sums round toward zero: accumulated in one set
//   of registers over config 3's ~150 MMAs per output, that bias reached
//   2.1e-5 on outputs of order 1, past decimal=5.  So each k8 step's
//   hi*hi lands in fresh registers and is added to the tile's sum on the
//   CUDA cores in IEEE f32, and the cross products accumulate apart.
//   Where hi is inf or nan, lo and the copy of hi used in the two cross
//   products are 0, so inf * finite stays inf and no inf * 0 appears.
// - Complex values take the same tiles, ring and plan (mma.cuh: four real
//   products a k4 or k8 step on the parts, read from interleaved complex
//   shared memory; c128 on f64 MMA, c64 on 3xTF32), with a complex
//   alpha/beta/C0 epilogue.  The CUDA-core kernel served them before:
//   one thread block per block row and 64 columns walked the whole row
//   (12.5 blocks on average, 25 at the longest, at phase 3's c128 BSR)
//   with each block staged behind two barriers, and every complex FMA
//   read two 16-byte values from shared memory.  A complex element
//   is 8 or 16 bytes, so the inner chunk is 16 elements (256 bytes of a
//   c128 row: one step a block at bs 16) and tiles are at most 32 rows
//   tall (the sums of a 64-row tile would not fit 128 registers);
//   taller blocks take several row tiles.
// - A ring of kStages tiles in dynamic shared memory, filled by cp.async:
//   the copies of the next two (block, k-chunk) steps are in flight while
//   the tensor cores work on the current one, across stored-block
//   boundaries.  16-byte copies where the row pitch and the pointers
//   allow them, element copies otherwise (n = 37); ragged rows, columns
//   and inner chunks are zero-filled by the copy, and B is not padded.
// - One thread block per (work item, 64-column tile), up to 128 rows
//   tall, so each B panel chunk is loaded once per block row up to
//   bs = 128; taller blocks are split into 128-row tiles.  A work item is
//   a chunk of at most S stored blocks of one block row (the chunk plan,
//   built on the device by formats.bsr_chunk_plan).  A block row of one
//   chunk, empty ones included, writes C with the fused alpha/beta/C0
//   epilogue.  The chunks of a longer row write partial tiles to a
//   workspace, and bsr_reduce_kernel sums them in chunk order and applies
//   the epilogue.  No atomics: results are the same from run to run.
// - A batch of members that share A's pattern (torch.func.vmap over the
//   blocks, jacfwd, a Hessian's batched tangents) is one launch: the
//   member is blockIdx.z of both kernels, the blocks, B, C0 and C each
//   have a member stride (0 for an operand all members share), the chunk
//   plan is shared, and each member has its own workspace slots
//   (work + z * slots * bs * n).  A single product is the instance with
//   BATCH false, whose code has no member offsets.  Where the members
//   share B and real values run on the tensor cores, bsr_spmm_group.cu
//   serves a group of members a block from one staged chunk of B.
#include "bsr_spmm.cuh"

namespace sdt {
namespace {

// items: (n_items, 4) int64 rows of (block row, first stored block, end
// stored block, workspace slot or -1); rows with block row -1 are
// padding.  gridDim.x = n_items * row_tiles, gridDim.y = column tiles.
// At most 128 registers a thread, so two thread blocks share an SM.
// With BATCH, blockIdx.z is the member.
template <typename T, typename I, int BM, bool BATCH>
__global__ void __launch_bounds__(kThreads, 2)
bsr_spmm_tc_kernel(const int64_t* __restrict__ items,
                   const I* __restrict__ indices, const T* __restrict__ data,
                   const T* __restrict__ b, const T* __restrict__ c0,
                   T* __restrict__ c, T* __restrict__ work, int bs,
                   int row_tiles, int64_t n, T alpha, T beta, bool scale,
                   bool a_vec, bool b_vec, Strides st) {
  using L = Tile<T, BM>;
  SDT_K1_TO_MEMBER
  if constexpr (BATCH) {
    data += blockIdx.z * st.data;
    b += blockIdx.z * st.b;
  }
  constexpr int BK = L::BK;
  constexpr int V = L::kVec;
  using Op = Operand<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);  // [kStages][BM][kAPitch]
  T* Bs = As + kStages * L::kAStage;   // [kStages][BK][kBPitch]

  const int64_t item = blockIdx.x / row_tiles;
  const int64_t brow = items[item * 4];
  if (brow < 0) return;
  const int64_t p0 = items[item * 4 + 1];
  const int64_t p1 = items[item * 4 + 2];
  const int64_t slot = items[item * 4 + 3];
  const int r0 = (blockIdx.x % row_tiles) * BM;
  const int64_t col_base = static_cast<int64_t>(blockIdx.y) * kBN;
  const int64_t bs2 = static_cast<int64_t>(bs) * bs;
  const int ksteps = (bs + BK - 1) / BK;
  const int64_t nsteps = (p1 - p0) * ksteps;

  // Issue the copies of step s (stored block p0 + s / ksteps, inner chunk
  // s % ksteps) into ring stage `stage`.
  auto load = [&](int64_t s, int stage) {
    const int64_t p = p0 + s / ksteps;
    const int k0 = static_cast<int>(s % ksteps) * BK;
    const T* blk = data + p * bs2;
    const T* panel =
        b + static_cast<int64_t>(indices[p]) * bs * n + col_base;
    T* as = As + stage * L::kAStage;
    T* bsm = Bs + stage * L::kBStage;
    constexpr int kA = BM * BK / V;  // 16-byte vectors of A's tile
#pragma unroll
    for (int i = 0; i < (kA + kThreads - 1) / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (kA % kThreads != 0 && e >= kA) break;
      const int r = e / (BK / V);
      const int kv = (e % (BK / V)) * V;
      // bs % 8 == 0 and V <= 4: a vector is wholly inside or outside.
      const bool ok = r0 + r < bs && k0 + kv < bs;
      const T* src = blk + static_cast<int64_t>(r0 + r) * bs + k0 + kv;
      T* dst = as + r * L::kAPitch + kv;
      if (a_vec) {
        cp_async16(dst, ok ? src : data, ok);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v)
          cp_async_elem<sizeof(T)>(dst + v, ok ? src + v : data, ok);
      }
    }
    constexpr int kB = BK * kBN / V;  // 16-byte vectors of B's tile
#pragma unroll
    for (int i = 0; i < (kB + kThreads - 1) / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (kB % kThreads != 0 && e >= kB) break;
      const int kr = e / (kBN / V);
      const int cv = (e % (kBN / V)) * V;
      const bool krow = k0 + kr < bs;
      const T* src = panel + static_cast<int64_t>(k0 + kr) * n + cv;
      T* dst = bsm + kr * L::kBPitch + cv;
      if (b_vec) {  // n % V == 0: a vector is wholly inside or outside
        const bool ok = krow && col_base + cv < n;
        cp_async16(dst, ok ? src : b, ok);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const bool ok = krow && col_base + cv + v < n;
          cp_async_elem<sizeof(T)>(dst + v, ok ? src + v : b, ok);
        }
      }
    }
  };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp % L::kWarpsM) * L::WM;
  const int wn = (warp / L::kWarpsM) * L::WN;
  const int g = lane / 4;
  const int t = lane % 4;

  T acc[L::MT][L::NT][4], acc_lo[L::MT][L::NT][4];
#pragma unroll
  for (int i = 0; i < L::MT; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = acc_lo[i][j][q] = T(0);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) load(s, s);
    cp_async_commit();
  }
  for (int64_t s = 0; s < nsteps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step s has landed; step s - 1's stage is free
    if (s + kStages - 1 < nsteps)
      load(s + kStages - 1, static_cast<int>((s + kStages - 1) % kStages));
    cp_async_commit();
    const int stage = static_cast<int>(s % kStages);
    const T* as = As + stage * L::kAStage;
    const T* bsm = Bs + stage * L::kBStage;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      typename Op::type af[L::MT][4], bf[L::NT][2];
#pragma unroll
      for (int i = 0; i < L::MT; ++i) {
        const T* ap = as + (wm + i * 16 + g) * L::kAPitch + kk + t;
        af[i][0] = Op::make(ap[0]);
        af[i][1] = Op::make(ap[8 * L::kAPitch]);
        af[i][2] = Op::make(ap[4]);
        af[i][3] = Op::make(ap[8 * L::kAPitch + 4]);
      }
#pragma unroll
      for (int j = 0; j < L::NT; ++j) {
        const T* bp = bsm + (kk + t) * L::kBPitch + wn + j * 8 + g;
        bf[j][0] = Op::make(bp[0]);
        bf[j][1] = Op::make(bp[4 * L::kBPitch]);
      }
#pragma unroll
      for (int i = 0; i < L::MT; ++i)
#pragma unroll
        for (int j = 0; j < L::NT; ++j)
          mma_k8(acc[i][j], acc_lo[i][j], af[i], bf[j]);
    }
  }

  // Accumulator q of tile (i, j) is row g (+8 for q >= 2), column
  // 2t + (q & 1) of that tile.
  const int64_t tile = static_cast<int64_t>(bs) * n;
#pragma unroll
  for (int i = 0; i < L::MT; ++i) {
#pragma unroll
    for (int q2 = 0; q2 < 2; ++q2) {
      const int r = r0 + wm + i * 16 + g + 8 * q2;
      if (r >= bs) continue;
#pragma unroll
      for (int j = 0; j < L::NT; ++j) {
#pragma unroll
        for (int q1 = 0; q1 < 2; ++q1) {
          const int64_t col = col_base + wn + j * 8 + 2 * t + q1;
          if (col >= n) continue;
          const int q = 2 * q2 + q1;
          T v = acc[i][j][q];
          if constexpr (kSplitSum<T>) v += acc_lo[i][j][q];
          const int64_t off = static_cast<int64_t>(r) * n + col;
          if (slot < 0) {
            const int64_t idx = brow * tile + off;
            c[idx] = epilogue(v, c0, idx, alpha, beta, scale);
          } else {
            work[slot * tile + off] = v;
          }
        }
      }
    }
  }
}

#undef SDT_K1_TO_MEMBER

template <typename T, typename I, int BM, bool BATCH>
cudaError_t launch_tiles(const void* items, int64_t n_items,
                         const void* indices, const void* data,
                         const void* b, const void* c0, void* c, void* work,
                         int bs, int64_t n, T alpha, T beta, bool scale,
                         bool a_vec, bool b_vec, int64_t batch, Strides st,
                         cudaStream_t stream) {
  using L = Tile<T, BM>;
  auto kernel = bsr_spmm_tc_kernel<T, I, BM, BATCH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return err;
  const int row_tiles = (bs + BM - 1) / BM;
  const dim3 grid(static_cast<unsigned>(n_items * row_tiles),
                  static_cast<unsigned>((n + kBN - 1) / kBN),
                  static_cast<unsigned>(batch));
  kernel<<<grid, kThreads, L::kSmem, stream>>>(
      static_cast<const int64_t*>(items), static_cast<const I*>(indices),
      static_cast<const T*>(data), static_cast<const T*>(b),
      static_cast<const T*>(c0), static_cast<T*>(c), static_cast<T*>(work),
      bs, row_tiles, n, alpha, beta, scale, a_vec, b_vec, st);
  return cudaGetLastError();
}

// The tile height that covers bs (128 rows at most, complex 32), for one
// member (BATCH false) or a batch.
template <typename T, typename I, bool BATCH>
cudaError_t launch_height(const void* items, int64_t n_items,
                          const void* indices, const void* data,
                          const void* b, const void* c0, void* c, void* work,
                          int bs, int64_t n, T alpha, T beta, bool scale,
                          bool a_vec, bool b_vec, int64_t batch, Strides st,
                          cudaStream_t stream) {
#define SDT_K1_TILE_ARGS                                                    \
  items, n_items, indices, data, b, c0, c, work, bs, n, alpha, beta, scale, \
      a_vec, b_vec, batch, st, stream
  if (bs <= 16) return launch_tiles<T, I, 16, BATCH>(SDT_K1_TILE_ARGS);
  if constexpr (IsComplex<T>::value) {
    return launch_tiles<T, I, 32, BATCH>(SDT_K1_TILE_ARGS);
  } else {
    if (bs <= 32) return launch_tiles<T, I, 32, BATCH>(SDT_K1_TILE_ARGS);
    if (bs <= 64) return launch_tiles<T, I, 64, BATCH>(SDT_K1_TILE_ARGS);
    return launch_tiles<T, I, 128, BATCH>(SDT_K1_TILE_ARGS);
  }
#undef SDT_K1_TILE_ARGS
}

template <typename T, typename I>
cudaError_t launch(const void* items, int64_t n_items, const void* splits,
                   int64_t n_splits, const void* indices, const void* data,
                   const void* b, const void* c0, void* c, void* work,
                   int64_t slots, int64_t bs, int64_t n, double alpha_re,
                   double alpha_im, double beta_re, double beta_im,
                   int64_t batch, int64_t s_data, int64_t s_b, int64_t s_c0,
                   int64_t s_c, cudaStream_t stream) {
  if (bs < 8 || bs % 8 || bs > (1 << 20) || n_items < 0 || n_splits < 0 ||
      (n_splits > 0 && work == nullptr) || batch < 1 ||
      batch > kMaxMembers || slots < 0 || s_data < 0 || s_b < 0 ||
      s_c0 < 0 || s_c < 0)
    return cudaErrorInvalidValue;
  if (n_items == 0 || n == 0) return cudaSuccess;
  const T alpha = Arith<T>::make(alpha_re, alpha_im);  // real values take
  const T beta = Arith<T>::make(beta_re, beta_im);     // the real parts
  const bool scale = !is_one(alpha_re, alpha_im);
  const int ibs = static_cast<int>(bs);
  // 16-byte copies need every member's blocks (rows of B) on 16 bytes.
  const int64_t size = static_cast<int64_t>(sizeof(T));
  const bool a_vec = aligned16(data) && (s_data * size) % 16 == 0;
  const bool b_vec = aligned16(b) && n % (16 / size) == 0 &&
                     (s_b * size) % 16 == 0;
  const Strides st{s_data, s_b, s_c0, s_c, slots * bs * n};
#define SDT_K1_HEIGHT_ARGS                                                  \
  items, n_items, indices, data, b, c0, c, work, ibs, n, alpha, beta, scale, \
      a_vec, b_vec, batch, st, stream
  cudaError_t err = batch == 1
                        ? launch_height<T, I, false>(SDT_K1_HEIGHT_ARGS)
                        : launch_height<T, I, true>(SDT_K1_HEIGHT_ARGS);
#undef SDT_K1_HEIGHT_ARGS
  if (err != cudaSuccess) return err;
  return launch_reduce<T>(splits, n_splits, work, c0, c, bs, n, alpha, beta,
                          scale, batch, st, stream);
}

}  // namespace
}  // namespace sdt

// batch members (at most kMaxMembers, grid.z's limit), each operand at
// its member stride in elements (0: shared), each with its own `slots`
// workspace slots; batch 1 is one product.
extern "C" int sdt_bsr_spmm_tc(int dtype, int itype, const void* items,
                               int64_t n_items, const void* splits,
                               int64_t n_splits, const void* indices,
                               const void* data, const void* b,
                               const void* c0, void* c, void* work,
                               int64_t slots, int64_t bs, int64_t n,
                               double alpha_re, double alpha_im,
                               double beta_re, double beta_im, int64_t batch,
                               int64_t s_data, int64_t s_b, int64_t s_c0,
                               int64_t s_c, void* stream) {
  SDT_DISPATCH(dtype, itype, sdt::launch, items, n_items, splits, n_splits,
               indices, data, b, c0, c, work, slots, bs, n, alpha_re,
               alpha_im, beta_re, beta_im, batch, s_data, s_b, s_c0, s_c,
               static_cast<cudaStream_t>(stream))
}

extern "C" const char* sdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
