// K1, tensor-core variant: BSR SpMM, C = alpha * A @ B + beta * C0, for
// BSR A with square bs x bs blocks, bs % 8 == 0, real values (f32, f64),
// and row-major B.  Complex values and other block sizes go to the
// CUDA-core variant in bsr_spmm_simt.cu (the choice is made in ops/bsr.py).
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
#include <type_traits>

#include "common.cuh"

namespace sdt {
namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBN = 64;        // columns of B per thread block
constexpr int kStages = 3;     // depth of the cp.async ring

// Tile shape for element type T and thread-block height BM (16, 32, 64 or
// 128 rows).  The inner chunk is 128 bytes of a row of A (BK elements);
// the shared-memory pitches are padded so that the fragment loads below
// hit 32 distinct banks.
template <typename T, int BM>
struct Tile {
  static constexpr int kBK0 = 128 / static_cast<int>(sizeof(T));
  static constexpr int BK = kBK0 < BM ? kBK0 : BM;
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // per 16 B
  static constexpr int kWarpsM = BM >= 64 ? 4 : BM / 16;
  static constexpr int kWarpsN = 8 / kWarpsM;
  static constexpr int WM = BM / kWarpsM;  // rows per warp
  static constexpr int WN = kBN / kWarpsN;  // columns per warp
  static constexpr int MT = WM / 16;        // m16 tiles per warp
  static constexpr int NT = WN / 8;         // n8 tiles per warp
  static constexpr int kAPitch = BK + 4;
  static constexpr int kBPitch = kBN + (sizeof(T) == 4 ? 8 : 4);
  static constexpr int kAStage = BM * kAPitch;
  static constexpr int kBStage = BK * kBPitch;
  static constexpr size_t kSmem = sizeof(T) * kStages * (kAStage + kBStage);
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; ok == false zero-fills dst and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// One element (4 or 8 bytes), for rows that are not 16-byte aligned.
template <int N>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src,
                                              bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(N), "r"(ok ? N : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 3xTF32 operand: hi for the hi*hi product, hic and lo for the two cross
// products (both 0 where hi is not finite).  hi is x rounded to TF32's 10
// mantissa bits (half away from zero, by an integer add and a mask);
// lo = x - hi is exact in f32 and goes to the tensor cores as it is,
// which read its top 10 mantissa bits.  Integer and f32 arithmetic only:
// cvt.rna.tf32.f32 runs at a fraction of their rate.
struct Tf32x3 {
  unsigned hi, hic, lo;
};

__device__ __forceinline__ Tf32x3 split_tf32(float x) {
  const unsigned hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  const bool finite = (hi & 0x7f800000u) != 0x7f800000u;
  return {hi, finite ? hi : 0u,
          finite ? __float_as_uint(x - __uint_as_float(hi)) : 0u};
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], unsigned a0,
                                         unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_f64(double (&d)[4], double a0,
                                        double a1, double b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b0));
}

// One k8 step of one (m16, n8) tile.  a holds A[g][t], A[g+8][t],
// A[g][t+4], A[g+8][t+4] and b holds B[t][g], B[t+4][g] for the lane's
// group g = lane / 4 and t = lane % 4, the m16n8k8 fragment layout.
// The tensor cores round their f32 sums toward zero, a bias that grows
// with every product accumulated into the same registers.  So the step's
// hi*hi products go to fresh registers and are added to d in IEEE f32,
// and the cross products, 2^-11 as large, accumulate apart in lo.
__device__ __forceinline__ void mma_k8(float (&d)[4], float (&lo)[4],
                                       const Tf32x3 (&a)[4],
                                       const Tf32x3 (&b)[2]) {
  float hh[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(hh, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
  mma_tf32(lo, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hic, b[1].hic);
  mma_tf32(lo, a[0].hic, a[1].hic, a[2].hic, a[3].hic, b[0].lo, b[1].lo);
#pragma unroll
  for (int q = 0; q < 4; ++q) d[q] += hh[q];
}

// f64: the same k8 step as two m16n8k4 products (k = t, then k = t + 4),
// accumulated in IEEE f64 by the tensor cores; lo is not used.
__device__ __forceinline__ void mma_k8(double (&d)[4], double (&)[4],
                                       const double (&a)[4],
                                       const double (&b)[2]) {
  mma_f64(d, a[0], a[1], b[0]);
  mma_f64(d, a[2], a[3], b[1]);
}

template <typename T>
struct Operand {
  using type = T;
  __device__ static T make(T x) { return x; }
};
template <>
struct Operand<float> {
  using type = Tf32x3;
  __device__ static Tf32x3 make(float x) { return split_tf32(x); }
};

// items: (n_items, 4) int64 rows of (block row, first stored block, end
// stored block, workspace slot or -1); rows with block row -1 are
// padding.  gridDim.x = n_items * row_tiles, gridDim.y = column tiles.
// At most 128 registers a thread, so two thread blocks share an SM.
template <typename T, typename I, int BM>
__global__ void __launch_bounds__(kThreads, 2)
bsr_spmm_tc_kernel(const int64_t* __restrict__ items,
                   const I* __restrict__ indices, const T* __restrict__ data,
                   const T* __restrict__ b, const T* __restrict__ c0,
                   T* __restrict__ c, T* __restrict__ work, int bs,
                   int row_tiles, int64_t n, T alpha, T beta, bool scale,
                   bool a_vec, bool b_vec) {
  using L = Tile<T, BM>;
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
          if constexpr (std::is_same<T, float>::value) v += acc_lo[i][j][q];
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

// splits: (n_splits, 3) int64 rows of (block row, first workspace slot,
// number of chunks); rows with block row -1 are padding.  Sums the
// partial tiles of each split block row in chunk order and writes C.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bsr_reduce_kernel(const int64_t* __restrict__ splits,
                  const T* __restrict__ work, const T* __restrict__ c0,
                  T* __restrict__ c, int64_t tile, T alpha, T beta,
                  bool scale) {
  const int64_t brow = splits[blockIdx.x * 3];
  if (brow < 0) return;
  const T* part = work + splits[blockIdx.x * 3 + 1] * tile;
  const int64_t nch = splits[blockIdx.x * 3 + 2];
  for (int64_t e = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
       e < tile; e += static_cast<int64_t>(gridDim.y) * kThreads) {
    T acc = part[e];
    for (int64_t j = 1; j < nch; ++j) acc += part[j * tile + e];
    const int64_t idx = brow * tile + e;
    c[idx] = epilogue(acc, c0, idx, alpha, beta, scale);
  }
}

template <typename T, typename I, int BM>
cudaError_t launch_tiles(const void* items, int64_t n_items,
                         const void* indices, const void* data,
                         const void* b, const void* c0, void* c, void* work,
                         int bs, int64_t n, T alpha, T beta, bool scale,
                         bool a_vec, bool b_vec, cudaStream_t stream) {
  using L = Tile<T, BM>;
  auto kernel = bsr_spmm_tc_kernel<T, I, BM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return err;
  const int row_tiles = (bs + BM - 1) / BM;
  const dim3 grid(static_cast<unsigned>(n_items * row_tiles),
                  static_cast<unsigned>((n + kBN - 1) / kBN));
  kernel<<<grid, kThreads, L::kSmem, stream>>>(
      static_cast<const int64_t*>(items), static_cast<const I*>(indices),
      static_cast<const T*>(data), static_cast<const T*>(b),
      static_cast<const T*>(c0), static_cast<T*>(c), static_cast<T*>(work),
      bs, row_tiles, n, alpha, beta, scale, a_vec, b_vec);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, typename I>
cudaError_t launch(const void* items, int64_t n_items, const void* splits,
                   int64_t n_splits, const void* indices, const void* data,
                   const void* b, const void* c0, void* c, void* work,
                   int64_t bs, int64_t n, double alpha_re, double alpha_im,
                   double beta_re, double beta_im, cudaStream_t stream) {
  if constexpr (!std::is_floating_point<T>::value) {
    return cudaErrorInvalidValue;  // complex values take the SIMT variant
  } else {
    if (bs < 8 || bs % 8 || bs > (1 << 20) || n_items < 0 || n_splits < 0 ||
        (n_splits > 0 && work == nullptr))
      return cudaErrorInvalidValue;
    if (n_items == 0 || n == 0) return cudaSuccess;
    const T alpha = static_cast<T>(alpha_re);  // real values: no imaginary
    const T beta = static_cast<T>(beta_re);    // parts to take
    const bool scale = !is_one(alpha_re, alpha_im);
    const int ibs = static_cast<int>(bs);
    const bool a_vec = aligned16(data);
    const bool b_vec = aligned16(b) && n % (16 / sizeof(T)) == 0;
    cudaError_t err;
    if (ibs <= 16) {
      err = launch_tiles<T, I, 16>(items, n_items, indices, data, b, c0, c, work, ibs, n, alpha, beta, scale, a_vec, b_vec, stream);
    } else if (ibs <= 32) {
      err = launch_tiles<T, I, 32>(items, n_items, indices, data, b, c0, c, work, ibs, n, alpha, beta, scale, a_vec, b_vec, stream);
    } else if (ibs <= 64) {
      err = launch_tiles<T, I, 64>(items, n_items, indices, data, b, c0, c, work, ibs, n, alpha, beta, scale, a_vec, b_vec, stream);
    } else {
      err = launch_tiles<T, I, 128>(items, n_items, indices, data, b, c0, c, work, ibs, n, alpha, beta, scale, a_vec, b_vec, stream);
    }
    if (err != cudaSuccess || n_splits == 0) return err;
    const int64_t tile = bs * n;
    const int64_t per_split = (tile + kThreads - 1) / kThreads;
    const dim3 grid(static_cast<unsigned>(n_splits),
                    static_cast<unsigned>(per_split < 1024 ? per_split : 1024));
    bsr_reduce_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const int64_t*>(splits), static_cast<const T*>(work),
        static_cast<const T*>(c0), static_cast<T*>(c), tile, alpha, beta,
        scale);
    return cudaGetLastError();
  }
}

}  // namespace
}  // namespace sdt

extern "C" int sdt_bsr_spmm_tc(int dtype, int itype, const void* items,
                               int64_t n_items, const void* splits,
                               int64_t n_splits, const void* indices,
                               const void* data, const void* b,
                               const void* c0, void* c, void* work,
                               int64_t bs, int64_t n, double alpha_re,
                               double alpha_im, double beta_re,
                               double beta_im, void* stream) {
  SDT_DISPATCH(dtype, itype, sdt::launch, items, n_items, splits, n_splits,
               indices, data, b, c0, c, work, bs, n, alpha_re, alpha_im,
               beta_re, beta_im, static_cast<cudaStream_t>(stream))
}

extern "C" const char* sdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
