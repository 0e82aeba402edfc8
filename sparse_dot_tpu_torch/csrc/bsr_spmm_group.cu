// K1 on the tensor cores for a batch whose members share B (stride 0) and
// not their blocks, in f32 and f64: one thread block serves M members (2
// or 4) for one (work item, row tile, 64-column tile), blockIdx.z being a
// group of M consecutive members.  The per-member instance
// (bsr_spmm.cu, blockIdx.z a member) has each member's block stage its
// own copy of the same chunk of B's panel by cp.async and load B's
// fragments from shared memory for every MMA, splitting each into TF32
// hi / lo in f32.  Here each ring stage holds one chunk of B and M chunks
// of A; each warp loads (and in f32 splits) its fragments of B once a k8
// step and issues the MMAs of M members into M sets of accumulators.
// A's copies, the MMAs and the accumulators stay one a member, and the
// accumulators cost registers: M = 4 runs one block an SM, M = 2 two.
//
// Tiles are at most 64 rows tall (taller blocks take several row tiles,
// each loading the chunk of B again for its M members): the height that
// covers bs up to 64 (32-row tiles at bs 64, which halve the
// accumulators, were timed slower at config 3).  Each member's
// accumulators take its single launch's MMAs in the same order (the k8 steps in order, whatever the tile's
// height or chunk), the same 3xTF32 split in f32 and the same epilogue,
// and split block rows write each member's partial tiles to its own
// workspace slots for bsr_reduce_kernel to add in chunk order: each
// member has its single launch's bits.  A part-full last group's missing
// members copy and multiply the last member's blocks and store nothing.
// Complex values, other block sizes and batches with B per member run
// the per-member instance (the wrapper, ops/bsr.py, spmm_group, decides).
// A source of its own, so that nvcc builds these instances beside the
// per-member ones.
#include "bsr_spmm.cuh"

namespace sdt {
namespace {

// At most 255 registers a thread for 4 members (one block an SM: the
// ring's M chunks of A take 150 KB at 64 rows), 128 for 2.
template <typename T, typename I, int BM, int M>
__global__ void __launch_bounds__(kThreads, M == 2 ? 2 : 1)
bsr_spmm_group_kernel(const int64_t* __restrict__ items,
                      const I* __restrict__ indices,
                      const T* __restrict__ data, const T* __restrict__ b,
                      const T* __restrict__ c0, T* __restrict__ c,
                      T* __restrict__ work, int bs, int row_tiles, int64_t n,
                      T alpha, T beta, bool scale, bool a_vec, bool b_vec,
                      Strides st, int64_t batch) {
  using L = Tile<T, BM>;
  const int64_t z0 = static_cast<int64_t>(blockIdx.z) * M;
  const int last = static_cast<int>(batch - z0 < M ? batch - z0 - 1 : M - 1);
  data += z0 * st.data;
  if (c0 != nullptr) c0 += z0 * st.c0;
  c += z0 * st.c;
  if (work != nullptr) work += z0 * st.work;
  constexpr int BK = L::BK;
  constexpr int V = L::kVec;
  using Op = Operand<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);     // [kStages][M][BM][kAPitch]
  T* Bs = As + kStages * M * L::kAStage;  // [kStages][BK][kBPitch]

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
  // s % ksteps) into ring stage `stage`: the chunk of each member's block,
  // then the chunk of B's panel.
  auto load = [&](int64_t s, int stage) {
    const int64_t p = p0 + s / ksteps;
    const int k0 = static_cast<int>(s % ksteps) * BK;
    const T* panel =
        b + static_cast<int64_t>(indices[p]) * bs * n + col_base;
    constexpr int kA = BM * BK / V;  // 16-byte vectors of A's tile
#pragma unroll
    for (int mm = 0; mm < M; ++mm) {
      const T* blk = data + (mm < last ? mm : last) * st.data + p * bs2;
      T* as = As + (stage * M + mm) * L::kAStage;
#pragma unroll
      for (int i = 0; i < (kA + kThreads - 1) / kThreads; ++i) {
        const int e = threadIdx.x + i * kThreads;
        if (kA % kThreads != 0 && e >= kA) break;
        const int r = e / (BK / V);
        const int kv = (e % (BK / V)) * V;
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
    }
    T* bsm = Bs + stage * L::kBStage;
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
      if (b_vec) {
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

  T acc[M][L::MT][L::NT][4], acc_lo[M][L::MT][L::NT][4];
#pragma unroll
  for (int mm = 0; mm < M; ++mm)
#pragma unroll
    for (int i = 0; i < L::MT; ++i)
#pragma unroll
      for (int j = 0; j < L::NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mm][i][j][q] = acc_lo[mm][i][j][q] = T(0);

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
    const T* bsm = Bs + stage * L::kBStage;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      // B's fragments once for the group.
      typename Op::type bf[L::NT][2];
#pragma unroll
      for (int j = 0; j < L::NT; ++j) {
        const T* bp = bsm + (kk + t) * L::kBPitch + wn + j * 8 + g;
        bf[j][0] = Op::make(bp[0]);
        bf[j][1] = Op::make(bp[4 * L::kBPitch]);
      }
#pragma unroll
      for (int mm = 0; mm < M; ++mm) {
        const T* as = As + (stage * M + mm) * L::kAStage;
        typename Op::type af[L::MT][4];
#pragma unroll
        for (int i = 0; i < L::MT; ++i) {
          const T* ap = as + (wm + i * 16 + g) * L::kAPitch + kk + t;
          af[i][0] = Op::make(ap[0]);
          af[i][1] = Op::make(ap[8 * L::kAPitch]);
          af[i][2] = Op::make(ap[4]);
          af[i][3] = Op::make(ap[8 * L::kAPitch + 4]);
        }
#pragma unroll
        for (int i = 0; i < L::MT; ++i)
#pragma unroll
          for (int j = 0; j < L::NT; ++j)
            mma_k8(acc[mm][i][j], acc_lo[mm][i][j], af[i], bf[j]);
      }
    }
  }

  // Accumulator q of tile (i, j) is row g (+8 for q >= 2), column
  // 2t + (q & 1) of that tile; each live member's own C or workspace.
  const int64_t tile = static_cast<int64_t>(bs) * n;
#pragma unroll
  for (int mm = 0; mm < M; ++mm) {
    if (mm > last) break;
    T* const cm = c + mm * st.c;
    const T* const c0m = c0 == nullptr ? nullptr : c0 + mm * st.c0;
    T* const wk = work == nullptr ? nullptr : work + mm * st.work;
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
            T v = acc[mm][i][j][q];
            if constexpr (kSplitSum<T>) v += acc_lo[mm][i][j][q];
            const int64_t off = static_cast<int64_t>(r) * n + col;
            if (slot < 0) {
              const int64_t idx = brow * tile + off;
              cm[idx] = epilogue(v, c0m, idx, alpha, beta, scale);
            } else {
              wk[slot * tile + off] = v;
            }
          }
        }
      }
    }
  }
}

template <typename T, typename I, int BM, int M>
cudaError_t launch_group_tiles(const void* items, int64_t n_items,
                               const void* indices, const void* data,
                               const void* b, const void* c0, void* c,
                               void* work, int bs, int64_t n, T alpha,
                               T beta, bool scale, bool a_vec, bool b_vec,
                               int64_t batch, const Strides& st,
                               cudaStream_t stream) {
  using L = Tile<T, BM>;
  constexpr size_t kSmem = sizeof(T) * kStages * (M * L::kAStage + L::kBStage);
  auto kernel = bsr_spmm_group_kernel<T, I, BM, M>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  const int row_tiles = (bs + BM - 1) / BM;
  const dim3 grid(static_cast<unsigned>(n_items * row_tiles),
                  static_cast<unsigned>((n + kBN - 1) / kBN),
                  static_cast<unsigned>((batch + M - 1) / M));
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const int64_t*>(items), static_cast<const I*>(indices),
      static_cast<const T*>(data), static_cast<const T*>(b),
      static_cast<const T*>(c0), static_cast<T*>(c), static_cast<T*>(work),
      bs, row_tiles, n, alpha, beta, scale, a_vec, b_vec, st, batch);
  return cudaGetLastError();
}

template <typename T, typename I, int M>
cudaError_t launch_group_height(const void* items, int64_t n_items,
                                const void* indices, const void* data,
                                const void* b, const void* c0, void* c,
                                void* work, int bs, int64_t n, T alpha,
                                T beta, bool scale, bool a_vec, bool b_vec,
                                int64_t batch, const Strides& st,
                                cudaStream_t stream) {
#define SDT_K1_GROUP_ARGS                                                   \
  items, n_items, indices, data, b, c0, c, work, bs, n, alpha, beta, scale, \
      a_vec, b_vec, batch, st, stream
  if (bs <= 16) return launch_group_tiles<T, I, 16, M>(SDT_K1_GROUP_ARGS);
  if (bs <= 32) return launch_group_tiles<T, I, 32, M>(SDT_K1_GROUP_ARGS);
  return launch_group_tiles<T, I, 64, M>(SDT_K1_GROUP_ARGS);
#undef SDT_K1_GROUP_ARGS
}

template <typename T, typename I>
cudaError_t launch_group(const void* items, int64_t n_items,
                         const void* splits, int64_t n_splits,
                         const void* indices, const void* data,
                         const void* b, const void* c0, void* c, void* work,
                         int64_t slots, int64_t bs, int64_t n,
                         double alpha_re, double alpha_im, double beta_re,
                         double beta_im, int64_t batch, int64_t s_data,
                         int64_t s_c0, int64_t s_c, int group,
                         cudaStream_t stream) {
  if constexpr (IsComplex<T>::value) {
    return cudaErrorInvalidValue;  // complex batches: the per-member one
  } else {
    if (bs < 8 || bs % 8 || bs > (1 << 20) || n_items < 0 || n_splits < 0 ||
        (n_splits > 0 && work == nullptr) || batch < 1 ||
        batch > kMaxMembers || slots < 0 || s_data < 0 || s_c0 < 0 ||
        s_c < 0 || (group != 2 && group != 4))
      return cudaErrorInvalidValue;
    if (n_items == 0 || n == 0) return cudaSuccess;
    const T alpha = Arith<T>::make(alpha_re, alpha_im);
    const T beta = Arith<T>::make(beta_re, beta_im);
    const bool scale = !is_one(alpha_re, alpha_im);
    const int ibs = static_cast<int>(bs);
    const int64_t size = static_cast<int64_t>(sizeof(T));
    const bool a_vec = aligned16(data) && (s_data * size) % 16 == 0;
    const bool b_vec = aligned16(b) && n % (16 / size) == 0;
    const Strides st{s_data, 0, s_c0, s_c, slots * bs * n};
#define SDT_K1_GROUP_ARGS                                                     \
  items, n_items, indices, data, b, c0, c, work, ibs, n, alpha, beta, scale, \
      a_vec, b_vec, batch, st, stream
    const cudaError_t err =
        group == 2 ? launch_group_height<T, I, 2>(SDT_K1_GROUP_ARGS)
                   : launch_group_height<T, I, 4>(SDT_K1_GROUP_ARGS);
#undef SDT_K1_GROUP_ARGS
    if (err != cudaSuccess) return err;
    return launch_reduce<T>(splits, n_splits, work, c0, c, bs, n, alpha,
                            beta, scale, batch, st, stream);
  }
}

}  // namespace
}  // namespace sdt

// batch members (at most kMaxMembers) sharing b, `group` (2 or 4) of
// them a block on tiles of the height that covers bs (at most 64), the
// blocks, c0 and c at their member strides in elements
// (c0's 0: shared), each member with its own `slots` workspace slots.
// f32 and f64 only.
extern "C" int sdt_bsr_spmm_tc_group(
    int dtype, int itype, const void* items, int64_t n_items,
    const void* splits, int64_t n_splits, const void* indices,
    const void* data, const void* b, const void* c0, void* c, void* work,
    int64_t slots, int64_t bs, int64_t n, double alpha_re, double alpha_im,
    double beta_re, double beta_im, int64_t batch, int64_t s_data,
    int64_t s_c0, int64_t s_c, int group, void* stream) {
  SDT_DISPATCH(dtype, itype, sdt::launch_group, items, n_items, splits,
               n_splits, indices, data, b, c0, c, work, slots, bs, n,
               alpha_re, alpha_im, beta_re, beta_im, batch, s_data, s_c0,
               s_c, group, static_cast<cudaStream_t>(stream))
}
