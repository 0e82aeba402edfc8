// K13: masked compaction, the CSR of a dense C (r x n, row-major) at the
// positions where a structural count P (r x n, bf16, row-major) is > 0, and
// with `triangular` only at columns j >= row0 + i.  Each row's columns come
// in ascending order and every position of the mask is stored, exact zeros
// of C included (an entry whose products cancel), as K5 writes a
// sparse-output product.
//
// Replaces sparse_dot_tpu/ops/_xla.py extract_structure (:1301) and
// extract_sparse_masked (:1460), the last step of spgemm_structural_extract
// (:1495): there a prefix sum over the flattened mask gives each stored
// position its slot, and scatters place the columns and values.  Here one
// launch counts, sums and fills, and no (r * n)-long prefix or scatter
// index is ever written.
//
// Bound: bytes.  P is read once (its triangle with `triangular`), C at the
// mask, and the CSR written once; the work per byte is a few integer
// operations.  At the demo's 500 x 500 the bytes take ~2 us, so there the
// time is the launch and the host's read of the total: one launch, one
// read.  The design:
//
// - Tiles of up to 32 rows (ops/compact.py, compact_plan: enough tiles
//   for the card's 132 SMs where the rows allow), each row cut into work
//   items of 256-column steps that the block's 8 warps share.  A block
//   takes its tile's number from an atomic ticket in launch order, not
//   from blockIdx, so every tile it waits on below belongs to a block
//   that has started and will finish; the block that draws the last
//   ticket puts the ticket back to 0 for the next call (every block has
//   drawn by then).
// - Count: each lane reads kGroup = 8 consecutive bf16 of P (one 16-byte
//   load where the rows allow, else eight scalar ones) and makes an 8-bit
//   mask of the positives at columns >= row0 + i (`triangular`); a warp
//   covers 256 columns a step from the step that holds column row0 + i.
//   The masks go to shared memory (a bit a column: n / 8 bytes a row, 1/16
//   of P's bytes), so P is read once.  Rows too wide for the tile's
//   shared memory (compact_plan: more than kStageBytes of masks) keep no
//   masks, and the fill reads P a second time, through L2, in the same
//   launch.
// - Running sum: a single pass across blocks with decoupled look-back.
//   Each tile publishes its count as soon as it has it, in a 64-bit status
//   word tagged with the call's number (no zeroing launch: a word of an
//   earlier call carries another tag and reads as not yet written; a
//   launch captured in a CUDA graph gets a workspace of its own that the
//   graph zeroes before each replay, ops/compact.py); a
//   tile's first warp reads the 32 tiles before it at once, adds their
//   counts up to the nearest one that has published its inclusive prefix
//   (walking further back while none has), and publishes its own.
// - Fill: a warp a row again, 32 consecutive columns at a time, lane l on
//   column j0 + l, so that the loads of C and the stores of the entries
//   are coalesced: the 32 columns' mask is a word of the staged masks (or
//   a __ballot_sync of P > 0 on wide rows), each lane's slot is the row's
//   start plus the popcount of the mask's lower lanes, and a step of 256
//   columns issues its 8 loads of C before any store.  The row's start
//   goes to indptr, and the tile that holds the last row writes indptr[r]
//   and the int64 total.  The wrapper sizes indices and data for every
//   position of the (triangle of the) r x n area, since the total is read
//   on the host only after the launch (with the route's finite flags, in
//   one copy).
//
// Every position is written by one lane, with no atomics on the output: a
// run gives the same bits twice.
#include "common.cuh"

namespace sdt {
namespace {

// A block: 8 warps, which share its tile's work items.
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// Rows of a tile and work items of a tile, at most.
constexpr int kMaxRows = 32;
constexpr int kMaxItems = 4 * kThreads;
// Columns of P a lane reads at once (16 bytes of bf16) and a warp a step;
// a step is 8 words of the mask.
constexpr int kGroup = 8;
constexpr int64_t kStep = 32 * kGroup;
constexpr int kWords = kStep / 32;
// Shared memory for a tile's masks, at most (ops/compact.py, STAGE_BYTES):
// with the items' 8 KB, within the 48 KB a block has without opting in.
constexpr int64_t kStageBytes = 32 * 1024;

// A tile's status word: its count in the low 40 bits (below 2^40: P's r *
// n bf16 fit the card), bit 40 set once the count is the inclusive prefix
// of tiles 0..t, the call's tag above (23 bits, never 0).
constexpr int kValueBits = 40;
constexpr uint64_t kValueMask = (uint64_t(1) << kValueBits) - 1;
constexpr uint64_t kInclusive = uint64_t(1) << kValueBits;
constexpr int kTagShift = kValueBits + 1;
constexpr int64_t kMaxTag = int64_t(1) << (64 - kTagShift);

// A bf16 is > 0 where its sign bit is clear and its other bits are not all
// zero: as a signed 16-bit integer, > 0.
__device__ __forceinline__ unsigned positive(uint32_t half_bits) {
  return static_cast<int16_t>(half_bits & 0xffffu) > 0 ? 1u : 0u;
}

// Bit b set where P[row][j + b] > 0 and j + b lies in [lo, n).  With kVec
// the group is one aligned 16-byte load (n % kGroup == 0, so a group that
// starts inside the row ends inside it).  A group wholly below lo reads
// nothing.
template <bool kVec>
__device__ __forceinline__ unsigned group_mask(const uint16_t* __restrict__ row,
                                               int64_t j, int64_t n,
                                               int64_t lo) {
  unsigned m = 0;
  if (j >= n || j + kGroup <= lo) return 0;
  if (kVec) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + j));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      m |= positive(w[q]) << (2 * q);
      m |= positive(w[q] >> 16) << (2 * q + 1);
    }
  } else {
#pragma unroll
    for (int b = 0; b < kGroup; ++b) {
      if (j + b < n) m |= positive(__ldg(row + j + b)) << b;
    }
  }
  if (lo > j) m &= ~((1u << (lo - j)) - 1u);
  return m;
}

__device__ __forceinline__ void publish(unsigned long long* word,
                                        uint64_t value) {
  __threadfence();
  *reinterpret_cast<volatile unsigned long long*>(word) = value;
}

__device__ __forceinline__ uint64_t peek(const unsigned long long* word) {
  return *reinterpret_cast<const volatile unsigned long long*>(word);
}

// The count of tiles 0..tile-1, by warp 0 of the tile (every lane gets
// it), after publishing `own` (this tile's count) for the tiles after it.
__device__ __forceinline__ long long look_back(unsigned long long* status,
                                               int64_t tile, uint64_t tag,
                                               long long own, int lane) {
  const uint64_t tagged = tag << kTagShift;
  if (tile == 0) {
    if (lane == 0) publish(status, tagged | kInclusive | own);
    return 0;
  }
  if (lane == 0) publish(status + tile, tagged | own);
  long long before = 0;
  for (int64_t end = tile;; end -= 32) {
    const int64_t t = end - 1 - lane;
    uint64_t w = tagged | kInclusive;  // before tile 0: an inclusive 0
    if (t >= 0) {
      do {
        w = peek(status + t);
      } while ((w >> kTagShift) != tag);
    }
    const unsigned inclusive =
        __ballot_sync(kFullMask, (w & kInclusive) != 0);
    // The nearest tile with its inclusive prefix: lanes past it add nothing.
    const int stop = inclusive ? __ffs(inclusive) - 1 : 32;
    long long v = lane <= stop ? static_cast<long long>(w & kValueMask) : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_xor_sync(kFullMask, v, off);
    }
    before += v;
    if (inclusive) break;
  }
  if (lane == 0) publish(status + tile, tagged | kInclusive | (before + own));
  return before;
}

// The rows of a tile, cut into work items of `q` steps of 256 columns
// from the step that holds column row0 + i (every row at least one item,
// so that it gets its start), listed row by row: row k's items are
// starts[k] .. starts[k + 1] - 1 and its first step first[k].
struct Items {
  int starts[kMaxRows + 1];
  int64_t first[kMaxRows];
};

template <typename T, typename I, bool kVec, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    compact_kernel(const T* __restrict__ c, const uint16_t* __restrict__ p,
                   int64_t r, int64_t n, int triangular, int64_t row0,
                   int rows_per_tile, int q, int64_t tiles,
                   unsigned long long* __restrict__ status,
                   unsigned long long* __restrict__ ticket, uint64_t tag,
                   I* __restrict__ indptr, I* __restrict__ indices,
                   T* __restrict__ data, int64_t* __restrict__ total) {
  extern __shared__ uint32_t masks[];  // rows_per_tile x steps x 8 words
  __shared__ Items items;
  __shared__ long long counts[kMaxItems];  // per item, then its start
  __shared__ long long warp_sums[kWarps];
  __shared__ long long tile_count, tile_start;
  __shared__ int64_t drawn;
  const int warp = static_cast<int>(threadIdx.x / 32);
  const int lane = static_cast<int>(threadIdx.x & 31);
  const int64_t steps = (n + kStep - 1) / kStep;
  if (threadIdx.x == 0) {
    const unsigned long long t = atomicAdd(ticket, 1ull);
    if (static_cast<int64_t>(t) == tiles - 1) *ticket = 0;
    drawn = static_cast<int64_t>(t);
  }
  __syncthreads();
  const int64_t tile = drawn;
  const int64_t row_base = tile * rows_per_tile;
  if (warp == 0) {  // the tile's items, lane k for row k
    const int64_t i = row_base + lane;
    int own = 0;
    int64_t first = 0;
    if (lane < rows_per_tile && i < r) {
      const int64_t lo = triangular ? row0 + i : 0;
      first = (lo < n ? lo : n) / kStep;
      const int64_t left = (steps - first + q - 1) / q;
      own = left > 1 ? static_cast<int>(left) : 1;
    }
    int before = own;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFullMask, before, off);
      if (lane >= off) before += v;
    }
    if (lane < kMaxRows) {
      items.first[lane] = first;
      items.starts[lane + 1] = before;
    }
    if (lane == 0) items.starts[0] = 0;
  }
  __syncthreads();
  const int n_items = items.starts[rows_per_tile];

  // The item's row (k, of the tile) and steps [s0, s1).
  auto locate = [&](int it, int* k, int64_t* s0, int64_t* s1) {
    const unsigned at_or_below = __ballot_sync(
        kFullMask, lane < rows_per_tile && items.starts[lane] <= it);
    *k = __popc(at_or_below) - 1;
    *s0 = items.first[*k] + static_cast<int64_t>(it - items.starts[*k]) * q;
    *s1 = *s0 + q < steps ? *s0 + q : steps;
  };

  // Count, the masks kept.
  for (int it = warp; it < n_items; it += kWarps) {
    int k;
    int64_t s0, s1;
    locate(it, &k, &s0, &s1);
    const int64_t i = row_base + k;
    const int64_t lo = triangular ? row0 + i : 0;
    const uint16_t* row = p + i * n;
    uint8_t* staged = reinterpret_cast<uint8_t*>(masks) + k * steps * kStep / 8;
    long long count = 0;
    for (int64_t s = s0; s < s1; ++s) {
      const unsigned m =
          group_mask<kVec>(row, s * kStep + lane * kGroup, n, lo);
      if (kStaged) staged[s * (kStep / 8) + lane] = static_cast<uint8_t>(m);
      count += __popc(m);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      count += __shfl_xor_sync(kFullMask, count, off);
    }
    if (lane == 0) counts[it] = count;
  }
  __syncthreads();

  // Each item's start in the tile: thread t scans items [4t, 4t + 4).
  constexpr int kPerThread = kMaxItems / kThreads;
  long long mine[kPerThread];
  long long sum = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int it = static_cast<int>(threadIdx.x) * kPerThread + j;
    mine[j] = it < n_items ? counts[it] : 0;
    sum += mine[j];
  }
  long long inclusive = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long v = __shfl_up_sync(kFullMask, inclusive, off);
    if (lane >= off) inclusive += v;
  }
  if (lane == 31) warp_sums[warp] = inclusive;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const long long v = __shfl_up_sync(kFullMask, w, off);
      if (lane >= off) w += v;
    }
    if (lane < kWarps) warp_sums[lane] = w;  // inclusive, by warp
    const long long own = __shfl_sync(kFullMask, w, kWarps - 1);
    const long long before = look_back(status, tile, tag, own, lane);
    if (lane == 0) {
      tile_start = before;
      tile_count = own;
    }
  }
  __syncthreads();
  long long start = tile_start + inclusive - sum +
                    (warp > 0 ? warp_sums[warp - 1] : 0);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int it = static_cast<int>(threadIdx.x) * kPerThread + j;
    if (it < n_items) counts[it] = start;
    start += mine[j];
  }
  if (tile == tiles - 1 && threadIdx.x == 0) {
    indptr[r] = static_cast<I>(tile_start + tile_count);
    *total = tile_start + tile_count;
  }
  __syncthreads();

  // Fill, from the masks (or P again).
  const unsigned lower = (1u << lane) - 1u;
  for (int it = warp; it < n_items; it += kWarps) {
    int k;
    int64_t s0, s1;
    locate(it, &k, &s0, &s1);
    const int64_t i = row_base + k;
    long long base = counts[it];
    if (lane == 0 && it == items.starts[k]) indptr[i] = static_cast<I>(base);
    const int64_t lo = triangular ? row0 + i : 0;
    const uint16_t* row = p + i * n;
    const T* c_row = c + i * n;
    const uint32_t* words_of_row = masks + k * steps * kWords;
    for (int64_t s = s0; s < s1; ++s) {
      const int64_t j0 = s * kStep;
      uint32_t mask[kWords];
      if (kStaged) {
#pragma unroll
        for (int b = 0; b < kWords; ++b) mask[b] = words_of_row[s * kWords + b];
      } else {
        uint16_t v[kWords];
#pragma unroll
        for (int b = 0; b < kWords; ++b) {
          const int64_t j = j0 + 32 * b + lane;
          v[b] = j < n ? __ldg(row + j) : uint16_t(0);
        }
#pragma unroll
        for (int b = 0; b < kWords; ++b) {
          const int64_t j = j0 + 32 * b + lane;
          mask[b] = __ballot_sync(kFullMask, positive(v[b]) && j >= lo);
        }
      }
      T value[kWords];
#pragma unroll
      for (int b = 0; b < kWords; ++b) {
        if ((mask[b] >> lane) & 1u) value[b] = c_row[j0 + 32 * b + lane];
      }
#pragma unroll
      for (int b = 0; b < kWords; ++b) {
        if ((mask[b] >> lane) & 1u) {
          const int64_t pos = base + __popc(mask[b] & lower);
          indices[pos] = static_cast<I>(j0 + 32 * b + lane);
          data[pos] = value[b];
        }
        base += __popc(mask[b]);
      }
    }
  }
}

// Whether P's rows take 16-byte loads: every row starts on 16 bytes.
bool vector_rows(const void* p, int64_t n) {
  return n % kGroup == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, typename I, bool kVec, bool kStaged>
cudaError_t launch_tiles(const void* c, const void* p, int64_t r, int64_t n,
                         int triangular, int64_t row0, int rows_per_tile,
                         int q, int64_t tiles, size_t smem, void* status,
                         void* ticket, int64_t tag, void* indptr,
                         void* indices, void* data, void* total,
                         cudaStream_t stream) {
  compact_kernel<T, I, kVec, kStaged>
      <<<static_cast<unsigned>(tiles), kThreads, smem, stream>>>(
          static_cast<const T*>(c), static_cast<const uint16_t*>(p), r, n,
          triangular, row0, rows_per_tile, q, tiles,
          static_cast<unsigned long long*>(status),
          static_cast<unsigned long long*>(ticket),
          static_cast<uint64_t>(tag), static_cast<I*>(indptr),
          static_cast<I*>(indices), static_cast<T*>(data),
          static_cast<int64_t*>(total));
  return cudaGetLastError();
}

template <typename T, typename I>
cudaError_t launch(const void* c, const void* p, int64_t r, int64_t n,
                   int triangular, int64_t row0, int rows_per_tile, int q,
                   int staged, void* status, void* ticket, int64_t tag,
                   void* indptr, void* indices, void* data, void* total,
                   cudaStream_t stream) {
  if (r < 1 || n < 1 || row0 < 0 || tag < 1 || tag >= kMaxTag || q < 1 ||
      rows_per_tile < 1 || rows_per_tile > kMaxRows) {
    return cudaErrorInvalidValue;
  }
  const int64_t tiles = (r + rows_per_tile - 1) / rows_per_tile;
  const int64_t steps = (n + kStep - 1) / kStep;
  const size_t smem =
      staged ? static_cast<size_t>(rows_per_tile * steps * kStep / 8) : 0;
  // Every row has at least one item, and no more than ceil(steps / q).
  if (tiles > 0x7fffffff || smem > static_cast<size_t>(kStageBytes) ||
      rows_per_tile * ((steps + q - 1) / q) > kMaxItems) {
    return cudaErrorInvalidValue;
  }
#define SDT_K13_ARGS                                                        \
  c, p, r, n, triangular, row0, rows_per_tile, q, tiles, smem, status,      \
      ticket, tag, indptr, indices, data, total, stream
  const bool vec = vector_rows(p, n);
  if (staged) {
    return vec ? launch_tiles<T, I, true, true>(SDT_K13_ARGS)
               : launch_tiles<T, I, false, true>(SDT_K13_ARGS);
  }
  return vec ? launch_tiles<T, I, true, false>(SDT_K13_ARGS)
             : launch_tiles<T, I, false, false>(SDT_K13_ARGS);
#undef SDT_K13_ARGS
}

}  // namespace
}  // namespace sdt

// rows_per_tile: 1 to 32; q: steps of 256 columns a work item; staged:
// the tile's masks in shared memory; status: at least ceil(r /
// rows_per_tile) words that no other launch uses now; ticket: one word,
// 0 between calls; tag: this call's number, in [1, 2^23), other than the
// last one that wrote these status words.
extern "C" int sdt_csr_compact(int dtype, int itype, const void* c,
                               const void* p, int64_t r, int64_t n,
                               int triangular, int64_t row0,
                               int rows_per_tile, int q, int staged,
                               void* status, void* ticket, int64_t tag,
                               void* indptr, void* indices, void* data,
                               void* total, void* stream) {
  SDT_DISPATCH(dtype, itype, sdt::launch, c, p, r, n, triangular, row0,
               rows_per_tile, q, staged, status, ticket, tag, indptr,
               indices, data, total, static_cast<cudaStream_t>(stream))
}
