"""Sparse x sparse products: K4 ``csr_spgemm_count``, K5
``csr_spgemm_fill`` (sparse output) and K6 ``csr_spgemm_dense`` (dense
output).

Each wrapper takes the CSR arrays of op(A) (m rows) and op(B) (n
columns), as ``csr_arrays()`` of any container gives them.  On a CUDA
tensor it launches the hand-written kernel (``csrc/csr_spgemm.cu``,
``csrc/csr_spgemm_dense.cu``) or raises; on a CPU tensor it runs the
plain PyTorch version beside it, which is also what the kernel is checked
against on the card.  ``<wrapper>.launches`` counts the wrapper's calls
that launched its kernel.

They replace the JAX package's XLA-level SpGEMM: the densify + pattern
matmul family of ``sparse_dot_tpu/ops/_xla.py`` (``spgemm_numeric_sorted``,
``_pattern_matmul``, ``spgemm_structural_sorted``, ``extract_structure``)
and its expand-sort-compress path (``_xla.esc_spgemm_block``,
``_esc_sort_compress``, ``host._spgemm_esc_arrays_impl``).

The output pattern is structural, as in the JAX package: (i, j) is
stored when any stored op(A)[i, k] meets a stored op(B)[k, j], explicit
zeros and exactly cancelled sums included, and each row's columns come
out in ascending order.  ``triangular=True`` keeps only j >= i.

How a sparse-output product runs on the card:

1. the plan (``spgemm_plan`` in plain torch defines it; on the card K4's
   launch builds the same arrays, with no host sync): each row's bound
   ``ub[i] = sum of nnz(op(B)[k, :]) over op(A)[i, k]``, and a bin for
   each row from the table ``spgemm_bins``, which picks the row's
   accumulator: for ub <= 32 the registers of a group of 4, 8, 16 or 32
   lanes (one product a lane), past that by ``min(ub[i], n)`` a warp's
   sorted products (up to 128 or 512 a row: keys in registers, each
   product's entries in shared memory), a hash table in shared memory
   for a block, a dense row of width n in shared memory, or a dense row
   in a bounded device workspace;
2. K4 writes each row's number of distinct columns;
3. ``indptr`` is their running sum; reading ``nnz = indptr[-1]`` to size
   the output is the one host sync (the JAX package pays the same one);
4. K5 writes each row's columns in ascending order with their values.

op(B) must not repeat a column within a row (containers hold canonical
CSR): the kernels let one thread own each column of a B row at a time.

A dense-output product is one launch of K6 on the plan ``dense_plan``
picks: warps, each with a partial row of C in shared memory, share out
the rows (a row split across warps when rows are few, cut into column
windows when it is wide).  Where a work item covers less than a whole
row (windows, or the gram's diagonal), K6 enters each row of op(B) where
the item's columns start: at a window from a table of window starts that
the launch builds first (``window_starts_pay``), at the diagonal by
binary search.  That needs op(B)'s rows sorted: the caller says so
(``b_sorted``), else the wrapper sorts them first and raises where a row
repeats a column (on both devices, so the plain version and the kernel
refuse the same inputs).

Gradients, on either device, when an operand is tracked
(``csr.tracked``): ``csr_spgemm_dense`` runs
``ops.autograd.CsrSpgemmDense``, K6 forward and K9
(``ops/spgemm_grad.csr_spgemm_sddmm``) for both operands' values
backward; ``csr_spgemm`` runs ``ops.autograd.CsrSpgemm``, K4 + K5 forward
and K11 (``ops/spgemm_grad.csr_spgemm_sparse_sddmm``) for both operands'
values backward, with G on C's pattern; both to any order.
``csr_spgemm_fill`` called directly carries no gradient and raises on a
tracked operand.

Batches (``torch.func.vmap`` over the values, and the transforms built
on it): ``spgemm_dense_batched`` (K6), ``fill_batched`` (K5) and
``product_batched`` (one plan and K4, one nnz read, one batched K5) take
members that share both patterns, each operand's values per member or
shared, in one launch, the member on the grid's y dimension; each has a
plain version vectorised over the members.  K5's batch runs a group of
``fill_groups`` members a block in each bin where that fits
(``csrc/csr_spgemm_group.cu``): the row's structural work done once for
the group, each member's values M times.  K6's batch runs a group of
``dense_group`` members a block (``csrc/csr_spgemm_dense_group.cu``):
a warp walks its chunk of op(A)'s row once for the group, each member's
values and partial row M times.
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import config
from ..formats import (_check_index_bounds, expand_indptr, structure_only,
                       sorted_unique_columns)
from . import _build
from .csr import (_add_rows, _check, batch_size, check_members,
                  member_chunks, member_ptr, member_stride, refuse_tracked,
                  refuse_views, tracked)
from .dense import axpby

# Kinds of row bins (the codes of csrc/csr_spgemm.cu's BinKind).
(SKIP, SORTED_WARP, HASH_BLOCK, DENSE_SHARED, DENSE_GLOBAL,
 TINY4, TINY8, TINY16, TINY32) = range(9)
# The register bins by group width G: rows of 1..G products, one a lane.
TINY_KINDS = {4: TINY4, 8: TINY8, 16: TINY16, 32: TINY32}
TINY_MAX = max(TINY_KINDS)
# Shared memory one thread block of K4/K5 may ask for.
SHARED_BUDGET = 200 * 1024
# The sorted-product bins' products a row (slots = u_max): one warp a
# row, 8 a block, each warp's region sized to its bin's products.  Each
# stands where a hash table of twice its products would: in the table
# only where n is past DENSE_RATIO times that.
WARP_PRODUCTS = (128, 512)
# Hash table sizes (slots): one table per block, from BLOCK_SLOTS up to
# the largest that SHARED_BUDGET holds.
BLOCK_SLOTS = 4096
# A row of width n takes the dense accumulator once its hash table (or
# the one a sorted-product bin stands for) would need n / DENSE_RATIO
# slots or more.
DENSE_RATIO = 8
# Bytes of device memory for the dense rows of the DENSE_GLOBAL bin.
GLOBAL_WORKSPACE = 256 << 20
# K6 (csrc/csr_spgemm_dense.cu): a block of DENSE_WARPS warps, each with a
# partial row of C of at most DENSE_ROW_BYTES in shared memory (so 56 KB a
# block and 4 blocks an SM); work enough for DENSE_WARPS_PER_SM warps on
# every SM before a row is split; a split chunk of op(A) entries no
# shorter than DENSE_MIN_CHUNK (two batches of the 32 entries that a
# warp's lanes load at once).
DENSE_WARPS = 8
DENSE_ROW_BYTES = 7 * 1024
DENSE_WARPS_PER_SM = 32
DENSE_MIN_CHUNK = 64
# K6's member groups (csrc/csr_spgemm_dense_group.cu) run on the single
# plan: a window's cap leaves room for 4 members' partial rows a warp
# within the 227 KB of shared memory an H100 block may ask for.
assert DENSE_WARPS * DENSE_ROW_BYTES * 4 <= 227 * 1024
# What the members of a batched K6 launch share (``dense_form``): op(B)'s
# values (op(A)'s per member), nothing but op(A)'s pattern and op(B)'s
# (op(B)'s values per member), or both operands' values (only C0 and C
# per member, one sum for the group).
B_SHARED, B_PER_MEMBER, ONE_SUM = "b_shared", "b_per_member", "one_sum"


def _round16(nbytes):
    return -(-nbytes // 16) * 16


def dense_row_bytes(n, dtype):
    """Bytes of one dense accumulator row of K5: values and flags."""
    return _round16(n * (dtype.itemsize + 1))


def max_hash_slots(dtype, index_dtype):
    """Largest power-of-two hash table (keys and values) of K5 that fits
    SHARED_BUDGET."""
    slots = BLOCK_SLOTS
    while 2 * slots * (dtype.itemsize + index_dtype.itemsize) <= SHARED_BUDGET:
        slots *= 2
    return slots


def spgemm_bins(dtype, index_dtype, n):
    """Row bins of K4/K5 for values of ``dtype``, indices of
    ``index_dtype`` and n output columns: an (nbins, 3) int64 numpy array
    of (kind, slots, u_max) rows, u_max ascending.  A row of ub products
    goes to the first bin with ub <= u_max: ub == 0 to SKIP, 1 <= ub <= 32
    to the register bin of the smallest width G >= ub (slots = G),
    whatever n; a sorted-product bin (SORTED_WARP) rows of up to slots =
    128 or 512 products; a hash bin rows of up to slots / 2 products (so
    of distinct columns: load at most one half); the last bin (dense, in
    shared memory when a row of width n fits SHARED_BUDGET, else in the
    device workspace) takes the rest.  Past 32 products ub picks the same
    bin as u = min(ub, n) would: a sorted-product or hash bin is in the
    table only where n is above its u_max."""
    return _bins_table(dtype, index_dtype, n).copy()


@functools.lru_cache(maxsize=256)
def _bins_table(dtype, index_dtype, n):
    bins = [(SKIP, 0, 0)] + [(kind, g, g) for g, kind in TINY_KINDS.items()]
    dense_fits = dense_row_bytes(n, dtype) <= SHARED_BUDGET
    candidates = [(SORTED_WARP, u, u) for u in WARP_PRODUCTS]
    candidates += [(HASH_BLOCK, s, s // 2) for s in
                   (BLOCK_SLOTS, max_hash_slots(dtype, index_dtype))]
    for kind, slots, u_max in candidates:
        if dense_fits and n <= DENSE_RATIO * 2 * u_max:
            break
        bins.append((kind, slots, u_max))
    last = (DENSE_SHARED if dense_fits else DENSE_GLOBAL, n,
            np.iinfo(np.int64).max)
    return np.array(bins + [last], dtype=np.int64)


class SpgemmPlan(NamedTuple):
    """Row bounds and row bins of one product.

    ``ub`` (m,) int64: the number of products of each row.  ``rows`` (m,)
    int64: the row ids, grouped by bin; bin b's rows are
    ``rows[offsets[b]:offsets[b + 1]]`` with ``offsets`` an (nbins + 1,)
    int64 tensor on the device.  ``bins``: ``spgemm_bins``'s host table."""

    ub: torch.Tensor
    rows: torch.Tensor
    offsets: torch.Tensor
    bins: np.ndarray


def row_bounds(a_indptr, a_indices, b_indptr):
    """ub[i] = sum over op(A)[i, k] of nnz(op(B)[k, :]), in int64: a
    gather of B's row lengths, their running sum (int64) and its
    difference at ``a_indptr``."""
    prefix = a_indices.new_zeros(a_indices.numel() + 1, dtype=torch.long)
    torch.cumsum(b_indptr.diff().index_select(0, a_indices), 0,
                 out=prefix[1:])
    return prefix.index_select(0, a_indptr).diff()


def _thresholds(bins, device):
    """The bins' u_max but the last (int64) on ``device``; on the card
    copied from pinned memory, so that ``spgemm_plan`` does not wait for
    the card: ``chip_smoke.py`` builds it there under the sync-debug mode
    "error", as the reference for the plan K4 builds in its launch."""
    u_max = torch.from_numpy(np.ascontiguousarray(bins[:-1, 2]))
    if device.type == "cuda":
        return u_max.pin_memory().to(device, non_blocking=True)
    return u_max


def spgemm_plan(a_indptr, a_indices, b_indptr, n, dtype, index_dtype):
    """The plan of K4/K5 (``SpgemmPlan``), built with device ops only:
    nothing waits for the device.  Each row's bin id comes from one
    ``bucketize`` of its ub against the bins' thresholds; a stable sort of
    the ids groups the rows by bin, in row order within a bin.  About ten
    ops: at 1M rows the card runs them faster than the host issues them,
    so on the card ``plan_and_count`` builds the same plan in K4's
    launch."""
    ub = row_bounds(a_indptr, a_indices, b_indptr)
    bins = spgemm_bins(dtype, index_dtype, n)
    bin_of = torch.bucketize(ub, _thresholds(bins, ub.device),
                             out_int32=True)
    sorted_bins, rows = torch.sort(bin_of, stable=True)
    # Bin b's rows start where the sorted ids first reach b (searchsorted;
    # bincount would read the largest bin back to the host).
    ids = torch.arange(len(bins) + 1, dtype=torch.int32, device=ub.device)
    offsets = torch.searchsorted(sorted_bins, ids)
    return SpgemmPlan(ub, rows, offsets, bins)


# ---------------------------------------------------------------------------
# Plain versions: expand, sort, compress (ESC)
# ---------------------------------------------------------------------------


def _row_chunks(ub, members=1):
    """Row ranges [r0, r1) whose products, once for each of ``members``
    (a batch's members, each with its own values), stay within
    ``config.spmm_chunk_elements`` (a longer row is a chunk alone)."""
    budget = max(1, config.spmm_chunk_elements // members)
    prefix = np.concatenate([[0], np.cumsum(ub.cpu().numpy())])
    m, r = len(prefix) - 1, 0
    while r < m:
        end = int(np.searchsorted(prefix, prefix[r] + budget, "right")) - 1
        end = min(max(end, r + 1), m)
        yield r, end
        r = end


def products(a_indptr, a_indices, b_indptr, b_indices, a_rows, r0, r1,
             triangular):
    """(p, q, row, col) of every product a(i, k) * b(k, j) of rows
    [r0, r1), in op(A)'s stored order, then op(B)'s: the positions of its
    entries of op(A) and op(B) and its entry (i, j) of C, as int64; only
    j >= i with ``triangular``."""
    p0, p1 = int(a_indptr[r0]), int(a_indptr[r1])
    k = a_indices[p0:p1].long()
    b_start = b_indptr[:-1].long()[k]
    count = b_indptr[1:].long()[k] - b_start
    total = int(count.sum())
    entry = torch.repeat_interleave(
        torch.arange(p1 - p0, device=k.device), count, output_size=total)
    first = torch.cumsum(count, 0) - count
    q = b_start[entry] + torch.arange(total, device=k.device) - first[entry]
    p = entry + p0
    rows, cols = a_rows[p].long(), b_indices[q].long()
    if triangular:
        keep = cols >= rows
        p, q, rows, cols = p[keep], q[keep], rows[keep], cols[keep]
    return p, q, rows, cols


def _expand(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data,
            a_rows, r0, r1, triangular):
    """(row, col, value) of every product of rows [r0, r1)
    (``products``), the values with the members of a batch ahead where an
    operand has them; ``a_data`` None skips the values."""
    p, q, rows, cols = products(a_indptr, a_indices, b_indptr, b_indices,
                                a_rows, r0, r1, triangular)
    vals = None if a_data is None else a_data[..., p] * b_data[..., q]
    return rows, cols, vals


def spgemm_plain(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data,
                 n, triangular=False):
    """op(A) @ op(B) -> CSR (indptr, indices, data) in plain PyTorch: the
    products of each chunk of rows are keyed by row * n + col, sorted
    stably, and summed by ``unique_consecutive`` and ``index_add_``; so
    each entry's products add in op(A)'s stored order, as in K5.  Chunks
    hold at most ``config.spmm_chunk_elements`` products."""
    return _esc(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data,
                n, triangular, ())


def spgemm_plain_batched(a_indptr, a_indices, a_data, b_indptr, b_indices,
                         b_data, n, triangular=False):
    """``spgemm_plain`` for a batch of members that share both patterns,
    ``a_data`` and ``b_data`` each (B, nnz) or shared (nnz,), at least one
    with the member dimension: vectorised over the members (one expansion
    and one sort of the keys for all, each member's products summed as
    ``spgemm_plain`` sums them).  Returns (indptr, indices, data (B,
    nnz(C)))."""
    size = batch_size("csr_spgemm", ((a_data, 1), (b_data, 1)))
    return _esc(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data,
                n, triangular, (size,))


def _esc(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data, n,
         triangular, lead):
    """``spgemm_plain``'s expand, sort and compress, C's values of leading
    shape ``lead``: () for one product, (B,) for a batch's members."""
    m = a_indptr.numel() - 1
    dev, itype = a_indptr.device, a_indptr.dtype
    a_rows = expand_indptr(a_indptr.long(), a_indices.numel())
    counts = torch.zeros(m, dtype=torch.long, device=dev)
    cols, vals = [], []
    for r0, r1 in _row_chunks(row_bounds(a_indptr, a_indices, b_indptr),
                              lead[0] if lead else 1):
        rows, col, val = _expand(a_indptr, a_indices, a_data, b_indptr,
                                 b_indices, b_data, a_rows, r0, r1,
                                 triangular)
        key, order = torch.sort(rows * n + col, stable=True)
        key, inverse = torch.unique_consecutive(key, return_inverse=True)
        summed = torch.zeros((*lead, key.numel()), dtype=a_data.dtype,
                             device=dev)
        _add_rows(summed, inverse, val[..., order].expand(*lead, -1),
                  dim=len(lead))
        vals.append(summed)
        cols.append(key % n)
        counts[r0:r1] = torch.bincount(key // n - r0, minlength=r1 - r0)
    indptr = torch.zeros(m + 1, dtype=torch.long, device=dev)
    torch.cumsum(counts, 0, out=indptr[1:])
    _check_index_bounds(int(indptr[-1]), (m, n), itype)
    empty = torch.zeros(0, dtype=torch.long, device=dev)
    return (indptr.to(itype), torch.cat(cols or [empty]).to(itype),
            torch.cat(vals, -1) if vals
            else torch.zeros((*lead, 0), dtype=a_data.dtype, device=dev))


def csr_spgemm_count_plain(a_indptr, a_indices, b_indptr, b_indices, n,
                           triangular=False):
    """K4's plain version: the number of distinct columns of each row of
    op(A) @ op(B), as int64, by the same ESC over keys alone."""
    m = a_indptr.numel() - 1
    a_rows = expand_indptr(a_indptr.long(), a_indices.numel())
    counts = torch.zeros(m, dtype=torch.long, device=a_indptr.device)
    for r0, r1 in _row_chunks(row_bounds(a_indptr, a_indices, b_indptr)):
        rows, col, _ = _expand(a_indptr, a_indices, None, b_indptr,
                               b_indices, None, a_rows, r0, r1, triangular)
        key = torch.unique(rows * n + col)
        counts[r0:r1] = torch.bincount(key // n - r0, minlength=r1 - r0)
    return counts


def csr_spgemm_fill_plain(a_indptr, a_indices, a_data, b_indptr, b_indices,
                          b_data, n, triangular=False):
    """K5's plain version: (indices, data) of ``spgemm_plain``."""
    _, indices, data = spgemm_plain(a_indptr, a_indices, a_data, b_indptr,
                                    b_indices, b_data, n, triangular)
    return indices, data


def csr_spgemm_fill_batched_plain(a_indptr, a_indices, a_data, b_indptr,
                                  b_indices, b_data, n, triangular=False):
    """K5's batched plain version: (indices, data (B, nnz(C))) of
    ``spgemm_plain_batched``."""
    _, indices, data = spgemm_plain_batched(a_indptr, a_indices, a_data,
                                            b_indptr, b_indices, b_data, n,
                                            triangular)
    return indices, data


def csr_spgemm_dense_plain(a_indptr, a_indices, a_data, b_indptr, b_indices,
                           b_data, n, alpha=None, beta=None, c0=None,
                           triangular=False):
    """K6's plain version: ``alpha * op(A) @ op(B) + beta * c0`` as a
    dense (m, n) tensor, scattering the expanded products of each chunk
    of rows with ``index_add_`` (no densified operand)."""
    return _dense_plain(a_indptr, a_indices, a_data, b_indptr, b_indices,
                        b_data, n, alpha, beta, c0, triangular, ())


def csr_spgemm_dense_batched_plain(a_indptr, a_indices, a_data, b_indptr,
                                   b_indices, b_data, n, alpha=None,
                                   beta=None, c0=None, triangular=False):
    """K6's batched plain version: ``csr_spgemm_dense_plain`` for a batch
    of members that share both patterns (``a_data`` and ``b_data`` (B,
    nnz) or shared (nnz,), ``c0`` (B, m, n), (m, n) or None, at least one
    with the member dimension), vectorised over the members; (B, m, n)."""
    size = batch_size("csr_spgemm_dense",
                      ((a_data, 1), (b_data, 1), (c0, 2)))
    return _dense_plain(a_indptr, a_indices, a_data, b_indptr, b_indices,
                        b_data, n, alpha, beta, c0, triangular, (size,))


def _dense_plain(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data,
                 n, alpha, beta, c0, triangular, lead):
    """``csr_spgemm_dense_plain`` with C of leading shape ``lead``: () for
    one product, (B,) for a batch's members."""
    m = a_indptr.numel() - 1
    c = torch.zeros((*lead, m * n), dtype=a_data.dtype, device=a_data.device)
    a_rows = expand_indptr(a_indptr.long(), a_indices.numel())
    for r0, r1 in _row_chunks(row_bounds(a_indptr, a_indices, b_indptr),
                              lead[0] if lead else 1):
        rows, cols, vals = _expand(a_indptr, a_indices, a_data, b_indptr,
                                   b_indices, b_data, a_rows, r0, r1,
                                   triangular)
        _add_rows(c, rows * n + cols, vals.expand(*lead, -1), dim=len(lead))
    return axpby(c.reshape(*lead, m, n), alpha, beta, c0)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


def _workspace(table, per_group, device, members=1):
    """(workspace, groups): dense rows of ``per_group`` bytes for the
    DENSE_GLOBAL bin of ``table`` (``_launch_table``'s), ``groups`` for
    each of ``members`` members, as many as GLOBAL_WORKSPACE holds (at
    least one a member, at most two per SM)."""
    if table[-1, 0] != DENSE_GLOBAL:
        return None, 0
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    groups = max(1, min(2 * sms, GLOBAL_WORKSPACE // (per_group * members)))
    work = torch.empty(members * groups * per_group, dtype=torch.uint8,
                       device=device)
    return work, groups


def _fill_members(table, per_group):
    """The most members of one batched K5 launch: ``_build.MAX_MEMBERS``,
    or where the DENSE_GLOBAL bin of ``table`` is used, as many as keep
    one workspace row each within GLOBAL_WORKSPACE (at least one)."""
    if table[-1, 0] != DENSE_GLOBAL:
        return _build.MAX_MEMBERS
    return max(1, min(_build.MAX_MEMBERS, GLOBAL_WORKSPACE // per_group))


# Groups of threads a block of each shared-memory bin holds (one region
# each).
_BIN_GROUPS = {SORTED_WARP: 8, HASH_BLOCK: 1, DENSE_SHARED: 1}


def group_bytes(kind, slots, dtype, index_dtype, members):
    """Shared memory a block of K5's sorted-product, hash or
    dense-shared bin ``kind`` asks for with ``members`` members a block:
    one region a group of threads, rounded up to 16.  A sorted-product
    region holds each of its ``slots`` products' op(A) and op(B) entries
    and a 16-bit sorted order, whatever the members
    (``csrc/csr_spgemm.cuh``, sorted_region_bytes); a hash or dense
    region the members' values a slot then the keys (hash) or flag bytes
    (dense) (region_bytes)."""
    if kind == SORTED_WARP:
        return _BIN_GROUPS[kind] * _round16(slots * (2 * index_dtype.itemsize
                                                     + 2))
    tail = slots * index_dtype.itemsize if kind != DENSE_SHARED else slots
    return _BIN_GROUPS[kind] * _round16(members * slots * dtype.itemsize
                                        + tail)


def fill_groups(bins, dtype, index_dtype, size, most=None):
    """Members a block of each bin of ``bins`` (a plan's or a launch
    table's kinds and slots) in a batched K5 launch of ``size`` members:
    the register bins 4, a sorted-product, hash or dense-shared bin the
    most of 4 and 2 whose region fits SHARED_BUDGET (``group_bytes``; a
    sorted-product region does not grow with the members, so 4), else 1
    (the per-member instance), as are the dense rows in the device
    workspace; 2 at most for a batch of 2, and 1 for a batch of 1; at
    most ``most`` when given (1: the per-member instance in every bin).
    4 ran fastest at case c in f64 (either index width), f32 and c128
    and at the sorted-product rows of a 100,000^2 Poisson(10) A @ A in
    f64, 2 and 1 slower (PERF.md).  An int64 numpy array, one entry a
    bin; cached by what it depends on."""
    top = 1 if size < 2 else 2 if size == 2 else 4
    if most is not None:
        top = min(top, most)
    return _fill_groups(np.ascontiguousarray(bins[:, :2]).tobytes(), dtype,
                        index_dtype, top)


@functools.lru_cache(maxsize=256)
def _fill_groups(kinds_slots, dtype, index_dtype, most):
    table = np.frombuffer(kinds_slots, dtype=np.int64).reshape(-1, 2)
    out = np.ones(len(table), dtype=np.int64)
    for b, (kind, slots) in enumerate(table):
        if kind in TINY_KINDS.values():
            out[b] = most
        elif kind in _BIN_GROUPS:
            out[b] = next((g for g in (4, 2) if g <= most and group_bytes(
                kind, int(slots), dtype, index_dtype, g) <= SHARED_BUDGET),
                1)
    out.flags.writeable = False
    return out


def _by_group(table, groups):
    """(members a block, table) of each group size among ``table``'s
    launched bins: the table with every other bin SKIP (the table itself
    where all take one size)."""
    live = table[:, 0] != SKIP
    sizes = sorted(set(groups[live].tolist())) or [1]
    if len(sizes) == 1:
        return [(sizes[0], table)]
    parts = []
    for g in sizes:
        part = table.copy()
        part[groups != g, 0] = SKIP
        parts.append((g, part))
    return parts


def _launch_table(plan, m, sizes=None):
    """The kernels' bin table: (kind, slots, rows) a bin, rows bounding
    the bin's rows to size its grid: m for K4, which runs before the sizes
    are known, or for K5 the bin's size from ``sizes`` (host ints).  With
    ``sizes`` an empty bin becomes SKIP; the register bins, which run in
    one launch, only when all four are empty."""
    table = plan.bins.copy()
    if sizes is None:
        table[:, 2] = m
        return table
    table[:, 2] = sizes
    empty = table[:, 2] == 0
    tiny = slice(1, 1 + len(TINY_KINDS))  # spgemm_bins puts them there
    empty[tiny] = empty[tiny].all()
    table[empty, 0] = SKIP
    return table


def _plan_args(plan, table, n):
    return (plan.rows.data_ptr(), plan.offsets.data_ptr(),
            table.ctypes.data, len(table), n)


def csr_spgemm_count(a_indptr, a_indices, b_indptr, b_indices, n, plan,
                     triangular=False, out=None):
    """K4: the number of distinct columns of each row of op(A) @ op(B)
    (j >= i only with ``triangular``), as an (m,) int64 tensor: ``out``
    when given (zeros, which rows of no product keep), else a new one.
    ``plan`` is ``spgemm_plan``'s for the same operands."""
    refuse_views("csr_spgemm_count", a_indptr, a_indices, b_indptr,
                 b_indices)
    if a_indptr.device.type == "cpu":
        return csr_spgemm_count_plain(a_indptr, a_indices, b_indptr,
                                      b_indices, n, triangular)
    return _count(a_indptr, a_indices, b_indptr, b_indices, n, plan,
                  triangular, out)


def plan_and_count(a_indptr, a_indices, b_indptr, b_indices, n, dtype,
                   triangular=False, out=None):
    """(plan, counts): ``spgemm_plan(..., n, dtype, index dtype)`` and K4.
    On the card K4 builds the plan itself, in the same launch (three
    kernels before the count: ub and the rows per bin of each tile of
    rows, one block's scan of those, a stable scatter of the row ids), to
    the same arrays as ``spgemm_plan``: its nine torch ops take the host
    longer to issue than these kernels take to run.  On the CPU: the
    torch plan and K4's plain version."""
    m = a_indptr.numel() - 1
    if a_indptr.device.type == "cpu":
        plan = spgemm_plan(a_indptr, a_indices, b_indptr, n, dtype,
                           a_indptr.dtype)
        return plan, csr_spgemm_count(a_indptr, a_indices, b_indptr,
                                      b_indices, n, plan, triangular, out)
    bins = spgemm_bins(dtype, a_indptr.dtype, n)
    nb = len(bins)
    if m == 0 or n == 0:  # no product: every row in SKIP, no launch
        plan = _empty_plan(m, bins, a_indptr.device)
        return plan, _count(a_indptr, a_indices, b_indptr, b_indices, n,
                            plan, triangular, out)
    lanes, tile_rows = _plan_tiles(a_indices.numel() / m)
    tiles = -(-m // tile_rows)
    # ub, rows, offsets and the per-tile scratch in one allocation.
    buf = torch.empty(2 * m + nb + 1 + tiles * nb, dtype=torch.long,
                      device=a_indptr.device)
    plan = SpgemmPlan(buf[:m], buf[m:2 * m], buf[2 * m:2 * m + nb + 1], bins)
    counts = _count(a_indptr, a_indices, b_indptr, b_indices, n, plan,
                    triangular, out,
                    build=(lanes, tile_rows, buf[2 * m + nb + 1:]))
    return plan, counts


def _empty_plan(m, bins, device):
    """``spgemm_plan``'s arrays where no row has a product (m == 0 or
    n == 0): ub 0, the rows in order, all of them in the first bin."""
    offsets = torch.full((len(bins) + 1,), m, dtype=torch.long,
                         device=device)
    offsets[0] = 0
    return SpgemmPlan(torch.zeros(m, dtype=torch.long, device=device),
                      torch.arange(m, device=device), offsets, bins)


def _plan_tiles(mean_row):
    """(lanes a row, rows a tile) of the plan built on the card, for op(A)
    rows of ``mean_row`` entries: the power of two of lanes at or above
    the mean, at most 32, and tiles of about 2048 entries, in whole rounds
    of the 256 / lanes groups of a block (and at most 32 rounds)."""
    lanes = 1
    while lanes < min(32, mean_row):
        lanes *= 2
    groups = 256 // lanes
    rounds = int(max(1, min(32, 2048 // (groups * max(mean_row, 1)))))
    return lanes, groups * rounds


def _count(a_indptr, a_indices, b_indptr, b_indices, n, plan, triangular,
           out, build=None):
    """K4's launch on the card; with ``build`` = (lanes a row, rows a
    tile, scratch) it first fills ``plan``'s ub, rows and offsets from its
    ``bins``."""
    if not a_indptr.is_cuda:
        raise ValueError(f"csr_spgemm_count: no kernel for device "
                         f"{a_indptr.device}")
    _check("csr_spgemm_count", (a_indptr, a_indices, b_indptr, b_indices),
           (plan.ub,))
    m = a_indptr.numel() - 1
    counts = (torch.zeros(m, dtype=torch.long, device=a_indptr.device)
              if out is None else out)
    if counts.shape != (m,) or counts.dtype != torch.long:
        raise ValueError(f"csr_spgemm_count: out must be ({m},) int64")
    if m == 0 or n == 0:
        return counts
    table = _launch_table(plan, m)
    lanes, tile_rows, tile_bins = build or (1, 256, None)
    u_max = (None if build is None
             else np.ascontiguousarray(plan.bins[:-1, 2]))
    # K4's dense rows hold one flag byte per column.
    work, groups = _workspace(table, _round16(n), a_indptr.device)
    _build.launch(
        "sdt_csr_spgemm_count", _build.ITYPE_CODES[a_indptr.dtype],
        a_indptr.data_ptr(), a_indices.data_ptr(), b_indptr.data_ptr(),
        b_indices.data_ptr(), *_plan_args(plan, table, n), int(triangular),
        counts.data_ptr(), None if work is None else work.data_ptr(),
        groups, None if u_max is None else u_max.ctypes.data, m, lanes,
        tile_rows, plan.ub.data_ptr(),
        None if tile_bins is None else tile_bins.data_ptr(),
        _build.stream_of(a_indptr),
    )
    csr_spgemm_count.launches += 1
    return counts


csr_spgemm_count.launches = 0


def csr_spgemm_fill(a_indptr, a_indices, a_data, b_indptr, b_indices,
                    b_data, n, plan, c_indptr, nnz, triangular=False,
                    bin_sizes=None):
    """K5: (indices, data) of op(A) @ op(B) in the CSR layout of
    ``c_indptr`` (K4's counts summed, ``nnz`` entries), each row's columns
    ascending; values summed in op(A)'s stored order.  K5 skips the empty
    bins and sizes each grid to its bin: ``bin_sizes`` are the plan's rows
    per bin as host ints, read from ``plan.offsets`` when not given (a
    host read, as that of ``nnz``; ``csr_spgemm`` reads both at once).
    Carries no gradient: raises on a tracked operand
    (``csr.refuse_tracked``)."""
    refuse_tracked("csr_spgemm_fill", a_data, b_data)
    return fill(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data, n,
                plan, c_indptr, nnz, triangular, bin_sizes)


def fill(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data, n, plan,
         c_indptr, nnz, triangular=False, bin_sizes=None):
    """``csr_spgemm_fill`` without the tracked check, for
    ``ops.autograd``'s Functions: K5 on the card, its plain version on the
    CPU; counted in ``csr_spgemm_fill.launches``.  ``plan`` None: the
    plan is built here (``spgemm_plan``: device ops, no K4; the
    Functions pass ``pair_plan``'s, cached on the operands' patterns)."""
    refuse_views("csr_spgemm_fill", a_indptr, a_indices, a_data, b_indptr,
                 b_indices, b_data)
    if a_data.device.type == "cpu":
        return csr_spgemm_fill_plain(a_indptr, a_indices, a_data, b_indptr,
                                     b_indices, b_data, n, triangular)
    if plan is None:
        plan = spgemm_plan(a_indptr, a_indices, b_indptr, n, a_data.dtype,
                           a_indptr.dtype)
    return _fill_launcher(a_indptr, a_indices, a_data, b_indptr, b_indices,
                          b_data, n, plan, c_indptr,
                          triangular)(nnz, bin_sizes)


def fill_batched(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data,
                 n, plan, c_indptr, nnz, triangular=False, bin_sizes=None):
    """K5 for a batch of members that share op(A)'s and op(B)'s patterns:
    member i's values of op(A) @ op(B) on C's pattern (``c_indptr``, nnz
    entries), op(A)'s values ``a_data[i]`` and op(B)'s ``b_data[i]``
    ((B, nnz) each, or (nnz,) shared, at least one with the member
    dimension, each member contiguous).  Returns (indices (nnz,), data
    (B, nnz)): C's column ids, the same for every member, written once.
    One launch a bin on the card for up to ``_build.MAX_MEMBERS`` members
    (fewer where the dense rows in the device workspace would pass
    GLOBAL_WORKSPACE: ``_fill_members``), each bin at ``fill_groups``
    members a block, on the shared plan (``plan`` None: built here, as in
    ``fill``); counted in ``csr_spgemm_fill.launches`` and
    ``launches_batched``, those with a group in ``launches_group``.  The
    batched plain version on the CPU.  Carries no gradient
    (``ops.autograd``'s ``CsrSpgemmFill`` does)."""
    refuse_views("csr_spgemm_fill", a_indptr, a_indices, a_data, b_indptr,
                 b_indices, b_data)
    size = batch_size("csr_spgemm_fill", ((a_data, 1), (b_data, 1)))
    if a_data.device.type == "cpu":
        return csr_spgemm_fill_batched_plain(a_indptr, a_indices, a_data,
                                             b_indptr, b_indices, b_data, n,
                                             triangular)
    if plan is None:
        plan = spgemm_plan(a_indptr, a_indices, b_indptr, n, a_data.dtype,
                           a_indptr.dtype)
    return _fill_launcher(a_indptr, a_indices, a_data, b_indptr, b_indices,
                          b_data, n, plan, c_indptr, triangular,
                          size)(nnz, bin_sizes)


def pair_plan(a, b, dtype):
    """(plan, bin sizes) of K5 for op(A) and op(B) given as
    ``CsrPattern``s ``a`` and ``b`` and values of ``dtype``:
    ``spgemm_plan``'s device ops and one host read of its bin sizes, made
    once per pattern pair and value type and cached on ``a.plans`` (as
    K11's runs are on P's), so that ``CsrSpgemmFill`` (the tangents of
    ``csr_spgemm``, the derivatives of its backward) neither plans nor
    reads the host again at every fill.  The plan holds no values and
    counts every product (``triangular`` is K5's own filter)."""
    key = ("k5", b, dtype)
    if key not in a.plans:
        with structure_only():
            plan = spgemm_plan(a.indptr, a.indices, b.indptr, b.ncols, dtype,
                               a.indptr.dtype)
            a.plans[key] = (plan, np.diff(plan.offsets.tolist()))
    return a.plans[key]


def _fill_launcher(a_indptr, a_indices, a_data, b_indptr, b_indices,
                   b_data, n, plan, c_indptr, triangular, members=None):
    """K5's launch on the card, made ready up to what the output's size
    decides: ``launch(nnz, bin_sizes)`` then allocates the output and
    launches (``bin_sizes`` None: read from ``plan.offsets``).
    ``csr_spgemm`` makes it before its one host sync, so only ``launch``
    stands between the sync and K5.  With ``members`` (a batch's size)
    the values are ``fill_batched``'s and so is the output, each bin at
    ``fill_groups`` members a block (``launch``'s ``most``, when given,
    caps them: 1 runs the per-member instance, for measurements)."""
    if not a_data.is_cuda:
        raise ValueError(f"csr_spgemm_fill: no kernel for device "
                         f"{a_data.device}")
    index_tensors = (a_indptr, a_indices, b_indptr, b_indices, c_indptr)
    if members is None:
        _check("csr_spgemm_fill", index_tensors, (a_data, b_data))
        strides = (0, 0, 0)
    else:
        strides = tuple(check_members("csr_spgemm_fill", index_tensors,
                                      ((a_data, 1), (b_data, 1)),
                                      views=False))
    m = a_indptr.numel() - 1
    device = a_data.device
    codes = _build.type_codes(a_data, a_indptr)
    a_ids = (a_indptr.data_ptr(), a_indices.data_ptr())
    b_ids = (b_indptr.data_ptr(), b_indices.data_ptr())
    rows = (plan.rows.data_ptr(), plan.offsets.data_ptr())
    tail = (n, int(triangular), c_indptr.data_ptr())
    stream = _build.stream_of(a_data)
    row_bytes = dense_row_bytes(n, a_data.dtype)

    def launch_k5(table, first, count, strides, indices, data, write,
                  groups=None):
        """One launch of K5 for ``count`` members from ``first``: each
        bin at its ``groups`` members a block (``fill_groups``; None: one
        member a block), the bins of one size in one call."""
        a_ptr, b_ptr, c_ptr = (member_ptr(t, st, first) for t, st in
                               zip((a_data, b_data, data), strides))
        head = (*codes, *a_ids, a_ptr, *b_ids, b_ptr, *rows)
        parts = (_by_group(table, groups) if groups is not None
                 else [(1, table)])
        for group, part in parts:
            if group == 1:
                work, wgroups = _workspace(part, row_bytes, device, count)
                _build.launch(
                    "sdt_csr_spgemm_fill", *head, part.ctypes.data,
                    len(part), *tail, indices.data_ptr(), c_ptr,
                    None if work is None else work.data_ptr(), wgroups,
                    count, *strides, int(write), stream)
            else:
                _build.launch(
                    "sdt_csr_spgemm_fill_group", *head, part.ctypes.data,
                    len(part), *tail, indices.data_ptr(), c_ptr, count,
                    *strides, int(write), group, stream)
        csr_spgemm_fill.launches += 1
        csr_spgemm_fill.launches_group += max(g for g, _ in parts) > 1

    def launch(nnz, bin_sizes=None, most=None):
        indices = torch.empty(nnz, dtype=a_indptr.dtype, device=device)
        data = torch.empty(nnz if members is None else (members, nnz),
                           dtype=a_data.dtype, device=device)
        if nnz == 0 or members == 0:
            return indices, data
        if bin_sizes is None:
            bin_sizes = np.diff(plan.offsets.tolist())
        table = _launch_table(plan, m, bin_sizes)
        if members is None:
            launch_k5(table, 0, 1, strides, indices, data, True)
            return indices, data
        for i, (first, count) in enumerate(member_chunks(
                members, _fill_members(table, row_bytes))):
            launch_k5(table, first, count, (*strides, nnz), indices, data,
                      i == 0, fill_groups(table, a_data.dtype,
                                          a_indptr.dtype, count, most))
            csr_spgemm_fill.launches_batched += 1
        return indices, data

    return launch


csr_spgemm_fill.launches = 0
csr_spgemm_fill.launches_batched = 0
csr_spgemm_fill.launches_group = 0


# The steps of ``csr_spgemm`` on the card, as its ``marks`` names them.
PRODUCT_STEPS = ("plan_and_K4", "running_sum", "nnz_read", "K5")


def csr_spgemm(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data, n,
               triangular=False, marks=None):
    """op(A) @ op(B) -> CSR (indptr, indices, data) with op(A)'s index
    dtype: the plan and K4 (one launch), the running sum, the nnz read, K5
    on the card (``PRODUCT_STEPS``; ``marks``, when given, is called with
    each step's name as it ends, to time them); the plain ESC on the CPU.
    Raises (with the ILP64 hint) when int32 indices cannot hold the
    output's nnz.

    When autograd or a ``torch.func`` transform follows ``a_data`` or
    ``b_data`` (``csr.tracked``), the call goes through
    ``ops.autograd.CsrSpgemm`` on either device (``marks`` unused): the
    same launches, and ``data`` carries its gradient (K11 twice on the
    card, ``ops/spgemm_grad.csr_spgemm_sparse_sddmm``); ``indptr`` and
    ``indices`` carry none."""
    if tracked(a_data, b_data):
        from .autograd import CsrSpgemm, patterns

        return CsrSpgemm.apply(
            patterns.get(a_indptr, a_indices, b_indptr.numel() - 1), a_data,
            patterns.get(b_indptr, b_indices, n), b_data, triangular)
    return product(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data,
                   n, triangular, marks)


def product(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data, n,
            triangular=False, marks=None):
    """``csr_spgemm`` without autograd: (indptr, indices, data)."""
    refuse_views("csr_spgemm", a_indptr, a_indices, a_data, b_indptr,
                 b_indices, b_data)
    if a_data.device.type == "cpu":
        return spgemm_plain(a_indptr, a_indices, a_data, b_indptr, b_indices,
                            b_data, n, triangular)
    return _product(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data,
                    n, triangular, marks)


def product_batched(a_indptr, a_indices, a_data, b_indptr, b_indices,
                    b_data, n, triangular=False):
    """``product`` for a batch of members that share op(A)'s and op(B)'s
    patterns (``a_data`` and ``b_data`` (B, nnz) or (nnz,) shared, at
    least one with the member dimension): (indptr, indices, data (B,
    nnz(C))), C's structure the patterns' and the members'.  On the card
    one plan and K4 (one launch), one nnz read and one batched K5
    (``fill_batched``'s launch); the batched plain version on the
    CPU."""
    refuse_views("csr_spgemm", a_indptr, a_indices, a_data, b_indptr,
                 b_indices, b_data)
    size = batch_size("csr_spgemm", ((a_data, 1), (b_data, 1)))
    if a_data.device.type == "cpu":
        return spgemm_plain_batched(a_indptr, a_indices, a_data, b_indptr,
                                    b_indices, b_data, n, triangular)
    return _product(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data,
                    n, triangular, None, size)


def _product(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data, n,
             triangular, marks, members=None):
    """``product`` on the card, of a batch of ``members`` when given."""
    mark = marks or (lambda step: None)
    m = a_indptr.numel() - 1
    total = torch.zeros(m + 1, dtype=torch.long, device=a_data.device)
    plan, _ = plan_and_count(a_indptr, a_indices, b_indptr, b_indices, n,
                             a_data.dtype, triangular, out=total[1:])
    mark("plan_and_K4")
    total[1:].cumsum_(0)
    indptr = total.to(a_indptr.dtype)
    launch = _fill_launcher(a_indptr, a_indices, a_data, b_indptr,
                            b_indices, b_data, n, plan, indptr, triangular,
                            members)
    mark("running_sum")
    # The one host sync: the output's size, read with the bin sizes.
    head = torch.cat((total[-1:], plan.offsets)).tolist()
    nnz = head[0]
    _check_index_bounds(nnz, (m, n), a_indptr.dtype)
    mark("nnz_read")
    indices, data = launch(nnz, np.diff(head[1:]))
    mark("K5")
    return indptr, indices, data


class DensePlan(NamedTuple):
    """K6's launch: ``splits`` warps an item (one row of C over one window
    of ``width`` columns; ``windows`` of them a row)."""

    splits: int
    width: int
    windows: int


def dense_plan(m, n, itemsize, a_nnz, sms=132):
    """K6's plan for m rows of op(A) holding ``a_nnz`` entries, n columns
    and values of ``itemsize`` bytes, on a card of ``sms`` SMs.  A window
    is the widest multiple of 32 columns that fits DENSE_ROW_BYTES (the
    whole row when it fits), the windows of a row of equal width; rows
    are split in 2, 4 or 8 chunks while the items leave the card short of
    DENSE_WARPS_PER_SM warps an SM and each chunk keeps DENSE_MIN_CHUNK
    entries of op(A) on average.  A group of members a block runs on the
    same plan, so each member has its single launch's bits."""
    cap = max(32, DENSE_ROW_BYTES // itemsize // 32 * 32)
    windows = max(1, -(-n // cap))
    width = max(1, min(n, -(-n // windows // 32) * 32 if windows > 1 else n))
    windows = max(1, -(-n // width))
    mean_row = a_nnz / max(m, 1)
    splits = 1
    while (splits < DENSE_WARPS
           and m * windows * splits < DENSE_WARPS_PER_SM * sms
           and mean_row >= DENSE_MIN_CHUNK * 2 * splits):
        splits *= 2
    return DensePlan(splits, width, windows)


def dense_form(s_a, s_b):
    """What the members of a batched K6 launch share, from op(A)'s and
    op(B)'s member strides (0: shared): B_PER_MEMBER, B_SHARED or
    ONE_SUM."""
    return B_PER_MEMBER if s_b else B_SHARED if s_a else ONE_SUM


def dense_group_bytes(plan, members, itemsize, form=B_SHARED):
    """The shared memory a block of K6's launch asks for: DENSE_WARPS
    partial rows of ``plan.width`` columns, each column ``members`` values
    side by side (one in the ONE_SUM form, and for one member a block)."""
    sums = 1 if form == ONE_SUM else members
    return DENSE_WARPS * plan.width * sums * itemsize


# Members a block of K6's group instance where the card timed fewer
# faster than 4 at case a (PERF.md), by (value type, index bytes, form):
# (members, from this batch size on).  op(B)'s values per member: 2
# (f32 kept 4); c64 with 32-bit ids, op(B)'s values shared: 2 past 8
# members (3% faster at 16 sets; 4 ahead or level at 4 and 8).
_K6_FEWER_MEMBERS = {
    **{(dtype, index_bytes, B_PER_MEMBER): (2, 2)
       for dtype in (torch.float64, torch.complex64, torch.complex128)
       for index_bytes in (4, 8)},
    (torch.complex64, 4, B_SHARED): (2, 9),
}


def dense_group(dtype, index_bytes, size, form):
    """Members a block of a batched K6 launch of ``size`` members: 4,
    fewer where ``_K6_FEWER_MEMBERS`` says so for the value type, index
    bytes, form and batch size, 2 for a batch of 2, 1 (the per-member
    instance) for a batch of 1; in the ONE_SUM form 4 for any batch of 2
    or more (a group keeps one sum, whatever its members)."""
    if size < 2:
        return 1
    if form == ONE_SUM:
        return 4
    fewer, from_size = _K6_FEWER_MEMBERS.get((dtype, index_bytes, form),
                                             (4, 0))
    most = fewer if size >= from_size else 4
    return min(most, 2 if size == 2 else 4)


def window_starts_pay(plan, m, n, k, a_nnz, itemsize, index_size):
    """Whether K6 first tabulates where each of op(B)'s k sorted rows
    enters each window (one search a row and window, in place of two an
    entry of op(A) and window): with windows, when op(A) has at least k
    entries and the table is no larger than the output."""
    return (plan.windows > 1 and k <= a_nnz
            and k * (plan.windows + 1) * index_size <= m * n * itemsize)


def csr_spgemm_dense(a_indptr, a_indices, a_data, b_indptr, b_indices,
                     b_data, n, alpha=None, beta=None, c0=None,
                     triangular=False, b_sorted=False):
    """K6: ``alpha * op(A) @ op(B) + beta * c0`` as a new row-major (m, n)
    tensor (only j >= i of the product with ``triangular``; ``c0`` is
    added everywhere); op(B)'s rows repeat no column (module docstring),
    as ``_xla.spgemm_numeric_sorted``'s sorted, unique flat indices.
    ``b_sorted=True`` is the caller's warrant that each row of op(B)
    lists its columns in ascending order without repeats, as a
    container's ``sorted_csr_arrays`` are (containers sum repeated
    entries when they are built); nothing is checked then.  With
    ``b_sorted=False`` the rows are sorted here first and a row that
    repeats a column raises ``ValueError``
    (``formats.sorted_unique_columns``: neighbours compared after the
    sort, one host read), on either device with the same message; the
    tracked path checks once per cached op(B) pattern
    (``CsrPattern.sorted_columns``).  The launch's plan is kept in
    ``csr_spgemm_dense.last_plan``, and whether it tabulated op(B)'s
    window starts (``window_starts_pay``) in ``last_table``.  No atomics;
    the same bits on every run.

    When autograd or a ``torch.func`` transform follows ``a_data``,
    ``b_data`` or ``c0`` (``csr.tracked``), the call goes through
    ``ops.autograd.CsrSpgemmDense`` on either device, so the result
    carries its gradient (K9 twice on the card, ``ops/spgemm_grad``);
    otherwise it is the kernel (the plain version on the CPU) alone."""
    if tracked(a_data, b_data, c0):
        from .autograd import CsrSpgemmDense, patterns

        return CsrSpgemmDense.apply(
            patterns.get(a_indptr, a_indices, b_indptr.numel() - 1), a_data,
            patterns.get(b_indptr, b_indices, n), b_data, alpha, beta, c0,
            triangular, b_sorted)
    return spgemm_dense(a_indptr, a_indices, a_data, b_indptr, b_indices,
                        b_data, n, alpha, beta, c0, triangular, b_sorted)


def spgemm_dense(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data,
                 n, alpha=None, beta=None, c0=None, triangular=False,
                 b_sorted=False):
    """``csr_spgemm_dense`` without autograd: K6 on the card, the plain
    version on the CPU; counted in ``csr_spgemm_dense.launches``."""
    refuse_views("csr_spgemm_dense", a_indptr, a_indices, a_data, b_indptr,
                 b_indices, b_data, c0)
    if a_data.device.type == "cpu":
        if not b_sorted:
            b_indices, b_data = sorted_unique_columns(b_indptr, b_indices,
                                                      b_data, n)
        return csr_spgemm_dense_plain(a_indptr, a_indices, a_data, b_indptr,
                                      b_indices, b_data, n, alpha, beta, c0,
                                      triangular)
    if not a_data.is_cuda:
        raise ValueError(f"csr_spgemm_dense: no kernel for device "
                         f"{a_data.device}")
    _check("csr_spgemm_dense", (a_indptr, a_indices, b_indptr, b_indices),
           (a_data, b_data), (c0,))
    m = a_indptr.numel() - 1
    if c0 is not None and tuple(c0.shape) != (m, n):
        raise ValueError(f"csr_spgemm_dense: c0 is {tuple(c0.shape)}, "
                         f"need {(m, n)}")
    c = torch.empty((m, n), dtype=a_data.dtype, device=a_data.device)
    launch = _k6_launcher(a_indptr, a_indices, a_data, b_indptr, n, alpha,
                          beta, c0 is not None, triangular)
    if not b_sorted:
        # Last before the launch: the check's host read then leaves the
        # card idle only while K6 is launched.
        b_indices, b_data = sorted_unique_columns(b_indptr, b_indices,
                                                  b_data, n)
    if m == 0 or n == 0:
        return c
    launch(b_indices, 1, (0, 0, 0, 0), a_data.data_ptr(), b_data.data_ptr(),
           None if c0 is None else c0.data_ptr(), c.data_ptr(), False)
    return c


def spgemm_dense_batched(a_indptr, a_indices, a_data, b_indptr, b_indices,
                         b_data, n, alpha=None, beta=None, c0=None,
                         triangular=False, b_sorted=False):
    """K6 for a batch of members that share op(A)'s and op(B)'s patterns:
    member i is ``alpha * A_i @ B_i + beta * c0_i`` (only j >= i of the
    product with ``triangular``), with ``a_data`` and ``b_data`` (B, nnz)
    or (nnz,) and ``c0`` (B, m, n), (m, n) or None, at least one with the
    member dimension, each member contiguous; an operand without it (or
    expanded along it) is shared, read in place by every member.  Returns
    a new (B, m, n) tensor.  op(B)'s rows are sorted and checked once for
    the batch (``b_sorted`` as in ``csr_spgemm_dense``), its members'
    values gathered as ``b_data[..., order]``.  One launch on the card
    (one per ``_build.MAX_MEMBERS`` members) on the shared plan and
    window-start table, ``dense_group`` members a block (``dense_form``
    says what they share); counted in ``csr_spgemm_dense.launches`` and ``launches_batched``
    (and ``launches_group``).  The batched plain version on the CPU."""
    refuse_views("csr_spgemm_dense", a_indptr, a_indices, a_data, b_indptr,
                 b_indices, b_data, c0)
    operands = ((a_data, 1), (b_data, 1), (c0, 2))
    size = batch_size("csr_spgemm_dense", operands)
    if a_data.device.type == "cpu":
        if not b_sorted:
            b_indices, b_data = _sorted_members(b_indptr, b_indices, b_data,
                                                n)
        return csr_spgemm_dense_batched_plain(
            a_indptr, a_indices, a_data, b_indptr, b_indices, b_data, n,
            alpha, beta, c0, triangular)
    if not a_data.is_cuda:
        raise ValueError(f"csr_spgemm_dense: no kernel for device "
                         f"{a_data.device}")
    check_members("csr_spgemm_dense",
                  (a_indptr, a_indices, b_indptr, b_indices), operands)
    m = a_indptr.numel() - 1
    if (a_data.shape[-1] != a_indices.numel()
            or b_data.shape[-1] != b_indices.numel()
            or (c0 is not None and tuple(c0.shape[-2:]) != (m, n))):
        raise ValueError(
            f"csr_spgemm_dense: values {tuple(a_data.shape)}, "
            f"{tuple(b_data.shape)} and c0 "
            f"{None if c0 is None else tuple(c0.shape)} do not fit "
            f"{a_indices.numel()} and {b_indices.numel()} entries and "
            f"{(m, n)}")
    c = torch.empty((size, m, n), dtype=a_data.dtype, device=a_data.device)
    form = dense_form(member_stride("csr_spgemm_dense", a_data, 1),
                      member_stride("csr_spgemm_dense", b_data, 1))
    launch = _k6_launcher(a_indptr, a_indices, a_data, b_indptr, n, alpha,
                          beta, c0 is not None, triangular)
    if not b_sorted:
        b_indices, b_data = _sorted_members(b_indptr, b_indices, b_data, n)
    if m == 0 or n == 0 or size == 0:
        return c
    strides = (member_stride("csr_spgemm_dense", a_data, 1),
               member_stride("csr_spgemm_dense", b_data, 1),
               member_stride("csr_spgemm_dense", c0, 2), m * n)
    for i, (first, count) in enumerate(member_chunks(size)):
        launch(b_indices, count, strides,
               *(member_ptr(t, st, first)
                 for t, st in zip((a_data, b_data, c0, c), strides)),
               i > 0, dense_group(a_data.dtype, a_indices.element_size(),
                                  count, form))
        csr_spgemm_dense.launches_batched += 1
    return c


def _sorted_members(b_indptr, b_indices, b_data, n):
    """op(B)'s rows sorted, each once for every member of ``b_data`` ((B,
    nnz) or (nnz,)): (indices, b_data[..., order]), values expanded along
    the members staying so; raises where a row repeats a column
    (``formats.sorted_unique_columns``)."""
    indices, order = sorted_unique_columns(
        b_indptr, b_indices,
        torch.arange(b_indices.numel(), device=b_indices.device), n)
    if b_data.dim() == 2 and b_data.shape[0] and b_data.stride(0) == 0:
        return indices, b_data[0, order].expand_as(b_data)
    return indices, b_data[..., order]


def _k6_launcher(a_indptr, a_indices, a_data, b_indptr, n, alpha, beta,
                 with_c0, triangular):
    """K6's launch for op(A) and op(B)'s patterns, planned here
    (``dense_plan``, and the window-start table's scratch where
    ``window_starts_pay``): ``launch(b_indices, members, strides, a,
    b, c0, c, starts_ready, group=1)`` launches for ``members`` members at
    ``strides`` (op(A)'s, op(B)'s values, c0, C) given the addresses,
    ``group`` of them a block (1: ``sdt_csr_spgemm_dense``, one member a
    block; 2 or 4: ``sdt_csr_spgemm_dense_group``); ``starts_ready``: an
    earlier launch of the call built the table.  Counted in
    ``csr_spgemm_dense.launches``, the group launches also in
    ``launches_group``."""
    m, k = a_indptr.numel() - 1, b_indptr.numel() - 1
    a_nnz, itemsize = a_indices.numel(), a_data.element_size()
    plan = starts = None
    if m and n:
        sms = torch.cuda.get_device_properties(
            a_data.device).multi_processor_count
        plan = dense_plan(m, n, itemsize, a_nnz, sms)
        if window_starts_pay(plan, m, n, k, a_nnz, itemsize,
                             b_indptr.element_size()):
            starts = torch.empty(k * (plan.windows + 1),
                                 dtype=b_indptr.dtype, device=a_data.device)
    dt, it = _build.type_codes(a_data, a_indptr)
    stream = _build.stream_of(a_data)

    def launch(b_indices, members, strides, a, b, c0, c, starts_ready,
               group=1):
        args = (dt, it, a_indptr.data_ptr(), a_indices.data_ptr(), a,
                b_indptr.data_ptr(), b_indices.data_ptr(), b, c0, c, m, n,
                *_build.scalar_parts(alpha),
                *_build.scalar_parts(beta if with_c0 else 0.0),
                int(triangular), plan.splits, plan.width, k,
                None if starts is None else starts.data_ptr(),
                int(starts_ready), members, *strides)
        if group == 1:
            _build.launch("sdt_csr_spgemm_dense", *args, stream)
        else:
            _build.launch("sdt_csr_spgemm_dense_group", *args, group, stream)
            csr_spgemm_dense.launches_group += 1
        csr_spgemm_dense.launches += 1
        csr_spgemm_dense.last_plan = plan
        csr_spgemm_dense.last_table = starts is not None

    return launch


csr_spgemm_dense.launches = 0
csr_spgemm_dense.launches_batched = 0
csr_spgemm_dense.launches_group = 0
csr_spgemm_dense.last_plan = None
csr_spgemm_dense.last_table = False
