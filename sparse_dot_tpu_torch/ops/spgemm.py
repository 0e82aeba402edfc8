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

1. ``spgemm_plan`` (plain torch on the device, no host sync): each row's
   bound ``ub[i] = sum of nnz(op(B)[k, :]) over op(A)[i, k]``, and a bin
   for each row by ``min(ub[i], n)`` from the table ``spgemm_bins``,
   which picks the row's accumulator: a hash table in shared memory for a
   warp or a block, a dense row of width n in shared memory, or a dense
   row in a bounded device workspace;
2. K4 writes each row's number of distinct columns;
3. ``indptr`` is their running sum; reading ``nnz = indptr[-1]`` to size
   the output is the one host sync (the JAX package pays the same one);
4. K5 writes each row's columns in ascending order with their values.

op(B) must not repeat a column within a row (containers hold canonical
CSR): the kernels let one thread own each column of a B row at a time.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..config import config
from ..formats import _check_index_bounds, expand_indptr
from . import _build
from .csr import _check
from .dense import axpby

# Kinds of row bins (the codes of csrc/csr_spgemm.cu's BinKind).
SKIP, HASH_WARP, HASH_BLOCK, DENSE_SHARED, DENSE_GLOBAL = range(5)
# Shared memory one thread block of K4/K5 may ask for.
SHARED_BUDGET = 200 * 1024
# Hash table sizes (slots): 8 tables per block, one per warp, then one per
# block up to the largest that SHARED_BUDGET holds.
WARP_SLOTS = (64, 256, 1024)
BLOCK_SLOTS = 4096
# A row of width n takes the dense accumulator once its hash table would
# need n / DENSE_RATIO slots or more.
DENSE_RATIO = 8
# Bytes of device memory for the dense rows of the DENSE_GLOBAL bin.
GLOBAL_WORKSPACE = 256 << 20


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
    of (kind, slots, u_max) rows.  A row with u = min(ub, n) goes to the
    first bin with u <= u_max: u == 0 to SKIP; a hash bin holds rows of up
    to slots / 2 distinct columns (load at most one half); the last bin
    (dense, in shared memory when a row of width n fits SHARED_BUDGET,
    else in the device workspace) takes the rest."""
    bins = [(SKIP, 0, 0)]
    dense_fits = dense_row_bytes(n, dtype) <= SHARED_BUDGET
    hash_slots = [(HASH_WARP, s) for s in WARP_SLOTS]
    hash_slots += [(HASH_BLOCK, s) for s in
                   (BLOCK_SLOTS, max_hash_slots(dtype, index_dtype))]
    for kind, slots in hash_slots:
        if dense_fits and n <= DENSE_RATIO * slots:
            break
        bins.append((kind, slots, slots // 2))
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
    gather of B's row lengths and a segment sum by ``a_indptr``."""
    b_len = (b_indptr[1:] - b_indptr[:-1]).long()
    prefix = torch.zeros(a_indices.numel() + 1, dtype=torch.long,
                         device=a_indices.device)
    torch.cumsum(b_len[a_indices.long()], 0, out=prefix[1:])
    ip = a_indptr.long()
    return prefix[ip[1:]] - prefix[ip[:-1]]


def spgemm_plan(a_indptr, a_indices, b_indptr, n, dtype, index_dtype):
    """The plan of K4/K5 (``SpgemmPlan``), built with device ops only: the
    bin thresholds are Python ints, so nothing waits for the device."""
    ub = row_bounds(a_indptr, a_indices, b_indptr)
    bins = spgemm_bins(dtype, index_dtype, n)
    u = torch.clamp(ub, max=n)
    bin_of = torch.zeros_like(u)
    for u_max in bins[:-1, 2]:
        bin_of += u > int(u_max)
    rows = torch.argsort(bin_of, stable=True)
    # Bin b's rows start where the sorted bins first reach b (searchsorted;
    # bincount would read the largest bin back to the host).
    offsets = torch.searchsorted(
        bin_of[rows], torch.arange(len(bins) + 1, device=u.device))
    return SpgemmPlan(ub, rows, offsets, bins)


# ---------------------------------------------------------------------------
# Plain versions: expand, sort, compress (ESC)
# ---------------------------------------------------------------------------


def _row_chunks(ub):
    """Row ranges [r0, r1) whose products stay within
    ``config.spmm_chunk_elements`` (a longer row is a chunk alone)."""
    budget = config.spmm_chunk_elements
    prefix = np.concatenate([[0], np.cumsum(ub.cpu().numpy())])
    m, r = len(prefix) - 1, 0
    while r < m:
        end = int(np.searchsorted(prefix, prefix[r] + budget, "right")) - 1
        end = min(max(end, r + 1), m)
        yield r, end
        r = end


def _expand(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data,
            a_rows, r0, r1, triangular):
    """(row, col, value) of every product a(i, k) * b(k, j) of rows
    [r0, r1), in op(A)'s stored order, then op(B)'s; ``a_data`` None skips
    the values."""
    p0, p1 = int(a_indptr[r0]), int(a_indptr[r1])
    k = a_indices[p0:p1].long()
    b_start = b_indptr[:-1].long()[k]
    count = b_indptr[1:].long()[k] - b_start
    total = int(count.sum())
    entry = torch.repeat_interleave(
        torch.arange(p1 - p0, device=k.device), count, output_size=total)
    first = torch.cumsum(count, 0) - count
    q = b_start[entry] + torch.arange(total, device=k.device) - first[entry]
    rows, cols = a_rows[p0:p1][entry], b_indices[q].long()
    vals = None if a_data is None else a_data[p0:p1][entry] * b_data[q]
    if triangular:
        keep = cols >= rows
        rows, cols = rows[keep], cols[keep]
        vals = None if vals is None else vals[keep]
    return rows, cols, vals


def spgemm_plain(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data,
                 n, triangular=False):
    """op(A) @ op(B) -> CSR (indptr, indices, data) in plain PyTorch: the
    products of each chunk of rows are keyed by row * n + col, sorted
    stably, and summed by ``unique_consecutive`` and ``index_add_``; so
    each entry's products add in op(A)'s stored order, as in K5.  Chunks
    hold at most ``config.spmm_chunk_elements`` products."""
    m = a_indptr.numel() - 1
    dev, itype = a_indptr.device, a_indptr.dtype
    a_rows = expand_indptr(a_indptr.long(), a_indices.numel())
    counts = torch.zeros(m, dtype=torch.long, device=dev)
    cols, vals = [], []
    for r0, r1 in _row_chunks(row_bounds(a_indptr, a_indices, b_indptr)):
        rows, col, val = _expand(a_indptr, a_indices, a_data, b_indptr,
                                 b_indices, b_data, a_rows, r0, r1,
                                 triangular)
        key, order = torch.sort(rows * n + col, stable=True)
        key, inverse = torch.unique_consecutive(key, return_inverse=True)
        vals.append(torch.zeros(key.numel(), dtype=a_data.dtype, device=dev)
                    .index_add_(0, inverse, val[order]))
        cols.append(key % n)
        counts[r0:r1] = torch.bincount(key // n - r0, minlength=r1 - r0)
    indptr = torch.zeros(m + 1, dtype=torch.long, device=dev)
    torch.cumsum(counts, 0, out=indptr[1:])
    _check_index_bounds(int(indptr[-1]), (m, n), itype)
    empty = torch.zeros(0, dtype=torch.long, device=dev)
    return (indptr.to(itype), torch.cat(cols or [empty]).to(itype),
            torch.cat(vals) if vals else a_data[:0].clone())


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


def csr_spgemm_dense_plain(a_indptr, a_indices, a_data, b_indptr, b_indices,
                           b_data, n, alpha=None, beta=None, c0=None,
                           triangular=False):
    """K6's plain version: ``alpha * op(A) @ op(B) + beta * c0`` as a
    dense (m, n) tensor, scattering the expanded products of each chunk
    of rows with ``index_add_`` (no densified operand)."""
    m = a_indptr.numel() - 1
    c = torch.zeros(m * n, dtype=a_data.dtype, device=a_data.device)
    a_rows = expand_indptr(a_indptr.long(), a_indices.numel())
    for r0, r1 in _row_chunks(row_bounds(a_indptr, a_indices, b_indptr)):
        rows, cols, vals = _expand(a_indptr, a_indices, a_data, b_indptr,
                                   b_indices, b_data, a_rows, r0, r1,
                                   triangular)
        c.index_add_(0, rows * n + cols, vals)
    return axpby(c.reshape(m, n), alpha, beta, c0)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


def _workspace(plan, per_group, device):
    """(workspace, groups): dense rows of ``per_group`` bytes for the
    DENSE_GLOBAL bin, as many as GLOBAL_WORKSPACE holds (at least one, at
    most two per SM)."""
    if plan.bins[-1, 0] != DENSE_GLOBAL:
        return None, 0
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    groups = max(1, min(2 * sms, GLOBAL_WORKSPACE // per_group))
    work = torch.empty(groups * per_group, dtype=torch.uint8, device=device)
    return work, groups


def _plan_args(plan, m, n):
    return (plan.rows.data_ptr(), plan.offsets.data_ptr(),
            plan.bins.ctypes.data, len(plan.bins), m, n)


def csr_spgemm_count(a_indptr, a_indices, b_indptr, b_indices, n, plan,
                     triangular=False):
    """K4: the number of distinct columns of each row of op(A) @ op(B)
    (j >= i only with ``triangular``), as an (m,) int64 tensor.  ``plan``
    is ``spgemm_plan``'s for the same operands."""
    if a_indptr.device.type == "cpu":
        return csr_spgemm_count_plain(a_indptr, a_indices, b_indptr,
                                      b_indices, n, triangular)
    if not a_indptr.is_cuda:
        raise ValueError(f"csr_spgemm_count: no kernel for device "
                         f"{a_indptr.device}")
    _check("csr_spgemm_count", (a_indptr, a_indices, b_indptr, b_indices),
           (plan.ub,))
    m = a_indptr.numel() - 1
    counts = torch.zeros(m, dtype=torch.long, device=a_indptr.device)
    if m == 0 or n == 0:
        return counts
    # K4's dense rows hold one flag byte per column.
    work, groups = _workspace(plan, _round16(n), a_indptr.device)
    _build.launch(
        "sdt_csr_spgemm_count", _build.ITYPE_CODES[a_indptr.dtype],
        a_indptr.data_ptr(), a_indices.data_ptr(), b_indptr.data_ptr(),
        b_indices.data_ptr(), *_plan_args(plan, m, n), int(triangular),
        counts.data_ptr(), None if work is None else work.data_ptr(),
        groups, _build.stream_of(a_indptr),
    )
    csr_spgemm_count.launches += 1
    return counts


csr_spgemm_count.launches = 0


def csr_spgemm_fill(a_indptr, a_indices, a_data, b_indptr, b_indices,
                    b_data, n, plan, c_indptr, nnz, triangular=False):
    """K5: (indices, data) of op(A) @ op(B) in the CSR layout of
    ``c_indptr`` (K4's counts summed, ``nnz`` entries), each row's columns
    ascending; values summed in op(A)'s stored order."""
    if a_data.device.type == "cpu":
        return csr_spgemm_fill_plain(a_indptr, a_indices, a_data, b_indptr,
                                     b_indices, b_data, n, triangular)
    if not a_data.is_cuda:
        raise ValueError(f"csr_spgemm_fill: no kernel for device "
                         f"{a_data.device}")
    _check("csr_spgemm_fill",
           (a_indptr, a_indices, b_indptr, b_indices, c_indptr),
           (a_data, b_data))
    m = a_indptr.numel() - 1
    indices = torch.empty(nnz, dtype=a_indptr.dtype, device=a_data.device)
    data = torch.empty(nnz, dtype=a_data.dtype, device=a_data.device)
    if nnz == 0:
        return indices, data
    dt, it = _build.type_codes(a_data, a_indptr)
    work, groups = _workspace(plan, dense_row_bytes(n, a_data.dtype),
                              a_data.device)
    _build.launch(
        "sdt_csr_spgemm_fill", dt, it, a_indptr.data_ptr(),
        a_indices.data_ptr(), a_data.data_ptr(), b_indptr.data_ptr(),
        b_indices.data_ptr(), b_data.data_ptr(), *_plan_args(plan, m, n),
        int(triangular), c_indptr.data_ptr(), indices.data_ptr(),
        data.data_ptr(), None if work is None else work.data_ptr(), groups,
        _build.stream_of(a_data),
    )
    csr_spgemm_fill.launches += 1
    return indices, data


csr_spgemm_fill.launches = 0


def csr_spgemm(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data, n,
               triangular=False):
    """op(A) @ op(B) -> CSR (indptr, indices, data) with op(A)'s index
    dtype: K4, the running sum, the nnz read, K5 on the card; the plain
    ESC on the CPU.  Raises (with the ILP64 hint) when int32 indices
    cannot hold the output's nnz."""
    if a_data.device.type == "cpu":
        return spgemm_plain(a_indptr, a_indices, a_data, b_indptr,
                            b_indices, b_data, n, triangular)
    m = a_indptr.numel() - 1
    plan = spgemm_plan(a_indptr, a_indices, b_indptr, n, a_data.dtype,
                       a_indptr.dtype)
    counts = csr_spgemm_count(a_indptr, a_indices, b_indptr, b_indices, n,
                              plan, triangular)
    indptr = torch.zeros(m + 1, dtype=torch.long, device=a_data.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    nnz = int(indptr[-1])  # the one host sync: the output's size
    _check_index_bounds(nnz, (m, n), a_indptr.dtype)
    indptr = indptr.to(a_indptr.dtype)
    indices, data = csr_spgemm_fill(a_indptr, a_indices, a_data, b_indptr,
                                    b_indices, b_data, n, plan, indptr, nnz,
                                    triangular)
    return indptr, indices, data


def csr_spgemm_dense(a_indptr, a_indices, a_data, b_indptr, b_indices,
                     b_data, n, alpha=None, beta=None, c0=None,
                     triangular=False):
    """K6: ``alpha * op(A) @ op(B) + beta * c0`` as a new row-major (m, n)
    tensor (only j >= i of the product with ``triangular``; ``c0`` is
    added everywhere).  One thread block per output row, no atomics."""
    if a_data.device.type == "cpu":
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
    if m == 0 or n == 0:
        return c
    dt, it = _build.type_codes(a_data, a_indptr)
    _build.launch(
        "sdt_csr_spgemm_dense", dt, it, a_indptr.data_ptr(),
        a_indices.data_ptr(), a_data.data_ptr(), b_indptr.data_ptr(),
        b_indices.data_ptr(), b_data.data_ptr(),
        None if c0 is None else c0.data_ptr(), c.data_ptr(), m, n,
        *_build.scalar_parts(alpha),
        *_build.scalar_parts(0.0 if c0 is None else beta),
        int(triangular), _build.stream_of(a_data),
    )
    csr_spgemm_dense.launches += 1
    return c


csr_spgemm_dense.launches = 0
