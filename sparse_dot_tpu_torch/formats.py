"""Sparse matrix containers (CSR / CSC / BSR) on torch tensors.

Port of ``sparse_dot_tpu/formats.py``.  A container holds ``data``,
``indices`` and ``indptr`` tensors on ``config.device`` plus the shape;
complex values are stored natively (torch's complex tensors are
interleaved, as the CUDA kernels read them).

Validation follows the JAX package and the reference's
``_create_mkl_sparse``: float32/float64/complex64/complex128 data only,
BSR blocks square and dividing the matrix dims, and index widths following
the LP64/ILP64 policy with an overflow error carrying the ILP64 hint.
The caller's arrays are never modified: a non-canonical CSR/CSC has its
duplicates summed (and sorted) on a copy, and a BSR with repeated blocks
has them summed on a copy, so every container holds each entry (or block)
once, as the sparse x sparse kernels need of op(B); a BSR without repeats
keeps the caller's block order, as the JAX package's does.

The kernels read CSR (K2, K3) or BSR (K1) in the orientation of the
product.  ``csr_arrays(transpose)`` and ``BSR.bsr_arrays(transpose)``
give those arrays, building the converted layout once on the device (a
stable sort of the other axis' ids) and caching it on the container as
structure and permutation, the values gathered anew on every call, so
they follow ``data`` (one rule for every cached layout), as
``BSR.bsr_plan(transpose)`` caches K1's chunk plan (``bsr_chunk_plan``)
and ``csr_plan(transpose, spmv)`` K2's and K3's row plans (``csr_plan``).
``csr_sorted(transpose)`` tells whether each row of ``csr_arrays(
transpose)`` lists its columns in ascending order, as K6 needs before it
searches them: from scipy's ``has_sorted_indices`` when the container is
built from scipy, true by construction for the converted layouts, else
computed once on the device; ``sorted_csr_arrays(transpose)`` gives those
arrays sorted, sorting them once (the order cached) where they are not.
The one cache of values is ``dense_planes(transpose, dtype)``: the dense
op(A), its bf16 structural indicator and the finite flag of its values for
the densify routes, kept within ``config.spgemm_plane_cache_bytes`` and
keyed on ``data``'s identity and ``_version``, so an in-place change of
``data`` is seen.  ``CsrPattern`` and ``BsrPattern`` hold a structure without values, with
its plans and transpose cached the same way, for the device API's
gradients (``ops/autograd``); ``coo_structure`` reads COO ids by the
JAX package's rules.
"""

import contextlib
from typing import NamedTuple

import numpy as np
import scipy.sparse as _sps
import torch

from .backend import torch_device
from .config import config, ILP64_HINT

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}
_NUMPY_DTYPES = {v: k for k, v in _TORCH_DTYPES.items()}


def torch_dtype(dtype):
    """torch dtype of a valid numpy value dtype."""
    return _TORCH_DTYPES[np.dtype(dtype)]


def _validate_dtype(dtype):
    if np.dtype(dtype) not in _TORCH_DTYPES:
        raise ValueError(
            "Matrix data type must be float32, float64, complex64, or "
            f"complex128; {np.dtype(dtype)} provided"
        )


def _check_index_bounds(nnz, shape, index_dtype=None):
    """Raise (with the ILP64 hint) when indices of ``index_dtype`` (a
    numpy or torch dtype; default the interface's) cannot hold a matrix
    of ``shape`` with ``nnz`` entries: an input, or a product's output."""
    if index_dtype is None:
        index_dtype = config.index_dtype
    if isinstance(index_dtype, torch.dtype):
        info = torch.iinfo(index_dtype)
        name = str(index_dtype).removeprefix("torch.")
    else:
        info, name = np.iinfo(index_dtype), np.dtype(index_dtype)
    if nnz > info.max or max(shape, default=0) > info.max:
        raise ValueError(
            f"Index interface is {name} and cannot hold a matrix with "
            f"shape {tuple(shape)} / nnz {nnz}; {ILP64_HINT}"
        )


def _host_to_device(arr, device):
    """numpy array -> tensor on ``device``, always a copy (the caller's
    buffer is never shared).  Row-major result."""
    arr = np.asarray(arr)
    if not (arr.flags.c_contiguous or arr.flags.f_contiguous):
        arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    t = torch.from_numpy(arr)
    if device.type == "cpu":
        return t.clone(memory_format=torch.contiguous_format)
    return t.to(device).contiguous()


def _indices_to_device(arr, device):
    return _host_to_device(np.asarray(arr, dtype=config.index_dtype), device)


def _values_to_device(arr, device):
    _validate_dtype(arr.dtype)
    return _host_to_device(arr, device)


def expand_indptr(indptr, count):
    """indptr -> one segment id per entry (empty segments included)."""
    nseg = indptr.numel() - 1
    ids = torch.arange(nseg, dtype=indptr.dtype, device=indptr.device)
    return torch.repeat_interleave(
        ids, (indptr[1:] - indptr[:-1]).long(), output_size=count
    )


class BsrChunkPlan(NamedTuple):
    """How K1's tensor-core variant cuts a BSR's block rows into work.

    ``items`` (n_items, 4) int64 rows of (block row, first stored block,
    end stored block, workspace slot or -1): one per chunk of at most
    ``chunk`` stored blocks, one for each empty block row; block rows of
    one chunk write C directly (slot -1).  ``splits`` (n_splits, 3) int64
    rows of (block row, first slot, number of chunks) for the block rows
    of more than one chunk, whose chunks take consecutive slots.  Both are
    padded with rows whose block row is -1 to sizes known on the host, so
    building a plan never waits for the device; ``slots`` bounds the
    workspace slots used."""

    items: torch.Tensor
    splits: torch.Tensor
    chunk: int
    slots: int
    nbrows: int
    nblocks: int


def bsr_chunk_length(nbrows, nblocks):
    """S: the mean number of stored blocks per block row, rounded up."""
    return max(1, -(-nblocks // max(nbrows, 1)))


def _padding_row(values, dev):
    """An int64 row of ``values`` on ``dev``, filled there: a tensor made
    from a host list, or an item set from a Python number, is a copy that
    waits for the device."""
    row = torch.empty(len(values), dtype=torch.long, device=dev)
    for i, v in enumerate(values):
        row.narrow(0, i, 1).fill_(v)
    return row


def bsr_chunk_plan(indptr, nblocks, chunk=None):
    """The chunk plan of the block ``indptr`` of a BSR with ``nblocks``
    stored blocks (device ops, no host sync).  Any CSR ``indptr`` with its
    nnz works the same way (``csr_plan``).

    The chunk length S is ``chunk``, by default the mean number of stored
    blocks per block row, rounded up, so a block row longer than the mean
    is spread over several thread blocks.  With L_r blocks in row r, row r
    has max(1, ceil(L_r / S)) chunks; there are at most
    nbrows + nblocks // S of them, at most nblocks // (S + 1) rows of more
    than one, and those rows take at most nblocks // S + nblocks // (S + 1)
    slots."""
    nbrows = indptr.numel() - 1
    dev = indptr.device
    S = chunk or bsr_chunk_length(nbrows, nblocks)
    if nbrows == 0:
        empty = torch.zeros((0, 4), dtype=torch.long, device=dev)
        return BsrChunkPlan(empty, empty[:, :3], S, 0, 0, nblocks)
    n_splits = nblocks // (S + 1)
    ip = indptr.long()
    nchunks = torch.clamp((ip[1:] - ip[:-1] + S - 1) // S, min=1)
    split = nchunks > 1
    cum = torch.cumsum(nchunks, 0)
    slot_count = torch.where(split, nchunks, 0)
    first_slot = torch.cumsum(slot_count, 0) - slot_count

    # Item t is chunk j of the row r whose chunks cover t.
    t = torch.arange(nbrows + nblocks // S, device=dev)
    row = torch.searchsorted(cum, t, right=True)
    r = row.clamp(max=nbrows - 1)
    j = t - (cum[r] - nchunks[r])
    p0 = ip[r] + j * S
    items = torch.stack([
        r, p0, torch.minimum(p0 + S, ip[r + 1]),
        torch.where(split[r], first_slot[r] + j, -1),
    ], 1)
    items = torch.where((row < nbrows)[:, None], items,
                        _padding_row((-1, 0, 0, -1), dev))

    # Split row k is the row where the running count of split rows
    # passes k.
    k = torch.arange(n_splits, device=dev)
    srow = torch.searchsorted(torch.cumsum(split.long(), 0), k, right=True)
    s = srow.clamp(max=nbrows - 1)
    splits = torch.stack([s, first_slot[s], nchunks[s]], 1)
    splits = torch.where((srow < nbrows)[:, None], splits,
                         _padding_row((-1, 0, 0), dev))
    return BsrChunkPlan(items, splits, S, nblocks // S + n_splits, nbrows,
                        nblocks)


# Nonzeros per tile of K3 (``SPMV_TILE`` equals ``kTile`` of
# ``csrc/csr_spmv.cu``, which checks it): a tile holds the rows whose first
# nonzero lies in [t * T, (t + 1) * T), and rows longer than T are split.
SPMV_TILE = 128


class CsrPlan(NamedTuple):
    """How K2 or K3 cuts a CSR's rows into work (``csr_plan``).

    Rows of at most ``chunk`` nonzeros are done whole.  Longer rows are
    cut into chunks of ``chunk`` (``bsr_chunk_plan`` on the CSR's indptr):
    ``chunks`` (slots, 4) int64 rows of (row, first nonzero, end nonzero,
    workspace slot), the split rows' chunks in row and slot order, then
    padding rows (-1, 0, 0, -1).  ``counts``: (slots,) int32 zeros, where
    the kernel counts the finished chunks of a split row (at its first
    slot), so that the last to finish adds the partial results in chunk
    order, and sets the count back to 0: a run gives the same bits twice.
    ``tiles`` (K3 only, else empty): (n_tiles, 4) int64 rows of (first
    row, end row, first nonzero, end nonzero) of each tile of
    ``SPMV_TILE`` nonzeros, a long last row (more than ``SPMV_TILE``
    nonzeros, done by its chunks) left out.  Sizes are known on the host,
    so building a plan never waits for the device."""

    chunks: torch.Tensor
    tiles: torch.Tensor
    counts: torch.Tensor
    chunk: int
    nrows: int
    nnz: int

    @property
    def slots(self):
        return self.chunks.shape[0]


def spmm_chunk_length(nrows, nnz):
    """K2's S: four times the mean row length, and at least 128 nonzeros
    and 1/8192 of the nnz, so only rows far past the mean are split and
    the padded chunk list stays short."""
    mean = -(-nnz // max(nrows, 1))
    return max(4 * mean, 128, -(-nnz // 8192))


def csr_plan(indptr, nnz, spmv=False):
    """The ``CsrPlan`` of a CSR's ``indptr`` with ``nnz`` entries, for K3
    when ``spmv`` (tiles and chunks of ``SPMV_TILE``) or else for K2
    (chunks of ``spmm_chunk_length``).  Device ops, no host sync."""
    nrows = indptr.numel() - 1
    dev = indptr.device
    S = SPMV_TILE if spmv else spmm_chunk_length(nrows, nnz)
    plan = bsr_chunk_plan(indptr, nnz, S)
    # Slot u is chunk j of the split row k whose slots cover u (the split
    # rows' first slots rise; padding rows' are moved past every slot).
    ip = indptr.long()
    if plan.splits.shape[0] == 0:  # no row can be longer than S
        plan = plan._replace(splits=_padding_row((-1, 0, 0), dev)[None])
    rows, firsts, nchunks = plan.splits.unbind(1)
    firsts = torch.where(rows >= 0, firsts, plan.slots)
    u = torch.arange(plan.slots, device=dev)
    k = (torch.searchsorted(firsts, u, right=True) - 1).clamp(min=0)
    r = rows[k].clamp(min=0)
    j = u - firsts[k]
    p0 = ip[r] + j * S
    chunks = torch.stack([r, p0, torch.minimum(p0 + S, ip[r + 1]), u], 1)
    chunks = torch.where(((u >= firsts[k]) & (j < nchunks[k]))[:, None],
                         chunks, _padding_row((-1, 0, 0, -1), dev))
    tiles = torch.zeros((0, 4), dtype=torch.long, device=dev)
    if spmv:
        n_tiles = nnz // S + 1
        # Tile t: the rows whose first nonzero lies in [t S, (t + 1) S);
        # the last bound, past every row's start, is nrows.
        bounds = torch.searchsorted(
            ip[:-1], torch.arange(n_tiles + 1, device=dev) * S)
        first, end = bounds[:-1], bounds[1:]
        # A row longer than S can only be its tile's last row.
        last = (end - 1).clamp(min=0)
        long_last = (end > first) & (ip[end] - ip[last] > S)
        end = end - long_last.long()
        tiles = torch.stack([first, end, ip[first], ip[end]], 1)
    counts = torch.zeros(plan.slots, dtype=torch.int32, device=dev)
    return CsrPlan(chunks, tiles, counts, S, nrows, nnz)


def _indptr_of_rows(rows, nrows):
    indptr = torch.zeros(nrows + 1, dtype=rows.dtype, device=rows.device)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=nrows), 0)
    return indptr


def rows_ascend(indptr, indices):
    """Whether the indices of each compressed row ascend (ties allowed),
    as scipy's ``has_sorted_indices`` tells: device ops and one host
    read."""
    nnz = indices.numel()
    if nnz < 2:
        return True
    ascends = indices[1:] >= indices[:-1]
    # A step from one row's last entry to the next row's first counts as
    # ascending.
    starts = indptr[1:-1].long()
    ascends[starts[(starts > 0) & (starts < nnz)] - 1] = True
    return bool(ascends.all())


class CsrPattern:
    """The structure of a CSR matrix, without its values: ``indptr``,
    ``indices`` and the number of columns ``ncols``, with what the kernels
    need of it built once on the device and cached.  ``plan(spmv)`` is K2's
    (K3's) row plan (``csr_plan``); ``transpose()`` the pattern of the
    transpose and the permutation that carries values to it.  It holds no
    values, so what it caches stays right while the values change, as
    they do at every step of a training loop: values reach the transpose
    as ``data[order]``, gathered anew by each caller.  ``plans`` is the
    plan cache ({spmv: CsrPlan}), which a caller may seed with a plan
    already built for these arrays.  What it builds, it builds outside
    any ``torch.func`` transform that is active (``structure_only``), so a
    pattern first used inside ``torch.func.grad`` or ``vmap`` caches plain
    tensors.  ``span`` is ``column_span``'s answer where the caller knows
    bounds on the column ids without reading them (a product's output:
    (0, ncols))."""

    def __init__(self, indptr, indices, ncols, span=None):
        self.indptr = indptr
        self.indices = indices
        self.ncols = int(ncols)
        self.plans = {}
        self._transpose = None
        self._sorted = None
        self._span = span

    @property
    def shape(self):
        return (self.indptr.numel() - 1, self.ncols)

    @property
    def nnz(self):
        return self.indices.numel()

    def plan(self, spmv=False):
        """K2's ``CsrPlan`` of these arrays (K3's with ``spmv``), built on
        the device once (no host sync) and cached."""
        spmv = bool(spmv)
        if spmv not in self.plans:
            with structure_only():
                self.plans[spmv] = csr_plan(self.indptr, self.nnz, spmv)
        return self.plans[spmv]

    def transpose(self):
        """(pattern of the transpose, order): entry q of the transpose's
        CSR is entry ``order[q]`` of this one, its rows listed in
        ascending order (one stable sort of the column ids, once)."""
        if self._transpose is None:
            with structure_only():
                self._transpose = self._build_transpose()
        return self._transpose

    def sorted_columns(self):
        """(indices, order): each row's column ids in ascending order and
        the permutation that carries values to them (``data[order]``).
        Raises ``ValueError`` (``sorted_unique_columns``) when a row
        repeats a column.  One stable sort
        and one host read, once: a pattern that passed is not checked
        again."""
        if self._sorted is None:
            with structure_only():
                self._sorted = sorted_unique_columns(
                    self.indptr, self.indices,
                    torch.arange(self.nnz, device=self.indices.device),
                    self.ncols)
        return self._sorted

    def column_span(self):
        """(least, one past the greatest) column id, (0, 0) with no entry:
        one host read, once."""
        if self._span is None:
            if self.nnz == 0:
                self._span = (0, 0)
            else:
                with structure_only():
                    lo, hi = torch.stack((self.indices.min(),
                                          self.indices.max())).tolist()
                self._span = (int(lo), int(hi) + 1)
        return self._span

    def _build_transpose(self):
        order = torch.argsort(self.indices, stable=True)
        rows = expand_indptr(self.indptr, self.nnz)
        return (CsrPattern(_indptr_of_rows(self.indices, self.ncols),
                           rows[order], self.shape[0]), order)


def coo_structure(rows, cols, m, k):
    """(order, indptr, indices): the CSR structure of expanded COO ids
    read by NumPy's rules, as the JAX package's gathers and
    ``mode="drop"`` scatters read them.  A row id in [-m, 0) is m + id, a
    column id in [-k, 0) is k + id; entries whose row is then outside
    [0, m) are dropped, the rest stably sorted by row (entry q of the CSR
    is entry ``order[q]`` of the COO).  Raises on a kept entry whose
    column lies outside [-k, k), which JAX would clamp to the edge.  One
    host read."""
    rows = torch.where(rows < 0, rows + m, rows)
    cols = torch.where(cols < 0, cols + k, cols)
    keep = (rows >= 0) & (rows < m)
    kept_cols = cols[keep]
    kept, bad = torch.stack([
        keep.sum(), ((kept_cols < 0) | (kept_cols >= k)).sum()]).tolist()
    if bad:
        raise ValueError(f"coo: {bad} column ids outside [-{k}, {k})")
    order = torch.argsort(torch.where(keep, rows, m), stable=True)[:kept]
    return (order, _indptr_of_rows(rows[order], m),
            cols[order].to(rows.dtype))


class BsrPattern:
    """The structure of a BSR matrix of square ``bs`` x ``bs`` blocks,
    without its values: block ``indptr``, block-column ``indices`` and the
    number of block columns ``nbcols``, with what K1 needs of it built
    once on the device and cached, as ``CsrPattern`` does for CSR:
    ``plan()`` is K1's chunk plan (``bsr_chunk_plan``), ``transpose()``
    the pattern of the transpose (block coordinates swapped, blocks sorted
    by block row) and the permutation that carries blocks to it, so that
    A^H's blocks are ``data[order].transpose(1, 2).conj_physical()``,
    gathered anew by each caller.  ``from_coo`` builds it from block COO
    and keeps ``order``: stored block q is the caller's block ``order[q]``
    (None for a pattern of BSR arrays)."""

    def __init__(self, indptr, indices, nbcols, bs, order=None):
        self.indptr = indptr
        self.indices = indices
        self.nbcols = int(nbcols)
        self.bs = int(bs)
        self.order = order
        self._plan = None
        self._transpose = None

    @classmethod
    def from_coo(cls, block_rows, block_cols, m, k, bs):
        """The pattern of the blocks at (``block_rows``, ``block_cols``)
        of an m x k matrix: ids by ``coo_structure``'s rules (block rows
        outside [-m / bs, m / bs) dropped), the kept blocks stably sorted
        by block row, repeated blocks kept apart."""
        with structure_only():
            order, indptr, indices = coo_structure(block_rows, block_cols,
                                                   m // bs, k // bs)
        return cls(indptr, indices, k // bs, bs, order)

    @property
    def shape(self):
        return ((self.indptr.numel() - 1) * self.bs, self.nbcols * self.bs)

    @property
    def nblocks(self):
        return self.indices.numel()

    def plan(self, given=None):
        """K1's ``BsrChunkPlan`` of these arrays, built on the device once
        (no host sync) and cached; ``given``, a plan already built for
        these arrays, is cached when none is."""
        if self._plan is None:
            with structure_only():
                self._plan = (bsr_chunk_plan(self.indptr, self.nblocks)
                              if given is None else given)
        return self._plan

    def transpose(self):
        """(pattern of the transpose, order): stored block q of the
        transpose is block ``order[q]`` of this one, transposed (one stable
        sort of the block-column ids, once)."""
        if self._transpose is None:
            with structure_only():
                indptr, indices, order = coo_to_csr(
                    self.indices, expand_indptr(self.indptr, self.nblocks),
                    torch.arange(self.nblocks, device=self.indices.device),
                    self.nbcols)
            self._transpose = (BsrPattern(indptr, indices,
                                          self.indptr.numel() - 1, self.bs),
                               order)
        return self._transpose


def structure_only():
    """A block whose tensors no autograd or ``torch.func`` transform
    follows: index structure built there is plain, whatever transform
    the caller runs under."""
    stack = contextlib.ExitStack()
    stack.enter_context(torch.no_grad())
    stack.enter_context(torch._C._DisableFuncTorch())
    return stack


def coo_to_csr(rows, cols, vals, nrows):
    """Expanded COO -> (indptr, indices, vals) of CSR with ``nrows`` rows.

    A stable sort by row keeps the entries of each row in their input
    order, so COO that is sorted by column within equal rows stays so."""
    order = torch.argsort(rows, stable=True)
    return _indptr_of_rows(rows, nrows), cols[order], vals[order]


def sort_csr_indices(rows, cols, vals, ncols):
    """Entries of expanded COO in (row, col) order: one stable sort of the
    key ``row * ncols + col``.  Returns (cols, vals) in that order.  Plain
    torch: the counterpart of ``_xla.sort_csr_indices``; its calls are
    counted in ``sort_csr_indices.calls``."""
    order = torch.argsort(rows.long() * ncols + cols.long(), stable=True)
    sort_csr_indices.calls += 1
    return cols[order], vals[order]


sort_csr_indices.calls = 0


def sorted_unique_columns(indptr, indices, vals, ncols):
    """(cols, vals) of op(B)'s CSR (``indptr``, ``indices``, ``vals``) for
    K6 (``ops/spgemm.csr_spgemm_dense``), each row's columns in ascending
    order (``sort_csr_indices``); raises ``ValueError`` when a row holds a
    column twice, found by comparing neighbours within each row after the
    sort (one host read)."""
    nnz = indices.numel()
    rows = expand_indptr(indptr, nnz)
    cols, vals = sort_csr_indices(rows, indices, vals, ncols)
    repeat = (cols[1:] == cols[:-1]) & (rows[1:] == rows[:-1])
    if nnz > 1 and bool(repeat.any()):
        first = int(repeat.nonzero()[0])
        raise ValueError(
            f"csr_spgemm_dense: row {int(rows[first])} of op(B) repeats "
            f"column {int(cols[first])}; op(B) must hold each column at "
            "most once a row (sum repeated entries first, as the "
            "containers do)")
    return cols, vals


def coo_to_sorted_csr(rows, cols, vals, shape):
    """Expanded COO -> (indptr, indices, vals) of CSR of ``shape`` with the
    columns of each row sorted (``coo_to_csr`` then ``sort_csr_indices``):
    the counterpart of ``_xla.coo_to_csr_arrays``."""
    cols, vals = sort_csr_indices(rows, cols, vals, shape[1])
    return _indptr_of_rows(rows, shape[0]), cols, vals


class Planes(NamedTuple):
    """What the densify routes read of op(A) (``dense_planes``): its dense
    values, its bf16 structural indicator (None when not asked for), and
    whether its values are finite (a Python bool once read on the host, a
    0-d bool tensor on the device before)."""

    dense: torch.Tensor
    indicator: object
    finite: object


class _StoredPlanes:
    """A container's planes of the stored rows, for the values ``data``
    held at ``version`` cast to ``dtype``."""

    def __init__(self, data, dtype):
        self.data, self.version, self.dtype = data, data._version, dtype
        self.dense = self.indicator = self.finite = None

    def holds(self, data, dtype):
        return (self.data is data and self.version == data._version
                and self.dtype == dtype)

    def nbytes(self):
        return sum(t.numel() * t.element_size()
                   for t in (self.dense, self.indicator) if t is not None)


class SparseDeviceMatrix:
    """Base class of the containers.

    Attributes
    ----------
    data : torch.Tensor
        Values: (nnz,) for CSR/CSC, (nblocks, R, C) for BSR.
    indices, indptr : torch.Tensor
        Compressed-sparse index arrays in the active index dtype.
    shape : tuple of int
    sorted_indices : bool or None
        Whether the indices of each compressed row (block row for BSR)
        ascend; None when not known, then ``csr_sorted`` finds out.
    """

    format = None  # "csr" | "csc" | "bsr"

    def __init__(self, data, indices, indptr, shape, sorted_indices=None):
        self.data = data
        self.indices = indices
        self.indptr = indptr
        self.shape = tuple(int(s) for s in shape)
        self.sorted_indices = sorted_indices

    @property
    def dtype(self):
        """numpy dtype of the values (what the dtype policy reads)."""
        return _NUMPY_DTYPES[self.data.dtype]

    @property
    def device(self):
        return self.data.device

    @property
    def ndim(self):
        return 2

    @property
    def nnz(self):
        return int(self.data.shape[0])

    @property
    def iscomplex(self):
        return self.data.is_complex()

    def _with(self, data, indices=None, indptr=None, sorted_indices=None):
        """Same structure (and class) with other tensors; caches dropped.
        The order of the indices carries over when they do, else it is
        ``sorted_indices``."""
        out = type(self).__new__(type(self))
        SparseDeviceMatrix.__init__(
            out, data,
            self.indices if indices is None else indices,
            self.indptr if indptr is None else indptr,
            self.shape,
            self.sorted_indices if indices is None else sorted_indices,
        )
        if isinstance(self, BSR):
            out.blocksize = self.blocksize
        return out

    def astype(self, dtype):
        """Container with values cast to ``dtype``; the SAME object when
        the dtype already matches (the identity the cast policy relies
        on)."""
        dtype = np.dtype(dtype)
        if dtype == self.dtype:
            return self
        _validate_dtype(dtype)
        if self.iscomplex and dtype.kind != "c":
            raise ValueError(
                f"cannot cast complex container to real dtype {dtype}"
            )
        return self._with(self.data.to(torch_dtype(dtype)))

    def to(self, device):
        """Container with every tensor on ``device``."""
        device = torch.device(device)
        return self._with(
            self.data.to(device), self.indices.to(device),
            self.indptr.to(device), self.sorted_indices,
        )

    def to_dense(self):
        """The matrix as a dense tensor on its device (``dense()``)."""
        return self.dense()

    def dense(self, transpose=False, dtype=None):
        """op(A) as a dense tensor on its device, its values cast to
        ``dtype`` when given: K12 (``ops.densify.csr_densify``, the
        counterpart of ``_xla.densify`` / ``densify_sorted``) on the stored
        arrays, which a CSR holds as its own rows and a CSC as the rows of
        its transpose (a BSR on its element CSR).  Where the stored rows
        are op(A)ᵀ's, the result is the transposed view of their dense
        (column-major), so no transposed layout is ever sorted."""
        from .ops.densify import csr_densify

        indptr, indices, data, shape = self._stored_csr()
        if dtype is not None:
            data = data.to(dtype)
        return self._op_view(csr_densify(indptr, indices, data, shape),
                             transpose)

    def _stored_csr(self):
        """(indptr, indices, data, shape) of the CSR that the container
        stores: its own arrays (a CSC's are the rows of its transpose), a
        BSR's element CSR."""
        if isinstance(self, BSR):
            return (*self.csr_arrays(), self.shape)
        shape = self.shape[::-1] if self._own_csr_transpose else self.shape
        return self.indptr, self.indices, self.data, shape

    def _op_view(self, stored, transpose):
        """op(A) of a dense tensor of the stored rows (``_stored_csr``)."""
        if stored is None:
            return None
        return stored.mT if self._own_csr_transpose != bool(transpose) \
            else stored

    def dense_planes(self, transpose=False, dtype=None, indicator=True):
        """``Planes`` of op(A) for the densify routes of ``ops/host``: its
        dense values cast to ``dtype`` (``dense``), with ``indicator`` its
        bf16 structural indicator (K12's indicator template,
        ``ops.densify.csr_indicator``: 1.0 at every stored entry, explicit
        zeros included), and the finite flag of its values.

        The port of the JAX package's ``formats.dense_planes``: while
        ``config.spgemm_plane_cache`` is on, the planes are kept on the
        container, within ``config.spgemm_plane_cache_bytes``, and a later
        call with the same values returns them without a launch (the
        indicator is added to them when first asked for).  Values are
        matched by ``data``'s identity and its ``_version``, so an in-place
        change of ``data`` (or a new ``data``) builds them anew; tracked
        values are never kept.  The planes are kept from the first use on:
        the route densifies then anyway, and the scipy path's containers
        live for one call, so they take their planes with them.  The flag is
        a 0-d bool tensor on the device until a caller reads it and
        records it (``note_finite``); then a Python bool, and the route
        skips that read."""
        from .config import config
        from .ops.csr import tracked
        from .ops.densify import csr_densify, csr_indicator

        dtype = self.data.dtype if dtype is None else dtype
        use_cache = config.spgemm_plane_cache and not tracked(self.data)
        planes = self.__dict__.get("_planes") if use_cache else None
        if planes is None or not planes.holds(self.data, dtype):
            planes = _StoredPlanes(self.data, dtype)
        indptr, indices, data, shape = self._stored_csr()
        if planes.dense is None:
            values = data.to(dtype)
            planes.dense = csr_densify(indptr, indices, values, shape)
            planes.finite = torch.isfinite(values.sum())
        if indicator and planes.indicator is None:
            planes.indicator = csr_indicator(indptr, indices, shape)
        if use_cache:
            if planes.nbytes() <= config.spgemm_plane_cache_bytes:
                self._planes = planes
            else:
                self.__dict__.pop("_planes", None)
        return Planes(self._op_view(planes.dense, transpose),
                      self._op_view(planes.indicator, transpose),
                      planes.finite)

    def note_finite(self, dtype, finite):
        """Record the host's reading of the finite flag of the values cast
        to ``dtype`` in the kept planes, when they still hold these
        values."""
        planes = self.__dict__.get("_planes")
        if planes is not None and planes.holds(self.data, dtype):
            planes.finite = bool(finite)

    def csr_plan(self, transpose=False, spmv=False):
        """K2's ``CsrPlan`` (K3's with ``spmv``) of
        ``csr_arrays(transpose)``, built once on the device and cached."""
        def build():
            indptr, indices, _ = self.csr_arrays(transpose)
            return csr_plan(indptr, indices.numel(), spmv)

        return self._cached(("csr_plan", bool(transpose), bool(spmv)), build)

    def csr_sorted(self, transpose=False):
        """Whether each row of ``csr_arrays(transpose)`` lists its columns
        in ascending order.  The layouts that ``csr_arrays`` converts are
        (a stable sort by the other axis of entries stored in order); the
        container's own arrays are when ``sorted_indices`` says so, which
        is found out once (one host read) where it was not known."""
        if bool(transpose) != self._own_csr_transpose:
            return True
        if self.sorted_indices is None:
            self.sorted_indices = rows_ascend(self.indptr, self.indices)
        return self.sorted_indices

    def sorted_csr_arrays(self, transpose=False):
        """``csr_arrays(transpose)`` with each row's columns in ascending
        order: those arrays where ``csr_sorted`` says so, else a copy
        sorted once on the device (one stable sort).  As for every cached
        layout, the structure and the permutation are cached and the
        values gathered through it on every call, so they follow
        ``data``."""
        indptr, indices, data = self.csr_arrays(transpose)
        if self.csr_sorted(transpose):
            return indptr, indices, data

        def build():
            nnz = indices.numel()
            return sort_csr_indices(
                expand_indptr(indptr, nnz), indices,
                torch.arange(nnz, device=indices.device),
                self.shape[0] if transpose else self.shape[1])

        cols, order = self._cached(("sorted_csr", bool(transpose)), build)
        return indptr, cols, data[order]

    # ``csr_arrays(transpose)`` is built on the container's own arrays (for
    # a BSR: its element CSR, in block order) for this ``transpose``.
    _own_csr_transpose = False

    def _cached(self, key, build):
        """``build()``, once per key.  Layouts cache structure (index
        arrays, plans, permutations), never values: ``data`` may be
        updated in place, and each call gathers it anew.  The one cache of
        values is ``dense_planes``', which keys on ``data``'s identity and
        ``_version`` and so sees an in-place change."""
        cache = self.__dict__.setdefault("_layout_cache", {})
        if key not in cache:
            cache[key] = build()
        return cache[key]

    def __repr__(self):
        return (
            f"<{type(self).__name__} shape={self.shape} nnz={self.nnz} "
            f"dtype={self.dtype} device={self.device}>"
        )


def _summed(mat):
    """``mat``, or a copy with its repeated blocks summed when it has any.
    Without repeats the caller's block order is kept, sorted or not, as the
    JAX package's ``BSR.from_scipy`` keeps it."""
    if mat.has_canonical_format:
        return mat
    summed = mat.copy()
    summed.sum_duplicates()
    return mat if summed.nnz == mat.nnz else summed


def _compressed_from_scipy(cls, mat, fmt):
    if not _sps.issparse(mat) or mat.format != fmt:
        raise ValueError(
            f"Expected scipy {fmt.upper()} matrix, got {type(mat)}"
        )
    _check_index_bounds(mat.nnz, mat.shape)
    if not mat.has_canonical_format:
        mat = mat.copy()
        mat.sum_duplicates()
    device = torch_device()
    return cls(
        _values_to_device(mat.data, device),
        _indices_to_device(mat.indices, device),
        _indices_to_device(mat.indptr, device),
        mat.shape,
        bool(mat.has_sorted_indices),
    )


def _host_arrays(mat):
    return (
        mat.data.cpu().numpy(),
        mat.indices.cpu().numpy(),
        mat.indptr.cpu().numpy(),
    )


class CSR(SparseDeviceMatrix):
    format = "csr"

    @classmethod
    def from_scipy(cls, mat):
        return _compressed_from_scipy(cls, mat, "csr")

    def to_scipy(self, container=_sps.csr_matrix):
        return container(_host_arrays(self), shape=self.shape)

    def row_indices(self):
        """One row id per nonzero (device op, cached)."""
        return self._cached(
            "rows", lambda: expand_indptr(self.indptr, self.nnz)
        )

    def csr_arrays(self, transpose=False):
        """(indptr, indices, data) of the CSR of op(A).  The transpose's
        structure and the permutation of the values are cached, the values
        gathered through it on every call, so they follow ``data``."""
        if not transpose:
            return self.indptr, self.indices, self.data
        pattern, order = self._cached("csr_T", lambda: CsrPattern(
            self.indptr, self.indices, self.shape[1]).transpose())
        return pattern.indptr, pattern.indices, self.data[order]

    @property
    def T(self):
        """Zero-cost transpose: the same buffers read as CSC (memoized)."""
        return self._cached("T", lambda: CSC(
            self.data, self.indices, self.indptr, self.shape[::-1],
            self.sorted_indices,
        ))


class CSC(SparseDeviceMatrix):
    format = "csc"
    _own_csr_transpose = True

    @classmethod
    def from_scipy(cls, mat):
        return _compressed_from_scipy(cls, mat, "csc")

    def to_scipy(self, container=_sps.csc_matrix):
        return container(_host_arrays(self), shape=self.shape)

    def col_indices(self):
        """One column id per nonzero (device op, cached)."""
        return self._cached(
            "cols", lambda: expand_indptr(self.indptr, self.nnz)
        )

    def csr_arrays(self, transpose=False):
        """(indptr, indices, data) of the CSR of op(A).  A CSC's own
        arrays are the CSR of its transpose; its CSR form is cached as
        structure and permutation, the values gathered on every call."""
        if transpose:
            return self.indptr, self.indices, self.data
        pattern, order = self._cached("csr", lambda: CsrPattern(
            self.indptr, self.indices, self.shape[0]).transpose())
        return pattern.indptr, pattern.indices, self.data[order]

    @property
    def T(self):
        return self._cached("T", lambda: CSR(
            self.data, self.indices, self.indptr, self.shape[::-1],
            self.sorted_indices,
        ))


class BSR(SparseDeviceMatrix):
    """Block CSR with square blocks.

    ``data`` is (nblocks, bs, bs); ``indices`` holds block-column ids;
    ``indptr`` compresses block rows.
    """

    format = "bsr"

    def __init__(self, data, indices, indptr, shape, blocksize,
                 sorted_indices=None):
        super().__init__(data, indices, indptr, shape, sorted_indices)
        self.blocksize = (int(blocksize[0]), int(blocksize[1]))

    @classmethod
    def from_scipy(cls, mat):
        if not _sps.issparse(mat) or mat.format != "bsr":
            raise ValueError(f"Expected scipy BSR matrix, got {type(mat)}")
        _check_blocksize(mat.blocksize, mat.shape)
        _check_index_bounds(mat.nnz, mat.shape)
        mat = _summed(mat)
        device = torch_device()
        return cls(
            _values_to_device(mat.data, device),
            _indices_to_device(mat.indices, device),
            _indices_to_device(mat.indptr, device),
            mat.shape,
            mat.blocksize,
            bool(mat.has_sorted_indices),
        )

    def to_scipy(self, container=_sps.bsr_matrix):
        return container(
            _host_arrays(self), shape=self.shape, blocksize=self.blocksize
        )

    @property
    def nnz(self):
        return self.nblocks * self.blocksize[0] * self.blocksize[1]

    @property
    def nblocks(self):
        return int(self.data.shape[0])

    def block_row_indices(self):
        """One block-row id per stored block (device op, cached)."""
        return self._cached(
            "block_rows", lambda: expand_indptr(self.indptr, self.nblocks)
        )

    def element_coo(self):
        """(rows, cols, vals) with one entry per stored element, in block
        order (port of ``host._bsr_element_coo``)."""
        R, C = self.blocksize
        nb = self.nblocks
        br = self.block_row_indices()
        i = torch.arange(R, dtype=br.dtype, device=br.device)
        j = torch.arange(C, dtype=br.dtype, device=br.device)
        rows = (br[:, None, None] * R + i[None, :, None]).expand(nb, R, C)
        cols = (self.indices[:, None, None] * C + j[None, None, :]).expand(
            nb, R, C
        )
        return rows.reshape(-1), cols.reshape(-1), self.data.reshape(-1)

    def bsr_arrays(self, transpose=False):
        """(indptr, indices, data) of the BSR of op(A).  The transpose
        swaps block coordinates, transposes each block and re-sorts the
        blocks by block row: the structure and the blocks' order are
        cached, the blocks gathered on every call."""
        if not transpose:
            return self.indptr, self.indices, self.data

        def build():
            return coo_to_csr(
                self.indices, self.block_row_indices(),
                torch.arange(self.nblocks, device=self.data.device),
                self.shape[1] // self.blocksize[0],
            )

        indptr, indices, order = self._cached("bsr_T", build)
        return indptr, indices, self.data[order].transpose(1, 2).contiguous()

    def bsr_plan(self, transpose=False):
        """K1's chunk plan (``bsr_chunk_plan``) of ``bsr_arrays(transpose)``,
        built once on the device and cached."""
        def build():
            indptr, _, data = self.bsr_arrays(transpose)
            return bsr_chunk_plan(indptr, int(data.shape[0]))

        return self._cached(("bsr_plan", bool(transpose)), build)

    def csr_arrays(self, transpose=False):
        """(indptr, indices, data) of the element CSR of op(A), for SpMV:
        the structure and the elements' order cached, the values gathered
        on every call."""
        def build():
            rows, cols, _ = self.element_coo()
            if transpose:
                rows, cols = cols, rows
            return coo_to_csr(
                rows, cols, torch.arange(rows.numel(), device=rows.device),
                self.shape[1 if transpose else 0]
            )

        indptr, indices, order = self._cached(("csr", bool(transpose)), build)
        return indptr, indices, self.data.reshape(-1)[order]


def _check_blocksize(blocksize, shape):
    R, C = blocksize
    if R != C:
        raise ValueError(
            f"BSR blocks must be square; blocksize {tuple(blocksize)} "
            "provided"
        )
    if shape[0] % R or shape[1] % C:
        raise ValueError(
            f"BSR matrix dims {tuple(shape)} must be divisible by the "
            f"blocksize {tuple(blocksize)}"
        )


_DEVICE_CLASSES = {"csr": CSR, "csc": CSC, "bsr": BSR}


def from_arrays(fmt, data, indices, indptr, shape, blocksize=None):
    """Container from host arrays: ``data``/``indices``/``indptr`` of a
    CSR, CSC or BSR (any array-likes that ``np.asarray`` reads, e.g. the
    arrays of a ``sparse_dot_tpu`` container).  The arrays are copied to
    ``config.device``, repeated entries summed on the copy as
    ``from_scipy`` does; BSR ``blocksize`` defaults to
    ``data.shape[1:]``."""
    fmt = str(fmt).lower()
    if fmt not in _DEVICE_CLASSES:
        raise ValueError(
            f"Input matrices must be CSR, CSC, or BSR; {fmt.upper()} is "
            "not supported"
        )
    data = np.asarray(data)
    _validate_dtype(data.dtype)
    shape = tuple(int(s) for s in shape)
    _check_index_bounds(data.size, shape)
    arrays = (data, np.asarray(indices), np.asarray(indptr))
    if fmt != "bsr":
        return _DEVICE_CLASSES[fmt].from_scipy(
            _scipy_format_classes[fmt][0](arrays, shape=shape))
    blocksize = tuple(data.shape[1:]) if blocksize is None else blocksize
    _check_blocksize(blocksize, shape)
    return BSR.from_scipy(
        _sps.bsr_matrix(arrays, shape=shape, blocksize=blocksize))


# ---------------------------------------------------------------------------
# scipy-facing format helpers (reference: _common.py:216-242)
# ---------------------------------------------------------------------------

_scipy_output_types = {
    "csr_matrix": _sps.csr_matrix,
    "csr_array": _sps.csr_array,
    "csc_matrix": _sps.csc_matrix,
    "csc_array": _sps.csc_array,
    "bsr_matrix": _sps.bsr_matrix,
    "bsr_array": _sps.bsr_array,
}
_scipy_format_classes = {
    "csr": (_sps.csr_matrix, _sps.csr_array),
    "csc": (_sps.csc_matrix, _sps.csc_array),
    "bsr": (_sps.bsr_matrix, _sps.bsr_array),
}


def is_csr(x):
    return isinstance(x, _scipy_format_classes["csr"]) or isinstance(x, CSR)


def is_csc(x):
    return isinstance(x, _scipy_format_classes["csc"]) or isinstance(x, CSC)


def is_bsr(x):
    return isinstance(x, _scipy_format_classes["bsr"]) or isinstance(x, BSR)


def is_device_sparse(x):
    return isinstance(x, SparseDeviceMatrix)


def issparse(x):
    return _sps.issparse(x) or is_device_sparse(x)


def sparse_output_type(x):
    """Return (constructor, type-name) matching the input's class, so the
    product of a ``csr_array`` is a ``csr_array`` etc. (reference
    ``sparse_output_type``, ``_common.py:228-242``)."""
    for name, constructor in _scipy_output_types.items():
        if isinstance(x, constructor):
            return constructor, name
    if isinstance(x, CSR):
        return _sps.csr_matrix, "csr_matrix"
    if isinstance(x, CSC):
        return _sps.csc_matrix, "csc_matrix"
    if isinstance(x, BSR):
        return _sps.bsr_matrix, "bsr_matrix"
    raise ValueError(
        "Input matrices must be CSR, CSC, or BSR; COO is not supported"
    )


def to_device(mat):
    """scipy sparse (CSR/CSC/BSR) or container -> container on
    ``config.device`` (a container elsewhere is copied there)."""
    if is_device_sparse(mat):
        device = torch_device()
        return mat if mat.device.type == device.type else mat.to(device)
    if not _sps.issparse(mat):
        raise ValueError(f"Expected a sparse matrix, got {type(mat)}")
    if mat.format not in _DEVICE_CLASSES:
        raise ValueError(
            "Input matrices must be CSR, CSC, or BSR; "
            f"{mat.format.upper()} is not supported"
        )
    return _DEVICE_CLASSES[mat.format].from_scipy(mat)


def dense_to_device(arr):
    """Host dense array -> row-major tensor on ``config.device`` (a copy)."""
    arr = np.asarray(arr)
    _validate_dtype(arr.dtype)
    return _host_to_device(arr, torch_device())
