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
duplicates summed on a copy.

The kernels read CSR (K2, K3) or BSR (K1) in the orientation of the
product.  ``csr_arrays(transpose)`` and ``BSR.bsr_arrays(transpose)``
give those arrays, building the converted layout once on the device (a
stable sort of the other axis' ids) and caching it on the container, as
``BSR.bsr_plan(transpose)`` caches K1's chunk plan (``bsr_chunk_plan``).
"""

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


def _check_index_bounds(nnz, shape):
    int_max = np.iinfo(config.index_dtype).max
    if nnz > int_max or max(shape) > int_max:
        raise ValueError(
            f"Index interface is {np.dtype(config.index_dtype)} and cannot "
            f"hold a matrix with shape {shape} / nnz {nnz}; {ILP64_HINT}"
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


def bsr_chunk_plan(indptr, nblocks):
    """The chunk plan of the block ``indptr`` of a BSR with ``nblocks``
    stored blocks (device ops, no host sync).

    The chunk length S is the mean number of stored blocks per block row,
    rounded up, so a block row longer than the mean is spread over
    several thread blocks.  With L_r blocks in row r, row r has
    max(1, ceil(L_r / S)) chunks; there are at most nbrows + nblocks // S
    of them, at most nblocks // (S + 1) rows of more than one, and those
    rows take at most nblocks // S + nblocks // (S + 1) slots."""
    nbrows = indptr.numel() - 1
    dev = indptr.device
    if nbrows == 0:
        empty = torch.zeros((0, 4), dtype=torch.long, device=dev)
        return BsrChunkPlan(empty, empty[:, :3], 1, 0, 0, nblocks)
    S = bsr_chunk_length(nbrows, nblocks)
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
                        torch.tensor([-1, 0, 0, -1], device=dev))

    # Split row k is the row where the running count of split rows
    # passes k.
    k = torch.arange(n_splits, device=dev)
    srow = torch.searchsorted(torch.cumsum(split.long(), 0), k, right=True)
    s = srow.clamp(max=nbrows - 1)
    splits = torch.stack([s, first_slot[s], nchunks[s]], 1)
    splits = torch.where((srow < nbrows)[:, None], splits,
                         torch.tensor([-1, 0, 0], device=dev))
    return BsrChunkPlan(items, splits, S, nblocks // S + n_splits, nbrows,
                        nblocks)


def coo_to_csr(rows, cols, vals, nrows):
    """Expanded COO -> (indptr, indices, vals) of CSR with ``nrows`` rows.

    A stable sort by row keeps the entries of each row in their input
    order, so COO that is sorted by column within equal rows stays so.
    Plain torch: the counterpart of ``_xla.coo_to_csr_arrays``."""
    order = torch.argsort(rows, stable=True)
    counts = torch.bincount(rows, minlength=nrows)
    indptr = torch.zeros(nrows + 1, dtype=rows.dtype, device=rows.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return indptr, cols[order], vals[order]


class SparseDeviceMatrix:
    """Base class of the containers.

    Attributes
    ----------
    data : torch.Tensor
        Values: (nnz,) for CSR/CSC, (nblocks, R, C) for BSR.
    indices, indptr : torch.Tensor
        Compressed-sparse index arrays in the active index dtype.
    shape : tuple of int
    """

    format = None  # "csr" | "csc" | "bsr"

    def __init__(self, data, indices, indptr, shape):
        self.data = data
        self.indices = indices
        self.indptr = indptr
        self.shape = tuple(int(s) for s in shape)

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

    def _with(self, data, indices=None, indptr=None):
        """Same structure (and class) with other tensors; caches dropped."""
        out = type(self).__new__(type(self))
        SparseDeviceMatrix.__init__(
            out, data,
            self.indices if indices is None else indices,
            self.indptr if indptr is None else indptr,
            self.shape,
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
            self.indptr.to(device),
        )

    def _cached(self, key, build):
        cache = self.__dict__.setdefault("_layout_cache", {})
        if key not in cache:
            cache[key] = build()
        return cache[key]

    def __repr__(self):
        return (
            f"<{type(self).__name__} shape={self.shape} nnz={self.nnz} "
            f"dtype={self.dtype} device={self.device}>"
        )


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
        """(indptr, indices, data) of the CSR of op(A)."""
        if not transpose:
            return self.indptr, self.indices, self.data
        return self._cached("csr_T", lambda: coo_to_csr(
            self.indices, self.row_indices(), self.data, self.shape[1]
        ))

    @property
    def T(self):
        """Zero-cost transpose: the same buffers read as CSC (memoized)."""
        return self._cached("T", lambda: CSC(
            self.data, self.indices, self.indptr, self.shape[::-1]
        ))


class CSC(SparseDeviceMatrix):
    format = "csc"

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
        arrays are the CSR of its transpose."""
        if transpose:
            return self.indptr, self.indices, self.data
        return self._cached("csr", lambda: coo_to_csr(
            self.indices, self.col_indices(), self.data, self.shape[0]
        ))

    @property
    def T(self):
        return self._cached("T", lambda: CSR(
            self.data, self.indices, self.indptr, self.shape[::-1]
        ))


class BSR(SparseDeviceMatrix):
    """Block CSR with square blocks.

    ``data`` is (nblocks, bs, bs); ``indices`` holds block-column ids;
    ``indptr`` compresses block rows.
    """

    format = "bsr"

    def __init__(self, data, indices, indptr, shape, blocksize):
        super().__init__(data, indices, indptr, shape)
        self.blocksize = (int(blocksize[0]), int(blocksize[1]))

    @classmethod
    def from_scipy(cls, mat):
        if not _sps.issparse(mat) or mat.format != "bsr":
            raise ValueError(f"Expected scipy BSR matrix, got {type(mat)}")
        _check_blocksize(mat.blocksize, mat.shape)
        _check_index_bounds(mat.nnz, mat.shape)
        device = torch_device()
        return cls(
            _values_to_device(mat.data, device),
            _indices_to_device(mat.indices, device),
            _indices_to_device(mat.indptr, device),
            mat.shape,
            mat.blocksize,
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
        blocks by block row."""
        if not transpose:
            return self.indptr, self.indices, self.data

        def build():
            bs = self.blocksize[0]
            indptr, indices, order = coo_to_csr(
                self.indices, self.block_row_indices(),
                torch.arange(self.nblocks, device=self.data.device),
                self.shape[1] // bs,
            )
            blocks = self.data[order].transpose(1, 2).contiguous()
            return indptr, indices, blocks

        return self._cached("bsr_T", build)

    def bsr_plan(self, transpose=False):
        """K1's chunk plan (``bsr_chunk_plan``) of ``bsr_arrays(transpose)``,
        built once on the device and cached."""
        def build():
            indptr, _, data = self.bsr_arrays(transpose)
            return bsr_chunk_plan(indptr, int(data.shape[0]))

        return self._cached(("bsr_plan", bool(transpose)), build)

    def csr_arrays(self, transpose=False):
        """(indptr, indices, data) of the element CSR of op(A), for SpMV."""
        def build():
            rows, cols, vals = self.element_coo()
            if transpose:
                rows, cols = cols, rows
            return coo_to_csr(
                rows, cols, vals, self.shape[1 if transpose else 0]
            )

        return self._cached(("csr", bool(transpose)), build)


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
    ``config.device``; BSR ``blocksize`` defaults to ``data.shape[1:]``."""
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
    device = torch_device()
    parts = (
        _values_to_device(data, device),
        _indices_to_device(indices, device),
        _indices_to_device(indptr, device),
        shape,
    )
    if fmt != "bsr":
        return _DEVICE_CLASSES[fmt](*parts)
    blocksize = tuple(data.shape[1:]) if blocksize is None else blocksize
    _check_blocksize(blocksize, shape)
    return BSR(*parts, blocksize)


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
