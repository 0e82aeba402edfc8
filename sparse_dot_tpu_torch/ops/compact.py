"""Masked compaction (kernel K13): a dense C at a structural mask -> CSR.

``csr_compact(c, p, triangular, row0, index_dtype)`` returns the CSR arrays
(indptr, indices, data) of the r x n dense ``c`` at the positions where the
structural count ``p`` (r x n, bf16, the product of two indicators) is > 0,
with ``triangular`` only at columns j >= row0 + i: columns ascending in each
row, every position of the mask stored, exact zeros of ``c`` included, as
K5 writes a sparse-output product.  It is two launches around a running
sum, with no host read between them: ``compact_count`` (each row's count on
the card, then ``torch.cumsum`` into the rows' starts, int64) and
``compact_fill`` (indptr, the columns and the values gathered from ``c``,
into arrays sized for every position of the area, ``area``); then the
total is read on the host and the arrays cut there (``cut``).  The
densify route of sparse-output products (``ops/host``) reads that total in
one host copy with its operands' finite flags.

On CUDA tensors the wrappers launch the hand-written kernels
(``csrc/csr_compact.cu``) or raise; on CPU tensors they run the plain
versions beside them (``torch.nonzero`` order of the mask, ``c`` gathered
at it, arrays of the exact size), which is also what the kernels are
checked against on the card.  ``compact_count.launches`` and
``compact_fill.launches`` count the calls that launched a kernel.

K13 replaces ``_xla.extract_structure`` and ``extract_sparse_masked``
(``sparse_dot_tpu/ops/_xla.py:1301``, ``:1460``).  It is bound by bytes: P
read twice, C read at the mask, the CSR written once.
"""

import torch

from ..formats import _check_index_bounds
from . import _build
from .csr import refuse_tracked, refuse_views

# The type of the structural count P that the kernels read.
INDICATOR_DTYPE = torch.bfloat16


def _mask(p, triangular, row0):
    """P > 0, with ``triangular`` only at columns j >= row0 + i."""
    mask = p > 0
    if triangular:
        r, n = mask.shape
        rows = torch.arange(r, device=p.device) + row0
        mask &= torch.arange(n, device=p.device)[None, :] >= rows[:, None]
    return mask


def compact_count_plain(p, triangular=False, row0=0):
    """K13's count, plain: each row's stored positions, int64."""
    return _mask(p, triangular, row0).sum(dim=1)


def compact_fill_plain(c, p, starts, triangular=False, row0=0,
                       index_dtype=torch.int32):
    """K13's fill, plain: the mask's positions in ``torch.nonzero`` order
    (row-major, so columns ascend in each row) and ``c`` gathered there."""
    mask = _mask(p, triangular, row0)
    return (starts.to(index_dtype), mask.nonzero()[:, 1].to(index_dtype),
            c[mask])


def csr_compact_plain(c, p, triangular=False, row0=0,
                      index_dtype=torch.int32):
    """K13's plain version: count, running sum and fill in one call."""
    starts = torch.zeros(p.shape[0] + 1, dtype=torch.int64, device=p.device)
    starts[1:] = compact_count_plain(p, triangular, row0).cumsum(0)
    return compact_fill_plain(c, p, starts, triangular, row0, index_dtype)


def area(r, n, triangular=False, row0=0):
    """Positions of the r x n area: all, or with ``triangular`` those with
    j >= row0 + i."""
    if not triangular:
        return r * n
    rows = min(max(n - row0, 0), r)
    return rows * (n - row0) - rows * (rows - 1) // 2


def _check_p(name, p, row0):
    refuse_views(name, p)
    if p.dim() != 2 or p.dtype != INDICATOR_DTYPE:
        raise ValueError(f"{name}: P must be a 2-d {INDICATOR_DTYPE} "
                         f"tensor, not {tuple(p.shape)} {p.dtype}")
    if not p.is_contiguous():
        raise ValueError(f"{name}: P must be contiguous")
    if row0 < 0:
        raise ValueError(f"{name}: row0 = {row0} < 0")
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {p.device}")


def compact_count(p, triangular=False, row0=0):
    """The rows' starts of the CSR of P > 0 (``triangular``: at j >= row0 +
    i), r + 1 int64 on P's device, the last the total: K13's count launch
    on the card (the plain version on the CPU), then ``torch.cumsum``.
    Nothing is read on the host."""
    _check_p("compact_count", p, row0)
    r, n = p.shape
    if p.device.type == "cpu":
        starts = torch.zeros(r + 1, dtype=torch.int64)
        starts[1:] = compact_count_plain(p, triangular, row0)
    elif r and n:
        starts = torch.empty(r + 1, dtype=torch.int64, device=p.device)
        _build.launch("sdt_csr_compact_count", p.data_ptr(), r, n,
                      int(bool(triangular)), int(row0), starts.data_ptr(),
                      _build.stream_of(p))
        compact_count.launches += 1
    else:
        starts = torch.zeros(r + 1, dtype=torch.int64, device=p.device)
    starts[1:].cumsum_(0)
    return starts


compact_count.launches = 0


def compact_fill(c, p, starts, triangular=False, row0=0,
                 index_dtype=torch.int32):
    """(indptr, indices, data) of C at P > 0 (``triangular``: at j >= row0
    + i), given ``compact_count``'s ``starts``: K13's fill launch on the
    card (none for an empty area), whose indices and data hold ``area``
    entries, the first starts[-1] of them written; the plain version on the
    CPU, of the exact size.  ``cut`` them at the total read on the host."""
    _check_p("compact_fill", p, row0)
    refuse_views("compact_fill", c, starts)
    refuse_tracked("compact_fill", c)
    r, n = p.shape
    if tuple(c.shape) != (r, n) or c.device != p.device:
        raise ValueError(f"compact_fill: C {tuple(c.shape)} on {c.device} "
                         f"and P {(r, n)} on {p.device}")
    if starts.shape != (r + 1,) or starts.dtype != torch.int64:
        raise ValueError("compact_fill: starts must be compact_count's")
    if c.device.type == "cpu":
        return compact_fill_plain(c, p, starts, triangular, row0,
                                  index_dtype)
    if not c.is_contiguous():
        raise ValueError("compact_fill: C must be contiguous")
    size = area(r, n, triangular, row0)
    # The kernel writes every start; with no position it does not run.
    indptr = (torch.empty if size else torch.zeros)(
        r + 1, dtype=index_dtype, device=c.device)
    indices = torch.empty(size, dtype=index_dtype, device=c.device)
    data = torch.empty(size, dtype=c.dtype, device=c.device)
    if size:
        dt, it = _build.type_codes(c, indptr)
        _build.launch("sdt_csr_compact_fill", dt, it, c.data_ptr(),
                      p.data_ptr(), r, n, int(bool(triangular)), int(row0),
                      starts.data_ptr(), indptr.data_ptr(), indices.data_ptr(),
                      data.data_ptr(), _build.stream_of(c))
        compact_fill.launches += 1
    return indptr, indices, data


compact_fill.launches = 0


def cut(arrays, nnz, ncols):
    """``compact_fill``'s arrays cut at their total ``nnz`` (read on the
    host); raises (with the ILP64 hint) where their index type cannot hold
    it."""
    indptr, indices, data = arrays
    _check_index_bounds(nnz, (indptr.numel() - 1, ncols), indices.dtype)
    return indptr, indices[:nnz], data[:nnz]


def csr_compact(c, p, triangular=False, row0=0, index_dtype=torch.int32):
    """(indptr, indices, data) of C at P > 0 (``triangular``: at j >= row0
    + i): ``compact_count``, ``compact_fill``, the total read on the host,
    ``cut``."""
    starts = compact_count(p, triangular, row0)
    arrays = compact_fill(c, p, starts, triangular, row0, index_dtype)
    return cut(arrays, int(starts[-1]), p.shape[1])
