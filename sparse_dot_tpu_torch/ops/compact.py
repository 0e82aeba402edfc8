"""Masked compaction (kernel K13): a dense C at a structural mask -> CSR.

``csr_compact(c, p, triangular, row0, index_dtype)`` returns the CSR arrays
(indptr, indices, data) of the r x n dense ``c`` at the positions where the
structural count ``p`` (r x n, bf16, the product of two indicators) is > 0,
with ``triangular`` only at columns j >= row0 + i: columns ascending in each
row, every position of the mask stored, exact zeros of ``c`` included, as
K5 writes a sparse-output product.  It is ``masked_compact``, one launch
that counts each tile of rows, finds the tile's start by a single pass
across tiles (decoupled look-back) and fills indptr, the columns and the
values gathered from ``c`` into arrays sized for every position of the
area (``area``), with the total in a device word; then the total is read
on the host and the arrays cut there (``cut``).  The densify route of
sparse-output products (``ops/host``) reads that total in one host copy
with its operands' finite flags.

On CUDA tensors ``masked_compact`` launches the hand-written kernel
(``csrc/csr_compact.cu``) or raises; on CPU tensors it runs the plain
version beside it (``torch.nonzero`` order of the mask, ``c`` gathered at
it, arrays of the exact size), which is also what the kernel is checked
against on the card.  ``masked_compact.launches`` counts the calls that
launched the kernel.  Its tiles of rows (``compact_plan``) cut each row
into work items of 256-column steps that the block's warps share, and
keep the mask of P a bit a column in shared memory, so P is read once;
rows too wide for that read P again in the fill.  The look-back's status
words and the tiles' ticket live in a workspace per device and stream
(``_workspace``), reused by every call: the words carry the call's
number, so no call zeroes them.

K13 replaces ``_xla.extract_structure`` and ``extract_sparse_masked``
(``sparse_dot_tpu/ops/_xla.py:1301``, ``:1460``).  It is bound by bytes: P
read once, C read at the mask, the CSR written once.
"""

from collections import OrderedDict

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


def csr_compact_plain(c, p, triangular=False, row0=0,
                      index_dtype=torch.int32):
    """K13's plain version: the rows' running sum of the mask's positions,
    the positions in ``torch.nonzero`` order (row-major, so columns ascend
    in each row) and ``c`` gathered there."""
    mask = _mask(p, triangular, row0)
    indptr = torch.zeros(p.shape[0] + 1, dtype=index_dtype, device=p.device)
    indptr[1:] = mask.sum(dim=1).cumsum(0)
    return indptr, mask.nonzero()[:, 1].to(index_dtype), c[mask]


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


# Shared memory for a tile's masks of P, at most (``csrc/csr_compact.cu``,
# kStageBytes): rows whose masks do not fit are read again in the fill.
STAGE_BYTES = 32 * 1024
# A block's warps, a tile's rows and work items at most, and the tiles
# that fill the card (the H100's 132 SMs).
_WARPS = 8
_MAX_ROWS = 32
_MAX_ITEMS = 1024
_TILES = 132
# Status words carry the call's number below this (``kMaxTag``).
_MAX_TAG = 1 << 23
# Workspaces kept, one a (device, stream); the least recently used go.
_MAX_WORKSPACES = 8


def compact_plan(r, n):
    """(rows a tile, steps an item, staged) of K13's launch.  A row's
    columns are steps of 256, taken in work items of ``q`` steps (1, more
    only where a row would pass ``_MAX_ITEMS`` items), which the block's 8
    warps share: the most rows a tile (up to 32) whose items stay within
    two a warp, fewer while the tiles are fewer than ``_TILES`` and the
    items more than one a warp, fewer again while the tile's masks (n bits
    a row) pass ``STAGE_BYTES``; ``staged`` False where one row's do (P
    read again in the fill)."""
    steps = -(-n // 256)
    q = max(1, -(-steps // _MAX_ITEMS))
    items = -(-steps // q)
    rows = 1
    while rows < _MAX_ROWS and 2 * rows * items <= 2 * _WARPS:
        rows *= 2
    while rows > 1 and -(-r // rows) < _TILES and rows * items > _WARPS:
        rows //= 2
    row_bytes = steps * 32
    if row_bytes > STAGE_BYTES:
        return rows, q, False
    while rows * row_bytes > STAGE_BYTES:
        rows //= 2
    return rows, q, True


class _Workspace:
    """The look-back's status words (one a tile, int64), the tiles' ticket
    (one word, 0 between calls) and the number of the last call that used
    them."""

    def __init__(self, device, tiles):
        self.status = torch.zeros(tiles, dtype=torch.int64, device=device)
        self.ticket = torch.zeros(1, dtype=torch.int64, device=device)
        self.tag = 0


_workspaces = OrderedDict()


def _workspace(device, stream, tiles):
    """The workspace of (device, stream) with at least ``tiles`` status
    words, its tag advanced to this call's: new zeroed words where it
    grows, and the words zeroed once every 2^23 calls, when the tag wraps
    (a word of an earlier call must never carry the current tag).  One is
    kept a (device, stream), made on that stream, the least recently used
    past ``_MAX_WORKSPACES`` dropped (the allocator frees it in its
    stream's order).  Inside a CUDA graph capture a new one with tag 1,
    which the graph keeps and zeroes before each replay."""
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        ws = _Workspace(device, tiles)
        ws.tag = 1
        return ws
    key = (device, stream)
    ws = _workspaces.pop(key, None)
    if ws is None or ws.status.numel() < tiles:
        ws = _Workspace(device, max(tiles, 2 * (ws.status.numel() if ws
                                                else 0)))
    _workspaces[key] = ws
    while len(_workspaces) > _MAX_WORKSPACES:
        _workspaces.popitem(last=False)
    ws.tag += 1
    if ws.tag >= _MAX_TAG:
        ws.status.zero_()
        ws.tag = 1
    return ws


def masked_compact(c, p, triangular=False, row0=0, index_dtype=torch.int32):
    """(indptr, indices, data, total) of C at P > 0 (``triangular``: at j
    >= row0 + i), with ``total`` the number of entries as a 0-d int64
    tensor on P's device: one K13 launch on the card (none for an empty
    area), whose indices and data hold ``area`` entries, the first
    ``total`` of them written; the plain version on the CPU, of the exact
    size.  Nothing is read on the host: ``cut`` the arrays at the total
    read there."""
    _check_p("masked_compact", p, row0)
    refuse_views("masked_compact", c)
    refuse_tracked("masked_compact", c)
    r, n = p.shape
    if tuple(c.shape) != (r, n) or c.device != p.device:
        raise ValueError(f"masked_compact: C {tuple(c.shape)} on {c.device} "
                         f"and P {(r, n)} on {p.device}")
    if c.device.type == "cpu":
        indptr, indices, data = csr_compact_plain(c, p, triangular, row0,
                                                  index_dtype)
        return indptr, indices, data, torch.tensor(indices.numel())
    if not c.is_contiguous():
        raise ValueError("masked_compact: C must be contiguous")
    size = area(r, n, triangular, row0)
    # The kernel writes every start and the total; with no position it does
    # not run.
    make = torch.empty if size else torch.zeros
    indptr = make(r + 1, dtype=index_dtype, device=c.device)
    total = make((), dtype=torch.int64, device=c.device)
    indices = torch.empty(size, dtype=index_dtype, device=c.device)
    data = torch.empty(size, dtype=c.dtype, device=c.device)
    if size:
        rows, q, staged = compact_plan(r, n)
        stream = _build.stream_of(c)
        ws = _workspace(c.device, stream, -(-r // rows))
        dt, it = _build.type_codes(c, indptr)
        _build.launch("sdt_csr_compact", dt, it, c.data_ptr(), p.data_ptr(),
                      r, n, int(bool(triangular)), int(row0), rows, q,
                      int(staged), ws.status.data_ptr(),
                      ws.ticket.data_ptr(), ws.tag, indptr.data_ptr(),
                      indices.data_ptr(), data.data_ptr(), total.data_ptr(),
                      stream)
        masked_compact.launches += 1
    return indptr, indices, data, total


masked_compact.launches = 0


def cut(arrays, nnz, ncols):
    """``masked_compact``'s arrays (indptr, indices, data) cut at their
    total ``nnz`` (read on the host); raises (with the ILP64 hint) where
    their index type cannot hold it."""
    indptr, indices, data = arrays
    _check_index_bounds(nnz, (indptr.numel() - 1, ncols), indices.dtype)
    return indptr, indices[:nnz], data[:nnz]


def csr_compact(c, p, triangular=False, row0=0, index_dtype=torch.int32):
    """(indptr, indices, data) of C at P > 0 (``triangular``: at j >= row0
    + i): ``masked_compact``, the total read on the host, ``cut``."""
    *arrays, total = masked_compact(c, p, triangular, row0, index_dtype)
    return cut(arrays, int(total), p.shape[1])
