"""CSR densify (kernel K12): CSR arrays -> a dense row-major matrix.

``csr_densify(indptr, indices, data, shape)`` scatters the entries of an
m x k CSR into zeros: repeated columns in a row are summed, columns may
come in any order, explicit zeros are kept.  On a CUDA tensor the wrapper
launches the hand-written kernel (``csrc/csr_densify.cu``) or raises; on a
CPU tensor it runs the plain version beside it, which is also what the
kernel is checked against on the card.  ``csr_densify.launches`` counts
calls that launched the kernel.

K12 replaces ``_xla.densify`` and ``_xla.densify_sorted`` (through
``sorted_set_scatter``) of ``sparse_dot_tpu/ops/_xla.py``, the scatter
half of ``spmm_densified_sorted`` and ``spgemm_numeric_sorted``.  It is
bound by the bytes of the dense output, written once: rows that fit
TILE_BYTES are built in shared memory a tile of consecutive rows at a
time (``densify_plan``) and stored once, wider rows are zeroed in device
memory and their entries added in L2.  The containers' ``dense()`` and
``to_dense()`` (``formats``) call it on a matrix's stored arrays, so the
densify route of ``ops/host`` and the dense QR and LU solvers run on it.

``csr_indicator(indptr, indices, shape)`` is K12's indicator template: bf16
1.0 at every stored position (explicit zeros included, repeats once), no
value read, the counterpart of ``_xla._indicator_sorted``.  The densify
route of sparse-output products multiplies two of them into the
structural count P (``ops/host``); ``csr_indicator.launches`` counts its
launches apart from K12's values.
"""

import torch

from ..formats import expand_indptr
from . import _build
from .csr import _check, refuse_tracked, refuse_views

# The largest tile of rows built in shared memory (``kTileBytes`` in
# ``csrc/csr_densify.cu``); a row wider than this takes the device-memory
# path.
TILE_BYTES = 200 * 1024
# The largest tile of which two fit an SM's 227 KB: tiles of rows up to
# this wide stay within it, so two blocks share an SM.
PAIR_BYTES = 112 * 1024
# Tiles per SM that the tile count should reach before tiles grow past
# one row: the H100's 132 SMs.
_SMS = 132
_TILES_PER_SM = 4


def densify_plan(m, k, itemsize):
    """K12's rows per tile for an m x k output of ``itemsize``-byte
    values: 0 (a block a row, in device memory) when a row is wider than
    TILE_BYTES; else as many rows as fit PAIR_BYTES (one row up to
    TILE_BYTES) but no more than leave ``_TILES_PER_SM`` tiles an SM, at
    least one."""
    row = k * itemsize
    if row > TILE_BYTES:
        return 0
    spread = -(-m // (_TILES_PER_SM * _SMS))
    return max(1, min(PAIR_BYTES // max(row, 1), spread))


def csr_densify_plain(indptr, indices, data, shape):
    """K12's plain version: zeros, then ``index_put_`` with accumulate at
    each entry's (row, column)."""
    rows = expand_indptr(indptr, indices.numel())
    dense = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return dense.index_put_((rows.long(), indices.long()), data,
                            accumulate=True)


def _arguments(name, indptr, indices, data, shape):
    """(m, k) of ``shape``; raises where the arrays do not fit it."""
    m, k = (int(s) for s in shape)
    if indptr.numel() != m + 1 or data.numel() != indices.numel():
        raise ValueError(f"{name}: indptr of {indptr.numel()} and "
                         f"{indices.numel()} indices, {data.numel()} values "
                         f"do not fit {(m, k)}")
    return m, k


def csr_densify(indptr, indices, data, shape):
    """The (m, k) = ``shape`` dense matrix of CSR arrays (``indptr`` of
    m + 1, ``indices`` and ``data`` of nnz), row-major, as a new tensor:
    K12 on the card, the plain version on the CPU.  Column ids must lie in
    [0, k) (the kernel skips others).  Refuses a tracked ``data`` on
    either device (``csr.refuse_tracked``): the kernel carries no
    gradient."""
    refuse_views("csr_densify", indptr, indices, data)
    refuse_tracked("csr_densify", data)
    m, k = _arguments("csr_densify", indptr, indices, data, shape)
    if data.device.type == "cpu":
        return csr_densify_plain(indptr, indices, data, (m, k))
    if not data.is_cuda:
        raise ValueError(f"csr_densify: no kernel for device {data.device}")
    _check("csr_densify", (indptr, indices), (data,))
    out = torch.empty((m, k), dtype=data.dtype, device=data.device)
    if m == 0 or k == 0:
        return out
    dt, it = _build.type_codes(data, indptr)
    _build.launch("sdt_csr_densify", dt, it, indptr.data_ptr(),
                  indices.data_ptr(), data.data_ptr(), out.data_ptr(), m, k,
                  densify_plan(m, k, data.element_size()),
                  _build.stream_of(data))
    csr_densify.launches += 1
    return out


csr_densify.launches = 0


def csr_indicator_plain(indptr, indices, shape):
    """The indicator template's plain version: bf16 zeros, 1.0 put at each
    entry's (row, column)."""
    rows = expand_indptr(indptr, indices.numel())
    ind = torch.zeros(tuple(shape), dtype=torch.bfloat16,
                      device=indices.device)
    return ind.index_put_((rows.long(), indices.long()),
                          torch.ones((), dtype=torch.bfloat16,
                                     device=indices.device))


def csr_indicator(indptr, indices, shape):
    """The (m, k) = ``shape`` bf16 structural indicator of CSR arrays: 1.0
    at every stored position, 0 elsewhere, row-major, as a new tensor: K12's
    indicator template on the card, the plain version on the CPU.  Column
    ids must lie in [0, k) (the kernel skips others)."""
    refuse_views("csr_indicator", indptr, indices)
    m, k = _arguments("csr_indicator", indptr, indices, indices, shape)
    if indices.device.type == "cpu":
        return csr_indicator_plain(indptr, indices, (m, k))
    if not indices.is_cuda:
        raise ValueError(f"csr_indicator: no kernel for device "
                         f"{indices.device}")
    _check("csr_indicator", (indptr, indices), (indices,))
    out = torch.empty((m, k), dtype=torch.bfloat16, device=indices.device)
    if m == 0 or k == 0:
        return out
    _build.launch("sdt_csr_indicator", _build.index_code(indptr),
                  indptr.data_ptr(), indices.data_ptr(), out.data_ptr(), m, k,
                  densify_plan(m, k, out.element_size()),
                  _build.stream_of(indices))
    csr_indicator.launches += 1
    return out


csr_indicator.launches = 0
