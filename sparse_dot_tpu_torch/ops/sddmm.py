"""CSR SDDMM (kernel K7): the gradient of a sparse product with respect to
its values.

``csr_sddmm(indptr, indices, g, b, alpha)`` gives, for each stored entry
p = (r_p, c_p) of a CSR A in its stored order,

    out[p] = alpha * sum_n g[r_p, n] * conj(b[c_p, n])

(conj only for complex values): G B^H sampled at A's pattern.  With
G = dL/dC of C = A @ B it is dL/d(A's values), as PyTorch's convention
for complex gradients has it; at n = 1 it is the gradient of y = A @ x.
On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/csr_sddmm.cu``) or raises; on a CPU tensor it runs the plain
version beside it, which is also what the kernel is checked against on
the card.  ``csr_sddmm.launches`` counts calls that launched the kernel.

K7 replaces XLA's transpose of the scatter in ``_xla.coo_spmm_raw`` and
``_xla.coo_spmv`` (``sparse_dot_tpu/ops/_xla.py``), which ``jax.grad``
runs through an nnz x n intermediate.  It is bound by the bytes it moves
(A's indices, G, the rows of B it gathers, the output); the gather of a
whole B row per entry through L2 sets its time.  Its lane mapping is
K2's (``csr.spmm_schedule``), chosen on the host with no device read,
with rounds of entries software-pipelined and spans sized to one wave
of the card (``sddmm_schedule``).
"""

from typing import NamedTuple

import torch

from ..config import config
from ..formats import expand_indptr
from . import _build
from .csr import _check, refuse_tracked, refuse_views, spmm_schedule

# Groups of 32 lanes in one wave of the span kernel: the H100's 132 SMs,
# 32 warps on each (``csrc/csr_sddmm.cu``, kSpanBlocks blocks of 4 warps).
_SPAN_GROUPS = 132 * 32
# Spans stay in [_SPAN_MIN, _SPAN_MAX] entries.
_SPAN_MIN, _SPAN_MAX = 32, 512
# The entry kernel's tile: a warp takes 32 * 8 consecutive entries.
_ENTRY_TILE = 32 * 8
# The span kernel counts columns in 32 bits, a strip past the last.
_MAX_N = 2**31 - 1024


class SddmmSchedule(NamedTuple):
    """K7's launch: ``vec``, ``lanes`` and ``per_lane`` as in K2's
    ``SpmmSchedule`` (a strip of ``lanes * per_lane * vec`` columns),
    ``round``, the entries whose B rows a group loads together and whose
    sums it adds in one reduce-scatter, and ``span``, the consecutive
    entries a group of ``lanes`` lanes walks.  ``lanes`` == 1 (n at most
    one 16-byte load) is the entry kernel: a thread an entry (``round``
    1), a warp a tile of ``span`` = ``_ENTRY_TILE`` entries."""

    vec: int
    lanes: int
    per_lane: int
    round: int
    span: int


def round_entries(lanes, load_bytes):
    """Entries a round for groups of ``lanes`` lanes that load
    ``load_bytes`` of an entry's B row a lane: 4, halved while four would
    pass 64 bytes a lane, at most ``lanes`` (``csrc/csr_sddmm.cu``,
    round_entries, which refuses any other)."""
    e = 4
    while e > 2 and e * load_bytes > 64:
        e //= 2
    return min(e, lanes)


def sddmm_schedule(n, dtype, nnz, aligned=True):
    """The ``SddmmSchedule`` for n columns of ``dtype`` and ``nnz``
    entries; ``aligned``: G and B start on 16 bytes.  The lanes are K2's
    for n (``spmm_schedule``: 16-byte loads only for aligned rows of whole
    16-byte units, so misaligned views take scalar loads); the span is
    the entries over one wave of groups (``_SPAN_GROUPS`` groups of 32
    lanes, more for narrower groups), kept in [``_SPAN_MIN``,
    ``_SPAN_MAX``]."""
    s = spmm_schedule(n, dtype, 0, aligned)
    if s.lanes == 1:
        return SddmmSchedule(s.vec, 1, 1, 1, _ENTRY_TILE)
    groups = _SPAN_GROUPS * (32 // s.lanes)
    span = min(_SPAN_MAX, max(_SPAN_MIN, -(-nnz // groups)))
    load_bytes = s.per_lane * s.vec * dtype.itemsize
    return SddmmSchedule(s.vec, s.lanes, s.per_lane,
                         round_entries(s.lanes, load_bytes), span)


def csr_sddmm_plain(indptr, indices, g, b, alpha=None):
    """``alpha * sum_n g[r_p, n] * conj(b[c_p, n])`` for each entry p of
    the CSR (``indptr``, ``indices``) in plain PyTorch: gather both rows,
    multiply, sum over n, chunked over nnz so the gathered intermediate
    stays under ``config.spmm_chunk_elements`` elements."""
    nnz, n = indices.numel(), g.shape[1]
    out = torch.zeros(nnz, dtype=g.dtype, device=g.device)
    if nnz and n:
        rows = expand_indptr(indptr, nnz).long()
        nchunks = max(1, (nnz * n) // config.spmm_chunk_elements)
        chunk = -(-nnz // nchunks)
        for s in range(0, nnz, chunk):
            e = min(s + chunk, nnz)
            prods = g[rows[s:e]] * b[indices[s:e].long()].conj()
            out[s:e] = prods.sum(1)
    if alpha is not None and complex(alpha) != 1:
        out = out * alpha
    return out


def csr_sddmm(indptr, indices, g, b, alpha=None):
    """``alpha * (g @ b^H)`` at the entries of the CSR (``indptr`` of
    m + 1, ``indices`` into k columns), for row-major ``g`` of (m, n) and
    ``b`` of (k, n), as a new (nnz,) tensor in the entries' stored order.
    Not differentiable itself (``ops.autograd.CsrSddmm`` is): it raises on
    a tracked ``g`` or ``b`` (``csr.refuse_tracked``), on both devices."""
    refuse_tracked("csr_sddmm", g, b)
    return sddmm(indptr, indices, g, b, alpha)


def sddmm(indptr, indices, g, b, alpha=None):
    """``csr_sddmm`` without the tracked check, for ``CsrSddmm``'s forward:
    K7 on the card, the plain version on the CPU; counted in
    ``csr_sddmm.launches``."""
    refuse_views("csr_sddmm", indptr, indices, g, b)
    if g.device.type == "cpu":
        return csr_sddmm_plain(indptr, indices, g, b, alpha)
    if not g.is_cuda:
        raise ValueError(f"csr_sddmm: no kernel for device {g.device}")
    _check("csr_sddmm", (indptr, indices), (g, b))
    m, nnz = indptr.numel() - 1, indices.numel()
    if g.dim() != 2 or b.dim() != 2 or g.shape[0] != m or (
            g.shape[1] != b.shape[1]):
        raise ValueError(f"csr_sddmm: g {tuple(g.shape)} and b "
                         f"{tuple(b.shape)} do not fit {m} rows")
    n = g.shape[1]
    if n > _MAX_N:
        raise ValueError(f"csr_sddmm: n = {n} past the kernel's {_MAX_N}")
    out = torch.empty(nnz, dtype=g.dtype, device=g.device)
    if nnz == 0:
        return out
    if n == 0:
        return out.zero_()
    aligned = g.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    s = sddmm_schedule(n, g.dtype, nnz, aligned)
    dt, it = _build.type_codes(g, indptr)
    _build.launch(
        "sdt_csr_sddmm", dt, it, indptr.data_ptr(), indices.data_ptr(),
        g.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, nnz, s.vec,
        s.lanes, s.per_lane, s.round, s.span, *_build.scalar_parts(alpha),
        _build.stream_of(g),
    )
    csr_sddmm.launches += 1
    return out


csr_sddmm.launches = 0
