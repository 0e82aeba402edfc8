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

``sddmm_batched`` runs K7 for a batch of members that share the pattern
(g and b each per member or shared) in one launch, the member on the
grid's y dimension: the backward of ``torch.func.vmap`` over the values
or over b (per-sample gradients), ``jacrev``'s batch of cotangents and a
batch of tangents (``ops.autograd``).  Where b is shared, a group of
lanes serves ``shared_members`` members at once (4, or 2 where the card
timed that faster or the lanes hold no more), gathering each entry's row
of b once for all of them; where g is shared and b is not, the same runs
on A's transpose with the roles swapped, given that transpose.
"""

from typing import NamedTuple

import torch

from ..config import config
from ..formats import expand_indptr
from . import _build
from .csr import (_check, aligned_members, batch_size, check_members,
                  member_chunks, member_ptr, member_stride, refuse_tracked,
                  refuse_views, spmm_schedule)

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


# Members a group serves with b shared where the card timed fewer faster
# than the most one reduce-scatter holds, by (value type, index bytes):
# c128 with 64-bit indices ran 16 G's at config 1 (n = 128) in 3.43 ms
# at 2 members against 4.87 at 4 (PERF.md).
_FEWER_MEMBERS = {(torch.complex128, 8): 2}


def shared_round(lanes, load_bytes, members):
    """Entries a round of the shared kernel: ``round_entries``' split over
    the ``members``, at least 1 (``csrc/csr_sddmm.cu``, shared_round)."""
    return max(1, round_entries(lanes, load_bytes) // members)


def shared_members(s, dtype, index_bytes=4):
    """Members a group serves at once where b is shared: the most of 4 and
    2 whose sums one reduce-scatter of the group's lanes holds (round *
    members <= lanes), within ``_FEWER_MEMBERS`` for its type and index
    bytes; 1 (the per-member kernel) where none does, and for the entry
    kernel.  Timed at config 1, n = 128, 16 G's (``compare_k7_k13.py
    members``): 4 ran fastest in f32, f64 (either index width), c64 and
    c128 with 32-bit indices, 2 in c128 with 64-bit ones."""
    if s.lanes == 1:
        return 1
    most = _FEWER_MEMBERS.get((dtype, index_bytes), 4)
    load_bytes = s.per_lane * s.vec * dtype.itemsize
    for members in (4, 2):
        if (members <= most and shared_round(s.lanes, load_bytes, members)
                * members <= s.lanes):
            return members
    return 1


def batched_schedule(n, dtype, nnz, size, strides, aligned=True,
                     index_bytes=4):
    """(``SddmmSchedule``, members a group) of a batched launch of
    ``size`` members at member ``strides`` (g, b), indices of
    ``index_bytes``: with b shared and g not, ``shared_members`` members a
    group, the round ``shared_round`` and the span sized over the member
    groups' entries; otherwise one member a group, the span sized over all
    members' entries (spans sized to fill whole waves of the card measured
    slower, PERF.md)."""
    s = sddmm_schedule(n, dtype, size * nnz, aligned)
    members = (shared_members(s, dtype, index_bytes)
               if strides[1] == 0 and strides[0] else 1)
    if members == 1:
        return s, 1
    groups = -(-size // members)
    span = sddmm_schedule(n, dtype, groups * nnz, aligned).span
    load_bytes = s.per_lane * s.vec * dtype.itemsize
    return s._replace(round=shared_round(s.lanes, load_bytes, members),
                      span=span), members


def swapped_roles(transpose, g, b, alpha, run, out=None):
    """``alpha * (g @ b^H)`` at A's entries computed as ``run`` (a batched
    K7 or its plain version) on A's transpose with b and g swapped:
    entry q of the transpose, (c, r), is entry order[q], (r, c), of A, and
    ``conj(conj(alpha) * b_c . conj(g_r)) = alpha * g_r . conj(b_c)``.
    ``transpose`` is (pattern of A's transpose, order); the result goes to
    ``out`` (a new tensor when None) in A's entries' order."""
    t, order = transpose
    if alpha is not None and g.is_complex():
        alpha = complex(alpha).conjugate()
    swapped = run(t.indptr, t.indices, b, g, alpha)
    if swapped.is_complex():
        swapped.conj_physical_()
    # A gather in A's order (each output written once, in order) through
    # the inverse of ``order``.
    back = torch.empty_like(order)
    back[order] = torch.arange(order.numel(), dtype=order.dtype,
                               device=order.device)
    if out is None:
        return swapped.index_select(-1, back)
    return torch.index_select(swapped, -1, back, out=out)


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


def csr_sddmm_batched_plain(indptr, indices, g, b, alpha=None):
    """``sddmm_batched`` in plain PyTorch, vectorised over the members:
    ``csr_sddmm_plain``'s gathers, product and sum with a member
    dimension ahead (a shared operand broadcast), chunked over nnz so the
    gathered intermediate of all members stays under
    ``config.spmm_chunk_elements`` elements."""
    size = batch_size("csr_sddmm", ((g, 2), (b, 2)))
    nnz, n = indices.numel(), g.shape[-1]
    out = torch.zeros((size, nnz), dtype=g.dtype, device=g.device)
    if nnz and n and size:
        rows = expand_indptr(indptr, nnz).long()
        nchunks = max(1, (size * nnz * n) // config.spmm_chunk_elements)
        chunk = -(-nnz // nchunks)
        for s in range(0, nnz, chunk):
            e = min(s + chunk, nnz)
            prods = g[..., rows[s:e], :] * b[..., indices[s:e].long(),
                                             :].conj()
            out[:, s:e] = prods.sum(-1)
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
    _launch_k7(indptr, indices, s, alpha, 1, (0, 0, 0), g.data_ptr(),
               b.data_ptr(), out.data_ptr(), g)
    return out


def _launch_k7(indptr, indices, s, alpha, members, strides, g, b, out,
               g_t, shared=1):
    """One launch of K7 (``sdt_csr_sddmm``) for ``members`` members at
    ``strides`` (g, b, out), ``shared`` of them a group (b shared), given
    the addresses; counted in ``csr_sddmm.launches``."""
    m, nnz, n = indptr.numel() - 1, indices.numel(), g_t.shape[-1]
    dt, it = _build.type_codes(g_t, indptr)
    _build.launch(
        "sdt_csr_sddmm", dt, it, indptr.data_ptr(), indices.data_ptr(), g, b,
        out, m, n, nnz, s.vec, s.lanes, s.per_lane, s.round, s.span,
        *_build.scalar_parts(alpha), members, *strides, shared,
        _build.stream_of(g_t),
    )
    csr_sddmm.launches += 1


def sddmm_batched(indptr, indices, g, b, alpha=None, transpose=None):
    """K7 for a batch of members that share the CSR (``indptr``,
    ``indices``): member i is ``alpha * (g_i @ b_i^H)`` at the entries,
    with ``g`` (B, m, n) or (m, n) and ``b`` (B, k, n) or (k, n), at least
    one with the member dimension, each member contiguous; an operand
    without it (or expanded along it) is shared, read in place by every
    member.  Returns a new (B, nnz) tensor.  One launch on the card (one
    per ``_build.MAX_MEMBERS`` members), its schedule ``batched_schedule``;
    counted in ``csr_sddmm.launches`` and ``csr_sddmm.launches_batched``.
    ``transpose``, where given, returns (CSR pattern of A's transpose with
    ``indptr`` and ``indices``, order) as ``formats.CsrPattern.transpose``
    does: with g shared and b not, the launch then runs on it with the
    roles swapped (b's rows held in registers, g's rows gathered once for
    a group of members), alpha conjugated, and its result conjugated into
    the entries' order.  The plain version on the CPU."""
    refuse_views("csr_sddmm", indptr, indices, g, b)
    operands = ((g, 2), (b, 2))
    size = batch_size("csr_sddmm", operands)
    if g.device.type == "cpu":
        return csr_sddmm_batched_plain(indptr, indices, g, b, alpha)
    if not g.is_cuda:
        raise ValueError(f"csr_sddmm: no kernel for device {g.device}")
    check_members("csr_sddmm", (indptr, indices), operands)
    m, nnz = indptr.numel() - 1, indices.numel()
    if g.shape[-2] != m or g.shape[-1] != b.shape[-1]:
        raise ValueError(f"csr_sddmm: g {tuple(g.shape)} and b "
                         f"{tuple(b.shape)} do not fit {m} rows")
    n = g.shape[-1]
    if n > _MAX_N:
        raise ValueError(f"csr_sddmm: n = {n} past the kernel's {_MAX_N}")
    out = torch.empty((size, nnz), dtype=g.dtype, device=g.device)
    if nnz == 0 or size == 0:
        return out
    if n == 0:
        return out.zero_()
    strides = (member_stride("csr_sddmm", g, 2),
               member_stride("csr_sddmm", b, 2), nnz)
    aligned = aligned_members((g, strides[0]), (b, strides[1]))
    index_bytes = indices.element_size()
    if transpose is not None and strides[0] == 0 and strides[1]:
        if batched_schedule(n, g.dtype, nnz, size, (strides[1], 0), aligned,
                            index_bytes)[1] > 1:
            return swapped_roles(transpose(), g, b, alpha, sddmm_batched,
                                 out)
    s, shared = batched_schedule(n, g.dtype, nnz, size, strides, aligned,
                                 index_bytes)
    for first, count in member_chunks(size):
        _launch_k7(indptr, indices, s, alpha, count, strides,
                   *(member_ptr(t, st, first)
                     for t, st in zip((g, b, out), strides)), g,
                   shared)
        csr_sddmm.launches_batched += 1
    return out


csr_sddmm.launches = 0
csr_sddmm.launches_batched = 0
