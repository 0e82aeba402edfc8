"""CSR SpMM (kernel K2) and CSR SpMV (kernel K3).

Each wrapper takes the CSR arrays of op(A), a dense operand and,
optionally, the row plan of those arrays (``formats.csr_plan``; the
containers cache it as ``csr_plan(transpose, spmv)``, and a direct call
builds one).  On a CUDA tensor it launches the hand-written kernel
(``csrc/csr_spmm.cu``, ``csrc/csr_spmv.cu``) or raises; on a CPU tensor it
runs the plain PyTorch version beside it, which is also what the kernel is
checked against on the card.  ``<wrapper>.launches`` counts calls that
launched the kernel.

K2 replaces the TPU's CSR SpMM family in ``sparse_dot_tpu/ops/_xla.py``
(``ell_spmm_binned``, ``ell_spmm``, ``coo_spmm``) and the Pallas probes
in ``experiments/exp_pallas_gather.py`` and
``experiments/exp_pallas_ell_small.py``; K3 replaces ``_xla.ell_spmv``
and ``_xla.coo_spmv``.  Both kernels are bound by the bytes they move
(A's arrays, the gathered rows of B or elements of x, the output) at the
main path's densities; the notes at the top of each ``.cu`` file say how
their designs meet that.  K2's lane mapping is chosen on the host from n,
the value type, the alignment of the pointers and the mean row length
(``spmm_schedule``), with no device read.

``spmm_batched`` runs K2 for a batch of members that share A's pattern
(values, b and c0 each per member or shared) in one launch, the member
on the grid's z dimension: what ``torch.func.vmap`` over the values
(``ops.autograd``) and the transforms built on it reach.  Where b is
shared and the values are not (an ensemble over A's values, a batched
tangent in them), a block serves a group of ``spmm_group`` members
(``csrc/csr_spmm_group.cu``), each strip of b gathered once for the
group.  The helpers
below it (``batch_size``, ``member_stride``, ``member_chunks``) serve the
batched wrappers of K1, K5, K6, K7, K8, K9 and K11 too.
"""

import functools
from typing import NamedTuple

import torch
from torch._C import _functorch
from torch.autograd import forward_ad

from ..config import config
from ..formats import SPMV_TILE, csr_plan, expand_indptr
from . import _build
from .dense import axpby


def refuse_views(name, *tensors):
    """Raise on an operand that a kernel would read wrongly through its
    ``data_ptr()``: a lazy conjugate or negative view (``b.conj()``, whose
    bit the kernels cannot see; ``conj_physical()`` is the form they
    take), or a tensor wrapped by a ``torch.func`` transform, which only
    the ``torch.autograd.Function``s of ``ops/autograd`` may unwrap.
    Checked on both devices, so the CPU's plain versions refuse what the
    card would."""
    for t in tensors:
        if t is None:
            continue
        if t.is_conj() or t.is_neg():
            raise ValueError(
                f"{name}: an operand is a lazy conjugate or negative view; "
                "pass .conj_physical() or .resolve_conj().resolve_neg()")
        if _functorch.is_functorch_wrapped_tensor(t):
            raise ValueError(f"{name}: an operand is wrapped by a "
                             "torch.func transform")


def tracked(*tensors):
    """Whether autograd or a ``torch.func`` transform follows any of
    ``tensors``: one requires grad under grad mode, carries a forward-mode
    tangent, or is wrapped by a transform."""
    grad = torch.is_grad_enabled()
    for t in tensors:
        if t is None:
            continue
        if ((grad and t.requires_grad)
                or _functorch.is_functorch_wrapped_tensor(t)
                or forward_ad.unpack_dual(t).tangent is not None):
            return True
    return False


def refuse_tracked(name, *tensors):
    """Raise on an operand that autograd or a ``torch.func`` transform
    follows (``tracked``), for a wrapper whose result carries no
    gradient: on the card its kernel writes a fresh tensor with no
    ``grad_fn``, so the gradient would be dropped without a word.  Checked
    on both devices, so the CPU's plain versions refuse what the card
    would.  Detach the operand, or take the differentiable entry point
    (``ops.autograd``)."""
    if tracked(*tensors):
        raise ValueError(
            f"{name}: an operand requires grad or is followed by a "
            "torch.func transform, and this kernel carries no gradient; "
            "pass .detach() or use a differentiable entry point")


def _check(name, index_tensors, value_tensors, optional=()):
    """Same CUDA device, contiguous, one index dtype and one value dtype,
    no lazy view (``refuse_views``)."""
    tensors = [*index_tensors, *value_tensors,
               *(t for t in optional if t is not None)]
    refuse_views(name, *tensors)
    device = value_tensors[0].device
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if any(t.dtype != index_tensors[0].dtype for t in index_tensors):
        raise TypeError(f"{name}: indptr and indices dtypes differ")
    values = [*value_tensors, *(t for t in optional if t is not None)]
    if any(t.dtype != values[0].dtype for t in values):
        raise TypeError(f"{name}: value dtypes differ")


def _row_plan(name, plan, indptr, nnz, spmv):
    """``plan``, or the plan of these arrays when None; raises when it was
    built for other arrays or for the other kernel."""
    if plan is None:
        return csr_plan(indptr, nnz, spmv)
    m = indptr.numel() - 1
    if ((plan.nrows, plan.nnz) != (m, nnz) or bool(plan.tiles.numel()) != spmv
            or plan.chunks.device != indptr.device):
        raise ValueError(f"{name}: the row plan is for other arrays")
    return plan


def _pattern(indptr, indices, ncols, plan, spmv):
    """The ``CsrPattern`` of these arrays for a tracked call, cached per
    (indptr, indices, ncols) (``ops.autograd.patterns``), so that a
    training loop sorts A's transpose and builds its plans once; ``plan``,
    when given, is taken as its K2 (K3 with ``spmv``) plan."""
    from .autograd import patterns

    pattern = patterns.get(indptr, indices, ncols)
    if plan is not None:
        pattern.plans.setdefault(spmv, plan)
    return pattern


def _chunk_args(plan):
    """(counts, chunks, n_chunks) of the plan for the C interface."""
    return plan.counts.data_ptr(), plan.chunks.data_ptr(), plan.slots


def _add_rows(out, rows, src, dim=0):
    """``out[rows] += src`` row by row along ``dim``.  Complex values are
    added on their real view: ``index_add_`` on a complex tensor
    multiplies src by alpha = 1+0j, and (1+0j)(inf+nanj) has a nan real
    part where scipy keeps inf+nanj."""
    if out.is_complex():
        torch.view_as_real(out).index_add_(dim, rows,
                                           torch.view_as_real(src))
    else:
        out.index_add_(dim, rows, src)


# ---------------------------------------------------------------------------
# Batches: members that share one pattern, one launch (K1, K2, K7, K8)
# ---------------------------------------------------------------------------


def batch_size(name, operands):
    """The members of a batched call: the leading size of every operand
    given with a member dimension ahead of its own ``core`` dimensions
    (``operands``: (tensor or None, core) pairs); these must agree, and
    at least one operand must have it."""
    sizes = {t.shape[0] for t, core in operands
             if t is not None and t.dim() == core + 1}
    if len(sizes) != 1:
        raise ValueError(f"{name}: batched operands of sizes {sorted(sizes)}"
                         "; need one member dimension of one size")
    return sizes.pop()


def member_stride(name, t, core):
    """Operand ``t``'s member stride in elements: 0 when it has only its
    ``core`` dimensions (shared: every member reads it in place, and it
    is never copied) or is expanded along the members, else
    ``t.stride(0)``, each member contiguous."""
    if t is None or t.dim() == core:
        return 0
    if t.dim() != core + 1 or (t.shape[0] and not t[0].is_contiguous()):
        raise ValueError(f"{name}: a batched operand of {tuple(t.shape)} "
                         f"needs {core} contiguous dimensions a member")
    return t.stride(0)


def member_chunks(size, most=None):
    """(first member, members) of each launch of a batch of ``size``:
    launches of at most ``most`` members, ``_build.MAX_MEMBERS`` (the
    grid's limit) when None or larger."""
    most = min(most or _build.MAX_MEMBERS, _build.MAX_MEMBERS)
    return [(s, min(most, size - s)) for s in range(0, size, most)]


def member_groups(size, group):
    """(first member, members) of each group of ``group`` members that
    one block serves (the kernels' group ``blockIdx * group``): whole
    groups, then a part-full last one where ``group`` does not divide
    ``size``, whose missing members read the last member's values and
    store nothing."""
    return [(s, min(group, size - s)) for s in range(0, size, group)]


def member_ptr(t, stride, first):
    """The address of member ``first`` of ``t`` (None for None)."""
    if t is None:
        return None
    return t.data_ptr() + first * stride * t.element_size()


def aligned_members(*pairs):
    """Whether every member of each (tensor, member stride) starts on 16
    bytes: its first does and the stride is whole 16-byte units."""
    return all(t.data_ptr() % 16 == 0 and (st * t.element_size()) % 16 == 0
               for t, st in pairs if t is not None)


def check_members(name, index_tensors, operands, views=True):
    """``_check`` for a batched call: one CUDA device, one index and one
    value dtype, no lazy view (``views=False``: the caller ran
    ``refuse_views`` on these tensors), each operand's members contiguous
    (``member_stride``).  Returns the operands' member strides."""
    values = [t for t, _ in operands if t is not None]
    if views:
        refuse_views(name, *index_tensors, *values)
    device = values[0].device
    for t in (*index_tensors, *values):
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
    if not all(t.is_contiguous() for t in index_tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    strides = [member_stride(name, t, core) for t, core in operands]
    if any(t.dtype != index_tensors[0].dtype for t in index_tensors):
        raise TypeError(f"{name}: indptr and indices dtypes differ")
    if any(t.dtype != values[0].dtype for t in values):
        raise TypeError(f"{name}: value dtypes differ")
    return strides


# ---------------------------------------------------------------------------
# K2: CSR SpMM
# ---------------------------------------------------------------------------


def csr_spmm_plain(indptr, indices, data, b, alpha=None, beta=None, c0=None):
    """``alpha * A @ b + beta * c0`` in plain PyTorch: gather the B rows
    of each nonzero, scale, ``index_add_`` into the rows of C (the
    ``_xla.coo_spmm`` scatter), chunked over nnz so the gathered
    intermediate stays under ``config.spmm_chunk_elements`` elements."""
    m, n = indptr.numel() - 1, b.shape[1]
    nnz = indices.numel()
    c = torch.zeros((m, n), dtype=b.dtype, device=b.device)
    if nnz and n:
        rows = expand_indptr(indptr, nnz)
        nchunks = max(1, (nnz * n) // config.spmm_chunk_elements)
        chunk = -(-nnz // nchunks)
        for s in range(0, nnz, chunk):
            e = min(s + chunk, nnz)
            gathered = data[s:e, None] * b[indices[s:e].long()]
            _add_rows(c, rows[s:e], gathered)
    return axpby(c, alpha, beta, c0)


def csr_spmm_batched_plain(indptr, indices, data, b, alpha=None, beta=None,
                           c0=None):
    """``spmm_batched`` in plain PyTorch, vectorised over the members:
    ``csr_spmm_plain``'s gather, scale and ``index_add_`` with a member
    dimension ahead (shared operands broadcast), chunked over nnz so the
    gathered intermediate of all members stays under
    ``config.spmm_chunk_elements`` elements."""
    size = batch_size("csr_spmm", ((data, 1), (b, 2), (c0, 2)))
    m, n = indptr.numel() - 1, b.shape[-1]
    nnz = indices.numel()
    c = torch.zeros((size, m, n), dtype=b.dtype, device=b.device)
    if nnz and n and size:
        rows = expand_indptr(indptr, nnz)
        nchunks = max(1, (size * nnz * n) // config.spmm_chunk_elements)
        chunk = -(-nnz // nchunks)
        for s in range(0, nnz, chunk):
            e = min(s + chunk, nnz)
            gathered = data[..., s:e, None] * b[..., indices[s:e].long(), :]
            _add_rows(c, rows[s:e], gathered.expand(size, e - s, n), dim=1)
    return axpby(c, alpha, beta, c0)


class SpmmSchedule(NamedTuple):
    """K2's lane mapping.  A lane reads ``vec`` adjacent columns of a B
    row in one 16-byte load (1 column, a scalar load, off the vector
    path); ``lanes`` lanes cover ``per_lane`` such loads each of a row's
    strip of ``lanes * per_lane * vec`` columns, and ``strips`` strips
    cover n; ``split`` groups of ``lanes`` lanes share a row, each taking
    every ``split``-th nonzero, and add their sums with shuffles at the
    end.  A warp holds 32 // (lanes * split) rows."""

    vec: int
    lanes: int
    split: int
    per_lane: int
    strips: int


def spmm_schedule(n, dtype, mean_row, aligned=True):
    """The ``SpmmSchedule`` for n columns of ``dtype`` and rows of
    ``mean_row`` nonzeros on average.  The 16-byte path needs rows of B,
    C0 and C that are whole 16-byte units (n * itemsize % 16 == 0) and
    ``aligned`` pointers; a row takes the power of two of lanes at or
    above the loads it needs, at most 32, and a lane up to two loads; the
    lanes left in the warp split the nonzeros of long rows (about 4 or
    more per lane) or else hold more rows."""
    itemsize = dtype.itemsize
    vec = 16 // itemsize if aligned and (n * itemsize) % 16 == 0 else 1
    loads = -(-n // vec)
    lanes = 1
    while lanes < min(loads, 32):
        lanes *= 2
    per_lane = 2 if loads > lanes else 1
    strips = -(-n // (lanes * per_lane * vec))
    split = 1
    while split * 2 <= min(32 // lanes, mean_row / 4):
        split *= 2
    return SpmmSchedule(vec, lanes, split, per_lane, strips)


# Members a block serves where b is shared, by (value type, index bytes),
# where the card timed fewer faster than 4: f32 at config 1 (n = 128) ran
# 4 and 16 value sets 3-4% faster at 2 than at 4, with either index width
# (PERF.md).
_K2_FEWER_MEMBERS = {(torch.float32, 4): 2, (torch.float32, 8): 2}


def spmm_group(s, dtype, index_bytes=4, size=4):
    """Members a block of K2's group instance serves at once where b is
    shared and the values are not, for the ``SpmmSchedule`` ``s``: 4,
    fewer where ``_K2_FEWER_MEMBERS`` says so for the value type and
    index bytes, 2 for a batch of 2, 1 (the per-member instance) for a
    batch of 1.  Each member keeps ``per_lane * vec`` sums a lane beside
    the single kernel's registers; a group keeps the single kernel's lane
    mapping, so each member's output has its single launch's bits."""
    if size < 2:
        return 1
    most = _K2_FEWER_MEMBERS.get((dtype, index_bytes), 4)
    return min(most, 2 if size == 2 else 4)


@functools.lru_cache(maxsize=256)
def batched_plan(n, dtype, mean_row, aligned, index_bytes, size, shared_b,
                 per_member_values):
    """(``SpmmSchedule``, members a block) of a batched K2 launch of
    ``size`` members: ``spmm_schedule``'s lanes, and ``spmm_group``'s
    members where b is shared and the values are per member, else 1.
    Cached, so that a training loop's calls plan once."""
    s = spmm_schedule(n, dtype, mean_row, aligned)
    group = (spmm_group(s, dtype, index_bytes, size)
             if shared_b and per_member_values else 1)
    return s, group


def csr_spmm(indptr, indices, data, b, alpha=None, beta=None, c0=None,
             plan=None):
    """``alpha * A @ b + beta * c0`` for CSR A (``indptr`` of m + 1,
    ``indices``, ``data``) and row-major ``b`` of (k, n); ``c0`` is (m, n)
    or None.  ``plan`` is ``formats.csr_plan`` of these arrays (K2's);
    built here when None.  Returns a new (m, n) tensor.

    When autograd or a ``torch.func`` transform follows ``data``, ``b`` or
    ``c0`` (``tracked``), the call goes through ``ops.autograd.CsrSpmm``
    on either device, so the result carries its gradient (K7 and K2 over
    A^H on the card); otherwise it is the kernel (the plain version on
    the CPU) alone."""
    if tracked(data, b, c0):
        from .autograd import CsrSpmm

        pattern = _pattern(indptr, indices, b.shape[0], plan, spmv=False)
        return CsrSpmm.apply(pattern, data, b, alpha, beta, c0)
    return spmm(indptr, indices, data, b, alpha, beta, c0, plan)


def spmm(indptr, indices, data, b, alpha=None, beta=None, c0=None,
         plan=None):
    """``csr_spmm`` without autograd: K2 on the card, the plain version on
    the CPU; counted in ``csr_spmm.launches``."""
    refuse_views("csr_spmm", indptr, indices, data, b, c0)
    if b.device.type == "cpu":
        return csr_spmm_plain(indptr, indices, data, b, alpha, beta, c0)
    if not b.is_cuda:
        raise ValueError(f"csr_spmm: no kernel for device {b.device}")
    _check("csr_spmm", (indptr, indices), (data, b), (c0,))
    m, n = indptr.numel() - 1, b.shape[1]
    if c0 is not None and tuple(c0.shape) != (m, n):
        raise ValueError(f"csr_spmm: c0 is {tuple(c0.shape)}, need {(m, n)}")
    c = torch.empty((m, n), dtype=b.dtype, device=b.device)
    if m == 0 or n == 0:
        return c
    nnz = indices.numel()
    plan = _row_plan("csr_spmm", plan, indptr, nnz, spmv=False)
    aligned = all(t.data_ptr() % 16 == 0
                  for t in (b, c, c0) if t is not None)
    s = spmm_schedule(n, b.dtype, nnz / m, aligned)
    counts, chunks, n_chunks = _chunk_args(plan)
    # Partial rows of the chunks of split rows; untouched when none is.
    work = (torch.empty((plan.slots, n), dtype=b.dtype, device=b.device)
            if n_chunks else None)
    _launch_k2(indptr, indices, plan, s, alpha, beta, c0 is not None, 1,
               (0, 0, 0, 0), data.data_ptr(), b.data_ptr(),
               None if c0 is None else c0.data_ptr(), c.data_ptr(),
               None if work is None else work.data_ptr(), counts, data, b)
    return c


def _launch_k2(indptr, indices, plan, s, alpha, beta, with_c0, members,
               strides, data, b, c0, c, work, counts, data_t, b_t, group=1):
    """One launch of K2 for ``members`` members at ``strides`` (values, b,
    c0, c), given the addresses: ``sdt_csr_spmm`` (one member a block),
    or with ``group`` > 1 ``sdt_csr_spmm_group`` (b shared, ``group``
    members a block); counted in ``csr_spmm.launches``, the group
    launches also in ``csr_spmm.launches_group``."""
    _, chunks, n_chunks = _chunk_args(plan)
    m, n = indptr.numel() - 1, b_t.shape[-1]
    dt, it = _build.type_codes(data_t, indptr)
    head = (dt, it, indptr.data_ptr(), indices.data_ptr(), data, b, c0, c,
            work, counts, chunks, n_chunks, m, n, plan.chunk, s.vec,
            s.lanes, s.split, s.per_lane, *_build.scalar_parts(alpha),
            *_build.scalar_parts(beta if with_c0 else 0.0), members)
    if group == 1:
        _build.launch("sdt_csr_spmm", *head, *strides, _build.stream_of(b_t))
    else:
        if strides[1]:
            raise ValueError("csr_spmm: a group of members needs b shared")
        _build.launch("sdt_csr_spmm_group", *head, strides[0], *strides[2:],
                      group, _build.stream_of(b_t))
        csr_spmm.launches_group += 1
    csr_spmm.launches += 1


def spmm_batched(indptr, indices, data, b, alpha=None, beta=None, c0=None,
                 plan=None):
    """K2 for a batch of members that share the CSR (``indptr``,
    ``indices``): member i is ``alpha * A_i @ b_i + beta * c0_i``, A_i
    with values ``data[i]``.  ``data`` is (B, nnz) or (nnz,), ``b`` (B, k,
    n) or (k, n), ``c0`` (B, m, n), (m, n) or None; at least one has the
    member dimension, and each member is contiguous.  An operand without
    it, or expanded along it, is shared: every member reads it in place.
    Returns a new (B, m, n) tensor.  One launch on the card (one per
    ``_build.MAX_MEMBERS`` members), each member with its own counts and
    workspace for split rows; where b is shared and the values are not,
    ``spmm_group`` members a block (``batched_plan``); counted in
    ``csr_spmm.launches`` and ``csr_spmm.launches_batched``.  The plain
    version on the CPU."""
    refuse_views("csr_spmm", indptr, indices, data, b, c0)
    operands = ((data, 1), (b, 2), (c0, 2))
    size = batch_size("csr_spmm", operands)
    if b.device.type == "cpu":
        return csr_spmm_batched_plain(indptr, indices, data, b, alpha, beta,
                                      c0)
    if not b.is_cuda:
        raise ValueError(f"csr_spmm: no kernel for device {b.device}")
    strides = check_members("csr_spmm", (indptr, indices), operands,
                            views=False)
    m, nnz, n = indptr.numel() - 1, indices.numel(), b.shape[-1]
    if data.shape[-1] != nnz or (
            c0 is not None and tuple(c0.shape[-2:]) != (m, n)):
        raise ValueError(f"csr_spmm: values {tuple(data.shape)} and c0 "
                         f"{None if c0 is None else tuple(c0.shape)} do not "
                         f"fit {nnz} entries and ({m}, {n})")
    c = torch.empty((size, m, n), dtype=b.dtype, device=b.device)
    if m == 0 or n == 0 or size == 0:
        return c
    plan = _row_plan("csr_spmm", plan, indptr, nnz, spmv=False)
    strides = (*strides, m * n)
    s, group = batched_plan(
        n, b.dtype, nnz / m, aligned_members(
            (b, strides[1]), (c0, strides[2]), (c, strides[3])),
        indices.element_size(), size, strides[1] == 0, strides[0] != 0)
    for first, count in member_chunks(size):
        # Each member's own counts (zeroed) and partial rows of split rows.
        counts = work = None
        if plan.slots:
            counts = torch.zeros((count, plan.slots), dtype=torch.int32,
                                 device=b.device)
            work = torch.empty((count, plan.slots, n), dtype=b.dtype,
                               device=b.device)
        _launch_k2(indptr, indices, plan, s, alpha, beta, c0 is not None,
                   count, strides, *(member_ptr(t, st, first) for t, st in
                                     zip((data, b, c0, c), strides)),
                   None if work is None else work.data_ptr(),
                   None if counts is None else counts.data_ptr(), data, b,
                   group if group == 1 else spmm_group(
                       s, b.dtype, indices.element_size(), count))
        csr_spmm.launches_batched += 1
    return c


csr_spmm.launches = 0
csr_spmm.launches_batched = 0
csr_spmm.launches_group = 0


# ---------------------------------------------------------------------------
# K3: CSR SpMV
# ---------------------------------------------------------------------------


def csr_spmv_plain(indptr, indices, data, x, alpha=None, beta=None, y0=None):
    """``alpha * A @ x + beta * y0`` in plain PyTorch: gather, scale and
    ``index_add_`` by row (the ``_xla.coo_spmv`` scatter)."""
    m = indptr.numel() - 1
    y = torch.zeros((m,), dtype=x.dtype, device=x.device)
    nnz = indices.numel()
    if nnz:
        _add_rows(y, expand_indptr(indptr, nnz), data * x[indices.long()])
    return axpby(y, alpha, beta, y0)


def csr_spmv(indptr, indices, data, x, alpha=None, beta=None, y0=None,
             plan=None):
    """``alpha * A @ x + beta * y0`` for CSR A and 1-d ``x`` of (k,);
    ``y0`` is (m,) or None.  ``plan`` is ``formats.csr_plan(..., spmv=True)``
    of these arrays (K3's tiles); built here when None.  Returns a new
    (m,) tensor.  Tracked operands go through ``ops.autograd.CsrSpmv``,
    as in ``csr_spmm``."""
    if tracked(data, x, y0):
        from .autograd import CsrSpmv

        pattern = _pattern(indptr, indices, x.shape[0], plan, spmv=True)
        return CsrSpmv.apply(pattern, data, x, alpha, beta, y0)
    return spmv(indptr, indices, data, x, alpha, beta, y0, plan)


def spmv(indptr, indices, data, x, alpha=None, beta=None, y0=None,
         plan=None):
    """``csr_spmv`` without autograd: K3 on the card, the plain version on
    the CPU; counted in ``csr_spmv.launches``."""
    refuse_views("csr_spmv", indptr, indices, data, x, y0)
    if x.device.type == "cpu":
        return csr_spmv_plain(indptr, indices, data, x, alpha, beta, y0)
    if not x.is_cuda:
        raise ValueError(f"csr_spmv: no kernel for device {x.device}")
    _check("csr_spmv", (indptr, indices), (data, x), (y0,))
    m = indptr.numel() - 1
    if x.dim() != 1 or (y0 is not None and tuple(y0.shape) != (m,)):
        raise ValueError("csr_spmv: x and y0 must be 1-d, y0 of length m")
    y = torch.empty((m,), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    plan = _row_plan("csr_spmv", plan, indptr, indices.numel(), spmv=True)
    counts, chunks, n_chunks = _chunk_args(plan)
    # One partial sum per chunk of a split row.
    work = (torch.empty(plan.slots, dtype=x.dtype, device=x.device)
            if n_chunks else None)
    dt, it = _build.type_codes(data, indptr)
    _build.launch(
        "sdt_csr_spmv", dt, it, indptr.data_ptr(), indices.data_ptr(),
        data.data_ptr(), x.data_ptr(),
        None if y0 is None else y0.data_ptr(), y.data_ptr(),
        None if work is None else work.data_ptr(), counts,
        plan.tiles.data_ptr(), plan.tiles.shape[0], chunks, n_chunks, m,
        SPMV_TILE,
        *_build.scalar_parts(alpha),
        *_build.scalar_parts(0.0 if y0 is None else beta),
        _build.stream_of(x),
    )
    csr_spmv.launches += 1
    return y


csr_spmv.launches = 0
