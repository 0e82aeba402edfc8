"""BSR SpMM (kernel K1) and block SDDMM (kernel K8), its gradient in the
blocks.

Port of ``sparse_dot_tpu/ops/pallas_bsr.py`` ``bsr_spmm_pallas`` (the
JAX package's one Pallas kernel) and of its XLA fallback
``_xla.bsr_spmm``.  On a CUDA tensor the wrapper launches one of K1's two
hand-written variants or raises; on a CPU tensor it runs the plain
PyTorch version beside them, which is also what both are checked against
on the card.

The variant follows the value type and the block size
(``uses_tensor_cores``), a choice on shape, not a fallback:

- blocks of a multiple of 8 take the tensor-core variant
  (``csrc/bsr_spmm.cu``): f64 MMA, 3xTF32 for f32 (about f32's own
  precision; never plain TF32), complex values as four real products a
  step on their parts (c128 on f64 MMA, c64 on 3xTF32), a cp.async ring
  of tiles, one thread block per (chunk of a block row, 64 columns) up to
  128 rows tall (complex 32), and block rows longer than the chunk plan's
  S stored blocks (``formats.bsr_chunk_plan``) summed from partial tiles
  in chunk order, so results do not change from run to run;
- other block sizes take the port's first, CUDA-core variant
  (``csrc/bsr_spmm_simt.cu``): any square bs, any n, plain FMA.

Complex products in both variants, and in the plain versions, follow
numpy's component formula (``_component_matmul``): the nan, +inf and
-inf of a result are those of the real products of the parts.

``bsr_spmm.launches`` counts launches of either variant;
``bsr_spmm.launches_tc`` and ``bsr_spmm.launches_simt`` count each, and
``launches_tc_complex`` the tensor-core launches on complex values.  The
notes at the top of the ``.cu`` files say what bounds each variant and
how its tiles are laid out.

K8 (``bsr_sddmm``) gives each stored block's gradient, G's block row
times the conjugate transpose of B's block row; it replaces ``jax.grad``
of ``_xla.bsr_spmm`` in the blocks.  It is split as K1 is, by the same
predicate (``uses_tensor_cores``), chosen before the launch:

- blocks of a multiple of 8 on the tensor cores (``csrc/bsr_sddmm.cu``):
  K1's arithmetic (``csrc/mma.cuh``) in every value type, a thread block
  a tile of at most 64 x 64 (complex 32 x 32) of a stored block, G's and
  B's strips streamed through a ``cp.async`` ring of 2 chunks;
- other block sizes on the CUDA cores (``csrc/bsr_sddmm_simt.cu``):
  strips staged in shared memory 16 columns at a time, plain FMA.

``bsr_sddmm.launches`` counts launches of either variant,
``bsr_sddmm.launches_tc`` and ``bsr_sddmm.launches_simt`` each, and
``launches_tc_complex`` the tensor-core launches on complex values.
``bsr_spmm`` takes ``ops.autograd.BsrSpmm`` when an operand is tracked,
whose backward runs K8 and K1 over A^H.

``spmm_batched`` and ``sddmm_batched`` run either kernel, in the variant
the value type and bs name, for a batch of members that share A's
pattern (blocks, b, c0 or g each per member or shared) in one launch, the
member on the grid's z dimension: what ``torch.func.vmap`` over the
blocks and the transforms built on it reach (``ops.autograd``).  Each
member of K1's tensor-core variant has its own workspace slots for split
block rows; the chunk plan is shared.  Where the members share b and not
their blocks (real values on the tensor cores), a thread block serves a
group of ``spmm_group`` members (``csrc/bsr_spmm_group.cu``): one chunk
of b staged and its fragments loaded once for the group.
"""

import torch

from ..config import config
from ..formats import bsr_chunk_plan, expand_indptr
from . import _build
from .csr import (_add_rows, _check, batch_size, check_members,
                  member_chunks, member_ptr, member_stride, refuse_tracked,
                  refuse_views, tracked)
from .dense import axpby, ieee_matmul


def _component_matmul(a, b):
    """``a @ b`` (``torch.matmul``, leading dimensions broadcast); complex
    operands go in as one real product of their parts side by side,
    [Ar, Ai] @ [[Br, Bi], [-Bi, Br]], so that each product follows
    numpy's component formula, as the kernels do (cuBLAS's complex GEMM
    gives nan + nanj where that formula gives +-inf +-infj).  On the CPU
    only where a value is not finite: finite ones take the complex
    product there, 2.6 to 5 times faster (PERF.md), and a sum that
    overflows only sends them the slower way; on the card the check
    would cost a host sync."""
    if not a.is_complex() or (not a.is_cuda and bool(
            torch.isfinite(torch.stack([a.sum(), b.sum()])).all())):
        return torch.matmul(a, b)
    n = b.shape[-1]
    a2 = torch.cat([a.real, a.imag], -1)
    b2 = torch.cat([torch.cat([b.real, b.imag], -1),
                    torch.cat([-b.imag, b.real], -1)], -2)
    out = torch.matmul(a2, b2)
    return torch.complex(out[..., :n], out[..., n:])


def bsr_spmm_plain(indptr, indices, data, b, alpha=None, beta=None, c0=None):
    """``alpha * A @ b + beta * c0`` in plain PyTorch: gather the B panel
    of every stored block, one batched matmul (``_component_matmul``),
    ``index_add_`` of the block rows (``_xla.bsr_spmm``)."""
    nblocks, bs, _ = data.shape
    nbrows = indptr.numel() - 1
    k, n = b.shape
    c = torch.zeros((nbrows, bs, n), dtype=b.dtype, device=b.device)
    if nblocks and n:
        if b.is_cuda:
            ieee_matmul()
        panels = b.reshape(k // bs, bs, n)[indices.long()]
        _add_rows(c, expand_indptr(indptr, nblocks),
                  _component_matmul(data, panels))
    return axpby(c.reshape(nbrows * bs, n), alpha, beta, c0)


def bsr_spmm_batched_plain(indptr, indices, data, b, alpha=None, beta=None,
                           c0=None):
    """``spmm_batched`` in plain PyTorch, vectorised over the members:
    ``bsr_spmm_plain``'s gathered panels and batched matmul with a member
    dimension ahead (shared operands broadcast), one ``index_add_`` of
    the block rows."""
    size = batch_size("bsr_spmm", ((data, 3), (b, 2), (c0, 2)))
    nblocks, bs = data.shape[-3], data.shape[-1]
    nbrows = indptr.numel() - 1
    k, n = b.shape[-2:]
    c = torch.zeros((size, nbrows, bs, n), dtype=b.dtype, device=b.device)
    if nblocks and n and size:
        if b.is_cuda:
            ieee_matmul()
        panels = b.reshape(*b.shape[:-2], k // bs, bs, n)[
            ..., indices.long(), :, :]
        prods = _component_matmul(data, panels)
        _add_rows(c, expand_indptr(indptr, nblocks),
                  prods.expand(size, nblocks, bs, n), dim=1)
    return axpby(c.reshape(size, nbrows * bs, n), alpha, beta, c0)


def uses_tensor_cores(dtype, bs):
    """Whether K1 and K8 run on the tensor cores for values of ``dtype``
    in ``bs`` x ``bs`` blocks (else on the CUDA cores): blocks of a
    multiple of 8, in every value type (c64's 3xTF32 measured faster than
    the CUDA cores at phase 3's complex BSR, PERF.md)."""
    return bs % 8 == 0


# Members a block of K1's group instance, by value type: the fastest the
# card timed at config 3 over 4 block sets (PERF.md: f64 at 2 members 6%
# faster than one a block and than 4; f32 at 4 15% faster than one; on
# 32-row tiles both slower).
_K1_GROUP = {torch.float32: 4, torch.float64: 2}


def spmm_group(dtype, bs, size, shared_b=True, per_member_blocks=True):
    """Members a block of a batched K1 launch of ``size`` members: where b
    is shared and the blocks are per member, on the tensor cores in f32
    or f64, ``_K1_GROUP``'s (2 for a batch of 2), else 1, the per-member
    instance.  Each member keeps its own accumulators; the group keeps
    each member's MMAs in its single launch's order, so each member has
    its single launch's bits."""
    if (size < 2 or not shared_b or not per_member_blocks
            or dtype not in _K1_GROUP or not uses_tensor_cores(dtype, bs)):
        return 1
    return min(_K1_GROUP[dtype], 2 if size == 2 else 4)


def bsr_spmm(indptr, indices, data, b, alpha=None, beta=None, c0=None,
             plan=None):
    """``alpha * A @ b + beta * c0`` for BSR A (block ``indptr`` of
    nbrows + 1, block-column ``indices``, ``data`` of (nblocks, bs, bs))
    and row-major ``b`` of (k, n) with k % bs == 0; ``c0`` is
    (nbrows * bs, n) or None.  ``plan`` is ``bsr_chunk_plan`` of these
    arrays (for example ``BSR.bsr_plan``, cached); it is built here when
    None and the tensor-core variant needs it.  Returns a new
    (nbrows * bs, n) tensor.

    When autograd or a ``torch.func`` transform follows ``data``, ``b`` or
    ``c0`` (``csr.tracked``), the call goes through
    ``ops.autograd.BsrSpmm`` on either device, with A's ``BsrPattern``
    cached per index tensors (``autograd.bsr_patterns``), so the result
    carries its gradient (K8 and K1 over A^H on the card); otherwise it is
    the kernel (the plain version on the CPU) alone."""
    if tracked(data, b, c0):
        from .autograd import BsrSpmm, bsr_patterns

        if data.dim() != 3 or b.dim() != 2:
            raise ValueError(f"bsr_spmm: blocks {tuple(data.shape)} and b "
                             f"{tuple(b.shape)} must be 3-d and 2-d")
        bs = data.shape[1]
        pattern = bsr_patterns.get(indptr, indices, b.shape[0] // bs, bs)
        pattern.plan(plan)
        return BsrSpmm.apply(pattern, data, b, alpha, beta, c0)
    return spmm(indptr, indices, data, b, alpha, beta, c0, plan)


def spmm(indptr, indices, data, b, alpha=None, beta=None, c0=None,
         plan=None):
    """``bsr_spmm`` without autograd: K1 on the card, the plain version on
    the CPU; counted in ``bsr_spmm.launches`` (and ``launches_tc`` or
    ``launches_simt``)."""
    refuse_views("bsr_spmm", indptr, indices, data, b, c0)
    if b.device.type == "cpu":
        return bsr_spmm_plain(indptr, indices, data, b, alpha, beta, c0)
    if not b.is_cuda:
        raise ValueError(f"bsr_spmm: no kernel for device {b.device}")
    _check("bsr_spmm", (indptr, indices), (data, b), (c0,))
    if (data.dim() != 3 or data.shape[1] != data.shape[2] or b.dim() != 2
            or b.shape[0] % data.shape[1]):
        raise ValueError(
            f"bsr_spmm: blocks {tuple(data.shape)} must be square and "
            f"divide b's rows {tuple(b.shape)}"
        )
    nbrows, bs, n = indptr.numel() - 1, data.shape[1], b.shape[1]
    m = nbrows * bs
    if c0 is not None and tuple(c0.shape) != (m, n):
        raise ValueError(f"bsr_spmm: c0 is {tuple(c0.shape)}, need {(m, n)}")
    c = torch.empty((m, n), dtype=b.dtype, device=b.device)
    if m == 0 or n == 0:
        return c
    plan = (_chunk_plan(plan, indptr, data.shape[0], b.device)
            if uses_tensor_cores(data.dtype, bs) else None)
    _launch_k1(indptr, indices, plan, alpha, beta, c0 is not None, 1,
               (0, 0, 0, 0), data.data_ptr(), b.data_ptr(),
               None if c0 is None else c0.data_ptr(), c.data_ptr(), data, b)
    return c


def _chunk_plan(plan, indptr, nblocks, device):
    """``plan``, or the chunk plan of these arrays when None (K1's tensor
    cores); raises when it was built for other arrays."""
    if plan is None:
        plan = bsr_chunk_plan(indptr, nblocks)
    if ((plan.nbrows, plan.nblocks) != (indptr.numel() - 1, nblocks)
            or plan.items.device != device):
        raise ValueError("bsr_spmm: the chunk plan is for other arrays")
    return plan


def _launch_k1(indptr, indices, plan, alpha, beta, with_c0, members,
               strides, data, b, c0, c, data_t, b_t, group=1):
    """One launch of K1 for ``members`` members at ``strides`` (blocks, b,
    c0, c), given the addresses: on the tensor cores with ``plan``, the
    chunk plan (each member with its own workspace slots for the partial
    tiles of split block rows), on the CUDA cores when it is None.
    ``group``: members a block, ``sdt_bsr_spmm_tc_group`` (b shared)
    where it is more than one.  Counted in ``bsr_spmm.launches`` and
    ``launches_tc`` or ``launches_simt``, a group launch also in
    ``launches_group``."""
    bs, n = data_t.shape[-1], b_t.shape[-1]
    dt, it = _build.type_codes(data_t, indptr)
    scalars = (*_build.scalar_parts(alpha),
               *_build.scalar_parts(beta if with_c0 else 0.0))
    if plan is not None:
        n_splits = plan.splits.shape[0]
        # Untouched when no block row is split.
        work = (torch.empty((members, plan.slots, bs, n), dtype=b_t.dtype,
                            device=b_t.device) if n_splits else None)
        head = (dt, it, plan.items.data_ptr(), plan.items.shape[0],
                plan.splits.data_ptr(), n_splits, indices.data_ptr(), data,
                b, c0, c, None if work is None else work.data_ptr(),
                plan.slots, bs, n, *scalars, members)
        if group == 1:
            _build.launch("sdt_bsr_spmm_tc", *head, *strides,
                          _build.stream_of(b_t))
        else:
            if strides[1]:
                raise ValueError("bsr_spmm: a group of members needs b "
                                 "shared")
            _build.launch("sdt_bsr_spmm_tc_group", *head, strides[0],
                          *strides[2:], group, _build.stream_of(b_t))
            bsr_spmm.launches_group += 1
        bsr_spmm.launches_tc += 1
        bsr_spmm.launches_tc_complex += b_t.is_complex()
    else:
        _build.launch(
            "sdt_bsr_spmm_simt", dt, it, indptr.data_ptr(),
            indices.data_ptr(), data, b, c0, c, indptr.numel() - 1, bs, n,
            *scalars, members, *strides, _build.stream_of(b_t),
        )
        bsr_spmm.launches_simt += 1
    bsr_spmm.launches += 1


def spmm_batched(indptr, indices, data, b, alpha=None, beta=None, c0=None,
                 plan=None):
    """K1 for a batch of members that share the BSR (``indptr``,
    ``indices``): member i is ``alpha * A_i @ b_i + beta * c0_i``, A_i with
    blocks ``data[i]``.  ``data`` is (B, nblocks, bs, bs) or (nblocks, bs,
    bs), ``b`` (B, k, n) or (k, n), ``c0`` (B, m, n), (m, n) or None; at
    least one has the member dimension, and each member is contiguous.
    An operand without it (or expanded along it) is shared, read in place
    by every member.  Returns a new (B, m, n) tensor.  One launch of the
    variant ``uses_tensor_cores`` names (one per ``_build.MAX_MEMBERS``
    members; the tensor-core variant's split block rows add their partial
    tiles in a second kernel of the same call, each member in its own
    workspace slots), counted as ``spmm``'s and in
    ``bsr_spmm.launches_batched`` (and ``launches_batched_tc`` or
    ``launches_batched_simt``).  Where b is shared and the blocks are
    not, real values on the tensor cores, ``spmm_group`` members a block.
    The plain version on the CPU."""
    refuse_views("bsr_spmm", indptr, indices, data, b, c0)
    operands = ((data, 3), (b, 2), (c0, 2))
    size = batch_size("bsr_spmm", operands)
    if b.device.type == "cpu":
        return bsr_spmm_batched_plain(indptr, indices, data, b, alpha, beta,
                                      c0)
    if not b.is_cuda:
        raise ValueError(f"bsr_spmm: no kernel for device {b.device}")
    check_members("bsr_spmm", (indptr, indices), operands)
    nbrows, bs, n = indptr.numel() - 1, data.shape[-1], b.shape[-1]
    m, nblocks = nbrows * bs, data.shape[-3]
    if (data.shape[-2] != bs or b.shape[-2] % bs or nblocks != indices.numel()
            or (c0 is not None and tuple(c0.shape[-2:]) != (m, n))):
        raise ValueError(
            f"bsr_spmm: blocks {tuple(data.shape)}, b {tuple(b.shape)} and "
            f"c0 {None if c0 is None else tuple(c0.shape)} do not fit")
    c = torch.empty((size, m, n), dtype=b.dtype, device=b.device)
    if m == 0 or n == 0 or size == 0:
        return c
    tc = uses_tensor_cores(data.dtype, bs)
    plan = _chunk_plan(plan, indptr, nblocks, b.device) if tc else None
    strides = (member_stride("bsr_spmm", data, 3),
               member_stride("bsr_spmm", b, 2),
               member_stride("bsr_spmm", c0, 2), m * n)
    for first, count in member_chunks(size):
        _launch_k1(indptr, indices, plan, alpha, beta, c0 is not None,
                   count, strides, *(member_ptr(t, st, first) for t, st in
                                     zip((data, b, c0, c), strides)),
                   data, b, spmm_group(data.dtype, bs, count,
                                       strides[1] == 0, strides[0] != 0))
        bsr_spmm.launches_batched += 1
        if tc:
            bsr_spmm.launches_batched_tc += 1
            bsr_spmm.launches_batched_tc_complex += b.is_complex()
        else:
            bsr_spmm.launches_batched_simt += 1
    return c


bsr_spmm.launches = 0
bsr_spmm.launches_tc = 0
bsr_spmm.launches_tc_complex = 0
bsr_spmm.launches_simt = 0
bsr_spmm.launches_batched = 0
bsr_spmm.launches_batched_tc = 0
bsr_spmm.launches_batched_tc_complex = 0
bsr_spmm.launches_batched_simt = 0
bsr_spmm.launches_group = 0


# ---------------------------------------------------------------------------
# K8: block SDDMM, the gradient of K1 with respect to the blocks
# ---------------------------------------------------------------------------


def _strips_product(gs, bs_):
    """``gs @ conj(bs_)^T`` for batches of strips (..., nb, bs, n), as one
    batched ``torch.matmul`` (``_component_matmul``: complex strips in
    real arithmetic, as the kernels compute them)."""
    return _component_matmul(gs, bs_.conj().mT)


def bsr_sddmm_plain(indptr, indices, g, b, bs, alpha=None):
    """``alpha * G[r_b bs:(r_b + 1) bs, :] @ conj(B[c_b bs:(c_b + 1) bs,
    :])^T`` for each stored block b in plain PyTorch: both block strips
    gathered, one ``torch.bmm`` (``_strips_product``; what
    ``_xla.bsr_spmm``'s batched ``dot_general`` transposes into under
    ``jax.grad``), chunked over the blocks so each gathered strip stays
    under ``config.spmm_chunk_elements`` elements."""
    nblocks, n = indices.numel(), g.shape[1]
    out = torch.zeros((nblocks, bs, bs), dtype=g.dtype, device=g.device)
    if nblocks and n:
        if g.is_cuda:
            ieee_matmul()
        rows = expand_indptr(indptr, nblocks).long()
        cols = indices.long()
        g_strips = g.reshape(-1, bs, n)
        b_strips = b.reshape(-1, bs, n)
        chunk = max(1, config.spmm_chunk_elements // (bs * n))
        for s in range(0, nblocks, chunk):
            e = min(s + chunk, nblocks)
            out[s:e] = _strips_product(g_strips[rows[s:e]],
                                       b_strips[cols[s:e]])
    if alpha is not None and complex(alpha) != 1:
        out = out * alpha
    return out


def bsr_sddmm_batched_plain(indptr, indices, g, b, bs, alpha=None):
    """``sddmm_batched`` in plain PyTorch, vectorised over the members:
    ``bsr_sddmm_plain``'s gathered strips and batched product with a
    member dimension ahead (a shared operand broadcast), chunked over the
    blocks so each gathered strip of all members stays under
    ``config.spmm_chunk_elements`` elements."""
    size = batch_size("bsr_sddmm", ((g, 2), (b, 2)))
    nblocks, n = indices.numel(), g.shape[-1]
    out = torch.zeros((size, nblocks, bs, bs), dtype=g.dtype,
                      device=g.device)
    if nblocks and n and size:
        if g.is_cuda:
            ieee_matmul()
        rows = expand_indptr(indptr, nblocks).long()
        cols = indices.long()
        g_strips = g.reshape(*g.shape[:-2], -1, bs, n)
        b_strips = b.reshape(*b.shape[:-2], -1, bs, n)
        chunk = max(1, config.spmm_chunk_elements // (size * bs * n))
        for s in range(0, nblocks, chunk):
            e = min(s + chunk, nblocks)
            out[:, s:e] = _strips_product(g_strips[..., rows[s:e], :, :],
                                          b_strips[..., cols[s:e], :, :])
    if alpha is not None and complex(alpha) != 1:
        out = out * alpha
    return out


def bsr_sddmm(indptr, indices, g, b, bs, alpha=None):
    """``alpha * G's block row r_b @ (B's block row c_b)^H`` for each
    stored block b = (r_b, c_b) of the BSR (block ``indptr`` of nbrows + 1,
    block-column ``indices``) with ``bs`` x ``bs`` blocks, for row-major
    ``g`` of (nbrows * bs, n) and ``b`` of (k, n), k % bs == 0: a new
    (nblocks, bs, bs) tensor in the blocks' stored order.  Not
    differentiable itself (``ops.autograd.BsrSddmm`` is): it raises on a
    tracked ``g`` or ``b`` (``csr.refuse_tracked``), on both devices."""
    refuse_tracked("bsr_sddmm", g, b)
    return sddmm(indptr, indices, g, b, bs, alpha)


def sddmm(indptr, indices, g, b, bs, alpha=None):
    """``bsr_sddmm`` without the tracked check, for ``BsrSddmm``'s
    forward: K8 on the card (the variant ``uses_tensor_cores`` names),
    the plain version on the CPU; counted in ``bsr_sddmm.launches`` (and
    ``launches_tc`` or ``launches_simt``)."""
    refuse_views("bsr_sddmm", indptr, indices, g, b)
    nbrows = indptr.numel() - 1
    if (g.dim() != 2 or b.dim() != 2 or g.shape != (nbrows * bs, g.shape[1])
            or b.shape[0] % bs or b.shape[1] != g.shape[1]):
        raise ValueError(f"bsr_sddmm: g {tuple(g.shape)} and b "
                         f"{tuple(b.shape)} do not fit {nbrows} block rows "
                         f"of {bs}")
    if g.device.type == "cpu":
        return bsr_sddmm_plain(indptr, indices, g, b, bs, alpha)
    if not g.is_cuda:
        raise ValueError(f"bsr_sddmm: no kernel for device {g.device}")
    _check("bsr_sddmm", (indptr, indices), (g, b))
    nblocks, n = indices.numel(), g.shape[1]
    out = torch.empty((nblocks, bs, bs), dtype=g.dtype, device=g.device)
    if nblocks == 0:
        return out
    if n == 0:
        return out.zero_()
    _launch_k8(indptr, indices, bs, alpha, 1, (0, 0, 0), g.data_ptr(),
               b.data_ptr(), out.data_ptr(), g)
    return out


def _launch_k8(indptr, indices, bs, alpha, members, strides, g, b, out,
               g_t):
    """One launch of K8, in the variant ``uses_tensor_cores`` names, for
    ``members`` members at ``strides`` (g, b, out), given the addresses;
    counted in ``bsr_sddmm.launches`` and ``launches_tc`` or
    ``launches_simt``."""
    tc = uses_tensor_cores(g_t.dtype, bs)
    dt, it = _build.type_codes(g_t, indptr)
    _build.launch("sdt_bsr_sddmm_tc" if tc else "sdt_bsr_sddmm_simt", dt, it,
                  indptr.data_ptr(), indptr.numel() - 1, indices.data_ptr(),
                  indices.numel(), g, b, out, bs, g_t.shape[-1],
                  *_build.scalar_parts(alpha), members, *strides,
                  _build.stream_of(g_t))
    if tc:
        bsr_sddmm.launches_tc += 1
        bsr_sddmm.launches_tc_complex += g_t.is_complex()
    else:
        bsr_sddmm.launches_simt += 1
    bsr_sddmm.launches += 1


def sddmm_batched(indptr, indices, g, b, bs, alpha=None):
    """K8 for a batch of members that share the BSR (``indptr``,
    ``indices``, ``bs`` x ``bs`` blocks): member i is ``bsr_sddmm`` of
    ``g_i`` and ``b_i``, with ``g`` (B, nbrows * bs, n) or (nbrows * bs,
    n) and ``b`` (B, k, n) or (k, n), at least one with the member
    dimension, each member contiguous; an operand without it (or
    expanded along it) is shared, read in place by every member.  Returns
    a new (B, nblocks, bs, bs) tensor.  One launch of the variant
    ``uses_tensor_cores`` names (one per ``_build.MAX_MEMBERS`` members),
    counted as ``sddmm``'s and in ``bsr_sddmm.launches_batched`` (and
    ``launches_batched_tc`` or ``launches_batched_simt``).  The plain
    version on the CPU."""
    refuse_views("bsr_sddmm", indptr, indices, g, b)
    operands = ((g, 2), (b, 2))
    size = batch_size("bsr_sddmm", operands)
    nbrows = indptr.numel() - 1
    if (g.shape[-2:] != (nbrows * bs, g.shape[-1]) or b.shape[-2] % bs
            or b.shape[-1] != g.shape[-1]):
        raise ValueError(f"bsr_sddmm: g {tuple(g.shape)} and b "
                         f"{tuple(b.shape)} do not fit {nbrows} block rows "
                         f"of {bs}")
    if g.device.type == "cpu":
        return bsr_sddmm_batched_plain(indptr, indices, g, b, bs, alpha)
    if not g.is_cuda:
        raise ValueError(f"bsr_sddmm: no kernel for device {g.device}")
    check_members("bsr_sddmm", (indptr, indices), operands)
    nblocks, n = indices.numel(), g.shape[-1]
    out = torch.empty((size, nblocks, bs, bs), dtype=g.dtype,
                      device=g.device)
    if nblocks == 0 or size == 0:
        return out
    if n == 0:
        return out.zero_()
    strides = (member_stride("bsr_sddmm", g, 2),
               member_stride("bsr_sddmm", b, 2), nblocks * bs * bs)
    for first, count in member_chunks(size):
        _launch_k8(indptr, indices, bs, alpha, count, strides,
                   *(member_ptr(t, st, first)
                     for t, st in zip((g, b, out), strides)), g)
        bsr_sddmm.launches_batched += 1
        if uses_tensor_cores(g.dtype, bs):
            bsr_sddmm.launches_batched_tc += 1
            bsr_sddmm.launches_batched_tc_complex += g.is_complex()
        else:
            bsr_sddmm.launches_batched_simt += 1
    return out


bsr_sddmm.launches = 0
bsr_sddmm.launches_tc = 0
bsr_sddmm.launches_tc_complex = 0
bsr_sddmm.launches_simt = 0
bsr_sddmm.launches_batched = 0
bsr_sddmm.launches_batched_tc = 0
bsr_sddmm.launches_batched_tc_complex = 0
bsr_sddmm.launches_batched_simt = 0
