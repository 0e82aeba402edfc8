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

- real values (f32, f64) with ``bs % 8 == 0`` take the tensor-core
  variant (``csrc/bsr_spmm.cu``): f64 MMA, 3xTF32 for f32 (about f32's
  own precision; never plain TF32), a cp.async ring of tiles, one thread
  block per (chunk of a block row, 64 columns) up to 128 rows tall, and
  block rows longer than the chunk plan's S stored blocks
  (``formats.bsr_chunk_plan``) summed from partial tiles in chunk order,
  so results do not change from run to run;
- complex values and other block sizes take the CUDA-core variant of
  PR 1 (``csrc/bsr_spmm_simt.cu``): any square bs, any n, plain FMA.

``bsr_spmm.launches`` counts launches of either variant;
``bsr_spmm.launches_tc`` and ``bsr_spmm.launches_simt`` count each.  The
notes at the top of the ``.cu`` files say what bounds each variant and
how its tiles are laid out.

K8 (``bsr_sddmm``) gives each stored block's gradient, G's block row
times the conjugate transpose of B's block row; it replaces ``jax.grad``
of ``_xla.bsr_spmm`` in the blocks.  It is split as K1 is, by the same
predicate (``uses_tensor_cores``), chosen before the launch:

- real values with ``bs % 8 == 0`` on the tensor cores
  (``csrc/bsr_sddmm.cu``): f64 MMA, 3xTF32 for f32 (K1's arithmetic,
  ``csrc/mma.cuh``), a thread block a tile of at most 64 x 64 of a
  stored block, G's and B's strips streamed through a ``cp.async`` ring
  of 2 chunks;
- complex values and other block sizes on the CUDA cores
  (``csrc/bsr_sddmm_simt.cu``): strips staged in shared memory 16
  columns at a time, plain FMA.

``bsr_sddmm.launches`` counts launches of either variant,
``bsr_sddmm.launches_tc`` and ``bsr_sddmm.launches_simt`` each.
``bsr_spmm`` takes ``ops.autograd.BsrSpmm`` when an operand is tracked,
whose backward runs K8 and K1 over A^H.
"""

import torch

from ..config import config
from ..formats import bsr_chunk_plan, expand_indptr
from . import _build
from .csr import _check, refuse_tracked, refuse_views, tracked
from .dense import axpby, ieee_matmul


def bsr_spmm_plain(indptr, indices, data, b, alpha=None, beta=None, c0=None):
    """``alpha * A @ b + beta * c0`` in plain PyTorch: gather the B panel
    of every stored block, one batched matmul, ``index_add_`` of the
    block rows (``_xla.bsr_spmm``)."""
    nblocks, bs, _ = data.shape
    nbrows = indptr.numel() - 1
    k, n = b.shape
    c = torch.zeros((nbrows, bs, n), dtype=b.dtype, device=b.device)
    if nblocks and n:
        if b.is_cuda:
            ieee_matmul()
        panels = b.reshape(k // bs, bs, n)[indices.long()]
        c.index_add_(0, expand_indptr(indptr, nblocks),
                     torch.bmm(data, panels))
    return axpby(c.reshape(nbrows * bs, n), alpha, beta, c0)


def uses_tensor_cores(dtype, bs):
    """Whether K1 and K8 run on the tensor cores for values of ``dtype``
    in ``bs`` x ``bs`` blocks (else on the CUDA cores)."""
    return dtype in (torch.float32, torch.float64) and bs % 8 == 0


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
    dt, it = _build.type_codes(data, indptr)
    scalars = (*_build.scalar_parts(alpha),
               *_build.scalar_parts(0.0 if c0 is None else beta))
    c0_ptr = None if c0 is None else c0.data_ptr()
    if uses_tensor_cores(data.dtype, bs):
        nblocks = data.shape[0]
        if plan is None:
            plan = bsr_chunk_plan(indptr, nblocks)
        if ((plan.nbrows, plan.nblocks) != (nbrows, nblocks)
                or plan.items.device != b.device):
            raise ValueError("bsr_spmm: the chunk plan is for other arrays")
        n_splits = plan.splits.shape[0]
        # Partial tiles of split block rows; untouched when none is split.
        work = (torch.empty((plan.slots, bs, n), dtype=b.dtype,
                            device=b.device) if n_splits else None)
        _build.launch(
            "sdt_bsr_spmm_tc", dt, it, plan.items.data_ptr(),
            plan.items.shape[0], plan.splits.data_ptr(), n_splits,
            indices.data_ptr(), data.data_ptr(), b.data_ptr(), c0_ptr,
            c.data_ptr(), None if work is None else work.data_ptr(), bs, n,
            *scalars, _build.stream_of(b),
        )
        bsr_spmm.launches_tc += 1
    else:
        _build.launch(
            "sdt_bsr_spmm_simt", dt, it, indptr.data_ptr(),
            indices.data_ptr(), data.data_ptr(), b.data_ptr(), c0_ptr,
            c.data_ptr(), nbrows, bs, n, *scalars, _build.stream_of(b),
        )
        bsr_spmm.launches_simt += 1
    bsr_spmm.launches += 1
    return c


bsr_spmm.launches = 0
bsr_spmm.launches_tc = 0
bsr_spmm.launches_simt = 0


# ---------------------------------------------------------------------------
# K8: block SDDMM, the gradient of K1 with respect to the blocks
# ---------------------------------------------------------------------------


def _strips_product(gs, bs_):
    """``gs @ conj(bs_)^T`` for batches of strips (nb, bs, n), as one
    ``torch.bmm`` in real arithmetic: complex strips go in as their real
    and imaginary parts side by side, so that each product follows
    numpy's component formula, as the kernels do (cuBLAS's complex GEMM
    gives nan + nanj where a product of inf and a finite value is
    +-inf +-infj by that formula)."""
    if not gs.is_complex():
        return torch.bmm(gs, bs_.mT)
    bs = bs_.shape[1]
    g2 = torch.cat([gs.real, gs.imag], -1)
    b2 = torch.cat([torch.cat([bs_.real, bs_.imag], -1),
                    torch.cat([-bs_.imag, bs_.real], -1)], 1)
    out = torch.bmm(g2, b2.mT)
    return torch.complex(out[..., :bs], out[..., bs:])


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
    dt, it = _build.type_codes(g, indptr)
    args = (indptr.data_ptr(), nbrows, indices.data_ptr(), nblocks,
            g.data_ptr(), b.data_ptr(), out.data_ptr(), bs, n)
    if uses_tensor_cores(g.dtype, bs):
        _build.launch("sdt_bsr_sddmm_tc", dt, it, *args,
                      *_build.scalar_parts(alpha), _build.stream_of(g))
        bsr_sddmm.launches_tc += 1
    else:
        _build.launch("sdt_bsr_sddmm_simt", dt, it, *args,
                      *_build.scalar_parts(alpha), _build.stream_of(g))
        bsr_sddmm.launches_simt += 1
    bsr_sddmm.launches += 1
    return out


bsr_sddmm.launches = 0
bsr_sddmm.launches_tc = 0
bsr_sddmm.launches_simt = 0
