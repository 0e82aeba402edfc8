"""BSR SpMM (kernel K1).

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
"""

import torch

from ..formats import bsr_chunk_plan, expand_indptr
from . import _build
from .csr import _check, refuse_views
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
    """Whether K1 runs on the tensor cores for values of ``dtype`` in
    ``bs`` x ``bs`` blocks (else on the CUDA cores)."""
    return dtype in (torch.float32, torch.float64) and bs % 8 == 0


def bsr_spmm(indptr, indices, data, b, alpha=None, beta=None, c0=None,
             plan=None):
    """``alpha * A @ b + beta * c0`` for BSR A (block ``indptr`` of
    nbrows + 1, block-column ``indices``, ``data`` of (nblocks, bs, bs))
    and row-major ``b`` of (k, n) with k % bs == 0; ``c0`` is
    (nbrows * bs, n) or None.  ``plan`` is ``bsr_chunk_plan`` of these
    arrays (for example ``BSR.bsr_plan``, cached); it is built here when
    None and the tensor-core variant needs it.  Returns a new
    (nbrows * bs, n) tensor."""
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
