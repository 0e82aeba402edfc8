"""BSR SpMM (kernel K1).

Port of ``sparse_dot_tpu/ops/pallas_bsr.py`` ``bsr_spmm_pallas`` (the
JAX package's one Pallas kernel) and of its XLA fallback
``_xla.bsr_spmm``.  On a CUDA tensor the wrapper launches the
hand-written kernel (``csrc/bsr_spmm.cu``) or raises; on a CPU tensor it
runs the plain PyTorch version beside it, which is also what the kernel
is checked against on the card.  ``bsr_spmm.launches`` counts kernel
launches.

Unlike the TPU kernel, which took f32 only, ``bs % 8 == 0`` and B padded
to 128-column panels, the kernel takes all four value types, any square
block size and any n.  It is expected to be bound by the CUDA cores'
multiply-add rate at the main path's block sizes; the note at the top of
the ``.cu`` file says why and how its tiles are laid out.
"""

import torch

from ..formats import expand_indptr
from . import _build
from .csr import _check
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


def bsr_spmm(indptr, indices, data, b, alpha=None, beta=None, c0=None):
    """``alpha * A @ b + beta * c0`` for BSR A (block ``indptr`` of
    nbrows + 1, block-column ``indices``, ``data`` of (nblocks, bs, bs))
    and row-major ``b`` of (k, n) with k % bs == 0; ``c0`` is
    (nbrows * bs, n) or None.  Returns a new (nbrows * bs, n) tensor."""
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
    _build.launch(
        "sdt_bsr_spmm", dt, it, indptr.data_ptr(), indices.data_ptr(),
        data.data_ptr(), b.data_ptr(),
        None if c0 is None else c0.data_ptr(), c.data_ptr(), nbrows, bs, n,
        *_build.scalar_parts(alpha),
        *_build.scalar_parts(0.0 if c0 is None else beta),
        _build.stream_of(b),
    )
    bsr_spmm.launches += 1
    return c


bsr_spmm.launches = 0
