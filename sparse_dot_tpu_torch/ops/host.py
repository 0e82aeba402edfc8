"""Host-boundary wrappers around the kernels.

Port of ``sparse_dot_tpu/ops/host.py`` ``spmm``/``spmv``/``gemm`` and
``_bilinear_host``: numpy -> device tensors, one product on the device
with the alpha/beta(out_scalar) accumulate fused into the kernel's
epilogue, and one device -> host copy of the result.

There is one path per operation.  Complex values run natively (no planar
decomposition), f64 runs as IEEE f64 (no hi|lo range gates), and each
format has one route: CSR and CSC go to K2 (``ops.csr.csr_spmm``), BSR to
K1 (``ops.bsr.bsr_spmm``), SpMV of any format to K3
(``ops.csr.csr_spmv``), each on the layout of op(A) that the container
builds once (``formats``).  The TPU's measured crossovers between ELL,
densify+matmul and scatter routes are not carried over.
"""

from .. import formats
from . import bsr, csr, dense


def _spmm_pass(A, b, transpose, alpha=None, beta=None, c0=None):
    """``alpha * op(A) @ b + beta * c0`` on the device (the port of
    ``host._real_spmm``)."""
    if isinstance(A, formats.BSR):
        return bsr.bsr_spmm(*A.bsr_arrays(transpose), b, alpha, beta, c0)
    return csr.csr_spmm(*A.csr_arrays(transpose), b, alpha, beta, c0)


def _spmv_pass(A, x, transpose, alpha=None, beta=None, c0=None):
    """``alpha * op(A) @ x + beta * c0`` on the device (the port of
    ``host._real_spmv``)."""
    return csr.csr_spmv(*A.csr_arrays(transpose), x, alpha, beta, c0)


def _bilinear_host(A, b_np, one_pass, out_dtype, alpha=1.0, out=None,
                   out_scalar=None, transpose=False):
    """Run one sparse-dense product with accumulate semantics; returns a
    host numpy array (row-major)."""
    beta = 1.0 if out_scalar is None else out_scalar
    b = formats.dense_to_device(b_np)
    c0 = formats.dense_to_device(out) if out is not None else None
    res = one_pass(
        A, b, transpose,
        alpha=None if alpha == 1.0 else alpha,
        beta=beta if c0 is not None else None,
        c0=c0,
    )
    return res.cpu().numpy().astype(out_dtype, copy=False)


def spmm(A, b_np, out_dtype, alpha=1.0, out=None, out_scalar=None,
         transpose=False):
    """alpha * op(A) @ b + out_scalar * out -> host numpy (row-major)."""
    return _bilinear_host(
        A, b_np, _spmm_pass, out_dtype, alpha=alpha, out=out,
        out_scalar=out_scalar, transpose=transpose,
    )


def spmv(A, x_np, out_dtype, alpha=1.0, out=None, out_scalar=None,
         transpose=False):
    return _bilinear_host(
        A, x_np, _spmv_pass, out_dtype, alpha=alpha, out=out,
        out_scalar=out_scalar, transpose=transpose,
    )


def gemm(a_np, b_np, out_dtype, alpha=1.0, out=None, out_scalar=None):
    """alpha * a @ b + out_scalar * out -> host numpy (row-major)."""
    beta = 1.0 if out_scalar is None else out_scalar
    a = formats.dense_to_device(a_np)
    b = formats.dense_to_device(b_np)
    c0 = formats.dense_to_device(out) if out is not None else None
    res = dense.gemm(a, b, alpha=alpha, beta=beta, c0=c0)
    return res.cpu().numpy().astype(out_dtype, copy=False)
