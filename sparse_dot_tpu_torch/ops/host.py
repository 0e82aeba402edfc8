"""Host-boundary wrappers around the kernels.

Port of ``sparse_dot_tpu/ops/host.py`` ``spmm``/``spmv``/``gemm`` and
``_bilinear_host``, the sparse x sparse products (``spgemm_device``,
``spgemm_sparse_arrays``, ``spgemm_dense``) and the gram products
(``gram_dense_from_dense``, ``gram_dense_from_sparse``, ``gram_sparse``):
numpy -> device tensors, one product on the device with the
alpha/beta(out_scalar) accumulate fused into the kernel's epilogue, and
one device -> host copy of the result.

There is one path per operation.  Complex values run natively (no planar
decomposition), f64 runs as IEEE f64 (no hi|lo range gates), and each
format has one route: CSR and CSC go to K2 (``ops.csr.csr_spmm``), BSR to
K1 (``ops.bsr.bsr_spmm``), SpMV of any format to K3
(``ops.csr.csr_spmv``), each on the layout of op(A) and the kernel's
row plan that the container builds once and caches (``formats``).  The TPU's measured crossovers between ELL,
densify+matmul and scatter routes are not carried over.  Sparse x sparse
has one route per output kind: sparse output on K4 + K5, dense output on
K6 (``ops.spgemm``), both on the CSR arrays of op(A) and op(B); the JAX
package's routing ladder, planar complex and speculative size caches
have no counterpart.
"""

import numpy as np

from .. import formats, policy
from . import bsr, csr, dense, spgemm


def _spmm_pass(A, b, transpose, alpha=None, beta=None, c0=None):
    """``alpha * op(A) @ b + beta * c0`` on the device (the port of
    ``host._real_spmm``)."""
    if isinstance(A, formats.BSR):
        return bsr.bsr_spmm(*A.bsr_arrays(transpose), b, alpha, beta, c0,
                            plan=A.bsr_plan(transpose))
    return csr.csr_spmm(*A.csr_arrays(transpose), b, alpha, beta, c0,
                        plan=A.csr_plan(transpose))


def _spmv_pass(A, x, transpose, alpha=None, beta=None, c0=None):
    """``alpha * op(A) @ x + beta * c0`` on the device (the port of
    ``host._real_spmv``)."""
    return csr.csr_spmv(*A.csr_arrays(transpose), x, alpha, beta, c0,
                        plan=A.csr_plan(transpose, spmv=True))


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


# ---------------------------------------------------------------------------
# sparse x sparse
# ---------------------------------------------------------------------------


def _product_arrays(A, B, out_dtype, sort_b=False):
    """CSR arrays of op(A) and op(B) with ``out_dtype`` values and A's
    index dtype; with ``sort_b`` op(B)'s rows in ascending column order
    (``sorted_csr_arrays``)."""
    dtype = formats.torch_dtype(out_dtype)
    a_ip, a_ix, a_dv = A.csr_arrays()
    b_ip, b_ix, b_dv = B.sorted_csr_arrays() if sort_b else B.csr_arrays()
    itype = a_ip.dtype
    return (a_ip, a_ix, a_dv.to(dtype), b_ip.to(itype), b_ix.to(itype),
            b_dv.to(dtype))


def spgemm_device(A, B, out_dtype=None, triangular=False):
    """A @ B -> ``formats.CSR`` on the device (no host copy), with the
    structural output pattern and sorted columns; only j >= i with
    ``triangular``.  Reading the output's nnz is the one host sync."""
    if out_dtype is None:
        out_dtype = policy.output_dtype(A, B)
    m, n = A.shape[0], B.shape[1]
    indptr, indices, data = spgemm.csr_spgemm(
        *_product_arrays(A, B, out_dtype), n, triangular)
    return formats.CSR(data, indices, indptr, (m, n), sorted_indices=True)


def spgemm_sparse_arrays(A, B, out_dtype, triangular=False):
    """A @ B -> (data, indices, indptr) host CSR arrays with the
    structural output pattern (exactly cancelled entries kept as explicit
    zeros)."""
    C = spgemm_device(A, B, out_dtype, triangular)
    return (C.data.cpu().numpy(), C.indices.cpu().numpy(),
            C.indptr.cpu().numpy())


def _spgemm_dense_host(A, B, out_dtype, out, out_scalar, triangular):
    beta = 1.0 if out_scalar is None else out_scalar
    c0 = formats.dense_to_device(out) if out is not None else None
    res = spgemm.csr_spgemm_dense(
        *_product_arrays(A, B, out_dtype, sort_b=True), B.shape[1],
        beta=beta if c0 is not None else None, c0=c0,
        triangular=triangular, b_sorted=True,
    )
    return res.cpu().numpy().astype(out_dtype, copy=False)


def spgemm_dense(A, B, out_dtype, out=None, out_scalar=None):
    """A @ B (+ out_scalar * out) -> dense host numpy (spmmd analog)."""
    return _spgemm_dense_host(A, B, out_dtype, out, out_scalar, False)


# ---------------------------------------------------------------------------
# Gram (syrk)
# ---------------------------------------------------------------------------


def gram_dense_from_dense(a_np, out_dtype, aat=False, out=None,
                          out_scalar=None):
    """triu(op(a)) from a dense operand (cblas_?syrk analog), unconjugated
    for complex input: the strict lower triangle of the result is
    out_scalar * out (or zero)."""
    beta = 1.0 if out_scalar is None else out_scalar
    a = formats.dense_to_device(np.asarray(a_np))
    c0 = formats.dense_to_device(out) if out is not None else None
    res = dense.syrk(a, aat=aat, beta=beta, c0=c0)
    return res.cpu().numpy().astype(out_dtype, copy=False)


def _gram_operands(A, aat):
    return (A, A.T) if aat else (A.T, A)


def gram_dense_from_sparse(A, out_dtype, aat=False, out=None,
                           out_scalar=None, full=False):
    """Gram of a sparse operand with dense output (syrkd analog):
    triu(op(A)) + out_scalar * out; ``full=True`` keeps the lower triangle
    of the product too, as the reference's syrkd does before its
    lower-triangle cleanup (``_gram_matrix.py:164-169``)."""
    first, second = _gram_operands(A, aat)
    return _spgemm_dense_host(first, second, out_dtype, out, out_scalar,
                              not full)


def gram_sparse(A, out_dtype, aat=False):
    """Gram of a sparse operand with sparse (upper-triangular) output."""
    first, second = _gram_operands(A, aat)
    return spgemm_sparse_arrays(first, second, out_dtype, triangular=True)
