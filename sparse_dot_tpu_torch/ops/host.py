"""Host-boundary wrappers around the kernels.

Port of ``sparse_dot_tpu/ops/host.py`` ``spmm``/``spmv``/``gemm`` and
``_bilinear_host``, the sparse x sparse products (``spgemm_device``,
``spgemm_sparse_arrays``, ``spgemm_dense``) and the gram products
(``gram_dense_from_dense``, ``gram_dense_from_sparse``, ``gram_sparse``):
numpy -> device tensors, one product on the device with the
alpha/beta(out_scalar) accumulate fused into the kernel's epilogue (or
applied after a dense product), and one device -> host copy of the
result.

Complex values run natively (no planar decomposition) and f64 runs as
IEEE f64 (no hi|lo range gates).  SpMM has two routes, as the JAX package
has (``host._real_spmm``): BSR goes to K1 (``ops.bsr.bsr_spmm``); CSR and
CSC go to K2 (``ops.csr.csr_spmm``) on the layout of op(A) and the row
plan that the container builds once and caches (``formats``), or, where
the gate ``_prefer_densify`` says the dense product is faster and B is
finite, to the densify route: K12 (``ops.densify``) on A's stored arrays
and one IEEE ``torch.matmul`` (the counterpart of
``_xla.spmm_densified_sorted``).  SpMV of any format goes to K3
(``ops.csr.csr_spmv``).  Sparse x sparse with sparse output runs on K4 +
K5; with dense output on K6 (``ops.spgemm``), or, where
``_prefer_densify_product`` favours it and both operands' values are
finite, on K12 and one ``torch.matmul`` (the counterpart of
``_xla.spgemm_numeric_sorted``; a single densify when op(B) is op(A)'s
transpose view).  The gates' constants were measured on the H100, not
carried over from the TPU; the JAX package's ELL route, routing ladder,
planar complex and speculative size caches have no counterpart.
"""

import math

import numpy as np
import torch

from .. import formats, policy
from . import bsr, csr, dense, spgemm

# ---------------------------------------------------------------------------
# The densify route's gates (the port of ``_xla._prefer_densify``)
# ---------------------------------------------------------------------------

# Constants of the cost models, fitted by ``chip_smoke.py --only densify``
# (phase 4's sweep, ``fit_gate``) on an NVIDIA H100 80GB HBM3 at a 700 W
# power limit.  K2: fixed seconds, seconds a stored entry of op(A), and
# seconds a product (an entry times a column of B) as b + d ln(R_hi / r),
# r being op(A)'s mean row held within _K2_ROWS, the mean rows the sweep
# spans (longer rows take less a product).  K6: fixed seconds, seconds a
# product (an entry of op(A) times one of op(B)), and the share of that
# time a ``triangular`` launch takes.  K12: seconds a byte of dense output
# and an entry scattered.  ``torch.matmul``: fixed seconds, seconds a byte
# of the dense op(A) read, and FLOP/s.  The route's own seconds (the
# finite flag's host read, the host's gaps between launches): for SpMM,
# and for sparse x sparse of one operand and of two.
_K2_S = {torch.float32: (0.0, 6.65e-12, 2.57e-13, 8.02e-14),
         torch.float64: (0.0, 1.12e-11, 5.02e-13, 1.79e-13),
         torch.complex64: (0.0, 1.02e-11, 5.48e-13, 1.60e-13),
         torch.complex128: (0.0, 2.42e-11, 1.12e-12, 3.88e-13)}
_K2_ROWS = (50.0, 4000.0)
_K6_S = {torch.float32: (5.79e-5, 1.09e-12, 0.851),
         torch.float64: (6.15e-5, 1.75e-12, 0.785),
         torch.complex64: (6.93e-5, 1.72e-12, 0.819),
         torch.complex128: (6.30e-5, 4.00e-12, 0.592)}
_K12_S = {torch.float32: (4.30e-13, 3.55e-12),
          torch.float64: (3.63e-13, 4.57e-12),
          torch.complex64: (3.78e-13, 5.31e-12),
          torch.complex128: (3.87e-13, 1.13e-11)}
_MATMUL_S = 1.86e-5
_MATMUL = {torch.float32: (9.39e-13, 4.74e13),
           torch.float64: (3.46e-13, 5.98e13),
           torch.complex64: (5.82e-13, 5.28e13),
           torch.complex128: (3.37e-13, 6.15e13)}
_DENSE_ROUTE_S = 1.27e-4
_DENSE_PRODUCT_S = (8.89e-5, 9.99e-5)
# Dense operands past this many bytes stay on the kernels (the JAX
# package's cap, ``_xla.py:557-558``).
DENSE_CAP_BYTES = 4e9


def _densify_seconds(elements, nnz, dtype):
    """K12's forecast: ``elements`` of dense output, ``nnz`` entries."""
    per_byte, per_entry = _K12_S[dtype]
    return elements * dtype.itemsize * per_byte + nnz * per_entry


def _matmul_seconds(m, k, n, dtype):
    """``torch.matmul``'s forecast for (m, k) @ (k, n): the dense op(A)
    read or the FLOPs, whichever takes longer."""
    per_byte, flops = _MATMUL[dtype]
    flop = 2.0 * m * k * n * (4 if dtype.is_complex else 1)
    return _MATMUL_S + max(m * k * dtype.itemsize * per_byte, flop / flops)


def _k2_seconds(m, n, nnz, dtype):
    """K2's forecast for op(A) of m rows and ``nnz`` entries times n
    columns."""
    fixed, per_entry, per_product, per_log = _K2_S[dtype]
    lo, hi = _K2_ROWS
    rows = min(max(nnz / max(m, 1), lo), hi)
    return fixed + nnz * (per_entry
                          + n * (per_product + per_log * math.log(hi / rows)))


def _prefer_densify(m, k, n, nnz, dtype, device):
    """Whether op(A) (m x k, ``nnz`` entries) @ B (k x n) of ``dtype``
    should run as K12 + ``torch.matmul`` rather than K2.  On the CPU the
    JAX package's rule, nnz / (m k) > 0.25 (``_xla.py:541-543``), so both
    packages take the same route on the same input; on the card the
    faster of the two cost models, dense A within DENSE_CAP_BYTES."""
    if device.type == "cpu":
        return nnz / max(m * k, 1) > 0.25
    if m * k * dtype.itemsize > DENSE_CAP_BYTES:
        return False
    dense_s = (_DENSE_ROUTE_S + _densify_seconds(m * k, nnz, dtype)
               + _matmul_seconds(m, k, n, dtype))
    return dense_s < _k2_seconds(m, n, nnz, dtype)


def _prefer_densify_product(m, k, n, a_nnz, b_nnz, dtype, device,
                            one_operand=False, triangular=False):
    """Whether op(A) (m x k, ``a_nnz`` entries) @ op(B) (k x n, ``b_nnz``)
    with dense output (only j >= i with ``triangular``) should run as K12
    + ``torch.matmul`` rather than K6; ``one_operand``: op(B) is op(A)'s
    transpose view, densified once.  K6's work is its products, estimated
    as a_nnz * b_nnz / k (no pass over the patterns).  On the CPU the SpMM
    rule's ratio: the products exceed 0.25 of the dense product's m k n
    multiply-adds (as nnz n does m k n there); on the card the faster of
    the two cost models, dense operands within DENSE_CAP_BYTES."""
    products = a_nnz * b_nnz / max(k, 1)
    if device.type == "cpu":
        return products > 0.25 * m * k * n
    elements = m * k if one_operand else m * k + k * n
    if elements * dtype.itemsize > DENSE_CAP_BYTES:
        return False
    fixed, per_product, triangular_share = _K6_S[dtype]
    dense_s = (_DENSE_PRODUCT_S[0 if one_operand else 1]
               + _densify_seconds(elements, a_nnz if one_operand
                                  else a_nnz + b_nnz, dtype)
               + _matmul_seconds(m, k, n, dtype))
    return dense_s < fixed + per_product * products * (
        triangular_share if triangular else 1.0)


def all_finite(*tensors):
    """Whether every value of ``tensors`` is finite: the sum of their sums
    is finite only then (one read of each tensor on the device, one host
    sync).  A sum that overflows reads as not finite, which only keeps the
    call off the densify route."""
    return bool(torch.isfinite(sum(t.sum() for t in tensors)))


def densified_spmm(A, b, transpose, alpha=None, beta=None, c0=None):
    """The densify route of ``_spmm_pass``: ``alpha * op(A) @ b + beta *
    c0`` as K12 on A's stored arrays and one ``torch.matmul`` (the port of
    ``_xla.spmm_densified_sorted``), the epilogue as the plain versions
    apply it (``dense.axpby``).  The product is enqueued first and the
    finite flag of b (for complex values A's values too, which a BLAS
    complex product meets with another inf rule) read on the host after
    it, so the read waits for the card instead of the card for the read.
    None when a value is not finite (the product is dropped): a densified
    A meets every entry of b with its zeros, and 0 * inf is NaN where
    scipy and K2 have no term."""
    a = A.dense(transpose, b.dtype)
    if b.is_cuda:
        dense.ieee_matmul()
    c = dense.axpby(torch.matmul(a, b), alpha, beta, c0)
    if not all_finite(b, *((A.data,) if b.is_complex() else ())):
        return None
    return c


def _spmm_pass(A, b, transpose, alpha=None, beta=None, c0=None):
    """``alpha * op(A) @ b + beta * c0`` on the device (the port of
    ``host._real_spmm``): BSR on K1; CSR and CSC on the densify route
    (``densified_spmm``) where ``_prefer_densify`` says so and the values
    it meets are finite, else on K2."""
    if isinstance(A, formats.BSR):
        return bsr.bsr_spmm(*A.bsr_arrays(transpose), b, alpha, beta, c0,
                            plan=A.bsr_plan(transpose))
    m, k = A.shape[::-1] if transpose else A.shape
    if _prefer_densify(m, k, b.shape[1], A.nnz, b.dtype, b.device):
        c = densified_spmm(A, b, transpose, alpha, beta, c0)
        if c is not None:
            return c
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


def transpose_pair(A, B):
    """Whether B is A's zero-cost transpose view (``CSR.T`` / ``CSC.T``:
    the same buffers, the transposed shape, the other format), so that
    A @ B densifies once: the counterpart of ``host._is_syrk_pair``."""
    return (B.data is A.data and B.indices is A.indices
            and B.indptr is A.indptr and B.shape == A.shape[::-1]
            and not isinstance(A, formats.BSR) and type(B) is not type(A))


def densified_product(A, B, dtype, beta=None, c0=None, triangular=False):
    """The densify route of ``spgemm_dense_device``: ``op(A) @ op(B) + beta
    * c0`` with dense output (only j >= i of the product with
    ``triangular``; ``c0`` added everywhere, as K6 adds it) as K12 on each
    operand's stored arrays, once for a ``transpose_pair``, and one
    ``torch.matmul`` (the port of ``_xla.spgemm_numeric_sorted``).  The
    product is enqueued first and the finite flag of both operands'
    stored values read on the host after it; None when a value is not
    finite (the product is dropped): a densified operand meets the
    other's entries with its zeros, and 0 * inf is NaN where the
    structural product has no term."""
    pair = transpose_pair(A, B)
    a = A.dense(dtype=dtype)
    b = a.mT if pair else B.dense(dtype=dtype)
    if a.is_cuda:
        dense.ieee_matmul()
    c = torch.matmul(a, b)
    if triangular:
        c = c.triu_()
    c = dense.axpby(c, None, beta, c0)
    if not all_finite(A.data, *(() if pair else (B.data,))):
        return None
    return c


def spgemm_dense_device(A, B, out_dtype, beta=None, c0=None,
                        triangular=False):
    """``A @ B + beta * c0`` as a dense device tensor of the numpy dtype
    ``out_dtype`` (only j >= i of the product with ``triangular``): the
    densify route (``densified_product``) where
    ``_prefer_densify_product`` favours it and both operands' stored
    values are finite, else K6 on op(A)'s CSR arrays and op(B)'s sorted
    ones."""
    dtype = formats.torch_dtype(out_dtype)
    m, k = A.shape
    n = B.shape[1]
    if _prefer_densify_product(m, k, n, A.nnz, B.nnz, dtype, A.data.device,
                               transpose_pair(A, B), triangular):
        c = densified_product(A, B, dtype, beta, c0, triangular)
        if c is not None:
            return c
    return spgemm.csr_spgemm_dense(
        *_product_arrays(A, B, out_dtype, sort_b=True), n, beta=beta, c0=c0,
        triangular=triangular, b_sorted=True)


def _spgemm_dense_host(A, B, out_dtype, out, out_scalar, triangular):
    beta = 1.0 if out_scalar is None else out_scalar
    c0 = formats.dense_to_device(out) if out is not None else None
    res = spgemm_dense_device(A, B, out_dtype,
                              beta if c0 is not None else None, c0,
                              triangular)
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
