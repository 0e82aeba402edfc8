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
has (``host._real_spmm``): an untransposed BSR goes to K1
(``ops.bsr.bsr_spmm``); the rest, where the gate ``_prefer_densify`` says
the dense product is faster and B is finite, to the densify route: K12
(``ops.densify``) on A's stored arrays and one IEEE ``torch.matmul`` (the
counterpart of ``_xla.spmm_densified_sorted``), else to K1 over the
transposed blocks (BSR) or K2 (``ops.csr.csr_spmm``, CSR and CSC) on the
layout of op(A) and the row plan that the container builds once and
caches (``formats``).  SpMV of any format goes to K3
(``ops.csr.csr_spmv``).  Sparse x sparse with sparse output runs on K4 +
K5, or, where ``_prefer_densify_sparse_product`` favours it and both
operands' values are finite and untracked, on the structural densify
route: K12 and its indicator template, two ``torch.matmul`` (the values,
and the bf16 indicators' structural count P) and K13 (``ops.compact``,
C's CSR at P > 0; the counterpart of ``_xla.spgemm_structural_extract``).
With dense output it runs on K6 (``ops.spgemm``), or, where
``_prefer_densify_product`` favours it and both operands' values are
finite, on K12 and one ``torch.matmul`` (the counterpart of
``_xla.spgemm_numeric_sorted``).  Each densify route densifies once when
op(B) is op(A)'s transpose view, and reads a container's kept planes
(``formats.SparseDeviceMatrix.dense_planes``) on its repeat use.  The
gates' constants were measured on the H100, not carried over from the
TPU; the JAX package's ELL route, routing ladder, planar complex, row-
blocked sparse output and speculative size caches have no counterpart.
"""

import math

import numpy as np
import torch

from .. import formats, policy
from . import bsr, compact, csr, dense, spgemm

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
# and an entry scattered (bf16: its indicator template).
# ``torch.matmul``: fixed seconds, seconds a byte of the dense op(A) read,
# and FLOP/s (bf16: the indicators' product).  The route's own seconds
# (the finite flag's host read, the host's gaps between launches): for
# SpMM, and for sparse x sparse of one operand and of two.
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
          torch.complex128: (3.87e-13, 1.13e-11),
          torch.bfloat16: (5.24e-13, 8.22e-12)}
_MATMUL_S = 1.86e-5
_MATMUL = {torch.float32: (9.39e-13, 4.74e13),
           torch.float64: (3.46e-13, 5.98e13),
           torch.complex64: (5.82e-13, 5.28e13),
           torch.complex128: (3.37e-13, 6.15e13),
           torch.bfloat16: (1.53e-12, 8.85e14)}
_DENSE_ROUTE_S = 1.27e-4
_DENSE_PRODUCT_S = (8.89e-5, 9.99e-5)
# The structural densify route of sparse-output products: K4 + K5 (fixed
# seconds; seconds a product as (b + d ln(R_hi / r)) (1 + S / m), r the
# products a row of op(A) held within _K45_ROWS, since longer rows take
# less a product, and S the rows of op(A) below which part of the card
# idles; seconds an entry of C; the share of that work a ``triangular``
# launch takes); K13's seconds a byte (P read twice, C's entries read and
# written with their columns); the route's own seconds (K13's fixed part,
# the host read of C's nnz and the finite flags, the host's gaps) of one
# operand and of two.
_K45_S = {
    torch.float32: (3.18e-4, 2.09e-12, 3.21e-12, 1.18e-11, 500.0, 1.116),
    torch.float64: (3.52e-4, 3.58e-12, 3.93e-12, 3.36e-11, 250.0, 1.091),
    torch.complex64: (3.26e-4, 4.26e-12, 5.05e-12, 2.86e-11, 125.0, 1.096),
    torch.complex128: (3.21e-4, 6.77e-12, 6.59e-12, 1.03e-10, 0.0, 1.014)}
_K45_ROWS = (100.0, 1.0e6)
_K13_S = 3.39e-13
_DENSE_SPARSE_S = (3.55e-4, 4.89e-4)
# K1 over a transposed BSR (dense x BSR): fixed seconds and FLOP/s on the
# tensor cores (bs % 8 == 0; complex values apart) and on the CUDA cores
# (the rest), from K1's rows in PERF.md (config 3, bs 64: 1.72 GFLOP in
# 0.0925 ms f64, 0.0949 ms f32; c128 bs 16: 0.41 GFLOP in 0.0659 ms on
# the CUDA cores) and, for complex values on the tensor cores, from
# ``compare_k7_k13.py bsr_gate`` (4000^2, bs 16, n = 64, 10-90% of
# blocks: 2.1-2.3e13 in c64, 2.7-2.9e13 in c128).  K1 alone: the reorder
# of a BSR's stored values, which both routes pay (K1 into A^T's block
# order, K12 into the element CSR's), is left out of both forecasts.
_K1_S = 2.0e-5
_K1_FLOPS = {"tc": 1.8e13, "tc_complex": 2.2e13, "simt": 6.0e12}
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


def _k1_seconds(nnz, n, dtype, blocksize):
    """K1's forecast for a BSR of ``nnz`` stored elements in blocks of
    ``blocksize`` times n columns."""
    variant = "simt"
    if bsr.uses_tensor_cores(dtype, blocksize):
        variant = "tc_complex" if dtype.is_complex else "tc"
    flop = nnz * n * (8 if dtype.is_complex else 2)
    return _K1_S + flop / _K1_FLOPS[variant]


def _prefer_densify(m, k, n, nnz, dtype, device, blocksize=None):
    """Whether op(A) (m x k, ``nnz`` entries) @ B (k x n) of ``dtype``
    should run as K12 + ``torch.matmul`` rather than K2 (with
    ``blocksize``, op(A) a transposed BSR: rather than K1).  On the CPU
    the JAX package's rule, nnz / (m k) > 0.25 (``_xla.py:541-543``), so
    both packages take the same route on the same input; on the card the
    faster of the two cost models, dense A within DENSE_CAP_BYTES."""
    if device.type == "cpu":
        return nnz / max(m * k, 1) > 0.25
    if m * k * dtype.itemsize > DENSE_CAP_BYTES:
        return False
    dense_s = (_DENSE_ROUTE_S + _densify_seconds(m * k, nnz, dtype)
               + _matmul_seconds(m, k, n, dtype))
    if blocksize is not None:
        return dense_s < _k1_seconds(nnz, n, dtype, blocksize)
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


def _prefer_densify_sparse_product(m, k, n, a_nnz, b_nnz, dtype, device,
                                   one_operand=False, triangular=False):
    """Whether op(A) (m x k, ``a_nnz`` entries) @ op(B) (k x n, ``b_nnz``)
    with sparse output (only j >= i with ``triangular``) should run as the
    densify route (``densified_sparse_product``) rather than K4 + K5;
    ``one_operand``: op(B) is op(A)'s transpose view (or op(A) itself),
    densified once.  The products are estimated as a_nnz * b_nnz / k and
    C's entries as the positions that a product reaches when the products
    fall at random, m n (1 - exp(-products / (m n))).  On the CPU the
    dense-output rule (``_prefer_densify_product``); on the card the
    faster of the two cost models, the dense operands, their indicators,
    C, P and K13's output (sized for all m n positions) within
    DENSE_CAP_BYTES."""
    products = a_nnz * b_nnz / max(k, 1)
    if device.type == "cpu":
        return products > 0.25 * m * k * n
    elements = m * k if one_operand else m * k + k * n
    item = dtype.itemsize
    if (elements + m * n) * (item + 2) + m * n * (item + 8) > DENSE_CAP_BYTES:
        return False
    entries = -m * n * math.expm1(-products / max(m * n, 1))
    fixed, per_product, per_log, per_entry, spread, triangular_share = \
        _K45_S[dtype]
    lo, hi = _K45_ROWS
    row = min(max(products / max(m, 1), lo), hi)
    per_product = ((per_product + per_log * math.log(hi / row))
                   * (1 + spread / max(m, 1)))
    share = triangular_share if triangular else 1.0
    nnz = a_nnz if one_operand else a_nnz + b_nnz
    dense_s = (_DENSE_SPARSE_S[0 if one_operand else 1]
               + _densify_seconds(elements, nnz, dtype)
               + _densify_seconds(elements, nnz, torch.bfloat16)
               + _matmul_seconds(m, k, n, dtype)
               + _matmul_seconds(m, k, n, torch.bfloat16)
               + _K13_S * (4 * m * n + share * entries * (2 * item + 4)))
    return dense_s < fixed + share * (per_product * products
                                      + per_entry * entries)


def _host_read(total, checks):
    """One device-to-host copy of ``total`` (a 0-d int64 device tensor, or
    None) and of the finite flags of ``checks``, (flag, container, dtype)
    with a flag a Python bool (known: not read) or a 0-d bool device tensor
    (``Planes.finite``; container None for a flag of no container's
    planes).  Each flag read is recorded in its container's planes
    (``note_finite``).  Returns (total as an int or None, whether every
    flag is true); no copy when there is nothing to read."""
    pending = [(f, M, dt) for f, M, dt in checks if not isinstance(f, bool)]
    parts = [t.reshape(1).long() for t in
             ([] if total is None else [total]) + [f for f, _, _ in pending]]
    values = torch.cat(parts).tolist() if parts else []
    count = None if total is None else values.pop(0)
    for (_, M, dt), v in zip(pending, values):
        if M is not None:
            M.note_finite(dt, v)
    known = all(f for f, _, _ in checks if isinstance(f, bool))
    return count, known and all(values)


def densified_spmm(A, b, transpose, alpha=None, beta=None, c0=None):
    """The densify route of ``_spmm_pass``: ``alpha * op(A) @ b + beta *
    c0`` as K12 on A's stored arrays (or A's kept planes,
    ``dense_planes``) and one ``torch.matmul`` (the port of
    ``_xla.spmm_densified_sorted`` and ``spmm_planes``), the epilogue as
    the plain versions apply it (``dense.axpby``).  The product is enqueued
    first and the finite flag of b (for complex values A's values too,
    which a BLAS complex product meets with another inf rule, unless A's
    planes know it) read on the host after it, so the read waits for the
    card instead of the card for the read.  None when a value is not
    finite (the product is dropped): a densified A meets every entry of b
    with its zeros, and 0 * inf is NaN where scipy and K2 have no term."""
    planes = A.dense_planes(transpose, b.dtype, indicator=False)
    checks = [(torch.isfinite(b.sum()), None, None)]
    if b.is_complex():
        if planes.finite is False:
            return None
        checks.append((planes.finite, A, b.dtype))
    if b.is_cuda:
        dense.ieee_matmul()
    c = dense.axpby(torch.matmul(planes.dense, b), alpha, beta, c0)
    return c if _host_read(None, checks)[1] else None


def _spmm_pass(A, b, transpose, alpha=None, beta=None, c0=None):
    """``alpha * op(A) @ b + beta * c0`` on the device (the port of
    ``host._real_spmm``): an untransposed BSR on K1; the rest on the
    densify route (``densified_spmm``) where ``_prefer_densify`` says so
    (against K1's forecast for a BSR, K2's for CSR and CSC) and the values
    it meets are finite, else on K1 over the transposed blocks (BSR) or K2
    (CSR, CSC)."""
    is_bsr = isinstance(A, formats.BSR)
    if is_bsr and not transpose:
        return bsr.bsr_spmm(*A.bsr_arrays(), b, alpha, beta, c0,
                            plan=A.bsr_plan())
    m, k = A.shape[::-1] if transpose else A.shape
    if _prefer_densify(m, k, b.shape[1], A.nnz, b.dtype, b.device,
                       A.blocksize[0] if is_bsr else None):
        c = densified_spmm(A, b, transpose, alpha, beta, c0)
        if c is not None:
            return c
    if is_bsr:
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
    ``triangular``.  The densify route (``densified_sparse_product``) where
    ``_prefer_densify_sparse_product`` favours it, no operand's values are
    tracked and both operands' values are finite, else K4 + K5 on op(A)'s
    and op(B)'s CSR arrays.  Reading the output's nnz is the one host
    sync."""
    if out_dtype is None:
        out_dtype = policy.output_dtype(A, B)
    m, n = A.shape[0], B.shape[1]
    dtype = formats.torch_dtype(out_dtype)
    if (not csr.tracked(A.data, B.data)
            and _prefer_densify_sparse_product(
                m, A.shape[1], n, A.nnz, B.nnz, dtype, A.data.device,
                B is A or transpose_pair(A, B), triangular)):
        C = densified_sparse_product(A, B, dtype, triangular)
        if C is not None:
            return C
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


def _operand_planes(A, B, dtype, indicator):
    """(op(A)'s planes, op(B)'s dense and indicator, the finite checks for
    ``_host_read``), None when a kept flag says a value is not finite.  One
    densify for a ``transpose_pair`` (op(B) is op(A)'s ``.mT``) and for
    A @ A."""
    pa = A.dense_planes(dtype=dtype, indicator=indicator)
    if transpose_pair(A, B) or B is A:
        flip = B is not A
        b_dense = pa.dense.mT if flip else pa.dense
        b_ind = None if pa.indicator is None else (
            pa.indicator.mT if flip else pa.indicator)
        checks = [(pa.finite, A, dtype)]
    else:
        pb = B.dense_planes(dtype=dtype, indicator=indicator)
        b_dense, b_ind = pb.dense, pb.indicator
        checks = [(pa.finite, A, dtype), (pb.finite, B, dtype)]
    if any(f is False for f, _, _ in checks):
        return None
    if pa.dense.is_cuda:
        dense.ieee_matmul()
    return pa, b_dense, b_ind, checks


def densified_product(A, B, dtype, beta=None, c0=None, triangular=False):
    """The densify route of ``spgemm_dense_device``: ``op(A) @ op(B) + beta
    * c0`` with dense output (only j >= i of the product with
    ``triangular``; ``c0`` added everywhere, as K6 adds it) as K12 on each
    operand's stored arrays (or its kept planes, ``dense_planes``), once
    for a ``transpose_pair``, and one ``torch.matmul`` (the port of
    ``_xla.spgemm_numeric_sorted`` and ``spgemm_numeric_planes``).  The
    product is enqueued first and the finite flags of both operands'
    stored values that the planes do not know read on the host after it;
    None when a value is not finite (the product is dropped): a densified
    operand meets the other's entries with its zeros, and 0 * inf is NaN
    where the structural product has no term."""
    operands = _operand_planes(A, B, dtype, indicator=False)
    if operands is None:
        return None
    pa, b, _, checks = operands
    c = torch.matmul(pa.dense, b)
    if triangular:
        c = c.triu_()
    c = dense.axpby(c, None, beta, c0)
    return c if _host_read(None, checks)[1] else None


def densified_sparse_product(A, B, dtype, triangular=False):
    """The densify route of ``spgemm_device``: op(A) @ op(B) with the
    structural pattern (only j >= i with ``triangular``) as a
    ``formats.CSR``, the port of ``_xla.spgemm_structural_extract`` and
    ``spgemm_structural_vals_planes``: each operand's dense values and bf16
    indicator (K12 and its indicator template, or the kept planes,
    ``dense_planes``; once for a ``transpose_pair``), one IEEE
    ``torch.matmul`` of the values and one bf16 ``torch.matmul`` of the
    indicators, P = ind(A) @ ind(B), whose terms are all >= 0, so P > 0
    exactly where a product is stored (explicit zeros included), then K13
    (``ops.compact.masked_compact``, one launch: count, running sum across
    tiles and fill), then one host copy of C's nnz with the finite flags
    the planes do not know.
    None when a value is not finite: a densified operand meets the other's
    entries with its zeros, and 0 * inf is NaN where the structural product
    has no term."""
    operands = _operand_planes(A, B, dtype, indicator=True)
    if operands is None:
        return None
    pa, b, b_ind, checks = operands
    c = torch.matmul(pa.dense, b)
    p = torch.matmul(pa.indicator, b_ind)
    *arrays, total = compact.masked_compact(c, p, triangular,
                                             index_dtype=A.indices.dtype)
    nnz, finite = _host_read(total, checks)
    if not finite:
        return None
    indptr, indices, data = compact.cut(arrays, nnz, B.shape[1])
    return formats.CSR(data, indices, indptr, (A.shape[0], B.shape[1]),
                       sorted_indices=True)


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
                               B is A or transpose_pair(A, B), triangular):
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
