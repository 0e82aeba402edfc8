"""Symmetric triple products: AᵀBA and ABAᵀ (sypr).

Port of ``sparse_dot_tpu/ops/sypr.py``, the working version of the
reference's dead ``_sparse_sypr.py`` module.  The triple product chains
two structural sparse products (``host.spgemm_sparse_arrays``: K4 + K5
on the card, or the structural densify route where its gate says so), so

* the output pattern is the structural pattern product
  ``1[op(A)]·1[B]·1[A]`` with exactly-cancelled entries kept as explicit
  zeros, as in every other sparse product of the package,
* on K4 + K5 no dense m×k or m×m intermediate is materialized: each
  product builds one output row at a time in an accumulator sized to
  that row; the densify route is taken only where its dense operands
  and product fit ``host.DENSE_CAP_BYTES``.
"""

import numpy as np
import scipy.sparse as sps

from .. import formats
from ..policy import (
    type_check,
    precision_flags,
    OUTPUT_DTYPES,
)
from . import host as _host


def _sparse_product(X, Y, out_dtype, triangular=False):
    """Structural sparse product X @ Y as a scipy CSR (explicit zeros
    preserved — ``sps.csr_matrix`` does not prune)."""
    data, indices, indptr = _host.spgemm_sparse_arrays(
        X, Y, out_dtype, triangular=triangular
    )
    return sps.csr_matrix(
        (data, indices, indptr), shape=(X.shape[0], Y.shape[1])
    )


def sypr(matrix_a, matrix_b, transpose=False, cast=False, dense=False):
    """Compute triu(Aᵀ B A) (or triu(A B Aᵀ) with ``transpose=True``)
    for sparse A and sparse symmetric B.

    CSR/BSR A, CSR/BSR B, optional dtype cast, sparse (CSR,
    upper-triangular structural pattern) or dense output, as the JAX
    package's ``sypr``.
    """
    if not (formats.is_csr(matrix_a) or formats.is_bsr(matrix_a)):
        raise ValueError("sypr requires matrix A in CSR or BSR format")
    if not (formats.is_csr(matrix_b) or formats.is_bsr(matrix_b)):
        raise ValueError("sypr requires matrix B in CSR or BSR format")

    matrix_a, matrix_b = type_check(matrix_a, matrix_b, cast=cast)

    dbl, cplx = precision_flags(matrix_a)
    out_dtype = np.dtype(OUTPUT_DTYPES[(dbl, cplx)])

    def _as_csr_device(mat):
        # BSR operands run through the CSR chain: the BSR container has
        # no transpose view, and the product's pattern and values are the
        # same either way.
        if formats.is_bsr(mat):
            mat = (mat if sps.issparse(mat) else mat.to_scipy()).tocsr()
        return formats.to_device(mat)

    A = _as_csr_device(matrix_a)
    B = _as_csr_device(matrix_b)

    if transpose:
        # A B Aᵀ : (m x k)(k x k)(k x m) -> m x m
        if A.shape[1] != B.shape[0] or B.shape[1] != A.shape[1]:
            raise ValueError(
                f"Bad shapes for A B Aᵀ: A {A.shape}, B {B.shape}"
            )
        inner = _sparse_product(B, A.T, out_dtype)  # k x m
        first = A
    else:
        # Aᵀ B A : (k x m)(m x m)(m x k) -> k x k
        if B.shape[0] != A.shape[0] or B.shape[1] != A.shape[0]:
            raise ValueError(
                f"Bad shapes for Aᵀ B A: A {A.shape}, B {B.shape}"
            )
        inner = _sparse_product(B, A, out_dtype)  # m x k
        first = A.T

    res = _sparse_product(
        first, formats.to_device(inner), out_dtype, triangular=True
    )

    if dense:
        return np.asarray(res.todense())
    return res
