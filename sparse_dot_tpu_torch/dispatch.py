"""Public polymorphic multiply API.

Port of ``sparse_dot_tpu/dispatch.py`` ``dot_product`` (the reference's
``sparse_dot.py:79-152``): routes by operand sparsity and shape to SpMM,
SpMV or GEMM, with the reference's keyword semantics — ``cast``,
``out``/``out_scalar`` accumulate into the caller's array, the
empty-output dtype rules, the memory-order rules (SpMM output follows B's
order, GEMM follows A's) and the error messages.  Inputs may be scipy
sparse matrices or arrays, numpy dense arrays, or this package's
containers.

Sparse x sparse (SpGEMM) is not ported yet (ROADMAP.md, Queue 1 item 5)
and raises ``NotImplementedError``.
"""

import warnings

import numpy as np

from . import formats
from . import policy
from .backend import torch_device
from .ops import host as _ops
from .utils.debug import debug_print, print_backend_debug, trace_phase

__all__ = ["dot_product"]


def _deprecated_debug(debug):
    if debug:
        warnings.warn(
            "Set debug mode with sparse_dot_tpu_torch.set_debug_mode(True)",
            DeprecationWarning,
        )


# ---------------------------------------------------------------------------
# sparse @ dense / dense @ sparse
# ---------------------------------------------------------------------------


def _sparse_dense_matmul(matrix_a, matrix_b, scalar=1.0, transpose=False,
                         out=None, out_scalar=None, out_t=None):
    """op(A_sparse) @ B_dense with alpha/beta accumulate; mirrors
    ``_sparse_dense_matmul`` (``_sparse_dense.py:34-133``)."""
    output_shape = (
        matrix_a.shape[1] if transpose else matrix_a.shape[0],
        matrix_b.shape[1],
    )
    layout_b, _ = policy.get_dense_layout(matrix_b, second_arr=out)

    dbl, cplx = policy.precision_flags(matrix_a)
    out_dtype = np.dtype(policy.OUTPUT_DTYPES[(dbl, cplx)])

    output_order = "C" if layout_b == policy.LAYOUT_C else "F"
    out_validated = policy.out_matrix(
        output_shape, out_dtype, output_order, out_arr=out, out_t=out_t
    )

    A = formats.to_device(matrix_a)
    with trace_phase("spmm"):
        res = _ops.spmm(
            A,
            matrix_b,
            out_dtype,
            alpha=scalar,
            out=out,
            out_scalar=out_scalar,
            transpose=transpose,
        )

    if out is not None:
        out_validated[...] = res
        return out_validated
    if output_order == "F":
        return np.asfortranarray(res)
    return np.ascontiguousarray(res)


def _sparse_dot_dense(matrix_a, matrix_b, cast=False, scalar=1.0, out=None,
                      out_scalar=None):
    policy.sanity_check(matrix_a, matrix_b)

    if policy.empty_output_check(matrix_a, matrix_b):
        debug_print(
            "Skipping multiplication because A (dot) B must yield an "
            "empty matrix"
        )
        final_dtype = policy.empty_result_dtype(matrix_a, matrix_b)
        return policy.out_matrix(
            (matrix_a.shape[0], matrix_b.shape[1]), final_dtype, out_arr=out
        )

    matrix_a, matrix_b = policy.type_check(matrix_a, matrix_b, cast=cast)

    if formats.issparse(matrix_a):
        return _sparse_dense_matmul(
            matrix_a, matrix_b, scalar=scalar, out=out, out_scalar=out_scalar
        )
    if formats.issparse(matrix_b) and out is not None:
        _sparse_dense_matmul(
            matrix_b,
            matrix_a.T,
            scalar=scalar,
            transpose=True,
            out=out.T,
            out_scalar=out_scalar,
            out_t=True,
        )
        return out
    if formats.issparse(matrix_b):
        return _sparse_dense_matmul(
            matrix_b, matrix_a.T, scalar=scalar, transpose=True
        ).T
    raise ValueError("_sparse_dot_dense takes one sparse and one dense array")


# ---------------------------------------------------------------------------
# sparse @ vector
# ---------------------------------------------------------------------------


def _sparse_dense_vector_mult(matrix_a, vector_b, scalar=1.0,
                              transpose=False, out=None, out_scalar=None,
                              out_t=None):
    out_len = matrix_a.shape[1] if transpose else matrix_a.shape[0]
    output_shape = (out_len,) if vector_b.ndim == 1 else (out_len, 1)

    if policy.empty_output_check(matrix_a, vector_b):
        final_dtype = policy.empty_result_dtype(matrix_a, vector_b)
        return policy.out_matrix(output_shape, final_dtype, out_arr=out)

    dbl, cplx = policy.precision_flags(matrix_a)
    out_dtype = np.dtype(policy.OUTPUT_DTYPES[(dbl, cplx)])

    out_validated = policy.out_matrix(
        output_shape, out_dtype, out_arr=out, out_t=out_t
    )

    A = formats.to_device(matrix_a)
    with trace_phase("spmv"):
        res = _ops.spmv(
            A,
            np.asarray(vector_b).ravel(),
            out_dtype,
            alpha=scalar,
            out=out.ravel() if out is not None else None,
            out_scalar=out_scalar,
            transpose=transpose,
        )

    res = res.reshape(output_shape)
    if out is not None:
        out_validated[...] = res
        return out_validated
    return res


def _sparse_dot_vector(mv_a, mv_b, cast=False, scalar=1.0, out=None,
                       out_scalar=None):
    policy.sanity_check(mv_a, mv_b, allow_vector=True)
    mv_a, mv_b = policy.type_check(mv_a, mv_b, cast=cast)

    if not policy.allowed_sparse_format(mv_a) or not (
        policy.allowed_sparse_format(mv_b)
    ):
        raise ValueError(
            "Only CSR, CSC, and BSR-type sparse matrices are supported"
        )
    if policy.is_dense_vector(mv_b):
        return _sparse_dense_vector_mult(
            mv_a, mv_b, scalar=scalar, out=out, out_scalar=out_scalar
        )
    if policy.is_dense_vector(mv_a) and out is None:
        return _sparse_dense_vector_mult(
            mv_b, mv_a.T, scalar=scalar, transpose=True
        ).T
    if policy.is_dense_vector(mv_a):
        _sparse_dense_vector_mult(
            mv_b,
            mv_a.T,
            scalar=scalar,
            transpose=True,
            out=out.T,
            out_scalar=out_scalar,
            out_t=True,
        )
        return out
    raise ValueError("Neither mv_a or mv_b is a dense vector")


# ---------------------------------------------------------------------------
# dense @ dense
# ---------------------------------------------------------------------------


def _dense_matmul(matrix_a, matrix_b, scalar=1.0, out=None, out_scalar=None):
    dbl, cplx = policy.precision_flags(matrix_a)
    out_dtype = np.dtype(policy.OUTPUT_DTYPES[(dbl, cplx)])

    flatten_output = matrix_b.ndim == 1
    matrix_b = matrix_b.reshape(-1, 1) if flatten_output else matrix_b

    output_shape = (matrix_a.shape[0], matrix_b.shape[1])

    layout_a, _ = policy.get_dense_layout(matrix_a)
    out_order = "C" if layout_a == policy.LAYOUT_C else "F"

    out_validated = policy.out_matrix(
        output_shape, out_dtype, order=out_order, out_arr=out
    )

    with trace_phase("gemm"):
        res = _ops.gemm(
            matrix_a,
            matrix_b,
            out_dtype,
            alpha=scalar,
            out=out,
            out_scalar=out_scalar,
        )

    if out is not None:
        out_validated[...] = res
        result = out_validated
    elif out_order == "F":
        result = np.asfortranarray(res)
    else:
        result = np.ascontiguousarray(res)

    return result.ravel() if flatten_output else result


def _dense_dot_dense(matrix_a, matrix_b, cast=False, scalar=1.0, out=None,
                     out_scalar=None):
    policy.sanity_check(matrix_a, matrix_b, allow_vector=True)

    if policy.empty_output_check(matrix_a, matrix_b):
        debug_print(
            "Skipping multiplication because A (dot) B must yield an "
            "empty matrix"
        )
        final_dtype = policy.empty_result_dtype(matrix_a, matrix_b)
        return policy.out_matrix(
            (matrix_a.shape[0], matrix_b.shape[1]), final_dtype, out_arr=out
        )

    matrix_a, matrix_b = policy.type_check(matrix_a, matrix_b, cast=cast)
    return _dense_matmul(
        matrix_a, matrix_b, scalar=scalar, out=out, out_scalar=out_scalar
    )


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------


def dot_product(matrix_a, matrix_b, cast=False, copy=True,
                reorder_output=False, dense=False, debug=False, out=None,
                out_scalar=None):
    """Multiply two matrices on ``config.device``.

    Drop-in analog of ``dot_product_mkl`` (``sparse_dot.py:18-152``):
    inputs may be scipy sparse (CSR/CSC/BSR), numpy dense, or containers,
    in float32/float64/complex64/complex128.  Routing:

    * sparse @ vector / vector @ sparse -> SpMV (kernel K3)
    * sparse @ dense / dense @ sparse -> SpMM (K2 for CSR/CSC, K1 for BSR)
    * vector @ vector -> np.dot special case
    * dense @ dense -> GEMM
    * sparse @ sparse -> not ported yet (``NotImplementedError``)

    With ``config.device == "cuda"`` and no visible card this raises
    before any work.
    """
    _deprecated_debug(debug)
    torch_device()
    print_backend_debug()

    num_sparse = sum((formats.issparse(matrix_a), formats.issparse(matrix_b)))

    if num_sparse == 2:
        raise NotImplementedError(
            "sparse @ sparse (SpGEMM) is not ported to sparse_dot_tpu_torch "
            "yet; see ROADMAP.md, Queue 1 item 5"
        )

    if (
        num_sparse == 1
        and policy.is_dense_vector(matrix_a)
        and (matrix_a.ndim == 1 or matrix_a.shape[0] == 1)
    ):
        return _sparse_dot_vector(
            matrix_a, matrix_b, cast=cast, out=out, out_scalar=out_scalar
        )

    if (
        num_sparse == 1
        and policy.is_dense_vector(matrix_b)
        and (matrix_b.ndim == 1 or matrix_b.shape[1] == 1)
    ):
        return _sparse_dot_vector(
            matrix_a, matrix_b, cast=cast, out=out, out_scalar=out_scalar
        )

    if num_sparse == 1:
        return _sparse_dot_dense(
            matrix_a, matrix_b, cast=cast, out=out, out_scalar=out_scalar
        )

    if (
        policy.is_dense_vector(matrix_a)
        and policy.is_dense_vector(matrix_b)
        and (matrix_a.ndim == 1 or matrix_b.ndim == 1)
    ):
        # The reference delegates this edge straight to numpy
        # (``sparse_dot.py:135-142``), including its out-scaling quirk.
        if out_scalar is not None:
            out *= out_scalar
        return np.dot(matrix_a, matrix_b, out=out)

    return _dense_dot_dense(
        matrix_a, matrix_b, cast=cast, out=out, out_scalar=out_scalar
    )
