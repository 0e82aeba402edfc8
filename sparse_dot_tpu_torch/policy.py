"""The behavioral-contract layer: dtype policy, shape sanity, layout
probing, and ``out=`` validation.

Port of ``sparse_dot_tpu/policy.py``, whose rules and messages it keeps
word for word: the policy half of the reference's
``sparse_dot_mkl/_mkl_interface/_common.py`` — the semantics a drop-in
user relies on:

* dtype policy (``_type_check``, ``_common.py:773-866``): float32/float64/
  complex64/complex128 only; equal dtypes pass through by reference; with
  ``cast=True`` mixed reals upcast to float64, mixed complex to complex128,
  real+complex pairs upcast to the complex operand's dtype; any non-float
  dtype casts to float64; ``cast=False`` mismatches raise ValueError.
* ``out=`` validation (``_out_matrix``, ``_common.py:885-955``): shape,
  dtype, memory order, and contiguity must match exactly, with the
  transposed-view reporting rule for right-sparse products.
* shape sanity (``_sanity_check``, ``_common.py:725-752``) and empty-output
  short-circuits (``_empty_output_check``, ``_common.py:1003-1024``).
* dense layout probing (``_get_numpy_layout``, ``_common.py:181-213``).
"""

import numpy as np
import scipy.sparse as _sps

from .formats import (
    is_csr,
    is_csc,
    is_bsr,
    is_device_sparse,
    issparse,
)
from .utils.debug import debug_print

VALID_REAL = (np.dtype(np.float32), np.dtype(np.float64))
VALID_COMPLEX = (np.dtype(np.complex64), np.dtype(np.complex128))
VALID_ALL = VALID_REAL + VALID_COMPLEX

LAYOUT_C = "C"
LAYOUT_F = "F"


# ---------------------------------------------------------------------------
# dtype policy
# ---------------------------------------------------------------------------


def _dtype_of(m):
    return np.dtype(m.dtype)


def _valid_dtype(m, kinds=VALID_ALL):
    return _dtype_of(m) in kinds


def _iscomplex(m):
    return _dtype_of(m) in VALID_COMPLEX


def _cast_to(matrix, dtype):
    """astype copy only when needed — equal dtype returns the same object
    (identity is asserted by the reference's type tests)."""
    return matrix.astype(dtype) if _dtype_of(matrix) != np.dtype(dtype) else matrix


def type_check(matrix_a, matrix_b=None, cast=False, allow_complex=True):
    """Dtype policy for one or two operands.  See module docstring for the
    rule table; mirrors ``_type_check`` (``_common.py:773-866``)."""

    n_complex = int(np.iscomplexobj(matrix_a)) + int(
        matrix_b is not None and np.iscomplexobj(matrix_b)
    )
    if not allow_complex and n_complex > 0:
        raise ValueError("Complex datatypes are not supported")

    if matrix_b is None:
        if _valid_dtype(matrix_a):
            return matrix_a
        if cast:
            target = np.complex128 if n_complex else np.float64
            return _cast_to(matrix_a, target)
        raise ValueError(
            "Matrix data type must be float32, float64, complex64, or "
            f"complex128; {_dtype_of(matrix_a)} provided"
        )

    a_dt, b_dt = _dtype_of(matrix_a), _dtype_of(matrix_b)

    if _valid_dtype(matrix_a) and a_dt == b_dt:
        return matrix_a, matrix_b

    if not cast:
        raise ValueError(
            "Matrix data types must be float32, float64, complex64, or "
            "complex128, and must be the same if cast=False; "
            f"{a_dt} & {b_dt} provided"
        )

    if n_complex == 0:
        debug_print(f"Recasting {a_dt} and {b_dt} to float64")
        return _cast_to(matrix_a, np.float64), _cast_to(matrix_b, np.float64)
    if n_complex == 2:
        debug_print(f"Recasting {a_dt} and {b_dt} to complex128")
        return (
            _cast_to(matrix_a, np.complex128),
            _cast_to(matrix_b, np.complex128),
        )
    # Exactly one complex operand: upcast the real one to the complex
    # operand's dtype when that dtype is itself valid; otherwise both to
    # complex128.
    if _valid_dtype(matrix_a, VALID_COMPLEX):
        return matrix_a, _cast_to(matrix_b, a_dt)
    if _valid_dtype(matrix_b, VALID_COMPLEX):
        return _cast_to(matrix_a, b_dt), matrix_b
    return (
        _cast_to(matrix_a, np.complex128),
        _cast_to(matrix_b, np.complex128),
    )


def precision_flags(matrix):
    """(double_precision, is_complex) for a valid-dtype operand; mirrors
    ``_is_double`` (``_common.py:964-986``)."""
    dt = _dtype_of(matrix)
    if dt == np.dtype(np.float32):
        return False, False
    if dt == np.dtype(np.float64):
        return True, False
    if dt == np.dtype(np.complex64):
        return False, True
    if dt == np.dtype(np.complex128):
        return True, True
    raise ValueError(
        "Only float32, float64, complex64, and complex128 dtypes are "
        "supported"
    )


OUTPUT_DTYPES = {
    (False, False): np.float32,
    (True, False): np.float64,
    (False, True): np.complex64,
    (True, True): np.complex128,
}


def output_dtype(matrix_a, matrix_b=None):
    """Result dtype of a product of validated operands."""
    dbl_a, cplx_a = precision_flags(matrix_a)
    if matrix_b is None:
        return np.dtype(OUTPUT_DTYPES[(dbl_a, cplx_a)])
    dbl_b, cplx_b = precision_flags(matrix_b)
    return np.dtype(OUTPUT_DTYPES[(dbl_a or dbl_b, cplx_a or cplx_b)])


def empty_result_dtype(matrix_a, matrix_b):
    """Dtype rule for empty-output short circuits: float32 only when both
    operands are float32, else float64 (``_sparse_dense.py:168-172``)."""
    if (
        _dtype_of(matrix_a) == _dtype_of(matrix_b)
        and _dtype_of(matrix_a) == np.dtype(np.float32)
    ):
        return np.float32
    return np.float64


# ---------------------------------------------------------------------------
# shape / format sanity
# ---------------------------------------------------------------------------


def is_dense_vector(m):
    """Dense with ndim==1 or a 2-d array with a unit dimension
    (``_common.py:958-961``)."""
    return not issparse(m) and (
        m.ndim == 1 or (m.ndim == 2 and min(m.shape) == 1)
    )


def allowed_sparse_format(matrix):
    """Dense, or a CSR/CSC/BSR sparse type (``_common.py:989-1000``)."""
    if issparse(matrix):
        return is_csr(matrix) or is_csc(matrix) or is_bsr(matrix)
    return True


def sanity_check(matrix_a, matrix_b, allow_vector=False):
    """Shape compatibility / dimensionality checks
    (``_common.py:725-752``)."""

    a_2d, b_2d = matrix_a.ndim == 2, matrix_b.ndim == 2
    a_vec, b_vec = is_dense_vector(matrix_a), is_dense_vector(matrix_b)

    if not allow_vector and not (a_2d and b_2d):
        raise ValueError(
            f"Matrices must be 2d: {matrix_a.shape} * {matrix_b.shape} "
            "is not valid"
        )

    invalid_ndims = not (a_2d or a_vec) or not (b_2d or b_vec)
    inner_a = matrix_a.shape[0] if matrix_a.ndim == 1 else matrix_a.shape[1]
    if invalid_ndims or inner_a != matrix_b.shape[0]:
        raise ValueError(
            f"Matrix alignment error: {matrix_a.shape} * {matrix_b.shape} "
            "is not valid"
        )


def empty_output_check(matrix_a, matrix_b):
    """True when the product is trivially empty
    (``_common.py:1003-1024``)."""
    if min([*matrix_a.shape, *matrix_b.shape]) == 0:
        return True
    for m in (matrix_a, matrix_b):
        if _sps.issparse(m) and min(m.data.size, m.indices.size) == 0:
            return True
        if is_device_sparse(m) and m.nnz == 0:
            return True
    return False


# ---------------------------------------------------------------------------
# dense layout probing
# ---------------------------------------------------------------------------


def get_dense_layout(arr, second_arr=None):
    """Return ("C"|"F", leading_dimension) for a contiguous numpy array,
    deferring to ``second_arr``'s order when ``arr`` is 1-d/ambiguous
    (``_get_numpy_layout``, ``_common.py:181-213``)."""
    is_c = arr.flags.c_contiguous
    is_f = arr.flags.f_contiguous

    if is_c and is_f and second_arr is not None:
        if second_arr.flags.c_contiguous:
            return LAYOUT_C, arr.shape[-1]
        if second_arr.flags.f_contiguous:
            return LAYOUT_F, arr.shape[0]
    if is_c:
        return LAYOUT_C, arr.shape[-1]
    if is_f:
        return LAYOUT_F, arr.shape[0]
    raise ValueError("Array is not contiguous")


# ---------------------------------------------------------------------------
# out= validation
# ---------------------------------------------------------------------------


def _describe_out(arr, shape, dtype, order, transposed_view):
    """Build the have/need halves of the out-mismatch message.

    When the product was computed through a transposed view of ``out``
    (right-sparse paths), both halves are reported in the USER's
    orientation: shapes flip back and the effective memory order
    inverts (a C-contiguous buffer seen through ``.T`` is F-ordered
    from the caller's side).
    """
    is_c = arr.flags["C_CONTIGUOUS"]
    is_f = arr.flags["F_CONTIGUOUS"]
    if transposed_view and arr.ndim > 1:
        have_shape = arr.shape[::-1]
        need_shape = tuple(shape)[::-1]
        have_order = "F" if (is_c and not is_f) else "C"
        need_order = "F" if order == "C" else "C"
    else:
        have_shape = arr.shape
        need_shape = tuple(shape)
        have_order = "C" if is_c else "F"
        need_order = order
    contig = "CONTIGUOUS" if arr.data.contiguous else "NONCONTIGUOUS"
    need_dtype = getattr(dtype, "__name__", None) or np.dtype(dtype).name
    have = f"{have_shape} {arr.dtype} [{have_order}_{contig}]"
    need = f"{need_shape} {need_dtype} [{need_order}_CONTIGUOUS]"
    return have, need


def out_matrix(shape, dtype, order="C", out_arr=None, out_t=False):
    """Allocate the output buffer, or validate a caller-supplied ``out``.

    The contract (same as the reference's ``out=`` semantics,
    ``_common.py:885-955``): ``out`` must match the product's shape,
    dtype, memory order, and be contiguous — EXACTLY, since the result
    is written into it in place and the same object is returned.  Any
    mismatch raises with a have/need description (reported through the
    transposed view when ``out_t`` is set).
    """
    if out_arr is None:
        return np.zeros(shape, dtype=dtype, order=order)

    wanted_flag = "C_CONTIGUOUS" if order == LAYOUT_C else "F_CONTIGUOUS"
    ok = (
        out_arr.shape == tuple(shape)
        and out_arr.dtype == np.dtype(dtype)
        and out_arr.flags[wanted_flag]
        and out_arr.data.contiguous
    )
    if not ok:
        have, need = _describe_out(
            out_arr, shape, dtype, order, bool(out_t)
        )
        raise ValueError(
            f"Provided out array is {have} and product requires {need}"
        )
    return out_arr
