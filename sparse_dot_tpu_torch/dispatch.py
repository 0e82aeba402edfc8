"""Public polymorphic multiply API.

Port of ``sparse_dot_tpu/dispatch.py`` ``dot_product`` (the reference's
``sparse_dot.py:79-152``) and ``gram_matrix`` (``sparse_dot.py:155-242``):
routes by operand sparsity and shape to SpGEMM, SpMM, SpMV or GEMM, with
the reference's keyword semantics — ``cast``, ``dense``,
``reorder_output``, ``out``/``out_scalar`` accumulate into the caller's
array, the empty-output dtype rules, the memory-order rules (SpMM output
follows B's order, GEMM follows A's) and the error messages.  Inputs may
be scipy sparse matrices or arrays, numpy dense arrays, or this package's
containers.
"""

import warnings

import numpy as np
import scipy.sparse as _sps

from . import formats
from . import policy
from .backend import torch_device
from .ops import host as _ops
from .solvers.qr import sparse_qr_solver
from .utils.debug import debug_print, print_backend_debug, trace_phase

__all__ = ["dot_product", "gram_matrix", "sparse_qr_solve"]


def _deprecated_debug(debug):
    if debug:
        warnings.warn(
            "Set debug mode with sparse_dot_tpu_torch.set_debug_mode(True)",
            DeprecationWarning,
        )


def _scipy_blocksize(mat):
    if formats.is_bsr(mat):
        return tuple(mat.blocksize)
    return None


# ---------------------------------------------------------------------------
# sparse @ sparse
# ---------------------------------------------------------------------------


def _same_array(x, y):
    """Whether two numpy arrays are the same memory read the same way."""
    return (x.shape == y.shape and x.dtype == y.dtype
            and x.strides == y.strides
            and x.__array_interface__["data"][0]
            == y.__array_interface__["data"][0])


def _transpose_view(matrix_a, matrix_b):
    """Whether scipy ``matrix_b`` is ``matrix_a.T``: the same arrays read
    as the other of CSR and CSC, the shape transposed.  Its container is
    then the zero-cost view ``A.T`` of A's (one upload; a dense-output
    product densifies once, ``ops.host.transpose_pair``)."""
    return (_sps.issparse(matrix_a) and _sps.issparse(matrix_b)
            and {matrix_a.format, matrix_b.format} == {"csr", "csc"}
            and matrix_b.shape == matrix_a.shape[::-1]
            and all(_same_array(getattr(matrix_a, name),
                                getattr(matrix_b, name))
                    for name in ("data", "indices", "indptr")))


def _sparse_dot_sparse(matrix_a, matrix_b, cast=False, reorder_output=False,
                       dense=False, out=None):
    if not policy.allowed_sparse_format(matrix_a) or not (
        policy.allowed_sparse_format(matrix_b)
    ):
        raise ValueError(
            "Input matrices to dot_product must be CSR, CSC, or BSR; "
            "COO is not supported"
        )

    if out is not None and not dense:
        raise ValueError(
            "out argument cannot be used with sparse (dot) sparse "
            "matrix multiplication unless dense=True"
        )

    default_output, output_type = formats.sparse_output_type(matrix_a)
    blocksize = _scipy_blocksize(matrix_a)

    policy.sanity_check(matrix_a, matrix_b)

    output_shape = (matrix_a.shape[0], matrix_b.shape[1])

    if policy.empty_output_check(matrix_a, matrix_b):
        if dense:
            return policy.out_matrix(
                output_shape, matrix_a.dtype, out_arr=out
            )
        return _empty_sparse(
            default_output, output_type, output_shape, matrix_a.dtype,
            blocksize,
        )

    matrix_a, matrix_b = policy.type_check(matrix_a, matrix_b, cast=cast)
    out_dtype = policy.output_dtype(matrix_a, matrix_b)

    A = formats.to_device(matrix_a)
    B = (A.T if _transpose_view(matrix_a, matrix_b)
         else formats.to_device(matrix_b))

    if dense:
        # spmmd semantics: the product overwrites out (no accumulation).
        out_validated = policy.out_matrix(
            output_shape, out_dtype, "C", out_arr=out
        )
        with trace_phase("spgemm_dense"):
            res = _ops.spgemm_dense(A, B, out_dtype)
        out_validated[...] = res
        return out_validated

    with trace_phase("spgemm"):
        data, indices, indptr = _ops.spgemm_sparse_arrays(A, B, out_dtype)
    # reorder_output is satisfied: K5 writes each row's columns sorted.
    return _build_sparse_output(
        default_output, output_type, output_shape, data, indices, indptr,
        blocksize,
    )


def _empty_sparse(constructor, output_type, shape, dtype, blocksize):
    if output_type.startswith("bsr"):
        return constructor(shape, dtype=dtype, blocksize=blocksize)
    return constructor(shape, dtype=dtype)


def _build_sparse_output(constructor, output_type, shape, data, indices,
                         indptr, blocksize):
    csr = _sps.csr_matrix((data, indices, indptr), shape=shape)
    if output_type.startswith("csr"):
        return constructor(csr) if constructor is not _sps.csr_matrix else csr
    if output_type.startswith("csc"):
        return constructor(csr.tocsc())
    if output_type.startswith("bsr"):
        return constructor(csr.tobsr(blocksize=blocksize))
    raise ValueError(f"Unknown output type {output_type}")


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
# sharded operands (the torch.distributed layer)
# ---------------------------------------------------------------------------


def _sharded_dot_product(matrix_a, matrix_b, cast=False, dense=False,
                         reorder_output=False, out=None, out_scalar=None):
    """Route ``dot_product`` on sharded operands to ``parallel.ops``
    (``sparse_dot_tpu/dispatch.py:361-466``): A must be the sharded
    operand, built with a mesh; B a dense array (by A's layout: the ring,
    the contraction partition, or the row partition's SpMV / SpMM) or a
    ShardedCSR sharded along k (the ring SpGEMM, sparse output).  The
    single-device keyword contract holds: ``out``/``out_scalar`` accumulate
    into the caller's array, which is returned; ``out`` without ``dense``
    and ``dense=True`` on sparse @ sparse follow the reference's rules;
    dtype mismatches follow ``cast``.  An unsharded sparse B raises a
    ``ValueError`` that names it."""
    from .parallel import ops as pops

    if not isinstance(matrix_a, pops.ShardedCSR):
        raise ValueError(
            "dot_product with a sharded operand requires the SHARDED "
            "matrix on the left (dense @ sharded is not supported)"
        )
    mesh = matrix_a.mesh
    if mesh is None:
        raise ValueError(
            "ShardedCSR must be built with a mesh (shard_csr_rows(..., "
            "mesh=...)) to be used with dot_product"
        )

    if isinstance(matrix_b, pops.ShardedCSR):
        if dense:
            raise NotImplementedError(
                "dense=True is not supported for sharded @ sharded "
                "products (the output is assembled as sparse CSR)"
            )
        if out is not None:
            raise ValueError(
                "out argument cannot be used with sparse (dot) sparse "
                "matrix multiplication unless dense=True"
            )
        if np.dtype(matrix_a.dtype) != np.dtype(matrix_b.dtype):
            if not cast:
                raise ValueError(
                    "Matrix dtypes must be identical; set cast=True or "
                    "build both sharded operands at the same dtype "
                    f"(got {matrix_a.dtype} and {matrix_b.dtype})"
                )
            raise NotImplementedError(
                "cast=True cannot re-type mesh-sharded operands; build "
                "the shards at the common dtype (shard_csr_*(A.astype(...)))"
            )
        if matrix_a.layout != "grid":
            raise ValueError(
                "sharded @ sharded requires A partitioned with "
                "shard_csr_grid (row + column blocks)"
            )
        res = pops.sharded_spgemm(mesh, matrix_a, matrix_b,
                                  axis=matrix_a.axis)
        if reorder_output:
            res.sort_indices()
        return res

    if formats.issparse(matrix_b):
        raise ValueError(
            "dot_product with a sharded A takes a dense B or a ShardedCSR "
            "B (shard_csr_krows); got an unsharded sparse "
            f"{type(matrix_b).__name__}: shard it with shard_csr_krows or "
            "densify it"
        )
    b = np.asarray(matrix_b)
    a_dt, b_dt = np.dtype(matrix_a.dtype), np.dtype(b.dtype)
    if a_dt != b_dt:
        if not cast:
            raise ValueError(
                "Matrix dtypes must be identical; set cast=True to "
                f"upcast the dense operand (got {a_dt} and {b_dt})"
            )
        promoted = np.promote_types(a_dt, b_dt)
        if promoted != a_dt:
            raise NotImplementedError(
                "cast=True would need to upcast the mesh-sharded "
                f"operand ({a_dt} -> {promoted}); build the shards at "
                "the promoted dtype instead"
            )
        b = b.astype(promoted)

    b2 = b.reshape(-1, 1) if b.ndim == 1 else b
    if matrix_a.layout == "grid":
        res = pops.sharded_spmm_ring(mesh, matrix_a, b2, axis=matrix_a.axis)
    elif matrix_a.layout == "cols":
        res = pops.sharded_spmm_2d(mesh, matrix_a, b2, axis=matrix_a.axis)
    elif b.ndim == 1:
        res = pops.sharded_spmv(mesh, matrix_a, b, axis=matrix_a.axis)
    else:
        res = pops.sharded_spmm(mesh, matrix_a, b, axis=matrix_a.axis)
    res = res.cpu().numpy()
    if b.ndim == 1:
        res = res.reshape(-1)

    if out is None:
        return res
    out_validated = policy.out_matrix(
        res.shape, res.dtype, "C", out_arr=out
    )
    beta = 1.0 if out_scalar is None else out_scalar
    out_validated[...] = res + beta * out_validated
    return out_validated


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

    * sparse @ sparse -> SpGEMM: sparse output in A's format (K4 + K5, or
      K12 + two ``torch.matmul`` + K13 where the densify gate says so),
      or dense with ``dense=True`` (K6, or K12 + ``torch.matmul``)
    * sparse @ vector / vector @ sparse -> SpMV (kernel K3)
    * sparse @ dense / dense @ sparse -> SpMM (K2 for CSR/CSC, K1 for BSR,
      or K12 + ``torch.matmul`` where the densify gate says so)
    * vector @ vector -> np.dot special case
    * dense @ dense -> GEMM

    * a ``ShardedCSR`` operand -> the sharded layer (``parallel``), on
      the ranks of its mesh

    With ``config.device == "cuda"`` (the default) and no visible card
    this raises before any work.
    """
    _deprecated_debug(debug)
    torch_device()
    print_backend_debug()

    from .parallel.ops import ShardedCSR

    if isinstance(matrix_a, ShardedCSR) or isinstance(matrix_b, ShardedCSR):
        return _sharded_dot_product(
            matrix_a, matrix_b, cast=cast, dense=dense,
            reorder_output=reorder_output, out=out, out_scalar=out_scalar,
        )

    num_sparse = sum((formats.issparse(matrix_a), formats.issparse(matrix_b)))

    if num_sparse == 2:
        return _sparse_dot_sparse(
            matrix_a, matrix_b, cast=cast, reorder_output=reorder_output,
            dense=dense, out=out,
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


def gram_matrix(matrix, transpose=False, cast=False, dense=False,
                debug=False, reorder_output=False, out=None,
                out_scalar=None, allow_complex=False):
    """Gram matrix AᵀA (or AAᵀ with ``transpose=True``), upper-triangular.

    Port of ``sparse_dot_tpu.gram_matrix`` (the reference's
    ``gram_matrix_mkl``, ``sparse_dot.py:155-242`` and
    ``_gram_matrix.py:252-335``), including: CSC requires ``cast=True``;
    complex inputs are rejected by default; a dense-input product leaves
    the strict lower triangle as out_scalar * out; the empty-input shape
    rule.  ``allow_complex=True`` (the JAX package's extension) computes
    the unconjugated AᵀA / AAᵀ of complex input.  Sparse output runs on
    K4 + K5 (or the structural densify route), dense output from sparse
    input on K6 (or the densify route), dense input on ``torch.matmul``.
    """
    _deprecated_debug(debug)
    torch_device()
    print_backend_debug()

    if policy.empty_output_check(matrix, matrix):
        debug_print(
            "Skipping multiplication because AT (dot) A must yield an "
            "empty matrix"
        )
        # Reference quirk preserved: the empty-path shape uses the
        # transposed selector (``_gram_matrix.py:269-274``).
        output_shape = (
            (matrix.shape[1], matrix.shape[1])
            if transpose
            else (matrix.shape[0], matrix.shape[0])
        )
        output_func = (
            _sps.csr_matrix if formats.issparse(matrix) else np.zeros
        )
        return output_func(output_shape, dtype=matrix.dtype)

    if np.iscomplexobj(matrix) and not allow_complex:
        raise ValueError("gram_matrix does not support complex datatypes")

    matrix = policy.type_check(matrix, cast=cast)

    is_sparse = formats.issparse(matrix)

    if is_sparse and not (formats.is_csr(matrix) or formats.is_csc(matrix)):
        raise ValueError(
            "gram_matrix requires sparse matrix to be CSR or CSC format"
        )
    if formats.is_csc(matrix) and not cast:
        raise ValueError(
            "gram_matrix cannot use a CSC matrix unless cast=True"
        )

    dbl, cplx = policy.precision_flags(matrix)
    out_dtype = np.dtype(policy.OUTPUT_DTYPES[(dbl, cplx)])

    if not is_sparse:
        layout_a, _ = policy.get_dense_layout(matrix)
        out_order = "C" if layout_a == policy.LAYOUT_C else "F"
        n = matrix.shape[0] if transpose else matrix.shape[1]
        out_validated = policy.out_matrix(
            (n, n), out_dtype, order=out_order, out_arr=out
        )
        with trace_phase("syrk_dense"):
            res = _ops.gram_dense_from_dense(
                matrix, out_dtype, aat=transpose,
                out=out, out_scalar=out_scalar,
            )
        if out is not None:
            out_validated[...] = res
            return out_validated
        return (
            np.asfortranarray(res) if out_order == "F"
            else np.ascontiguousarray(res)
        )

    A = formats.to_device(matrix)

    if dense:
        n = matrix.shape[0] if transpose else matrix.shape[1]
        out_validated = policy.out_matrix(
            (n, n), out_dtype, order="C", out_arr=out
        )
        # Reference emulation: syrkd produces a FULL matrix for the
        # ATA/out=None/real case and the wrapper zeroes the lower triangle
        # afterwards (``_gram_matrix.py:164-169``); with out provided the
        # full product is accumulated.
        full = not transpose and out is not None
        with trace_phase("syrkd"):
            res = _ops.gram_dense_from_sparse(
                A, out_dtype, aat=transpose,
                out=out, out_scalar=out_scalar,
                full=full,
            )
        if out is not None:
            out_validated[...] = res
            return out_validated
        return res

    if out is not None:
        raise ValueError(
            "out argument cannot be used with sparse (dot) sparse "
            "matrix multiplication"
        )

    with trace_phase("syrk_sparse"):
        data, indices, indptr = _ops.gram_sparse(A, out_dtype, aat=transpose)
    n = matrix.shape[0] if transpose else matrix.shape[1]
    return _sps.csr_matrix((data, indices, indptr), shape=(n, n))


def sparse_qr_solve(matrix_a, matrix_b, cast=False, debug=False):
    """Least-squares solve of AX = B for sparse A (CSR; CSC with
    ``cast=True``) and dense B.  See :mod:`sparse_dot_tpu_torch.solvers.qr`."""
    _deprecated_debug(debug)
    torch_device()
    print_backend_debug()
    return sparse_qr_solver(matrix_a, matrix_b, cast=cast)
