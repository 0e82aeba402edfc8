"""Sparse QR least-squares solver.

Port of ``sparse_dot_tpu/solvers/qr.py``: solve min ||AX - B|| for sparse
A (CSR; CSC with ``cast=True``) and dense B, float32/float64 only, with the
reference's guards and output dtypes.

Two routes, chosen by the densified size of A alone:

* up to ``_QR_DENSIFY_BUDGET`` bytes, A is densified on the device and
  solved by Householder QR (``torch.linalg.qr``, then
  ``torch.linalg.solve_triangular`` on R x = Qᵀ b): library calls where the
  JAX package used XLA's own ``jnp.linalg.qr``;
* beyond it, Jacobi-preconditioned CGLS on the device: op(A) on A's CSR,
  op(A)ᵀ on the container's transposed CSR, built once on the device, both
  on K3 (``ops/csr.csr_spmv``) for one right-hand side and on K2
  (``ops/csr.csr_spmm``) for several.  The Jacobi scaling is computed on
  the device from the same CSR arrays.  The loop's scalars stay on the
  device; its running flag is read every ``CHECK_EVERY`` steps.

A ``ShardedCSR`` A (``parallel``) takes the sharded route: one
distributed CGLS (``parallel.ops.sharded_cgls``) per column of B, with the
same guards and output dtypes.  The JAX package's TPU probe
``supports_f64_qr`` has no counterpart here.
"""

import numpy as np
import torch

from .. import formats
from ..ops.dense import ieee_matmul
from ..policy import (
    type_check,
    precision_flags,
    get_dense_layout,
    LAYOUT_C,
)
from .iterative import CHECK_EVERY, CsrOperator, _to_host

# Densified-A byte budget above which the solver switches from Householder
# QR to the CGLS loop.
_QR_DENSIFY_BUDGET = 2 << 30

# Diagnostics: CGLS iteration count of the most recent CGLS solve (None
# when the dense Householder route ran).
_last_cgls_iters = None


def _qr_lstsq(a, b):
    """Least squares of dense a (m >= n) by Householder QR."""
    if a.is_cuda:
        ieee_matmul()
    q, r = torch.linalg.qr(a, mode="reduced")
    return torch.linalg.solve_triangular(r, q.T @ b, upper=True)


def _cgls_loop(fwd, adj, b, k, maxiter, d, rtol=0.0, atol=0.0):
    """CGLS for min ||A X - B|| column by column, each column with its own
    step sizes, on the column-equilibrated system (A diag(d)) Y = B; returns
    (X = diag(d) Y, the residual B - A X, iterations) on the device.  With
    d_j = 1/||a_j|| the normal matrix has a unit diagonal, which bounds the
    iteration growth on ill-conditioned systems.  The loop runs while any
    column's squared gradient norm is above rtol^2 times its start and
    above atol^2; steps issued after that change nothing and do not
    count."""
    dcol = d[:, None]
    x = torch.zeros((k, b.shape[1]), dtype=b.dtype, device=b.device)
    r, s = b, dcol * adj(b)
    p, g = s, (s * s).sum(0)
    thresh = torch.clamp((rtol * rtol) * torch.clamp(g, min=1e-300),
                         min=atol * atol)
    it = torch.zeros((), dtype=torch.int64, device=b.device)
    for step in range(maxiter):
        running = (g > thresh).any()
        if step and step % CHECK_EVERY == 0 and not bool(running):
            break
        q = fwd(dcol * p)
        qq = (q * q).sum(0)
        alpha = torch.where(running & (qq > 0), g / qq, 0.0)
        x = torch.addcmul(x, alpha, p)
        r = torch.addcmul(r, alpha, q, value=-1.0)
        s = dcol * adj(r)
        g_new = (s * s).sum(0)
        beta = torch.where(g > 0, g_new / g, 0.0)
        p = torch.where(running, torch.addcmul(s, beta, p), p)
        g = torch.where(running, g_new, g)
        it += running
    return dcol * x, r, it


def _col_sumsq(indices, data, n):
    """The column sums of squares of A's CSR arrays, float64, on their
    device."""
    sq = torch.zeros(n, dtype=torch.float64, device=data.device)
    data = data.to(torch.float64)
    sq.index_add_(0, indices.long(), data * data)
    return sq


def _jacobi_colscale(sq):
    """d_j = 1/||a_j||_2 (1.0 for an empty column) from the column sums of
    squares ``sq``."""
    return torch.where(sq > 0, torch.rsqrt(sq), 1.0)


def _panel(op, k):
    """``op`` on (rows, k) panels: K3 on the one column when k == 1, K2
    otherwise."""
    if k == 1:
        return lambda v: op(v.reshape(-1)).unsqueeze(1)
    return op.mm


def _sparse_qr(matrix_a, matrix_b):
    global _last_cgls_iters
    A = formats.to_device(matrix_a)
    m, n = A.shape
    b = formats.dense_to_device(np.asarray(matrix_b))

    if m * n * np.dtype(A.dtype).itemsize > _QR_DENSIFY_BUDGET:
        fwd = CsrOperator(*A.csr_arrays())
        adj = CsrOperator(*A.csr_arrays(transpose=True))
        nrhs = b.shape[1]
        x, _, it = _cgls_loop(
            _panel(fwd, nrhs), _panel(adj, nrhs), b.to(torch.float64), n,
            10 * n + 1000, _jacobi_colscale(_col_sumsq(*fwd.arrays[1:], n)),
            rtol=1e-14,
        )
        host = _to_host(x, it)
        x = host[:-1].reshape(n, -1)
        _last_cgls_iters = int(host[-1])
    else:
        if m < n:
            # Householder QR solves R x = Q^T b with a square R: the JAX
            # package's triangular solve refuses a wide A the same way.
            raise ValueError(
                f"Householder QR needs m >= n: A has shape {(m, n)}; "
                "a wide A takes the CGLS route only past the densify budget"
            )
        x = _qr_lstsq(A.to_dense(), b).cpu().numpy()
        _last_cgls_iters = None

    layout_b, _ = get_dense_layout(matrix_b)
    if layout_b == LAYOUT_C:
        return np.ascontiguousarray(x)
    return np.asfortranarray(x)


def _sharded_qr(matrix_a, matrix_b):
    """The ``ShardedCSR`` route (``sparse_dot_tpu/solvers/qr.py:257-296``):
    a mesh is required, shapes must align and complex is rejected; one
    ``sharded_cgls`` per column of B; float64 out for float64 A, float32
    otherwise."""
    from ..parallel.ops import sharded_cgls

    if matrix_a.mesh is None:
        raise ValueError(
            "Sharded QR solve requires the ShardedCSR to carry a "
            "mesh (shard_csr_rows(..., mesh=...))"
        )
    if matrix_a.shape[0] != np.asarray(matrix_b).shape[0]:
        raise ValueError(
            f"Bad matrix shapes for AX=B solver: "
            f"A {matrix_a.shape} & B {np.asarray(matrix_b).shape}"
        )
    if np.dtype(matrix_a.dtype).kind == "c":
        raise ValueError(
            "Complex datatypes are not supported by the QR solver"
        )
    out_dt = (np.float64 if np.dtype(matrix_a.dtype) == np.float64
              else np.float32)
    b_np = np.asarray(matrix_b, dtype=np.float64)
    cols = [b_np] if b_np.ndim == 1 else list(b_np.T)
    xs = [sharded_cgls(matrix_a.mesh, matrix_a, col, axis=matrix_a.axis)[0]
          for col in cols]
    x = xs[0] if b_np.ndim == 1 else np.stack(xs, axis=1)
    return x.astype(out_dt, copy=False)


def sparse_qr_solver(matrix_a, matrix_b, cast=False):
    """Solve AX = B in the least-squares sense, with the reference's guards
    (``_sparse_qr_solver.py:110-163``): CSC requires cast=True, only
    CSR/CSC sparse is accepted, shapes must align, complex is rejected.
    A ``ShardedCSR`` A runs the distributed CGLS (``_sharded_qr``)."""
    from ..parallel.ops import ShardedCSR

    if isinstance(matrix_a, ShardedCSR):
        return _sharded_qr(matrix_a, matrix_b)
    if formats.is_csc(matrix_a) and not cast:
        raise ValueError(
            "sparse_qr_solver only accepts CSR matrices if cast=False"
        )
    if not (formats.is_csc(matrix_a) or formats.is_csr(matrix_a)):
        raise ValueError(
            "sparse_qr_solver requires matrix A to be CSR or CSC sparse "
            "matrix"
        )
    if matrix_a.shape[0] != matrix_b.shape[0]:
        raise ValueError(
            f"Bad matrix shapes for AX=B solver: "
            f"A {matrix_a.shape} & B {matrix_b.shape}"
        )

    matrix_a, matrix_b = type_check(
        matrix_a, matrix_b, cast=cast, allow_complex=False
    )

    dbl, _ = precision_flags(matrix_a)

    b_2d = matrix_b if matrix_b.ndim == 2 else matrix_b.reshape(-1, 1)
    x = _sparse_qr(matrix_a, b_2d)
    x = x.astype(np.float64 if dbl else np.float32, copy=False)
    return x if matrix_b.ndim == 2 else x.ravel()
