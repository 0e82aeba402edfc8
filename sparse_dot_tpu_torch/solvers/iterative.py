"""Iterative sparse solvers (CG, multi-RHS CG, FGMRES) as device loops.

Port of ``sparse_dot_tpu/solvers/iterative.py``, with its protocol: the
solver classes are context managers and iterators (one step per
``__next__``) with ``solve()``, ``set_sparse_matrix_descr`` (the
symmetric descriptor included), ``update_tmp`` and the ``ipar``/``dpar``
blocks; ``cg``, ``cg_mrhs`` and ``fgmres`` return ``(x, code)``.

Each solver builds one operator, the CSR of op(A) on ``config.device``
with float64 values (``CsrOperator``), and caches it: single right-hand
sides run their matvecs on K3 (``ops/csr.csr_spmv``), ``cg_mrhs`` its
products on K2 (``ops/csr.csr_spmm``), and ``b - A x`` uses the kernels'
alpha/beta epilogue.  The JAX package's COO and binned-ELL loop forms and
its hi|lo range gate are TPU workarounds with no counterpart.

Host syncs: a step's scalars (alpha, beta, the squared residual, the done
flag) stay on the device.  The fused loops read their done flag once every
``CHECK_EVERY`` steps; a step issued after convergence is frozen on the
device (alpha = 0, the count does not advance), so the iterate and the
count equal the stepwise loop's.  FGMRES reads its (restart + 1) x restart
Hessenberg matrix once per cycle and runs the Givens rotations and the
back-substitution on the host: one sync per cycle of ``restart`` matvecs.
"""

import math
import warnings

import numpy as np
import scipy.sparse as _sps
import torch

from .. import formats
from ..interface import (
    sparse_handle_t,
    SPARSE_MATRIX_TYPE_GENERAL,
    SPARSE_MATRIX_TYPE_SYMMETRIC,
    SPARSE_FILL_MODE_FULL,
    SPARSE_DIAG_NON_UNIT,
)
from ..ops import csr
from ..ops.dense import ieee_matmul

DEFAULT_ATOL = 0.0
DEFAULT_RTOL = 1e-6
DEFAULT_MAX_ITER = 1000

# Steps between two reads of a fused loop's done flag.
CHECK_EVERY = 16


class ConvergenceWarning(UserWarning):
    pass


class CsrOperator:
    """An operator as CSR arrays on the device, float64 values:
    ``op(v)`` runs K3, ``op.mm(V)`` K2, and ``op.residual(b, x)`` is
    ``b - op(x)`` in the kernel's epilogue (alpha = -1, beta = 1).  Each
    kernel's row plan (``formats.csr_plan``) is built on its first use and
    kept for the solve."""

    def __init__(self, indptr, indices, data):
        self.arrays = (indptr, indices, data.to(torch.float64))
        self._plans = {}

    def plan(self, spmv):
        if spmv not in self._plans:
            self._plans[spmv] = formats.csr_plan(
                self.arrays[0], self.arrays[1].numel(), spmv)
        return self._plans[spmv]

    def __call__(self, v):
        return csr.csr_spmv(*self.arrays, v, plan=self.plan(True))

    def mm(self, v):
        return csr.csr_spmm(*self.arrays, v, plan=self.plan(False))

    def residual(self, b, x):
        if x.dim() == 1:
            return csr.csr_spmv(*self.arrays, x, -1.0, 1.0, b,
                                plan=self.plan(True))
        return csr.csr_spmm(*self.arrays, x, -1.0, 1.0, b,
                            plan=self.plan(False))


def container_operator(A, n, symmetric=False):
    """The (n, n) ``CsrOperator`` of container A (at most n rows and
    columns).  ``symmetric`` builds S = T + Tᵀ - diag(T) of the stored
    triangle T once, as T plus its mirror with the diagonal zeroed, sorted
    into CSR (``formats.coo_to_sorted_csr``)."""
    indptr, indices, data = A.csr_arrays()
    m = indptr.numel() - 1
    if symmetric:
        rows = formats.expand_indptr(indptr, indices.numel())
        mirror = torch.where(rows == indices, 0.0, data)
        indptr, indices, data = formats.coo_to_sorted_csr(
            torch.cat([rows, indices]), torch.cat([indices, rows]),
            torch.cat([data, mirror]), (n, n))
    elif m < n:
        indptr = torch.cat([indptr, indptr[-1:].expand(n - m)])
    return CsrOperator(indptr, indices, data)


def _device(arr):
    return formats.dense_to_device(np.asarray(arr, dtype=np.float64))


def _upload(arr, device):
    """Small host array -> device without waiting for the device."""
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _to_host(*tensors):
    """Device tensors -> one float64 host vector, read in one copy."""
    flat = [t.reshape(-1).to(torch.float64) for t in tensors]
    return torch.cat(flat).cpu().numpy()


def _as_container(A):
    if isinstance(A, sparse_handle_t):
        return formats.to_device(A._live())
    if formats.is_device_sparse(A):
        return formats.to_device(A)
    if _sps.issparse(A) and A.format == "csr":
        return formats.CSR.from_scipy(A)
    return None


# ---------------------------------------------------------------------------
# CG
# ---------------------------------------------------------------------------


def _cg_step(op, x, r, p, rs, active=None):
    """One CG step; returns (x, r, p, rs_new).  With ``active`` (a bool
    tensor) False, x and r stay as they are."""
    sp = op(p)
    denom = torch.dot(p, sp)
    ok = denom != 0 if active is None else active & (denom != 0)
    alpha = torch.where(ok, rs / denom, 0.0)
    x = torch.addcmul(x, alpha, p)
    r = torch.addcmul(r, alpha, sp, value=-1.0)
    rs_new = torch.dot(r, r)
    beta = torch.where(rs != 0, rs_new / rs, 0.0)
    return x, r, torch.addcmul(r, beta, p), rs_new


def _cg_loop(op, b, x0, threshold, maxiter, at_least_one=True):
    """CG from x0 until sqrt(rs) <= threshold or ``maxiter`` steps, at
    least one step unless ``at_least_one`` is False (then a start that is
    already converged takes none): (x, rs, it) on the device.  The done
    flag is read every ``CHECK_EVERY`` steps."""
    r = op.residual(b, x0)
    x, p, rs = x0, r, torch.dot(r, r)
    done = (torch.zeros((), dtype=torch.bool, device=b.device)
            if at_least_one else torch.sqrt(rs) <= threshold)
    it = torch.zeros((), dtype=torch.int64, device=b.device)
    for step in range(maxiter):
        if step and step % CHECK_EVERY == 0 and bool(done):
            break
        active = ~done
        x, r, p, rs = _cg_step(op, x, r, p, rs, active)
        it += active
        done |= torch.sqrt(rs) <= threshold
    return x, rs, it


def _cg_mrhs_loop(op, B, X0, thresholds, maxiter):
    """Multi-RHS CG on one K2 product per step: every column advances with
    its own scalars, and a converged column is frozen (no step, search
    direction kept), so each column's iterates are its single-RHS solve's.
    Returns (X, final squared residual norms) on the device."""
    R = op.residual(B, X0)
    X, P, rs = X0, R, (R * R).sum(0)
    thr2 = thresholds * thresholds
    for step in range(maxiter):
        active = rs > thr2
        if step and step % CHECK_EVERY == 0 and not bool(active.any()):
            break
        SP = op.mm(P)
        denom = (P * SP).sum(0)
        alpha = torch.where(active & (denom != 0), rs / denom, 0.0)
        X = torch.addcmul(X, alpha, P)
        R = torch.addcmul(R, alpha, SP, value=-1.0)
        rs_new = (R * R).sum(0)
        beta = torch.where(active & (rs != 0), rs_new / rs, 0.0)
        P = torch.where(active, torch.addcmul(R, beta, P), P)
        rs = torch.where(active, rs_new, rs)
    return X, rs


# ---------------------------------------------------------------------------
# FGMRES
# ---------------------------------------------------------------------------


def _givens_solve(H, beta, threshold, restart):
    """Host half of an FGMRES cycle: rotate the Hessenberg columns ``H``
    ((restart + 1) x restart) by Givens rotations, track |g[j + 1]|, and
    back-substitute on the leading ju x ju triangle, where ju is the first
    step whose rotated residual clears ``threshold`` (``restart`` if none,
    0 if ``beta`` already does).  Returns (y, resid, ju)."""
    R = np.zeros((restart + 1, restart))
    cs, sn = [0.0] * restart, [0.0] * restart
    g = [0.0] * (restart + 1)
    g[0] = beta
    ju = 0 if beta <= threshold else restart
    for j in range(restart):
        hc = [float(v) for v in H[:, j]]
        for i in range(j):
            hi = cs[i] * hc[i] + sn[i] * hc[i + 1]
            hc[i + 1] = -sn[i] * hc[i] + cs[i] * hc[i + 1]
            hc[i] = hi
        denom = math.sqrt(hc[j] * hc[j] + hc[j + 1] * hc[j + 1])
        c = 1.0 if denom == 0 else hc[j] / denom
        s = 0.0 if denom == 0 else hc[j + 1] / denom
        cs[j], sn[j] = c, s
        hc[j] = c * hc[j] + s * hc[j + 1]
        hc[j + 1] = 0.0
        g[j], g[j + 1] = c * g[j], -s * g[j]
        R[:, j] = hc
        if abs(g[j + 1]) <= threshold and ju == restart:
            ju = j + 1
    y = np.zeros(restart)
    for i in reversed(range(ju)):
        den = R[i, i] if R[i, i] != 0 else 1.0
        y[i] = (g[i] - R[i, :restart] @ y) / den
    resid = beta if ju == 0 else abs(g[min(ju, restart)])
    return y, resid, ju


def _fgmres_cycle(op, b, x, threshold, restart):
    """One restarted-FGMRES cycle: ``restart`` Arnoldi steps on the device
    (K3 matvec, CGS2 orthogonalization against the basis so far), one read
    of beta and the Hessenberg matrix, the rotations and back-substitution
    on the host (``_givens_solve``), and x + V y on the device.  Every
    step runs even after the residual clears the threshold; columns past
    ju get y = 0.  Returns (x_new, resid, ju): ju is the number of Arnoldi
    steps the convergence test needed, the honest inner count."""
    if x.is_cuda:
        ieee_matmul()
    r = op.residual(b, x)
    beta = torch.linalg.vector_norm(r)
    V = torch.zeros((restart + 1, x.numel()), dtype=x.dtype, device=x.device)
    V[0] = r / torch.where(beta == 0, 1.0, beta)
    H = torch.zeros((restart + 1, restart), dtype=x.dtype, device=x.device)
    for j in range(restart):
        w = op(V[j])
        basis = V[: j + 1]
        h1 = torch.mv(basis, w)
        w = w - torch.mv(basis.T, h1)
        h2 = torch.mv(basis, w)
        w = w - torch.mv(basis.T, h2)
        hj1 = torch.linalg.vector_norm(w)
        H[: j + 1, j] = h1 + h2
        H[j + 1, j] = hj1
        V[j + 1] = w / torch.where(hj1 == 0, 1.0, hj1)
    host = _to_host(beta, H)
    y, resid, ju = _givens_solve(host[1:].reshape(restart + 1, restart),
                                 float(host[0]), threshold, restart)
    x_new = torch.addmv(x, V[:restart].T, _upload(y, x.device))
    return x_new, resid, ju


def _fgmres_loop(op, b, x0, threshold, maxiter, restart):
    """Restarted FGMRES from x0 until the residual clears ``threshold`` or
    ``maxiter`` cycles: (x, resid, cycles, inner_total)."""
    resid = float(torch.linalg.vector_norm(op.residual(b, x0)))
    x, cycles, inner = x0, 0, 0
    while resid > threshold and cycles < maxiter:
        x, resid, ju = _fgmres_cycle(op, b, x, threshold, restart)
        cycles += 1
        inner += ju
    return x, resid, cycles, inner


# ---------------------------------------------------------------------------
# Solver classes
# ---------------------------------------------------------------------------


class IterativeSparseSolver:
    """Base solver: operator construction, protocol plumbing.

    Subclasses implement ``solve_iteration`` (one step, True when
    converged) and may override ``solve`` with a fused device loop.
    """

    solver_name = "iterative"

    def __init__(self, A, b, x=None, ipar=None, dpar=None, tmp=None,
                 max_iter=DEFAULT_MAX_ITER, a_tol=DEFAULT_ATOL,
                 r_tol=DEFAULT_RTOL, verbose=False, n=None):

        self.current_iter, self.max_iter = 0, max_iter
        self.a_tol = DEFAULT_ATOL if a_tol is None else a_tol
        self.r_tol = DEFAULT_RTOL if r_tol is None else r_tol
        self.verbose = verbose
        self.final_code = None

        is_handle = isinstance(A, sparse_handle_t) or (
            formats.is_device_sparse(A)
        )
        if is_handle and n is None:
            raise ValueError(
                "If A is a sparse handle, n must be passed as well"
            )

        container = _as_container(A)
        if container is None:
            raise ValueError(
                "Matrix A must be a double-precision scipy CSR matrix "
                "or a sparse handle"
            )
        if not is_handle:
            if np.dtype(container.dtype) != np.dtype(np.float64):
                raise ValueError(
                    "Matrix A must be a double-precision scipy CSR matrix "
                    "or a sparse handle"
                )
            if n is not None and A.shape[1] != n:
                raise ValueError(
                    f"n = {n} does not align with matrix A ({A.shape})"
                )
            if n is None:
                n = A.shape[1]
        if max(container.shape) > n:
            # The operator is (n, n): an index past n would read past x.
            raise ValueError(
                f"n = {n} does not align with matrix A ({container.shape})"
            )

        self.A = container
        self.n = int(n)

        # RHS: flatten; tolerate a short RHS by zero-padding to n (the
        # reference's RCI reads n entries regardless).
        b = np.asarray(b, dtype=np.float64).ravel()
        if b.shape[0] < self.n:
            b = np.concatenate([b, np.zeros(self.n - b.shape[0])])
        self.b = b

        if x is None:
            self.x = np.zeros(self.n, dtype=np.float64)
        else:
            self.x = np.asarray(x, dtype=np.float64).flatten()
            if self.x.shape[0] != self.n:
                raise ValueError(
                    f"x ({self.x.shape}) does not align with n = {self.n}"
                )

        # Parameter blocks kept for protocol parity with the RCI API.
        self.ipar = np.zeros(128, dtype=np.int64) if ipar is None else ipar
        self.dpar = np.zeros(128, dtype=np.float64) if dpar is None else dpar
        self.tmp = tmp

        self.set_sparse_matrix_descr()
        self.set_initial_parameters()

    # -- descriptor / operator ---------------------------------------------

    def set_sparse_matrix_descr(self,
                                matrix_type=SPARSE_MATRIX_TYPE_GENERAL,
                                fill_mode=SPARSE_FILL_MODE_FULL,
                                diag=SPARSE_DIAG_NON_UNIT):
        self.matrix_A_descr = (matrix_type, fill_mode, diag)
        self._op_cache = None

    def set_initial_parameters(self):
        self.ipar[4] = self.max_iter
        self.dpar[0] = self.r_tol
        self.dpar[1] = self.a_tol

    def _operator(self):
        """The cached ``CsrOperator`` of the stored matrix under the
        descriptor (symmetric: the stored triangle symmetrized)."""
        if self._op_cache is None:
            self._op_cache = container_operator(
                self.A, self.n,
                symmetric=self.matrix_A_descr[0]
                == SPARSE_MATRIX_TYPE_SYMMETRIC,
            )
        return self._op_cache

    def update_tmp(self):
        """Protocol-parity hook: the RCI matvec ``tmp[1] = A @ tmp[0]``
        (the reference updates the flat work buffer, not ``x``), with the
        work block allocated lazily."""
        if self.tmp is None:
            self.tmp = np.zeros((4, self.n), dtype=np.float64)
        self.tmp[1] = self._operator()(_device(self.tmp[0])).cpu().numpy()
        return self.tmp[1]

    # -- convergence --------------------------------------------------------

    def _threshold(self):
        b_norm = float(np.linalg.norm(self.b))
        return max(self.r_tol * b_norm, self.a_tol, 0.0)

    def _threshold_value(self):
        thr = self._threshold()
        return 1e-12 if thr == 0.0 else thr

    def _converged(self, r_norm):
        return r_norm <= self._threshold_value()

    def _finish(self, converged):
        """Set final_code from a fused solve's outcome, warning when it did
        not converge."""
        if converged:
            self.final_code = 0
        else:
            warnings.warn(
                f"{self.solver_name} did not converge within "
                f"{self.max_iter} iterations",
                ConvergenceWarning,
            )
            self.final_code = -1
        return self.x

    def _trivial(self):
        """A zero RHS: the least-squares solution is x = 0."""
        self.x = np.zeros(self.n, dtype=np.float64)
        self.final_code = 0
        return self.x

    # -- context manager / iterator ----------------------------------------

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.A = None
        self._op_cache = None
        return False

    def __iter__(self):
        return self

    def __next__(self):
        if self.current_iter >= self.max_iter:
            raise StopIteration
        converged = self.solve_iteration()
        self.current_iter += 1
        if converged:
            self.final_code = 0
            raise StopIteration
        return 1

    def solve_iteration(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def solve(self):
        if np.linalg.norm(self.b) == 0.0:
            return self._trivial()

        for _ in self:
            pass

        if self.final_code != 0:
            warnings.warn(
                f"{self.solver_name} did not converge within "
                f"{self.max_iter} iterations",
                ConvergenceWarning,
            )
            self.final_code = -1 if self.final_code is None else (
                self.final_code
            )
        return self.x


class CGIterativeSparseSolver(IterativeSparseSolver):
    """Conjugate gradient.  One CG step per ``__next__`` (device math, host
    loop control); ``solve()`` runs the fused device loop with the same
    steps, so iterates and iteration counts agree."""

    solver_name = "cg"

    def _ensure_state(self):
        if getattr(self, "_r", None) is None:
            r = self._operator().residual(_device(self.b), _device(self.x))
            self._r = r
            self._p = r
            self._rs = torch.dot(r, r)

    def solve_iteration(self):
        self._ensure_state()
        x, self._r, self._p, self._rs = _cg_step(
            self._operator(), _device(self.x), self._r, self._p, self._rs)
        self.x = x.cpu().numpy()
        return self._converged(float(torch.sqrt(self._rs)))

    def solve(self):
        """Full solve as one device loop that reads the host once every
        ``CHECK_EVERY`` steps; the stepwise protocol (``__next__``) gives
        the same iterates and count."""
        if np.linalg.norm(self.b) == 0.0:
            return self._trivial()
        thr = self._threshold_value()
        x, rs, it = _cg_loop(self._operator(), _device(self.b),
                             _device(self.x), thr, self.max_iter)
        host = _to_host(x, rs, it)
        self.x = host[: self.n]
        self.current_iter = int(host[-1])
        return self._finish(math.sqrt(host[-2]) <= thr)


class FGMRESIterativeSparseSolver(IterativeSparseSolver):
    """Flexible GMRES by restarted Arnoldi cycles (``_fgmres_cycle``).  Each
    ``__next__`` runs one cycle; ``solve()`` runs the cycles in one loop.
    Both run the same cycle, so iterates and counts agree.

    ``current_iter`` counts restart cycles; ``total_inner_iterations``
    counts the Arnoldi steps (matvecs) the convergence test needed, the
    reference RCI's ipar iteration counter analog.
    """

    solver_name = "fgmres"
    restart = 20
    total_inner_iterations = 0

    def solve_iteration(self):
        x, resid, ju = _fgmres_cycle(
            self._operator(), _device(self.b), _device(self.x),
            self._threshold_value(), min(self.restart, self.n))
        self.x = x.cpu().numpy()
        self.total_inner_iterations += ju
        return resid <= self._threshold_value()

    def solve(self):
        """Full solve: one host read per cycle, counts read back with the
        result."""
        if np.linalg.norm(self.b) == 0.0:
            return self._trivial()
        thr = self._threshold_value()
        x, resid, cycles, inner = _fgmres_loop(
            self._operator(), _device(self.b), _device(self.x), thr,
            self.max_iter, min(self.restart, self.n))
        self.x = x.cpu().numpy()
        self.current_iter = cycles
        self.total_inner_iterations = inner
        return self._finish(resid <= thr)


# ---------------------------------------------------------------------------
# Convenience wrappers
# ---------------------------------------------------------------------------


def _wrapper_guards(M, callback, callback_type=None):
    if M is not None:
        raise NotImplementedError("Preconditioner M not supported")
    if callback is not None or callback_type is not None:
        raise NotImplementedError("callback is not supported")


def cg(A, b, x0=None, tol=1e-05, maxiter=DEFAULT_MAX_ITER, M=None,
       callback=None, atol=None):
    """Conjugate-gradient convenience wrapper -> (x, code); mirrors the
    reference ``cg``."""
    _wrapper_guards(M, callback)

    with CGIterativeSparseSolver(
        A, b, x=x0, verbose=False, max_iter=maxiter, a_tol=atol, r_tol=tol
    ) as solver:
        return solver.solve(), solver.final_code


def cg_mrhs(A, B, X0=None, tol=1e-05, maxiter=DEFAULT_MAX_ITER, M=None,
            callback=None, atol=None):
    """Multi-RHS conjugate gradient: solve ``A X = B`` for B ``(n, k)``.

    The working analog of MKL's ``dcgmrhs`` RCI family.  All k columns
    advance together on one K2 product per step, each with its own
    threshold ``max(tol * ||b_col||, atol)``, until every column has
    converged.  Returns ``(X (n, k), codes (k,))`` with code 0 =
    converged, -1 = hit ``maxiter``.
    """
    _wrapper_guards(M, callback)
    Ac = _as_container(A)
    if Ac is None:
        raise ValueError(
            "cg_mrhs requires a scipy CSR matrix, a device container, "
            f"or a sparse handle; got {type(A)}"
        )
    if np.dtype(Ac.dtype) != np.dtype(np.float64):
        raise ValueError(
            "Matrix A must be a double-precision scipy CSR matrix "
            "or a sparse handle"
        )
    n = Ac.shape[0]
    if Ac.shape[1] != n:
        raise ValueError(f"cg_mrhs requires a square A; got {Ac.shape}")
    B_np = np.asarray(B, dtype=np.float64)
    if B_np.ndim != 2 or B_np.shape[0] != n:
        raise ValueError(
            f"B must be a dense (n, k) array with n == {n}; got shape "
            f"{B_np.shape}"
        )
    k = B_np.shape[1]
    if X0 is None:
        X0_np = np.zeros((n, k), dtype=np.float64)
    else:
        X0_np = np.asarray(X0, dtype=np.float64)
        if X0_np.shape != (n, k):
            raise ValueError(f"X0 must have shape {(n, k)}")

    a_tol = DEFAULT_ATOL if atol is None else atol
    thresholds = np.maximum(
        tol * np.linalg.norm(B_np, axis=0), max(a_tol, 0.0)
    )
    thresholds = np.where(thresholds == 0.0, 1e-12, thresholds)

    X, rs = _cg_mrhs_loop(container_operator(Ac, n), _device(B_np),
                          _device(X0_np), _device(thresholds), maxiter)
    host = _to_host(X, rs)
    X_np = host[: n * k].reshape(n, k)
    res = np.sqrt(host[n * k:])
    codes = np.where(res <= thresholds, 0, -1).astype(np.int32)
    if (codes != 0).any():
        warnings.warn(
            f"cg did not converge within {maxiter} iterations for "
            f"{int((codes != 0).sum())} of {k} right-hand sides",
            ConvergenceWarning,
        )
    return X_np, codes


def fgmres(A, b, x0=None, tol=1e-05, restart=None, maxiter=DEFAULT_MAX_ITER,
           M=None, callback=None, atol=None, callback_type=None):
    """FGMRES convenience wrapper -> (x, code); mirrors the reference
    ``fgmres``."""
    _wrapper_guards(M, callback, callback_type)

    with FGMRESIterativeSparseSolver(
        A, b, x=x0, max_iter=maxiter, a_tol=atol, r_tol=tol
    ) as solver:
        if restart is not None:
            solver.restart = restart
        return solver.solve(), solver.final_code
