"""PARDISO-compatible direct solver interface.

Port of ``sparse_dot_tpu/solvers/pardiso.py``: the classic 64-slot
``pt``/``iparm`` state machine of the reference
(``sparse_dot_mkl/solvers/_pardiso.py``).  ``pardisoinit`` fills the flag
block; ``pardiso`` runs phases (11 analysis, 22 numeric factorization, 33
solve, 13 all, negative to release), with ``pt`` the opaque handle of the
stored factor.

The factor is a dense LU on ``config.device`` (``torch.linalg.lu_factor_ex``
and ``lu_solve``, library calls standing where the JAX package used XLA's
LU), in A's own precision: float64 and complex LU are native on the card,
so the JAX package's mixed f32 LU with f64 refinement and its real 2n x 2n
embedding of complex systems have no counterpart, and ``iparm[6]`` reports
0 refinement steps.  Past ``config.pardiso_dense_budget_bytes``
(n * n * 12 bytes, the JAX package's test) the solve runs matrix-free on
the iterative solvers' loops: CG for the SPD mtype 2, FGMRES otherwise,
real mtypes only.

Phase semantics asserted by the reference tests: phase 11 leaves X zero
but sets ``pt``; 13 solves; 33 re-solves from the stored factor without
reading A; ``perm`` is returned untouched (zeros) unless supplied.
"""

import itertools
import warnings

import numpy as np
import scipy.sparse as _sps
import torch

from .. import formats
from ..backend import torch_device
from ..config import config
from .iterative import _cg_loop, _fgmres_loop, CsrOperator

PARDISO_ERRORS = {
    0: None,
    -1: "input inconsistent",
    -2: "not enough memory",
    -3: "reordering problem",
    -4: "Zero pivot, numerical factorization or iterative refinement "
        "problem",
    -5: "unclassified (internal) error",
    -6: "reordering failed (matrix types 11 and 13 only)",
    -7: "diagonal matrix is singular",
    -8: "32-bit integer overflow problem",
    -9: "not enough memory for OOC",
    -10: "error opening OOC files",
    -11: "read/write error with OOC files",
    -12: "pardiso_64 called from 32-bit library",
    -13: "interrupted by the (user-defined) progress function",
    -15: "internal error",
}

_REAL_MTYPES = (1, 2, -2, 11)
_COMPLEX_MTYPES = (3, 4, -4, 6, 13)

# iparm slots honored or deliberately accepted.  Honored: iparm[7] (max
# refinement steps; none are needed, iparm[6] reports 0), iparm[11]
# (transpose / conjugate-transpose solve), iparm[17]/iparm[18] (<0 on entry
# requests the factor-nnz / MFLOP reports), iparm[27] (single precision:
# a float32 A factors in float32), iparm[34] (zero-based indexing, the
# only value scipy CSR can carry).  Accepted without effect (they select
# behaviors of MKL's sparse elimination that a dense LU or Krylov backing
# has no analog of): iparm[0], [1], [9], [10], [12].  Any other nonzero
# slot warns.
_IPARM_ACCEPTED = frozenset({0, 1, 6, 7, 9, 10, 11, 12, 17, 18, 27,
                             34})


def _check_iparm(iparm, quiet):
    """Warn on nonzero iparm slots outside the honored/accepted set."""
    if iparm is None:
        return
    ip = np.asarray(iparm)
    unsupported = [
        int(i) for i in np.nonzero(ip)[0] if int(i) not in _IPARM_ACCEPTED
    ]
    if unsupported and not quiet:
        warnings.warn(
            f"iparm slots {unsupported} are nonzero but not honored by "
            "sparse_dot_tpu_torch's pardiso (dense-LU / Krylov backing); "
            "results may differ from MKL for those options",
            RuntimeWarning,
        )
    if ip.shape[0] > 34 and int(ip[34]) == 0 and not quiet:
        warnings.warn(
            "iparm[34] == 0 selects one-based (Fortran) indexing, which "
            "scipy CSR inputs cannot carry; indices are interpreted as "
            "zero-based (set iparm[34] = 1, as pardisoinit does)",
            RuntimeWarning,
        )


# Factorization store: pt[0] holds a key into this registry (the opaque
# "pointer" role pt plays in MKL).
_factor_store = {}
_next_key = itertools.count(1)


def _needs_iterative(n):
    """True when a dense LU of n x n would pass the budget (n * n * 12
    bytes, the JAX package's test) and the solve must go matrix-free."""
    return n * n * 12 > int(config.pardiso_dense_budget_bytes)


def pardisoinit(mtype, iparm=None, single_precision=False):
    """Initialize ``pt`` and ``iparm`` blocks for the given matrix type;
    mirrors the reference ``pardisoinit``."""
    if mtype not in _REAL_MTYPES + _COMPLEX_MTYPES:
        raise ValueError(f"mtype {mtype} is not a valid PARDISO mtype")

    pt = np.zeros(64, dtype=np.int64)

    if iparm is None:
        iparm = np.zeros(64, dtype=np.int32)
        iparm[0] = 1    # user-supplied iparm values
        iparm[1] = 2    # fill-reducing ordering (nested dissection analog)
        iparm[9] = 13   # pivot perturbation 1e-13
        iparm[10] = 1   # scaling
        iparm[12] = 1   # matching
        iparm[17] = -1  # report nnz in factors
        iparm[18] = -1  # report factorization flops
        iparm[34] = 1   # zero-based indexing

    if single_precision:
        iparm[27] = 1

    return pt, iparm


def _report(iparm, nnz, mflop):
    """Fill the iparm[17]/[18] reports that were requested (< 0)."""
    if iparm is None:
        return
    i32max = np.iinfo(np.int32).max
    if len(iparm) > 17 and int(iparm[17]) < 0:
        iparm[17] = min(nnz, i32max)
    if len(iparm) > 18 and int(iparm[18]) < 0:
        iparm[18] = min(mflop, i32max)


def _expand_triangle(A, mtype):
    """Symmetric / Hermitian mtypes: MKL reads only the upper triangle and
    expands it to the full operator (a full symmetric matrix reconstructs
    identically)."""
    A_s = A.to_scipy().tocsr() if formats.is_device_sparse(A) else A
    U = _sps.triu(A_s, format="csr")
    strict = _sps.triu(A_s, k=1, format="csr")
    if mtype in (4, -4):  # Hermitian: conjugate the mirror
        return (U + strict.conj().T).tocsr()
    return (U + strict.T).tocsr()


def _krylov_solve(state, B, tmode):
    """Matrix-free solve of each column of B on the stored container: CG
    (mtype 2) or FGMRES, on K3 over op(A)'s CSR.  Returns X, or None when a
    column does not converge."""
    container = state["container"]
    op = CsrOperator(*container.csr_arrays(transpose=tmode in (1, 2)))
    b_np = np.asarray(B, dtype=np.float64)
    b_2d = b_np.reshape(-1, 1) if b_np.ndim == 1 else b_np
    xs = []
    for j in range(b_2d.shape[1]):
        b_col = formats.dense_to_device(np.ascontiguousarray(b_2d[:, j]))
        thr = 1e-10 * max(float(np.linalg.norm(b_2d[:, j])), 1e-300)
        x0 = torch.zeros_like(b_col)
        if state["mtype_sym"]:
            x, rs, _ = _cg_loop(op, b_col, x0, thr, 5000)
            resid = float(torch.sqrt(rs))
        else:
            x, resid, _, _ = _fgmres_loop(op, b_col, x0, thr, 200, 40)
        if not np.isfinite(resid) or resid > thr * 1e3:
            return None
        xs.append(x.cpu().numpy())
    return np.stack(xs, axis=1).reshape(b_np.shape)


def _lu_solve(state, B, tmode):
    """Solve op(A) X = B on the stored LU.  iparm[11] codes: 1 = conjugate
    transpose, 2 = transpose; ``lu_solve`` offers only the adjoint, so a
    complex factor solves Aᵀx = b as Aᴴ conj(x) = conj(b)."""
    lu, piv = state["lu"]

    def solve(b, adjoint):
        b = formats.dense_to_device(np.ascontiguousarray(b))
        return torch.linalg.lu_solve(lu, piv, b, adjoint=adjoint).cpu(
        ).numpy()

    b_np = np.asarray(B)
    b_2d = b_np.reshape(-1, 1) if b_np.ndim == 1 else b_np
    target = formats._NUMPY_DTYPES[lu.dtype]
    if lu.is_complex():
        b_c = b_2d.astype(target)
        if tmode == 2:
            x = solve(b_c.conj(), True).conj()
        else:
            x = solve(b_c, tmode == 1)
    elif np.iscomplexobj(b_np):
        # Real factor, complex B: solve the parts separately (the transpose
        # and the conjugate transpose coincide on a real operator).
        x = (solve(b_2d.real.astype(target), tmode in (1, 2))
             + 1j * solve(b_2d.imag.astype(target), tmode in (1, 2)))
    else:
        x = solve(b_2d.astype(target), tmode in (1, 2))
    x = x.reshape(b_np.shape)
    if np.iscomplexobj(x) and not np.iscomplexobj(b_np):
        # X carries B's dtype (the caller's buffer): a complex solution
        # over a real-dtyped B cannot be represented, so warn instead of
        # discarding it silently.
        scale = max(float(np.abs(x).max()), 1e-300)
        if float(np.abs(x.imag).max()) > 1e-9 * scale:
            warnings.warn(
                "sparse_dot_tpu_torch pardiso: complex-factor solve "
                "with a real-dtyped B produced a solution with a "
                "nonzero imaginary part, which B's dtype cannot "
                "represent; pass a complex B to receive it",
                RuntimeWarning,
            )
        x = np.ascontiguousarray(x.real)
    return x


def pardiso(A, B, pt, mtype, iparm, phase=13, maxfct=1, mnum=1, perm=None,
            msglvl=0, X=None, quiet=False):
    """Direct solve AX = B through the PARDISO phase protocol.

    Returns (X, pt, perm, error); mirrors the reference signature and
    phase behavior.
    """
    if not formats.is_csr(A):
        raise ValueError(f"A must be a CSR matrix; {type(A)} passed")
    if _sps.issparse(B):
        raise ValueError(f"B must be a dense array; {type(B)} passed")
    if A.shape[0] != B.shape[0]:
        raise ValueError(
            f"Bad matrix shapes for AX=B solver: A {A.shape} & B {B.shape}"
        )
    n = A.shape[0]
    if A.shape[1] != n:
        raise ValueError(
            f"PARDISO requires a square matrix; A is {A.shape}"
        )

    if B.ndim > 2:
        raise ValueError("B must be 1- or 2-d")

    if perm is None:
        perm = np.zeros(n, dtype=config.index_dtype)

    if mtype not in _REAL_MTYPES + _COMPLEX_MTYPES:
        return _fail(B, pt, perm, -1, quiet)

    _check_iparm(iparm, quiet)
    # iparm[11]: 0 = solve A X = B, 1 = conjugate-transpose A^H X = B,
    # 2 = transpose A^T X = B (MKL slot semantics).
    tmode = 0
    if iparm is not None:
        ip = np.asarray(iparm)
        if ip.shape[0] > 11:
            tmode = int(ip[11])
            if tmode not in (0, 1, 2):
                return _fail(B, pt, perm, -1, quiet)

    if X is None:
        X = np.zeros_like(np.asarray(B))

    phase = int(phase)

    # Release phases
    if phase < 0:
        _factor_store.pop(int(pt[0]), None)
        pt[:] = 0
        return X, pt, perm, 0

    # Solve-only calls (phase 33) read nothing but the stored factor: no
    # triangle expansion and no upload of A.
    A_container = None
    if phase in (11, 12, 13, 22, 23):
        if mtype in (2, -2, 4, -4, 6):
            A = _expand_triangle(A, mtype)
        try:
            A_container = formats.to_device(A)
        except ValueError:
            return _fail(B, pt, perm, -1, quiet)

    key = int(pt[0])
    state = _factor_store.get(key)
    if state is None:
        key = next(_next_key)
        state = {}
        _factor_store[key] = state
        # pt is the opaque handle: nonzero after analysis, as the
        # reference tests assert.
        pt[0] = key
        pt[1] = n

    do_analysis = phase in (11, 12, 13)
    do_factor = phase in (12, 13, 22, 23)
    do_solve = phase in (13, 23, 33)

    if do_analysis:
        state["n"] = n
        state["structure_nnz"] = A_container.nnz

    if do_factor and _needs_iterative(n):
        # Beyond the dense-LU budget: a matrix-free Krylov solve at phase
        # 33, the matrix itself is the "factorization".  Real only: fail
        # complex here instead of promising a solve phase 33 rejects.
        if A_container.iscomplex:
            warnings.warn(
                f"sparse_dot_tpu_torch pardiso: n={n} exceeds the "
                "dense-LU budget and the matrix-free fallback supports "
                "real mtypes only; raise config.pardiso_dense_budget_bytes "
                "or use the iterative solvers directly",
                RuntimeWarning,
            )
            return _fail(B, pt, perm, -1, quiet)
        warnings.warn(
            f"sparse_dot_tpu_torch pardiso: n={n} exceeds the dense-LU "
            "budget; phases 22/33 will run a matrix-free Krylov solve "
            "(CG for the SPD mtype 2, FGMRES otherwise) instead of a "
            "direct factorization",
            RuntimeWarning,
        )
        # CG needs positive definiteness: only mtype 2 (real symmetric
        # positive definite) qualifies; -2 (indefinite) runs FGMRES.
        state.update(iterative=True, container=A_container,
                     mtype_sym=mtype == 2, dtype=A_container.dtype, lu=None)
        _report(iparm, int(A_container.nnz), 0)

    elif do_factor:
        lu, piv, _ = torch.linalg.lu_factor_ex(A_container.to_dense())
        # Zero U-pivots mean an exactly singular system: its LU is finite,
        # so check the diagonal as well as finiteness, in one device read.
        bad = (~torch.isfinite(lu)).any() | (torch.diagonal(lu) == 0).any()
        if bool(bad):
            return _fail(B, pt, perm, -4, quiet)
        state.update(lu=(lu, piv), dtype=A_container.dtype, iterative=False)
        # A prior over-budget factorization on this pt armed the Krylov
        # route; the direct factor disarms it.
        state.pop("container", None)
        # The backing factor is a dense LU: n^2 entries, (2/3) n^3 flops,
        # reported in MFLOP.
        _report(iparm, n * n, int(2 * n**3 / 3 / 1e6))

    if do_solve and state.get("iterative"):
        x = _krylov_solve(state, B, tmode)
        if x is None:
            return _fail(B, pt, perm, -4, quiet)
        X[...] = x.astype(np.asarray(B).dtype, copy=False)
        return X, pt, perm, 0

    if do_solve:
        if state.get("lu") is None:
            return _fail(B, pt, perm, -1, quiet)
        X[...] = _lu_solve(state, B, tmode).astype(np.asarray(B).dtype,
                                                   copy=False)
        # iparm[6] output report: refinement steps performed.
        if iparm is not None and len(iparm) > 6:
            iparm[6] = 0

    return X, pt, perm, 0


def export_factorization(pt):
    """Serialize the factorization behind ``pt`` to a plain dict of numpy
    arrays (picklable), in the JAX package's layout: ``piv`` holds 0-based
    pivots (the scipy and ``jax.scipy.linalg.lu_factor`` convention), so a
    blob moves between the two packages either way.  Reload with
    :func:`import_factorization` and solve with phase 33."""
    state = _factor_store.get(int(np.asarray(pt)[0]))
    if state is None or state.get("lu") is None:
        raise ValueError(
            "pt does not reference a live factorization (run phase "
            "12/13/22/23 first)"
        )
    lu, piv = state["lu"]
    return {
        "version": 1,
        "lu": lu.cpu().numpy(),
        "piv": (piv - 1).cpu().numpy(),
        "embedded": False,
        "mixed": False,
        "a_dense": None,
        "dtype": np.dtype(state["dtype"]).str,
        "n": int(state.get("n", lu.shape[0])),
        "structure_nnz": int(state.get("structure_nnz", 0)),
    }


def import_factorization(blob):
    """Restore a factorization exported by :func:`export_factorization` of
    either package; returns a fresh ``pt`` block referencing it (solve with
    phase 33).  The 0-based pivots of the blob become torch's 1-based
    LAPACK pivots.  Blobs of the JAX package's TPU layouts (``embedded``:
    the real 2n embedding of a complex system; ``mixed``: an f32 factor
    refined in f64) are rejected."""
    if not isinstance(blob, dict) or "lu" not in blob or "piv" not in blob:
        raise ValueError("not a sparse_dot_tpu factorization export")
    if blob.get("embedded") or blob.get("mixed"):
        raise ValueError(
            "the factorization is in a TPU layout of sparse_dot_tpu "
            "(embedded: the real 2n x 2n embedding of a complex system; "
            "mixed: an f32 factor with f64 refinement); refactor the "
            "system with this package instead"
        )
    device = torch_device()
    lu = torch.from_numpy(np.array(blob["lu"])).to(device)
    piv = torch.from_numpy(np.asarray(blob["piv"], dtype=np.int32) + 1).to(
        device)
    key = next(_next_key)
    _factor_store[key] = {
        "lu": (lu, piv),
        "dtype": np.dtype(blob["dtype"]),
        "n": int(blob["n"]),
        "structure_nnz": int(blob.get("structure_nnz", 0)),
    }
    pt = np.zeros(64, dtype=np.int64)
    pt[0] = key
    pt[1] = int(blob["n"])
    return pt


def _fail(B, pt, perm, error, quiet):
    if not quiet and PARDISO_ERRORS.get(error):
        warnings.warn(
            f"PARDISO returned error {error}: {PARDISO_ERRORS[error]}",
            RuntimeWarning,
        )
    return np.zeros_like(np.asarray(B)), pt, perm, error
