"""Parity of the port's handle protocol and solvers with the JAX package.

The same inputs, made from a seed with numpy, go through ``sparse_dot_tpu``
(on the CPU backend) and ``sparse_dot_tpu_torch`` (on the CPU, where each
kernel wrapper runs its plain version).  Tolerances: float64 iterates and
solutions agree to rtol 1e-9 (the JAX package's loops sum in COO or ELL
order, the port's in CSR order); iteration, cycle and inner counts are
equal on these seeds; converted and ordered CSR arrays are equal exactly
(both are permutations of the same entries).  The port's stepwise and
fused loops agree exactly.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import sparse_dot_tpu as jx
import sparse_dot_tpu_torch as pt
from sparse_dot_tpu import interface as jx_interface
from sparse_dot_tpu.solvers import export_factorization as jx_export
from sparse_dot_tpu.solvers import import_factorization as jx_import
from sparse_dot_tpu.solvers import qr as jx_qr
from sparse_dot_tpu_torch import formats as pt_formats
from sparse_dot_tpu_torch import interface as pt_interface
from sparse_dot_tpu_torch.config import config as pt_config
from sparse_dot_tpu_torch.solvers import export_factorization as pt_export
from sparse_dot_tpu_torch.solvers import import_factorization as pt_import
from sparse_dot_tpu_torch.solvers import qr as pt_qr


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless asked otherwise; these tests ask
    for the CPU, where its wrappers take their plain versions."""
    saved = pt_config.device
    pt_config.device = "cpu"
    yield
    pt_config.device = saved


RTOL = 1e-9
PACKAGES = {"jax": jx, "port": pt}


def random_csr(rng, m, k, nnz, diag=0.0):
    """m x k CSR from nnz N(0, 1) entries at random positions (repeats
    summed) plus ``diag`` on the diagonal."""
    a = sps.csr_matrix((rng.standard_normal(nnz),
                        (rng.integers(0, m, nnz), rng.integers(0, k, nnz))),
                       shape=(m, k))
    if diag:
        a = a + diag * sps.eye(m, k)
    a = a.tocsr()
    a.sum_duplicates()
    return a


def spd(seed, n=60):
    rng = np.random.default_rng(seed)
    m = random_csr(rng, n, n, 4 * n)
    return (m @ m.T + n * sps.eye(n)).tocsr(), rng.standard_normal(n)


def nonsymmetric(seed, n=50):
    rng = np.random.default_rng(seed)
    return random_csr(rng, n, n, 6 * n, diag=6.0), rng.standard_normal(n)


def assert_close(port, ref):
    np.testing.assert_allclose(port, ref, rtol=RTOL,
                               atol=RTOL * np.abs(ref).max())


# ---------------------------------------------------------------------------
# Handles and K10
# ---------------------------------------------------------------------------


def shuffled_rows(a, rng):
    """``a`` with the entries of each row in a random order."""
    a = a.copy()
    for i in range(a.shape[0]):
        s, e = a.indptr[i], a.indptr[i + 1]
        order = s + rng.permutation(e - s)
        a.indices[s:e], a.data[s:e] = a.indices[order], a.data[order]
    return a


@pytest.mark.parametrize("kind", ["csc", "bsr", "order"])
def test_handle_convert_and_order_match_jax(kind):
    rng = np.random.default_rng(40)
    a = random_csr(rng, 60, 48, 500)
    if kind == "csc":
        src = a.tocsc()
    elif kind == "bsr":
        src = a.tobsr(blocksize=(4, 4))
    else:
        src = shuffled_rows(a, rng)
    out = {}
    for name, iface in (("jax", jx_interface), ("port", pt_interface)):
        h, _, _ = iface.create_sparse_handle(src)
        h = (iface.order_sparse_handle(h) if kind == "order"
             else iface.convert_to_csr(h))
        out[name] = iface.export_sparse_handle(h, output_type="csr_matrix")
    for attr in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(out["port"], attr),
                                      getattr(out["jax"], attr))
    np.testing.assert_array_equal(out["port"].toarray(), src.toarray())


def test_sort_csr_indices_is_a_row_major_sort():
    rng = np.random.default_rng(41)
    rows = rng.integers(0, 30, 400)
    cols = rng.integers(0, 50, 400)
    vals = rng.standard_normal(400)
    got_cols, got_vals = pt_formats.sort_csr_indices(
        torch.from_numpy(rows), torch.from_numpy(cols),
        torch.from_numpy(vals), 50)
    order = np.lexsort((cols, rows))  # stable: ties keep their order
    np.testing.assert_array_equal(got_cols.numpy(), cols[order])
    np.testing.assert_array_equal(got_vals.numpy(), vals[order])


def test_matmul_handles_matches_jax():
    rng = np.random.default_rng(42)
    a, b = random_csr(rng, 40, 70, 300), random_csr(rng, 70, 30, 300)
    out = {}
    for name, iface in (("jax", jx_interface), ("port", pt_interface)):
        h = iface.matmul_handles(iface.create_sparse_handle(a)[0],
                                 iface.create_sparse_handle(b.tocsc())[0])
        out[name] = iface.export_sparse_handle(h)
    assert isinstance(pt_interface.matmul_handles(
        pt_interface.create_sparse_handle(a)[0],
        pt_interface.create_sparse_handle(b)[0]).container, pt_formats.CSR)
    np.testing.assert_array_equal(out["port"].indptr, out["jax"].indptr)
    np.testing.assert_array_equal(out["port"].indices, out["jax"].indices)
    assert_close(out["port"].data, out["jax"].data)


# ---------------------------------------------------------------------------
# CG
# ---------------------------------------------------------------------------


def cg_runs(mod, A, b, x0=None, max_iter=1000, r_tol=1e-10, descr=None):
    """(fused x, fused count, fused code, stepwise x, stepwise count)."""
    runs = []
    for fused in (True, False):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", mod.ConvergenceWarning)
            with mod.CGIterativeSparseSolver(A, b, x=x0, r_tol=r_tol,
                                             max_iter=max_iter) as s:
                if descr:
                    s.set_sparse_matrix_descr(*descr)
                if fused:
                    x = s.solve()
                else:
                    for _ in s:
                        pass
                    x = s.x
                runs.append((x, s.current_iter, s.final_code))
    (xf, nf, cf), (xs, ns, _) = runs
    return xf, nf, cf, xs, ns


@pytest.mark.parametrize("seed,x0,max_iter", [
    (1, False, 1000), (2, True, 1000), (3, False, 7)],
    ids=["converges", "x0", "max_iter"])
def test_cg_matches_jax_fused_and_stepwise(seed, x0, max_iter):
    A, b = spd(seed)
    x0 = np.random.default_rng(seed).standard_normal(A.shape[0]) if x0 \
        else None
    j = cg_runs(jx, A, b, x0, max_iter)
    p = cg_runs(pt, A, b, x0, max_iter)
    assert p[1] == j[1] and p[4] == j[4] and p[1] == p[4]
    assert p[2] == j[2] == (0 if max_iter == 1000 else -1)
    assert_close(p[0], j[0])
    np.testing.assert_array_equal(p[0], p[3])  # fused == stepwise


def test_cg_symmetric_descriptor_matches_jax():
    """The stored upper triangle under SPARSE_MATRIX_TYPE_SYMMETRIC solves
    the full symmetric system, as in the JAX package."""
    A, b = spd(4)
    descr = (pt_interface.SPARSE_MATRIX_TYPE_SYMMETRIC,
             pt_interface.SPARSE_FILL_MODE_UPPER,
             pt_interface.SPARSE_DIAG_NON_UNIT)
    upper = sps.triu(A, format="csr")
    j = cg_runs(jx, upper, b, descr=descr)
    p = cg_runs(pt, upper, b, descr=descr)
    assert p[1] == j[1] == p[4] and p[2] == 0
    assert_close(p[0], j[0])
    np.testing.assert_array_equal(p[0], p[3])
    np.testing.assert_allclose(p[0], np.linalg.solve(A.toarray(), b),
                               rtol=1e-8)


def test_symmetric_operator_is_the_full_matrix():
    A, _ = spd(5)
    from sparse_dot_tpu_torch.solvers.iterative import container_operator

    op = container_operator(pt_formats.to_device(sps.triu(A, format="csr")),
                            A.shape[0], symmetric=True)
    indptr, indices, data = (t.numpy() for t in op.arrays)
    full = sps.csr_matrix((data, indices, indptr), shape=A.shape)
    np.testing.assert_array_equal(full.toarray(), A.toarray())


@pytest.mark.parametrize("maxiter", [1000, 3])
def test_cg_mrhs_matches_jax(maxiter):
    """Multi-RHS CG: X and codes as the JAX package's, a zero column frozen
    from the start; at maxiter=3 the other columns stop unconverged."""
    A, b = spd(6)
    rng = np.random.default_rng(6)
    B = np.stack([b, np.zeros_like(b), rng.standard_normal(b.size)], 1)
    out = {}
    for name, mod in PACKAGES.items():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", mod.ConvergenceWarning)
            out[name] = mod.cg_mrhs(A, B, tol=1e-10, maxiter=maxiter)
    np.testing.assert_array_equal(out["port"][1], out["jax"][1])
    np.testing.assert_array_equal(
        out["port"][1], [0, 0, 0] if maxiter == 1000 else [-1, 0, -1])
    assert_close(out["port"][0], out["jax"][0])
    assert not out["port"][0][:, 1].any()


# ---------------------------------------------------------------------------
# FGMRES
# ---------------------------------------------------------------------------


def fgmres_runs(mod, A, b, restart, max_iter=1000):
    runs = []
    for fused in (True, False):
        with mod.FGMRESIterativeSparseSolver(A, b, r_tol=1e-10,
                                             max_iter=max_iter) as s:
            s.restart = restart
            if fused:
                x = s.solve()
            else:
                for _ in s:
                    pass
                x = s.x
            runs.append((x, s.current_iter, s.total_inner_iterations,
                         s.final_code))
    return runs


@pytest.mark.parametrize("restart", [5, 20])
def test_fgmres_matches_jax_fused_and_stepwise(restart):
    A, b = nonsymmetric(7)
    (jf, js), (pf, ps) = fgmres_runs(jx, A, b, restart), fgmres_runs(
        pt, A, b, restart)
    assert pf[1:] == jf[1:] and ps[1:3] == js[1:3] and pf[1:3] == ps[1:3]
    assert pf[3] == 0
    assert_close(pf[0], jf[0])
    np.testing.assert_array_equal(pf[0], ps[0])
    np.testing.assert_allclose(pf[0], np.linalg.solve(A.toarray(), b),
                               rtol=1e-8)


@pytest.mark.parametrize("solver", ["cg", "fgmres"])
def test_kernel_failure_reaches_the_caller(solver, monkeypatch):
    """A failing matvec (a kernel that does not build or launch) raises
    out of ``cg`` and ``fgmres``; it is not turned into (x0, code)."""
    from sparse_dot_tpu_torch.ops import csr

    def fail(*args, **kwargs):
        raise RuntimeError("csr_spmv: launch failed")

    A, b = spd(10) if solver == "cg" else nonsymmetric(10)
    monkeypatch.setattr(csr, "csr_spmv", fail)
    with pytest.raises(RuntimeError, match="launch failed"):
        getattr(pt, solver)(A, b)


# ---------------------------------------------------------------------------
# Sparse QR
# ---------------------------------------------------------------------------


def tall_system(seed, m=400, k=40, nrhs=2):
    rng = np.random.default_rng(seed)
    a = random_csr(rng, m, k, 6 * m)
    a = (a + sps.vstack([2.0 * sps.eye(k), sps.csr_matrix((m - k, k))])
         ).tocsr()
    return a, rng.standard_normal((m, nrhs))


@pytest.mark.parametrize("route", ["householder", "cgls"])
def test_sparse_qr_matches_jax(route, monkeypatch):
    A, B = tall_system(8)
    if route == "cgls":
        monkeypatch.setattr(jx_qr, "_QR_DENSIFY_BUDGET", 1)
        monkeypatch.setattr(pt_qr, "_QR_DENSIFY_BUDGET", 1)
    got = pt.sparse_qr_solve(A, B)
    ref = jx.sparse_qr_solve(A, B)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert_close(got, ref)
    assert pt_qr._last_cgls_iters == jx_qr._last_cgls_iters
    assert (pt_qr._last_cgls_iters is None) == (route == "householder")
    np.testing.assert_allclose(
        got, np.linalg.lstsq(A.toarray(), B, rcond=None)[0], rtol=1e-8)


def wide_system(seed, m=40, k=120, nrhs=2):
    rng = np.random.default_rng(seed)
    a = (random_csr(rng, m, k, 6 * m)
         + sps.hstack([2.0 * sps.eye(m), sps.csr_matrix((m, k - m))])
         ).tocsr()
    return a, rng.standard_normal((m, nrhs))


def test_sparse_qr_wide_a_raises_on_householder_like_jax():
    """A wide A on the dense route: both packages raise ValueError (the
    type only is held to JAX's; the port's message names A's shape)."""
    A = sps.random(4, 8, density=0.5, format="csr", random_state=0)
    with pytest.raises(ValueError, match=r"\(4, 8\)"):
        pt.sparse_qr_solve(A, np.ones(4))
    with pytest.raises(ValueError):
        jx.sparse_qr_solve(A, np.ones(4))


@pytest.mark.parametrize("nrhs", [1, 2])
def test_sparse_qr_wide_cgls_matches_jax(nrhs, monkeypatch):
    """Past the densify budget a wide A runs CGLS in both packages and
    solves the consistent system (the Jacobi scaling picks a solution
    other than the least-norm one, the same in both)."""
    A, B = wide_system(10, nrhs=nrhs)
    b = B[:, 0] if nrhs == 1 else B
    monkeypatch.setattr(jx_qr, "_QR_DENSIFY_BUDGET", 1)
    monkeypatch.setattr(pt_qr, "_QR_DENSIFY_BUDGET", 1)
    got = pt.sparse_qr_solve(A, b)
    ref = jx.sparse_qr_solve(A, b)
    assert got.shape == ref.shape == (A.shape[1],) + b.shape[1:]
    assert_close(got, ref)
    assert pt_qr._last_cgls_iters == jx_qr._last_cgls_iters
    np.testing.assert_allclose(A @ got, b, rtol=1e-8,
                               atol=1e-8 * np.abs(b).max())


@pytest.mark.parametrize("nrhs", [1, 2])
def test_cgls_products_by_column_count(nrhs, monkeypatch):
    """CGLS runs its products on the CSR SpMV (K3) for one right-hand side
    and on the CSR SpMM (K2) for several; the other wrapper must not run.
    The result still matches the JAX package's."""
    from sparse_dot_tpu_torch.ops import csr

    A, B = tall_system(9, nrhs=nrhs)
    b = B[:, 0] if nrhs == 1 else B

    def refuse(*args, **kwargs):
        raise AssertionError("CGLS ran the wrong product")

    monkeypatch.setattr(csr, "csr_spmm" if nrhs == 1 else "csr_spmv", refuse)
    monkeypatch.setattr(jx_qr, "_QR_DENSIFY_BUDGET", 1)
    monkeypatch.setattr(pt_qr, "_QR_DENSIFY_BUDGET", 1)
    got = pt.sparse_qr_solve(A, b)
    ref = jx.sparse_qr_solve(A, b)
    assert got.shape == ref.shape == (A.shape[1],) + b.shape[1:]
    assert_close(got, ref)
    assert pt_qr._last_cgls_iters == jx_qr._last_cgls_iters


# ---------------------------------------------------------------------------
# PARDISO
# ---------------------------------------------------------------------------


def pardiso_phases(mod, A, B, mtype, tmode=0):
    """Phases 11, 22, 33 on one pt: (X, iparm)."""
    p, iparm = mod.pardisoinit(mtype)
    iparm[11] = tmode
    for phase in (11, 22):
        _, p, _, err = mod.pardiso(A, B, p, mtype, iparm, phase)
        assert err == 0
    X, p, _, err = mod.pardiso(A, B, p, mtype, iparm, 33)
    assert err == 0
    mod.pardiso(A, B, p, mtype, iparm, -1)
    return X, iparm


@pytest.mark.parametrize("dtype,tmode", [
    (np.float64, 0), (np.float64, 1), (np.float64, 2),
    (np.complex128, 0), (np.complex128, 1), (np.complex128, 2)])
def test_pardiso_direct_matches_jax(dtype, tmode):
    A, b = nonsymmetric(9, 40)
    rng = np.random.default_rng(9)
    B = np.stack([b, rng.standard_normal(b.size)], 1).astype(dtype)
    A = A.astype(dtype)
    mtype = 11
    if dtype == np.complex128:
        A = (A + 0.5j * random_csr(rng, 40, 40, 200)).tocsr()
        B = B + 1j * rng.standard_normal(B.shape)
        mtype = 13
    (xj, ij), (xp, ip) = (pardiso_phases(jx, A, B, mtype, tmode),
                          pardiso_phases(pt, A, B, mtype, tmode))
    assert xp.dtype == xj.dtype
    assert_close(xp, xj)
    np.testing.assert_array_equal(ip[[6, 17, 18]], ij[[6, 17, 18]])
    op = {0: A, 1: A.conj().T, 2: A.T}[tmode].toarray()
    np.testing.assert_allclose(xp, np.linalg.solve(op, B), rtol=1e-8)


@pytest.mark.parametrize("mtype", [2, 11])
def test_pardiso_krylov_route_matches_jax(mtype, monkeypatch):
    """Past the dense budget: CG (mtype 2) or FGMRES (11) on both."""
    from sparse_dot_tpu.config import config as jx_config

    A, b = spd(10) if mtype == 2 else nonsymmetric(10)
    monkeypatch.setattr(jx_config, "pardiso_dense_budget_bytes", 1 << 10)
    monkeypatch.setattr(pt_config, "pardiso_dense_budget_bytes", 1 << 10)
    out = {}
    for name, mod in PACKAGES.items():
        p, iparm = mod.pardisoinit(mtype)
        iparm[11] = 2
        with pytest.warns(RuntimeWarning, match="matrix-free"):
            X, p, _, err = mod.pardiso(A, b, p, mtype, iparm, 13)
        assert err == 0
        out[name] = (X, iparm[17])
    assert_close(out["port"][0], out["jax"][0])
    assert out["port"][1] == out["jax"][1] == A.nnz


def test_pardiso_imports_jax_factor_and_back():
    """A factor exported by the JAX package (0-based pivots) solves on the
    port with phase 33 to the JAX package's X, and the port's export
    (0-based pivots too) solves on the JAX package."""
    A, b = nonsymmetric(11, 40)
    B = np.stack([b, 2 * b + 1], 1)
    X = {}
    for name, mod, export in (("jax", jx, jx_export), ("port", pt, pt_export)):
        p, iparm = mod.pardisoinit(11)
        _, p, _, err = mod.pardiso(A, B, p, 11, iparm, 12)
        assert err == 0
        X[name] = (mod.pardiso(A, B, p, 11, iparm, 33)[0], export(p))
    for blob, mod, importer, ref in (
            (X["jax"][1], pt, pt_import, X["jax"][0]),
            (X["port"][1], jx, jx_import, X["port"][0])):
        p = importer(blob)
        got, _, _, err = mod.pardiso(A, B, p, 11, mod.pardisoinit(11)[1], 33)
        assert err == 0
        np.testing.assert_allclose(got, ref, rtol=1e-12)
    np.testing.assert_array_equal(X["port"][1]["piv"], X["jax"][1]["piv"])


@pytest.mark.parametrize("key", ["embedded", "mixed"])
def test_pardiso_import_rejects_tpu_layouts(key):
    A, b = nonsymmetric(12, 20)
    p, iparm = jx.pardisoinit(11)
    _, p, _, _ = jx.pardiso(A, b, p, 11, iparm, 12)
    blob = dict(jx_export(p), **{key: True})
    with pytest.raises(ValueError, match="TPU layout"):
        pt_import(blob)
