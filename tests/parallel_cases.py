"""The sharded cases of ``tests/test_torch_parallel.py`` and
``tests/test_torch_multihost.py``, and the gloo cluster that runs them.

Each case is a function ``case(pkg, S)`` of a package namespace: the JAX
package's ``parallel`` on a mesh of S of its CPU devices, run in the
pytest process, or the port's, run in each of S spawned ranks of a gloo
group.  The same body on the same seeded inputs gives both sides' results,
which the tests compare; an exception a case expects is returned as
``(type name, message)`` by ``raised``.  Nothing here imports JAX or the
JAX package, so the ranks, which import this module, hold only the port
(each rank checks it after every case).
"""

import multiprocessing
import os
import queue
import sys
import traceback
from datetime import timedelta
from types import SimpleNamespace

import numpy as np
import numpy.testing as npt
import scipy.sparse as sps

from .common import MATRIX_1, np_almost_equal

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def raised(fn):
    """(type name, message) of the exception ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as e:  # compared by type and message
        return type(e).__name__, str(e)
    return None


def _rows(pkg, S, A):
    mesh = pkg.mesh((S, 1))
    return mesh, pkg.shard_csr_rows(A, S, mesh)


def _b(seed, n):
    return np.random.default_rng(seed).random((MATRIX_1.shape[1], n))


# ---------------------------------------------------------------------------
# tests/test_parallel.py, TestShardedOps
# ---------------------------------------------------------------------------


@case
def multiple_devices_available(pkg, S):
    assert pkg.n_devices >= 2
    return {"n": pkg.n_devices}


@case
def row_sharded_spmm(pkg, S):
    A, B = MATRIX_1.tocsr(), _b(9, 40)
    mesh, A_sh = _rows(pkg, S, A)
    C = np.asarray(pkg.sharded_spmm(mesh, A_sh, B))
    np_almost_equal(C, A.toarray() @ B)
    return {"C": C}


@case
def row_sharded_spmv(pkg, S):
    A, x = MATRIX_1.tocsr(), _b(9, 40)[:, 0]
    mesh, A_sh = _rows(pkg, S, A)
    y = np.asarray(pkg.sharded_spmv(mesh, A_sh, x))
    np_almost_equal(y, A.toarray() @ x)
    return {"y": y}


@case
def k_sharded_spmm_psum(pkg, S):
    A, B = MATRIX_1.tocsr(), _b(9, 40)
    mesh = pkg.mesh((1, S))
    A_sh = pkg.shard_csr_cols(A, S, mesh)
    C = np.asarray(pkg.sharded_spmm_2d(mesh, A_sh, B))
    np_almost_equal(C, A.toarray() @ B)
    return {"C": C}


@case
def row_sharded_spmm_f32(pkg, S):
    A32, B = MATRIX_1.astype(np.float32), _b(9, 40).astype(np.float32)
    mesh, A_sh = _rows(pkg, S, A32)
    assert A_sh.dtype == np.float32
    C = np.asarray(pkg.sharded_spmm(mesh, A_sh, B))
    np_almost_equal(C, A32.toarray() @ B, decimal=4)
    return {"C": C}


def _complex_spmm(pkg, S, Ac, b):
    mesh, A_sh = _rows(pkg, S, Ac)
    assert A_sh.dtype == Ac.dtype
    C = np.asarray(pkg.sharded_spmm(mesh, A_sh, b))
    np_almost_equal(C, Ac.toarray() @ b)
    return {"C": C}


@case
def row_sharded_spmm_complex(pkg, S):
    A, B = MATRIX_1, _b(9, 40)
    Ac = (A + 0.5j * A).tocsr().astype(np.complex128)
    return _complex_spmm(pkg, S, Ac, B + 1j * B[:, ::-1])


@case
def row_sharded_spmm_complex_real_b(pkg, S):
    A = MATRIX_1
    return _complex_spmm(pkg, S, (A - 2j * A).tocsr().astype(np.complex128),
                         _b(9, 40))


@case
def row_sharded_spmm_real_a_complex_b(pkg, S):
    B = _b(9, 40)
    return _complex_spmm(pkg, S, MATRIX_1.tocsr(), B + 1j * B[:, ::-1])


@case
def row_sharded_spmv_complex(pkg, S):
    A, B = MATRIX_1, _b(9, 40)
    Ac = (A + 1j * A.multiply(0.25)).tocsr().astype(np.complex128)
    xc = B[:, 0] + 1j * B[:, 1]
    mesh, A_sh = _rows(pkg, S, Ac)
    y = np.asarray(pkg.sharded_spmv(mesh, A_sh, xc))
    np_almost_equal(y, Ac.toarray() @ xc)
    return {"y": y}


def _ring(pkg, S, A, b, decimal=6):
    mesh = pkg.mesh((S, 1))
    A_grid = pkg.shard_csr_grid(A, S, mesh)
    C = np.asarray(pkg.sharded_spmm_ring(mesh, A_grid, b))
    np_almost_equal(C, A.toarray() @ b, decimal=decimal)
    return {"C": C}


@case
def ring_spmm_complex(pkg, S):
    A, B = MATRIX_1, _b(9, 40)
    return _ring(pkg, S, (A + 0.5j * A).tocsr().astype(np.complex128),
                 B + 1j * B[:, ::-1])


@case
def ring_spmm_complex64(pkg, S):
    A, B = MATRIX_1, _b(9, 40)
    out = _ring(pkg, S, (A + 0.5j * A).astype(np.complex64).tocsr(),
                (B + 1j * B[:, ::-1]).astype(np.complex64), decimal=3)
    assert out["C"].dtype == np.complex64
    return out


@case
def sharded_gram(pkg, S):
    A = MATRIX_1.tocsr()
    mesh, A_sh = _rows(pkg, S, A)
    G = np.asarray(pkg.sharded_gram(mesh, A_sh))
    np_almost_equal(G, A.toarray().T @ A.toarray())
    return {"G": G}


def _spd(n):
    M = sps.random(n, n, density=0.2, random_state=4, format="csr")
    return (M @ M.T + n * sps.identity(n)).tocsr()


@case
def sharded_cg(pkg, S):
    n = 64
    A, b = _spd(n), np.random.default_rng(5).random(n)
    mesh, A_sh = _rows(pkg, S, A)
    x, res, iters = pkg.sharded_cg(mesh, A_sh, b, tol=1e-12)
    npt.assert_array_almost_equal(x, np.linalg.solve(A.toarray(), b))
    assert res < 1e-10
    return {"x": x, "iters": iters}


# ---------------------------------------------------------------------------
# TestRingSpMM
# ---------------------------------------------------------------------------


@case
def ring_spmm_matches_dense(pkg, S):
    return _ring(pkg, S, MATRIX_1.tocsr(), _b(10, 24))


@case
def ring_spmm_uneven_dims(pkg, S):
    return _ring(pkg, S, MATRIX_1.tocsr()[:197, :299], _b(10, 24)[:299])


@case
def dot_product_routes_sharded(pkg, S):
    A, B = MATRIX_1.tocsr(), _b(10, 24)
    mesh, A_rows = _rows(pkg, S, A)
    C = pkg.dot_product(A_rows, B)
    np_almost_equal(C, A.toarray() @ B)
    v = B[:, 0].copy()
    y = pkg.dot_product(A_rows, v)
    np_almost_equal(y, A.toarray() @ v)
    C2 = pkg.dot_product(pkg.shard_csr_grid(A, S, mesh), B)
    np_almost_equal(C2, A.toarray() @ B)
    return {"C": C, "y": y, "C2": C2}


@case
def dot_product_sharded_guards(pkg, S):
    A, B = MATRIX_1.tocsr(), _b(10, 24)
    A_nomesh = pkg.shard_csr_rows(A, S, mesh=None)
    _, A_rows = _rows(pkg, S, A)
    return {"no_mesh": raised(lambda: pkg.dot_product(A_nomesh, B)),
            "dense_left": raised(lambda: pkg.dot_product(B, A_rows))}


@case
def dot_product_sharded_kwargs(pkg, S):
    A, B = MATRIX_1.tocsr(), _b(10, 24)
    _, A_rows = _rows(pkg, S, A)
    ref = A.toarray() @ B
    out = np.full(ref.shape, 2.0, dtype=ref.dtype)
    got = pkg.dot_product(A_rows, B, out=out, out_scalar=3.0)
    assert got is out
    np_almost_equal(out, ref + 3.0 * 2.0)
    bad = np.zeros((ref.shape[0] + 1, ref.shape[1]), dtype=ref.dtype)
    b32 = B.astype(np.float32)
    cast = pkg.dot_product(A_rows, b32, cast=True)
    np_almost_equal(cast, A.toarray() @ b32.astype(np.float64))
    return {"out": out,
            "bad_out": raised(lambda: pkg.dot_product(A_rows, B, out=bad)),
            "no_cast": raised(lambda: pkg.dot_product(A_rows, b32)),
            "cast": cast}


# ---------------------------------------------------------------------------
# TestShardedSpGEMM
# ---------------------------------------------------------------------------


def _spgemm_operands(pkg, S, dtype=np.float64):
    A = MATRIX_1.tocsr().astype(dtype)
    B = sps.random(A.shape[1], 120, density=0.05, format="csr",
                   dtype=np.float64, random_state=11).astype(dtype)
    mesh = pkg.mesh((S, 1))
    return (A, B, mesh, pkg.shard_csr_grid(A, S, mesh),
            pkg.shard_csr_krows(B, S, mesh))


@case
def sharded_spgemm_matches_scipy(pkg, S):
    A, B, mesh, A_grid, B_k = _spgemm_operands(pkg, S)
    C = pkg.sharded_spgemm(mesh, A_grid, B_k)
    np_almost_equal(C.toarray(), (A @ B).toarray())
    return {"C": C}


@case
def dot_product_routes_sharded_spgemm(pkg, S):
    A, B, _, A_grid, B_k = _spgemm_operands(pkg, S)
    C = pkg.dot_product(A_grid, B_k)
    np_almost_equal(C.toarray(), (A @ B).toarray())
    return {"C": C}


@case
def sharded_spgemm_kwarg_guards(pkg, S):
    A, B, _, A_grid, B_k = _spgemm_operands(pkg, S)
    out = np.zeros((A.shape[0], B.shape[1]))
    C = pkg.dot_product(A_grid, B_k, reorder_output=True)
    assert C.has_sorted_indices
    return {"out": raised(lambda: pkg.dot_product(A_grid, B_k, out=out)),
            "dense": raised(lambda: pkg.dot_product(A_grid, B_k,
                                                    dense=True)),
            "C": C}


@case
def sharded_spgemm_requires_grid(pkg, S):
    A, B, mesh, _, B_k = _spgemm_operands(pkg, S)
    A_rows = pkg.shard_csr_rows(A, S, mesh)
    return {"rows": raised(lambda: pkg.dot_product(A_rows, B_k))}


@case
def sharded_spgemm_f32(pkg, S):
    A, B, mesh, A_grid, B_k = _spgemm_operands(pkg, S, np.float32)
    C = pkg.sharded_spgemm(mesh, A_grid, B_k)
    assert C.dtype == np.float32
    np_almost_equal(C.toarray(), (A @ B).toarray(), decimal=4)
    return {"C": C}


@case
def sharded_spgemm_structural_pattern(pkg, S):
    A = sps.csr_matrix(np.tile([[1.0, -1.0]], (8, 1)))
    B = sps.csr_matrix(np.array([[1.0, 3.0], [1.0, 0.0]]))
    mesh = pkg.mesh((S, 1))
    C = pkg.sharded_spgemm(mesh, pkg.shard_csr_grid(A, S, mesh),
                           pkg.shard_csr_krows(B, S, mesh))
    assert C.nnz == 16  # 8 explicit zeros + 8 values
    np_almost_equal(C.toarray(), A.toarray() @ B.toarray())
    return {"C": C}


# ---------------------------------------------------------------------------
# TestShardedCGLS
# ---------------------------------------------------------------------------


@case
def sharded_least_squares(pkg, S):
    A = MATRIX_1.copy().tocsr()[:, :50]
    b = np.random.default_rng(2).random(A.shape[0])
    mesh, A_sh = _rows(pkg, S, A)
    x, res, iters = pkg.sharded_cgls(mesh, A_sh, b, tol=1e-12)
    npt.assert_array_almost_equal(
        x, np.linalg.lstsq(A.toarray(), b, rcond=None)[0])
    return {"x": x, "res": res, "iters": iters}


@case
def sharded_ill_conditioned(pkg, S):
    rng = np.random.default_rng(9)
    m, k = 4000, 60
    A0 = sps.random(m, k, density=0.02, format="csr", dtype=np.float64,
                    random_state=9)
    tail = sps.csr_matrix((np.ones(k), (np.arange(m - k, m), np.arange(k))),
                          shape=(m, k))
    A = ((A0 + tail) @ sps.diags(np.logspace(0, -6, k))).tocsr()
    x_true = rng.standard_normal(k)
    mesh, A_sh = _rows(pkg, S, A)
    x, res, iters = pkg.sharded_cgls(mesh, A_sh, A @ x_true, tol=1e-12,
                                     maxiter=500)
    assert np.linalg.norm(x - x_true) / np.linalg.norm(x_true) < 1e-8
    assert iters <= 300
    return {"x": x, "iters": iters}


# ---------------------------------------------------------------------------
# TestHaloSpMV
# ---------------------------------------------------------------------------


def _banded(n, bw):
    rng = np.random.default_rng(7)
    diags = [rng.random(n - abs(o)) for o in range(-bw, bw + 1)]
    return sps.diags(diags, range(-bw, bw + 1), format="csr").tocsr()


@case
def halo_matches_dense_oracle(pkg, S):
    n = 64 * S
    A, x = _banded(n, 3), np.random.default_rng(8).random(n)
    mesh, A_sh = _rows(pkg, S, A)
    y = pkg.sharded_spmv_halo(mesh, A_sh, x, halo=1)
    npt.assert_allclose(y, A @ x, atol=1e-12)
    return {"y": y}


@case
def halo_wider(pkg, S):
    n = 16 * S
    A, x = _banded(n, 20), np.random.default_rng(9).random(n)
    mesh, A_sh = _rows(pkg, S, A)
    y = pkg.sharded_spmv_halo(mesh, A_sh, x, halo=2)
    npt.assert_allclose(y, A @ x, atol=1e-12)
    return {"y": y}


@case
def halo_bandwidth_violation_raises(pkg, S):
    n = 32 * S
    A = sps.random(n, n, density=0.2, format="csr", dtype=np.float64,
                   random_state=10)
    mesh, A_sh = _rows(pkg, S, A)
    x = np.random.default_rng(11).random(n)
    return {"raised": raised(
        lambda: pkg.sharded_spmv_halo(mesh, A_sh, x, halo=1))}


# ---------------------------------------------------------------------------
# TestShardingGuards
# ---------------------------------------------------------------------------


@case
def mismatched_n_shards_raises(pkg, S):
    mesh = pkg.mesh((S, 1))
    return {"raised": raised(lambda: pkg.shard_csr_rows(
        MATRIX_1.tocsr()[:, :50], S * 2, mesh))}


@case
def mismatched_op_mesh_raises(pkg, S):
    A_sh = _rows(pkg, S, MATRIX_1.tocsr()[:, :50])[1]
    half = pkg.mesh((S // 2, 1))
    return {"raised": raised(lambda: pkg.sharded_gram(half, A_sh))}


@case
def cols_accepts_device_container(pkg, S):
    A = MATRIX_1.tocsr()[:, :50]
    mesh = pkg.mesh((1, S))
    A_sh = pkg.shard_csr_cols(pkg.to_device(A), S, mesh)
    b = np.random.default_rng(5).random((50, 3))
    got = np.asarray(pkg.sharded_spmm_2d(mesh, A_sh, b))
    npt.assert_allclose(got, A.toarray() @ b, atol=1e-10)
    return {"C": got}


@case
def complex_sharded_solvers_raise_cleanly(pkg, S):
    A = MATRIX_1.tocsr()[:, :50]
    Ac = (A[:50, :50] + 1j * A[:50, :50]).tocsr()
    mesh, A_sh = _rows(pkg, S, Ac)
    b = np.ones(50)
    return {"cg": raised(lambda: pkg.sharded_cg(mesh, A_sh, b)),
            "cgls": raised(lambda: pkg.sharded_cgls(mesh, A_sh, b)),
            "gram": raised(lambda: pkg.sharded_gram(mesh, A_sh))}


# ---------------------------------------------------------------------------
# Beyond tests/test_parallel.py: uneven shapes, empty shards, the QR route
# ---------------------------------------------------------------------------


def _every_op(pkg, S, m, k, seed):
    """Each sharded op and both routes on an m x k matrix (CG on an m x m
    SPD one, the halo SpMV on an m x m tridiagonal one), checked against
    scipy."""
    rng = np.random.default_rng(seed)
    A = (sps.random(m, k, density=0.6, format="csr", random_state=seed)
         + sps.eye(m, k)).tocsr()
    B = rng.standard_normal((k, 3))
    v = rng.standard_normal(m)
    Bs = sps.random(k, 5, density=0.5, format="csr", random_state=seed + 1)
    spd = (A @ A.T + m * sps.eye(m)).tocsr()
    band = _banded(m, 1)
    mesh, A_rows = _rows(pkg, S, A)
    cmesh = pkg.mesh((1, S))
    A_grid = pkg.shard_csr_grid(A, S, mesh)
    out = {
        "spmm": np.asarray(pkg.sharded_spmm(mesh, A_rows, B)),
        "spmv": np.asarray(pkg.sharded_spmv(mesh, A_rows, B[:, 0])),
        "spmm_2d": np.asarray(pkg.sharded_spmm_2d(
            cmesh, pkg.shard_csr_cols(A, S, cmesh), B)),
        "ring": np.asarray(pkg.sharded_spmm_ring(mesh, A_grid, B)),
        "spgemm": pkg.sharded_spgemm(mesh, A_grid,
                                     pkg.shard_csr_krows(Bs, S, mesh)),
        "gram": np.asarray(pkg.sharded_gram(mesh, A_rows)),
        "halo": pkg.sharded_spmv_halo(
            mesh, pkg.shard_csr_rows(band, S, mesh), v, halo=1),
        "dot": pkg.dot_product(A_rows, B),
        "qr": pkg.sparse_qr_solve(A_rows, v),
    }
    out["cg_x"], _, out["cg_iters"] = pkg.sharded_cg(
        mesh, pkg.shard_csr_rows(spd, S, mesh), v, tol=1e-12)
    out["cgls_x"], _, out["cgls_iters"] = pkg.sharded_cgls(mesh, A_rows, v)
    dense = A.toarray()
    for key, ref in (("spmm", dense @ B), ("spmv", dense @ B[:, 0]),
                     ("spmm_2d", dense @ B), ("ring", dense @ B),
                     ("gram", dense.T @ dense), ("dot", dense @ B),
                     ("halo", band @ v)):
        np_almost_equal(out[key], ref)
    np_almost_equal(out["spgemm"].toarray(), (A @ Bs).toarray())
    np_almost_equal(out["cg_x"], np.linalg.solve(spd.toarray(), v))
    return out


@case
def uneven_shapes(pkg, S):
    """m = 2S + 1 rows and k = 3S - 1 columns, neither divisible by S;
    at S = 4 the last row shard is empty."""
    return _every_op(pkg, S, 2 * S + 1, 3 * S - 1, seed=21)


@case
def empty_shards(pkg, S):
    """One row over S shards: every shard but the first is empty."""
    return _every_op(pkg, S, 1, 2 * S + 1, seed=22)


@case
def qr_route(pkg, S):
    """``sparse_qr_solve`` on a ShardedCSR: one CGLS per column of B, the
    output dtypes and the guards."""
    A = MATRIX_1.tocsr()[:, :50]
    b = np.arange(A.shape[0], dtype=np.float64)
    B = np.random.default_rng(3).random((A.shape[0], 3))
    mesh, A_sh = _rows(pkg, S, A)
    A32 = pkg.shard_csr_rows(A.astype(np.float32), S, mesh)
    Ac = pkg.shard_csr_rows((A + 1j * A).tocsr(), S, mesh)
    A_nomesh = pkg.shard_csr_rows(A, S, mesh=None)
    x = pkg.sparse_qr_solve(A_sh, b)
    X = pkg.sparse_qr_solve(A_sh, B)
    X32 = pkg.sparse_qr_solve(A32, B)
    assert X32.dtype == np.float32 and X.dtype == x.dtype == np.float64
    npt.assert_array_almost_equal(
        x, np.linalg.lstsq(A.toarray(), b, rcond=None)[0])
    return {"x": x, "X": X, "X32": X32,
            "no_mesh": raised(lambda: pkg.sparse_qr_solve(A_nomesh, b)),
            "shape": raised(lambda: pkg.sparse_qr_solve(A_sh, b[:-1])),
            "complex": raised(lambda: pkg.sparse_qr_solve(Ac, b))}


@case
def exact_convergence(pkg, S):
    """Systems solved exactly in one step, then stepped on frozen until the
    done flag is read: a diagonal of powers of two (A diag(d) = I, so
    CGLS's residual and gradient are exactly 0 after a step) through
    ``sharded_cgls`` and ``sparse_qr_solve``, and the identity through
    ``sharded_cg``."""
    n = 32
    A = sps.diags(2.0 ** np.arange(-4, n - 4)).tocsr()
    b = np.random.default_rng(14).random(n)
    B = np.random.default_rng(15).random((n, 2))
    mesh, A_sh = _rows(pkg, S, A)
    x, res, iters = pkg.sharded_cgls(mesh, A_sh, b, tol=1e-12)
    X = pkg.sparse_qr_solve(A_sh, B)
    eye = pkg.shard_csr_rows(sps.identity(n, format="csr"), S, mesh)
    cg_x, cg_res, cg_iters = pkg.sharded_cg(mesh, eye, b, tol=1e-12)
    npt.assert_array_equal(x, b / A.diagonal())
    npt.assert_array_equal(X, B / A.diagonal()[:, None])
    npt.assert_array_equal(cg_x, b)
    assert iters == cg_iters == 1 and res == cg_res == 0.0
    return {"x": x, "res": res, "iters": iters, "X": X, "cg_x": cg_x,
            "cg_iters": cg_iters}


# ---------------------------------------------------------------------------
# The port's package namespace and the gloo cluster
# ---------------------------------------------------------------------------


def port_namespace():
    """The port's names under the ones the cases call."""
    import sparse_dot_tpu_torch as sdt
    from sparse_dot_tpu_torch import parallel

    info = parallel.device_mesh_info()

    def mesh(shape):
        return parallel.make_mesh(shape, devices=range(int(np.prod(shape))))

    return SimpleNamespace(
        **{name: getattr(parallel, name) for name in parallel.__all__},
        from_padded_coo=parallel.ops.from_padded_coo,
        dot_product=sdt.dot_product, sparse_qr_solve=sdt.sparse_qr_solve,
        to_device=sdt.to_device, mesh=mesh, n_devices=info["devices"])


def serve(rank, world, store, tasks, results):
    """A rank of the cluster: join the gloo group on the file ``store``,
    then run each case named on ``tasks`` (None ends) and put
    ``(rank, ("ok", result) or ("error", traceback))`` on ``results``."""
    import torch

    torch.set_num_threads(1)
    from sparse_dot_tpu_torch import parallel
    from sparse_dot_tpu_torch.config import config

    config.device = "cpu"
    parallel.initialize(f"file://{store}", world, rank,
                        timeout=timedelta(seconds=120))
    pkg = port_namespace()
    while True:
        task = tasks.get()
        if task is None:
            break
        name, kwargs = task
        try:
            fn = CASES[name] if name in CASES else PORT_ONLY[name]
            result = ("ok", fn(pkg, world, **kwargs))
            if "jax" in sys.modules:
                raise AssertionError("a rank imported jax")
        except Exception:  # reported to the parent, which fails the test
            result = ("error", traceback.format_exc())
        results.put((rank, result))
    parallel.shutdown()


class Cluster:
    """``world`` spawned ranks in a gloo group on a file store under
    ``directory``, kept for many cases: ``run(name, **kwargs)`` runs a
    case on every rank and returns the ranks' results in rank order
    (``submit`` and ``collect`` split it, so the caller can work
    meanwhile)."""

    def __init__(self, world, directory, timeout=120):
        ctx = multiprocessing.get_context("spawn")
        self.world, self.timeout = world, timeout
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(world)]
        store = os.path.join(str(directory), "store")
        self.procs = [ctx.Process(target=serve, daemon=True, args=(
            r, world, store, self.tasks[r], self.results))
            for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, name, **kwargs):
        self.submit(name, **kwargs)
        return self.collect(name)

    def submit(self, name, **kwargs):
        """Start case ``name`` on every rank; ``collect`` waits for it."""
        for q in self.tasks:
            q.put((name, kwargs))

    def collect(self, name):
        got = {}
        try:
            while len(got) < self.world:
                rank, result = self.results.get(timeout=self.timeout)
                got[rank] = result
        except queue.Empty:
            self.close()
            raise AssertionError(f"case {name}: ranks {sorted(got)} of "
                                 f"{self.world} answered in time")
        errors = [res[1] for res in got.values() if res[0] == "error"]
        if errors:
            raise AssertionError(f"case {name} failed on a rank:\n"
                                 + errors[0])
        return [got[r][1] for r in range(self.world)]

    def close(self):
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)


# ---------------------------------------------------------------------------
# Port-only cases
# ---------------------------------------------------------------------------


def ring_schedule(pkg, S):
    """The ring's collective calls in order: at each step the rotation of
    b's shard is issued before that step's K2 call, and the last step
    rotates nothing."""
    from sparse_dot_tpu_torch.ops import csr
    from sparse_dot_tpu_torch.parallel import comm

    events = []
    real_rotate, real_spmm = comm.start_rotate, csr.csr_spmm

    def rotate(*args, **kwargs):
        events.append("rotate")
        return real_rotate(*args, **kwargs)

    def spmm(*args, **kwargs):
        events.append("K2")
        return real_spmm(*args, **kwargs)

    comm.start_rotate, csr.csr_spmm = rotate, spmm
    try:
        mesh = pkg.mesh((S, 1))
        A, b = MATRIX_1.tocsr(), _b(10, 24)
        C = pkg.sharded_spmm_ring(mesh, pkg.shard_csr_grid(A, S, mesh), b)
    finally:
        comm.start_rotate, csr.csr_spmm = real_rotate, real_spmm
    np_almost_equal(np.asarray(C), A.toarray() @ b)
    return events


def unsharded_sparse_b(pkg, S):
    mesh, A_rows = _rows(pkg, S, MATRIX_1.tocsr())
    return raised(lambda: pkg.dot_product(A_rows, MATRIX_1.T.tocsr()))


def carried(pkg, S, layout, arrays, meta, b):
    """A JAX ShardedCSR's arrays carried across (``from_padded_coo``) and
    multiplied by b: by the ring for "grid", by the contraction partition
    for "cols", else by the row partition (B @ itself transposed is no
    product here; "krows" runs as A)."""
    shape = (1, S) if layout == "cols" else (S, 1)
    mesh = pkg.mesh(shape)
    axis = "cols" if layout == "cols" else "rows"
    A = pkg.from_padded_coo(*arrays, **meta, layout=layout, mesh=mesh,
                            axis=axis)
    op = {"grid": pkg.sharded_spmm_ring, "cols": pkg.sharded_spmm_2d}.get(
        layout, pkg.sharded_spmm)
    return np.asarray(op(mesh, A, b, axis=axis))


def carried_spgemm(pkg, S, a_arrays, a_meta, b_arrays, b_meta):
    mesh = pkg.mesh((S, 1))
    A = pkg.from_padded_coo(*a_arrays, **a_meta, layout="grid", mesh=mesh)
    B = pkg.from_padded_coo(*b_arrays, **b_meta, layout="krows", mesh=mesh)
    return pkg.sharded_spgemm(mesh, A, B)


def jax_free(pkg, S):
    """The modules the rank holds of either package."""
    return sorted(name for name in sys.modules
                  if name == "jax" or name.startswith(("jax.",
                                                       "sparse_dot_tpu.")))


def placement(pkg, S):
    """``put_sharded`` sharded and replicated, and ``gather_to_host`` of
    real and complex arrays (``tests/test_torch_multihost.py``)."""
    from sparse_dot_tpu_torch.parallel import multihost

    mesh = pkg.mesh((S, 1))
    x = np.arange(S * 4 * 3, dtype=np.float64).reshape(S * 4, 3)
    xc = np.random.default_rng(0).random((S * 2, 5)) * (1 + 2j)
    sharded = multihost.put_sharded(x, mesh, "rows")
    return {
        "x": x,
        "local": sharded.to_local().numpy(),
        "replicated": multihost.put_sharded(x, mesh, ()).to_local().numpy(),
        "placements": ["shard 0" if p.is_shard(0) else
                       "replicate" if p.is_replicate() else str(p)
                       for p in sharded.placements],
        "gathered": multihost.gather_to_host(sharded),
        "gathered_ref": x,
        "gathered_complex": multihost.gather_to_host(
            multihost.put_sharded(xc, mesh, "rows")),
        "gathered_complex_ref": xc,
        "uneven": raised(lambda: multihost.put_sharded(x[:-1], mesh,
                                                       "rows")),
    }


def constructor_placement(pkg, S):
    from sparse_dot_tpu_torch.parallel import multihost

    mesh = pkg.mesh((S, 1))
    a = sps.random(64, 48, density=0.2, format="csr", dtype=np.float64,
                   random_state=0)
    A = pkg.shard_csr_rows(a, S, mesh)
    rows = 64 // S
    b = np.random.default_rng(2).random((48, 4))
    return {"index": A.index, "block": A.blocks[0].to_scipy().toarray(),
            "expected_block": a[A.index * rows:(A.index + 1) * rows]
            .toarray(),
            "c": multihost.gather_to_host(pkg.sharded_spmm(mesh, A, b)),
            "ref": a.toarray() @ b}


def two_process(pkg, S):
    from sparse_dot_tpu_torch.parallel import multihost

    info = multihost.process_info()
    mesh = pkg.mesh((S, 1))
    a = sps.random(64, 48, density=0.25, format="csr", dtype=np.float64,
                   random_state=0)
    A = pkg.shard_csr_rows(a, S, mesh)
    b = np.random.default_rng(1).random((48, 4))
    out = {"process_count": info["process_count"],
           "c": multihost.gather_to_host(pkg.sharded_spmm(mesh, A, b)),
           "c_ref": a.toarray() @ b,
           "gram": multihost.gather_to_host(pkg.sharded_gram(mesh, A)),
           "gram_ref": a.toarray().T @ a.toarray()}
    multihost.sync_global_devices("done")
    return out


PORT_ONLY = {fn.__name__: fn for fn in (
    ring_schedule, unsharded_sparse_b, carried, carried_spgemm, jax_free,
    placement, constructor_placement, two_process)}
