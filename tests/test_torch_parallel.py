"""The port's sharded layer (``sparse_dot_tpu_torch.parallel``) against the
JAX package's, at 2 and 4 ranks.

Every case of ``tests/test_parallel.py`` (``tests/parallel_cases.py``)
runs twice on the same seeded inputs: in this process on the JAX package
over a mesh of S of its CPU devices, and in a cluster of S spawned ranks of
a gloo group (one per module and size) on the port.  Results agree at rtol
1e-12 for float64 and complex128 and 1e-5 for float32 and complex64 (atol
the same multiple of the largest magnitude), sparse patterns exactly
(explicit zeros included), the iterative solvers' solutions at rtol 1e-9
(``SOLUTIONS``), CG and CGLS iteration counts within one, and exceptions
by type and message.  ``test_pytree_roundtrip_preserves_
routing_state`` has no counterpart: a ShardedCSR is no JAX pytree.  The
JAX package's compiled-schedule check of the ring becomes a record of the
collective calls (``ring_schedule``).
"""

import inspect
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.sparse as sps

import jax

import sparse_dot_tpu
from sparse_dot_tpu import formats as jax_formats
from sparse_dot_tpu import parallel as jax_parallel
from sparse_dot_tpu_torch import parallel as port_parallel

from . import parallel_cases as cases

RTOL = {np.dtype(np.float64): 1e-12, np.dtype(np.complex128): 1e-12,
        np.dtype(np.float32): 1e-5, np.dtype(np.complex64): 1e-5}
# The solutions of the iterative solvers (CG, CGLS and the QR route's
# CGLS) carry the round-off of their sums times the system's condition
# number (1e6 in ``sharded_ill_conditioned``): they agree at the rtol of
# the port's solver tests (tests/test_torch_solvers.py).
SOLUTIONS = {"x", "X", "X32", "qr", "cg_x", "cgls_x"}
SOLUTION_RTOL = 1e-9


def jax_namespace(S):
    """The JAX package's names under the ones the cases call, on meshes
    of its first devices."""
    def mesh(shape):
        return jax_parallel.make_mesh(
            shape, devices=jax.devices()[: int(np.prod(shape))])

    return SimpleNamespace(
        **{name: getattr(jax_parallel, name)
           for name in jax_parallel.__all__},
        dot_product=sparse_dot_tpu.dot_product,
        sparse_qr_solve=sparse_dot_tpu.sparse_qr_solve,
        to_device=jax_formats.to_device, mesh=mesh, n_devices=S)


@pytest.fixture(scope="module", params=(2, 4), ids=lambda s: f"{s}ranks")
def cluster(request, tmp_path_factory):
    ranks = cases.Cluster(request.param,
                          tmp_path_factory.mktemp(f"gloo{request.param}"))
    yield ranks
    ranks.close()


def compare(port, ref, key="result"):
    """``port`` against ``ref`` (the JAX package's) by the rules above."""
    if isinstance(ref, dict):
        assert port.keys() == ref.keys(), key
        for name in ref:
            compare(port[name], ref[name], name)
    elif sps.issparse(ref):
        assert port.dtype == ref.dtype and port.shape == ref.shape, key
        np.testing.assert_array_equal(port.indptr, ref.indptr, err_msg=key)
        np.testing.assert_array_equal(port.indices, ref.indices,
                                      err_msg=key)
        compare(port.data, ref.data, key)
    elif isinstance(ref, np.ndarray):
        assert port.dtype == ref.dtype and port.shape == ref.shape, key
        rtol = max(RTOL[ref.dtype], SOLUTION_RTOL if key in SOLUTIONS
                   else 0.0)
        scale = float(np.abs(ref).max(initial=0.0))
        np.testing.assert_allclose(port, ref, rtol=rtol, atol=rtol * scale,
                                   err_msg=key)
    elif key.endswith("iters"):
        assert abs(int(port) - int(ref)) <= 1, (key, port, ref)
    elif isinstance(ref, float):
        np.testing.assert_allclose(port, ref, rtol=1e-12, err_msg=key)
    else:
        assert port == ref, (key, port, ref)


@pytest.mark.parametrize("name", list(cases.CASES))
def test_port_matches_jax(cluster, name):
    S = cluster.world
    cluster.submit(name)
    ref = cases.CASES[name](jax_namespace(S), S)
    for port in cluster.collect(name):
        compare(port, ref)


def test_ring_schedule(cluster):
    """Each step's rotation of b's shard is issued before that step's K2;
    S - 1 rotations for S steps."""
    S = cluster.world
    for events in cluster.run("ring_schedule"):
        assert events == ["rotate", "K2"] * (S - 1) + ["K2"]


def test_unsharded_sparse_b_raises(cluster):
    """A sharded A times an unsharded scipy B names the operand (the JAX
    package reports a dtype mismatch)."""
    for err in cluster.run("unsharded_sparse_b"):
        assert err[0] == "ValueError"
        assert "unsharded sparse csr_matrix" in err[1]


def _jax_arrays(A):
    return ([np.asarray(a) for a in (A.rows, A.cols, A.vals)],
            {"shape": A.shape, "m_local": A.m_local,
             "n_shards": A.n_shards, "k_local": getattr(A, "k_local", None)})


@pytest.mark.parametrize("layout,dtype", [
    ("rows", np.float64), ("rows", np.complex128), ("krows", np.float32),
    ("cols", np.float64), ("grid", np.float64), ("grid", np.complex128)])
def test_carried_shards(cluster, layout, dtype):
    """A JAX ShardedCSR's own arrays (planar complex included) carried to
    the port (``from_padded_coo``) give the JAX package's products."""
    S = cluster.world
    A = cases.MATRIX_1.tocsr()[:197, :299].astype(dtype)
    if np.dtype(dtype).kind == "c":
        A = (A + 0.25j * A[:, ::-1]).astype(dtype)
    b = np.random.default_rng(12).random((299, 7)).astype(A.real.dtype)
    jax_ns = jax_namespace(S)
    mesh = jax_ns.mesh((1, S) if layout == "cols" else (S, 1))
    axis = "cols" if layout == "cols" else "rows"
    build = {"rows": jax_parallel.shard_csr_rows,
             "krows": jax_parallel.shard_csr_krows,
             "cols": jax_parallel.shard_csr_cols,
             "grid": jax_parallel.shard_csr_grid}[layout]
    A_jax = build(A, S, mesh, axis=axis)
    op = {"grid": jax_parallel.sharded_spmm_ring,
          "cols": jax_parallel.sharded_spmm_2d}.get(
        layout, jax_parallel.sharded_spmm)
    ref = np.asarray(op(mesh, A_jax, b, axis=axis))
    arrays, meta = _jax_arrays(A_jax)
    for got in cluster.run("carried", layout=layout, arrays=arrays,
                           meta=meta, b=b):
        compare(got, ref)


def test_carried_spgemm(cluster):
    S = cluster.world
    A = cases.MATRIX_1.tocsr()
    B = sps.random(A.shape[1], 50, density=0.05, format="csr",
                   random_state=13)
    mesh = jax_namespace(S).mesh((S, 1))
    A_jax = jax_parallel.shard_csr_grid(A, S, mesh)
    B_jax = jax_parallel.shard_csr_krows(B, S, mesh)
    ref = jax_parallel.sharded_spgemm(mesh, A_jax, B_jax)
    a_arrays, a_meta = _jax_arrays(A_jax)
    b_arrays, b_meta = _jax_arrays(B_jax)
    for got in cluster.run("carried_spgemm", a_arrays=a_arrays,
                           a_meta=a_meta, b_arrays=b_arrays, b_meta=b_meta):
        compare(got, ref)


def test_ranks_hold_no_jax(cluster):
    """The ranks imported neither JAX nor the JAX package."""
    assert cluster.run("jax_free") == [[]] * cluster.world


def test_same_public_names_and_signatures():
    """The 23 names of the JAX package's ``parallel`` with its parameters
    (the ring's ``_inspect`` HLO hook is JAX's alone)."""
    assert port_parallel.__all__ == jax_parallel.__all__
    for name in jax_parallel.__all__:
        ours = getattr(port_parallel, name)
        theirs = getattr(jax_parallel, name)
        if name == "ShardedCSR" or not callable(theirs):
            continue
        params = [p for p in inspect.signature(theirs).parameters.values()
                  if p.name != "_inspect"]
        assert list(inspect.signature(ours).parameters.values()) == params, \
            name
