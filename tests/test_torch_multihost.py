"""The port's multi-process layer (``sparse_dot_tpu_torch.parallel.
multihost``), the counterpart of ``tests/test_multihost.py``.

The single-process behaviour (no group: one process, a no-op barrier; a
one-rank group on a file store started and left) runs in this process;
``put_sharded`` / ``gather_to_host`` round trips, the constructors'
placement and a sharded product across processes run in a cluster of two
spawned ranks of a gloo group (``tests/parallel_cases.Cluster``).
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from sparse_dot_tpu_torch import parallel
from sparse_dot_tpu_torch.config import config
from sparse_dot_tpu_torch.parallel import multihost

from . import parallel_cases as cases


@pytest.fixture(autouse=True)
def alone(monkeypatch):
    """On the CPU, outside torchrun's environment, with no group left
    behind."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    saved = config.device
    config.device = "cpu"
    yield
    parallel.shutdown()
    config.device = saved


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    ranks = cases.Cluster(2, tmp_path_factory.mktemp("gloo_pair"))
    yield ranks
    ranks.close()


def test_fields():
    assert multihost.process_info() == {
        "process_index": 0, "process_count": 1, "local_device_count": 1,
        "global_device_count": 1, "platform": "cpu"}
    assert parallel.device_mesh_info() == {
        "devices": 1, "local_devices": 1, "platform": "cpu"}


def test_initialize_noop_without_a_cluster():
    """No coordinator and no torchrun environment: one process, no
    group."""
    info = multihost.initialize()
    assert info["process_count"] == 1
    assert not multihost.is_initialized()


def test_initialize_reads_torchrun_environment(monkeypatch):
    """With no arguments under torchrun, the group starts from its
    environment (``env://``), gloo on the CPU."""
    calls = []
    monkeypatch.setattr(multihost.dist, "init_process_group",
                        lambda *args, **kwargs: calls.append((args, kwargs)))
    monkeypatch.setenv("WORLD_SIZE", "2")
    multihost.initialize()
    assert calls == [(("gloo",), {"init_method": "env://"})]


def test_initialize_refuses_cuda_without_a_card(monkeypatch):
    """NCCL is asked for only where a card is: on "cuda" with none
    visible, initialize raises rather than run elsewhere."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config.device = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize("localhost:1", 2, 0)
    assert not multihost.is_initialized()


def test_sync_noop():
    multihost.sync_global_devices("test")  # must not raise


def test_make_mesh_starts_one_rank_group():
    """A mesh in a process with no group starts a one-rank group (no
    ``initialize``, as a single-process JAX mesh needs none)."""
    mesh = parallel.make_mesh()
    assert multihost.is_initialized()
    assert mesh.mesh_dim_names == ("rows", "cols")
    assert tuple(mesh.mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match=r"Mesh shape \(2, 1\) does not "
                       "match device count 1"):
        parallel.make_mesh((2, 1))


def test_gather_to_host():
    mesh = parallel.make_mesh()
    x = np.random.default_rng(1).random((6, 5))
    np.testing.assert_array_equal(
        multihost.gather_to_host(multihost.put_sharded(x, mesh, "rows")), x)
    np.testing.assert_array_equal(
        multihost.gather_to_host(torch.from_numpy(x)), x)


def test_roundtrip(tmp_path):
    """initialize on a file store, a sharded product, barrier, shutdown:
    a one-process cluster."""
    assert not multihost.is_initialized()
    info = multihost.initialize(f"file://{tmp_path}/store", 1, 0)
    assert multihost.is_initialized() and info["process_count"] == 1
    mesh = parallel.make_mesh((1, 1))
    a = sps.random(32, 24, density=0.3, format="csr", random_state=0)
    b = np.random.default_rng(1).random((24, 2))
    c = multihost.gather_to_host(parallel.sharded_spmm(
        mesh, parallel.shard_csr_rows(a, 1, mesh), b))
    np.testing.assert_allclose(c, a.toarray() @ b, atol=1e-12)
    multihost.sync_global_devices("done")
    multihost.shutdown()
    assert not multihost.is_initialized()


# ---------------------------------------------------------------------------
# Two processes
# ---------------------------------------------------------------------------


def test_put_sharded_blocks(pair):
    """Each rank holds its block of dim 0 (``Shard(0)``) or the whole
    array (replicated), and gathering gives the global array back."""
    for rank, got in enumerate(pair.run("placement")):
        x = got["x"]
        np.testing.assert_array_equal(got["local"], x[rank * 4:(rank + 1)
                                                     * 4])
        np.testing.assert_array_equal(got["replicated"], x)
        assert got["placements"] == ["shard 0", "replicate"]
        for key in ("gathered", "gathered_complex"):
            np.testing.assert_array_equal(got[key], got[key + "_ref"])
        assert got["uneven"][0] == "ValueError"


def test_shard_csr_rows_placement(pair):
    """``shard_csr_rows`` leaves each rank with its own row block, and
    the product over both is right."""
    for rank, got in enumerate(pair.run("constructor_placement")):
        assert got["index"] == rank
        np.testing.assert_array_equal(got["block"], got["expected_block"])
        np.testing.assert_allclose(got["c"], got["ref"], atol=1e-12)


def test_two_process_sharded_ops(pair):
    """Both processes in one group: placement across them, a sharded
    SpMM and the gram (a sum across the processes), gathered on each,
    and a barrier."""
    for got in pair.run("two_process"):
        assert got["process_count"] == 2
        np.testing.assert_allclose(got["c"], got["c_ref"], atol=1e-12)
        np.testing.assert_allclose(got["gram"], got["gram_ref"], atol=1e-10)
