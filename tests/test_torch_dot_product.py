"""The port's ``dot_product`` against the JAX package's, case by case.

The same scipy/numpy inputs, made from a seed, go through
``sparse_dot_tpu.dot_product`` (JAX on the CPU) and
``sparse_dot_tpu_torch.dot_product`` (torch on the CPU, where every
kernel wrapper takes its plain version).  The two must give the same
result type, dtype, shape and memory order, return the caller's ``out``
when one is given, raise the same errors, and agree in value within
rtol = atol = 1e-12 (float64/complex128) or 1e-5 (float32/complex64):
the two sum in different orders.
"""

import os
import subprocess
import sys

import numpy as np
import numpy.testing as npt
import pytest
import scipy.sparse as sps
import torch

import sparse_dot_tpu as sdt
import sparse_dot_tpu_torch as sdtt
from sparse_dot_tpu_torch import formats
from sparse_dot_tpu_torch.config import config
from sparse_dot_tpu_torch.ops import bsr, csr


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless asked otherwise; these tests ask
    for the CPU, where its wrappers take their plain versions."""
    saved = config.device
    config.device = "cpu"
    yield
    config.device = saved


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = [np.float32, np.float64, np.complex64, np.complex128]
FORMATS = ["csr", "csc", "bsr"]
TOL = {
    np.dtype(np.float32): 1e-5,
    np.dtype(np.complex64): 1e-5,
    np.dtype(np.float64): 1e-12,
    np.dtype(np.complex128): 1e-12,
}
M, K, N = 40, 30, 7
BS = 5  # divides M and K


def sparse(fmt, dtype, shape=(M, K), density=0.2, seed=3):
    a = sps.random(*shape, density=density, format="csr", random_state=seed)
    if np.dtype(dtype).kind == "c":
        a = a + 1j * sps.random(*shape, density=density, format="csr",
                                random_state=seed + 1)
    a = a.astype(dtype).tocsr()
    return a.tobsr(blocksize=(BS, BS)) if fmt == "bsr" else a.asformat(fmt)


def dense(shape, dtype, order="C", seed=5):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        v = v + 1j * rng.standard_normal(shape)
    return np.asarray(v.astype(dtype), order=order)


def assert_same(port, ref):
    """Same type, dtype, shape, memory order; values within TOL."""
    assert type(port) is type(ref)
    ref_arr, port_arr = np.asarray(ref), np.asarray(port)
    assert port_arr.dtype == ref_arr.dtype
    assert port_arr.shape == ref_arr.shape
    if isinstance(ref, np.ndarray):
        assert port.flags.c_contiguous == ref.flags.c_contiguous
        assert port.flags.f_contiguous == ref.flags.f_contiguous
    tol = TOL.get(port_arr.dtype, 1e-12)
    npt.assert_allclose(port_arr, ref_arr, rtol=tol, atol=tol)


def both(a, b, **kwargs):
    """(port result, JAX result) of dot_product(a, b, **kwargs)."""
    return sdtt.dot_product(a, b, **kwargs), sdt.dot_product(a, b, **kwargs)


def both_out(a, b, out, **kwargs):
    """Like ``both`` with a copy of ``out`` each; checks ``r is out``."""
    out_p, out_r = out.copy(order="K"), out.copy(order="K")
    port = sdtt.dot_product(a, b, out=out_p, **kwargs)
    ref = sdt.dot_product(a, b, out=out_r, **kwargs)
    assert port is out_p and ref is out_r
    return port, ref


# ---------------------------------------------------------------------------
# SpMM: sparse x dense and dense x sparse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("order", ["C", "F"])
def test_sparse_times_dense(fmt, dtype, order):
    assert_same(*both(sparse(fmt, dtype), dense((K, N), dtype, order)))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("order", ["C", "F"])
def test_dense_times_sparse(fmt, dtype, order):
    assert_same(*both(dense((N, M), dtype, order), sparse(fmt, dtype)))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dtype", [np.float32, np.complex128])
@pytest.mark.parametrize("order", ["C", "F"])
@pytest.mark.parametrize("side", ["sparse_dense", "dense_sparse"])
def test_spmm_out_accumulates(fmt, dtype, order, side):
    if side == "sparse_dense":
        a, b = sparse(fmt, dtype), dense((K, N), dtype, order)
        out = dense((M, N), dtype, order, seed=9)
    else:
        a, b = dense((N, M), dtype, order), sparse(fmt, dtype)
        out = dense((N, K), dtype, order, seed=9)
    assert_same(*both_out(a, b, out, out_scalar=2.0))


@pytest.mark.parametrize("fmt", FORMATS)
def test_spmm_out_without_scalar(fmt):
    out = dense((M, N), np.float64, seed=9)
    assert_same(*both_out(sparse(fmt, np.float64),
                          dense((K, N), np.float64), out))


@pytest.mark.parametrize("fmt", FORMATS)
def test_spmm_out_mismatch_same_error(fmt):
    a, b = sparse(fmt, np.float64), dense((K, N), np.float64)
    bad = np.zeros((M, N), dtype=np.float64, order="F")
    with pytest.raises(ValueError) as port:
        sdtt.dot_product(a, b, out=bad)
    with pytest.raises(ValueError) as ref:
        sdt.dot_product(a, b, out=bad)
    assert str(port.value) == str(ref.value)


# ---------------------------------------------------------------------------
# SpMV and vector x matrix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("vshape", [(K,), (K, 1)])
def test_sparse_times_vector(fmt, dtype, vshape):
    assert_same(*both(sparse(fmt, dtype), dense(vshape, dtype)))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dtype", [np.float64, np.complex64])
@pytest.mark.parametrize("vshape", [(M,), (1, M)])
def test_vector_times_sparse(fmt, dtype, vshape):
    assert_same(*both(dense(vshape, dtype), sparse(fmt, dtype)))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("vector_first", [False, True])
def test_spmv_out_accumulates(fmt, vector_first):
    if vector_first:
        a, b = dense((M,), np.float64), sparse(fmt, np.float64)
        out = dense((K,), np.float64, seed=9)
    else:
        a, b = sparse(fmt, np.float64), dense((K,), np.float64)
        out = dense((M,), np.float64, seed=9)
    assert_same(*both_out(a, b, out, out_scalar=-0.5))


# ---------------------------------------------------------------------------
# dense x dense and vector . vector
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("order", ["C", "F"])
def test_dense_times_dense(dtype, order):
    assert_same(*both(dense((M, K), dtype, order), dense((K, N), dtype)))


@pytest.mark.parametrize("dtype", [np.float32, np.complex128])
def test_dense_times_dense_out(dtype):
    out = dense((M, N), dtype, seed=9)
    assert_same(*both_out(dense((M, K), dtype), dense((K, N), dtype), out,
                          out_scalar=3.0))


@pytest.mark.parametrize("dtype", [np.float64, np.complex64])
def test_dense_matrix_times_vector(dtype):
    assert_same(*both(dense((M, K), dtype), dense((K,), dtype)))


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_vector_dot_vector(dtype):
    assert_same(*both(dense((K,), dtype), dense((K,), dtype, seed=6)))


# ---------------------------------------------------------------------------
# cast, errors, empty outputs, array classes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("a, b", [
    (lambda: sparse("csr", np.float32), lambda: dense((K, N), np.float64)),
    (lambda: sparse("csc", np.float64), lambda: dense((K, N), np.complex64)),
    (lambda: dense((N, M), np.float32), lambda: sparse("bsr", np.complex128)),
    (lambda: dense((N, M), np.int64), lambda: sparse("csr", np.float64)),
    (lambda: sparse("csr", np.float32), lambda: dense((K,), np.float64)),
    (lambda: dense((M, K), np.float32), lambda: dense((K, N), np.float64)),
])
def test_cast_mixed_dtypes(a, b):
    assert_same(*both(a(), b(), cast=True))


@pytest.mark.parametrize("a, b", [
    (lambda: sparse("csr", np.float32), lambda: dense((K, N), np.float64)),
    (lambda: dense((N, M), np.float64), lambda: sparse("csc", np.complex128)),
    (lambda: sparse("bsr", np.float64), lambda: dense((K,), np.float32)),
    (lambda: dense((M, K), np.complex64), lambda: dense((K, N), np.float32)),
])
def test_cast_false_mismatch_same_error(a, b):
    a, b = a(), b()
    with pytest.raises(ValueError) as port:
        sdtt.dot_product(a, b)
    with pytest.raises(ValueError) as ref:
        sdt.dot_product(a, b)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("a, b", [
    (lambda: sps.csr_matrix((M, K), dtype=np.float32),
     lambda: dense((K, N), np.float32)),
    (lambda: sps.csr_matrix((M, K), dtype=np.float32),
     lambda: dense((K, N), np.float64)),
    (lambda: sparse("csr", np.complex64, shape=(0, K)),
     lambda: dense((K, N), np.complex64)),
    (lambda: sps.csc_matrix((M, K), dtype=np.float64),
     lambda: dense((K,), np.float64)),
    (lambda: dense((M, 0), np.float32), lambda: dense((0, N), np.float32)),
])
def test_empty_output_dtypes(a, b):
    assert_same(*both(a(), b()))


@pytest.mark.parametrize("cls", [sps.csr_array, sps.csc_array, sps.bsr_array])
def test_scipy_array_classes(cls):
    a = sparse("csr", np.float64)
    a = cls(a.tobsr(blocksize=(BS, BS)) if cls is sps.bsr_array else a)
    assert_same(*both(a, dense((K, N), np.float64)))
    assert_same(*both(a, dense((K,), np.float64)))


def test_sparse_times_sparse_not_ported():
    """Sparse x sparse used to raise NotImplementedError here; it is
    ported now and gives the JAX package's CSR (tests/test_torch_spgemm.py
    holds the cases)."""
    a = sparse("csr", np.float64)
    port, ref = both(a, a.T.tocsr())
    assert type(port) is type(ref) and port.dtype == ref.dtype
    npt.assert_array_equal(port.indptr, ref.indptr)
    npt.assert_array_equal(port.indices, ref.indices)
    npt.assert_allclose(port.data, ref.data, rtol=1e-12, atol=1e-12)


def test_non_canonical_csr_summed_on_a_copy():
    a = sps.csr_matrix(
        (np.array([1.0, 2.0, 3.0, 4.0]), np.array([2, 0, 2, 1]),
         np.array([0, 3, 3, 4])), shape=(3, 4),
    )
    assert not a.has_canonical_format
    before = (a.data.copy(), a.indices.copy(), a.indptr.copy())
    assert_same(*both(a, dense((4, 5), np.float64)))
    for arr, old in zip((a.data, a.indices, a.indptr), before):
        npt.assert_array_equal(arr, old)


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
def test_from_arrays_carries_jax_container_across(fmt):
    a = sparse(fmt, np.complex128)
    jax_container = sdt.to_device(a)
    port_container = sdtt.from_arrays(
        fmt, np.asarray(jax_container.data), np.asarray(jax_container.indices),
        np.asarray(jax_container.indptr), jax_container.shape,
        blocksize=getattr(jax_container, "blocksize", None),
    )
    assert isinstance(port_container, type(formats.to_device(a)))
    b = dense((K, N), np.complex128)
    assert_same(sdtt.dot_product(port_container, b),
                sdt.dot_product(jax_container, b))
    npt.assert_array_equal(port_container.to_scipy().toarray(), a.toarray())


def test_from_arrays_rejects_bad_input():
    with pytest.raises(ValueError, match="COO"):
        sdtt.from_arrays("coo", np.ones(1), [0], [0, 1], (1, 1))
    with pytest.raises(ValueError, match="square"):
        sdtt.from_arrays("bsr", np.ones((1, 2, 3)), [0], [0, 1], (2, 3))
    with pytest.raises(ValueError, match="float32, float64"):
        sdtt.from_arrays("csr", np.ones(1, np.int64), [0], [0, 1], (1, 1))


@pytest.mark.parametrize("fmt", FORMATS)
def test_device_container_operand(fmt):
    a = sparse(fmt, np.float64)
    port = sdtt.dot_product(sdtt.to_device(a), dense((K, N), np.float64))
    assert_same(port, sdt.dot_product(a, dense((K, N), np.float64)))
    assert_same(sdtt.dot_product(dense((N, M), np.float64),
                                 sdtt.to_device(a)),
                sdt.dot_product(dense((N, M), np.float64), a))


def test_container_transpose_views():
    a = sdtt.to_device(sparse("csr", np.float64))
    assert isinstance(a.T, sdtt.CSC) and a.T.shape == (K, M)
    assert a.T is a.T and isinstance(a.T.T, sdtt.CSR)
    assert a.T.data is a.data


def test_index_bound_error_carries_ilp64_hint():
    import sparse_dot_tpu.formats as jax_formats

    with pytest.raises(ValueError) as port:
        formats._check_index_bounds(10, (2 ** 31, 5))
    with pytest.raises(ValueError) as ref:
        jax_formats._check_index_bounds(10, (2 ** 31, 5))
    assert str(port.value) == str(ref.value)
    assert "ILP64" in str(port.value)


@pytest.mark.parametrize("fmt", FORMATS)
def test_ilp64_indices(fmt):
    sdtt.set_interface_layer("ILP64")
    try:
        a = sparse(fmt, np.float64)
        container = sdtt.to_device(a)
        assert container.indices.dtype == torch.int64
        assert container.indptr.dtype == torch.int64
        b = dense((K, N), np.float64)
        assert_same(sdtt.dot_product(a, b), sdt.dot_product(a, b))
        v = dense((M,), np.float64)
        assert_same(sdtt.dot_product(v, a), sdt.dot_product(v, a))
    finally:
        sdtt.set_interface_layer("LP64")


# ---------------------------------------------------------------------------
# device policy and imports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("a, b", [
    (lambda: sparse("csr", np.float64), lambda: dense((K, N), np.float64)),
    (lambda: sparse("bsr", np.float64), lambda: dense((K,), np.float64)),
    (lambda: dense((M, K), np.float64), lambda: dense((K, N), np.float64)),
])
def test_cuda_without_card_raises(monkeypatch, a, b):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(config, "device", "cuda")
    launches = (csr.csr_spmm.launches, csr.csr_spmv.launches,
                bsr.bsr_spmm.launches)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sdtt.dot_product(a(), b())
    assert launches == (csr.csr_spmm.launches, csr.csr_spmv.launches,
                        bsr.bsr_spmm.launches)


def _without_card(code):
    """Run ``code`` in a fresh interpreter that sees no CUDA device."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


def test_default_device_is_the_card():
    """Importing needs no card, and the default device is "cuda"."""
    _without_card(
        "import torch, sparse_dot_tpu_torch; "
        "from sparse_dot_tpu_torch.config import config; "
        "assert not torch.cuda.is_available(); "
        "assert config.device == 'cuda', config.device"
    )


def test_default_device_without_card_raises_before_launching():
    """With the default device and no card, ``dot_product`` on scipy
    operands raises and launches nothing: no fallback to the CPU."""
    _without_card(
        "import numpy as np, scipy.sparse as sps, sparse_dot_tpu_torch as s\n"
        "from sparse_dot_tpu_torch.ops import bsr, csr\n"
        "a = sps.random(30, 20, density=0.2, format='csr', random_state=1)\n"
        "try:\n"
        "    s.dot_product(a, np.ones((20, 3)))\n"
        "except RuntimeError as e:\n"
        "    assert 'no CUDA device' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('dot_product ran without a card')\n"
        "assert (csr.csr_spmm.launches, csr.csr_spmv.launches,\n"
        "        bsr.bsr_spmm.launches) == (0, 0, 0)\n"
    )


def test_config_device_validated():
    with pytest.raises(ValueError):
        config.device = "tpu"
    assert config.device == "cpu"


def test_import_leaves_jax_out():
    code = (
        "import sys, sparse_dot_tpu_torch; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'sparse_dot_tpu' or m.startswith('sparse_dot_tpu.')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_service_functions():
    v = sdtt.get_version()
    assert v["platform"] == "cpu" and v["torch_version"] == torch.__version__
    assert "sparse_dot_tpu_torch" in sdtt.mkl_get_version_string()
    assert sdtt.mkl_get_version()[3] == "sparse_dot_tpu_torch"
    before = sdtt.get_max_threads()
    try:
        assert sdtt.mkl_set_num_threads_local(2) == before
        assert sdtt.mkl_get_max_threads() == 2
    finally:
        sdtt.set_num_threads(before)
    with pytest.raises(ValueError):
        sdtt.set_num_threads(0)
    assert sdtt.mkl_set_interface_layer(1) == "ILP64"
    assert sdtt.mkl_interface_integer_dtype() == np.int64
    assert sdtt.mkl_set_interface_layer("LP64") == "LP64"
    assert sdtt.dot_product_mkl is sdtt.dot_product
