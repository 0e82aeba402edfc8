"""Complex products that meet inf, through the port's plain versions.

A complex product such as (2+0j)(inf+0j) is inf+nanj.  scipy keeps it
through its sums; the port's plain versions must too: ``index_add_`` on a
complex tensor multiplies its source by alpha = 1+0j, and
(1+0j)(inf+nanj) has a nan real part, so they add on the real view.  The
input is 2 x 2: A = [[2, 0], [0, 1]] (complex), B = [[inf, 1], [1, 1]].
Each route of ``dot_product`` is held against scipy, real and imaginary
parts compared as arrays (nan equal to nan), and, where the JAX package
agrees with scipy (CSR SpMM and dense x CSR), against it too.
"""

import numpy as np
import numpy.testing as npt
import pytest
import scipy.sparse as sps

import sparse_dot_tpu as sdt
import sparse_dot_tpu_torch as sdtt
from sparse_dot_tpu_torch.config import config


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless asked otherwise; these tests ask
    for the CPU, where its wrappers take their plain versions."""
    saved = config.device
    config.device = "cpu"
    yield
    config.device = saved


DTYPES = [np.complex64, np.complex128]


def operands(dtype):
    a = sps.csr_matrix(np.array([[2, 0], [0, 1]], dtype=dtype))
    b = np.array([[np.inf, 1], [1, 1]], dtype=dtype)
    return a, b


def assert_same_parts(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    npt.assert_array_equal(got.real, want.real)
    npt.assert_array_equal(got.imag, want.imag)


def routes(dtype):
    """(name, call, scipy's result) of every dense-output route."""
    a, b = operands(dtype)
    x = b[:, 0].copy()
    return {
        "csr_spmm": (lambda m: m.dot_product(a, b), a @ b),
        "csc_spmm": (lambda m: m.dot_product(a.tocsc(), b), a @ b),
        "dense_x_csr": (lambda m: m.dot_product(b, a), b @ a),
        "csr_x_vector": (lambda m: m.dot_product(a, x), a @ x),
        "vector_x_csr": (lambda m: m.dot_product(x, a), x @ a),
    }


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", ["csr_spmm", "csc_spmm", "dense_x_csr",
                                   "csr_x_vector", "vector_x_csr"])
def test_inf_times_complex_matches_scipy(route, dtype):
    call, want = routes(dtype)[route]
    got = call(sdtt)
    assert np.isposinf(got.real.flat[0]) and np.isnan(got.imag.flat[0])
    assert_same_parts(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("route", ["csr_spmm", "dense_x_csr"])
def test_inf_times_complex_matches_jax(route, dtype):
    call, _ = routes(dtype)[route]
    assert_same_parts(call(sdtt), call(sdt))


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
def test_sparse_times_sparse_keeps_inf_plus_nanj(dense):
    a, b = operands(np.complex128)
    got = sdtt.dot_product(a, sps.csr_matrix(b), dense=dense)
    want = (a @ sps.csr_matrix(b)).toarray()
    assert_same_parts(got if dense else got.toarray(), want)
