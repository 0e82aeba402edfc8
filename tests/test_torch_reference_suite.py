"""The reference-style suites, run on the port.

``tests/test_sparse_dense.py``, ``tests/test_sparse_vector.py``,
``tests/test_dense_dense.py`` and ``tests/test_sparse_sparse.py`` hold the
reference's ``dot_product_mkl`` cases for the JAX package: CSR/CSC/BSR, C
and F order, ``out`` and ``out_scalar``, casts, float32 and complex, and
sparse or dense output of sparse x sparse.  Here each of their test
classes runs again with the module's ``dot_product_mkl`` patched to
``sparse_dot_tpu_torch.dot_product_mkl`` for the length of each test.
The ``*Planar`` classes are left out: planar complex storage is the JAX
package's TPU layout, which the port does not have; so is
``TestBlockedSpGEMM``, which sets the JAX package's routing thresholds.

``tests/test_gram_matrix.py`` runs whole on the port: its tests and
classes run again with ``gram_matrix``, ``sypr`` and ``formats`` of both
the module and the ``sparse_dot_tpu`` package (its tests import them
inside their bodies) patched to the port's for the length of each test.

The modules are imported, not their classes or functions, so pytest does
not collect the originals a second time here.
"""

import contextlib
import functools
import inspect
import unittest
from unittest import mock

import pytest

import sparse_dot_tpu
import sparse_dot_tpu_torch
from sparse_dot_tpu_torch import formats as port_formats
from sparse_dot_tpu_torch.config import config as port_config

from . import (
    test_dense_dense,
    test_gram_matrix,
    test_sparse_dense,
    test_sparse_sparse,
    test_sparse_vector,
)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless asked otherwise; these tests ask
    for the CPU, where its wrappers take their plain versions."""
    saved = port_config.device
    port_config.device = "cpu"
    yield
    port_config.device = saved


def on_port(module, name):
    """Subclass of ``module.<name>`` whose tests call the port."""
    base = getattr(module, name)

    def setUp(self):
        patcher = mock.patch.object(module, "dot_product_mkl",
                                    sparse_dot_tpu_torch.dot_product_mkl)
        patcher.start()
        self.addCleanup(patcher.stop)
        base.setUp(self)

    port_name = name.replace("Test", "TestPort", 1)
    return type(port_name, (base,), {"setUp": setUp,
                                     "__qualname__": port_name,
                                     "__module__": __name__})


_SUITES = {
    test_sparse_dense: (
        "TestSparseDenseCSR", "TestSparseDenseCSR_F", "TestSparseDenseCSC",
        "TestSparseDenseCSC_F", "TestSparseDenseBSR",
        "TestSparseDenseCSRComplex", "TestSparseDenseCSCComplexF",
    ),
    test_sparse_vector: (
        "TestSparseVectorCSR", "TestSparseVectorCSC", "TestSparseVectorBSR",
        "TestSparseVectorCSRComplex",
    ),
    test_dense_dense: (
        "TestDenseDense", "TestDenseDenseFC", "TestDenseDenseCF",
        "TestDenseDenseFF", "TestDenseDenseComplex",
        "TestDenseDenseComplexFC",
    ),
    test_sparse_sparse: (
        "TestMultiplicationCSR", "TestMultiplicationCSC",
        "TestMultiplicationBSR", "TestMultiplicationCSRComplex",
        "TestMultiplicationCSCComplex", "TestMultiplicationCSRArray",
    ),
}

for _module, _names in _SUITES.items():
    for _name in _names:
        _cls = on_port(_module, _name)
        globals()[_cls.__name__] = _cls
del _module, _names, _name, _cls


# ---------------------------------------------------------------------------
# tests/test_gram_matrix.py
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def gram_on_port():
    """``gram_matrix``, ``sypr`` and ``formats`` of test_gram_matrix and of
    the ``sparse_dot_tpu`` package replaced by the port's."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(
            test_gram_matrix, "gram_matrix",
            sparse_dot_tpu_torch.gram_matrix))
        for name, port in (("gram_matrix", sparse_dot_tpu_torch.gram_matrix),
                           ("sypr", sparse_dot_tpu_torch.sypr),
                           ("formats", port_formats)):
            stack.enter_context(mock.patch.object(sparse_dot_tpu, name,
                                                  port))
        yield


def _gram_function(fn):
    """``fn`` (keeping its parameters and marks) run under
    ``gram_on_port``."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with gram_on_port():
            return fn(*args, **kwargs)

    return run


def _gram_class(base):
    """Subclass of the pytest-style class ``base`` run under
    ``gram_on_port``."""
    @pytest.fixture(autouse=True)
    def _port(self):
        with gram_on_port():
            yield

    port_name = base.__name__.replace("Test", "TestPort", 1)
    return type(port_name, (base,), {"_port": _port,
                                     "__qualname__": port_name,
                                     "__module__": __name__})


for _name, _obj in vars(test_gram_matrix).copy().items():
    if _name.startswith("test_") and inspect.isfunction(_obj):
        globals()[_name.replace("test_", "test_port_", 1)] = (
            _gram_function(_obj))
    elif _name.startswith("Test") and inspect.isclass(_obj):
        _cls = _gram_class(_obj)
        globals()[_cls.__name__] = _cls
del _name, _obj, _cls


def test_port_classes_call_the_port():
    """A port class's test goes through the port's dot_product_mkl."""
    calls = []
    real = sparse_dot_tpu_torch.dot_product_mkl

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    with mock.patch.object(sparse_dot_tpu_torch, "dot_product_mkl",
                           counted):
        # A suite runs the class's setUpClass and tearDownClass around the
        # test, as a whole run of the class does.
        result = unittest.TestResult()
        unittest.TestSuite([TestPortSparseDenseBSR(  # noqa: F821  (on_port)
            "test_sparse_dense_out")]).run(result)
    assert result.wasSuccessful() and calls


def test_port_gram_tests_call_the_port():
    """A gram test made here goes through the port's gram_matrix."""
    calls = []
    real = sparse_dot_tpu_torch.gram_matrix

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    with mock.patch.object(sparse_dot_tpu_torch, "gram_matrix", counted):
        with gram_on_port():
            test_gram_matrix.test_empty_device_container_returns_sparse()
    assert calls
