"""The reference-style suites, run on the port.

``tests/test_sparse_dense.py``, ``tests/test_sparse_vector.py`` and
``tests/test_dense_dense.py`` hold the reference's ``dot_product_mkl``
cases for the JAX package: CSR/CSC/BSR, C and F order, ``out`` and
``out_scalar``, casts, float32 and complex.  Here each of their test
classes runs again with the module's ``dot_product_mkl`` patched to
``sparse_dot_tpu_torch.dot_product_mkl`` for the length of each test.
The ``*Planar`` classes are left out: planar complex storage is the JAX
package's TPU layout, which the port does not have.

The modules are imported, not their classes, so pytest does not collect
the originals a second time here.
"""

import unittest
from unittest import mock

import sparse_dot_tpu_torch

from . import test_dense_dense, test_sparse_dense, test_sparse_vector


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
}

for _module, _names in _SUITES.items():
    for _name in _names:
        _cls = on_port(_module, _name)
        globals()[_cls.__name__] = _cls
del _module, _names, _name, _cls


def test_port_classes_call_the_port():
    """A port class's test goes through the port's dot_product_mkl."""
    calls = []
    real = sparse_dot_tpu_torch.dot_product_mkl

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    with mock.patch.object(sparse_dot_tpu_torch, "dot_product_mkl",
                           counted):
        result = unittest.TestResult()
        TestPortSparseDenseBSR(  # noqa: F821  (made by on_port above)
            "test_sparse_dense_out").run(result)
    assert result.wasSuccessful() and calls
