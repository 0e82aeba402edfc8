"""The device-container suite and the randomized oracle sweeps, run on the
port.

Each test below runs a test of ``tests/test_device_api.py`` or
``tests/test_fuzz.py`` again with the names it calls patched to
``sparse_dot_tpu_torch``'s for the length of the test (the harness of
``tests/test_torch_solver_suite.py``):

- ``tests/test_device_api.py``: ``test_container_transpose_view``,
  ``test_dot_product_accepts_device_container`` and
  ``test_device_csc_to_csr_conversion`` of ``TestDeviceContainers``, and
  ``TestILP64``.  Its ``tearDown`` and tests call
  ``formats.clear_transfer_cache()``, which the port does not have (it
  keeps no cache of host-to-device transfers): the harness makes it a
  no-op for the test.  ``jnp.int64``, which ``test_int64_indices``
  compares the index dtype with, is ``torch.int64`` here.  Left out:
  ``TestTransferCache`` (the JAX package's transfer cache, which the port
  does not have), ``TestPallasBSRInterpret`` (the Pallas kernel in
  interpret mode; ``tests/test_torch_kernels.py`` holds the port's K1
  plain version against it), and ``test_container_through_jit`` and
  ``test_tree_flatten_roundtrip`` (``jax.jit`` and pytrees, which have no
  counterpart in the port: PyTorch runs eagerly, and its device API's
  transforms are tested in ``tests/test_torch_transforms.py``);
- ``tests/test_fuzz.py``: all five sweeps (``TestFuzzSpMM`` and
  ``TestFuzzSpGEMM``), ``dot_product`` and ``gram_matrix`` the port's.

The modules are imported, not their classes, so pytest does not collect
the originals a second time here.
"""

import types
import unittest
from unittest import mock

import pytest
import torch

import sparse_dot_tpu.interface
import sparse_dot_tpu_torch
from sparse_dot_tpu_torch import formats as port_formats
from sparse_dot_tpu_torch import interface as port_interface
from sparse_dot_tpu_torch.config import config as port_config

from . import test_device_api, test_fuzz
from .test_torch_solver_suite import patched


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless asked otherwise; these tests ask
    for the CPU, where its wrappers take their plain versions."""
    saved = port_config.device
    port_config.device = "cpu"
    yield
    port_config.device = saved


def _no_transfer_cache():
    """The port keeps no transfer cache: nothing to clear."""


DEVICE_API = [
    (test_device_api, "sdt", sparse_dot_tpu_torch),
    (test_device_api, "formats", port_formats),
    (test_device_api, "jnp", types.SimpleNamespace(int64=torch.int64)),
    (sparse_dot_tpu.interface, "convert_container_to_csr",
     port_interface.convert_container_to_csr),
]
FUZZ = [
    (test_fuzz, "dot_product", sparse_dot_tpu_torch.dot_product),
    (test_fuzz, "gram_matrix", sparse_dot_tpu_torch.gram_matrix),
]


def port_class(module, name, patches, left_out=()):
    """Subclass of the unittest class ``module.<name>`` whose tests run
    with ``patches`` set (and ``clear_transfer_cache`` a no-op on the
    port's formats), without the tests named in ``left_out``."""
    base = getattr(module, name)

    def setUp(self):
        stack = mock.patch.object(port_formats, "clear_transfer_cache",
                                  _no_transfer_cache, create=True)
        stack.start()
        self.addCleanup(stack.stop)
        context = patched(patches)
        context.__enter__()
        self.addCleanup(context.__exit__, None, None, None)
        base.setUp(self)

    port_name = name.replace("Test", "TestPort", 1)
    attrs = {"setUp": setUp, "__qualname__": port_name,
             "__module__": __name__}
    attrs.update({test: None for test in left_out})
    return type(port_name, (base,), attrs)


TestPortDeviceContainers = port_class(
    test_device_api, "TestDeviceContainers", DEVICE_API,
    left_out=("test_container_through_jit", "test_tree_flatten_roundtrip"))
TestPortILP64 = port_class(test_device_api, "TestILP64", DEVICE_API)
TestPortFuzzSpMM = port_class(test_fuzz, "TestFuzzSpMM", FUZZ)
TestPortFuzzSpGEMM = port_class(test_fuzz, "TestFuzzSpGEMM", FUZZ)


@pytest.mark.parametrize("name, method", [
    ("TestPortDeviceContainers", "test_dot_product_accepts_device_container"),
    ("TestPortILP64", "test_int64_indices"),
    ("TestPortFuzzSpMM", "test_sweep_spmv"),
    ("TestPortFuzzSpGEMM", "test_sweep_gram"),
])
def test_reruns_call_the_port(name, method):
    """A rerun builds the port's containers (``formats.to_device``), so it
    runs the port's operations, not the JAX package's."""
    calls = []
    real = port_formats.to_device

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    result = unittest.TestResult()
    with mock.patch.object(port_formats, "to_device", counted):
        globals()[name](method).run(result)
    assert result.wasSuccessful(), result.errors + result.failures
    assert calls
