"""The reference-style service, policy, handle and solver suites, run on
the port.

Each test of these modules runs again with the names it calls patched to
``sparse_dot_tpu_torch``'s for the length of the test: the module's own
imports, and the ``sparse_dot_tpu`` names its test bodies import inside
(``from sparse_dot_tpu import cg_mrhs``, ``import
sparse_dot_tpu.solvers.qr as qr_mod``, ``from sparse_dot_tpu.config import
config``, ...).

- ``tests/test_service.py`` and ``tests/test_policy.py``: every test but
  ``test_full_f64_range_capability_and_no_warning_on_cpu``, which asserts
  the JAX backend's f64-range probe (a TPU capability probe the port does
  not have; ``test_port_full_f64_range_product`` below runs its product
  on the port), and ``test_container_astype_identity_and_planar``, which
  casts to planar complex storage;
- ``tests/test_handles.py``: ``TestHandles``.  ``TestHandlesPlanarComplex``
  is left out: planar complex storage is the JAX package's TPU layout;
- ``tests/test_solvers_iss.py``: ``TestSparseSolverCG``,
  ``TestSparseSolverFGMRES``, ``TestCGMultiRHS`` and
  ``TestCGMrhsDtypeGuard``.  Left out: ``TestEllSolverLoops`` and
  ``TestEllKillSwitch`` (the TPU's binned-ELL loop forms and their kill
  switch) and ``TestEllHiloRangeGate`` (the hi|lo f32 split's range gate);
  the port has one CSR operator per solver and exact f64;
- ``tests/test_qr_solver.py``: every test; ``test_sharded_qr_route``
  builds its ``ShardedCSR`` with the port's ``parallel`` in a one-rank
  gloo group (the port's device count, one per process, stands in for
  ``jax.device_count()``), left again after the test;
- ``tests/test_pardiso.py``: every test, with the ``case`` grid's native
  parameters (f32, f64, c64, c128) and ``native`` of
  ``test_iparm11_transpose_solve_complex``; the ``*-planar`` and
  ``planar`` parameters run the JAX package's real 2n embedding of complex
  systems, a TPU layout.

The modules are imported, not their classes or functions, so pytest does
not collect the originals a second time here.
"""

import contextlib
import functools
import importlib
import inspect
import sys
import unittest
import warnings
from unittest import mock

import numpy as np
import pytest
import scipy.sparse as sps

import jax

import sparse_dot_tpu
import sparse_dot_tpu.config
import sparse_dot_tpu.parallel
import sparse_dot_tpu.solvers
import sparse_dot_tpu.solvers.iterative
import sparse_dot_tpu_torch
from sparse_dot_tpu_torch import formats as port_formats
from sparse_dot_tpu_torch import interface as port_interface
from sparse_dot_tpu_torch import parallel as port_parallel
from sparse_dot_tpu_torch import policy as port_policy
from sparse_dot_tpu_torch.config import config as port_config
from sparse_dot_tpu_torch.solvers import iterative as port_iterative
from sparse_dot_tpu_torch.solvers import qr as port_qr

# The package's ``pardiso`` attribute is the function of that name.
port_pardiso = importlib.import_module("sparse_dot_tpu_torch.solvers.pardiso")

from . import (  # noqa: E402
    test_handles,
    test_pardiso,
    test_policy,
    test_qr_solver,
    test_service,
    test_solvers_iss,
)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless asked otherwise; these tests ask
    for the CPU, where its wrappers take their plain versions."""
    saved = port_config.device
    port_config.device = "cpu"
    yield
    port_config.device = saved


@pytest.fixture(autouse=True)
def no_group_left():
    """A process group that a test started (the sharded QR route's
    one-rank group) is left after it."""
    started = port_parallel.is_initialized()
    yield
    if not started:
        port_parallel.shutdown()


@contextlib.contextmanager
def _item(mapping, key, value):
    """``mapping[key]`` set to ``value`` for the block, and only that key
    restored after it (``mock.patch.dict`` would restore all of
    ``sys.modules``, dropping modules first imported inside)."""
    saved = mapping[key]
    mapping[key] = value
    try:
        yield
    finally:
        mapping[key] = saved


@contextlib.contextmanager
def patched(patches):
    """Every (target, name, value) of ``patches`` set for the block; a dict
    target has its item ``name`` set."""
    with contextlib.ExitStack() as stack:
        for target, name, value in patches:
            stack.enter_context(
                _item(target, name, value) if isinstance(target, dict)
                else mock.patch.object(target, name, value))
        yield


def _port_names(module, port_module, names):
    return [(module, name, getattr(port_module, name)) for name in names]


SERVICE = [(test_service, "sdt", sparse_dot_tpu_torch)]
POLICY = [
    *_port_names(test_policy, sparse_dot_tpu_torch,
                 ("dot_product", "to_device")),
    *_port_names(test_policy, port_policy,
                 ("empty_result_dtype", "output_dtype", "type_check")),
    (sparse_dot_tpu, "formats", port_formats),
]
HANDLES = _port_names(test_handles, port_interface, (
    "create_sparse_handle", "export_sparse_handle", "convert_to_csr",
    "order_sparse_handle", "destroy_sparse_handle", "matmul_handles",
    "sparse_handle_t",
))
SOLVERS = [
    *_port_names(test_solvers_iss, port_interface, (
        "SPARSE_FILL_MODE_UPPER", "SPARSE_DIAG_NON_UNIT",
        "SPARSE_MATRIX_TYPE_SYMMETRIC",
    )),
    *_port_names(test_solvers_iss, port_iterative, (
        "CGIterativeSparseSolver", "FGMRESIterativeSparseSolver",
        "ConvergenceWarning", "cg", "fgmres",
    )),
    *_port_names(sparse_dot_tpu, port_iterative, ("cg", "cg_mrhs")),
    (sparse_dot_tpu.solvers, "cg_mrhs", port_iterative.cg_mrhs),
    (sparse_dot_tpu.solvers, "iterative", port_iterative),
    (sparse_dot_tpu.solvers.iterative, "ConvergenceWarning",
     port_iterative.ConvergenceWarning),
]
QR = [
    (test_qr_solver, "sparse_qr_solve", sparse_dot_tpu_torch.sparse_qr_solve),
    (sparse_dot_tpu.solvers, "qr", port_qr),
]
SHARDED_QR = [
    *QR,
    (sys.modules, "sparse_dot_tpu.parallel", port_parallel),
    (jax, "device_count",
     lambda: port_parallel.process_info()["global_device_count"]),
]
PARDISO_NO_CONFIG = [
    *_port_names(test_pardiso, sparse_dot_tpu_torch,
                 ("pardiso", "pardisoinit", "sparse_qr_solve")),
    *_port_names(sparse_dot_tpu.solvers, port_pardiso,
                 ("export_factorization", "import_factorization")),
    (sys.modules, "sparse_dot_tpu.solvers.pardiso", port_pardiso),
]
PARDISO = [*PARDISO_NO_CONFIG,
           (sparse_dot_tpu.config, "config", port_config)]


def port_class(module, name, patches):
    """Subclass of the unittest class ``module.<name>`` whose tests run
    with ``patches`` set."""
    base = getattr(module, name)

    def setUp(self):
        stack = contextlib.ExitStack()
        stack.enter_context(patched(patches))
        self.addCleanup(stack.close)
        base.setUp(self)

    port_name = name.replace("Test", "TestPort", 1)
    return type(port_name, (base,), {"setUp": setUp,
                                     "__qualname__": port_name,
                                     "__module__": __name__})


def port_function(fn, patches):
    """``fn`` (keeping its parameters and marks) run with ``patches``
    set."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with patched(patches):
            return fn(*args, **kwargs)

    return run


for _module, _names in ((test_handles, ("TestHandles",)),
                        (test_solvers_iss, (
                            "TestSparseSolverCG", "TestSparseSolverFGMRES",
                            "TestCGMultiRHS", "TestCGMrhsDtypeGuard"))):
    for _name in _names:
        _cls = port_class(_module, _name,
                          HANDLES if _module is test_handles else SOLVERS)
        globals()[_cls.__name__] = _cls

_LEFT_OUT = {
    "test_full_f64_range_capability_and_no_warning_on_cpu",
    "test_container_astype_identity_and_planar",
    "test_iparm11_transpose_solve_complex",
}
for _module, _prefix, _patches in (
    (test_service, "service", SERVICE),
    (test_policy, "policy", POLICY),
    (test_qr_solver, "qr", QR),
    (test_pardiso, "pardiso", PARDISO),
):
    for _name, _obj in vars(_module).copy().items():
        if (_name.startswith("test_") and inspect.isfunction(_obj)
                and _name not in _LEFT_OUT):
            globals()[_name.replace("test_", f"test_port_{_prefix}_", 1)] = (
                port_function(_obj, SHARDED_QR if _name ==
                              "test_sharded_qr_route" else _patches))
del _module, _names, _name, _cls, _prefix, _patches, _obj

# test_qr_solver's fixture, under its own name for the functions above.
diag_system = test_qr_solver.diag_system


@pytest.fixture(params=[p for p in test_pardiso.GRID if not p[3]],
                ids=[i for i, p in zip(test_pardiso.GRID_IDS,
                                       test_pardiso.GRID) if not p[3]])
def case(request):
    """test_pardiso's ``case`` at its native (not planar) parameters."""
    dtype, mtype, single, _ = request.param
    pt, iparm = sparse_dot_tpu_torch.pardisoinit(mtype,
                                                 single_precision=single)
    return {
        "A": test_pardiso._A.astype(dtype),
        "b": test_pardiso._B[:, 0].astype(dtype),
        "B": test_pardiso._B.astype(dtype),
        "pt": pt,
        "iparm": iparm,
        "mtype": mtype,
        "single": single,
        "dtype": dtype,
    }


@pytest.mark.parametrize("tmode", [1, 2], ids=["conjT", "T"])
def test_port_pardiso_iparm11_transpose_solve_complex_native(tmode):
    """The native parameter of ``test_iparm11_transpose_solve_complex``;
    the test sets the JAX package's planar switch (to False) and clears
    its transfer cache, so its config stays the JAX package's."""
    with patched(PARDISO_NO_CONFIG):
        test_pardiso.test_iparm11_transpose_solve_complex(tmode, False)


def test_port_full_f64_range_product():
    """The product of ``test_full_f64_range_capability_and_no_warning_on_
    cpu`` on the port: values near 1e200 multiply exactly, with no range
    warning."""
    A = sps.random(40, 50, density=0.2, format="csr",
                   dtype=np.float64, random_state=3)
    A.data *= 1e200
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = sparse_dot_tpu_torch.dot_product(A, A.T.tocsc())
    np.testing.assert_allclose(got.toarray(), (A @ A.T).toarray(),
                               rtol=1e-12, atol=0)


# ---------------------------------------------------------------------------
# The reruns call the port
# ---------------------------------------------------------------------------


def _counting(target, name, calls):
    real = getattr(target, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    return mock.patch.object(target, name, counted)


def _with_monkeypatch(test):
    with pytest.MonkeyPatch.context() as monkeypatch:
        test(monkeypatch)


def _run_unittest(cls, method):
    result = unittest.TestResult()
    cls(method).run(result)
    assert result.wasSuccessful(), result.errors + result.failures


PORT_CALLS = {
    "handles": (port_interface, "spgemm_device", lambda: _run_unittest(
        TestPortHandles, "test_matmul_handles")),  # noqa: F821
    "cg": (port_iterative, "_cg_loop", lambda: _run_unittest(
        TestPortSparseSolverCG, "test_cg_spd_real_system")),  # noqa: F821
    "fgmres": (port_iterative, "_fgmres_cycle", lambda: _run_unittest(
        TestPortSparseSolverFGMRES,  # noqa: F821
        "test_fgmres_nonsymmetric_system")),
    "cg_mrhs": (port_iterative, "_cg_mrhs_loop", lambda: _run_unittest(
        TestPortCGMultiRHS, "test_matches_single_rhs")),  # noqa: F821
    "qr": (port_qr, "_cgls_loop", lambda: _with_monkeypatch(
        test_port_qr_large_m_routes_to_cgls)),  # noqa: F821
    "pardiso": (port_pardiso, "_lu_solve",
                lambda: test_port_pardiso_iparm11_transpose_solve_real()),  # noqa: F821,E501
    "policy": (sparse_dot_tpu_torch.dispatch, "_sparse_dot_sparse",
               lambda: test_port_policy_empty_sparse_sparse()),  # noqa: F821
    "service": (sparse_dot_tpu_torch, "get_device_count",
                lambda: test_port_service_device_count()),  # noqa: F821
}


@pytest.mark.parametrize("group", list(PORT_CALLS))
def test_port_suites_call_the_port(group):
    """A test of each rerun group goes through the port's code."""
    target, name, run = PORT_CALLS[group]
    calls = []
    with _counting(target, name, calls):
        run()
    assert calls


def test_device_count_follows_config_device(monkeypatch):
    """``get_device_count`` counts the devices of ``config.device``: 1 for
    the CPU, as ``sparse_dot_tpu.get_device_count`` counts its CPU device,
    and the visible cards for "cuda"."""
    import torch

    from sparse_dot_tpu_torch import backend

    assert backend.get_device_count() == 1
    assert backend.get_version()["num_devices"] == 1
    monkeypatch.setattr(port_config, "_device", "cuda")
    assert backend.get_device_count() == torch.cuda.device_count()
