"""Global configuration of the PyTorch port.

Port of ``sparse_dot_tpu/config.py``: the index integer width ("LP64"
int32 or "ILP64" int64, the reference's ``MKL_INTERFACE_LAYER``), the
debug flag, the chunk budget of the plain paths, PARDISO's dense budget
and the dense plane cache of the densify routes, plus the device every
tensor is created on: the card unless the caller sets ``config.device =
"cpu"``.  The TPU switches of the JAX package (planar complex,
Pallas/ELL/Ozaki routes and their caches) have no counterpart.

Environment variables
---------------------
SPARSE_DOT_INTERFACE : "LP64" (default, int32 indices) or "ILP64" (int64).
SPARSE_DOT_DEBUG : truthy to enable debug printing at import.
"""

import os

import numpy as np

__version__ = "0.5.0"

_VALID_INTERFACES = ("LP64", "ILP64")
_VALID_DEVICES = ("cpu", "cuda")


def _interface_from_env():
    val = os.environ.get("SPARSE_DOT_INTERFACE", "LP64").upper()
    if val not in _VALID_INTERFACES:
        raise ValueError(
            f"SPARSE_DOT_INTERFACE must be one of {_VALID_INTERFACES}; "
            f"got {val!r}"
        )
    return val


def _check_device(device):
    device = str(device).lower()
    if device not in _VALID_DEVICES:
        raise ValueError(
            f"device must be one of {_VALID_DEVICES}; got {device!r}"
        )
    return device


class _Config:
    """Process-wide settings."""

    def __init__(self):
        self.interface = _interface_from_env()
        self.debug = bool(os.environ.get("SPARSE_DOT_DEBUG", ""))
        # Max number of gathered elements the plain SpMM, and of expanded
        # products the plain SpGEMM, materialize at once (bounds the (nnz,
        # n) intermediate and the product sort; the CUDA kernels have
        # neither).
        self.spmm_chunk_elements = 1 << 24
        # PARDISO factors densely while n * n * 12 bytes stay under this
        # budget and solves matrix-free (CG / FGMRES) beyond it: the JAX
        # package's rule and default, so both packages take the same route.
        self.pardiso_dense_budget_bytes = 2 << 30
        # Dense planes of a container (``SparseDeviceMatrix.dense_planes``:
        # its dense op(A), bf16 structural indicator and the finite flag of
        # its values), kept on it while their bytes stay within this
        # budget, so that the densify routes of ``ops/host`` skip K12 on a
        # container's repeat use.  The JAX package's names and defaults.
        self.spgemm_plane_cache = True
        self.spgemm_plane_cache_bytes = 1 << 28
        self._device = "cuda"

    @property
    def device(self):
        """Where every tensor is created: "cuda" (default) or "cpu".  With
        "cuda" and no visible card, operations raise instead of running on
        the CPU (``backend.torch_device``); importing the package needs no
        card."""
        return self._device

    @device.setter
    def device(self, value):
        self._device = _check_device(value)

    @property
    def index_dtype(self):
        """NumPy dtype used for sparse index arrays (int32 or int64)."""
        return np.int64 if self.interface == "ILP64" else np.int32

    def set_interface(self, interface):
        interface = interface.upper()
        if interface not in _VALID_INTERFACES:
            raise ValueError(
                f"interface must be one of {_VALID_INTERFACES}; "
                f"got {interface!r}"
            )
        self.interface = interface


config = _Config()


def interface_integer_dtype():
    """Return the active index integer dtype (int32 for LP64, int64 for
    ILP64); the reference's ``mkl_interface_integer_dtype``."""
    return config.index_dtype


def set_interface_layer(interface):
    """Select LP64 (int32) or ILP64 (int64) index width; the reference's
    ``MKL_Set_Interface_Layer``.  Containers keep the width they were
    built with."""
    config.set_interface(interface)
    return config.interface


ILP64_HINT = (
    "Try changing the index interface to int64 with the environment "
    "variable SPARSE_DOT_INTERFACE=ILP64"
)
