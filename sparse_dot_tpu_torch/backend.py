"""Device selection and the service functions.

Port of ``sparse_dot_tpu/backend.py``: the analogs of MKL's
``MKL_Get_Version(_String)`` / ``MKL_Get_Max_Threads`` /
``MKL_Set_Num_Threads`` family, answered from torch and CUDA.  The JAX
package's backend capability probes (native complex, f64 range, f64
LU/QR) have no counterpart: CUDA and the CPU have all of them.
"""

import torch

from .config import __version__, config


def torch_device():
    """The ``torch.device`` of ``config.device``.  Raises when it is
    "cuda" and no card is visible: the port never falls back to the CPU."""
    if config.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "config.device is 'cuda' but torch sees no CUDA device; set "
            "config.device = 'cpu' to run on the CPU"
        )
    return torch.device(config.device)


def _device_kind():
    if config.device == "cuda" and torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


def get_version():
    """Dict describing the backend, analogous to ``MKLVersion``."""
    return {
        "framework_version": __version__,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "platform": config.device,
        "device_kind": _device_kind(),
        "num_devices": get_device_count(),
    }


def get_version_string():
    """Analog of ``mkl_get_version_string``."""
    v = get_version()
    return (
        f"sparse_dot_tpu_torch {v['framework_version']} on torch "
        f"{v['torch_version']} (CUDA {v['cuda_version']}) "
        f"[{v['platform']}: {v['device_kind']} x{v['num_devices']}]"
    )


def get_device_count():
    """Number of devices of ``config.device``: the visible CUDA devices for
    "cuda", 1 for "cpu" (the JAX package counts its CPU device too)."""
    return torch.cuda.device_count() if config.device == "cuda" else 1


def get_max_threads():
    """Analog of ``mkl_get_max_threads``: torch's intra-op thread count."""
    return torch.get_num_threads()


def set_num_threads(n):
    """Analog of ``mkl_set_num_threads``: sets torch's intra-op threads."""
    if n < 1:
        raise ValueError("Number of threads must be a positive integer")
    torch.set_num_threads(int(n))


_default_threads = torch.get_num_threads()


def set_num_threads_local(n):
    """Analog of ``mkl_set_num_threads_local``: returns the previous
    setting; 0 restores the count torch started with."""
    previous = torch.get_num_threads()
    set_num_threads(_default_threads if n == 0 else n)
    return previous


def free_buffers():
    """Analog of ``mkl_free_buffers``: return cached CUDA memory."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
