"""Debug / tracing utilities.

Port of ``sparse_dot_tpu/utils/debug.py``: a module-global debug flag, a
conditional printer, a phase wall-clock timer and a per-call backend
dump.  Phases are marked with ``torch.profiler.record_function``, so a
``torch.profiler`` trace shows the same phase names.
"""

import time

import torch

from ..config import config


def set_debug_mode(debug):
    """Activate or deactivate debug mode (the reference's
    ``sparse_dot_mkl.set_debug_mode``)."""
    if not isinstance(debug, bool):
        raise ValueError("Debug mode must be set with a boolean")
    config.debug = debug


def is_debug_mode():
    return config.debug


def debug_print(msg):
    """Print a message only when debug mode is on."""
    if config.debug:
        print(msg)


def debug_timer(msg=None, old_time=None):
    """Wall-clock phase timer.

    Usage::

        t = debug_timer()
        ...work...
        t = debug_timer("Phase name", t)
    """
    if not config.debug:
        return None
    now = time.time()
    if msg is not None and old_time is not None:
        print(f"{msg}: {(now - old_time) * 1000:.3f} ms")
    return now


def print_backend_debug():
    """Per-call backend info dump, analog of ``print_mkl_debug``."""
    if not config.debug:
        return
    from ..backend import get_version_string

    print(get_version_string())
    print(f"Index interface: {config.interface} ({config.index_dtype})")


class trace_phase:
    """Context manager adding a profiler range and debug timing."""

    def __init__(self, name):
        self.name = name
        self._range = None
        self._t = None

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._t = debug_timer()
        return self

    def __exit__(self, *exc):
        debug_timer(self.name, self._t)
        return self._range.__exit__(*exc)
