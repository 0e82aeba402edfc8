"""Operation layer: the host boundary (``host``), the kernel wrappers
with their plain versions (``bsr``, ``csr``, ``sddmm``, ``spgemm``,
``spgemm_grad``, ``dense``), the differentiable device API
(``autograd``: ``coo_spmm_raw``, ``coo_spmv`` and ``bsr_spmm``, exported
here) and the CUDA build (``_build``)."""

from .autograd import bsr_spmm, coo_spmm_raw, coo_spmv

__all__ = ["bsr_spmm", "coo_spmm_raw", "coo_spmv"]
