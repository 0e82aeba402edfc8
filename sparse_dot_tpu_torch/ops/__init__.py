"""Operation layer: the host boundary (``host``), the kernel wrappers
with their plain versions (``bsr``, ``csr``, ``sddmm``, ``spgemm``,
``dense``), the differentiable device API (``autograd``: ``coo_spmm_raw``
and ``coo_spmv``, exported here) and the CUDA build (``_build``)."""

from .autograd import coo_spmm_raw, coo_spmv

__all__ = ["coo_spmm_raw", "coo_spmv"]
