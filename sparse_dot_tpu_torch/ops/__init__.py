"""Operation layer: the host boundary (``host``), the kernel wrappers
with their plain versions (``bsr``, ``csr``, ``dense``) and the CUDA
build (``_build``)."""
