"""sparse_dot_tpu_torch — the PyTorch/CUDA port of ``sparse_dot_tpu``.

The same public surface as the JAX package, for one NVIDIA H100 (or the
CPU): ``dot_product``, ``gram_matrix`` and ``sypr`` over scipy
CSR/CSC/BSR and numpy dense operands in float32/float64/complex64/
complex128, with the reference's ``cast``, ``dense``, ``out``/
``out_scalar`` and memory-order semantics; the solvers ``cg``,
``cg_mrhs``, ``fgmres`` (and their classes), ``sparse_qr_solve`` and
``pardiso``/``pardisoinit``; and the sparse handle protocol
(``interface``).  The sparse products run on hand-written CUDA kernels
for Hopper (``csrc/``): K1 BSR SpMM, K2 CSR SpMM, K3 CSR SpMV, K4 + K5
sparse x sparse with sparse output (count, then fill), K6 sparse x
sparse with dense output and K7 CSR SDDMM (the gradient of a sparse
product with respect to its values); dense GEMM and the dense gram run on
``torch.matmul``.  Where a gate measured on the card says the dense
product is faster, a product runs on the densify routes instead: K12
(CSR densify, and its bf16 structural indicator) and ``torch.matmul``,
with K13 (masked compaction) for sparse output.  The solvers' matvecs
run on K3 (one right-hand side) and K2 (several, and CGLS); the dense QR
and LU routes on ``torch.linalg``.

Tensors live on ``config.device``: "cuda" by default, where an operation
raises when no card is visible (it never falls back to the CPU), or
"cpu" when the caller asks for it::

    from sparse_dot_tpu_torch.config import config
    config.device = "cpu"

The device API, ``ops.coo_spmm_raw`` and ``ops.coo_spmv`` (the JAX
package's ``_xla`` functions of those names), takes torch tensors and is
open to PyTorch's transforms: reverse mode with respect to the values and
the dense operand (K7 CSR SDDMM and K2/K3 over A^H), forward mode, and
``torch.func.vmap`` over dense operands (one K2 launch for the batch).
``ops.csr.csr_spmm`` and ``csr_spmv`` carry gradients the same way when
an operand requires grad.

The drop-in aliases with the reference's ``*_mkl`` names are exported.
The sharded layer, ``parallel``, runs the products and solvers over
``torch.distributed`` ranks (one device each; NCCL on the cards, gloo on
the CPU), and ``dot_product`` and ``sparse_qr_solve`` route a
``parallel.ShardedCSR`` operand to it.  This package never imports JAX.
"""

from .config import (
    __version__,
    interface_integer_dtype,
    set_interface_layer,
)
from . import backend
from .backend import (
    get_version,
    get_version_string,
    get_max_threads,
    get_device_count,
    set_num_threads,
    set_num_threads_local,
    free_buffers,
)
from .utils.debug import set_debug_mode, debug_print, debug_timer
from .formats import (
    CSR,
    CSC,
    BSR,
    is_csr,
    is_csc,
    is_bsr,
    issparse,
    to_device,
    from_arrays,
)
from . import interface
from .dispatch import dot_product, gram_matrix, sparse_qr_solve
from .ops.sypr import sypr
from .solvers import (
    cg,
    cg_mrhs,
    fgmres,
    pardiso,
    pardisoinit,
    CGIterativeSparseSolver,
    FGMRESIterativeSparseSolver,
    ConvergenceWarning,
)

dot_product_mkl = dot_product
gram_matrix_mkl = gram_matrix
dot_product_transpose_mkl = gram_matrix
sparse_qr_solve_mkl = sparse_qr_solve


def mkl_get_version():
    """7-tuple version info shaped like the reference's
    ``mkl_get_version`` (major, minor, update, product status, build,
    processor, platform)."""
    import torch

    parts = (torch.__version__.split("+")[0].split(".") + ["0", "0"])[:3]
    v = get_version()
    return (
        int(parts[0]),
        int(parts[1]),
        int("".join(c for c in parts[2] if c.isdigit()) or 0),
        "sparse_dot_tpu_torch",
        v["framework_version"],
        v["device_kind"],
        v["platform"],
    )


def mkl_set_interface_layer(layer_code):
    """Accepts the reference's interface-layer codes (ints) or the
    LP64/ILP64 strings; raises ValueError otherwise."""
    if isinstance(layer_code, int):
        # MKL codes: 0/2 -> LP64 variants, 1/3 -> ILP64 variants.
        return set_interface_layer("ILP64" if layer_code % 2 else "LP64")
    return set_interface_layer(layer_code)


mkl_get_version_string = get_version_string
mkl_get_max_threads = get_max_threads
mkl_set_num_threads = set_num_threads
mkl_set_num_threads_local = set_num_threads_local
mkl_interface_integer_dtype = interface_integer_dtype
mkl_free_buffers = free_buffers

__all__ = [
    "__version__",
    # canonical API
    "dot_product",
    "gram_matrix",
    "sparse_qr_solve",
    "sypr",
    "interface",
    # solvers
    "cg",
    "cg_mrhs",
    "fgmres",
    "pardiso",
    "pardisoinit",
    "CGIterativeSparseSolver",
    "FGMRESIterativeSparseSolver",
    "ConvergenceWarning",
    "set_debug_mode",
    "debug_print",
    "debug_timer",
    "set_interface_layer",
    "interface_integer_dtype",
    "get_version",
    "get_version_string",
    "get_max_threads",
    "get_device_count",
    "set_num_threads",
    "set_num_threads_local",
    "free_buffers",
    # containers
    "CSR",
    "CSC",
    "BSR",
    "is_csr",
    "is_csc",
    "is_bsr",
    "issparse",
    "to_device",
    "from_arrays",
    # reference-compatible aliases
    "dot_product_mkl",
    "gram_matrix_mkl",
    "dot_product_transpose_mkl",
    "sparse_qr_solve_mkl",
    "mkl_get_version",
    "mkl_get_version_string",
    "mkl_get_max_threads",
    "mkl_set_num_threads",
    "mkl_set_num_threads_local",
    "mkl_set_interface_layer",
    "mkl_interface_integer_dtype",
    "mkl_free_buffers",
]
