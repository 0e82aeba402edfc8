"""The sparse handle protocol.

Port of ``sparse_dot_tpu/interface.py``: the reference's internal handle
layer (``_create_mkl_sparse`` / ``_export_mkl`` / ``_convert_to_csr`` /
``_order_mkl_handle`` / ``_destroy_mkl_handle`` and the matrix-descriptor
enums) over this package's containers:

* a handle is a thin mutable box around a container on ``config.device``;
* "export" rebuilds a scipy object from the container's arrays;
* "convert" and "order" build new CSR arrays on the device, with one
  stable sort of the (row, col) key (``formats.sort_csr_indices``), so a
  converted or ordered CSR has each row's columns sorted, as the JAX
  package's are;
* "destroy" empties the box, and raises on an empty one;
* ``matmul_handles`` multiplies on K4 + K5 or the structural densify
  route (``ops/host.spgemm_device``) and keeps the product on the device.
"""

from . import formats
from .ops.host import spgemm_device
from .policy import precision_flags

# Matrix-descriptor enums: the JAX package's values (symbolic, never ABI).
SPARSE_MATRIX_TYPE_GENERAL = 20
SPARSE_MATRIX_TYPE_SYMMETRIC = 21
SPARSE_MATRIX_TYPE_HERMITIAN = 22
SPARSE_MATRIX_TYPE_TRIANGULAR = 23
SPARSE_MATRIX_TYPE_DIAGONAL = 24

SPARSE_FILL_MODE_LOWER = 40
SPARSE_FILL_MODE_UPPER = 41
SPARSE_FILL_MODE_FULL = 42

SPARSE_DIAG_NON_UNIT = 50
SPARSE_DIAG_UNIT = 51

SPARSE_OPERATION_NON_TRANSPOSE = 10
SPARSE_OPERATION_TRANSPOSE = 11
SPARSE_OPERATION_CONJUGATE_TRANSPOSE = 12


class matrix_descr:
    """Sparse matrix descriptor (analog of the reference's
    ``_structs.py:13-30``)."""

    def __init__(self, sparse_matrix_type_t=SPARSE_MATRIX_TYPE_GENERAL,
                 sparse_fill_mode_t=0, sparse_diag_type_t=0):
        self.sparse_matrix_type_t = sparse_matrix_type_t
        self.sparse_fill_mode_t = sparse_fill_mode_t
        self.sparse_diag_type_t = sparse_diag_type_t


class sparse_handle_t:
    """Mutable box around a container.  An empty handle (no container)
    raises on use, as the reference's empty ``sparse_matrix_t`` does."""

    def __init__(self, container=None):
        self.container = container

    def _live(self):
        if self.container is None:
            raise ValueError("Empty sparse handle cannot be used")
        return self.container


def create_sparse_handle(matrix):
    """scipy CSR/CSC/BSR or container -> (handle, double_precision,
    complex_type).  COO and non-float dtypes raise ValueError."""
    container = formats.to_device(matrix)
    dbl, cplx = precision_flags(container)
    return sparse_handle_t(container), dbl, cplx


def export_sparse_handle(handle, double_precision=None, complex_type=False,
                         output_type="csr_matrix"):
    """Handle -> scipy object of the requested class; ValueError for an
    unknown output type or an empty handle."""
    container = handle._live() if isinstance(handle, sparse_handle_t) else (
        handle
    )
    if output_type not in formats._scipy_output_types:
        raise ValueError(
            f"Only CSR, CSC, and BSR output types are supported; "
            f"{output_type} provided"
        )
    constructor = formats._scipy_output_types[output_type]
    fmt = output_type.split("_")[0]

    if container.format == fmt:
        return container.to_scipy(constructor)

    # Cross-format export goes through scipy's conversion on the host.
    native = container.to_scipy()
    return constructor(getattr(native, "to" + fmt)())


def convert_to_csr(handle, destroy_original=False):
    """CSC/BSR/CSR handle -> CSR handle, converted on the device
    (``mkl_sparse_convert_csr`` analog)."""
    container = handle._live()
    new = convert_container_to_csr(container)
    if destroy_original:
        destroy_sparse_handle(handle)
    return sparse_handle_t(new)


def convert_container_to_csr(container):
    """The CSR container of a CSC or BSR one, each row's columns sorted; a
    CSR container is returned as it is."""
    if isinstance(container, formats.CSR):
        return container
    indptr, indices, data = container.csr_arrays()
    rows = formats.expand_indptr(indptr, indices.numel())
    indptr, indices, data = formats.coo_to_sorted_csr(
        rows, indices, data, container.shape)
    return formats.CSR(data, indices, indptr, container.shape,
                       sorted_indices=True)


def order_sparse_handle(handle):
    """Sort the column indices within each row on the device
    (``mkl_sparse_order`` analog); CSR handles only."""
    container = handle._live()
    if not isinstance(container, formats.CSR):
        raise ValueError("order is only supported for CSR handles")
    cols, vals = formats.sort_csr_indices(
        container.row_indices(), container.indices, container.data,
        container.shape[1],
    )
    handle.container = container._with(vals, indices=cols,
                                       sorted_indices=True)
    return handle


def destroy_sparse_handle(handle):
    """Empty the handle box (``mkl_sparse_destroy`` analog).  Raises on an
    already-empty handle like the reference does."""
    if not isinstance(handle, sparse_handle_t) or handle.container is None:
        raise ValueError("Empty sparse handle cannot be destroyed")
    handle.container = None
    return handle


def matmul_handles(handle_a, handle_b):
    """SpGEMM of two handles -> new CSR handle on the device (``_matmul_mkl``
    analog): ValueError on empty handles or misaligned shapes."""
    a = handle_a._live()
    b = handle_b._live()
    if a.shape[1] != b.shape[0]:
        raise ValueError(
            f"Matrix alignment error: {a.shape} * {b.shape} is not valid"
        )
    return sparse_handle_t(spgemm_device(a, b))
