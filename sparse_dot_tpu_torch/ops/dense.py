"""Dense GEMM and the alpha/beta epilogue.

Port of ``sparse_dot_tpu/ops/_xla.py`` ``gemm`` (``cblas_?gemm``),
``syrk_dense`` (``cblas_?syrk``) and ``axpby``.  The JAX package computed the dense product with ``jnp.dot``
outside any Pallas kernel, so it stays a library product here
(``torch.matmul``).  The Ozaki f64 route of the TPU has no counterpart:
the card has IEEE f64.

float32 products must be IEEE float32: the reference's decimal=5 f32
tolerance does not hold under TF32's 10-bit mantissa (the JAX package
forced ``Precision.HIGHEST`` for the same reason, ``_xla._prec``).
"""

import torch


def ieee_matmul():
    """Turn TF32 off for CUDA matmuls and check that it is off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("could not turn TF32 off for float32 matmuls")


def as_scalar(x, dtype):
    """Python scalar of ``x`` for a tensor of ``dtype`` (a real dtype
    takes the real part, as ``jnp.asarray(x, dtype)`` does)."""
    z = complex(x)
    return z if dtype.is_complex else z.real


def axpby(c, alpha=None, beta=None, c0=None):
    """``alpha * c + beta * c0`` in place on ``c`` (each term optional):
    the out/out_scalar accumulate of the plain paths."""
    if alpha is not None:
        c.mul_(as_scalar(alpha, c.dtype))
    if c0 is not None:
        c.add_(c0, alpha=as_scalar(1.0 if beta is None else beta, c.dtype))
    return c


def gemm(a, b, alpha=1.0, beta=0.0, c0=None):
    """``alpha * (a @ b) + beta * c0`` (``cblas_?gemm`` semantics)."""
    if a.is_cuda:
        ieee_matmul()
    c = torch.matmul(a, b)
    return axpby(c, None if alpha == 1.0 else alpha, beta, c0)


def syrk(a, aat=False, alpha=1.0, beta=0.0, c0=None):
    """``triu(alpha * op(a)) + beta * c0`` with op(a) = a @ a.T (``aat``)
    or a.T @ a, unconjugated for complex ``a``: the strict lower triangle
    is ``beta * c0`` (or 0), as ``cblas_?syrk`` leaves it."""
    if a.is_cuda:
        ieee_matmul()
    c = torch.triu(torch.matmul(a, a.T) if aat else torch.matmul(a.T, a))
    return axpby(c, None if alpha == 1.0 else alpha, beta, c0)
