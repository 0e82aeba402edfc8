"""Complex BSR products as K1's and K8's tensor-core variants compute them,
against numpy's component formula and the JAX package.

On the card, complex values in blocks of a multiple of 8 run on the
tensor cores as four real products a step on their parts (``csrc/mma.cuh``):
re += Ar Br, re += (-Ai) Bi, im += Ar Bi, im += Ai Br, each MMA summing
the step's products of one of them.  ``test_decomposition_*`` writes that
order in numpy over the parts and holds it to numpy's component formula
(each complex product (ar br - ai bi) + (ar bi + ai br) i, summed over k):
the same nan, +inf and -inf at inf and nan inputs, and the same values at
rtol 1e-12 in f64.  For c64 the parts are split as 3xTF32 (hi, and lo = x
- hi, both 0 in the cross products where hi is not finite), which keeps
the pattern and f32's tolerance.

The rest hold the port's complex BSR ``dot_product``, the plain versions
of K1 and K8 (which the kernels are held to on the card) and the gradient
in the blocks (single and under ``torch.func.vmap``) to the JAX package,
at bs 8 and 16 in c64 and c128: on the CPU the port's wrappers take their
plain versions.  Tolerances as ``test_torch_bsr_grad.py``'s: rtol 1e-10
(atol 1e-12) in complex128, 1e-5 in complex64, on values of order 1; the
two sides sum in different orders.  PyTorch's gradient of a real loss in
complex values is the conjugate of JAX's.
"""

import collections

import numpy as np
import numpy.testing as npt
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

import sparse_dot_tpu as sdt
from sparse_dot_tpu.ops import _xla

import sparse_dot_tpu_torch as sdtt
from sparse_dot_tpu_torch.config import config
from sparse_dot_tpu_torch.ops import bsr, bsr_spmm

TOL = {np.dtype(np.complex128): (1e-10, 1e-12),
       np.dtype(np.complex64): (1e-5, 1e-5)}
DTYPES = [np.complex64, np.complex128]
BLOCK_SIZES = [8, 16]
N = 5


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless asked otherwise; these tests ask
    for the CPU, where its wrappers take their plain versions, on one
    intra-op thread."""
    saved = config.device, torch.get_num_threads()
    config.device = "cpu"
    torch.set_num_threads(1)
    yield
    config.device = saved[0]
    torch.set_num_threads(saved[1])


def close(port, ref, dtype):
    if isinstance(port, torch.Tensor):
        port = port.detach().numpy()
    rtol, atol = TOL[np.dtype(dtype)]
    npt.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol)


def values(rng, size, dtype):
    v = rng.standard_normal(size) + 1j * rng.standard_normal(size)
    return v.astype(dtype)


# ---------------------------------------------------------------------------
# The decomposition the kernels use
# ---------------------------------------------------------------------------


def split_tf32(x):
    """numpy's copy of ``mma.cuh`` ``split_tf32`` on an f32 array: (hi,
    hic, lo), hi rounded to 10 mantissa bits half away from zero, hic and
    lo 0 where hi is inf or nan."""
    bits = x.astype(np.float32).view(np.uint32)
    hi = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)
    finite = np.isfinite(hi)
    with np.errstate(invalid="ignore", over="ignore"):
        lo = np.where(finite, x.astype(np.float32) - hi, np.float32(0))
    return hi, np.where(finite, hi, np.float32(0)), lo


def step_product(a, b, tf32x3):
    """One step of the real product of ``a`` (m, s) and ``b`` (s, n) as an
    MMA sums it: (the step's sum, the part kept apart).  With ``tf32x3``
    the sum is hi*hi in f32, and lo*hic + hic*lo is kept apart, to be
    added at the end (``mma_k8``)."""
    if not tf32x3:
        return (a[:, :, None] * b[None]).sum(1), 0.0
    (ah, ahc, al), (bh, bhc, bl) = split_tf32(a), split_tf32(b)
    return ((ah[:, :, None] * bh[None]).sum(1),
            (al[:, :, None] * bhc[None]).sum(1)
            + (ahc[:, :, None] * bl[None]).sum(1))


def kernel_order(a, b, tf32x3=False):
    """a @ b for complex a (m, k) and b (k, n) in the kernels' order of
    real products on the parts: k in steps of 4 (f64 MMA) or 8 (3xTF32),
    each step adding Ar Br then (-Ai) Bi to re, Ar Bi then Ai Br to im."""
    step = 8 if tf32x3 else 4
    sums, apart = {"re": 0.0, "im": 0.0}, {"re": 0.0, "im": 0.0}
    for k0 in range(0, a.shape[1], step):
        s = slice(k0, k0 + step)
        ar, ai, br, bi = a.real[:, s], a.imag[:, s], b.real[s], b.imag[s]
        for key, pairs in (("re", ((ar, br), (-ai, bi))),
                           ("im", ((ar, bi), (ai, br)))):
            for x, y in pairs:
                hh, lo = step_product(x, y, tf32x3)
                sums[key] = sums[key] + hh
                apart[key] = apart[key] + lo
    return sums["re"] + apart["re"], sums["im"] + apart["im"]


def component_formula(a, b):
    """numpy's complex product, by its component formula, summed over k:
    the rule of the plain versions (``bsr._component_matmul``)."""
    ar, ai = a.real[:, :, None], a.imag[:, :, None]
    br, bi = b.real[None], b.imag[None]
    return (ar * br - ai * bi).sum(1), (ar * bi + ai * br).sum(1)


def nonfinite_operands(dtype, k=16):
    """(a, b) of (12, k) and (k, 10) with inf, -inf, a -inf imaginary
    part and a nan, so that products give nan, +-inf of each sign and
    both in the same sum."""
    rng = np.random.default_rng(71)
    a = values(rng, (12, k), dtype)
    b = values(rng, (k, 10), dtype)
    a[1, 0] = np.inf
    a[3, 5] = complex(0.0, -np.inf)
    a[3, 6] = complex(-np.inf, 1.0)
    b[7, 2] = -np.inf
    b[k - 5, 6] = complex(2.0, np.inf)
    b[4, 8] = np.nan
    a[6, k - 3] = complex(np.inf, np.inf)
    return a, b


@pytest.mark.parametrize("product", ["spmm", "sddmm"])
def test_decomposition_keeps_the_component_formula_c128(product):
    """c128 on f64 MMA: the kernels' order of real products has numpy's
    component formula's nan / +inf / -inf in every part at inf and nan
    inputs, and its finite values at rtol 1e-12.  K8 (sddmm) runs it on
    G and conj(B)^T."""
    a, b = nonfinite_operands(np.complex128)
    if product == "sddmm":
        b = np.conj(b)  # the operand conj(B)^T of B's strip B = b^T
    with np.errstate(invalid="ignore", over="ignore"):
        got = np.stack(kernel_order(a, b), -1)
        want = np.stack(component_formula(a, b), -1)
    assert np.isnan(want).any() and np.isposinf(want).any()
    assert np.isneginf(want).any()
    for what in (np.isnan, np.isposinf, np.isneginf):
        npt.assert_array_equal(what(got), what(want))
    fin = np.isfinite(want)
    npt.assert_allclose(got[fin], want[fin], rtol=1e-12, atol=1e-12)


def test_decomposition_finite_values_c128():
    """Finite c128 operands: the kernels' order equals numpy's complex
    matmul at rtol 1e-12."""
    rng = np.random.default_rng(72)
    a, b = values(rng, (16, 48), np.complex128), values(
        rng, (48, 16), np.complex128)
    re, im = kernel_order(a, b)
    npt.assert_allclose(re + 1j * im, a @ b, rtol=1e-12, atol=1e-12)


def test_decomposition_keeps_the_component_formula_c64():
    """c64 on 3xTF32: the same pattern at inf and nan (hi inf or nan
    leaves lo and the cross products' hi at 0, so no inf * 0 appears that
    the formula lacks), finite values at f32's tolerance."""
    a, b = nonfinite_operands(np.complex64)
    with np.errstate(invalid="ignore", over="ignore"):
        got = np.stack(kernel_order(a, b, tf32x3=True), -1)
        want = np.stack(component_formula(a.astype(np.complex128),
                                          b.astype(np.complex128)), -1)
    for what in (np.isnan, np.isposinf, np.isneginf):
        npt.assert_array_equal(what(got), what(want))
    fin = np.isfinite(want)
    scale = np.abs(want[fin]).max()
    npt.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_spmm_keeps_the_component_formula_at_inf(dtype):
    """``bsr_spmm_plain`` (and its batched form) on complex values has the
    component formula's nan, +inf and -inf parts: its one matmul runs on
    real and imaginary parts side by side, as K1's variants compute."""
    bs = 8
    indptr, indices = np.array([0, 2, 3]), np.array([0, 1, 1])
    a, b = nonfinite_operands(dtype, k=bs)
    rng = np.random.default_rng(73)
    data = values(rng, (3, bs, bs), dtype)
    data[0] = a[:bs]
    bmat = values(rng, (2 * bs, 10), dtype)
    bmat[:bs] = b
    args = [torch.tensor(x) for x in (indptr, indices, data, bmat)]
    out = bsr.bsr_spmm_plain(*args)
    batched = bsr.bsr_spmm_batched_plain(args[0], args[1], args[2][None],
                                         args[3])
    want = np.zeros((2, bs, 10, 2))  # stored blocks only, as A @ b reads
    with np.errstate(invalid="ignore", over="ignore"):
        for r in range(2):
            for p in range(indptr[r], indptr[r + 1]):
                panel = bmat[indices[p] * bs:(indices[p] + 1) * bs]
                want[r] += np.stack(component_formula(
                    data[p].astype(np.complex128),
                    panel.astype(np.complex128)), -1)
    want = want.reshape(2 * bs, 10, 2)
    assert np.isinf(want).any() and np.isnan(want).any()
    for got in (out, batched[0]):
        got = torch.view_as_real(got).numpy()
        for what in (np.isnan, np.isposinf, np.isneginf):
            npt.assert_array_equal(what(got), what(want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nonfinite", ["none", "a", "b"])
def test_component_matmul_routes(nonfinite, dtype):
    """``bsr._component_matmul`` takes the complex product on finite
    operands and the parts' real product when either operand holds a value
    that is not finite: both give the component formula's values, and its
    nan, +inf and -inf parts wherever ``a`` or ``b`` alone is not finite.
    (The CPU's complex product keeps that pattern too; cuBLAS's does not,
    and ``chip_smoke.py``'s K1 inf check holds the route there.)"""
    a, b = nonfinite_operands(dtype)
    rng = np.random.default_rng(75)
    if nonfinite != "a":
        a = values(rng, a.shape, dtype)
    if nonfinite != "b":
        b = values(rng, b.shape, dtype)
    got = torch.view_as_real(bsr._component_matmul(
        torch.tensor(a), torch.tensor(b))).numpy()
    with np.errstate(invalid="ignore", over="ignore"):
        want = np.stack(component_formula(a.astype(np.complex128),
                                          b.astype(np.complex128)), -1)
    assert np.isinf(want).any() == (nonfinite != "none")
    for what in (np.isnan, np.isposinf, np.isneginf):
        npt.assert_array_equal(what(got), what(want))
    fin = np.isfinite(want)
    rtol, atol = TOL[np.dtype(dtype)]
    npt.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# Against the JAX package at bs 8 and 16
# ---------------------------------------------------------------------------


def complex_bsr(rng, bs, dtype, nbrows=5, nbcols=4):
    """scipy BSR with block rows of 0 to 4 blocks (one empty) in bs x bs
    blocks."""
    lengths = rng.integers(0, 5, nbrows)
    lengths[2] = 0
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    indices = np.concatenate([np.sort(rng.choice(nbcols, n, replace=False))
                              for n in lengths]).astype(np.int64)
    data = values(rng, (indptr[-1], bs, bs), dtype)
    return sps.bsr_matrix((data, indices, indptr),
                          shape=(nbrows * bs, nbcols * bs))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bs", BLOCK_SIZES)
def test_dot_product_matches_jax(bs, dtype):
    """``dot_product`` of a complex BSR and a dense block, and with
    ``out`` and a complex ``out_scalar``, equals the JAX package's."""
    rng = np.random.default_rng(bs)
    a = complex_bsr(rng, bs, dtype)
    b = values(rng, (a.shape[1], N), dtype)
    close(sdtt.dot_product(a, b), sdt.dot_product(a, b), dtype)
    out = values(rng, (a.shape[0], N), dtype)
    port = sdtt.dot_product(a, b, out=out.copy(), out_scalar=0.5 - 1.5j)
    ref = sdt.dot_product(a, b, out=out.copy(), out_scalar=0.5 - 1.5j)
    close(port, ref, dtype)


def coordinates(a):
    """(blocks, block rows, block cols, m) of a scipy BSR, as
    ``ops.bsr_spmm`` and ``_xla.bsr_spmm`` take them."""
    bs = a.blocksize[0]
    rows = np.repeat(np.arange(a.shape[0] // bs), np.diff(a.indptr))
    return a.data, rows, a.indices, a.shape[0]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bs", BLOCK_SIZES)
def test_block_gradient_matches_jax(bs, dtype):
    """Gradients of sum |alpha A b + beta c0|^2 in the blocks and b (the
    blocks' by K8's plain version, b's by K1's over A^H) equal the
    conjugate of ``jax.grad`` of ``_xla.bsr_spmm``."""
    rng = np.random.default_rng(10 + bs)
    data, rows, cols, m = coordinates(complex_bsr(rng, bs, dtype))
    b = values(rng, (4 * bs, N), dtype)
    c0 = values(rng, (m, N), dtype)
    alpha = 1.5 - 0.5j
    jr, jc = jnp.asarray(rows), jnp.asarray(cols)

    def jax_loss(d, bb):
        c = _xla.bsr_spmm(d, jr, jc, bb, m, alpha=alpha, beta=-0.5,
                          c0=jnp.asarray(c0))
        return jnp.sum(jnp.abs(c) ** 2)

    refs = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(data),
                                              jnp.asarray(b))
    leaves = [torch.tensor(x, requires_grad=True) for x in (data, b)]
    c = bsr_spmm(leaves[0], torch.tensor(rows), torch.tensor(cols),
                 leaves[1], m, alpha, -0.5, torch.tensor(c0))
    (c.abs() ** 2).sum().backward()
    for leaf, ref in zip(leaves, refs):
        close(leaf.grad, np.conj(np.asarray(ref)), dtype)


@pytest.fixture
def batched_calls(monkeypatch):
    """Calls of ``bsr``'s four wrappers that the Functions make."""
    counts = collections.Counter()
    for name in ("spmm", "spmm_batched", "sddmm", "sddmm_batched"):
        def counted(*args, _fn=getattr(bsr, name), _key=name, **kwargs):
            counts[_key] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(bsr, name, counted)
    return counts


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bs", BLOCK_SIZES)
@pytest.mark.parametrize("over", ["blocks", "b"])
def test_block_gradient_under_vmap_matches_jax(over, bs, dtype,
                                               batched_calls):
    """``vmap(grad)`` of sum |A b|^2 in the blocks over 3 block sets (or
    3 b's) equals the conjugate of ``jax.vmap(jax.grad)``: one batched
    K8 call for the whole batch."""
    rng = np.random.default_rng(20 + bs)
    data, rows, cols, m = coordinates(complex_bsr(rng, bs, dtype))
    b = values(rng, (4 * bs, N), dtype)
    if over == "blocks":
        data = np.stack([data, 0.5 * data[::-1].copy(), 1j * data])
        dims = (0, None)
    else:
        b = np.stack([b, values(rng, b.shape, dtype), 2.0 * b])
        dims = (None, 0)
    tr, tc = torch.tensor(rows), torch.tensor(cols)
    jr, jc = jnp.asarray(rows), jnp.asarray(cols)
    grads = torch.func.vmap(torch.func.grad(
        lambda d, bb: (bsr_spmm(d, tr, tc, bb, m).abs() ** 2).sum()),
        in_dims=dims)(torch.tensor(data), torch.tensor(b))
    refs = jax.vmap(jax.grad(
        lambda d, bb: jnp.sum(jnp.abs(_xla.bsr_spmm(d, jr, jc, bb, m)) ** 2)),
        in_axes=dims)(jnp.asarray(data), jnp.asarray(b))
    close(grads, np.conj(np.asarray(refs)), dtype)
    assert batched_calls["sddmm_batched"] == 1
    assert batched_calls["sddmm"] == 0
