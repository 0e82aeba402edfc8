"""Gradients of the port's sparse x sparse product with dense output
(``ops.spgemm.csr_spgemm_dense`` through ``ops.autograd.CsrSpgemmDense``)
against a numpy oracle and against ``jax.grad`` of the JAX package's
``_xla.spgemm_numeric_sorted``.

For C = alpha op(A) op(B) + beta c0 and G = dL/dC, the gradient in op(A)'s
values is conj(alpha) (G' op(B)^H) at op(A)'s pattern, in op(B)'s values
conj(alpha) (op(A)^H G') at op(B)'s pattern, with G' = G, or its upper
triangle under ``triangular`` (the product keeps only j >= i there while c0
is added everywhere), and in c0 conj(beta) G.  On the CPU the Function runs
the plain versions of K6 and K9; ``chip_smoke.py`` runs the same graph on
the kernels.

Tolerances: rtol 1e-12 (atol 1e-12) against the numpy oracle in float64
and complex128.  Against JAX rtol 1e-6, with atol 1e-6 of the largest
gradient: the JAX package's float64 gradient goes through
``densify_sorted``'s hi|lo float32 limbs (``sorted_set_scatter``) and is
only float32-accurate (about 5e-8 of the gradient's scale), while its
forward is exact; the port does not copy that.
"""

import numpy as np
import numpy.testing as npt
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

import sparse_dot_tpu  # noqa: F401  (enables x64 before any JAX array)
from sparse_dot_tpu.ops import _xla

from sparse_dot_tpu_torch.config import config
from sparse_dot_tpu_torch.ops import spgemm, spgemm_grad

M, K, N = 7, 9, 8


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless asked otherwise; these tests ask
    for the CPU, where its wrappers take their plain versions.  Each runs
    thousands of small torch operations (``gradcheck``), whose parallel
    regions stall when the test processes share the cores: one intra-op
    thread while it runs."""
    saved = config.device, torch.get_num_threads()
    config.device = "cpu"
    torch.set_num_threads(1)
    yield
    config.device = saved[0]
    torch.set_num_threads(saved[1])


def close(port, ref, rtol=1e-12, atol=1e-12):
    if isinstance(port, torch.Tensor):
        port = port.detach().numpy()
    npt.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol)


def values(rng, size, dtype):
    v = rng.standard_normal(size)
    if np.dtype(dtype).kind == "c":
        v = v + 1j * rng.standard_normal(size)
    return v.astype(dtype)


def operands(dtype, seed, shuffle=False):
    """Random CSR op(A) (M x K) and op(B) (K x N) with an empty row each;
    with ``shuffle`` op(B)'s rows list their entries in a random order."""
    rng = np.random.default_rng(seed)
    a = sps.random(M, K, density=0.4, format="csr", random_state=seed)
    b = sps.random(K, N, density=0.4, format="csr", random_state=seed + 1)
    a, b = (x.tolil() for x in (a, b))
    a[3, :] = 0
    b[2, :] = 0
    a, b = (x.tocsr().astype(dtype) for x in (a, b))
    for x in (a, b):
        x.data = values(rng, x.nnz, dtype)
    if shuffle:
        for r in range(K):
            lo, hi = b.indptr[r], b.indptr[r + 1]
            perm = lo + rng.permutation(hi - lo)
            b.indices[lo:hi], b.data[lo:hi] = b.indices[perm], b.data[perm]
    return a, b


def arrays(x, requires_grad=True):
    return (torch.tensor(x.indptr), torch.tensor(x.indices),
            torch.tensor(x.data, requires_grad=requires_grad))


def sampled(dense, x):
    """``dense`` at the entries of CSR x, in x's stored order."""
    rows = np.repeat(np.arange(x.shape[0]), np.diff(x.indptr))
    return dense[rows, x.indices]


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("triangular", [False, True])
@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_grads_match_numpy_oracle(dtype, triangular, epilogue, shuffle):
    """The gradients in op(A)'s values, op(B)'s values (in the caller's
    order, op(B)'s rows shuffled and ``b_sorted=False``) and c0, and the
    result, against the numpy oracle."""
    a, b = operands(dtype, 40, shuffle)
    rng = np.random.default_rng(41)
    w = values(rng, (M, N), dtype)
    c0 = values(rng, (M, N), dtype)
    complex_ = np.dtype(dtype).kind == "c"
    alpha = (1.5 - 0.5j if complex_ else 1.5) if epilogue else None
    beta = (0.25 + 1j if complex_ else -0.5) if epilogue else None
    a_ip, a_ix, a_dv = arrays(a)
    b_ip, b_ix, b_dv = arrays(b)
    tc0 = torch.tensor(c0, requires_grad=True) if epilogue else None
    c = spgemm.csr_spgemm_dense(a_ip, a_ix, a_dv, b_ip, b_ix, b_dv, N,
                                alpha, beta, tc0, triangular,
                                b_sorted=not shuffle)
    assert type(c.grad_fn).__name__ == "CsrSpgemmDenseBackward"
    al = 1.0 if alpha is None else alpha
    prod = (a @ b).toarray()
    ref = al * (np.triu(prod) if triangular else prod)
    if epilogue:
        ref = ref + beta * c0
    close(c, ref)
    c.backward(torch.tensor(w))
    g = np.triu(w) if triangular else w
    close(a_dv.grad, np.conj(al) * sampled(g @ b.toarray().conj().T, a))
    close(b_dv.grad, np.conj(al) * sampled(a.toarray().conj().T @ g, b))
    if epilogue:
        close(tc0.grad, np.conj(beta) * w)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("triangular", [False, True])
def test_grads_match_jax(dtype, triangular):
    """The gradients of sum(Re(C conj(W))) in both operands' values equal
    the conjugate of ``jax.grad`` of ``spgemm_numeric_sorted`` over the
    same sorted operands, at float32 level (module docstring)."""
    a, b = operands(dtype, 42)
    w = values(np.random.default_rng(43), (M, N), dtype)
    a_flat = np.repeat(np.arange(M), np.diff(a.indptr)) * K + a.indices
    b_flat = np.repeat(np.arange(K), np.diff(b.indptr)) * N + b.indices

    def jax_loss(av, bv):
        c = _xla.spgemm_numeric_sorted(
            jnp.asarray(a_flat), av, jnp.asarray(b_flat), bv, M, K, N,
            triangular=triangular)
        return jnp.sum(jnp.real(c * jnp.conj(jnp.asarray(w))))

    ga, gb = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(a.data),
                                                jnp.asarray(b.data))
    a_ip, a_ix, a_dv = arrays(a)
    b_ip, b_ix, b_dv = arrays(b)
    c = spgemm.csr_spgemm_dense(a_ip, a_ix, a_dv, b_ip, b_ix, b_dv, N,
                                triangular=triangular, b_sorted=True)
    (c * torch.tensor(w).conj()).real.sum().backward()
    for port, ref in ((a_dv.grad, ga), (b_dv.grad, gb)):
        ref = np.conj(np.asarray(ref))
        close(port, ref, 1e-6, 1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("triangular", [False, True])
def test_gradcheck_with_forward_ad(dtype, triangular):
    """``torch.autograd.gradcheck`` in both operands' values and c0 (with
    alpha and beta), reverse and forward mode."""
    npdt = np.dtype(str(dtype).removeprefix("torch."))
    a, b = operands(npdt, 44, shuffle=True)
    a_ip, a_ix, a_dv = arrays(a)
    b_ip, b_ix, b_dv = arrays(b)
    c0 = torch.tensor(values(np.random.default_rng(45), (M, N), npdt),
                      requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda av, bv, cc: spgemm.csr_spgemm_dense(
            a_ip, a_ix, av, b_ip, b_ix, bv, N, 2.0, -0.5, cc, triangular),
        (a_dv, b_dv, c0), check_forward_ad=True)


def test_second_order_raises():
    """The backward is once-differentiable: differentiating a gradient
    raises, through ``torch.autograd`` and through ``torch.func``."""
    a, b = operands(np.float64, 46)
    a_ip, a_ix, a_dv = arrays(a)
    b_ip, b_ix, b_dv = arrays(b, requires_grad=False)

    def f(av):
        return (spgemm.csr_spgemm_dense(a_ip, a_ix, av, b_ip, b_ix, b_dv,
                                        N) ** 2).sum()

    (g,) = torch.autograd.grad(f(a_dv), a_dv, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.sum().backward()
    with pytest.raises(RuntimeError, match="once_differentiable"):
        torch.func.grad(lambda av: torch.func.grad(f)(av).sum())(
            a_dv.detach())


def test_func_grad_and_vmap():
    """``torch.func.grad`` in both operands' values, and ``vmap`` of it
    over a batch of weights (each member's gradient, K9 once a member),
    equal the autograd gradients; ``vmap`` over op(A)'s values equals the
    products one by one."""
    a, b = operands(np.float64, 47)
    a_ip, a_ix, a_dv = arrays(a, requires_grad=False)
    b_ip, b_ix, b_dv = arrays(b, requires_grad=False)
    ws = torch.tensor(values(np.random.default_rng(48), (3, M, N),
                             np.float64))

    def loss(av, bv, w):
        c = spgemm.csr_spgemm_dense(a_ip, a_ix, av, b_ip, b_ix, bv, N,
                                    triangular=True)
        return (c * w).sum()

    grads = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)),
                            in_dims=(None, None, 0))(a_dv, b_dv, ws)
    for i in range(3):
        av, bv = a_dv.clone().requires_grad_(), b_dv.clone().requires_grad_()
        loss(av, bv, ws[i]).backward()
        close(grads[0][i], av.grad)
        close(grads[1][i], bv.grad)
        single = torch.func.grad(loss, argnums=(0, 1))(a_dv, b_dv, ws[i])
        close(single[0], av.grad)
        close(single[1], bv.grad)
    avs = torch.stack([a_dv, 2 * a_dv, -a_dv])
    out = torch.func.vmap(lambda av: spgemm.csr_spgemm_dense(
        a_ip, a_ix, av, b_ip, b_ix, b_dv, N))(avs)
    for i in range(3):
        close(out[i], spgemm.csr_spgemm_dense_plain(
            a_ip, a_ix, avs[i], b_ip, b_ix, b_dv, N))


def test_sgd_steps_match_jax():
    """Five SGD steps on ||op(A) op(B) - T||^2 in both operands' values,
    from zero values of op(A), through the port and through ``jax.grad``,
    give the same values and losses (at float32 level, as above)."""
    a, b = operands(np.float64, 49)
    target = (a @ b).toarray()
    a_flat = np.repeat(np.arange(M), np.diff(a.indptr)) * K + a.indices
    b_flat = np.repeat(np.arange(K), np.diff(b.indptr)) * N + b.indices
    lr = 0.05

    def jax_loss(av, bv):
        c = _xla.spgemm_numeric_sorted(jnp.asarray(a_flat), av,
                                       jnp.asarray(b_flat), bv, M, K, N)
        return jnp.sum((c - jnp.asarray(target)) ** 2)

    ja, jb = jnp.zeros(a.nnz), jnp.asarray(b.data)
    a_ip, a_ix, _ = arrays(a, requires_grad=False)
    b_ip, b_ix, b_dv = arrays(b)
    a_dv = torch.zeros(a.nnz, dtype=torch.float64, requires_grad=True)
    opt = torch.optim.SGD([a_dv, b_dv], lr=lr)
    for _ in range(5):
        opt.zero_grad()
        loss = ((spgemm.csr_spgemm_dense(a_ip, a_ix, a_dv, b_ip, b_ix, b_dv,
                                         N) - torch.tensor(target)) ** 2
                ).sum()
        loss.backward()
        opt.step()
        jl, (ga, gb) = jax.value_and_grad(jax_loss, argnums=(0, 1))(ja, jb)
        ja, jb = ja - lr * ga, jb - lr * gb
        close(loss.detach(), jl, 1e-6)
        close(a_dv.detach(), ja, 1e-6, 1e-9)
        close(b_dv.detach(), jb, 1e-6, 1e-9)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("transposed", [False, True])
def test_plain_sampled_product_against_dense_einsum(dtype, transposed):
    """``csr_spgemm_sddmm_plain`` equals alpha (D @ conj(Y)^T) at P's
    entries, read as (row, column) or, ``transposed``, as (column, row),
    with empty rows in P and in Y, and with every product in one chunk
    or in chunks of a few; ``csr_spgemm_sddmm`` on CPU tensors is the
    plain version and raises on a tracked operand."""
    rng = np.random.default_rng(50)
    p = sps.random(6, 5, density=0.5, format="csr", random_state=51)
    y = sps.random(6 if transposed else 5, 9, density=0.4, format="csr",
                   random_state=52).tolil()
    y[1, :] = 0
    y = y.tocsr().astype(dtype)
    y.data = values(rng, y.nnz, dtype)
    d = values(rng, (5 if transposed else 6, 9), dtype)
    alpha = 0.5 - 1j if np.dtype(dtype).kind == "c" else -0.5
    dense = alpha * d @ y.toarray().conj().T
    rows = np.repeat(np.arange(6), np.diff(p.indptr))
    r, q = (p.indices, rows) if transposed else (rows, p.indices)
    args = (torch.tensor(p.indptr), torch.tensor(p.indices), torch.tensor(d),
            torch.tensor(y.indptr), torch.tensor(y.indices),
            torch.tensor(y.data), alpha, transposed)
    close(spgemm_grad.csr_spgemm_sddmm_plain(*args), dense[r, q])
    close(spgemm_grad.csr_spgemm_sddmm(*args), dense[r, q])
    saved = config.spmm_chunk_elements
    try:
        config.spmm_chunk_elements = 3
        close(spgemm_grad.csr_spgemm_sddmm_plain(*args), dense[r, q])
    finally:
        config.spmm_chunk_elements = saved
    with pytest.raises(ValueError, match="carries no gradient"):
        spgemm_grad.csr_spgemm_sddmm(*args[:2], args[2].requires_grad_(),
                                     *args[3:])


def test_sampled_lanes():
    """K9's lanes: the power of two at or above half the mean row of Y,
    1 to 32."""
    assert [spgemm_grad.sampled_lanes(x) for x in
            (0, 1, 2, 3, 5, 16, 63, 64, 106, 5000)] == [1, 1, 1, 2, 4, 8,
                                                        32, 32, 32, 32]
