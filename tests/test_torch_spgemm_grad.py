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
the kernels.  Second derivatives run K6 and K9 again (``CsrSpgemmSddmm``'s
backward and ``jvp``); they are held to ``jax.hessian`` of
``spgemm_numeric_sorted``, to torch's own Hessian through dense matrices
scattered from the values, and to ``gradgradcheck``.

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
from sparse_dot_tpu_torch import formats
from sparse_dot_tpu_torch.ops import autograd, spgemm, spgemm_grad

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


def hvp_along(loss, primals, u, how):
    """The Hessian-vector products of ``loss`` at the numpy ``primals``
    along the directions ``u``: by double backward (``create_graph``), or
    with ``how="grad_of_grad"`` by ``torch.func.grad`` of
    ``torch.func.grad`` (no guard left to stop it, nor zeros)."""
    us = [torch.tensor(w) for w in u]
    argnums = tuple(range(len(primals)))
    if how == "grad_of_grad":
        def dot(*xs):
            grads = torch.func.grad(loss, argnums=argnums)(*xs)
            return sum((g * w).sum() for g, w in zip(grads, us))

        return torch.func.grad(dot, argnums=argnums)(
            *map(torch.tensor, primals))
    leaves = [torch.tensor(x, requires_grad=True) for x in primals]
    grads = torch.autograd.grad(loss(*leaves), leaves, create_graph=True)
    return torch.autograd.grad(
        sum((g * w).sum() for g, w in zip(grads, us)), leaves)


def hessian_problem(seed, triangular):
    """(port loss, JAX loss, plain-torch loss, op(A), op(B)) of the
    non-quadratic loss sum(sin(C)) for C = op(A) op(B) (its upper
    triangle under ``triangular``) in both operands' values, f64:
    through ``csr_spgemm_dense``, through ``spgemm_numeric_sorted`` over
    the same sorted operands, and through dense matrices scattered from
    the values in plain torch (no port Function)."""
    a, b = operands(np.float64, seed)
    a_ip, a_ix, _ = arrays(a, requires_grad=False)
    b_ip, b_ix, _ = arrays(b, requires_grad=False)
    a_flat = np.repeat(np.arange(M), np.diff(a.indptr)) * K + a.indices
    b_flat = np.repeat(np.arange(K), np.diff(b.indptr)) * N + b.indices

    def port_loss(av, bv):
        return torch.sin(spgemm.csr_spgemm_dense(
            a_ip, a_ix, av, b_ip, b_ix, bv, N, triangular=triangular,
            b_sorted=True)).sum()

    def jax_loss(av, bv):
        return jnp.sum(jnp.sin(_xla.spgemm_numeric_sorted(
            jnp.asarray(a_flat), av, jnp.asarray(b_flat), bv, M, K, N,
            triangular=triangular)))

    def dense_loss(av, bv):
        da = torch.zeros(M * K, dtype=av.dtype).scatter(
            0, torch.tensor(a_flat), av).view(M, K)
        db = torch.zeros(K * N, dtype=bv.dtype).scatter(
            0, torch.tensor(b_flat), bv).view(K, N)
        c = da @ db
        return torch.sin(torch.triu(c) if triangular else c).sum()

    return port_loss, jax_loss, dense_loss, a, b


def jax_close(port, ref):
    """At the JAX package's float32-accurate level (module docstring)."""
    ref = np.asarray(ref)
    close(port, ref, 1e-6, 1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("triangular", [False, True])
@pytest.mark.parametrize("how", ["hessian", "double_backward",
                                 "grad_of_grad"])
def test_hessian_matches_jax(how, triangular):
    """Second derivatives in both operands' values of a non-quadratic loss
    through ``csr_spgemm_dense`` equal ``jax.hessian``'s of
    ``spgemm_numeric_sorted`` at rtol 1e-6 (its f64 gradient is f32-
    accurate) and torch's own Hessian through dense matrices scattered
    from the values at rtol 1e-10: the whole Hessian by
    ``torch.func.hessian`` (forward over reverse, with no guard left: its
    mixed block is nonzero), or Hessian-vector products along a random
    direction by double backward and by ``torch.func.grad`` of ``grad``;
    the backward's own derivatives run K6 and K9 again
    (``CsrSpgemmSddmm``'s backward)."""
    port_loss, jax_loss, dense_loss, a, b = hessian_problem(50, triangular)
    primals = (a.data, b.data)
    jh = jax.hessian(jax_loss, argnums=(0, 1))(*map(jnp.asarray, primals))
    dh = torch.func.hessian(dense_loss, argnums=(0, 1))(
        *map(torch.tensor, primals))
    assert np.abs(dh[0][1].numpy()).max() > 0.1
    if how == "hessian":
        th = torch.func.hessian(port_loss, argnums=(0, 1))(
            *map(torch.tensor, primals))
        for i in range(2):
            for j in range(2):
                jax_close(th[i][j], jh[i][j])
                close(th[i][j], dh[i][j], 1e-10, 1e-12)
        return
    rng = np.random.default_rng(51)
    u = [values(rng, x.shape, np.float64) for x in primals]
    for i, got in enumerate(hvp_along(port_loss, primals, u, how)):
        jax_close(got, sum(np.asarray(jh[i][j]) @ u[j] for j in range(2)))
        close(got, sum(dh[i][j].numpy() @ u[j] for j in range(2)), 1e-10,
              1e-12)


@pytest.mark.parametrize("triangular", [False, True])
def test_jvp_of_grad_matches_jax(triangular):
    """``torch.func.jvp`` of ``torch.func.grad`` (forward over reverse:
    ``CsrSpgemmSddmm``'s ``jvp``) equals ``jax.jvp`` of ``jax.grad`` at
    rtol 1e-6 and the same through the plain-torch dense loss at 1e-10."""
    port_loss, jax_loss, dense_loss, a, b = hessian_problem(52, triangular)
    primals = (a.data, b.data)
    u = [values(np.random.default_rng(53), x.shape, np.float64)
         for x in primals]

    def forward_over_reverse(loss):
        return torch.func.jvp(torch.func.grad(loss, argnums=(0, 1)),
                              tuple(map(torch.tensor, primals)),
                              tuple(map(torch.tensor, u)))[1]

    _, ref = jax.jvp(jax.grad(jax_loss, argnums=(0, 1)),
                     tuple(map(jnp.asarray, primals)),
                     tuple(map(jnp.asarray, u)))
    for got, r, d in zip(forward_over_reverse(port_loss), ref,
                         forward_over_reverse(dense_loss)):
        jax_close(got, r)
        close(got, d, 1e-10, 1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("case", ["sorted", "triangular", "shuffled"])
def test_gradgradcheck(case, dtype):
    """``torch.autograd.gradgradcheck`` (with forward over reverse) in
    both operands' values and c0, with alpha and beta (complex in c128),
    with and without ``triangular``, and with ``b_sorted=False`` over
    op(B) whose rows list their entries shuffled: K9's derivative in d
    is K6 over op(B) in the caller's order, which must not be read as
    sorted."""
    npdt = np.dtype(str(dtype).removeprefix("torch."))
    a, b = operands(npdt, 54, shuffle=case == "shuffled")
    a_ip, a_ix, a_dv = arrays(a)
    b_ip, b_ix, b_dv = arrays(b)
    c0 = torch.tensor(values(np.random.default_rng(55), (M, N), npdt),
                      requires_grad=True)
    alpha, beta = (1.5 - 0.5j, 0.25 + 1j) if npdt.kind == "c" else (2.0,
                                                                   -0.5)
    assert torch.autograd.gradgradcheck(
        lambda av, bv, cc: spgemm.csr_spgemm_dense(
            a_ip, a_ix, av, b_ip, b_ix, bv, N, alpha, beta, cc,
            case == "triangular", b_sorted=case == "sorted"),
        (a_dv, b_dv, c0), check_fwd_over_rev=True)


def test_first_order_launches_unchanged(monkeypatch):
    """One first-order backward in both operands' values and c0 calls
    K9's plain version twice and K6's not at all, sorts op(B) no more,
    as before second order was added, and builds no graph: its
    gradients carry no ``grad_fn``."""
    a, b = operands(np.float64, 56, shuffle=True)
    a_ip, a_ix, a_dv = arrays(a)
    b_ip, b_ix, b_dv = arrays(b)
    c0 = torch.tensor(values(np.random.default_rng(57), (M, N), np.float64),
                      requires_grad=True)
    calls = []
    for module, name in ((spgemm, "csr_spgemm_dense_plain"),
                         (spgemm_grad, "csr_spgemm_sddmm_plain"),
                         (formats, "sorted_unique_columns")):
        real = getattr(module, name)

        def counted(*args, name=name, real=real):
            calls.append(name)
            return real(*args)

        monkeypatch.setattr(module, name, counted)
    autograd.patterns.clear()
    c = spgemm.csr_spgemm_dense(a_ip, a_ix, a_dv, b_ip, b_ix, b_dv, N, 2.0,
                                0.5, c0, True)
    assert sorted(calls) == ["csr_spgemm_dense_plain",
                             "sorted_unique_columns"]
    calls.clear()
    grads = torch.autograd.grad(torch.sin(c).sum(), (a_dv, b_dv, c0))
    assert calls == ["csr_spgemm_sddmm_plain"] * 2
    assert all(g.grad_fn is None for g in grads)


def test_func_grad_and_vmap():
    """``torch.func.grad`` in both operands' values, and ``vmap`` of it
    over a batch of weights (each member's gradient, one batched K9 call),
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


@pytest.mark.parametrize("with_alpha", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64,
                                   np.complex128])
@pytest.mark.parametrize("transposed", [False, True])
def test_plain_sampled_product_against_dense_einsum(dtype, transposed,
                                                    with_alpha):
    """``csr_spgemm_sddmm_plain`` in both forms against a dense einsum:
    the dA form (``sampled_rows_plain``) equals alpha (D @ conj(Y)^T) at
    P's entries, the dB form (``transposed``, ``sampled_cols_plain``)
    alpha (conj(Y) @ D) at P's entries, with empty rows in P and in Y,
    and with every product in one chunk or in chunks of a few;
    ``csr_spgemm_sddmm`` on CPU tensors is the plain version and raises
    on a tracked operand.  rtol 1e-12 (1e-5 in f32 and c64)."""
    rng = np.random.default_rng(50)
    p = sps.random(6, 5, density=0.5, format="csr", random_state=51)
    y = sps.random(6 if transposed else 5, 9, density=0.4, format="csr",
                   random_state=52).tolil()
    y[1, :] = 0
    y = y.tocsr().astype(dtype)
    y.data = values(rng, y.nnz, dtype)
    d = values(rng, (9, 5) if transposed else (6, 9), dtype)
    alpha = None
    if with_alpha:
        alpha = 0.5 - 1j if np.dtype(dtype).kind == "c" else -0.5
    dense = np.einsum("qi,is->qs" if transposed else "rs,qs->rq",
                      y.toarray().conj() if transposed else d,
                      d if transposed else y.toarray().conj())
    dense = dense * (1 if alpha is None else alpha)
    rows = np.repeat(np.arange(6), np.diff(p.indptr))
    ref = dense[rows, p.indices]
    tol = 1e-5 if dtype in (np.float32, np.complex64) else 1e-12
    args = (torch.tensor(p.indptr), torch.tensor(p.indices), torch.tensor(d),
            torch.tensor(y.indptr), torch.tensor(y.indices),
            torch.tensor(y.data), alpha, transposed)
    plain = (spgemm_grad.sampled_cols_plain if transposed
             else spgemm_grad.sampled_rows_plain)
    close(plain(*args[:7]), ref, tol, tol)
    close(spgemm_grad.csr_spgemm_sddmm_plain(*args), ref, tol, tol)
    close(spgemm_grad.csr_spgemm_sddmm(*args), ref, tol, tol)
    saved = config.spmm_chunk_elements
    try:
        config.spmm_chunk_elements = 3
        close(spgemm_grad.csr_spgemm_sddmm_plain(*args), ref, tol, tol)
    finally:
        config.spmm_chunk_elements = saved
    with pytest.raises(ValueError, match="carries no gradient"):
        spgemm_grad.csr_spgemm_sddmm(*args[:2], args[2].requires_grad_(),
                                     *args[3:])


@pytest.mark.parametrize("case", ["dB_with_gt", "dA_y_past_d",
                                  "dA_p_past_y"])
def test_sampled_product_refuses_operands_that_do_not_fit(case):
    """``csr_spgemm_sddmm`` raises ``ValueError`` on the CPU, as on the
    card, where K9 would read past d or Y: the dB form given G^T (its
    old convention) in place of G, Y's column ids past d's columns, and
    P's column ids past Y's rows.  With operands that fit, the same call
    equals the plain version."""
    a = sps.random(6, 5, density=0.6, format="lil", random_state=60)
    a[5, 0] = a[0, 4] = 1.0
    a = a.tocsr()
    b = sps.random(5, 4, density=0.6, format="csr", random_state=61)
    g = torch.tensor(np.random.default_rng(62).standard_normal((6, 4)))

    def arrays(x):
        return (torch.tensor(x.indptr), torch.tensor(x.indices),
                torch.tensor(x.data))

    if case == "dB_with_gt":  # P = B, Y = A^T: G^T is (4, 6), G (6, 4)
        p, y, transposed = arrays(b), arrays(a.T.tocsr()), True
        bad, match = g.mT.contiguous(), "takes d = G, not G"
    elif case == "dA_y_past_d":  # P = A, Y = B: d of 3 columns, not 4
        p, y, transposed = arrays(a), arrays(b), False
        bad, match = g[:, :3].contiguous(), "Y's column ids span"
    else:  # P = A, Y = B's first 4 rows: A names row 4
        p, y, transposed = arrays(a), arrays(b[:4]), False
        bad, match = g, "P's column ids span"
    with pytest.raises(ValueError, match=match):
        spgemm_grad.csr_spgemm_sddmm(*p[:2], bad, *y, None, transposed)
    if case != "dA_p_past_y":
        args = (*p[:2], g, *y, None, transposed)
        close(spgemm_grad.csr_spgemm_sddmm(*args),
              spgemm_grad.csr_spgemm_sddmm_plain(*args))


def test_sampled_lanes():
    """K9's lanes: the power of two at or above half the mean row of Y,
    1 to 32."""
    assert [spgemm_grad.sampled_lanes(x) for x in
            (0, 1, 2, 3, 5, 16, 63, 64, 106, 5000)] == [1, 1, 1, 2, 4, 8,
                                                        32, 32, 32, 32]


@pytest.mark.parametrize("line, itemsize, mean_row, columns, budget, want", [
    # The demo's X @ X.T (lines of 500 f64): 28 lines in the default
    # budget, 32 in the widest, rows or columns alike.
    (500, 8, 106, False, None, (32, 28, True, 501)),
    (500, 8, 106, True, None, (32, 28, True, 501)),
    (500, 8, 106, False, 200 * 1024, (32, 32, True, 501)),
    # Config 3's BSR x BSR (lines of 8192): fewer than 4 fit, so rows in
    # panels of 8 read in place, columns in panels of 32 with a lane an
    # entry, unless the budget holds 4 or more.
    (8192, 8, 410, False, None, (32, 8, False, 0)),
    (8192, 8, 410, True, None, (32, 32, False, 0)),
    (8192, 8, 410, False, 200 * 1024, (32, 8, False, 0)),
    (8192, 4, 410, True, 200 * 1024, (32, 6, True, 8193)),
    (100_000, 8, 3, False, None, (2, 8, False, 0)),
    (100_000, 8, 3, True, None, (32, 32, False, 0)),
    (7, 16, 1, False, 0, (1, 8, False, 0)),
])
def test_sampled_plan(line, itemsize, mean_row, columns, budget, want):
    """K9's plan: ``sampled_lanes`` lanes, as many lines of D as fit the
    budget at an odd pitch (32 at most) where 4 or more do; else rows in
    panels of 8 read through L1, columns in panels of 32 with a lane an
    entry; the blocks an SM holds (two of 512 threads at most) follow the
    staged panel's bytes."""
    plan = spgemm_grad.sampled_plan(line, itemsize, mean_row, columns,
                                    budget)
    assert tuple(plan) == want
    blocks = spgemm_grad.sampled_blocks_per_sm(plan, itemsize)
    if plan.staged:
        assert plan.pitch % 2 == 1 and plan.pitch >= line
        smem = plan.panel * plan.pitch * itemsize
        assert smem <= (spgemm_grad.SAMPLED_SMEM if budget is None
                        else budget)
        assert 1 <= blocks <= 2  # two blocks of 512 threads an SM
        assert blocks * smem <= 227 * 1024
    else:
        assert blocks == 2


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("panel", [1, 3, 32])
@pytest.mark.parametrize("target", [1, 7, 1000])
def test_sampled_runs_cover_every_entry_once(transposed, panel, target):
    """K9's runs hold every entry of P once; a run's entries share a
    panel of lines and a row of Y; a work item's runs share a panel and
    start within one span of ``chunk`` entries of it, the smallest span
    that makes at most ``target`` items (one a panel where the panels are
    more)."""
    p = sps.random(40, 30, density=0.3, format="csr", random_state=7)
    ip, ix = (torch.tensor(x, dtype=torch.int32)
              for x in (p.indptr, p.indices))
    y_rows = 40 if transposed else 30
    runs = spgemm_grad.sampled_runs(ip, ix, transposed, panel, y_rows,
                                    target)
    line, q = (x.long() for x in spgemm_grad.entry_ids(ip, ix, transposed))
    perm = runs.perm.long()
    assert runs.perm.dtype == runs.run_ptr.dtype == torch.int32
    assert sorted(perm.tolist()) == list(range(p.nnz))
    assert torch.equal(runs.line.long(), line[perm])
    ptr = runs.run_ptr.long()
    assert ptr[0] == 0 and ptr[-1] == p.nnz and bool((ptr.diff() > 0).all())
    for r in range(len(ptr) - 1):
        seg = perm[ptr[r]:ptr[r + 1]]
        assert bool((q[seg] == runs.run_q[r].long()).all())
        assert len(set((line[seg] // panel).tolist())) == 1
    sizes = np.bincount((line // panel).numpy())
    sizes = sizes[sizes > 0]
    spans = -(-sizes // runs.chunk)
    assert spans.sum() <= target or runs.chunk == sizes.max()
    assert runs.chunk == 1 or (-(-sizes // (runs.chunk - 1))).sum() > target
    items = runs.items.tolist()
    assert items[0] == 0 and items[-1] == len(ptr) - 1
    panels = (line[perm[ptr[:-1]]] // panel).tolist()
    first = {}
    for r, pnl in enumerate(panels):
        first.setdefault(pnl, int(ptr[r]))
    for a, b in zip(items, items[1:]):
        assert b > a and len(set(panels[a:b])) == 1
        spans = {(int(ptr[r]) - first[panels[r]]) // runs.chunk
                 for r in range(a, b)}
        assert len(spans) == 1
    assert len(items) - 1 <= max(target, len(sizes))


def repeated_b():
    """op(A) (3 x 4) with distinct columns a row, and op(B) (4 x 5) whose
    row 2 holds column 3 twice."""
    a_ip = torch.tensor([0, 2, 2, 4])
    a_ix = torch.tensor([1, 2, 0, 3])
    b_ip = torch.tensor([0, 1, 3, 6, 7])
    b_ix = torch.tensor([4, 0, 2, 3, 1, 3, 2])
    rng = np.random.default_rng(70)
    return (a_ip, a_ix, torch.tensor(values(rng, 4, np.float64)), b_ip,
            b_ix, torch.tensor(values(rng, 7, np.float64)))


@pytest.mark.parametrize("tracked", [False, True])
def test_repeated_column_of_op_b_raises(tracked):
    """K6 takes op(B) without repeated columns (``_xla.spgemm_numeric_
    sorted`` takes sorted, unique flat indices): with ``b_sorted=False``
    a row that repeats a column raises ``ValueError``, raw or tracked, on
    the CPU as on the card (``chip_smoke.py`` phase 2 holds the card to
    the same message); ``b_sorted=True`` is the caller's warrant and is
    not checked."""
    a_ip, a_ix, a_dv, b_ip, b_ix, b_dv = repeated_b()
    a_dv.requires_grad_(tracked)
    with pytest.raises(ValueError, match="row 2 of op\\(B\\) repeats "
                                         "column 3"):
        spgemm.csr_spgemm_dense(a_ip, a_ix, a_dv, b_ip, b_ix, b_dv, 5)
    c = spgemm.csr_spgemm_dense(a_ip, a_ix, a_dv, b_ip, b_ix, b_dv, 5,
                                b_sorted=True)
    ref = spgemm.csr_spgemm_dense_plain(a_ip, a_ix, a_dv.detach(), b_ip,
                                        b_ix, b_dv, 5)
    close(c, ref.numpy())


def test_tracked_path_checks_op_b_once_per_pattern(monkeypatch):
    """The tracked path sorts and checks op(B) once per cached pattern
    (``CsrPattern.sorted_columns``), not at every step; a pattern that
    failed the check raises again."""
    a, b = operands(np.float64, 71, shuffle=True)
    a_ip, a_ix, a_dv = arrays(a)
    b_ip, b_ix, b_dv = arrays(b)
    calls = []
    real = formats.sorted_unique_columns

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(formats, "sorted_unique_columns", spy)
    autograd.patterns.clear()
    for _ in range(3):
        c = spgemm.csr_spgemm_dense(a_ip, a_ix, a_dv, b_ip, b_ix, b_dv, N)
        c.sum().backward()
    assert len(calls) == 1
    close(c, (a @ b).toarray())
    r_ip, r_ix, r_dv, *rest = repeated_b()
    for _ in range(2):
        with pytest.raises(ValueError, match="repeats column"):
            spgemm.csr_spgemm_dense(r_ip, r_ix, r_dv.requires_grad_(),
                                    *rest, 5)
    assert len(calls) == 3
