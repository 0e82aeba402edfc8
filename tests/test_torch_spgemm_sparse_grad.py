"""Gradients of the port's sparse x sparse product with sparse output
(``ops.spgemm.csr_spgemm`` through ``ops.autograd.CsrSpgemm``, backward on
K11's function ``ops.spgemm_grad.csr_spgemm_sparse_sddmm``) against a numpy
oracle and against ``jax.grad`` of the JAX package's
``_xla.esc_spgemm_block``.

For C = op(A) op(B) on its structural pattern and G = dL/d(C's values) on
that pattern, the gradient in op(A)'s values is (G op(B)^H) at op(A)'s
entries and in op(B)'s values (op(A)^H G) at op(B)'s, G read as a dense
matrix that is zero off C's pattern (under ``triangular`` the pattern
holds only j >= i).  On the CPU the Function runs the plain versions of
K4, K5 and K11; ``chip_smoke.py`` runs the same graph on the kernels.
Second derivatives run K5 on C's saved pattern and K11 again
(``CsrSpgemmSparseSddmm``'s and ``CsrSpgemmFill``'s backward and
``jvp``); they are held to ``jax.hessian`` of ``esc_spgemm_block`` (one
channel, f64) and to ``gradgradcheck``.

Tolerances: rtol 1e-12 (atol 1e-12 times the largest gradient) in float64
and complex128, 1e-5 in float32 and complex64, on values of order 1; the
two sides sum in different orders.  ``esc_spgemm_block`` keeps float64
values whole (its back half sorts and adds them exactly), so the port is
held to ``jax.grad`` at rtol 1e-12 too.
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
TOL = {np.float32: 1e-5, np.complex64: 1e-5, np.float64: 1e-12,
       np.complex128: 1e-12}


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless asked otherwise; these tests ask
    for the CPU, where its wrappers take their plain versions, with one
    intra-op thread (``gradcheck`` runs thousands of small operations,
    whose parallel regions stall when test processes share the cores)."""
    saved = config.device, torch.get_num_threads()
    config.device = "cpu"
    torch.set_num_threads(1)
    yield
    config.device = saved[0]
    torch.set_num_threads(saved[1])


def close(port, ref, tol=1e-12):
    if isinstance(port, torch.Tensor):
        port = port.detach().numpy()
    ref = np.asarray(ref)
    scale = np.abs(ref).max() if ref.size else 0.0
    npt.assert_allclose(port, ref, rtol=tol, atol=tol * max(scale, 1.0))


def values(rng, size, dtype):
    v = rng.standard_normal(size)
    if np.dtype(dtype).kind == "c":
        v = v + 1j * rng.standard_normal(size)
    return v.astype(dtype)


def operands(dtype, seed, m=M, k=K, n=N, empty=True):
    """Random CSR op(A) (m x k) and op(B) (k x n), with an empty row each
    (``empty``); canonical rows (op(B) repeats no column in a row)."""
    rng = np.random.default_rng(seed)
    a = sps.random(m, k, density=0.4, format="lil", random_state=seed)
    b = sps.random(k, n, density=0.4, format="lil", random_state=seed + 1)
    if empty:
        a[3, :] = 0
        b[2, :] = 0
    a, b = (x.tocsr().astype(dtype) for x in (a, b))
    for x in (a, b):
        x.data = values(rng, x.nnz, dtype)
    return a, b


def arrays(x, itype=np.int32, requires_grad=True):
    return (torch.tensor(x.indptr.astype(itype)),
            torch.tensor(x.indices.astype(itype)),
            torch.tensor(x.data, requires_grad=requires_grad))


def sampled(dense, x):
    """``dense`` at the entries of CSR x, in x's stored order."""
    rows = np.repeat(np.arange(x.shape[0]), np.diff(x.indptr))
    return dense[rows, x.indices]


def on_pattern(ip, ix, vals, shape):
    """The dense matrix of values ``vals`` on the CSR pattern (ip, ix)."""
    return sps.csr_matrix((np.asarray(vals), np.asarray(ix),
                           np.asarray(ip)), shape=shape).toarray()


def product(a, b, itype=np.int32, triangular=False):
    """(C's indptr, indices, data, op(A)'s values, op(B)'s values) of
    ``csr_spgemm`` with both operands' values tracked."""
    a_ip, a_ix, a_dv = arrays(a, itype)
    b_ip, b_ix, b_dv = arrays(b, itype)
    c = spgemm.csr_spgemm(a_ip, a_ix, a_dv, b_ip, b_ix, b_dv, b.shape[1],
                          triangular)
    return (*c, a_dv, b_dv)


def oracle(a, b, w):
    """(dL/d(op(A)'s values), dL/d(op(B)'s values)) for G = ``w`` dense."""
    return (sampled(w @ b.toarray().conj().T, a),
            sampled(a.toarray().conj().T @ w, b))


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64,
                                   np.complex128])
@pytest.mark.parametrize("itype", [np.int32, np.int64])
@pytest.mark.parametrize("triangular", [False, True])
def test_grads_match_numpy_oracle(dtype, itype, triangular):
    """The result carries ``CsrSpgemmBackward`` (indptr and indices no
    gradient); the result and both operands' gradients of
    sum(Re(C conj(W))) against the numpy oracle, with empty rows in both
    operands, in each value type and index width, with and without
    ``triangular``."""
    a, b = operands(dtype, 40)
    ip, ix, data, a_dv, b_dv = product(a, b, itype, triangular)
    assert type(data.grad_fn).__name__ == "CsrSpgemmBackward"
    assert ip.grad_fn is None and ix.grad_fn is None
    assert ip.dtype == ix.dtype == torch.from_numpy(np.zeros(0, itype)).dtype
    prod = (a.astype(np.complex128) @ b.astype(np.complex128)).toarray()
    c = on_pattern(ip, ix, data.detach(), (M, N))
    close(c, np.triu(prod) if triangular else prod, TOL[dtype])
    w = values(np.random.default_rng(41), data.numel(), dtype)
    (data * torch.tensor(w).conj()).real.sum().backward()
    ref_a, ref_b = oracle(a, b, on_pattern(ip, ix, w, (M, N)))
    close(a_dv.grad, ref_a, TOL[dtype])
    close(b_dv.grad, ref_b, TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_explicit_zeros_and_cancelled_sums(dtype):
    """A stored zero of op(A) and a sum that cancels exactly keep their
    entries of C (the pattern is structural), and the gradient reaches
    them: the stored zero's gradient is G op(B)^H there, not 0, and so
    are the gradients of the entries whose products cancel."""
    a = sps.csr_matrix((np.array([1.0, 1.0, 0.0, 2.0], dtype),
                        np.array([0, 1, 2, 0]), np.array([0, 3, 4])),
                       shape=(2, 3))
    b = sps.csr_matrix((np.array([1.0, -1.0, 3.0, 0.5], dtype),
                        np.array([0, 0, 1, 1]), np.array([0, 1, 2, 4])),
                       shape=(3, 2))
    ip, ix, data, a_dv, b_dv = product(a, b)
    # Row 0, column 0: 1 * 1 + 1 * (-1) = 0, stored; column 1 from the
    # stored zero of op(A) alone: 0 * 0.5, stored.
    assert ip.tolist() == [0, 2, 3] and ix.tolist() == [0, 1, 0]
    assert data.detach().tolist()[:2] == [0.0, 0.0]
    w = values(np.random.default_rng(42), data.numel(), dtype)
    (data * torch.tensor(w).conj()).real.sum().backward()
    ref_a, ref_b = oracle(a, b, on_pattern(ip, ix, w, (2, 2)))
    close(a_dv.grad, ref_a)
    close(b_dv.grad, ref_b)
    assert a_dv.grad[2] != 0 and (a_dv.grad[:2] != 0).all()


@pytest.mark.parametrize("case", ["empty_rows", "no_entry_of_a",
                                  "no_product"])
def test_empty_rows_and_no_entries(case):
    """Operands with many empty rows, op(A) with no entry, and operands
    whose entries meet nowhere (C has no entry): the gradients have the
    operands' lengths and equal the oracle (zeros where no product
    reaches an entry)."""
    if case == "empty_rows":
        a, b = operands(np.float64, 43, m=12, k=10, n=6)
        a = a.tolil()
        a[::2, :] = 0
        b = b.tolil()
        b[1::3, :] = 0
        a, b = a.tocsr(), b.tocsr()
    elif case == "no_entry_of_a":
        a = sps.csr_matrix((M, K))
        b = operands(np.float64, 44)[1]
    else:  # op(A) names only op(B)'s empty row 2
        a = sps.csr_matrix((np.ones(3), np.full(3, 2), np.array(
            [0, 1, 1, 2, 2, 2, 3, 3])), shape=(M, K))
        b = operands(np.float64, 44)[1]
    ip, ix, data, a_dv, b_dv = product(a, b)
    if case != "empty_rows":
        assert data.numel() == 0
    w = values(np.random.default_rng(45), data.numel(), np.float64)
    (data * torch.tensor(w)).sum().backward()
    ref_a, ref_b = oracle(a, b, on_pattern(ip, ix, w, (a.shape[0],
                                                        b.shape[1])))
    if case == "no_entry_of_a":
        assert a_dv.grad is None or a_dv.grad.numel() == 0
    else:
        close(a_dv.grad, ref_a)
    close(b_dv.grad, ref_b)


def esc_block(a, b, a_chans, b_chans, triangular):
    """``_xla.esc_spgemm_block`` over all of op(A)'s rows as one block
    (row offset 0, no padding, 32-bit keys, co-sorted values): C's
    values, one array a channel, in (row, column) order."""
    m, n = a.shape[0], b.shape[1]
    counts = np.diff(b.indptr)[a.indices]
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    e_total = int(offsets[-1])
    longest = int(np.diff(a.indptr).max())
    out = _xla.esc_spgemm_block(
        jnp.asarray(np.repeat(np.arange(m), np.diff(a.indptr)), jnp.int32),
        jnp.asarray(a.indices, jnp.int32), a_chans, jnp.asarray(offsets),
        jnp.asarray(e_total, jnp.int32), jnp.asarray(b.indptr, jnp.int32),
        jnp.asarray(b.indices, jnp.int32), b_chans,
        jnp.asarray(0, jnp.int32), e_pad=e_total, mb=m, n=n,
        nchan=a_chans.shape[0], key64=False,
        dup_passes=int(np.ceil(np.log2(max(longest, 1)))),
        triangular=triangular, perm_sort=False)
    count = int(out[-1])
    return [v[:count] for v in out[1:-1]]


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("triangular", [False, True])
def test_grads_match_jax_esc(dtype, triangular):
    """Gradients of sum(Re(C conj(W))) against ``jax.grad`` of
    ``esc_spgemm_block`` called directly with one row block: float64
    through one channel; complex128 through two planar channels (re, im),
    where the port's gradient is PyTorch's combination of the channels'
    ``jax.grad``s, d/d(re) + i d/d(im).  The forward equals the block's
    values too."""
    a, b = operands(dtype, 46)
    ip, ix, data, a_dv, b_dv = product(a, b, triangular=triangular)
    w = values(np.random.default_rng(47), data.numel(), dtype)

    def planes(x):
        return jnp.asarray(np.stack([x.real, x.imag]) if
                           np.iscomplexobj(x) else x[None])

    w_planes = planes(w)

    def jax_loss(a_chans, b_chans):
        c = esc_block(a, b, a_chans, b_chans, triangular)
        return sum(jnp.sum(ch * wp) for ch, wp in zip(c, w_planes))

    ga, gb = jax.grad(jax_loss, argnums=(0, 1))(planes(a.data),
                                                planes(b.data))
    c = esc_block(a, b, planes(a.data), planes(b.data), triangular)
    complex_ = np.iscomplexobj(w)
    close(data, (c[0] + 1j * c[1]) if complex_ else c[0])
    (data * torch.tensor(w).conj()).real.sum().backward()
    for port, ref in ((a_dv.grad, ga), (b_dv.grad, gb)):
        ref = np.asarray(ref)
        close(port, ref[0] + 1j * ref[1] if complex_ else ref[0])


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("triangular", [False, True])
def test_gradcheck_with_forward_ad(dtype, triangular):
    """``torch.autograd.gradcheck`` in both operands' values, reverse and
    forward mode (the tangent: K5 of (dA, B) plus K5 of (A, dB))."""
    npdt = np.dtype(str(dtype).removeprefix("torch."))
    a, b = operands(npdt, 48)
    a_ip, a_ix, a_dv = arrays(a)
    b_ip, b_ix, b_dv = arrays(b)
    assert torch.autograd.gradcheck(
        lambda av, bv: spgemm.csr_spgemm(a_ip, a_ix, av, b_ip, b_ix, bv, N,
                                         triangular)[2],
        (a_dv, b_dv), check_forward_ad=True)


def test_func_grad_and_vmap():
    """``torch.func.grad`` in both operands' values, and ``vmap`` of it
    over a batch of weights (one batched K11 call), equal the autograd
    gradients; ``vmap`` over op(A)'s values gives each member's values on
    the one pattern; ``torch.func.jvp`` equals the product of the
    tangent (the product is linear in op(A)'s values), and ``jacfwd``
    ``jacrev``."""
    a, b = operands(np.float64, 49)
    a_ip, a_ix, a_dv = arrays(a, requires_grad=False)
    b_ip, b_ix, b_dv = arrays(b, requires_grad=False)

    def values_of(av, bv, triangular=True):
        return spgemm.csr_spgemm(a_ip, a_ix, av, b_ip, b_ix, bv, N,
                                 triangular)[2]

    nnz = values_of(a_dv, b_dv).numel()
    ws = torch.tensor(values(np.random.default_rng(50), (3, nnz),
                             np.float64))

    def loss(av, bv, w):
        return (values_of(av, bv) * w).sum()

    grads = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)),
                            in_dims=(None, None, 0))(a_dv, b_dv, ws)
    for i in range(3):
        av, bv = a_dv.clone().requires_grad_(), b_dv.clone().requires_grad_()
        loss(av, bv, ws[i]).backward()
        single = torch.func.grad(loss, argnums=(0, 1))(a_dv, b_dv, ws[i])
        for got in (grads[0][i], single[0]):
            close(got, av.grad)
        for got in (grads[1][i], single[1]):
            close(got, bv.grad)
    avs = torch.stack([a_dv, 2 * a_dv, -a_dv])
    out = torch.func.vmap(lambda av: values_of(av, b_dv, False))(avs)
    for i in range(3):
        close(out[i], spgemm.spgemm_plain(a_ip, a_ix, avs[i], b_ip, b_ix,
                                          b_dv, N)[2])
    primal, tangent = torch.func.jvp(lambda av: values_of(av, b_dv),
                                     (a_dv,), (2 * a_dv,))
    close(tangent, 2 * primal)
    # jacfwd is vmap of jvp: the tangents' K5 fills, one a member.
    close(torch.func.jacfwd(values_of, argnums=(0, 1))(a_dv, b_dv)[1],
          torch.func.jacrev(values_of, argnums=(0, 1))(a_dv, b_dv)[1])


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
    """(port loss, JAX loss, op(A), op(B)) of the non-quadratic loss
    sum(sin(C's values)) for C = op(A) op(B) on its structural pattern
    (only j >= i under ``triangular``) in both operands' values, f64:
    through ``csr_spgemm`` and through ``esc_spgemm_block`` called with
    one row block and one channel."""
    a, b = operands(np.float64, seed)
    a_ip, a_ix, _ = arrays(a, requires_grad=False)
    b_ip, b_ix, _ = arrays(b, requires_grad=False)

    def port_loss(av, bv):
        return torch.sin(spgemm.csr_spgemm(a_ip, a_ix, av, b_ip, b_ix, bv, N,
                                           triangular)[2]).sum()

    def jax_loss(av, bv):
        return jnp.sum(jnp.sin(esc_block(a, b, av[None], bv[None],
                                         triangular)[0]))

    return port_loss, jax_loss, a, b


@pytest.mark.parametrize("triangular", [False, True])
@pytest.mark.parametrize("how", ["hessian", "double_backward",
                                 "grad_of_grad"])
def test_hessian_matches_jax(how, triangular):
    """Second derivatives in both operands' values of a non-quadratic loss
    through ``csr_spgemm`` equal ``jax.hessian``'s of ``esc_spgemm_block``
    (one channel, f64) on the same numpy inputs at rtol 1e-10: the whole
    Hessian by ``torch.func.hessian`` (forward over reverse, with no guard
    left: its mixed block is nonzero and JAX's), or Hessian-vector
    products along a random direction by double backward and by
    ``torch.func.grad`` of ``grad``; the backward's own derivatives run K5
    on C's saved pattern and K11 again (``CsrSpgemmSparseSddmm``'s
    backward)."""
    port_loss, jax_loss, a, b = hessian_problem(60, triangular)
    primals = (a.data, b.data)
    jh = jax.hessian(jax_loss, argnums=(0, 1))(*map(jnp.asarray, primals))
    assert np.abs(np.asarray(jh[0][1])).max() > 0.1
    if how == "hessian":
        th = torch.func.hessian(port_loss, argnums=(0, 1))(
            *map(torch.tensor, primals))
        for i in range(2):
            for j in range(2):
                close(th[i][j], jh[i][j], 1e-10)
        return
    rng = np.random.default_rng(61)
    u = [values(rng, x.shape, np.float64) for x in primals]
    for i, got in enumerate(hvp_along(port_loss, primals, u, how)):
        close(got, sum(np.asarray(jh[i][j]) @ u[j] for j in range(2)),
              1e-10)


@pytest.mark.parametrize("triangular", [False, True])
def test_jvp_of_grad_matches_jax(triangular):
    """``torch.func.jvp`` of ``torch.func.grad`` (forward over reverse:
    ``CsrSpgemmSparseSddmm``'s ``jvp``) equals ``jax.jvp`` of
    ``jax.grad`` on the same inputs and direction, f64, rtol 1e-10."""
    port_loss, jax_loss, a, b = hessian_problem(62, triangular)
    primals = (a.data, b.data)
    u = [values(np.random.default_rng(63), x.shape, np.float64)
         for x in primals]
    _, got = torch.func.jvp(torch.func.grad(port_loss, argnums=(0, 1)),
                            tuple(map(torch.tensor, primals)),
                            tuple(map(torch.tensor, u)))
    _, ref = jax.jvp(jax.grad(jax_loss, argnums=(0, 1)),
                     tuple(map(jnp.asarray, primals)),
                     tuple(map(jnp.asarray, u)))
    for g, r in zip(got, ref):
        close(g, r, 1e-10)


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("case", ["sorted", "triangular", "shuffled"])
def test_gradgradcheck(case, dtype):
    """``torch.autograd.gradgradcheck`` (with forward over reverse) of
    ``csr_spgemm``'s values in both operands' values, with and without
    ``triangular``, and over op(B) whose rows list their entries
    shuffled: the conjugations of ``CsrSpgemmSparseSddmm``'s and
    ``CsrSpgemmFill``'s derivatives included."""
    npdt = np.dtype(str(dtype).removeprefix("torch."))
    a, b = operands(npdt, 64)
    if case == "shuffled":
        rng = np.random.default_rng(65)
        for r in range(K):
            lo, hi = b.indptr[r], b.indptr[r + 1]
            perm = lo + rng.permutation(hi - lo)
            b.indices[lo:hi], b.data[lo:hi] = b.indices[perm], b.data[perm]
    a_ip, a_ix, a_dv = arrays(a)
    b_ip, b_ix, b_dv = arrays(b)
    assert torch.autograd.gradgradcheck(
        lambda av, bv: spgemm.csr_spgemm(a_ip, a_ix, av, b_ip, b_ix, bv, N,
                                         case == "triangular")[2],
        (a_dv, b_dv), check_fwd_over_rev=True)


def test_first_order_launches_unchanged(monkeypatch):
    """One first-order backward in both operands' values calls K11's
    plain version twice and neither the product's nor K5's, as before
    second order was added, and builds no graph: its gradients carry no
    ``grad_fn``."""
    a, b = operands(np.float64, 66)
    ip, ix, data, a_dv, b_dv = product(a, b, triangular=True)
    calls = []
    for module, name in ((spgemm, "spgemm_plain"),
                         (spgemm, "csr_spgemm_fill_plain"),
                         (spgemm_grad, "csr_spgemm_sparse_sddmm_plain")):
        real = getattr(module, name)

        def counted(*args, name=name, real=real):
            calls.append(name)
            return real(*args)

        monkeypatch.setattr(module, name, counted)
    grads = torch.autograd.grad(torch.sin(data).sum(), (a_dv, b_dv))
    assert calls == ["csr_spgemm_sparse_sddmm_plain"] * 2
    assert all(g.grad_fn is None for g in grads)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64,
                                   np.complex128])
@pytest.mark.parametrize("transposed", [False, True])
def test_plain_forms_against_dense_einsum(dtype, transposed):
    """``csr_spgemm_sparse_sddmm_plain`` against a dense einsum: the dA
    form equals (G conj(op(B))^T) at op(A)'s entries, the dB form
    (conj(op(A))^T G) at op(B)'s, G dense and zero off C's pattern, with
    every product in one chunk or in chunks of a few;
    ``csr_spgemm_sparse_sddmm`` on CPU tensors is the plain version, and
    called directly it raises on a tracked operand."""
    a, b = operands(dtype, 52)
    a_ip, a_ix, a_dv = arrays(a, requires_grad=False)
    b_ip, b_ix, b_dv = arrays(b, requires_grad=False)
    c_ip, c_ix, _ = spgemm.spgemm_plain(a_ip, a_ix, a_dv, b_ip, b_ix, b_dv,
                                        N)
    g = values(np.random.default_rng(53), c_ix.numel(), dtype)
    gd = on_pattern(c_ip, c_ix, g, (M, N))
    dense = (np.einsum("ij,kj->ik", gd, b.toarray().conj()) if not
             transposed else np.einsum("ik,ij->kj", a.toarray().conj(), gd))
    ref = sampled(dense, b if transposed else a)
    args = (a_ip, a_ix, a_dv, b_ip, b_ix, b_dv, c_ip, c_ix, torch.tensor(g),
            N, transposed)
    tol = TOL[dtype]
    close(spgemm_grad.csr_spgemm_sparse_sddmm_plain(*args), ref, tol)
    close(spgemm_grad.csr_spgemm_sparse_sddmm(*args), ref, tol)
    saved = config.spmm_chunk_elements
    try:
        config.spmm_chunk_elements = 3
        close(spgemm_grad.csr_spgemm_sparse_sddmm_plain(*args), ref, tol)
    finally:
        config.spmm_chunk_elements = saved
    with pytest.raises(ValueError, match="carries no gradient"):
        spgemm_grad.csr_spgemm_sparse_sddmm(
            *args[:8], args[8].clone().requires_grad_(), *args[9:])


@pytest.mark.parametrize("case", ["c_rows", "g_length", "a_past_b",
                                  "c_past_n"])
def test_sparse_sampled_product_refuses_operands_that_do_not_fit(case):
    """``csr_spgemm_sparse_sddmm`` raises ``ValueError`` on the CPU, as
    on the card, where K11 would read past an operand: C with other rows
    than op(A), G of another length than C's entries, op(A)'s column ids
    past op(B)'s rows, C's column ids past n."""
    a, b = operands(np.float64, 54)
    a_ip, a_ix, a_dv = arrays(a, requires_grad=False)
    b_ip, b_ix, b_dv = arrays(b, requires_grad=False)
    c_ip, c_ix, c_dv = spgemm.spgemm_plain(a_ip, a_ix, a_dv, b_ip, b_ix,
                                           b_dv, N)
    args = [a_ip, a_ix, a_dv, b_ip, b_ix, b_dv, c_ip, c_ix, c_dv, N]
    if case == "c_rows":
        args[6:8], match = (c_ip[:-1], c_ix[:int(c_ip[-2])]), "and C \\("
        args[8] = c_dv[:int(c_ip[-2])]
    elif case == "g_length":
        args[8], match = c_dv[1:], "G \\("
    elif case == "a_past_b":  # op(B)'s first K - 1 rows: op(A) names K - 1
        args[3:6] = b_ip[:-1], b_ix[:int(b_ip[-2])], b_dv[:int(b_ip[-2])]
        match = "op\\(A\\)'s column ids"
    else:
        args[7], match = c_ix.clone(), "C's column ids"
        args[7][0] = N
    for transposed in (False, True):
        with pytest.raises(ValueError, match=match):
            spgemm_grad.csr_spgemm_sparse_sddmm(*args, transposed)


@pytest.mark.parametrize("line, itemsize, mean_row, budget, want", [
    # case a (the demo X @ X.T, f64): 28 lines of 501 staged, 32 lanes
    (500, 8, 106, None, (32, 28, True, 501)),
    # case c (the 1M^2 A @ A): in place, a lane a row of P
    (10 ** 6, 8, 2, None, (1, 0, False, 0)),
    # short lines: at most 32 a panel
    (20, 4, 3, None, (2, 32, True, 21)),
    (20, 16, 40, None, (32, 32, True, 21)),
    # c128 lines of 3000: 2 fit 112 KB, in place; 4 fit 220 KB, staged
    (3000, 16, 150, None, (32, 0, False, 0)),
    (3000, 16, 150, 220 * 1024, (32, 4, True, 3001)),
    # f64 lines of 3583 (pitch 3583): 4 fit, the fewest staged; of 3584
    # (pitch 3585), 3: in place
    (3583, 8, 6, None, (4, 4, True, 3583)),
    (3584, 8, 6, None, (4, 0, False, 0)),
    # no shared memory: in place
    (500, 8, 106, 0, (32, 0, False, 0)),
])
def test_sparse_plan(line, itemsize, mean_row, budget, want):
    """K11's plan (lanes, panel, staged, pitch): K9's lanes for Y's mean
    row; lines of G (n long in the dA form, m in the dB form) staged as
    K9 stages them where at least 4 fit the budget (an odd pitch, at most
    32 a panel), else read in place (panel and pitch 0)."""
    assert tuple(spgemm_grad.sparse_plan(line, itemsize, mean_row,
                                         budget)) == want


def test_sparse_runs_built_once_per_pattern(monkeypatch):
    """K11's runs live on P's ``CsrPattern`` (op(A)'s in the dA form,
    op(B)'s in the dB form) under a key of their own, built once over
    three steps of a training loop whose C tensors are new at every
    step; they are ``sampled_runs`` of P's pattern and the plan's panel,
    whatever C holds."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import autograd

    a, b = operands(np.float64, 55, m=40, k=30, n=36)
    a_ip, a_ix, a_dv = arrays(a, requires_grad=False)
    b_ip, b_ix, b_dv = arrays(b, requires_grad=False)
    built = []
    real = spgemm_grad.sampled_runs

    def counted(*args):
        built.append(args[2:])
        return real(*args)

    monkeypatch.setattr(spgemm_grad, "sampled_runs", counted)
    pa = autograd.patterns.get(a_ip, a_ix, b_ip.numel() - 1)
    pb = autograd.patterns.get(b_ip, b_ix, b.shape[1])
    t, _ = pa.transpose()
    seen = {}
    for step in range(3):
        # A step's product: new C tensors, which the runs never read.
        spgemm.csr_spgemm(a_ip, a_ix, torch.tensor(a.data * (step + 1)),
                          b_ip, b_ix, b_dv, b.shape[1])
        for transposed, p, y, line in ((False, pa, pb, b.shape[1]),
                                       (True, pb, t, a.shape[0])):
            plan, runs = spgemm_grad.sparse_schedule(p, y, line, 8,
                                                     transposed, sms=4)
            assert plan.staged
            assert seen.setdefault(transposed, runs) is runs
    assert len(built) == 2
    for transposed, p in ((False, pa), (True, pb)):
        key = [k for k in p.plans if k[:2] == ("k11", transposed)]
        assert len(key) == 1
        runs = p.plans[key[0]]
        want = real(p.indptr, p.indices, transposed, key[0][2],
                    b_ip.numel() - 1, key[0][4])
        for got, ref in zip(runs[:5], want[:5]):
            assert torch.equal(got, ref)
        # Sorted stably by (panel of the line, row of Y): every entry once.
        assert sorted(runs.perm.tolist()) == list(range(p.nnz))
        line, q = formats.expand_indptr(p.indptr, p.nnz), p.indices
        if transposed:
            line, q = q, line
        key_of = ((line.long() // key[0][2]) * 100 + q.long())[runs.perm]
        assert (key_of[1:] >= key_of[:-1]).all()


def same_parts_and_close(port, ref, tol):
    """The same nan, +inf and -inf in each real and imaginary part, and
    the finite entries within ``tol`` of the largest finite one."""
    port = np.asarray(port.detach() if isinstance(port, torch.Tensor)
                      else port)
    got = port.view(np.float64) if np.iscomplexobj(port) else port
    want = ref.view(np.float64) if np.iscomplexobj(ref) else ref
    for what in (np.isnan, np.isposinf, np.isneginf):
        npt.assert_array_equal(what(got), what(want))
    fin = np.isfinite(want)
    scale = np.abs(want[fin]).max() if fin.any() else 1.0
    npt.assert_allclose(got[fin], want[fin], rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("transposed", [False, True])
def test_plain_skips_products_that_c_lacks(dtype, transposed):
    """The presence rule: where C's pattern lacks some products' entries
    (every other entry of some rows dropped), those products add
    nothing, so an inf in op(B)'s (dA form) or op(A)'s (dB form) values
    that meets only such entries leaves no nan, where a dense 0 * inf
    would.  ``csr_spgemm_sparse_sddmm_plain`` (and the wrapper on CPU
    tensors) against a numpy oracle that walks the products and skips
    them, in f64 and c128, at rtol 1e-12."""
    a, b = operands(dtype, 56, m=9, k=8, n=10)
    a.data[[1, 6]] = [np.inf, -np.inf]
    b.data[[0, 7]] = [-np.inf, np.inf]
    if np.iscomplexobj(a.data):
        a.data[3] = complex(0.0, np.inf)
        b.data[4] = complex(0.0, -np.inf)
    a_ip, a_ix, a_dv = arrays(a, requires_grad=False)
    b_ip, b_ix, b_dv = arrays(b, requires_grad=False)
    n = b.shape[1]
    full_ip, full_ix, _ = spgemm.spgemm_plain(a_ip, a_ix, a_dv, b_ip, b_ix,
                                              b_dv, n)
    keep = np.ones(full_ix.numel(), bool)
    for row in (0, 2, 3, 5, 8):
        keep[int(full_ip[row]) + 1:int(full_ip[row + 1]):2] = False
    rows = np.repeat(np.arange(a.shape[0]), np.diff(full_ip.numpy()))[keep]
    cols = full_ix.numpy()[keep]
    c_ip = torch.tensor(np.concatenate([[0], np.cumsum(np.bincount(
        rows, minlength=a.shape[0]))]).astype(np.int32))
    c_ix = torch.tensor(cols.astype(np.int32))
    g = values(np.random.default_rng(57), cols.size, dtype)
    present = {(int(i), int(j)): v for i, j, v in zip(rows, cols, g)}
    ref = np.zeros((b if transposed else a).nnz, dtype)
    a_rows = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    for pa, (i, kk) in enumerate(zip(a_rows, a.indices)):
        for pb in range(b.indptr[kk], b.indptr[kk + 1]):
            j = b.indices[pb]
            if (i, j) not in present:
                continue
            if transposed:
                ref[pb] += np.conj(a.data[pa]) * present[(i, j)]
            else:
                ref[pa] += present[(i, j)] * np.conj(b.data[pb])
    gd = on_pattern(c_ip, c_ix, g, (a.shape[0], n))
    with np.errstate(invalid="ignore"):
        dense = (sampled(gd @ b.toarray().conj().T, a) if not transposed
                 else sampled(a.toarray().conj().T @ gd, b))
    assert np.isnan(dense).sum() > np.isnan(ref).sum()
    args = (a_ip, a_ix, a_dv, b_ip, b_ix, b_dv, c_ip, c_ix, torch.tensor(g),
            n, transposed)
    same_parts_and_close(
        spgemm_grad.csr_spgemm_sparse_sddmm_plain(*args), ref, 1e-12)
    same_parts_and_close(spgemm_grad.csr_spgemm_sparse_sddmm(*args), ref,
                         1e-12)
