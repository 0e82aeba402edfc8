"""The port's BSR device function under PyTorch's transforms, against the
JAX package's ``_xla.bsr_spmm`` under JAX's.

``sparse_dot_tpu_torch.ops.bsr_spmm(block_data, block_rows, block_cols,
b, m, alpha, beta, c0)`` takes the arguments of ``_xla.bsr_spmm``: the
same blocks, block coordinates and dense operands, made from a seed with
numpy, go to both as numpy arrays.  On the CPU the port's Functions run
the plain versions of K1 (``bsr_spmm_plain``) and K8 (``bsr_sddmm_plain``);
the graph they build is the one the card builds (``chip_smoke.py`` runs
the same transforms there on the kernels).  Second derivatives
(``torch.func.hessian``, double backward, ``jvp`` of ``grad``) are held
to ``jax.hessian`` / ``jax.jvp`` of ``_xla.bsr_spmm`` and to
``gradgradcheck``; there ``BsrSddmm``'s own backward runs K1 and its
``jvp`` K8.

Tolerance: rtol 1e-10 (atol 1e-12) in float64 and complex128, 1e-5 in
float32, on values of order 1; the two sides sum in different orders.
PyTorch's gradient of a real loss in complex values is the conjugate of
JAX's, and the tests hold the port to that relation.
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax
import jax.numpy as jnp

import sparse_dot_tpu  # noqa: F401  (enables x64 before any JAX array)
from sparse_dot_tpu.ops import _xla

from sparse_dot_tpu_torch import formats
from sparse_dot_tpu_torch.config import config
from sparse_dot_tpu_torch.ops import autograd, bsr, bsr_spmm

TOL = {np.dtype(np.float64): (1e-10, 1e-12),
       np.dtype(np.complex128): (1e-10, 1e-12),
       np.dtype(np.float32): (1e-5, 1e-5)}
N = 5


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


def close(port, ref, dtype=np.float64):
    if isinstance(port, torch.Tensor):
        port = port.detach().numpy()
    rtol, atol = TOL[np.dtype(dtype)]
    npt.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol)


def values(rng, size, dtype):
    v = rng.standard_normal(size)
    if np.dtype(dtype).kind == "c":
        v = v + 1j * rng.standard_normal(size)
    return v.astype(dtype)


def blocks(rng, bs, dtype, nbrows=4, nbcols=5, nb=10):
    """(data, block_rows, block_cols, m, k): ``nb`` random blocks of an
    (nbrows bs) x (nbcols bs) matrix with a repeated block, block row 2
    empty, negative block ids counting from the end and one block in a
    row past the end (dropped, as JAX's ``mode="drop"``)."""
    rows = rng.integers(0, nbrows, nb)
    rows[rows == 2] = 3
    cols = rng.integers(0, nbcols, nb)
    rows[1], cols[1] = rows[0], cols[0]  # a repeated block
    rows[2] -= nbrows  # the same rows, counted from the end
    cols[3] -= nbcols
    rows[4] = nbrows + 1  # outside [-nbrows, nbrows): dropped
    data = values(rng, (nb, bs, bs), dtype)
    return data, rows, cols, nbrows * bs, nbcols * bs


def both(*arrays):
    """Each numpy array as (torch tensor, jax array)."""
    return [(torch.tensor(a), jnp.asarray(a)) for a in arrays]


@pytest.mark.parametrize("dtype", [np.float64, np.complex128, np.float32])
@pytest.mark.parametrize("bs", [1, 3, 8])
def test_grad_matches_jax(bs, dtype):
    """Gradients of sum |C|^2 in the blocks, b and c0, with alpha and
    beta: the port's equal the conjugate of ``jax.grad``'s (equal for
    real values)."""
    rng = np.random.default_rng(bs)
    data, rows, cols, m, k = blocks(rng, bs, dtype)
    b, c0 = values(rng, (k, N), dtype), values(rng, (m, N), dtype)
    alpha = (1.5 - 0.5j) if np.dtype(dtype).kind == "c" else 1.5
    (tr, jr), (tc, jc) = both(rows, cols)

    def jax_loss(d, bb, cc):
        c = _xla.bsr_spmm(d, jr, jc, bb, m, alpha=alpha, beta=-0.5, c0=cc)
        return jnp.sum(jnp.abs(c) ** 2)

    refs = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (data, b, c0)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (data, b, c0)]
    c = bsr_spmm(leaves[0], tr, tc, leaves[1], m, alpha, -0.5, leaves[2])
    assert type(c.grad_fn).__name__ == "BsrSpmmBackward"
    close(c, _xla.bsr_spmm(jnp.asarray(data), jr, jc, jnp.asarray(b), m,
                           alpha=alpha, beta=-0.5, c0=jnp.asarray(c0)),
          dtype)
    (c.abs() ** 2).sum().backward()
    for leaf, ref in zip(leaves, refs):
        close(leaf.grad, np.conj(np.asarray(ref)), dtype)
    assert not leaves[0].grad[4].any()  # the dropped block


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("bs", [1, 3, 8])
def test_jvp_matches_jax(bs, dtype):
    """``torch.func.jvp`` in the blocks, b and c0 at once equals
    ``jax.jvp`` (forward mode is linear: no conjugate)."""
    rng = np.random.default_rng(10 + bs)
    data, rows, cols, m, k = blocks(rng, bs, dtype)
    primals = (data, values(rng, (k, N), dtype), values(rng, (m, N), dtype))
    tangents = tuple(values(rng, p.shape, dtype) for p in primals)
    (tr, jr), (tc, jc) = both(rows, cols)
    out, dout = torch.func.jvp(
        lambda d, bb, cc: bsr_spmm(d, tr, tc, bb, m, 2.0, 0.5, cc),
        tuple(map(torch.tensor, primals)), tuple(map(torch.tensor,
                                                     tangents)))
    ref, dref = jax.jvp(
        lambda d, bb, cc: _xla.bsr_spmm(d, jr, jc, bb, m, alpha=2.0,
                                        beta=0.5, c0=cc),
        tuple(map(jnp.asarray, primals)), tuple(map(jnp.asarray, tangents)))
    close(out, ref, dtype)
    close(dout, dref, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("bs", [3, 8])
def test_gradcheck_with_forward_ad(bs, dtype):
    """``torch.autograd.gradcheck`` of the device function in the blocks,
    b and c0 (with alpha and beta), and of ``bsr.bsr_spmm`` on BSR arrays,
    reverse and forward mode, against finite differences."""
    rng = np.random.default_rng(20 + bs)
    npdt = np.dtype(str(dtype).removeprefix("torch."))
    data, rows, cols, m, k = blocks(rng, bs, npdt, 3, 2, 5)
    tr, tc = torch.tensor(rows), torch.tensor(cols)

    def leaf(a):
        return torch.tensor(a, requires_grad=True)

    d, b, c0 = leaf(data), leaf(values(rng, (k, 2), npdt)), leaf(
        values(rng, (m, 2), npdt))
    assert torch.autograd.gradcheck(
        lambda dd, bb, cc: bsr_spmm(dd, tr, tc, bb, m, -1.5, 0.5, cc),
        (d, b, c0), check_forward_ad=True)
    ip, ix = torch.tensor([0, 1, 1, 3]), torch.tensor([1, 0, 1])
    db = leaf(values(rng, (3, bs, bs), npdt))
    assert torch.autograd.gradcheck(
        lambda dd, bb: bsr.bsr_spmm(ip, ix, dd, bb, 2.0), (db, b),
        check_forward_ad=True)


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


def hessian_problem(rng, bs):
    """(torch loss, JAX loss, blocks, b) of the non-quadratic loss
    sum(sin(alpha A b + beta c0)) through ``bsr_spmm`` / ``_xla.bsr_spmm``
    in (blocks, b), on a 6 x 4 block pattern of ``bs`` with a repeated
    block, negative ids and a dropped block, f64."""
    data, rows, cols, m, k = blocks(rng, bs, np.float64, 3, 2, 5)
    b, c0 = values(rng, (k, 2), np.float64), values(rng, (m, 2), np.float64)
    (tr, jr), (tc, jc) = both(rows, cols)

    def torch_loss(d, bb):
        return torch.sin(bsr_spmm(d, tr, tc, bb, m, 1.5, -0.5,
                                  torch.tensor(c0))).sum()

    def jax_loss(d, bb):
        return jnp.sum(jnp.sin(_xla.bsr_spmm(d, jr, jc, bb, m, alpha=1.5,
                                             beta=-0.5,
                                             c0=jnp.asarray(c0))))

    return torch_loss, jax_loss, data, b


def hvp_reference(jh, u):
    """The Hessian-vector products of JAX's Hessian blocks ``jh`` along
    the directions ``u`` (one per argument)."""
    return [sum(np.tensordot(np.asarray(jh[i][j]), u[j], u[j].ndim)
                for j in range(len(u))) for i in range(len(u))]


@pytest.mark.parametrize("bs", [3, 8])
@pytest.mark.parametrize("how", ["hessian", "double_backward",
                                 "grad_of_grad"])
def test_hessian_matches_jax(how, bs):
    """Second derivatives in (blocks, b) of a non-quadratic loss through
    ``bsr_spmm`` (alpha and beta given) equal ``jax.hessian``'s of
    ``_xla.bsr_spmm`` on the same numpy inputs, f64, rtol 1e-10: the whole
    Hessian by ``torch.func.hessian`` (forward over reverse, with no guard
    left: its mixed block is nonzero and JAX's), or Hessian-vector
    products along a random direction by double backward and by
    ``torch.func.grad`` of ``grad``; the backward's own derivatives run K1
    and K8 again (``BsrSddmm``'s backward)."""
    rng = np.random.default_rng(36 + bs)
    torch_loss, jax_loss, data, b = hessian_problem(rng, bs)
    jh = jax.hessian(jax_loss, argnums=(0, 1))(jnp.asarray(data),
                                               jnp.asarray(b))
    assert np.abs(np.asarray(jh[0][1])).max() > 0.1
    if how == "hessian":
        th = torch.func.hessian(torch_loss, argnums=(0, 1))(
            torch.tensor(data), torch.tensor(b))
        for i in range(2):
            for j in range(2):
                close(th[i][j], jh[i][j])
        return
    u = [values(rng, x.shape, np.float64) for x in (data, b)]
    for got, ref in zip(hvp_along(torch_loss, (data, b), u, how),
                        hvp_reference(jh, u)):
        close(got, ref)


@pytest.mark.parametrize("bs", [3, 8])
def test_jvp_of_grad_matches_jax(bs):
    """``torch.func.jvp`` of ``torch.func.grad`` (forward over reverse,
    the Hessian-vector product: ``BsrSddmm``'s ``jvp``) equals
    ``jax.jvp`` of ``jax.grad`` on the same inputs and direction, f64,
    rtol 1e-10."""
    rng = np.random.default_rng(38 + bs)
    torch_loss, jax_loss, data, b = hessian_problem(rng, bs)
    u = [values(rng, x.shape, np.float64) for x in (data, b)]
    _, got = torch.func.jvp(torch.func.grad(torch_loss, argnums=(0, 1)),
                            (torch.tensor(data), torch.tensor(b)),
                            tuple(map(torch.tensor, u)))
    _, ref = jax.jvp(jax.grad(jax_loss, argnums=(0, 1)),
                     (jnp.asarray(data), jnp.asarray(b)),
                     tuple(map(jnp.asarray, u)))
    for g, r in zip(got, ref):
        close(g, r)


@pytest.mark.parametrize("bs, dtype", [(3, torch.float64),
                                       (3, torch.complex128),
                                       (8, torch.float64)])
def test_gradgradcheck(bs, dtype):
    """``torch.autograd.gradgradcheck`` (with forward over reverse) of
    the device function in the blocks, b and c0, with alpha and beta
    (complex in c128), and of ``bsr.bsr_spmm`` on BSR arrays, against
    finite differences: the conjugations and alpha's place in
    ``BsrSddmm``'s derivatives included.  bs 8 in f64 is the shape the
    card serves on the tensor cores; c128 runs on the CUDA cores at any
    bs."""
    rng = np.random.default_rng(40 + bs)
    npdt = np.dtype(str(dtype).removeprefix("torch."))
    data, rows, cols, m, k = blocks(rng, bs, npdt, 3, 2, 5)
    tr, tc = torch.tensor(rows), torch.tensor(cols)
    complex_ = npdt.kind == "c"
    alpha, beta = (1.5 - 0.5j, 0.25 + 1j) if complex_ else (-1.5, 0.5)

    def leaf(a):
        return torch.tensor(a, requires_grad=True)

    d, b, c0 = leaf(data), leaf(values(rng, (k, 2), npdt)), leaf(
        values(rng, (m, 2), npdt))
    assert torch.autograd.gradgradcheck(
        lambda dd, bb, cc: bsr_spmm(dd, tr, tc, bb, m, alpha, beta, cc),
        (d, b, c0), check_fwd_over_rev=True)
    ip, ix = torch.tensor([0, 1, 1, 3]), torch.tensor([1, 0, 1])
    db = leaf(values(rng, (3, bs, bs), npdt))
    assert torch.autograd.gradgradcheck(
        lambda dd, bb: bsr.bsr_spmm(ip, ix, dd, bb, alpha), (db, b),
        check_fwd_over_rev=True)


def test_first_order_launches_unchanged(monkeypatch):
    """One first-order backward in the blocks, b and c0 calls K8's plain
    version once and K1's once (over A^H), as before second order was
    added, and builds no graph: its gradients carry no ``grad_fn``."""
    rng = np.random.default_rng(42)
    data, rows, cols, m, k = blocks(rng, 3, np.float64)
    tr, tc = torch.tensor(rows), torch.tensor(cols)
    calls = {"bsr_spmm_plain": 0, "bsr_sddmm_plain": 0}
    for name in calls:
        real = getattr(bsr, name)

        def counted(*args, name=name, real=real):
            calls[name] += 1
            return real(*args)

        monkeypatch.setattr(bsr, name, counted)
    leaves = [torch.tensor(a, requires_grad=True) for a in (
        data, values(rng, (k, N), np.float64),
        values(rng, (m, N), np.float64))]
    loss = torch.sin(bsr_spmm(leaves[0], tr, tc, leaves[1], m, 2.0, 0.5,
                              leaves[2])).sum()
    assert calls == {"bsr_spmm_plain": 1, "bsr_sddmm_plain": 0}
    grads = torch.autograd.grad(loss, leaves)
    assert calls == {"bsr_spmm_plain": 2, "bsr_sddmm_plain": 1}
    assert all(g.grad_fn is None for g in grads)


def test_func_grad_and_vmap():
    """``torch.func.grad`` and ``vmap`` of it over a batch of b (each
    member's gradient) equal the autograd gradients; ``vmap`` over b is
    one K1 call (the batch folded into its columns) and equals
    ``jax.vmap``; ``vmap`` over the blocks equals ``jax.vmap``."""
    rng = np.random.default_rng(31)
    data, rows, cols, m, k = blocks(rng, 3, np.float64)
    (tr, jr), (tc, jc), (td, jd) = both(rows, cols, data)
    bs_ = values(rng, (3, k, N), np.float64)

    def loss(d, b):
        return (bsr_spmm(d, tr, tc, b, m) ** 2).sum()

    per_member = torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(
        td, torch.tensor(bs_))
    for i in range(3):
        d = td.clone().requires_grad_()
        loss(d, torch.tensor(bs_[i])).backward()
        close(per_member[i], d.grad)
        close(torch.func.grad(loss)(td, torch.tensor(bs_[i])), d.grad)

    calls = []
    spmm = bsr.spmm
    try:
        bsr.spmm = lambda *a: calls.append(1) or spmm(*a)
        out = torch.func.vmap(lambda b: bsr_spmm(td, tr, tc, b, m))(
            torch.tensor(bs_))
    finally:
        bsr.spmm = spmm
    assert out.shape == (3, m, N) and len(calls) == 1
    close(out, jax.vmap(lambda b: _xla.bsr_spmm(jd, jr, jc, b, m))(
        jnp.asarray(bs_)))
    ds = values(rng, (2, *data.shape), np.float64)
    out = torch.func.vmap(lambda d: bsr_spmm(d, tr, tc, torch.tensor(
        bs_[0]), m))(torch.tensor(ds))
    close(out, jax.vmap(lambda d: _xla.bsr_spmm(d, jr, jc, jnp.asarray(
        bs_[0]), m))(jnp.asarray(ds)))


def test_sgd_steps_match_jax():
    """Five SGD steps on ||A(blocks) b - T||^2 in the blocks and b, from
    zero blocks, through the port and through ``jax.grad``, give the same
    blocks, b and losses."""
    rng = np.random.default_rng(32)
    data, rows, cols, m, k = blocks(rng, 3, np.float64)
    b = values(rng, (k, N), np.float64)
    (tr, jr), (tc, jc) = both(rows, cols)
    target = np.asarray(_xla.bsr_spmm(jnp.asarray(data), jr, jc,
                                      jnp.asarray(b), m))
    lr = 0.05

    def jax_loss(d, bb):
        return jnp.sum((_xla.bsr_spmm(d, jr, jc, bb, m)
                        - jnp.asarray(target)) ** 2)

    jd, jb = jnp.zeros(data.shape), jnp.asarray(b)
    d = torch.zeros(data.shape, dtype=torch.float64, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    opt = torch.optim.SGD([d, tb], lr=lr)
    for _ in range(5):
        opt.zero_grad()
        loss = ((bsr_spmm(d, tr, tc, tb, m) - torch.tensor(target)) ** 2
                ).sum()
        loss.backward()
        opt.step()
        jl, (gd, gb) = jax.value_and_grad(jax_loss, argnums=(0, 1))(jd, jb)
        jd, jb = jd - lr * gd, jb - lr * gb
        close(loss.detach(), jl)
        close(d.detach(), jd)
        close(tb.detach(), jb)


def test_tracked_wrapper_builds_the_function_and_caches_the_pattern(
        monkeypatch):
    """``bsr.bsr_spmm`` on BSR arrays with an operand that requires grad
    builds ``BsrSpmm``'s node on the CPU, as on the card, and finds A's
    ``BsrPattern`` again for the same index tensors: three backward passes
    sort A^H's blocks once, and a plan the caller gives is the
    pattern's."""
    monkeypatch.setattr(autograd, "bsr_patterns",
                        autograd._StructureCache(formats.BsrPattern))
    sorts = []
    transpose = formats.BsrPattern.transpose

    def counted(self):
        if self._transpose is None:
            sorts.append(1)
        return transpose(self)

    monkeypatch.setattr(formats.BsrPattern, "transpose", counted)
    rng = np.random.default_rng(33)
    ip, ix = torch.tensor([0, 2, 2, 3]), torch.tensor([1, 0, 1])
    data = torch.tensor(values(rng, (3, 4, 4), np.float64))
    b = torch.tensor(values(rng, (8, 3), np.float64), requires_grad=True)
    plan = formats.bsr_chunk_plan(ip, 3)
    for _ in range(3):
        c = bsr.bsr_spmm(ip, ix, data, b, plan=plan)
        assert type(c.grad_fn).__name__ == "BsrSpmmBackward"
        c.sum().backward()
    assert len(sorts) == 1
    assert autograd.bsr_patterns.get(ip, ix, 2, 4).plan() is plan
    dense = torch.zeros(12, 8, dtype=torch.float64)
    for r, (p0, p1) in enumerate(zip(ip[:-1], ip[1:])):
        for p in range(p0, p1):
            dense[4 * r:4 * r + 4, 4 * ix[p]:4 * ix[p] + 4] = data[p]
    close(b.grad, 3 * dense.T @ torch.ones(12, 3, dtype=torch.float64))
    assert bsr.bsr_spmm(ip, ix, data, b.detach()).grad_fn is None


def test_non_square_blocks_raise():
    b = torch.zeros(6, 2, dtype=torch.float64)
    idx = torch.tensor([0])
    with pytest.raises(ValueError, match="square"):
        bsr_spmm(torch.zeros(1, 2, 3, dtype=torch.float64), idx, idx, b, 4)
    with pytest.raises(ValueError, match="divide"):
        bsr_spmm(torch.zeros(1, 4, 4, dtype=torch.float64), idx, idx, b, 8)


@pytest.mark.parametrize("dtype", [np.float64, np.complex64])
def test_plain_block_sddmm_against_dense_einsum(dtype):
    """``bsr_sddmm_plain`` (gathered strips, one real ``torch.bmm``)
    equals a dense numpy einsum over each stored block's strips and a
    complex ``torch.bmm`` of them, with alpha, empty block rows and no
    stored block; ``bsr_sddmm`` on CPU tensors is the plain version and
    raises on a tracked operand."""
    rng = np.random.default_rng(34)
    bs, n = 3, 7
    indptr = np.array([0, 2, 2, 5, 5])
    indices = np.array([1, 3, 0, 0, 2])
    g = values(rng, (4 * bs, n), dtype)
    b = values(rng, (4 * bs, n), dtype)
    alpha = 0.5 - 2j if np.dtype(dtype).kind == "c" else -2.0
    rows = np.repeat(np.arange(4), np.diff(indptr))
    ref = alpha * np.einsum("bin,bjn->bij",
                            g.reshape(4, bs, n)[rows],
                            np.conj(b.reshape(4, bs, n)[indices]))
    args = (torch.tensor(indptr), torch.tensor(indices), torch.tensor(g),
            torch.tensor(b), bs, alpha)
    tol = np.dtype(np.float32) if dtype == np.complex64 else np.float64
    close(bsr.bsr_sddmm_plain(*args), ref, tol)
    close(bsr.bsr_sddmm(*args), ref, tol)
    strips = [torch.tensor(x.reshape(4, bs, n)[ids]) for x, ids in
              ((g, rows), (b, indices))]
    close(bsr.bsr_sddmm_plain(*args), alpha * torch.bmm(
        strips[0], strips[1].conj().mT), tol)
    empty = bsr.bsr_sddmm_plain(torch.tensor([0, 0]), torch.tensor([0])[:0],
                                torch.tensor(g[:bs]), torch.tensor(b), bs)
    assert empty.shape == (0, bs, bs)
    with pytest.raises(ValueError, match="carries no gradient"):
        bsr.bsr_sddmm(*args[:2], args[2].clone().requires_grad_(),
                      *args[3:])


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128, np.float64])
def test_plain_block_sddmm_keeps_the_component_formula_at_inf(dtype):
    """With inf in G and B, ``bsr_sddmm_plain`` has the same nan, +inf and
    -inf parts as products by numpy's component formula summed over n
    (the rule K8 follows): its one ``torch.bmm`` runs on real and
    imaginary parts side by side."""
    rng = np.random.default_rng(35)
    bs, n = 3, 6
    indptr, indices = np.array([0, 2, 3]), np.array([0, 1, 1])
    g = values(rng, (2 * bs, n), dtype)
    b = values(rng, (2 * bs, n), dtype)
    g[1, 0] = np.inf
    b[2, 5] = -np.inf
    if np.dtype(dtype).kind == "c":
        b[bs, 3] = complex(0.0, -np.inf)
    rows = np.repeat(np.arange(2), np.diff(indptr))
    gs = g.reshape(2, bs, n)[rows]
    bc = np.conj(b.reshape(2, bs, n)[indices])
    with np.errstate(invalid="ignore"):
        if np.dtype(dtype).kind == "c":
            re = (gs.real[:, :, None] * bc.real[:, None]
                  - gs.imag[:, :, None] * bc.imag[:, None]).sum(-1)
            im = (gs.real[:, :, None] * bc.imag[:, None]
                  + gs.imag[:, :, None] * bc.real[:, None]).sum(-1)
            ref = np.stack([re, im], -1)
        else:
            ref = (gs[:, :, None] * bc[:, None]).sum(-1)
    out = bsr.bsr_sddmm_plain(torch.tensor(indptr), torch.tensor(indices),
                              torch.tensor(g), torch.tensor(b), bs)
    got = (torch.view_as_real(out) if out.is_complex() else out).numpy()
    assert np.isinf(ref).any()
    for what in (np.isnan, np.isposinf, np.isneginf):
        npt.assert_array_equal(what(got), what(ref))


@pytest.mark.parametrize("dtype, bs, tensor_cores", [
    (torch.float64, 64, True), (torch.float32, 8, True),
    (torch.float64, 24, True), (torch.float32, 128, True),
    (torch.float64, 3, False), (torch.float32, 20, False),
    (torch.complex128, 64, True), (torch.complex64, 16, True),
    (torch.complex128, 8, True), (torch.complex128, 12, False),
    (torch.complex64, 20, False), (torch.float64, 12, False),
])
def test_k8_variant_follows_dtype_and_block_size(dtype, bs, tensor_cores):
    """K8 is split as K1 is, by one predicate on the value type and the
    block size, decided before a launch: blocks of a multiple of 8 on the
    tensor cores in every value type, the rest on the CUDA cores.  On
    the CPU neither variant is counted."""
    assert bsr.uses_tensor_cores(dtype, bs) is tensor_cores
    counts = (bsr.bsr_sddmm.launches, bsr.bsr_sddmm.launches_tc,
              bsr.bsr_sddmm.launches_simt,
              bsr.bsr_sddmm.launches_tc_complex)
    g = torch.ones((2 * bs, 3), dtype=dtype)
    out = bsr.bsr_sddmm(torch.tensor([0, 1, 2]), torch.tensor([1, 0]), g, g,
                        bs)
    assert out.shape == (2, bs, bs) and bool((out == 3).all())
    assert (bsr.bsr_sddmm.launches, bsr.bsr_sddmm.launches_tc,
            bsr.bsr_sddmm.launches_simt,
            bsr.bsr_sddmm.launches_tc_complex) == counts
