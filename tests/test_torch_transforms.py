"""The port's device API under PyTorch's transforms, against the JAX
package's under JAX's (``tests/test_transforms.py``).

``sparse_dot_tpu_torch.ops.coo_spmm_raw`` and ``coo_spmv`` take the same
expanded COO as ``_xla.coo_spmm_raw`` and ``_xla.coo_spmv``: the arrays of
``MATRIX_1[:40, :30]`` as the JAX package's container holds them, and
dense operands made from a seed with numpy, go to both as numpy arrays.
On the CPU the port's Functions run the plain versions of K2, K3 and K7;
the graph they build is the one the card builds (``chip_smoke.py`` runs
the same transforms there on the kernels).

Tolerance: rtol 1e-10 (atol 1e-12 for entries near 0), float64 and
complex128 on values of order 1; the two sides sum in different orders.
PyTorch's gradient of a real loss in complex values is the conjugate of
JAX's (for |z|^2 at 3+4j JAX gives 6-8j, PyTorch 6+8j), and the tests
hold the port to that relation.
"""

import numpy as np
import numpy.testing as npt
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

from sparse_dot_tpu import formats as jax_formats
from sparse_dot_tpu.ops import _xla

from sparse_dot_tpu_torch import formats
from sparse_dot_tpu_torch.config import config
from sparse_dot_tpu_torch.ops import autograd, coo_spmm_raw, coo_spmv, csr

from .common import MATRIX_1

RTOL, ATOL = 1e-10, 1e-12
M, K, N = 40, 30, 8


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless asked otherwise; these tests ask
    for the CPU, where its wrappers take their plain versions."""
    saved = config.device
    config.device = "cpu"
    yield
    config.device = saved


def close(port, ref):
    if isinstance(port, torch.Tensor):
        port = port.detach().numpy()
    npt.assert_allclose(port, np.asarray(ref), rtol=RTOL, atol=ATOL)


def values(rng, size, dtype):
    v = rng.standard_normal(size)
    if np.dtype(dtype).kind == "c":
        v = v + 1j * rng.standard_normal(size)
    return v.astype(dtype)


@pytest.fixture
def coo():
    """(rows, cols, vals) of ``MATRIX_1[:40, :30]`` as the JAX package's
    container gives them (``row_indices``, ``indices``, ``data``)."""
    a = jax_formats.to_device(MATRIX_1.copy()[:M, :K].tocsr())
    return (np.asarray(a.row_indices()), np.asarray(a.indices),
            np.asarray(a.data))


def both(*arrays):
    """Each numpy array as (torch tensor, jax array)."""
    return [(torch.tensor(a), jnp.asarray(a)) for a in arrays]


def with_dtype(coo, dtype, rng):
    """coo's values in ``dtype`` (a random imaginary part for complex)."""
    rows, cols, vals = coo
    vals = vals.astype(dtype)
    if np.dtype(dtype).kind == "c":
        vals = vals + 1j * rng.standard_normal(vals.shape)
    return rows, cols, vals


def dense_of(rows, cols, vals, shape=(M, K)):
    """The dense matrix of expanded COO (repeats summed, rows >= m
    dropped)."""
    keep = rows < shape[0]
    out = np.zeros(shape, dtype=vals.dtype)
    np.add.at(out, (rows[keep], cols[keep]), vals[keep])
    return out


# ---------------------------------------------------------------------------
# Reverse mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_grad_matches_jax(coo, dtype):
    """Gradients of sum |C|^2 with respect to the values and to b: the
    port's equal the conjugate of ``jax.grad``'s (equal for real)."""
    rng = np.random.default_rng(0)
    rows, cols, vals = with_dtype(coo, dtype, rng)
    b = values(rng, (K, N), dtype)
    (tr, jr), (tc, jc) = both(rows, cols)

    def jax_loss(v, bb):
        c = _xla.coo_spmm_raw(jr, jc, v, bb, M)
        return jnp.sum(jnp.abs(c) ** 2)

    gv, gb = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(vals),
                                                 jnp.asarray(b))
    tv = torch.tensor(vals, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    c = coo_spmm_raw(tr, tc, tv, tb, M)
    (c.abs() ** 2).sum().backward()
    close(tv.grad, np.conj(gv))
    close(tb.grad, np.conj(gb))


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_spmv_grad_matches_jax(coo, dtype):
    """``coo_spmv`` with alpha, beta and y0: gradients in the values, x and
    y0 against ``jax.grad`` (conjugated)."""
    rng = np.random.default_rng(1)
    rows, cols, vals = with_dtype(coo, dtype, rng)
    x, y0 = values(rng, K, dtype), values(rng, M, dtype)
    (tr, jr), (tc, jc) = both(rows, cols)
    alpha, beta = 0.5 - 0.25j if dtype == np.complex128 else 0.5, 2.0

    def jax_loss(v, xx, yy):
        y = _xla.coo_spmv(jr, jc, v, xx, M, alpha, beta, yy)
        return jnp.sum(jnp.abs(y) ** 2)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (vals, x, y0)))
    ts = [torch.tensor(a, requires_grad=True) for a in (vals, x, y0)]
    y = coo_spmv(tr, tc, *ts[:2], M, alpha, beta, ts[2])
    (y.abs() ** 2).sum().backward()
    for t, g in zip(ts, ref):
        close(t.grad, np.conj(g))


def test_complex_gradient_is_conjugate_of_jax():
    """The convention itself: |z|^2 at 3+4j."""
    g_jax = jax.grad(lambda z: jnp.abs(z) ** 2)(jnp.asarray(3 + 4j))
    z = torch.tensor(3 + 4j, requires_grad=True)
    (z.abs() ** 2).backward()
    assert complex(g_jax) == 6 - 8j
    assert complex(z.grad) == 6 + 8j


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_gradcheck_with_forward_ad(coo, dtype):
    """``torch.autograd.gradcheck`` of ``coo_spmm_raw``, ``coo_spmv`` (with
    alpha, beta, y0) and ``csr_spmm`` (with c0), reverse and forward mode,
    against finite differences."""
    rng = np.random.default_rng(2)
    rows, cols, _ = coo
    tr, tc = torch.tensor(rows), torch.tensor(cols)
    nnz = len(rows)

    def leaf(shape):
        return torch.tensor(values(rng, shape, np.dtype(
            str(dtype).removeprefix("torch."))), requires_grad=True)

    v, b, x, y0, c0 = leaf(nnz), leaf((K, 3)), leaf(K), leaf(M), leaf((M, 3))
    a = sps.csr_matrix(MATRIX_1[:M, :K])
    ip, ix = torch.tensor(a.indptr), torch.tensor(a.indices)
    va = leaf(a.nnz)
    assert torch.autograd.gradcheck(
        lambda vv, bb: coo_spmm_raw(tr, tc, vv, bb, M), (v, b),
        check_forward_ad=True)
    assert torch.autograd.gradcheck(
        lambda vv, xx, yy: coo_spmv(tr, tc, vv, xx, M, -1.5, 0.5, yy),
        (v, x, y0), check_forward_ad=True)
    assert torch.autograd.gradcheck(
        lambda vv, bb, cc: csr.csr_spmm(ip, ix, vv, bb, 2.0, -1.0, cc),
        (va, b, c0), check_forward_ad=True)


def loss_and_operand(coo, op, rng):
    """(torch loss, JAX loss, values, x or b) of a non-quadratic loss,
    sum(sin(A x)) through ``coo_spmv`` or sum(sin(A b)) through
    ``coo_spmm_raw`` (b of two columns), on coo's pattern, f64."""
    rows, cols, vals = coo
    (tr, jr), (tc, jc) = both(rows, cols)
    dense = values(rng, K if op == "coo_spmv" else (K, 2), np.float64)
    torch_fn, jax_fn = ((coo_spmv, _xla.coo_spmv) if op == "coo_spmv"
                        else (coo_spmm_raw, _xla.coo_spmm_raw))

    def torch_loss(v, d):
        return torch.sin(torch_fn(tr, tc, v, d, M)).sum()

    def jax_loss(v, d):
        return jnp.sum(jnp.sin(jax_fn(jr, jc, v, d, M)))

    return torch_loss, jax_loss, vals, dense


@pytest.mark.parametrize("op", ["coo_spmv", "coo_spmm_raw"])
@pytest.mark.parametrize("how", ["hessian", "double_backward"])
def test_hessian_matches_jax(coo, op, how):
    """Second derivatives in (values, x or b) of a non-quadratic loss
    equal ``jax.hessian``'s of ``_xla.coo_spmv`` / ``coo_spmm_raw`` on the
    same numpy inputs, f64, rtol 1e-10: the whole Hessian by
    ``torch.func.hessian``, or Hessian-vector products by double backward
    (``create_graph``) along a random direction; the backward's own
    derivatives run K2 and K7 again (``CsrSddmm``'s backward)."""
    rng = np.random.default_rng(5)
    torch_loss, jax_loss, vals, dense = loss_and_operand(coo, op, rng)
    jh = jax.hessian(jax_loss, argnums=(0, 1))(jnp.asarray(vals),
                                               jnp.asarray(dense))
    if how == "hessian":
        th = torch.func.hessian(torch_loss, argnums=(0, 1))(
            torch.tensor(vals), torch.tensor(dense))
        for i in range(2):
            for j in range(2):
                close(th[i][j], jh[i][j])
        return
    u = [values(rng, x.shape, np.float64) for x in (vals, dense)]
    v = torch.tensor(vals, requires_grad=True)
    d = torch.tensor(dense, requires_grad=True)
    grads = torch.autograd.grad(torch_loss(v, d), (v, d), create_graph=True)
    dot = sum((g * torch.tensor(w)).sum() for g, w in zip(grads, u))
    hvp = torch.autograd.grad(dot, (v, d))
    for i, got in enumerate(hvp):
        ref = sum(np.tensordot(np.asarray(jh[i][j]), u[j], u[j].ndim)
                  for j in range(2))
        close(got, ref)


@pytest.mark.parametrize("op", ["coo_spmv", "coo_spmm_raw"])
def test_jvp_of_grad_matches_jax(coo, op):
    """``torch.func.jvp`` of ``torch.func.grad`` (forward over reverse,
    the Hessian-vector product) equals ``jax.jvp`` of ``jax.grad`` on the
    same inputs and direction, f64, rtol 1e-10."""
    rng = np.random.default_rng(6)
    torch_loss, jax_loss, vals, dense = loss_and_operand(coo, op, rng)
    u = [values(rng, x.shape, np.float64) for x in (vals, dense)]
    _, got = torch.func.jvp(torch.func.grad(torch_loss, argnums=(0, 1)),
                            (torch.tensor(vals), torch.tensor(dense)),
                            tuple(map(torch.tensor, u)))
    _, ref = jax.jvp(jax.grad(jax_loss, argnums=(0, 1)),
                     (jnp.asarray(vals), jnp.asarray(dense)),
                     tuple(map(jnp.asarray, u)))
    for g, r in zip(got, ref):
        close(g, r)


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("fn", ["coo_spmm_raw", "coo_spmv", "csr_spmm",
                                "csr_spmv"])
def test_gradgradcheck(dtype, fn):
    """``torch.autograd.gradgradcheck`` (with forward over reverse) of
    ``coo_spmm_raw``, ``coo_spmv``, ``csr.csr_spmm`` and ``csr.csr_spmv``
    in every differentiable operand, alpha and beta included, against
    finite differences: the second derivatives, conjugations and alpha's
    place included, in f64 and c128 (on a 9 x 7 pattern with a repeated
    entry and an empty row, to keep the finite differences few)."""
    rng = np.random.default_rng(7)
    npdt = np.dtype(str(dtype).removeprefix("torch."))
    m, k = 9, 7
    rows = np.array([0, 0, 1, 3, 3, 4, 5, 5, 6, 7, 8, 8, 1], np.int32)
    cols = np.array([1, 4, 0, 2, 6, 3, 0, 5, 4, 1, 2, 6, 0], np.int32)
    tr, tc = torch.tensor(rows), torch.tensor(cols)
    a = sps.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(m, k))
    ip, ix = torch.tensor(a.indptr), torch.tensor(a.indices)

    def leaf(shape):
        return torch.tensor(values(rng, shape, npdt), requires_grad=True)

    two = fn in ("coo_spmm_raw", "csr_spmm")
    dense, out0 = leaf((k, 2) if two else k), leaf((m, 2) if two else m)
    if fn == "coo_spmm_raw":
        f, inputs = (lambda v, b: coo_spmm_raw(tr, tc, v, b, m),
                     (leaf(len(rows)), dense))
    elif fn == "coo_spmv":
        f, inputs = (lambda v, x, y: coo_spmv(tr, tc, v, x, m, -1.5, 0.5,
                                              y), (leaf(len(rows)), dense,
                                                   out0))
    else:
        op = csr.csr_spmm if two else csr.csr_spmv
        alpha = 2.0 - 0.5j if npdt.kind == "c" else 2.0
        f, inputs = (lambda v, d, c: op(ip, ix, v, d, alpha, -1.0, c),
                     (leaf(a.nnz), dense, out0))
    assert torch.autograd.gradgradcheck(f, inputs, check_fwd_over_rev=True)


def test_func_grad_and_per_member_grads(coo):
    """``torch.func.grad``, and ``vmap`` of it over a batch of b (the
    gradient of each member's loss), equal the autograd gradients."""
    rng = np.random.default_rng(4)
    rows, cols, vals = coo
    tr, tc, tv = torch.tensor(rows), torch.tensor(cols), torch.tensor(vals)
    bs = torch.tensor(values(rng, (3, K, N), np.float64))

    def loss(v, b):
        return (coo_spmm_raw(tr, tc, v, b, M) ** 2).sum()

    per_member = torch.func.vmap(torch.func.grad(loss),
                                 in_dims=(None, 0))(tv, bs)
    for i in range(3):
        v = tv.clone().requires_grad_()
        loss(v, bs[i]).backward()
        close(per_member[i], v.grad)
        close(torch.func.grad(loss)(tv, bs[i]), v.grad)


# ---------------------------------------------------------------------------
# vmap and forward mode
# ---------------------------------------------------------------------------


def test_vmap_over_dense_batches(coo, monkeypatch):
    """``torch.func.vmap`` over 5 batches of b equals ``jax.vmap`` and
    runs one K2 call (the batch folded into its columns)."""
    rng = np.random.default_rng(1)
    rows, cols, vals = coo
    bs = rng.random((5, K, N))
    (tr, jr), (tc, jc), (tv, jv) = both(rows, cols, vals)
    ref = jax.vmap(lambda b: _xla.coo_spmm_raw(jr, jc, jv, b, M))(
        jnp.asarray(bs))
    calls = []
    spmm = csr.spmm
    monkeypatch.setattr(csr, "spmm", lambda *a: calls.append(1) or spmm(*a))
    out = torch.func.vmap(lambda b: coo_spmm_raw(tr, tc, tv, b, M))(
        torch.tensor(bs))
    assert out.shape == (5, M, N) and len(calls) == 1
    close(out, ref)


def test_vmap_spmv_over_x_and_y0(coo, monkeypatch):
    """``vmap`` of ``coo_spmv`` over x and y0 equals ``jax.vmap``: one K2
    call with the batch as its columns."""
    rng = np.random.default_rng(5)
    rows, cols, vals = coo
    xs, ys = rng.random((4, K)), rng.random((4, M))
    (tr, jr), (tc, jc), (tv, jv) = both(rows, cols, vals)
    ref = jax.vmap(lambda x, y: _xla.coo_spmv(jr, jc, jv, x, M, 2.0, 3.0, y))(
        jnp.asarray(xs), jnp.asarray(ys))
    calls = []
    spmm = csr.spmm
    monkeypatch.setattr(csr, "spmm", lambda *a: calls.append(1) or spmm(*a))
    out = torch.func.vmap(lambda x, y: coo_spmv(tr, tc, tv, x, M, 2.0, 3.0,
                                                y))(torch.tensor(xs),
                                                    torch.tensor(ys))
    assert out.shape == (4, M) and len(calls) == 1
    close(out, ref)


def test_vmap_over_values(coo):
    """A batch of values (one product per member) equals ``jax.vmap``."""
    rng = np.random.default_rng(6)
    rows, cols, vals = coo
    vs = rng.random((3, len(vals)))
    b = rng.random((K, N))
    (tr, jr), (tc, jc), (tb, jb) = both(rows, cols, b)
    ref = jax.vmap(lambda v: _xla.coo_spmm_raw(jr, jc, v, jb, M))(
        jnp.asarray(vs))
    out = torch.func.vmap(lambda v: coo_spmm_raw(tr, tc, v, tb, M))(
        torch.tensor(vs))
    close(out, ref)


@pytest.mark.parametrize("wrt", ["x", "values"])
def test_jvp_spmv(coo, wrt):
    """``torch.func.jvp`` of ``coo_spmv`` with respect to x and to the
    values equals ``jax.jvp``."""
    rng = np.random.default_rng(2)
    rows, cols, vals = coo
    x = rng.random(K)
    tangent = rng.random(K if wrt == "x" else len(vals))
    (tr, jr), (tc, jc), (tv, jv), (tx, jx) = both(rows, cols, vals, x)
    if wrt == "x":
        y, dy = torch.func.jvp(lambda a: coo_spmv(tr, tc, tv, a, M), (tx,),
                               (torch.tensor(tangent),))
        ry, rdy = jax.jvp(lambda a: _xla.coo_spmv(jr, jc, jv, a, m=M), (jx,),
                          (jnp.asarray(tangent),))
    else:
        y, dy = torch.func.jvp(lambda a: coo_spmv(tr, tc, a, tx, M), (tv,),
                               (torch.tensor(tangent),))
        ry, rdy = jax.jvp(lambda a: _xla.coo_spmv(jr, jc, a, jx, m=M), (jv,),
                          (jnp.asarray(tangent),))
    close(y, ry)
    close(dy, rdy)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_jvp_spmm_in_values_and_b(coo, dtype):
    """``torch.func.jvp`` of ``coo_spmm_raw`` in the values and b at once
    equals ``jax.jvp`` (forward mode is linear: no conjugate)."""
    rng = np.random.default_rng(7)
    rows, cols, vals = with_dtype(coo, dtype, rng)
    b, dv, db = (values(rng, s, dtype) for s in ((K, N), len(vals),
                                                 (K, N)))
    (tr, jr), (tc, jc) = both(rows, cols)
    _, dc = torch.func.jvp(lambda v, bb: coo_spmm_raw(tr, tc, v, bb, M),
                           (torch.tensor(vals), torch.tensor(b)),
                           (torch.tensor(dv), torch.tensor(db)))
    _, rdc = jax.jvp(lambda v, bb: _xla.coo_spmm_raw(jr, jc, v, bb, M),
                     (jnp.asarray(vals), jnp.asarray(b)),
                     (jnp.asarray(dv), jnp.asarray(db)))
    close(dc, rdc)


# ---------------------------------------------------------------------------
# The JAX rules the device API keeps
# ---------------------------------------------------------------------------


def test_rows_outside_dropped(coo):
    """Entries whose row is m or more are dropped, as JAX's
    ``mode="drop"``; their gradients are 0, as JAX's."""
    rng = np.random.default_rng(8)
    rows, cols, vals = coo
    rows = rows.copy()
    rows[::7] = M + rng.integers(0, 3, len(rows[::7]))
    b = rng.random((K, N))
    (tr, jr), (tc, jc) = both(rows, cols)

    def jax_loss(v):
        return jnp.sum(_xla.coo_spmm_raw(jr, jc, v, jnp.asarray(b), M) ** 2)

    tv = torch.tensor(vals, requires_grad=True)
    c = coo_spmm_raw(tr, tc, tv, torch.tensor(b), M)
    close(c, dense_of(rows, cols, vals) @ b)
    (c ** 2).sum().backward()
    g = jax.grad(jax_loss)(jnp.asarray(vals))
    close(tv.grad, g)
    assert not tv.grad[::7].any()


def test_negative_ids_count_from_the_end(coo):
    """Ids by NumPy's rules, as the JAX package's: a row id in [-m, 0)
    and a column id in [-k, 0) count from the end, rows outside [-m, m)
    are dropped.  ROADMAP's two inputs through ``coo_spmv`` and
    ``coo_spmm_raw`` against ``_xla``'s, then the gradients in the values
    of ``MATRIX_1[:40, :30]`` with negative row and column ids against
    ``jax.grad``; a column outside [-k, k) still raises."""
    vals, x = np.array([1.0, 2, 3, 4, 5]), np.array([1.0, 2, 3])
    for rows, cols, want in (([0, 1, -1, 2, 3], [0, 1, 2, 0, 1], [1, 4, 13]),
                             ([0, 1, 2, 2, 0], [0, 1, -1, 0, 1],
                              [11, 4, 13])):
        (tr, jr), (tc, jc), (tv, jv), (tx, jx) = both(
            np.array(rows), np.array(cols), vals, x)
        y = coo_spmv(tr, tc, tv, tx, 3)
        close(y, want)
        close(y, _xla.coo_spmv(jr, jc, jv, jx, 3))
        close(coo_spmm_raw(tr, tc, tv, tx[:, None], 3),
              _xla.coo_spmm_raw(jr, jc, jv, jx[:, None], 3))

    rng = np.random.default_rng(15)
    rows, cols, vals = coo
    rows, cols = rows.copy(), cols.copy()
    rows[::5] -= M
    cols[1::4] -= K
    rows[2] = -M - 1  # outside [-m, m): dropped
    b = rng.random((K, N))
    (tr, jr), (tc, jc) = both(rows, cols)

    def jax_loss(v):
        return jnp.sum(_xla.coo_spmm_raw(jr, jc, v, jnp.asarray(b), M) ** 2)

    tv = torch.tensor(vals, requires_grad=True)
    c = coo_spmm_raw(tr, tc, tv, torch.tensor(b), M)
    close(c, _xla.coo_spmm_raw(jr, jc, jnp.asarray(vals), jnp.asarray(b), M))
    (c ** 2).sum().backward()
    close(tv.grad, jax.grad(jax_loss)(jnp.asarray(vals)))
    assert tv.grad[2] == 0
    cols[0] = -K - 1
    with pytest.raises(ValueError, match="column ids outside"):
        coo_spmm_raw(torch.tensor(rows), torch.tensor(cols),
                     torch.tensor(vals), torch.tensor(b), M)


def test_repeated_entries_keep_separate_gradients(coo):
    """A repeated (row, col) stays two values, each with its own
    gradient (``formats.from_arrays`` would sum them)."""
    rng = np.random.default_rng(9)
    rows, cols, vals = coo
    rows = np.concatenate([rows, rows[:5]])
    cols = np.concatenate([cols, cols[:5]])
    vals = np.concatenate([vals, rng.random(5)])
    b = rng.random((K, N))
    (tr, jr), (tc, jc) = both(rows, cols)
    w = rng.random((M, N))

    def jax_loss(v):
        return jnp.sum(_xla.coo_spmm_raw(jr, jc, v, jnp.asarray(b), M)
                       * jnp.asarray(w))

    tv = torch.tensor(vals, requires_grad=True)
    (coo_spmm_raw(tr, tc, tv, torch.tensor(b), M) * torch.tensor(w)).sum(
    ).backward()
    close(tv.grad, jax.grad(jax_loss)(jnp.asarray(vals)))
    assert tv.grad.shape == (len(vals),)


def test_columns_outside_raise(coo):
    rows, cols, vals = coo
    cols = cols.copy()
    cols[3] = K
    with pytest.raises(ValueError, match="column ids outside"):
        coo_spmm_raw(torch.tensor(rows), torch.tensor(cols),
                     torch.tensor(vals), torch.zeros(K, 2,
                                                     dtype=torch.float64), M)


def test_no_entries():
    """nnz == 0: zeros, and zero gradients, as JAX's."""
    empty = torch.zeros(0, dtype=torch.int32)
    v = torch.zeros(0, dtype=torch.float64, requires_grad=True)
    b = torch.ones(K, 3, dtype=torch.float64, requires_grad=True)
    c = coo_spmm_raw(empty, empty, v, b, M)
    assert c.shape == (M, 3) and not c.any()
    c.sum().backward()
    assert v.grad.shape == (0,) and not b.grad.any()


def test_structure_sorted_once_per_structure(coo, monkeypatch):
    """The same rows and cols tensors find their CSR form again; an
    in-place change to them builds it anew."""
    rows, cols, vals = coo
    tr, tc, tv = torch.tensor(rows), torch.tensor(cols), torch.tensor(vals)
    b = torch.ones(K, 2, dtype=torch.float64)
    monkeypatch.setattr(autograd, "structures",
                        autograd._StructureCache(autograd._CooStructure))
    first = autograd.structures.get(tr, tc, M, K)
    coo_spmm_raw(tr, tc, tv, b, M)
    assert autograd.structures.get(tr, tc, M, K) is first
    tr[0] = tr[0]  # bumps the version counter
    assert autograd.structures.get(tr, tc, M, K) is not first


# ---------------------------------------------------------------------------
# Training: values that change, and the slice as a whole
# ---------------------------------------------------------------------------


def test_transposed_values_follow_in_place_updates(coo):
    """The gradient with respect to b uses A^H's values as they are at the
    backward: after ``vals.data.add_()`` the next one uses the new values
    (the transposed structure is cached, the values never)."""
    rng = np.random.default_rng(10)
    rows, cols, vals = coo
    tr, tc = torch.tensor(rows), torch.tensor(cols)
    v = torch.tensor(vals, requires_grad=True)
    b = torch.tensor(rng.random((K, N)), requires_grad=True)
    for step in range(2):
        b.grad = None
        coo_spmm_raw(tr, tc, v, b, M).sum().backward()
        dense = dense_of(rows, cols, v.detach().numpy())
        close(b.grad, dense.T @ np.ones((M, N)))
        with torch.no_grad():
            v.data.add_(1.0)


def test_container_transpose_follows_data():
    """``CSR.csr_arrays(transpose=True)`` and a CSC's CSR form gather the
    container's current values through the cached permutation."""
    a = sps.random(20, 15, density=0.2, format="csr", random_state=11)
    for mat in (formats.CSR.from_scipy(a), formats.CSC.from_scipy(a.tocsc())):
        transpose = isinstance(mat, formats.CSR)
        ip, ix, dv = mat.csr_arrays(transpose)
        mat.data.mul_(3.0)
        ip2, ix2, dv2 = mat.csr_arrays(transpose)
        assert ip2 is ip and ix2 is ix
        close(dv2, 3.0 * dv)


def bsr_layout(mat, layout):
    """(arrays, dense op(A) they hold) of the BSR ``mat``'s cached
    ``layout``."""
    dense = mat.to_scipy().toarray()
    if layout == "bsr_transpose":
        ip, ix, blocks = mat.bsr_arrays(transpose=True)
        return (ip, ix, blocks), sps.bsr_matrix(
            (blocks.numpy(), ix.numpy(), ip.numpy()),
            shape=dense.T.shape).toarray(), dense.T
    transpose = layout == "element_csr_transpose"
    ip, ix, dv = mat.csr_arrays(transpose)
    ref = dense.T if transpose else dense
    return (ip, ix, dv), sps.csr_matrix(
        (dv.numpy(), ix.numpy(), ip.numpy()), shape=ref.shape).toarray(), ref


@pytest.mark.parametrize("layout", ["bsr_transpose", "element_csr",
                                    "element_csr_transpose", "sorted_csr"])
def test_cached_layouts_follow_data(layout):
    """Every layout a container caches holds structure only: after its
    ``data`` is updated in place, the next call gathers the new values
    (BSR's transposed blocks and element CSR, the sorted copy of rows
    not known sorted), on the same cached index arrays."""
    if layout == "sorted_csr":
        # rows [1, 0] and [2]: columns not ascending in row 0
        mat = formats.CSR(torch.tensor([1.0, 2.0, 3.0]),
                          torch.tensor([1, 0, 2]), torch.tensor([0, 2, 3]),
                          (2, 3))

        def arrays():
            ip, ix, dv = mat.sorted_csr_arrays()
            assert formats.rows_ascend(ip, ix)
            return (ip, ix, dv), sps.csr_matrix(
                (dv.numpy(), ix.numpy(), ip.numpy()), shape=(2, 3)
            ).toarray(), mat.to_dense().numpy()
    else:
        a = sps.random(8, 12, density=0.4, format="csr",
                       random_state=15).tobsr(blocksize=(2, 2))
        mat = formats.to_device(a)

        def arrays():
            return bsr_layout(mat, layout)

    (ip, ix, _), got, ref = arrays()
    close(got, ref)
    mat.data.mul_(3.0)
    (ip2, ix2, _), got, ref2 = arrays()
    assert ip2 is ip and ix2 is ix
    close(got, 3.0 * ref)
    close(ref2, 3.0 * ref)


def test_tracked_calls_reuse_the_pattern(monkeypatch):
    """``csr_spmm`` with an operand that requires grad finds A's
    ``CsrPattern`` again for the same index tensors: three backward passes
    sort A's transpose once, and a plan the caller gives is the
    pattern's."""
    monkeypatch.setattr(autograd, "patterns",
                        autograd._StructureCache(formats.CsrPattern))
    sorts = []
    build = formats.CsrPattern._build_transpose
    monkeypatch.setattr(formats.CsrPattern, "_build_transpose",
                        lambda self: sorts.append(1) or build(self))
    a = sps.random(12, 9, density=0.3, format="csr", random_state=14)
    ip, ix = torch.tensor(a.indptr), torch.tensor(a.indices)
    data = torch.tensor(a.data)
    b = torch.ones(9, 4, dtype=torch.float64, requires_grad=True)
    plan = formats.csr_plan(ip, a.nnz)
    for _ in range(3):
        csr.csr_spmm(ip, ix, data, b, plan=plan).sum().backward()
    assert len(sorts) == 1
    assert autograd.patterns.get(ip, ix, 9).plans[False] is plan
    close(b.grad, 3 * (a.T @ np.ones((12, 4))))


def test_sgd_steps_match_jax(coo):
    """Five SGD steps on ||A(v) b - T||^2 from v = 0, through the port and
    through ``jax.grad``, give the same values and losses."""
    rng = np.random.default_rng(12)
    rows, cols, vals = coo
    b = rng.random((K, N))
    target = dense_of(rows, cols, vals) @ b
    lr = 0.5 / (2 * np.linalg.norm(b, 2) ** 2)
    (tr, jr), (tc, jc), (tb, jb), (tt, jt) = both(rows, cols, b, target)

    def jax_loss(v):
        return jnp.sum((_xla.coo_spmm_raw(jr, jc, v, jb, M) - jt) ** 2)

    jv = jnp.zeros(len(vals))
    v = torch.zeros(len(vals), dtype=torch.float64, requires_grad=True)
    opt = torch.optim.SGD([v], lr=lr)
    for _ in range(5):
        opt.zero_grad()
        loss = ((coo_spmm_raw(tr, tc, v, tb, M) - tt) ** 2).sum()
        loss.backward()
        opt.step()
        jl, jg = jax.value_and_grad(jax_loss)(jv)
        jv = jv - lr * jg
        close(loss.detach(), jl)
        close(v.detach(), jv)


def test_one_graph_on_both_devices():
    """On the CPU, ``csr_spmm`` and ``csr_spmv`` with an operand that
    requires grad build the Functions' nodes, as the card does, not the
    plain versions' ``IndexAddBackward0``; with grad off, or no operand
    requiring grad, the call has no node."""
    a = sps.random(12, 9, density=0.3, format="csr", random_state=13)
    ip, ix = torch.tensor(a.indptr), torch.tensor(a.indices)
    data = torch.tensor(a.data, requires_grad=True)
    b = torch.ones(9, 4, dtype=torch.float64)
    c = csr.csr_spmm(ip, ix, data, b)
    y = csr.csr_spmv(ip, ix, data, b[:, 0])
    assert type(c.grad_fn).__name__ == "CsrSpmmBackward"
    assert type(y.grad_fn).__name__ == "CsrSpmvBackward"
    (c.sum() + y.sum()).backward()
    close(data.grad, a.multiply(0).tocsr().copy().data + 5.0)
    assert csr.csr_spmm(ip, ix, data.detach(), b).grad_fn is None
    with torch.no_grad():
        assert csr.csr_spmm(ip, ix, data, b).grad_fn is None
