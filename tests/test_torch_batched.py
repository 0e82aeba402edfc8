"""One call for a batch: the device API's CSR and BSR Functions under
``torch.func.vmap`` and the transforms built on it, against the JAX
package's ``_xla.coo_spmm_raw``, ``_xla.coo_spmv`` and ``_xla.bsr_spmm``
under ``jax.vmap``, ``jax.grad``, ``jax.jacrev``, ``jax.jacfwd`` and
``jax.hessian``.

``CsrSpmm``, ``CsrSddmm``, ``BsrSpmm`` and ``BsrSddmm`` run a batch of
members that share A's pattern as one call of a batched wrapper
(``csr.spmm_batched``, ``sddmm.sddmm_batched``, ``bsr.spmm_batched``,
``bsr.sddmm_batched``: one launch of K2, K7, K1 or K8 on the card, the
plain version vectorised over the members on the CPU).  Each case counts
the wrapper calls: one per ``vmap`` level, whatever the batch, and no
single-product K7 or K8 call where the transform batches it.  The
batched plain versions are held to loops of the single ones.

Inputs are made from a seed with numpy and go to both packages as numpy
arrays.  Tolerance: rtol 1e-12 (atol 1e-12 times the largest |ref|) in
float64 and complex128, 1e-5 in float32; the two sides sum in different
orders.  PyTorch's gradient of a real loss in complex values is the
conjugate of JAX's; ``torch.func.jacrev`` and ``jacfwd`` take real inputs
only.
"""

import collections

import numpy as np
import numpy.testing as npt
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

import sparse_dot_tpu  # noqa: F401  (enables x64 before any JAX array)
from sparse_dot_tpu.ops import _xla

from sparse_dot_tpu_torch import formats
from sparse_dot_tpu_torch.config import config
from sparse_dot_tpu_torch.ops import (_build, autograd, bsr, bsr_spmm,
                                      coo_spmm_raw, coo_spmv, csr, sddmm,
                                      spgemm, spgemm_grad)

RTOL = {np.dtype(np.float64): 1e-12, np.dtype(np.complex128): 1e-12,
        np.dtype(np.float32): 1e-5, np.dtype(np.complex64): 1e-5}
M, K, N, NNZ = 12, 10, 3, 30
# Every wrapper the Functions call, single and batched: a Function that
# ran one call a member would show as a count of single calls.
WRAPPERS = ((csr, "spmm"), (csr, "spmm_batched"), (csr, "spmv"),
            (sddmm, "sddmm"), (sddmm, "sddmm_batched"), (bsr, "spmm"),
            (bsr, "spmm_batched"), (bsr, "sddmm"), (bsr, "sddmm_batched"),
            (spgemm, "spgemm_dense"), (spgemm, "spgemm_dense_batched"),
            (spgemm, "fill"), (spgemm, "fill_batched"), (spgemm, "product"),
            (spgemm, "product_batched"), (spgemm_grad, "sampled"),
            (spgemm_grad, "sampled_batched"), (spgemm_grad, "sparse_sampled"),
            (spgemm_grad, "sparse_sampled_batched"))


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless asked otherwise; these tests ask
    for the CPU, where its wrappers take their plain versions, on one
    intra-op thread (their many small operations stall in parallel
    regions when the test processes share the cores)."""
    saved = config.device, torch.get_num_threads()
    config.device = "cpu"
    torch.set_num_threads(1)
    yield
    config.device = saved[0]
    torch.set_num_threads(saved[1])


@pytest.fixture
def calls(monkeypatch):
    """The wrapper calls the Functions make ({"module.name": count}) of
    every wrapper, single or batched (``WRAPPERS``), so that a member
    loop in any Function shows as single calls, which the cases' exact
    counts refuse; and no per-member path left in ``ops.autograd`` (its
    ``_batched`` helper is gone)."""
    assert not hasattr(autograd, "_batched"), "a per-member vmap path"
    counts = collections.Counter()
    for mod, name in WRAPPERS:
        def counted(*args, _fn=getattr(mod, name),
                    _key=f"{mod.__name__.rsplit('.', 1)[1]}.{name}",
                    **kwargs):
            counts[_key] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, counted)
    return counts


def close(port, ref, dtype=np.float64):
    if isinstance(port, torch.Tensor):
        port = port.detach().numpy()
    ref = np.asarray(ref)
    rtol = RTOL[np.dtype(dtype)]
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    npt.assert_allclose(port, ref, rtol=rtol, atol=rtol * max(scale, 1e-300))


def values(rng, size, dtype):
    v = rng.standard_normal(size)
    if np.dtype(dtype).kind == "c":
        v = v + 1j * rng.standard_normal(size)
    return v.astype(dtype)


def coo(rng, nnz=NNZ):
    """Expanded COO ids of an M x K matrix with a repeated entry, a row
    counted from the end and a row outside [-M, M) (dropped, as JAX's
    ``mode="drop"``)."""
    rows = rng.integers(0, M, nnz)
    cols = rng.integers(0, K, nnz)
    if nnz > 4:
        rows[1], cols[1] = rows[0], cols[0]
        rows[2] -= M
        rows[3] = M + 1
    return rows, cols


def both(*arrays):
    """Each numpy array as (torch tensor, jax array)."""
    return [(torch.tensor(a), jnp.asarray(a)) for a in arrays]


def blocks(rng, bs, dtype, nbrows=4, nbcols=5, nb=9):
    """(data, block rows, block cols, m, k): ``nb`` random blocks of an
    (nbrows bs) x (nbcols bs) matrix with a repeated block and block row
    2 empty."""
    rows = rng.integers(0, nbrows, nb)
    rows[rows == 2] = 3
    cols = rng.integers(0, nbcols, nb)
    rows[1], cols[1] = rows[0], cols[0]
    return (values(rng, (nb, bs, bs), dtype), rows, cols, nbrows * bs,
            nbcols * bs)


# ---------------------------------------------------------------------------
# vmap over the values: one K2 call
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.complex128, np.float32])
@pytest.mark.parametrize("in_dim", [0, 1])
@pytest.mark.parametrize("b_batched", [False, True])
def test_vmap_over_values(dtype, in_dim, b_batched, calls):
    """``vmap`` of ``coo_spmm_raw`` over 4 sets of values (batch dimension
    0 or 1), with b shared or batched too, equals ``jax.vmap``: one
    batched K2 call."""
    rng = np.random.default_rng(1)
    rows, cols = coo(rng)
    vs = values(rng, (4, NNZ), dtype)
    vs = vs if in_dim == 0 else np.ascontiguousarray(vs.T)
    b = values(rng, (4, K, N) if b_batched else (K, N), dtype)
    (tr, jr), (tc, jc), (tv, jv), (tb, jb) = both(rows, cols, vs, b)
    dims = (in_dim, 0 if b_batched else None)
    out = torch.func.vmap(lambda v, bb: coo_spmm_raw(tr, tc, v, bb, M),
                          in_dims=dims)(tv, tb)
    ref = jax.vmap(lambda v, bb: _xla.coo_spmm_raw(jr, jc, v, bb, M),
                   in_axes=dims)(jv, jb)
    assert out.shape == (4, M, N)
    close(out, ref, dtype)
    assert calls == {"csr.spmm_batched": 1}


@pytest.mark.parametrize("dtype", [np.float64, np.complex128, np.float32])
@pytest.mark.parametrize("size", [3, 5])
@pytest.mark.parametrize("c0", [None, "shared", "batched"])
def test_vmap_over_values_b_shared_groups(dtype, size, c0, calls):
    """``vmap`` over 3 and 5 value sets with b shared (on the card a group
    of ``csr.spmm_group`` members a block, its last group part full):
    ``coo_spmm_raw``, and ``ops.csr.csr_spmm`` with alpha, beta and c0
    shared or per member, equal ``jax.vmap`` of ``_xla.coo_spmm_raw`` (and
    of alpha * A b + beta * c0): one batched K2 call each."""
    rng = np.random.default_rng(40 + size)
    rows, cols = coo(rng)
    vs = values(rng, (size, NNZ), dtype)
    b = values(rng, (K, N), dtype)
    (tr, jr), (tc, jc), (tv, jv), (tb, jb) = both(rows, cols, vs, b)
    out = torch.func.vmap(lambda v: coo_spmm_raw(tr, tc, v, tb, M))(tv)
    ref = jax.vmap(lambda v: _xla.coo_spmm_raw(jr, jc, v, jb, M))(jv)
    assert out.shape == (size, M, N)
    close(out, ref, dtype)
    a = formats.CSR.from_scipy(_csr_matrix(rng, dtype))
    ip, ix, dv = a.csr_arrays()
    a_rows = np.repeat(np.arange(M), np.diff(ip.numpy()))
    vs = values(rng, (size, dv.numel()), dtype)
    c0s = values(rng, (size, M, N) if c0 == "batched" else (M, N), dtype)
    alpha = (1.5 - 0.5j) if np.dtype(dtype).kind == "c" else 1.5
    dims = (0, 0 if c0 == "batched" else None)
    out = torch.func.vmap(lambda v, c: csr.csr_spmm(
        ip, ix, v, tb, alpha, -0.5, None if c0 is None else c),
        in_dims=dims)(torch.tensor(vs), torch.tensor(c0s))
    ref = jax.vmap(lambda v, c: alpha * _xla.coo_spmm_raw(
        jnp.asarray(a_rows), jnp.asarray(ix.numpy()), v, jb, M)
        - 0.5 * (0 if c0 is None else c), in_axes=dims)(jnp.asarray(vs),
                                                       jnp.asarray(c0s))
    close(out, ref, dtype)
    assert calls == {"csr.spmm_batched": 2}
    s = csr.spmm_schedule(N, tb.dtype, NNZ / M)
    assert csr.spmm_group(s, tb.dtype, 4, size) > 1
    assert csr.member_groups(size, 4)[-1][1] == (3 if size == 3 else 1)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("size", [2, 3, 4, 5])
@pytest.mark.parametrize("over", ["blocks", "blocks_and_c0", "b",
                                  "blocks_and_b"])
def test_vmap_bsr_groups(dtype, size, over, calls):
    """``vmap`` of ``ops.bsr_spmm`` at bs 8 over 2-5 members: over the
    blocks with b shared (on the card a group of ``bsr.spmm_group``
    members a block, 3 and 5 ending in a part-full group), over the
    blocks and c0 with alpha and beta (also a group), over b (folded into
    the columns of one single call) and over both (one member a block):
    equals ``jax.vmap`` of ``_xla.bsr_spmm``; one K1 call."""
    rng = np.random.default_rng(70 + size)
    data, rows, cols, m, k = blocks(rng, 8, dtype)
    ds = values(rng, (size, *data.shape), dtype)
    bs_ = values(rng, (size, k, N), dtype)
    c0 = values(rng, (size, m, N), dtype)
    d_in = ds if over != "b" else data
    b_in = bs_ if over in ("b", "blocks_and_b") else bs_[0]
    alpha, beta = (1.5, -0.5) if over == "blocks_and_c0" else (None, None)
    dims = (0 if d_in.ndim == 4 else None, 0 if b_in.ndim == 3 else None,
            0 if over == "blocks_and_c0" else None)
    (tr, jr), (tc, jc) = both(rows, cols)
    out = torch.func.vmap(lambda d, bb, c: bsr_spmm(
        d, tr, tc, bb, m, alpha, beta, c if alpha else None),
        in_dims=dims)(torch.tensor(d_in), torch.tensor(b_in),
                      torch.tensor(c0))
    ref = jax.vmap(lambda d, bb, c: _xla.bsr_spmm(
        d, jr, jc, bb, m, alpha=alpha, beta=beta,
        c0=c if alpha else None), in_axes=dims, axis_size=size)(
        jnp.asarray(d_in), jnp.asarray(b_in), jnp.asarray(c0))
    assert out.shape == (size, m, N)
    close(out, ref, dtype)
    assert calls == {"bsr.spmm" if over == "b" else "bsr.spmm_batched": 1}
    grouped = over in ("blocks", "blocks_and_c0")
    assert (bsr.spmm_group(torch.from_numpy(data).dtype, 8, size,
                           b_in.ndim == 2, d_in.ndim == 4) > 1) == grouped


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("over", ["values", "values_and_x"])
def test_vmap_spmv(dtype, over, calls):
    """``vmap`` of ``coo_spmv`` (alpha, beta, y0) over the values, or the
    values and x, equals ``jax.vmap``: one batched K2 call at n = 1, x and
    y0 as one-column members."""
    rng = np.random.default_rng(2)
    rows, cols = coo(rng)
    vs = values(rng, (5, NNZ), dtype)
    x = values(rng, (5, K) if over == "values_and_x" else K, dtype)
    y0 = values(rng, M, dtype)
    (tr, jr), (tc, jc), (tv, jv), (tx, jx), (ty, jy) = both(rows, cols, vs,
                                                            x, y0)
    dims = (0, 0 if over == "values_and_x" else None)
    out = torch.func.vmap(
        lambda v, xx: coo_spmv(tr, tc, v, xx, M, 2.0, -0.5, ty),
        in_dims=dims)(tv, tx)
    ref = jax.vmap(
        lambda v, xx: _xla.coo_spmv(jr, jc, v, xx, M, 2.0, -0.5, jy),
        in_axes=dims)(jv, jx)
    close(out, ref, dtype)
    assert calls == {"csr.spmm_batched": 1}


# ---------------------------------------------------------------------------
# Per-sample gradients, Jacobians and the Hessian of the CSR device API
# ---------------------------------------------------------------------------

# The wrapper calls of ``vmap(grad(sum |C|^2))`` in (values, b): over b,
# the forward and dL/db fold the batch into K2's columns, dL/dvals is one
# batched K7; over the values, all three are batched calls.
PER_SAMPLE_CALLS = {
    "b": {"csr.spmm": 2, "sddmm.sddmm_batched": 1},
    "values": {"csr.spmm_batched": 2, "sddmm.sddmm_batched": 1},
}


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("over", ["b", "values"])
def test_per_sample_grads(dtype, over, calls):
    """``vmap(grad)`` of sum |C|^2 in (values, b) over 4 b's or 4 sets of
    values equals the conjugate of ``jax.vmap(jax.grad)`` (equal for
    real): one K7 call for the batch."""
    rng = np.random.default_rng(3)
    rows, cols = coo(rng)
    v = values(rng, (4, NNZ) if over == "values" else NNZ, dtype)
    b = values(rng, (4, K, N) if over == "b" else (K, N), dtype)
    (tr, jr), (tc, jc), (tv, jv), (tb, jb) = both(rows, cols, v, b)
    dims = (0, None) if over == "values" else (None, 0)

    def loss(vv, bb):
        return (coo_spmm_raw(tr, tc, vv, bb, M).abs() ** 2).sum()

    def jax_loss(vv, bb):
        return jnp.sum(jnp.abs(_xla.coo_spmm_raw(jr, jc, vv, bb, M)) ** 2)

    grads = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)),
                            in_dims=dims)(tv, tb)
    refs = jax.vmap(jax.grad(jax_loss, argnums=(0, 1)), in_axes=dims)(jv, jb)
    for g, r in zip(grads, refs):
        close(g, np.conj(np.asarray(r)), dtype)
    assert calls == PER_SAMPLE_CALLS[over]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("transform", ["jacrev", "jacfwd"])
def test_jacobian_in_values(dtype, transform, calls):
    """``jacrev`` and ``jacfwd`` of ``coo_spmm_raw`` in the values equal
    JAX's (``torch.func`` takes real inputs only here): jacrev runs one K7
    call for all M * N cotangents, where the per-member path ran M * N;
    jacfwd one batched K2 call for all NNZ tangents."""
    rng = np.random.default_rng(4)
    rows, cols = coo(rng)
    (tr, jr), (tc, jc), (tv, jv), (tb, jb) = both(
        rows, cols, values(rng, NNZ, dtype), values(rng, (K, N), dtype))
    port = getattr(torch.func, transform)(
        lambda v: coo_spmm_raw(tr, tc, v, tb, M))(tv)
    ref = getattr(jax, transform)(
        lambda v: _xla.coo_spmm_raw(jr, jc, v, jb, M))(jv)
    assert port.shape == (M, N, NNZ)
    close(port, ref, dtype)
    if transform == "jacrev":
        assert calls == {"csr.spmm": 1, "sddmm.sddmm_batched": 1}
    else:
        assert calls == {"csr.spmm": 2, "csr.spmm_batched": 1}


def test_hessian_in_values_and_b(calls):
    """``torch.func.hessian`` of sum(sin(C)) in (values, b) equals
    ``jax.hessian``; its calls are a fixed number whatever the sizes, each
    batch one batched call."""
    rng = np.random.default_rng(5)
    rows, cols = coo(rng)
    (tr, jr), (tc, jc), (tv, jv), (tb, jb) = both(
        rows, cols, values(rng, NNZ, np.float64),
        values(rng, (K, N), np.float64))
    port = torch.func.hessian(
        lambda v, b: torch.sin(coo_spmm_raw(tr, tc, v, b, M)).sum(),
        argnums=(0, 1))(tv, tb)
    ref = jax.hessian(
        lambda v, b: jnp.sum(jnp.sin(_xla.coo_spmm_raw(jr, jc, v, b, M))),
        argnums=(0, 1))(jv, jb)
    for port_row, ref_row in zip(port, ref):
        for p, r in zip(port_row, ref_row):
            close(p, r)
    assert calls == {"csr.spmm": 4, "csr.spmm_batched": 2,
                     "sddmm.sddmm_batched": 3}


# ---------------------------------------------------------------------------
# The BSR device function
# ---------------------------------------------------------------------------

# The wrapper calls of each transform of ``bsr_spmm`` in (blocks, b).
BSR_CALLS = {
    "vmap_grad": {"bsr.spmm_batched": 2, "bsr.sddmm_batched": 1},
    "jacrev": {"bsr.spmm": 2, "bsr.sddmm_batched": 1},
    "jacfwd": {"bsr.spmm": 2, "bsr.spmm_batched": 1},
    "hessian": {"bsr.spmm": 4, "bsr.spmm_batched": 2,
                "bsr.sddmm_batched": 3},
}


@pytest.mark.parametrize("bs", [8, 3])
@pytest.mark.parametrize("transform", ["vmap_grad", "jacrev", "jacfwd",
                                       "hessian"])
def test_bsr_transforms(bs, transform, calls):
    """``vmap(grad)`` over 3 sets of blocks, ``jacrev``, ``jacfwd`` and
    ``hessian`` (of sum(sin(C))) of ``ops.bsr_spmm`` in (blocks, b) at bs
    8 (K1 and K8 on the tensor cores on the card) and bs 3 (the CUDA
    cores) equal JAX's transforms of ``_xla.bsr_spmm``, each batch one
    batched call."""
    rng = np.random.default_rng(6 + bs)
    data, rows, cols, m, k = blocks(rng, bs, np.float64, 4, 3, 5)
    b = values(rng, (k, 2), np.float64)
    (tr, jr), (tc, jc) = both(rows, cols)

    def port_fn(d, bb):
        return bsr_spmm(d, tr, tc, bb, m)

    def jax_fn(d, bb):
        return _xla.bsr_spmm(d, jr, jc, bb, m)

    if transform == "vmap_grad":
        ds = values(rng, (3, *data.shape), np.float64)
        port = torch.func.vmap(torch.func.grad(
            lambda d, bb: (port_fn(d, bb) ** 2).sum(), argnums=(0, 1)),
            in_dims=(0, None))(torch.tensor(ds), torch.tensor(b))
        ref = jax.vmap(jax.grad(lambda d, bb: jnp.sum(jax_fn(d, bb) ** 2),
                                argnums=(0, 1)), in_axes=(0, None))(
            jnp.asarray(ds), jnp.asarray(b))
    else:
        wrap = (lambda f: lambda d, bb: jnp.sum(jnp.sin(f(d, bb)))) \
            if transform == "hessian" else (lambda f: f)
        torch_wrap = (lambda f: lambda d, bb: torch.sin(f(d, bb)).sum()) \
            if transform == "hessian" else (lambda f: f)
        port = getattr(torch.func, transform)(torch_wrap(port_fn),
                                              argnums=(0, 1))(
            torch.tensor(data), torch.tensor(b))
        ref = getattr(jax, transform)(wrap(jax_fn), argnums=(0, 1))(
            jnp.asarray(data), jnp.asarray(b))
    for p, r in zip(jax.tree_util.tree_leaves(_as_tree(port)),
                    jax.tree_util.tree_leaves(ref)):
        close(p, r)
    assert calls == BSR_CALLS[transform]


def _as_tree(x):
    """Nested tuples of tensors as nested tuples of numpy arrays."""
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return tuple(_as_tree(t) for t in x)


def test_bsr_per_sample_complex(calls):
    """``vmap(grad)`` of sum |C|^2 over 3 b's at bs 3 in complex128 equals
    the conjugate of ``jax.vmap(jax.grad)``: one batched K8 call."""
    rng = np.random.default_rng(12)
    data, rows, cols, m, k = blocks(rng, 3, np.complex128)
    bs_ = values(rng, (3, k, N), np.complex128)
    (tr, jr), (tc, jc), (td, jd), (tb, jb) = both(rows, cols, data, bs_)
    grads = torch.func.vmap(torch.func.grad(
        lambda d, bb: (bsr_spmm(d, tr, tc, bb, m).abs() ** 2).sum(),
        argnums=(0, 1)), in_dims=(None, 0))(td, tb)
    refs = jax.vmap(jax.grad(
        lambda d, bb: jnp.sum(jnp.abs(_xla.bsr_spmm(d, jr, jc, bb, m)) ** 2),
        argnums=(0, 1)), in_axes=(None, 0))(jd, jb)
    for g, r in zip(grads, refs):
        close(g, np.conj(np.asarray(r)), np.complex128)
    assert calls == {"bsr.spmm": 2, "bsr.sddmm_batched": 1}


# ---------------------------------------------------------------------------
# Nested vmap, a batch of one, no entries, alpha / beta / c0
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("outer", ["values", "b"])
def test_nested_vmap(outer, calls):
    """A 2 x 3 nested ``vmap``: the inner level over 3 sets of values, the
    outer over 2 more (or over 2 b's) equals JAX's nested ``vmap``: the
    outer level merges both batches into one call of 6 members."""
    rng = np.random.default_rng(13)
    rows, cols = coo(rng)
    vs = values(rng, (2, 3, NNZ) if outer == "values" else (3, NNZ),
                np.float64)
    b = values(rng, (2, K, N) if outer == "b" else (K, N), np.float64)
    (tr, jr), (tc, jc), (tv, jv), (tb, jb) = both(rows, cols, vs, b)
    outer_dims = (0, None) if outer == "values" else (None, 0)
    out = torch.func.vmap(torch.func.vmap(
        lambda v, bb: coo_spmm_raw(tr, tc, v, bb, M), in_dims=(0, None)),
        in_dims=outer_dims)(tv, tb)
    ref = jax.vmap(jax.vmap(
        lambda v, bb: _xla.coo_spmm_raw(jr, jc, v, bb, M),
        in_axes=(0, None)), in_axes=outer_dims)(jv, jb)
    assert out.shape == (2, 3, M, N)
    close(out, ref)
    assert calls == {"csr.spmm_batched": 1}


def test_nested_vmap_bsr(calls):
    """The same 2 x 3 nesting over the blocks of ``bsr_spmm``: one call."""
    rng = np.random.default_rng(14)
    data, rows, cols, m, k = blocks(rng, 3, np.float64)
    ds = values(rng, (2, 3, *data.shape), np.float64)
    b = values(rng, (k, N), np.float64)
    (tr, jr), (tc, jc), (td, jd), (tb, jb) = both(rows, cols, ds, b)
    out = torch.func.vmap(torch.func.vmap(
        lambda d: bsr_spmm(d, tr, tc, tb, m)))(td)
    ref = jax.vmap(jax.vmap(lambda d: _xla.bsr_spmm(d, jr, jc, jb, m)))(jd)
    close(out, ref)
    assert calls == {"bsr.spmm_batched": 1}


@pytest.mark.parametrize("nnz", [NNZ, 0])
def test_batch_of_one_and_no_entries(nnz, calls):
    """A batch of one member, and a matrix with no entries, through
    ``vmap`` and per-sample gradients in the values: JAX's results, one
    call a level."""
    rng = np.random.default_rng(15)
    rows, cols = coo(rng, nnz)
    size = 1 if nnz else 3
    vs = values(rng, (size, nnz), np.float64)
    b = values(rng, (K, N), np.float64)
    (tr, jr), (tc, jc), (tv, jv), (tb, jb) = both(rows, cols, vs, b)
    out = torch.func.vmap(lambda v: coo_spmm_raw(tr, tc, v, tb, M))(tv)
    ref = jax.vmap(lambda v: _xla.coo_spmm_raw(jr, jc, v, jb, M))(jv)
    assert out.shape == (size, M, N)
    close(out, ref)
    grads = torch.func.vmap(torch.func.grad(
        lambda v: (coo_spmm_raw(tr, tc, v, tb, M) ** 2).sum()))(tv)
    refs = jax.vmap(jax.grad(
        lambda v: jnp.sum(_xla.coo_spmm_raw(jr, jc, v, jb, M) ** 2)))(jv)
    close(grads, refs)
    assert calls == {"csr.spmm_batched": 2, "sddmm.sddmm_batched": 1}


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_alpha_beta_c0(dtype, calls):
    """``vmap`` over the values and c0 of ``ops.csr.csr_spmm`` and over the
    blocks and c0 of ``ops.bsr_spmm``, with alpha and beta, equals
    ``jax.vmap`` of alpha * A b + beta * c0 (``_xla.coo_spmm_raw``) and of
    ``_xla.bsr_spmm``: one call each."""
    rng = np.random.default_rng(16)
    alpha = (1.5 - 0.5j) if np.dtype(dtype).kind == "c" else 1.5
    a = formats.CSR.from_scipy(_csr_matrix(rng, dtype))
    ip, ix, dv = a.csr_arrays()
    rows = np.repeat(np.arange(M), np.diff(ip.numpy()))
    vs = values(rng, (4, dv.numel()), dtype)
    b, c0s = values(rng, (K, N), dtype), values(rng, (4, M, N), dtype)
    out = torch.func.vmap(lambda v, c: csr.csr_spmm(
        ip, ix, v, torch.tensor(b), alpha, -0.5, c))(torch.tensor(vs),
                                                      torch.tensor(c0s))
    ref = jax.vmap(lambda v, c: alpha * _xla.coo_spmm_raw(
        jnp.asarray(rows), jnp.asarray(ix.numpy()), v, jnp.asarray(b), M)
        - 0.5 * c)(jnp.asarray(vs), jnp.asarray(c0s))
    close(out, ref, dtype)
    data, brows, bcols, m, k = blocks(rng, 3, dtype)
    ds, bb = values(rng, (4, *data.shape), dtype), values(rng, (k, N), dtype)
    c0b = values(rng, (4, m, N), dtype)
    (tr, jr), (tc, jc) = both(brows, bcols)
    out = torch.func.vmap(lambda d, c: bsr_spmm(
        d, tr, tc, torch.tensor(bb), m, alpha, -0.5, c))(torch.tensor(ds),
                                                         torch.tensor(c0b))
    ref = jax.vmap(lambda d, c: _xla.bsr_spmm(
        d, jr, jc, jnp.asarray(bb), m, alpha=alpha, beta=-0.5, c0=c))(
        jnp.asarray(ds), jnp.asarray(c0b))
    close(out, ref, dtype)
    assert calls == {"csr.spmm_batched": 1, "bsr.spmm_batched": 1}


def _csr_matrix(rng, dtype):
    return sps.random(M, K, density=0.3, format="csr",
                      random_state=rng).astype(dtype)


# ---------------------------------------------------------------------------
# The batched forms and their plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shared", ["values", "b", "none"])
def test_batched_forms_gradcheck(shared):
    """``CsrSpmm`` and ``BsrSpmm`` in their batched form (a member
    dimension on some operands, the others shared) pass ``gradcheck`` with
    forward mode, and so do ``CsrSddmm`` and ``BsrSddmm``: the gradient of
    a shared operand is summed over the members."""
    rng = np.random.default_rng(17)
    m, k = 6, 5
    a = formats.CSR.from_scipy(sps.random(m, k, density=0.4, format="csr",
                                          random_state=rng))
    pattern = formats.CsrPattern(*a.csr_arrays()[:2], k)

    def leaf(*shape):
        return torch.tensor(values(rng, shape, np.float64),
                            requires_grad=True)

    data = leaf(pattern.nnz) if shared == "values" else leaf(2, pattern.nnz)
    b = leaf(k, 2) if shared == "b" else leaf(2, k, 2)
    assert torch.autograd.gradcheck(
        lambda d, bb, cc: autograd.CsrSpmm.apply(pattern, d, bb, 1.5, 0.5,
                                                 cc),
        (data, b, leaf(m, 2)), check_forward_ad=True)
    g = leaf(2, m, 2) if shared != "none" else leaf(m, 2)
    assert torch.autograd.gradcheck(
        lambda gg, bb: autograd.CsrSddmm.apply(pattern, gg, bb, -2.0),
        (g, b), check_forward_ad=True)
    blk, brows, bcols, m, k = blocks(rng, 2, np.float64, 4, 3, 4)
    bp = formats.BsrPattern.from_coo(torch.tensor(brows), torch.tensor(bcols),
                                     m, k, 2)
    bdata = (torch.tensor(blk[bp.order.numpy()], requires_grad=True)
             if shared == "values" else leaf(2, bp.nblocks, 2, 2))
    bb = leaf(k, 2) if shared == "b" else leaf(2, k, 2)
    assert torch.autograd.gradcheck(
        lambda d, x: autograd.BsrSpmm.apply(bp, d, x, 0.5, None, None),
        (bdata, bb), check_forward_ad=True)
    gb = leaf(2, m, 2) if shared != "none" else leaf(m, 2)
    assert torch.autograd.gradcheck(
        lambda gg, x: autograd.BsrSddmm.apply(bp, gg, x, 1.5),
        (gb, bb), check_forward_ad=True)


def _split_rows(rng, dtype, long_row=400):
    """CSR arrays of 40 rows with one row of ``long_row`` entries, past 3
    times K2's chunk length (split on the card)."""
    lengths = rng.poisson(2, 40)
    lengths[7] = long_row
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    nnz = int(indptr[-1])
    assert long_row >= 3 * formats.spmm_chunk_length(40, nnz)
    indices = rng.integers(0, 25, nnz).astype(np.int32)
    return torch.tensor(indptr), torch.tensor(indices), nnz


@pytest.mark.parametrize("dtype", [np.float64, np.complex128, np.float32])
@pytest.mark.parametrize("shared", ["values", "b", "none"])
def test_batched_plain_versions_match_loops(dtype, shared, monkeypatch):
    """Each batched plain version (the CPU's batched wrappers) against a
    loop of the single plain versions over its members, with a split row
    (K2), a shared operand read in place or expanded along the members,
    and chunking forced by a small ``config.spmm_chunk_elements``."""
    monkeypatch.setattr(config, "spmm_chunk_elements", 500)
    rng = np.random.default_rng(18)
    ip, ix, nnz = _split_rows(rng, dtype)
    size, n = 3, 5

    def t(*shape):
        return torch.tensor(values(rng, shape, dtype))

    data = t(nnz) if shared == "values" else t(size, nnz)
    b = t(25, n) if shared == "b" else t(size, 25, n)
    c0 = t(size, 40, n)

    def member(x, i, core):
        return x if x.dim() == core else x[i]

    out = csr.spmm_batched(ip, ix, data, b, 2.0, -1.0, c0)
    for i in range(size):
        close(out[i], csr.csr_spmm_plain(ip, ix, member(data, i, 1),
                                         member(b, i, 2), 2.0, -1.0, c0[i]),
              dtype)
    expanded = csr.spmm_batched(ip, ix, data.expand(size, nnz) if
                                data.dim() == 1 else data, b)
    close(expanded, csr.spmm_batched(ip, ix, data, b), dtype)
    g = t(40, n) if shared == "values" else t(size, 40, n)
    out = sddmm.sddmm_batched(ip, ix, g, b, 0.5)
    for i in range(size):
        close(out[i], sddmm.csr_sddmm_plain(ip, ix, member(g, i, 2),
                                            member(b, i, 2), 0.5), dtype)
    bs = 3
    blk, brows, bcols, m, k = blocks(rng, bs, dtype, 4, 5, 9)
    bp = formats.BsrPattern.from_coo(torch.tensor(brows), torch.tensor(bcols),
                                     m, k, bs)
    bdata = (torch.tensor(blk) if shared == "values"
             else t(size, *blk.shape))
    bb = t(k, n) if shared == "b" else t(size, k, n)
    out = bsr.spmm_batched(bp.indptr, bp.indices, bdata, bb, 1.5, 2.0,
                           c0[:, :m])
    for i in range(size):
        close(out[i], bsr.bsr_spmm_plain(bp.indptr, bp.indices,
                                         member(bdata, i, 3),
                                         member(bb, i, 2), 1.5, 2.0,
                                         c0[i, :m]), dtype)
    gb = t(m, n) if shared == "values" else t(size, m, n)
    out = bsr.sddmm_batched(bp.indptr, bp.indices, gb, bb, bs, -1.0)
    for i in range(size):
        close(out[i], bsr.bsr_sddmm_plain(bp.indptr, bp.indices,
                                          member(gb, i, 2), member(bb, i, 2),
                                          bs, -1.0), dtype)


def test_member_launches_and_strides():
    """What the card's batched launches rest on, on the host: a batch past
    the grid's 65,535 is cut into launches of at most that many members;
    a shared or expanded operand has member stride 0; a member stride
    that is not whole 16-byte units takes the scalar path; operands
    whose members are not contiguous, and batches of two sizes, are
    refused."""
    assert _build.MAX_MEMBERS == 65535
    assert csr.member_chunks(70_000) == [(0, 65535), (65535, 4465)]
    assert csr.member_chunks(3) == [(0, 3)]
    b = torch.zeros(4, 6, 2)
    assert csr.member_stride("t", b, 2) == 12
    assert csr.member_stride("t", b[0], 2) == 0
    assert csr.member_stride("t", b[0].expand(4, 6, 2), 2) == 0
    buf = torch.zeros(4 * 13 + 1, dtype=torch.float64)
    odd = buf[1:].as_strided((4, 6, 2), (13, 2, 1))
    assert csr.member_stride("t", odd, 2) == 13
    assert not csr.aligned_members((odd, 13))
    assert csr.aligned_members((b.double(), 12))
    with pytest.raises(ValueError, match="contiguous"):
        csr.member_stride("t", b.transpose(1, 2), 2)
    with pytest.raises(ValueError, match="one member dimension"):
        csr.batch_size("t", ((torch.zeros(3, 5), 1), (torch.zeros(4, 6, 2),
                                                      2)))
    with pytest.raises(ValueError, match="one member dimension"):
        csr.batch_size("t", ((torch.zeros(5), 1), (torch.zeros(6, 2), 2)))
