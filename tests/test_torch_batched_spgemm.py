"""One call for a batch of sparse x sparse values: ``csr_spgemm_dense``
(``CsrSpgemmDense``, its gradients ``CsrSpgemmSddmm``) and ``csr_spgemm``
(``CsrSpgemm``, its gradients ``CsrSpgemmSparseSddmm`` and tangents
``CsrSpgemmFill``) under ``torch.func.vmap`` and the transforms built on
it, against a dense numpy oracle and against the JAX package's
``_xla.spgemm_numeric_sorted`` and ``_xla.esc_spgemm_block`` under
``jax.vmap``, ``jax.grad``, ``jax.jacrev``, ``jax.jacfwd`` and
``jax.hessian``.

The members of a batch share both operands' patterns and differ in their
values, so each ``vmap`` level is one call of a batched wrapper
(``spgemm.spgemm_dense_batched``, ``fill_batched``, ``product_batched``,
``spgemm_grad.sampled_batched``, ``sparse_sampled_batched``: one launch
of K6, K5, K4 + K5, K9 or K11 on the card, the plain version vectorised
over the members on the CPU).  Each case counts the wrapper calls, whatever
the batch size.  The batched plain versions are held to loops of the
single ones, and the batched forms pass ``gradcheck``.

Inputs are made from a seed with numpy.  Tolerances: against the dense
oracle rtol 1e-12 (atol 1e-12 times the largest |ref|) in float64 and
complex128, 1e-5 in float32 and complex64; against JAX as
``test_torch_spgemm_grad.py`` and ``test_torch_spgemm_sparse_grad.py``
hold the single products: ``spgemm_numeric_sorted``'s forward at 1e-12,
its gradients (float32-accurate in float64, through ``densify_sorted``'s
hi|lo limbs) at 1e-6, ``esc_spgemm_block``'s values and gradients at
1e-12 and its Hessian at 1e-10.  PyTorch's gradient of a real loss in
complex values is the conjugate of JAX's; ``torch.func.jacrev``,
``jacfwd`` and ``hessian`` take real inputs here.
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

from sparse_dot_tpu_torch.config import config
from sparse_dot_tpu_torch.formats import CsrPattern
from sparse_dot_tpu_torch.ops import autograd, spgemm, spgemm_grad

from .test_torch_spgemm_sparse_grad import esc_block

M, K, N = 7, 9, 8
RTOL = {np.dtype(np.float64): 1e-12, np.dtype(np.complex128): 1e-12,
        np.dtype(np.float32): 1e-5, np.dtype(np.complex64): 1e-5}
DTYPES = [np.float64, np.complex128, np.float32, np.complex64]
# The wrappers the sparse x sparse Functions call, single and batched.
WRAPPERS = ((spgemm, "spgemm_dense"), (spgemm, "spgemm_dense_batched"),
            (spgemm, "fill"), (spgemm, "fill_batched"), (spgemm, "product"),
            (spgemm, "product_batched"), (spgemm_grad, "sampled"),
            (spgemm_grad, "sampled_batched"),
            (spgemm_grad, "sparse_sampled"),
            (spgemm_grad, "sparse_sampled_batched"))


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


@pytest.fixture
def calls(monkeypatch):
    """The wrapper calls the Functions make ({"module.name": count})."""
    counts = collections.Counter()
    for mod, name in WRAPPERS:
        def counted(*args, _fn=getattr(mod, name),
                    _key=f"{mod.__name__.rsplit('.', 1)[1]}.{name}",
                    **kwargs):
            counts[_key] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, counted)
    return counts


def close(port, ref, dtype=np.float64, rtol=None):
    if isinstance(port, torch.Tensor):
        port = port.detach().numpy()
    ref = np.asarray(ref)
    rtol = RTOL[np.dtype(dtype)] if rtol is None else rtol
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    npt.assert_allclose(port, ref, rtol=rtol, atol=rtol * max(scale, 1.0))


def values(rng, size, dtype):
    v = rng.standard_normal(size)
    if np.dtype(dtype).kind == "c":
        v = v + 1j * rng.standard_normal(size)
    return v.astype(dtype)


def operands(seed, shuffle=False, m=M, k=K, n=N):
    """Random CSR patterns op(A) (m x k) and op(B) (k x n) with an empty
    row each (float64 values, replaced by the cases' own); with
    ``shuffle`` op(B)'s rows list their entries in a random order."""
    rng = np.random.default_rng(seed)
    a = sps.random(m, k, density=0.4, format="lil", random_state=seed)
    b = sps.random(k, n, density=0.4, format="lil", random_state=seed + 1)
    a[3, :] = 0
    b[2, :] = 0
    a, b = a.tocsr(), b.tocsr()
    if shuffle:
        for r in range(k):
            lo, hi = b.indptr[r], b.indptr[r + 1]
            perm = lo + rng.permutation(hi - lo)
            b.indices[lo:hi] = b.indices[perm]
    return a, b


def pattern(x):
    """(indptr, indices) of a scipy CSR as int32 tensors."""
    return (torch.tensor(x.indptr.astype(np.int32)),
            torch.tensor(x.indices.astype(np.int32)))


def dense(x, vals):
    """The dense matrix of CSR x's pattern with values ``vals``."""
    out = np.zeros(x.shape, dtype=np.result_type(vals, np.float32))
    rows = np.repeat(np.arange(x.shape[0]), np.diff(x.indptr))
    np.add.at(out, (rows, x.indices), vals)
    return out


def flat(x):
    """Row-major flat ids of CSR x's entries (``spgemm_numeric_sorted``'s
    sorted flat operands)."""
    rows = np.repeat(np.arange(x.shape[0]), np.diff(x.indptr))
    return jnp.asarray(rows * x.shape[1] + x.indices)


def structure(a, b, triangular=False):
    """C's structural pattern (indptr, indices) as K4 + K5 write it."""
    c = (abs(a).astype(bool).astype(np.int64)
         @ abs(b).astype(bool).astype(np.int64)).tocsr()
    c.data[:] = 1
    if triangular:
        c = sps.triu(c).tocsr()
    c.sort_indices()
    return c.indptr, c.indices


def on_c(c_ptr, c_idx, full):
    """The dense ``full`` (..., m, n) at C's entries, in C's order."""
    rows = np.repeat(np.arange(len(c_ptr) - 1), np.diff(c_ptr))
    return full[..., rows, c_idx]


def sampled(full, x):
    """The dense ``full`` (..., rows, cols) at CSR x's entries."""
    rows = np.repeat(np.arange(x.shape[0]), np.diff(x.indptr))
    return full[..., rows, x.indices]


def esc_values(a, b, a_vals, b_vals, triangular=False):
    """``esc_spgemm_block``'s values of C (one channel, float64) for op(A)
    and op(B)'s values ``a_vals`` and ``b_vals``, its count taken from
    C's structure: ``esc_block`` without its host read of the count, so
    ``jax.vmap`` can batch it."""
    count = len(structure(a, b, triangular)[1])
    m, n = a.shape[0], b.shape[1]
    counts = np.diff(b.indptr)[a.indices]
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    e_total = int(offsets[-1])
    out = _xla.esc_spgemm_block(
        jnp.asarray(np.repeat(np.arange(m), np.diff(a.indptr)), jnp.int32),
        jnp.asarray(a.indices, jnp.int32), a_vals[None],
        jnp.asarray(offsets), jnp.asarray(e_total, jnp.int32),
        jnp.asarray(b.indptr, jnp.int32), jnp.asarray(b.indices, jnp.int32),
        b_vals[None], jnp.asarray(0, jnp.int32), e_pad=e_total, mb=m, n=n,
        nchan=1, key64=False,
        dup_passes=int(np.ceil(np.log2(max(np.diff(a.indptr).max(), 1)))),
        triangular=triangular, perm_sort=False)
    return out[1][:count]


# ---------------------------------------------------------------------------
# Dense output: vmap, per-sample gradients, Jacobians, the Hessian
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batched", ["a", "b", "both"])
def test_vmap_dense(dtype, batched, calls):
    """``vmap`` of ``csr_spgemm_dense`` over 4 value sets of op(A), of
    op(B) or of both, with the batch in dimension 0 and in dimension 1,
    equals the dense oracle and ``jax.vmap`` of ``spgemm_numeric_sorted``:
    one batched K6 call a ``vmap``."""
    rng = np.random.default_rng(1)
    a, b = operands(2)
    a_ip, a_ix = pattern(a)
    b_ip, b_ix = pattern(b)
    av = values(rng, (4, a.nnz) if batched != "b" else a.nnz, dtype)
    bv = values(rng, (4, b.nnz) if batched != "a" else b.nnz, dtype)
    dims = (0 if batched != "b" else None, 0 if batched != "a" else None)
    ref = np.stack([dense(a, av if av.ndim == 1 else av[i])
                    @ dense(b, bv if bv.ndim == 1 else bv[i])
                    for i in range(4)])

    def fn(x, y):
        return spgemm.csr_spgemm_dense(a_ip, a_ix, x, b_ip, b_ix, y, N)

    for in_dim in (0, 1):
        moved = [torch.tensor(np.ascontiguousarray(v.T) if d is not None
                              and in_dim else v)
                 for v, d in ((av, dims[0]), (bv, dims[1]))]
        out = torch.func.vmap(fn, in_dims=tuple(
            None if d is None else in_dim for d in dims))(*moved)
        assert out.shape == (4, M, N)
        close(out, ref, dtype)
    jx = jax.vmap(lambda x, y: _xla.spgemm_numeric_sorted(
        flat(a), x, flat(b), y, M, K, N), in_axes=dims)(jnp.asarray(av),
                                                        jnp.asarray(bv))
    close(out, jx, dtype)
    assert calls == {"spgemm.spgemm_dense_batched": 2}


@pytest.mark.parametrize("size", [2, 3, 4, 5])
@pytest.mark.parametrize("form", ["a", "b", "both", "c0"])
def test_vmap_dense_groups(size, form, calls):
    """``vmap`` of ``csr_spgemm_dense`` over 2-5 members in each form that
    a group of K6 serves on the card (``spgemm.dense_form``: op(A)'s
    values per member with op(B)'s shared, op(B)'s with op(A)'s shared,
    both, or only c0 with alpha and beta; ``spgemm.dense_group`` members
    a block, 3 and 5 ending in a part-full group), float64, ``triangular``
    at odd sizes: equals ``jax.vmap`` of ``spgemm_numeric_sorted`` (alpha
    times it plus beta * c0 in the c0 form) and the dense oracle; one
    batched K6 call."""
    rng = np.random.default_rng(60 + size)
    a, b = operands(61)
    a_ip, a_ix = pattern(a)
    b_ip, b_ix = pattern(b)
    tri = bool(size % 2)
    av = values(rng, (size, a.nnz) if form in ("a", "both") else a.nnz,
                np.float64)
    bv = values(rng, (size, b.nnz) if form in ("b", "both") else b.nnz,
                np.float64)
    c0 = values(rng, (size, M, N), np.float64)
    alpha, beta = (-1.5, 2.0) if form == "c0" else (None, None)
    dims = (0 if av.ndim == 2 else None, 0 if bv.ndim == 2 else None,
            0 if form == "c0" else None)
    out = torch.func.vmap(
        lambda x, y, c: spgemm.csr_spgemm_dense(
            a_ip, a_ix, x, b_ip, b_ix, y, N, alpha, beta,
            c if form == "c0" else None, tri),
        in_dims=dims)(torch.tensor(av), torch.tensor(bv), torch.tensor(c0))
    assert out.shape == (size, M, N)
    prods = np.stack([dense(a, av if av.ndim == 1 else av[i])
                      @ dense(b, bv if bv.ndim == 1 else bv[i])
                      for i in range(size)])
    if tri:
        prods = np.triu(prods)
    jx = jax.vmap(lambda x, y: _xla.spgemm_numeric_sorted(
        flat(a), x, flat(b), y, M, K, N, triangular=tri),
        in_axes=dims[:2], axis_size=size)(jnp.asarray(av), jnp.asarray(bv))
    if form == "c0":
        prods = alpha * prods + beta * c0
        jx = alpha * jx + beta * jnp.asarray(c0)
    close(out, prods)
    close(out, jx)
    assert calls == {"spgemm.spgemm_dense_batched": 1}
    strides = (a.nnz if av.ndim == 2 else 0, b.nnz if bv.ndim == 2 else 0)
    shape = spgemm.dense_form(*strides)
    assert shape == {"a": spgemm.B_SHARED, "b": spgemm.B_PER_MEMBER,
                     "both": spgemm.B_PER_MEMBER, "c0": spgemm.ONE_SUM}[form]
    assert spgemm.dense_group(torch.float64, 4, size, shape) > 1


@pytest.mark.parametrize("triangular", [False, True])
@pytest.mark.parametrize("epilogue", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_vmap_dense_options(triangular, epilogue, shuffle, calls):
    """``vmap`` over 3 value sets of both operands (and of c0 with the
    epilogue: alpha * op(A) op(B) + beta * c0, c0 added everywhere) with
    and without ``triangular``, over op(B) whose rows are sorted or
    shuffled (sorted once for the batch), in complex128: the dense
    oracle, and ``jax.vmap`` of ``spgemm_numeric_sorted`` (triangular,
    no epilogue, which it lacks); one batched K6 call."""
    rng = np.random.default_rng(3)
    a, b = operands(4, shuffle)
    a_ip, a_ix = pattern(a)
    b_ip, b_ix = pattern(b)
    av, bv = values(rng, (3, a.nnz), np.complex128), values(
        rng, (3, b.nnz), np.complex128)
    c0 = values(rng, (3, M, N), np.complex128)
    alpha, beta = (1.5 - 0.5j, -0.25) if epilogue else (None, None)
    out = torch.func.vmap(lambda x, y, c: spgemm.csr_spgemm_dense(
        a_ip, a_ix, x, b_ip, b_ix, y, N, alpha, beta,
        c if epilogue else None, triangular))(
        *map(torch.tensor, (av, bv, c0)))
    ref = np.stack([dense(a, av[i]) @ dense(b, bv[i]) for i in range(3)])
    ref = np.triu(ref) if triangular else ref
    if epilogue:
        ref = alpha * ref + beta * c0
    close(out, ref, np.complex128)
    if not epilogue:
        bs = b.copy()
        bs.data = np.arange(b.nnz, dtype=np.float64)
        bs.sort_indices()
        order = bs.data.astype(np.int64)
        jx = jax.vmap(lambda x, y: _xla.spgemm_numeric_sorted(
            flat(a), x, flat(bs), y, M, K, N, triangular=triangular))(
            jnp.asarray(av), jnp.asarray(bv[:, order]))
        close(out, jx, np.complex128)
    assert calls == {"spgemm.spgemm_dense_batched": 1}


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("over", ["a", "w"])
def test_per_sample_grads_dense(dtype, over, calls):
    """``vmap(grad)`` of sum(Re(C conj(W))) in both operands' values, over
    3 value sets of op(A) or over 3 W's, with ``triangular``: the oracle
    conj(G') op(B)^H at op(A)'s entries and op(A)^H G' at op(B)'s (G' =
    triu(W)) at 1e-12, and the conjugate of ``jax.vmap(jax.grad)`` of
    ``spgemm_numeric_sorted`` at 1e-6; one K6 call (batched over op(A)'s
    values) and one batched K9 call a form."""
    rng = np.random.default_rng(5)
    a, b = operands(6)
    a_ip, a_ix = pattern(a)
    b_ip, b_ix = pattern(b)
    av = values(rng, (3, a.nnz) if over == "a" else a.nnz, dtype)
    bv = values(rng, b.nnz, dtype)
    w = values(rng, (3, M, N) if over == "w" else (M, N), dtype)
    dims = (0, None, None) if over == "a" else (None, None, 0)

    def loss(x, y, ww):
        c = spgemm.csr_spgemm_dense(a_ip, a_ix, x, b_ip, b_ix, y, N,
                                    triangular=True)
        return (c * ww.conj()).real.sum()

    ga, gb = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)),
                             in_dims=dims)(*map(torch.tensor, (av, bv, w)))
    for i in range(3):
        ai = av[i] if av.ndim == 2 else av
        g = np.triu(w[i] if w.ndim == 3 else w)
        close(ga[i], sampled(g @ dense(b, bv).conj().T, a), dtype)
        close(gb[i], sampled(dense(a, ai).conj().T @ g, b), dtype)

    def jax_loss(x, y, ww):
        c = _xla.spgemm_numeric_sorted(flat(a), x, flat(b), y, M, K, N,
                                       triangular=True)
        return jnp.sum(jnp.real(c * jnp.conj(ww)))

    refs = jax.vmap(jax.grad(jax_loss, argnums=(0, 1)), in_axes=dims)(
        *map(jnp.asarray, (av, bv, w)))
    for port, ref in zip((ga, gb), refs):
        close(port, np.conj(np.asarray(ref)), rtol=1e-6)
    # Over the W's alone the product itself is one member's.
    assert calls == {"spgemm.spgemm_dense" + (
        "_batched" if over == "a" else ""): 1,
        "spgemm_grad.sampled_batched": 2}


# The wrapper calls of each transform of ``csr_spgemm_dense`` in op(A)'s
# values (jacrev, jacfwd) or in both operands' (hessian).  jacfwd's second
# batched call is the tangent's term in op(B)'s values, which torch.func
# hands the ``jvp`` as zeros.
DENSE_CALLS = {
    "jacrev": {"spgemm.spgemm_dense": 1, "spgemm_grad.sampled_batched": 1},
    "jacfwd": {"spgemm.spgemm_dense": 1, "spgemm.spgemm_dense_batched": 2},
    "hessian": {"spgemm.spgemm_dense": 1, "spgemm.spgemm_dense_batched": 2,
                "spgemm_grad.sampled_batched": 6},
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("transform", ["jacrev", "jacfwd"])
def test_jacobians_dense(dtype, transform, calls):
    """``jacrev`` (one batched K9 call for all M * N cotangents) and
    ``jacfwd`` (one batched K6 call for all tangents) of
    ``csr_spgemm_dense`` in op(A)'s values: the oracle (dC[i, j] /
    da_p = op(B)[k_p, j] where i = r_p) and JAX's transform of
    ``spgemm_numeric_sorted`` (at 1e-6 in float64)."""
    rng = np.random.default_rng(7)
    a, b = operands(8)
    a_ip, a_ix = pattern(a)
    b_ip, b_ix = pattern(b)
    av, bv = values(rng, a.nnz, dtype), values(rng, b.nnz, dtype)
    port = getattr(torch.func, transform)(lambda x: spgemm.csr_spgemm_dense(
        a_ip, a_ix, x, b_ip, b_ix, torch.tensor(bv), N))(torch.tensor(av))
    rows = np.repeat(np.arange(M), np.diff(a.indptr))
    ref = np.zeros((M, N, a.nnz))
    ref[rows, :, np.arange(a.nnz)] = dense(b, bv)[a.indices]
    close(port, ref, dtype)
    jx = getattr(jax, transform)(lambda x: _xla.spgemm_numeric_sorted(
        flat(a), x, flat(b), jnp.asarray(bv), M, K, N))(jnp.asarray(av))
    close(port, jx, rtol=max(RTOL[np.dtype(dtype)], 1e-6))
    assert calls == DENSE_CALLS[transform]


def dense_torch_hessian(a, b, av, bv, triangular):
    """torch's Hessian of sum(sin(C)) (upper triangle under
    ``triangular``) through dense matrices scattered from the values:
    plain torch, no port Function."""
    fa, fb = (torch.tensor(np.asarray(flat(x))) for x in (a, b))

    def loss(x, y):
        da = torch.zeros(M * K, dtype=x.dtype).scatter(0, fa, x).view(M, K)
        db = torch.zeros(K * N, dtype=y.dtype).scatter(0, fb, y).view(K, N)
        c = da @ db
        return torch.sin(torch.triu(c) if triangular else c).sum()

    return torch.func.hessian(loss, argnums=(0, 1))(torch.tensor(av),
                                                    torch.tensor(bv))


@pytest.mark.parametrize("triangular", [False, True])
def test_hessian_dense(triangular, calls):
    """``torch.func.hessian`` of sum(sin(C)) in both operands' values
    (forward over reverse: ``vmap`` of the backward's ``jvp``, one batched
    call a level) equals torch's dense Hessian at 1e-12 and
    ``jax.hessian`` of ``spgemm_numeric_sorted`` at 1e-6."""
    rng = np.random.default_rng(9)
    a, b = operands(10)
    a_ip, a_ix = pattern(a)
    b_ip, b_ix = pattern(b)
    av, bv = values(rng, a.nnz, np.float64), values(rng, b.nnz, np.float64)
    port = torch.func.hessian(lambda x, y: torch.sin(
        spgemm.csr_spgemm_dense(a_ip, a_ix, x, b_ip, b_ix, y, N,
                                triangular=triangular)).sum(),
        argnums=(0, 1))(torch.tensor(av), torch.tensor(bv))
    ref = dense_torch_hessian(a, b, av, bv, triangular)
    jh = jax.hessian(lambda x, y: jnp.sum(jnp.sin(
        _xla.spgemm_numeric_sorted(flat(a), x, flat(b), y, M, K, N,
                                   triangular=triangular))),
        argnums=(0, 1))(jnp.asarray(av), jnp.asarray(bv))
    for i in range(2):
        for j in range(2):
            close(port[i][j], ref[i][j].numpy())
            close(port[i][j], jh[i][j], rtol=1e-6)
    assert np.abs(ref[0][1].numpy()).max() > 0.1
    assert calls == DENSE_CALLS["hessian"]


@pytest.mark.parametrize("outer", ["a", "b"])
def test_nested_vmap_dense(outer, calls):
    """A 2 x 3 nested ``vmap``: the inner level over 3 value sets of
    op(A), the outer over 2 more (or over 2 of op(B)): ``jax.vmap``'s
    nesting and the oracle; the outer level merges both batches into one
    call of 6 members."""
    rng = np.random.default_rng(11)
    a, b = operands(12)
    a_ip, a_ix = pattern(a)
    b_ip, b_ix = pattern(b)
    av = values(rng, (2, 3, a.nnz) if outer == "a" else (3, a.nnz),
                np.float64)
    bv = values(rng, (2, b.nnz) if outer == "b" else b.nnz, np.float64)
    dims = (0, None) if outer == "a" else (None, 0)
    out = torch.func.vmap(torch.func.vmap(
        lambda x, y: spgemm.csr_spgemm_dense(a_ip, a_ix, x, b_ip, b_ix, y,
                                             N), in_dims=(0, None)),
        in_dims=dims)(torch.tensor(av), torch.tensor(bv))
    ref = jax.vmap(jax.vmap(lambda x, y: _xla.spgemm_numeric_sorted(
        flat(a), x, flat(b), y, M, K, N), in_axes=(0, None)),
        in_axes=dims)(jnp.asarray(av), jnp.asarray(bv))
    assert out.shape == (2, 3, M, N)
    close(out, ref)
    for i in range(2):
        for j in range(3):
            x = av[i, j] if outer == "a" else av[j]
            y = bv[i] if outer == "b" else bv
            close(out[i, j], dense(a, x) @ dense(b, y))
    assert calls == {"spgemm.spgemm_dense_batched": 1}


# ---------------------------------------------------------------------------
# Sparse output: vmap, per-sample gradients, Jacobians, the Hessian
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batched", ["a", "b", "both"])
def test_vmap_sparse(dtype, batched, calls):
    """``vmap`` of ``csr_spgemm`` over 4 value sets of op(A), of op(B) or
    of both: each member's values on the one structural pattern (indptr
    and indices shared, not batched) equal the dense oracle at C's
    entries, and in float64 ``jax.vmap`` of ``esc_spgemm_block``: one
    batched product (one K4, one batched K5)."""
    rng = np.random.default_rng(13)
    a, b = operands(14)
    a_ip, a_ix = pattern(a)
    b_ip, b_ix = pattern(b)
    av = values(rng, (4, a.nnz) if batched != "b" else a.nnz, dtype)
    bv = values(rng, (4, b.nnz) if batched != "a" else b.nnz, dtype)
    dims = (0 if batched != "b" else None, 0 if batched != "a" else None)
    ip, ix, data = torch.func.vmap(
        lambda x, y: spgemm.csr_spgemm(a_ip, a_ix, x, b_ip, b_ix, y, N),
        in_dims=dims, out_dims=(None, None, 0))(torch.tensor(av),
                                                torch.tensor(bv))
    c_ptr, c_idx = structure(a, b)
    assert np.array_equal(ip.numpy(), c_ptr)
    assert np.array_equal(ix.numpy(), c_idx)
    assert data.shape == (4, len(c_idx))
    ref = np.stack([dense(a, av if av.ndim == 1 else av[i])
                    @ dense(b, bv if bv.ndim == 1 else bv[i])
                    for i in range(4)])
    close(data, on_c(c_ptr, c_idx, ref), dtype)
    if dtype == np.float64:
        jx = jax.vmap(lambda x, y: esc_values(a, b, x, y), in_axes=dims)(
            jnp.asarray(av), jnp.asarray(bv))
        close(data, jx)
    assert calls == {"spgemm.product_batched": 1}


@pytest.mark.parametrize("size", [3, 5])
@pytest.mark.parametrize("batched", ["a", "b"])
@pytest.mark.parametrize("triangular", [False, True])
def test_vmap_sparse_groups(size, batched, triangular, calls):
    """``vmap`` of ``csr_spgemm`` over 3 and 5 value sets of op(A) with
    op(B) shared, or of op(B) with op(A) shared (on the card K5's groups
    of ``spgemm.fill_groups`` members a block, the last part full), float64:
    each member's values equal ``jax.vmap`` of ``esc_spgemm_block`` and
    the dense oracle at C's entries; one batched product."""
    rng = np.random.default_rng(50 + size)
    a, b = operands(51)
    a_ip, a_ix = pattern(a)
    b_ip, b_ix = pattern(b)
    av = values(rng, (size, a.nnz) if batched == "a" else a.nnz, np.float64)
    bv = values(rng, (size, b.nnz) if batched == "b" else b.nnz, np.float64)
    dims = (0 if batched == "a" else None, 0 if batched == "b" else None)
    ip, ix, data = torch.func.vmap(
        lambda x, y: spgemm.csr_spgemm(a_ip, a_ix, x, b_ip, b_ix, y, N,
                                       triangular),
        in_dims=dims, out_dims=(None, None, 0))(torch.tensor(av),
                                                torch.tensor(bv))
    c_ptr, c_idx = structure(a, b, triangular)
    assert np.array_equal(ip.numpy(), c_ptr)
    assert np.array_equal(ix.numpy(), c_idx)
    assert data.shape == (size, len(c_idx))
    ref = np.stack([dense(a, av if av.ndim == 1 else av[i])
                    @ dense(b, bv if bv.ndim == 1 else bv[i])
                    for i in range(size)])
    close(data, on_c(c_ptr, c_idx, ref))
    jx = jax.vmap(lambda x, y: esc_values(a, b, x, y, triangular),
                  in_axes=dims)(jnp.asarray(av), jnp.asarray(bv))
    close(data, jx)
    assert calls == {"spgemm.product_batched": 1}


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("triangular", [False, True])
def test_per_sample_grads_sparse(dtype, triangular, calls):
    """``vmap(grad)`` of sum(Re(C conj(W))) over 3 value sets of op(A),
    W fixed on C's pattern: the oracle (G op(B)^H at op(A)'s entries,
    op(A)^H G at op(B)'s, G = W on C's pattern) at 1e-12, and in float64
    ``jax.vmap(jax.grad)`` of ``esc_spgemm_block`` at 1e-12; one batched
    product and one batched K11 call a form."""
    rng = np.random.default_rng(15)
    a, b = operands(16)
    a_ip, a_ix = pattern(a)
    b_ip, b_ix = pattern(b)
    c_ptr, c_idx = structure(a, b, triangular)
    av, bv = values(rng, (3, a.nnz), dtype), values(rng, b.nnz, dtype)
    w = values(rng, len(c_idx), dtype)

    def loss(x, y):
        data = spgemm.csr_spgemm(a_ip, a_ix, x, b_ip, b_ix, y, N,
                                 triangular)[2]
        return (data * torch.tensor(w).conj()).real.sum()

    ga, gb = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)),
                             in_dims=(0, None))(torch.tensor(av),
                                                torch.tensor(bv))
    g = dense(sps.csr_matrix((np.ones(len(c_idx)), c_idx, c_ptr),
                             shape=(M, N)), w)
    for i in range(3):
        close(ga[i], sampled(g @ dense(b, bv).conj().T, a), dtype)
        close(gb[i], sampled(dense(a, av[i]).conj().T @ g, b), dtype)
    if dtype == np.float64:
        refs = jax.vmap(jax.grad(
            lambda x, y: jnp.sum(esc_values(a, b, x, y, triangular) * w),
            argnums=(0, 1)), in_axes=(0, None))(jnp.asarray(av),
                                                jnp.asarray(bv))
        for port, ref in zip((ga, gb), refs):
            close(port, ref)
    assert calls == {"spgemm.product_batched": 1,
                     "spgemm_grad.sparse_sampled_batched": 2}


# The wrapper calls of each transform of ``csr_spgemm``'s values in
# op(A)'s values (jacrev, jacfwd) or in both operands' (hessian).  jacfwd's
# single fill is the tangent's term in op(B)'s values (zeros, as above).
SPARSE_CALLS = {
    "jacrev": {"spgemm.product": 1,
               "spgemm_grad.sparse_sampled_batched": 1},
    "jacfwd": {"spgemm.product": 1, "spgemm.fill_batched": 1,
               "spgemm.fill": 1},
    "hessian": {"spgemm.product": 1, "spgemm.fill_batched": 2,
                "spgemm_grad.sparse_sampled_batched": 6},
}


@pytest.mark.parametrize("transform", ["jacrev", "jacfwd"])
def test_jacobians_sparse(transform, calls):
    """``jacrev`` (one batched K11 call for all cotangents) and ``jacfwd``
    (one batched K5 call for all tangents) of ``csr_spgemm``'s values in
    op(A)'s values: the oracle (d data[c] / da_p = op(B)[k_p, j_c] where
    C's entry c is (r_p, j_c)) and JAX's transform of
    ``esc_spgemm_block`` at 1e-12."""
    rng = np.random.default_rng(17)
    a, b = operands(18)
    a_ip, a_ix = pattern(a)
    b_ip, b_ix = pattern(b)
    av, bv = values(rng, a.nnz, np.float64), values(rng, b.nnz, np.float64)
    port = getattr(torch.func, transform)(lambda x: spgemm.csr_spgemm(
        a_ip, a_ix, x, b_ip, b_ix, torch.tensor(bv), N)[2])(
        torch.tensor(av))
    c_ptr, c_idx = structure(a, b)
    rows = np.repeat(np.arange(M), np.diff(a.indptr))
    full = np.zeros((M, N, a.nnz))
    full[rows, :, np.arange(a.nnz)] = dense(b, bv)[a.indices]
    ref = full[np.repeat(np.arange(M), np.diff(c_ptr)), c_idx]
    close(port, ref)
    jx = getattr(jax, transform)(lambda x: esc_block(
        a, b, x[None], jnp.asarray(bv)[None], False)[0])(jnp.asarray(av))
    close(port, jx)
    assert calls == SPARSE_CALLS[transform]


@pytest.mark.parametrize("triangular", [False, True])
def test_hessian_sparse(triangular, calls):
    """``torch.func.hessian`` of sum(sin(C's values)) in both operands'
    values equals torch's dense Hessian of the same loss (sin of the
    product at C's entries) at 1e-12 and ``jax.hessian`` of
    ``esc_spgemm_block`` at 1e-10; one product, then batched calls."""
    rng = np.random.default_rng(19)
    a, b = operands(20)
    a_ip, a_ix = pattern(a)
    b_ip, b_ix = pattern(b)
    av, bv = values(rng, a.nnz, np.float64), values(rng, b.nnz, np.float64)
    port = torch.func.hessian(lambda x, y: torch.sin(spgemm.csr_spgemm(
        a_ip, a_ix, x, b_ip, b_ix, y, N, triangular)[2]).sum(),
        argnums=(0, 1))(torch.tensor(av), torch.tensor(bv))
    c_ptr, c_idx = structure(a, b, triangular)
    c_rows = torch.tensor(np.repeat(np.arange(M), np.diff(c_ptr)))
    fa, fb = (torch.tensor(np.asarray(flat(x))) for x in (a, b))

    def dense_loss(x, y):
        da = torch.zeros(M * K, dtype=x.dtype).scatter(0, fa, x).view(M, K)
        db = torch.zeros(K * N, dtype=y.dtype).scatter(0, fb, y).view(K, N)
        return torch.sin((da @ db)[c_rows, torch.tensor(c_idx)]).sum()

    ref = torch.func.hessian(dense_loss, argnums=(0, 1))(torch.tensor(av),
                                                         torch.tensor(bv))
    jh = jax.hessian(lambda x, y: jnp.sum(jnp.sin(esc_block(
        a, b, x[None], y[None], triangular)[0])), argnums=(0, 1))(
        jnp.asarray(av), jnp.asarray(bv))
    for i in range(2):
        for j in range(2):
            close(port[i][j], ref[i][j].numpy())
            close(port[i][j], jh[i][j], rtol=1e-10)
    assert calls == SPARSE_CALLS["hessian"]


def test_nested_vmap_sparse(calls):
    """A 2 x 3 nested ``vmap`` of ``csr_spgemm`` over op(A)'s values
    (inner) and op(B)'s (outer): the oracle and ``jax.vmap``'s nesting of
    ``esc_spgemm_block``; one batched product of 6 members, C's pattern
    shared."""
    rng = np.random.default_rng(21)
    a, b = operands(22)
    a_ip, a_ix = pattern(a)
    b_ip, b_ix = pattern(b)
    av, bv = values(rng, (3, a.nnz), np.float64), values(
        rng, (2, b.nnz), np.float64)
    data = torch.func.vmap(torch.func.vmap(
        lambda x, y: spgemm.csr_spgemm(a_ip, a_ix, x, b_ip, b_ix, y, N)[2],
        in_dims=(0, None)), in_dims=(None, 0))(torch.tensor(av),
                                               torch.tensor(bv))
    c_ptr, c_idx = structure(a, b)
    assert data.shape == (2, 3, len(c_idx))
    ref = jax.vmap(jax.vmap(lambda x, y: esc_values(a, b, x, y),
                            in_axes=(0, None)), in_axes=(None, 0))(
        jnp.asarray(av), jnp.asarray(bv))
    close(data, ref)
    for i in range(2):
        for j in range(3):
            close(data[i, j], on_c(c_ptr, c_idx,
                                   dense(a, av[j]) @ dense(b, bv[i])))
    assert calls == {"spgemm.product_batched": 1}


def test_batch_of_one_and_no_entries(calls):
    """A batch of one member, and an op(A) with no entries, through
    ``vmap`` and ``vmap(grad)`` of both products: the oracle's values and
    zero gradients, one call a level."""
    rng = np.random.default_rng(23)
    a, b = operands(24)
    b_ip, b_ix = pattern(b)
    empty = sps.csr_matrix((M, K))
    bv = torch.tensor(values(rng, b.nnz, np.float64))
    for x, size in ((a, 1), (empty, 3)):
        a_ip, a_ix = pattern(x)
        av = values(rng, (size, x.nnz), np.float64)
        out = torch.func.vmap(lambda v: spgemm.csr_spgemm_dense(
            a_ip, a_ix, v, b_ip, b_ix, bv, N))(torch.tensor(av))
        close(out, np.stack([dense(x, v) @ dense(b, bv.numpy())
                             for v in av]))
        grads = torch.func.vmap(torch.func.grad(lambda v: (
            spgemm.csr_spgemm(a_ip, a_ix, v, b_ip, b_ix, bv, N)[2] ** 2)
            .sum()))(torch.tensor(av))
        assert grads.shape == (size, x.nnz)
        c = [dense(x, v) @ dense(b, bv.numpy()) for v in av]
        for v, g, cc in zip(av, grads, c):
            close(g, sampled(2 * cc @ dense(b, bv.numpy()).T, x))
    assert calls == {"spgemm.spgemm_dense_batched": 2,
                     "spgemm.product_batched": 2,
                     "spgemm_grad.sparse_sampled_batched": 2}


@pytest.mark.parametrize("function", ["sddmm_dA", "sddmm_dB", "sparse_dA",
                                      "sparse_dB", "fill"])
def test_vmap_gradient_functions(function, calls):
    """``vmap`` of the gradient Functions themselves (``CsrSpgemmSddmm``
    in both forms, ``CsrSpgemmSparseSddmm`` in both forms,
    ``CsrSpgemmFill``) over 4 members of G or of the values, with the
    batch in dimension 1: one batched call, each member equal to the
    Function's single call."""
    rng = np.random.default_rng(30)
    a, b = operands(31)
    pa, pb = CsrPattern(*pattern(a), K), CsrPattern(*pattern(b), N)
    av, bv = (torch.tensor(values(rng, (x.nnz, 4), np.complex128))
              for x in (a, b))
    ip, ix, _ = spgemm.spgemm_plain(pa.indptr, pa.indices, av[:, 0],
                                    pb.indptr, pb.indices, bv[:, 0], N)
    d = torch.tensor(values(rng, (M, 4, N), np.complex128))
    g = torch.tensor(values(rng, (ix.numel(), 4), np.complex128))
    fns = {
        "sddmm_dA": (lambda dd, y: autograd.CsrSpgemmSddmm.apply(
            pa, dd, pb, y, 0.5, False), (d, bv), (1, 1),
            "spgemm_grad.sampled"),
        "sddmm_dB": (lambda dd, x: autograd.CsrSpgemmSddmm.apply(
            pb, dd, pa, x, 0.5, True), (d, av), (1, 1),
            "spgemm_grad.sampled"),
        "sparse_dA": (lambda y, gg: autograd.CsrSpgemmSparseSddmm.apply(
            pa, av[:, 0], pb, y, ip, ix, gg, False, False), (bv, g), (1, 1),
            "spgemm_grad.sparse_sampled"),
        "sparse_dB": (lambda x, gg: autograd.CsrSpgemmSparseSddmm.apply(
            pa, x, pb, bv[:, 0], ip, ix, gg, True, False), (av, g), (1, 1),
            "spgemm_grad.sparse_sampled"),
        "fill": (lambda x, y: autograd.CsrSpgemmFill.apply(
            pa, x, pb, y, ip, ix, False), (av, bv), (1, 1), "spgemm.fill"),
    }
    fn, args, dims, single = fns[function]
    out = torch.func.vmap(fn, in_dims=dims)(*args)
    assert calls == {single + "_batched": 1}
    for i in range(4):
        close(out[i], fn(*(x.select(dim, i) for x, dim in zip(args, dims))),
              np.complex128)
    assert calls == {single + "_batched": 1, single: 4}


# ---------------------------------------------------------------------------
# The batched forms, their plain versions, K5's plan cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shared", ["a", "b", "none"])
def test_batched_forms_gradcheck(shared):
    """The batched forms (a member dimension on some operands, the others
    shared) of ``CsrSpgemmDense`` (with the epilogue), ``CsrSpgemmSddmm``
    (both forms), ``CsrSpgemm``, ``CsrSpgemmSparseSddmm`` (both forms)
    and ``CsrSpgemmFill`` pass ``gradcheck`` with forward mode in
    complex128: a shared operand's gradient is summed over the
    members."""
    rng = np.random.default_rng(25)
    a_np, b_np = operands(26, m=5, k=4, n=4)
    pa = CsrPattern(*pattern(a_np), 4)
    pb = CsrPattern(*pattern(b_np), 4)

    def leaf(*shape):
        return torch.tensor(values(rng, shape, np.complex128),
                            requires_grad=True)

    av = leaf(a_np.nnz) if shared == "a" else leaf(2, a_np.nnz)
    bv = leaf(b_np.nnz) if shared == "b" else leaf(2, b_np.nnz)
    assert torch.autograd.gradcheck(
        lambda x, y, c: autograd.CsrSpgemmDense.apply(
            pa, x, pb, y, 1.5 - 0.5j, 0.5, c, True, False),
        (av, bv, leaf(5, 4)), check_forward_ad=True)
    d = leaf(5, 4) if shared != "none" else leaf(2, 5, 4)
    for p, x, x_vals, transposed in ((pa, pb, bv, False),
                                     (pb, pa, av, True)):
        assert torch.autograd.gradcheck(
            lambda dd, xx: autograd.CsrSpgemmSddmm.apply(
                p, dd, x, xx, -0.5 + 1j, transposed),
            (d, x_vals), check_forward_ad=True)
    ip, ix, _ = autograd.CsrSpgemm.apply(pa, av.detach(), pb, bv.detach(),
                                         False)
    assert torch.autograd.gradcheck(
        lambda x, y: autograd.CsrSpgemm.apply(pa, x, pb, y, False)[2],
        (av, bv), check_forward_ad=True)
    g = leaf(ix.numel()) if shared != "none" else leaf(2, ix.numel())
    for transposed in (False, True):
        assert torch.autograd.gradcheck(
            lambda x, y, gg: autograd.CsrSpgemmSparseSddmm.apply(
                pa, x, pb, y, ip, ix, gg, transposed, False),
            (av, bv, g), check_forward_ad=True)
    assert torch.autograd.gradcheck(
        lambda x, y: autograd.CsrSpgemmFill.apply(pa, x, pb, y, ip, ix,
                                                  False),
        (av, bv), check_forward_ad=True)


def member(x, i, core):
    return x if x is None or x.dim() == core else x[i]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shared", ["a", "b", "none"])
def test_batched_plain_versions_match_loops(dtype, shared, monkeypatch):
    """Each batched plain version (the CPU's batched wrappers: K5, K6
    with ``triangular`` and the epilogue, K9 in both forms, K11 in both
    forms) against a loop of the single plain versions over its members,
    with a shared operand read in place, and chunking forced by a small
    ``config.spmm_chunk_elements``."""
    monkeypatch.setattr(config, "spmm_chunk_elements", 40)
    rng = np.random.default_rng(27)
    a, b = operands(28)
    a_ip, a_ix = pattern(a)
    b_ip, b_ix = pattern(b)

    def t(*shape):
        return torch.tensor(values(rng, shape, dtype))

    av = t(a.nnz) if shared == "a" else t(3, a.nnz)
    bv = t(b.nnz) if shared == "b" else t(3, b.nnz)
    c0 = t(3, M, N)
    for tri in (False, True):
        out = spgemm.csr_spgemm_dense_batched_plain(
            a_ip, a_ix, av, b_ip, b_ix, bv, N, 2.0, -0.5, c0, tri)
        ip, ix, data = spgemm.spgemm_plain_batched(a_ip, a_ix, av, b_ip,
                                                   b_ix, bv, N, tri)
        idx, filled = spgemm.csr_spgemm_fill_batched_plain(
            a_ip, a_ix, av, b_ip, b_ix, bv, N, tri)
        assert torch.equal(idx, ix)
        close(filled, data, dtype)
        g = t(ix.numel()) if shared == "a" else t(3, ix.numel())
        for i in range(3):
            x, y = member(av, i, 1), member(bv, i, 1)
            close(out[i], spgemm.csr_spgemm_dense_plain(
                a_ip, a_ix, x, b_ip, b_ix, y, N, 2.0, -0.5, c0[i], tri),
                dtype)
            one = spgemm.spgemm_plain(a_ip, a_ix, x, b_ip, b_ix, y, N, tri)
            assert torch.equal(one[0], ip) and torch.equal(one[1], ix)
            close(data[i], one[2], dtype)
            for transposed in (False, True):
                args = (a_ip, a_ix, x, b_ip, b_ix, y, ip, ix,
                        member(g, i, 1), N, transposed, tri)
                close(spgemm_grad.csr_spgemm_sparse_sddmm_batched_plain(
                    a_ip, a_ix, av, b_ip, b_ix, bv, ip, ix, g, N,
                    transposed, tri)[i],
                    spgemm_grad.csr_spgemm_sparse_sddmm_plain(*args), dtype)
    pb = CsrPattern(b_ip, b_ix, N)
    tp, order = CsrPattern(a_ip, a_ix, K).transpose()
    d = t(M, N) if shared == "none" else t(3, M, N)
    for transposed, p_arr, y_ip, y_ix, y_vals in (
            (False, (a_ip, a_ix), b_ip, b_ix, bv),
            (True, (pb.indptr, pb.indices), tp.indptr, tp.indices,
             av[..., order])):
        out = spgemm_grad.csr_spgemm_sddmm_batched_plain(
            *p_arr, d, y_ip, y_ix, y_vals, 1.5, transposed)
        for i in range(3):
            close(out[i], spgemm_grad.csr_spgemm_sddmm_plain(
                *p_arr, member(d, i, 2), y_ip, y_ix, member(y_vals, i, 1),
                1.5, transposed), dtype)


def test_fill_plan_cached_on_the_pattern_pair(monkeypatch):
    """K5's plan and bin sizes (``spgemm.pair_plan``, what
    ``CsrSpgemmFill`` hands K5 on the card) are built once per pattern
    pair and value type, and equal ``spgemm_plan``'s: a tangent or
    second-order step no longer plans and reads the host at every
    fill."""
    a, b = operands(29)
    pa, pb = CsrPattern(*pattern(a), K), CsrPattern(*pattern(b), N)
    built = []
    plan_fn = spgemm.spgemm_plan

    def counting(*args):
        built.append(args[-2])
        return plan_fn(*args)

    monkeypatch.setattr(spgemm, "spgemm_plan", counting)
    for _ in range(3):
        plan, sizes = spgemm.pair_plan(pa, pb, torch.float64)
    spgemm.pair_plan(pa, pb, torch.complex128)
    assert built == [torch.float64, torch.complex128]
    ref = plan_fn(pa.indptr, pa.indices, pb.indptr, N, torch.float64,
                  pa.indptr.dtype)
    for got, want in zip(plan[:3], ref[:3]):
        assert torch.equal(got, want)
    assert np.array_equal(sizes, np.diff(ref.offsets.numpy()))
    assert spgemm.pair_plan(pa, pb, torch.float64)[0] is plan
