"""The port's kernel modules against the JAX package's functions.

Each module of ``sparse_dot_tpu_torch.ops`` that holds a kernel (K1 BSR
SpMM in ``bsr``, K2 CSR SpMM and K3 CSR SpMV in ``csr``, K7 CSR SDDMM in
``sddmm``) and the dense GEMM are run on the CPU, where the wrappers
take their plain PyTorch versions, on inputs made from a seed with numpy
and given to both packages.  The JAX side is the Pallas kernel in
interpret mode, or the XLA function it falls back to (for K7: ``jax.vjp``
of ``_xla.coo_spmm_raw`` in the values, and a dense numpy oracle).  The
CUDA kernels themselves are checked against these plain versions on the
card by ``chip_smoke.py``.

Tolerances: rtol = atol = 1e-12 for float64/complex128 and 1e-5 for
float32/complex64, on values of order 1; the two sides sum in different
orders.
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax
import jax.numpy as jnp

import sparse_dot_tpu  # noqa: F401  (enables x64 before any JAX array)
from sparse_dot_tpu.ops import _xla
from sparse_dot_tpu.ops.pallas_bsr import bsr_spmm_pallas

from sparse_dot_tpu_torch import formats
from sparse_dot_tpu_torch.config import config
from sparse_dot_tpu_torch.ops import (_build, bsr, csr, dense, sddmm, spgemm,
                                      spgemm_grad)


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless asked otherwise; these tests ask
    for the CPU, where its wrappers take their plain versions."""
    saved = config.device
    config.device = "cpu"
    yield
    config.device = saved


DTYPES = [np.float32, np.float64, np.complex64, np.complex128]
TOL = {
    np.dtype(np.float32): 1e-5,
    np.dtype(np.complex64): 1e-5,
    np.dtype(np.float64): 1e-12,
    np.dtype(np.complex128): 1e-12,
}


def assert_close(port, ref, dtype):
    tol = TOL[np.dtype(dtype)]
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    npt.assert_allclose(port, np.asarray(ref), rtol=tol, atol=tol)


def values(rng, size, dtype, scale=1.0):
    v = rng.standard_normal(size)
    if np.dtype(dtype).kind == "c":
        v = v + 1j * rng.standard_normal(size)
    return (v * scale).astype(dtype)


def random_csr(rng, m, k, mean_row, dtype, empty_every=4, distinct=False):
    """indptr, indices, data: Poisson rows, every ``empty_every``-th row
    empty, unsorted and possibly repeated columns; with ``distinct`` each
    row's columns are distinct (shuffled, at most k a row), as K6 takes
    op(B)."""
    lengths = rng.poisson(mean_row, m)
    if empty_every:
        lengths[::empty_every] = 0
    if distinct:
        lengths = np.minimum(lengths, k)
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    nnz = int(indptr[-1])
    if distinct:
        indices = np.concatenate(
            [rng.permutation(k)[:n] for n in lengths] or [[]]
        ).astype(np.int32)
    else:
        indices = rng.integers(0, k, nnz).astype(np.int32)
    data = values(rng, nnz, dtype, 1.0 / np.sqrt(max(mean_row, 1)))
    return indptr, indices, data


def row_ids(indptr):
    return np.repeat(np.arange(len(indptr) - 1), np.diff(indptr)).astype(
        np.int32
    )


def ell_arrays(indptr, indices, data):
    """Per-row padded (ELL) layout, padding with column 0 and value 0."""
    m = len(indptr) - 1
    rmax = max(int(np.diff(indptr).max()) if m else 0, 1)
    cols = np.zeros((m, rmax), np.int32)
    vals = np.zeros((m, rmax), data.dtype)
    for r in range(m):
        s, e = indptr[r], indptr[r + 1]
        cols[r, : e - s] = indices[s:e]
        vals[r, : e - s] = data[s:e]
    return cols, vals


def t(arr):
    return torch.from_numpy(np.ascontiguousarray(arr))


# ---------------------------------------------------------------------------
# K1: BSR SpMM
# ---------------------------------------------------------------------------


def random_bsr(rng, nbrows, nbcols, bs, dtype, per_row=2):
    lengths = rng.poisson(per_row, nbrows)
    lengths[1] = 0  # one empty block row at least
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    nblocks = int(indptr[-1])
    indices = rng.integers(0, nbcols, nblocks).astype(np.int32)
    data = values(rng, (nblocks, bs, bs), dtype, 1.0 / np.sqrt(bs))
    return indptr, indices, data


@pytest.mark.parametrize("accumulate", [False, True])
def test_bsr_plain_matches_pallas_kernel(accumulate):
    rng = np.random.default_rng(11)
    bs, nbrows, nbcols, n = 8, 8, 10, 128
    indptr, indices, data = random_bsr(rng, nbrows, nbcols, bs, np.float32)
    b = values(rng, (nbcols * bs, n), np.float32)
    c0 = values(rng, (nbrows * bs, n), np.float32)
    alpha, beta = (0.5, 2.0) if accumulate else (None, None)
    cc = c0 if accumulate else None
    ref = bsr_spmm_pallas(
        jnp.asarray(row_ids(indptr)), jnp.asarray(indices),
        jnp.asarray(data), jnp.asarray(b), m=nbrows * bs, bs=bs,
        interpret=True, alpha=alpha, beta=beta,
        c0=None if cc is None else jnp.asarray(cc),
    )
    port = bsr.bsr_spmm(t(indptr), t(indices), t(data), t(b), alpha, beta,
                        None if cc is None else t(cc))
    assert_close(port, ref, np.float32)
    npt.assert_array_equal(port.numpy()[bs:2 * bs],
                           (beta * c0[bs:2 * bs]) if accumulate else 0.0)


@pytest.mark.parametrize("bs", [1, 3, 16])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("accumulate", [False, True])
def test_bsr_plain_matches_xla_bsr_spmm(bs, dtype, accumulate):
    rng = np.random.default_rng(12)
    nbrows, nbcols, n = 7, 5, 9
    indptr, indices, data = random_bsr(rng, nbrows, nbcols, bs, dtype)
    b = values(rng, (nbcols * bs, n), dtype)
    c0 = values(rng, (nbrows * bs, n), dtype)
    alpha, beta, cc = (2.0, -0.5, c0) if accumulate else (None, None, None)
    ref = _xla.bsr_spmm(
        jnp.asarray(data), jnp.asarray(row_ids(indptr)), jnp.asarray(indices),
        jnp.asarray(b), m=nbrows * bs, alpha=alpha, beta=beta,
        c0=None if cc is None else jnp.asarray(cc),
    )
    port = bsr.bsr_spmm(t(indptr), t(indices), t(data), t(b), alpha, beta,
                        None if cc is None else t(cc))
    assert_close(port, ref, dtype)


def test_bsr_plain_no_blocks():
    indptr = np.zeros(4, np.int32)
    data = np.zeros((0, 4, 4))
    b = np.ones((8, 5))
    c0 = np.full((12, 5), 3.0)
    out = bsr.bsr_spmm(t(indptr), t(np.zeros(0, np.int32)), t(data), t(b),
                       None, 2.0, t(c0))
    npt.assert_array_equal(out.numpy(), 6.0)


# ---------------------------------------------------------------------------
# K2: CSR SpMM
# ---------------------------------------------------------------------------


CSR_CASES = [
    # m, k, n, mean row length
    (40, 30, 7, 5),
    (33, 50, 64, 12),
    (20, 20, 3, 0),  # nnz == 0
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CSR_CASES)
@pytest.mark.parametrize("accumulate", [False, True])
def test_csr_spmm_plain_matches_coo_spmm(dtype, case, accumulate):
    m, k, n, mean_row = case
    rng = np.random.default_rng(21)
    indptr, indices, data = random_csr(rng, m, k, mean_row, dtype)
    b = values(rng, (k, n), dtype)
    c0 = values(rng, (m, n), dtype)
    alpha, beta = (0.5, 2.0) if accumulate else (1.0, 0.0)
    cc = c0 if accumulate else None
    ref = _xla.coo_spmm(
        jnp.asarray(row_ids(indptr)), jnp.asarray(indices),
        jnp.asarray(data), jnp.asarray(b), m, k, alpha=alpha, beta=beta,
        c0=None if cc is None else jnp.asarray(cc), densify_ok=False,
    )
    port = csr.csr_spmm(t(indptr), t(indices), t(data), t(b),
                        alpha if accumulate else None,
                        beta if accumulate else None,
                        None if cc is None else t(cc))
    assert_close(port, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("accumulate", [False, True])
def test_csr_spmm_plain_matches_ell_spmm(dtype, accumulate):
    rng = np.random.default_rng(22)
    m, k, n = 37, 45, 20
    indptr, indices, data = random_csr(rng, m, k, 6, dtype)
    cols, vals = ell_arrays(indptr, indices, data)
    b = values(rng, (k, n), dtype)
    c0 = values(rng, (m, n), dtype)
    alpha, beta, cc = (-1.5, 0.25, c0) if accumulate else (None, None, None)
    ref = _xla.ell_spmm(
        jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(b), alpha=alpha,
        beta=beta, c0=None if cc is None else jnp.asarray(cc),
    )
    port = csr.csr_spmm(t(indptr), t(indices), t(data), t(b), alpha, beta,
                        None if cc is None else t(cc))
    assert_close(port, ref, dtype)


def test_csr_spmm_plain_chunking(monkeypatch):
    """The plain SpMM chunks over nnz like ``_xla.coo_spmm``; chunked and
    one-shot agree."""
    rng = np.random.default_rng(23)
    indptr, indices, data = random_csr(rng, 50, 40, 8, np.float64)
    b = values(rng, (40, 16), np.float64)
    whole = csr.csr_spmm(t(indptr), t(indices), t(data), t(b))
    monkeypatch.setattr(config, "spmm_chunk_elements", 100)
    chunked = csr.csr_spmm(t(indptr), t(indices), t(data), t(b))
    assert_close(chunked, whole.numpy(), np.float64)


# ---------------------------------------------------------------------------
# K3: CSR SpMV
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mean_row", [0, 3, 20])
@pytest.mark.parametrize("accumulate", [False, True])
def test_csr_spmv_plain_matches_coo_spmv(dtype, mean_row, accumulate):
    rng = np.random.default_rng(31)
    m, k = 45, 38
    indptr, indices, data = random_csr(rng, m, k, mean_row, dtype)
    x = values(rng, k, dtype)
    y0 = values(rng, m, dtype)
    alpha, beta = (2.0, -1.0) if accumulate else (1.0, 0.0)
    yy = y0 if accumulate else None
    ref = _xla.coo_spmv(
        jnp.asarray(row_ids(indptr)), jnp.asarray(indices),
        jnp.asarray(data), jnp.asarray(x), m=m, alpha=alpha, beta=beta,
        y0=None if yy is None else jnp.asarray(yy),
    )
    port = csr.csr_spmv(t(indptr), t(indices), t(data), t(x),
                        alpha if accumulate else None,
                        beta if accumulate else None,
                        None if yy is None else t(yy))
    assert_close(port, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_csr_spmv_plain_matches_ell_spmv(dtype):
    rng = np.random.default_rng(32)
    m, k = 29, 41
    indptr, indices, data = random_csr(rng, m, k, 5, dtype)
    cols, vals = ell_arrays(indptr, indices, data)
    x = values(rng, k, dtype)
    y0 = values(rng, m, dtype)
    ref = _xla.ell_spmv(jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x),
                        alpha=0.5, beta=3.0, y0=jnp.asarray(y0))
    port = csr.csr_spmv(t(indptr), t(indices), t(data), t(x), 0.5, 3.0,
                        t(y0))
    assert_close(port, ref, dtype)


# ---------------------------------------------------------------------------
# Dense GEMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("accumulate", [False, True])
def test_gemm_matches_xla_gemm(dtype, accumulate):
    rng = np.random.default_rng(41)
    a = values(rng, (13, 17), dtype)
    b = values(rng, (17, 6), dtype)
    c0 = values(rng, (13, 6), dtype)
    alpha, beta, cc = (3.0, 0.5, c0) if accumulate else (1.0, 0.0, None)
    ref = _xla.gemm(jnp.asarray(a), jnp.asarray(b), alpha=alpha, beta=beta,
                    c0=None if cc is None else jnp.asarray(cc),
                    allow_hilo=False)
    port = dense.gemm(t(a), t(b), alpha=alpha, beta=beta,
                      c0=None if cc is None else t(cc))
    assert_close(port, ref, dtype)


# ---------------------------------------------------------------------------
# K7: CSR SDDMM
# ---------------------------------------------------------------------------


SDDMM_CASES = [
    # m, k, n, mean row length
    (40, 30, 7, 5),
    (33, 50, 64, 12),
    (25, 20, 1, 3),   # n == 1: the SpMV gradient
    (30, 25, 4, 0),   # nnz == 0
]


def sddmm_oracle(indptr, indices, g, b):
    """``(G @ B^H)[rows, cols]`` densely, in numpy."""
    return (g @ b.conj().T)[row_ids(indptr), indices]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("itype", [np.int32, np.int64])
@pytest.mark.parametrize("case", SDDMM_CASES)
def test_csr_sddmm_plain_matches_dense_oracle(dtype, itype, case):
    """Every value type and index width, with empty rows (every fourth),
    nnz == 0 and n == 1, with and without alpha."""
    m, k, n, mean_row = case
    rng = np.random.default_rng(61)
    indptr, indices, _ = random_csr(rng, m, k, mean_row, dtype)
    indptr, indices = indptr.astype(itype), indices.astype(itype)
    g, b = values(rng, (m, n), dtype), values(rng, (k, n), dtype)
    ref = sddmm_oracle(indptr, indices, g, b)
    out = sddmm.csr_sddmm(t(indptr), t(indices), t(g), t(b))
    assert out.shape == (len(indices),) and out.dtype == t(g).dtype
    assert_close(out, ref, dtype)
    alpha = 0.5 - 2j if np.dtype(dtype).kind == "c" else -1.5
    assert_close(sddmm.csr_sddmm(t(indptr), t(indices), t(g), t(b), alpha),
                 alpha * ref, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_csr_sddmm_plain_is_jax_value_gradient(dtype):
    """K7 is the gradient of A @ B in A's values: the conjugate of JAX's
    ``vjp`` of ``_xla.coo_spmm_raw`` in the values for the cotangent
    conj(G) (JAX's vjp is linear, PyTorch's gradient conjugates)."""
    rng = np.random.default_rng(62)
    m, k, n = 35, 28, 9
    indptr, indices, data = random_csr(rng, m, k, 4, dtype)
    g, b = values(rng, (m, n), dtype), values(rng, (k, n), dtype)
    _, vjp = jax.vjp(lambda v: _xla.coo_spmm_raw(
        jnp.asarray(row_ids(indptr)), jnp.asarray(indices), v,
        jnp.asarray(b), m), jnp.asarray(data))
    (ref,) = vjp(jnp.asarray(np.conj(g)))
    out = sddmm.csr_sddmm(t(indptr), t(indices), t(g), t(b))
    assert_close(out, np.conj(np.asarray(ref)), dtype)


def test_csr_sddmm_plain_chunking(monkeypatch):
    """The plain SDDMM chunks over nnz; chunked and one-shot agree."""
    rng = np.random.default_rng(63)
    indptr, indices, _ = random_csr(rng, 50, 40, 8, np.complex128)
    g = values(rng, (50, 16), np.complex128)
    b = values(rng, (40, 16), np.complex128)
    whole = sddmm.csr_sddmm(t(indptr), t(indices), t(g), t(b))
    monkeypatch.setattr(config, "spmm_chunk_elements", 100)
    chunked = sddmm.csr_sddmm(t(indptr), t(indices), t(g), t(b))
    assert_close(chunked, whole.numpy(), np.complex128)


@pytest.mark.parametrize("n, dtype, lanes, vec", [
    (1, torch.float64, 1, 1),       # a thread an entry, scalar
    (2, torch.float64, 1, 2),       # a thread an entry, one 16-byte load
    (3, torch.float64, 4, 1),       # odd n: scalar loads, 4 lanes
    (128, torch.float64, 32, 2),    # config 1's width: a warp an entry
    (200, torch.complex128, 32, 1),  # two strips of 64 columns
])
def test_sddmm_schedule(n, dtype, lanes, vec):
    """K7's lanes are K2's for the same n; the span kernel's spans stay in
    [32, 512] and are the fewest entries that fit one wave of groups
    (``_SPAN_GROUPS`` groups of 32 lanes); the entry kernel's span is its
    warp tile."""
    s = sddmm.sddmm_schedule(n, dtype, 1_000_000)
    assert (s.lanes, s.vec) == (lanes, vec)
    assert s.lanes * s.per_lane * s.vec >= min(n, 128 if vec == 2 else 64)
    if lanes == 1:
        assert s.round == 1
        for nnz in (10, 1_000_000, 10**9):
            assert sddmm.sddmm_schedule(n, dtype, nnz).span == \
                sddmm._ENTRY_TILE
        return
    assert sddmm.sddmm_schedule(n, dtype, 10).span == 32
    assert sddmm.sddmm_schedule(n, dtype, 10**9).span == 512
    wave = sddmm._SPAN_GROUPS * (32 // lanes)
    assert -(-1_000_000 // s.span) <= wave or s.span == 512
    assert -(-1_000_000 // (s.span - 1)) > wave or s.span == 32


@pytest.mark.parametrize("lanes, load_bytes, entries", [
    (32, 32, 2),   # config 1 in f64: two 16-byte loads a lane
    (32, 16, 4),
    (32, 8, 4),    # scalar f64
    (32, 64, 2),   # never below 2
    (4, 16, 4),
    (2, 16, 2),    # at most the group's lanes
    (2, 4, 2),
])
def test_sddmm_round_entries(lanes, load_bytes, entries):
    """A round holds 4 entries' B loads, 2 where 4 would pass 64 bytes a
    lane, and no more than the group's lanes (``csrc/csr_sddmm.cu``,
    round_entries, refuses a schedule that says otherwise)."""
    assert sddmm.round_entries(lanes, load_bytes) == entries


@pytest.mark.parametrize("n, dtype, aligned, path", [
    # path: vec, lanes, per_lane, round
    (1, torch.float64, True, (1, 1, 1, 1)),        # entry kernel, scalar
    (2, torch.float64, True, (2, 1, 1, 1)),        # entry kernel, 16 bytes
    (4, torch.float32, True, (4, 1, 1, 1)),
    (1, torch.complex128, True, (1, 1, 1, 1)),
    (2, torch.float64, False, (1, 2, 1, 2)),       # misaligned: span, scalar
    (4, torch.float32, False, (1, 4, 1, 4)),
    (64, torch.float64, False, (1, 32, 2, 4)),     # two 8-byte loads
    (64, torch.float64, True, (2, 32, 1, 4)),
    (128, torch.float64, True, (2, 32, 2, 2)),     # config 1
    (128, torch.float32, True, (4, 32, 1, 4)),
    (17, torch.float64, True, (1, 32, 1, 4)),      # rows not 16-byte units
    (64, torch.complex128, True, (1, 32, 2, 2)),
    (32, torch.complex64, True, (2, 16, 1, 4)),
    (200, torch.float64, True, (2, 32, 2, 2)),     # last strip ends mid-row
])
def test_sddmm_schedule_paths(n, dtype, aligned, path):
    """The path for (n, value type, alignment): the entry kernel only for
    aligned rows of one 16-byte load (or n == 1); misaligned G or B, and
    rows that are not whole 16-byte units, take scalar loads."""
    assert tuple(sddmm.sddmm_schedule(n, dtype, 5000, aligned))[:4] == path


def kernel_entries(nnz, s):
    """The entries K7's launch writes, listed as the kernel walks them
    (``csrc/csr_sddmm.cu``): the entry kernel's warps take tiles of
    ``span`` entries, a thread every 32nd; the span kernel's groups take
    ``span`` consecutive entries in rounds of ``round``."""
    seen = []
    if s.lanes == 1:
        for tile in range(0, nnz, s.span):
            for lane in range(32):
                seen += [p for p in range(tile + lane, tile + s.span, 32)
                         if p < nnz]
        return seen
    for start in range(0, nnz, s.span):
        end = min(start + s.span, nnz)
        for p in range(start, end, s.round):
            seen += [p + e for e in range(s.round) if p + e < end]
    return seen


@pytest.mark.parametrize("n, dtype, aligned", [
    (1, torch.float64, True), (2, torch.float64, True),
    (128, torch.float64, True), (64, torch.float64, False),
    (3, torch.complex64, True), (32, torch.float32, True),
])
@pytest.mark.parametrize("nnz", [1, 31, 255, 257, 4097, 1_000_003])
def test_sddmm_spans_cover_every_entry_once(n, dtype, aligned, nnz):
    """Spans and rounds (the schedule's, as the kernel walks them) cover
    each of nnz entries exactly once, for nnz that is not a multiple of a
    round, a span or a tile; the span kernel's launch is one wave or
    fewer groups when nnz needs no more."""
    s = sddmm.sddmm_schedule(n, dtype, nnz, aligned)
    seen = kernel_entries(nnz, s)
    assert len(seen) == nnz and sorted(seen) == list(range(nnz))
    if s.lanes > 1 and s.span < sddmm._SPAN_MAX:
        assert -(-nnz // s.span) <= sddmm._SPAN_GROUPS * (32 // s.lanes)


def batch_items(s, members, nnz, size):
    """The work of a batched K7 launch as its kernels split it, mirroring
    their index arithmetic (``csrc/csr_sddmm.cu``): for each group of
    lanes, (first member, end member, first entry, end entry), as four
    arrays over all the launches (``csr.member_chunks``).  The span
    kernels: blockIdx.y a member group of ``members`` members, blockIdx.x's
    128 // lanes groups spans of ``s.span`` entries; the entry kernel: a
    member a blockIdx.y, a warp (4 a block) a tile."""
    per_block = 128 // s.lanes if s.lanes > 1 else 4
    groups = -(-nnz // s.span)
    blocks = -(-groups // per_block)
    parts = []
    for first, count in csr.member_chunks(size):
        y, x, t = np.meshgrid(np.arange(-(-count // members)),
                              np.arange(blocks), np.arange(per_block),
                              indexing="ij")
        start = ((x * per_block + t) * s.span).ravel()
        m0 = (first + y * members).ravel()
        m1 = np.minimum(m0 + members, first + count)
        keep = start < nnz
        parts.append((m0[keep], m1[keep], start[keep],
                      np.minimum(start[keep] + s.span, nnz)))
    return tuple(np.concatenate(col) for col in zip(*parts))


def member_strides(shared, m, k, n):
    """(g, b) member strides: per-member pairs, b shared or g shared."""
    return {"none": (m * n, k * n), "b": (m * n, 0), "g": (0, k * n)}[shared]


@pytest.mark.parametrize("size", [1, 4, 16, 65_536])
@pytest.mark.parametrize("shared", ["none", "b", "g"])
@pytest.mark.parametrize("n, dtype", [(128, torch.float64),
                                      (64, torch.complex128),
                                      (3, torch.float32),
                                      (2, torch.float64)])
def test_batched_sddmm_items_cover_every_member_entry_once(size, shared, n,
                                                           dtype):
    """A batched K7's work as its kernels split it (``batch_items``: member
    groups on blockIdx.y within launches of at most 65,535 members, spans
    of entries on blockIdx.x; the entry kernel a member a blockIdx.y)
    covers every (member, entry) exactly once, at 1, 4, 16 and 65,535 + 1
    members, per-member or with an operand shared (b shared: several
    members a group)."""
    nnz = 1000 if size < 65_536 else 70
    s, members = sddmm.batched_schedule(n, dtype, nnz, size,
                                        member_strides(shared, 9, 7, n))
    assert members == (sddmm.shared_members(s, dtype)
                       if shared == "b" else 1)
    m0, m1, e0, e1 = batch_items(s, members, nnz, size)
    cover = np.zeros((size + 1, nnz + 1), np.int64)
    np.add.at(cover, (m0, e0), 1)
    np.add.at(cover, (m1, e0), -1)
    np.add.at(cover, (m0, e1), -1)
    np.add.at(cover, (m1, e1), 1)
    cover = cover.cumsum(0).cumsum(1)[:size, :nnz]
    assert (cover == 1).all()
    assert (m1 - m0 <= members).all()


@pytest.mark.parametrize("index_bytes", [4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128])
@pytest.mark.parametrize("aligned", [True, False])
def test_shared_members_follow_the_timed_rule(dtype, aligned, index_bytes):
    """With b shared, the members a group serves are the most of 4 and 2
    whose sums one reduce-scatter of the group's lanes holds, 2 at most
    for c128 with 64-bit indices (timed faster on the card); the entry
    kernel serves one.  At config 1's n = 128 that is 4, but 2 for c128
    with 64-bit indices."""
    most = 2 if (dtype, index_bytes) == (torch.complex128, 8) else 4
    for n in range(1, 600):
        s = sddmm.sddmm_schedule(n, dtype, 10**6, aligned)
        members = sddmm.shared_members(s, dtype, index_bytes)
        load = s.per_lane * s.vec * dtype.itemsize
        if s.lanes == 1:
            assert members == 1
            continue

        def fits(mm):
            return (mm <= most and sddmm.shared_round(s.lanes, load, mm)
                    * mm <= s.lanes)

        assert members > 1 and fits(members)
        assert all(not fits(mm) for mm in (4, 2) if mm > members)
    s = sddmm.sddmm_schedule(128, dtype, 10**6, aligned)
    assert sddmm.shared_members(s, dtype, index_bytes) == most
    assert sddmm.shared_round(32, 32, 2) == 1
    assert sddmm.shared_round(32, 16, 2) == 2


@pytest.mark.parametrize("dtype", DTYPES)
def test_swapped_roles_match_the_direct_product(dtype):
    """G shared and b per member, computed on A's transpose with the roles
    swapped (``swapped_roles``: alpha conjugated, the result conjugated
    into A's entries' order) equals the direct batched product."""
    rng = np.random.default_rng(31)
    m, k, n, nnz, size = 9, 7, 5, 30, 3
    rows = np.sort(rng.integers(0, m, nnz))
    indptr = np.searchsorted(rows, np.arange(m + 1)).astype(np.int64)
    indices = rng.integers(0, k, nnz).astype(np.int64)
    pattern = formats.CsrPattern(torch.tensor(indptr), torch.tensor(indices),
                                 k)
    g = torch.tensor(values(rng, (m, n), dtype))
    b = torch.tensor(values(rng, (size, k, n), dtype))
    alpha = 0.5 - 2.0j if np.dtype(dtype).kind == "c" else -1.5
    want = sddmm.csr_sddmm_batched_plain(pattern.indptr, pattern.indices, g,
                                         b, alpha)
    got = sddmm.swapped_roles(pattern.transpose(), g, b, alpha,
                              sddmm.csr_sddmm_batched_plain)
    assert got.dtype == want.dtype
    assert_close(got, want.numpy(), dtype)


# ---------------------------------------------------------------------------
# Wrapper dispatch and the build's bookkeeping
# ---------------------------------------------------------------------------


def launch_counts():
    return (csr.csr_spmm.launches, csr.csr_spmv.launches,
            bsr.bsr_spmm.launches, sddmm.csr_sddmm.launches,
            spgemm.csr_spgemm_dense.launches, bsr.bsr_sddmm.launches,
            spgemm_grad.csr_spgemm_sddmm.launches,
            spgemm.csr_spgemm_count.launches,
            spgemm.csr_spgemm_fill.launches,
            spgemm_grad.csr_spgemm_sparse_sddmm.launches)


@pytest.mark.parametrize("tracked", [False, True])
def test_cpu_tensors_take_plain_version_without_counting(tracked):
    """On CPU tensors K1, K2, K3, K4 + K5, K6 and K7's wrappers give their
    plain versions' results and count no launch; with ``tracked`` K1, K2,
    K3, K4 + K5 and K6 take the autograd Functions (operands requiring
    grad), whose forward and backward (K7, K8, K9 and K11 among them)
    count none either."""
    rng = np.random.default_rng(51)
    # Rows of distinct columns: its first rows are K6's op(B).
    indptr, indices, data = random_csr(rng, 10, 8, 3, np.float64,
                                       distinct=True)
    b = values(rng, (8, 4), np.float64)
    g = values(rng, (10, 4), np.float64)
    ip, ix = t(indptr), t(indices)
    dv = t(data).clone().requires_grad_(tracked)
    tb = t(b).clone().requires_grad_(tracked)
    before = launch_counts()
    out = csr.csr_spmm(ip, ix, dv, tb)
    assert_close(out.detach(), csr.csr_spmm_plain(ip, ix, t(data),
                                                  t(b)).numpy(), np.float64)
    y = csr.csr_spmv(ip, ix, dv, tb[:, 0])
    assert_close(y.detach(), csr.csr_spmv_plain(ip, ix, t(data),
                                                t(b[:, 0])).numpy(),
                 np.float64)
    blocks = dv.reshape(-1, 1, 1)
    c1 = bsr.bsr_spmm(ip, ix, blocks, tb)
    assert_close(c1.detach(), bsr.bsr_spmm_plain(
        ip, ix, t(data.reshape(-1, 1, 1)), t(b)).numpy(), np.float64)
    c6 = spgemm.csr_spgemm_dense(ip, ix, dv, ip[:9], ix[:int(ip[8])],
                                 dv[:int(ip[8])], 8)
    assert_close(c6.detach(), spgemm.csr_spgemm_dense_plain(
        ip, ix, t(data), ip[:9], ix[:int(ip[8])], t(data[:int(ip[8])]),
        8).numpy(), np.float64)
    c5 = spgemm.csr_spgemm(ip, ix, dv, ip[:9], ix[:int(ip[8])],
                           dv[:int(ip[8])], 8)[2]
    assert_close(c5.detach(), spgemm.spgemm_plain(
        ip, ix, t(data), ip[:9], ix[:int(ip[8])], t(data[:int(ip[8])]),
        8)[2].numpy(), np.float64)
    assert_close(sddmm.csr_sddmm(ip, ix, t(g), t(b)),
                 sddmm.csr_sddmm_plain(ip, ix, t(g), t(b)).numpy(),
                 np.float64)
    for result in (out, y, c1, c6, c5):
        assert (result.grad_fn is not None) == tracked
    if tracked:
        ((out * t(g)).sum() + y.sum()).backward()
        ones = t(np.ones((10, 1)))
        ref = (sddmm.csr_sddmm_plain(ip, ix, t(g), t(b))
               + sddmm.csr_sddmm_plain(ip, ix, ones, t(b[:, :1])))
        assert_close(dv.grad, ref.numpy(), np.float64)
        dv.grad = None
        (c1 * t(g)).sum().backward()
        assert_close(dv.grad, sddmm.csr_sddmm_plain(
            ip, ix, t(g), t(b)).numpy(), np.float64)
        c6.sum().backward()
        c5.sum().backward()
    assert launch_counts() == before


@pytest.mark.parametrize("kernel", ["K11", "K5_fill", "K7", "K8", "K9"])
def test_wrappers_refuse_tracked_operands(kernel):
    """A wrapper whose kernel carries no gradient raises on an operand
    that requires grad, on the CPU as on the card (where its kernel would
    write a tensor with no grad_fn): K5's fill, and K7, K8, K9 and K11
    called directly (``csr_spgemm``, K4 + K5, carries a gradient through
    K11); the same call on detached operands runs."""
    rng = np.random.default_rng(65)
    indptr, indices, data = random_csr(rng, 6, 6, 2, np.float64)
    ip, ix = t(indptr), t(indices)
    dv = t(data).requires_grad_()
    g = t(values(rng, (6, 6), np.float64)).requires_grad_()

    def call(dv, g):
        if kernel == "K11":
            c_ip, c_ix, c_dv = spgemm.spgemm_plain(ip, ix, dv.detach(), ip,
                                                   ix, dv.detach(), 6)
            return spgemm_grad.csr_spgemm_sparse_sddmm(
                ip, ix, dv, ip, ix, dv, c_ip, c_ix, c_dv, 6, True)
        if kernel == "K5_fill":
            c_ip = spgemm.spgemm_plain(ip, ix, dv.detach(), ip, ix,
                                       dv.detach(), 6)[0]
            return spgemm.csr_spgemm_fill(ip, ix, dv, ip, ix, dv, 6, None,
                                          c_ip, int(c_ip[-1]))
        if kernel == "K7":
            return sddmm.csr_sddmm(ip, ix, g, g)
        if kernel == "K8":
            return bsr.bsr_sddmm(ip, ix, g, g, 1)
        return spgemm_grad.csr_spgemm_sddmm(ip, ix, g, ip, ix, dv)

    with pytest.raises(ValueError, match="carries no gradient"):
        call(dv, g)
    call(dv.detach(), g.detach())


@pytest.mark.parametrize("kernel", ["K1", "K5", "K6"])
def test_tracked_k1_and_k6_carry_gradients(kernel):
    """K1, K5 (the sparse-output product, K4 + K5) and K6 take their
    Functions for a tracked operand on either device: the result's node
    is ``BsrSpmmBackward``, ``CsrSpgemmBackward`` or
    ``CsrSpgemmDenseBackward``, and its gradient equals the one torch
    takes through the plain version."""
    rng = np.random.default_rng(66)
    indptr, indices, data = random_csr(rng, 6, 6, 2, np.float64,
                                       distinct=True)
    ip, ix = t(indptr), t(indices)
    w = t(values(rng, (6, 6), np.float64))
    dv = t(data).requires_grad_()
    ref_dv = t(data).requires_grad_()
    if kernel == "K1":
        out = bsr.bsr_spmm(ip, ix, dv.reshape(-1, 1, 1), w)
        ref = bsr.bsr_spmm_plain(ip, ix, ref_dv.reshape(-1, 1, 1), w)
        name = "BsrSpmmBackward"
    elif kernel == "K5":
        out = spgemm.csr_spgemm(ip, ix, dv, ip, ix, dv.detach(), 6)[2]
        ref = spgemm.spgemm_plain(ip, ix, ref_dv, ip, ix, t(data), 6)[2]
        w = t(values(rng, out.numel(), np.float64))
        name = "CsrSpgemmBackward"
    else:
        out = spgemm.csr_spgemm_dense(ip, ix, dv, ip, ix, dv.detach(), 6)
        ref = spgemm.csr_spgemm_dense_plain(ip, ix, ref_dv, ip, ix,
                                            t(data), 6)
        name = "CsrSpgemmDenseBackward"
    assert type(out.grad_fn).__name__ == name
    (out * w).sum().backward()
    (ref * w).sum().backward()
    assert_close(dv.grad, ref_dv.grad.numpy(), np.float64)


def lazy_view(x, kind):
    """x (values of ``kind``'s type) as a lazy view whose bit a kernel
    would not see: the conjugate of complex values, or the negative of
    real ones (the imaginary part of a conjugate view)."""
    if kind == "conj":
        return x.conj_physical().conj()
    return torch.complex(torch.zeros_like(x), -x).conj().imag


@pytest.mark.parametrize("kind", ["conj", "neg"])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K5", "K6", "K7"])
def test_wrappers_refuse_lazy_views(kernel, kind):
    """An operand that is a lazy conjugate or negative view would reach a
    kernel through ``data_ptr()`` with its bit unseen: each wrapper raises
    on one, on the CPU as on the card, and takes the materialized copy.
    (K4 reads indices only.)"""
    rng = np.random.default_rng(64)
    dtype = np.complex128 if kind == "conj" else np.float64
    indptr, indices, data = random_csr(rng, 6, 6, 2, dtype, distinct=True)
    ip, ix, dv = t(indptr), t(indices), t(data)
    b = t(values(rng, (6, 3), dtype))
    lazy = lazy_view(b, kind)
    assert lazy.is_conj() or lazy.is_neg()
    torch.testing.assert_close(lazy.resolve_conj().resolve_neg(), b)
    lazy_dv = lazy_view(dv, kind)

    def call(b_op, dv_op):
        if kernel == "K1":
            return bsr.bsr_spmm(ip, ix, dv_op.reshape(-1, 1, 1), b_op)
        if kernel == "K2":
            return csr.csr_spmm(ip, ix, dv_op, b_op)
        if kernel == "K3":
            return csr.csr_spmv(ip, ix, dv_op, b_op[:, 0])
        if kernel == "K5":
            return spgemm.csr_spgemm_fill(ip, ix, dv_op, ip, ix, dv, 6,
                                          None, ip, 0)
        if kernel == "K6":
            return spgemm.csr_spgemm_dense(ip, ix, dv, ip, ix, dv_op, 6)
        return sddmm.csr_sddmm(ip, ix, b if dv_op is dv else lazy, b_op)

    if kernel not in ("K5", "K6"):  # these take no dense operand
        with pytest.raises(ValueError, match="lazy"):
            call(lazy, dv)
    with pytest.raises(ValueError, match="lazy"):
        call(b, lazy_dv)
    if kernel in ("K2", "K3", "K7"):
        out = call(lazy.resolve_conj().resolve_neg(), dv)
        assert_close(out, call(b, dv).numpy(), dtype)


@pytest.mark.parametrize("wrapper, nargs", [
    (csr.csr_spmm, 4), (csr.csr_spmv, 4), (bsr.bsr_spmm, 4),
    (sddmm.csr_sddmm, 4),
])
def test_wrappers_refuse_other_devices(wrapper, nargs):
    """Neither CPU nor CUDA: no plain fallback."""
    meta = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        wrapper(*([meta] * nargs))


def test_type_codes_reject_other_types():
    with pytest.raises(TypeError):
        _build.type_codes(torch.zeros(2, dtype=torch.float16),
                          torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError):
        _build.type_codes(torch.zeros(2), torch.zeros(2, dtype=torch.int16))
    assert _build.type_codes(torch.zeros(2, dtype=torch.complex128),
                             torch.zeros(2, dtype=torch.int64)) == (3, 1)


def test_source_hash_follows_sources(tmp_path, monkeypatch):
    for path in _build.sources():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    h0 = _build.source_hash()
    assert h0 == _build.source_hash()
    with open(tmp_path / "csr_spmv.cu", "a") as f:
        f.write("\n// changed\n")
    assert _build.source_hash() != h0


def test_build_dir_in_checkout_or_env(monkeypatch, tmp_path):
    monkeypatch.delenv("SPARSE_DOT_BUILD_DIR", raising=False)
    assert _build.build_dir().parts[-2:] == ("build", "sparse_dot_tpu_torch")
    monkeypatch.setenv("SPARSE_DOT_BUILD_DIR", str(tmp_path))
    assert _build.build_dir() == tmp_path
