"""K2's and K3's designs, checked on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them
against ``csr_spmm_plain`` and ``csr_spmv_plain``).  What surrounds them is
checked here:

- K2's lane mapping (``ops.csr.spmm_schedule``): 16-byte loads exactly
  when a row of n values is whole 16-byte units and the pointers are
  aligned, the lanes a row takes, the strips, and the split of long rows;
- the row plans (``formats.csr_plan``): K2's chunks of the rows longer
  than S and K3's tiles on row boundaries, every nonzero covered once and
  in order, with sizes known on the host;
- torch emulations of the kernels' orders of summation (whole rows and
  tiles, then the split rows' partial sums added in chunk order, then the
  epilogue) against the plain versions and against the JAX
  package's ``_xla.ell_spmm`` / ``_xla.ell_spmv`` on the same
  numpy-seeded inputs, at the tolerances of ``tests/test_torch_kernels.py``
  (1e-12 f64/c128, 1e-5 f32/c64).
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax.numpy as jnp

import sparse_dot_tpu  # noqa: F401  (enables x64 before any JAX array)
from sparse_dot_tpu.ops import _xla

from sparse_dot_tpu_torch import formats
from sparse_dot_tpu_torch.config import config
from sparse_dot_tpu_torch.formats import SPMV_TILE, csr_plan
from sparse_dot_tpu_torch.ops import csr
from sparse_dot_tpu_torch.solvers.iterative import CsrOperator


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless asked otherwise; these tests ask
    for the CPU, where its wrappers take their plain versions."""
    saved = config.device
    config.device = "cpu"
    yield
    config.device = saved


DTYPES = [torch.float32, torch.float64, torch.complex64, torch.complex128]
NP = {torch.float32: np.float32, torch.float64: np.float64,
      torch.complex64: np.complex64, torch.complex128: np.complex128}
TOL = {torch.float32: 1e-5, torch.complex64: 1e-5, torch.float64: 1e-12,
       torch.complex128: 1e-12}


def t(arr):
    return torch.from_numpy(np.ascontiguousarray(arr))


def values(rng, size, dtype, scale=1.0):
    v = rng.standard_normal(size)
    if np.dtype(dtype).kind == "c":
        v = v + 1j * rng.standard_normal(size)
    return (v * scale).astype(dtype)


def csr_of(rng, lengths, k, dtype=np.float64, index_dtype=np.int32):
    """CSR arrays with rows of ``lengths`` random (repeatable) columns."""
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(index_dtype)
    nnz = int(indptr[-1])
    indices = rng.integers(0, k, nnz).astype(index_dtype)
    return indptr, indices, values(rng, nnz, dtype, 0.1)


# ---------------------------------------------------------------------------
# K2's lane mapping
# ---------------------------------------------------------------------------


NS = [1, 2, 3, 4, 8, 16, 17, 32, 64, 128, 129, 256]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NS)
def test_spmm_schedule_covers_n(n, dtype):
    s = csr.spmm_schedule(n, dtype, mean_row=5.0)
    itemsize = dtype.itemsize
    # 16-byte loads exactly when a row is whole 16-byte units.
    whole = (n * itemsize) % 16 == 0
    assert s.vec == (16 // itemsize if whole else 1)
    loads = -(-n // s.vec)
    # The power of two at or above the loads, at most 32; two loads a lane
    # at most; the strips cover n and no strip is empty.
    assert s.lanes in (1, 2, 4, 8, 16, 32)
    assert s.lanes >= min(loads, 32) and (s.lanes == 1
                                          or s.lanes // 2 < loads)
    assert s.per_lane == (2 if loads > s.lanes else 1)
    width = s.lanes * s.per_lane * s.vec
    assert s.strips * width >= n > (s.strips - 1) * width
    assert s.lanes * s.split <= 32


@pytest.mark.parametrize("n, dtype, mean, expected", [
    # (vec, lanes, split, per_lane, strips)
    (1, torch.float64, 5.0, (1, 1, 1, 1, 1)),
    (1, torch.float64, 10.0, (1, 1, 2, 1, 1)),
    (1, torch.float64, 3.9, (1, 1, 1, 1, 1)),
    (4, torch.float64, 3.9, (2, 2, 1, 1, 1)),
    (4, torch.float64, 93.0, (2, 2, 16, 1, 1)),
    (16, torch.float64, 5.0, (2, 8, 1, 1, 1)),
    (128, torch.float64, 100.0, (2, 32, 1, 2, 1)),
    (200, torch.float64, 100.0, (2, 32, 1, 2, 2)),
    (17, torch.float32, 8.0, (1, 32, 1, 1, 1)),
    (4, torch.float32, 1000.0, (4, 1, 32, 1, 1)),
    (3, torch.complex128, 20.0, (1, 4, 4, 1, 1)),
    (256, torch.complex64, 4.0, (2, 32, 1, 2, 2)),
])
def test_spmm_schedule_values(n, dtype, mean, expected):
    assert tuple(csr.spmm_schedule(n, dtype, mean)) == expected


@pytest.mark.parametrize("dtype", DTYPES)
def test_spmm_schedule_misaligned_takes_scalar_loads(dtype):
    """A view whose pointer is not 16-byte aligned takes one column a
    load even when its rows are whole 16-byte units."""
    n = 64
    assert csr.spmm_schedule(n, dtype, 5.0).vec == 16 // dtype.itemsize
    s = csr.spmm_schedule(n, dtype, 5.0, aligned=False)
    assert s.vec == 1 and s.lanes == 32
    assert s.strips * s.lanes * s.per_lane >= n


# ---------------------------------------------------------------------------
# The row plans
# ---------------------------------------------------------------------------


PLAN_CASES = {
    "long_rows": [0, 3, 600, 1, 0, 2, 300, 1700, 5],
    "row_of_3S_plus_1": [2, 1, 1, 0, 3 * SPMV_TILE + 1, 1, 1],
    "no_long_row": [3, 0, 5, 7, 1, 0, 2],
    "no_entries": [0, 0, 0],
    "one_row": [2500],
    "row_of_exactly_S": [SPMV_TILE],
}


def split_chunks(plan):
    """{row: [(first, end) nonzero, ...]} of the plan's split rows, from
    its chunks, which must take the slots 0, 1, ... in row order."""
    real = [c for c in plan.chunks.tolist() if c[0] >= 0]
    assert [c[3] for c in real] == list(range(len(real)))
    assert [c[0] for c in real] == sorted(c[0] for c in real)
    rows = {}
    for row, p0, p1, _ in real:
        rows.setdefault(row, []).append((p0, p1))
    return rows


def covered(plan, indptr):
    """Every nonzero's position, in the order the plan's work reads them:
    the rows of at most S entries whole, the split rows chunk by chunk.
    Checks the chunk lengths on the way."""
    S = plan.chunk
    ip = indptr.tolist()
    by_row = split_chunks(plan)
    seen = []
    for r in range(len(ip) - 1):
        if ip[r + 1] - ip[r] <= S:
            assert r not in by_row
            seen += range(ip[r], ip[r + 1])
            continue
        parts = by_row[r]
        assert len(parts) == -(-(ip[r + 1] - ip[r]) // S)
        for p0, p1 in parts:
            assert 0 < p1 - p0 <= S
            seen += range(p0, p1)
    return seen


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("spmv", [False, True], ids=["K2", "K3"])
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_row_plan_covers_every_nonzero_once(case, spmv, index_dtype):
    lengths = PLAN_CASES[case]
    indptr = t(np.concatenate([[0], np.cumsum(lengths)]).astype(index_dtype))
    nnz, m = int(indptr[-1]), len(lengths)
    plan = csr_plan(indptr, nnz, spmv)
    S = SPMV_TILE if spmv else formats.spmm_chunk_length(m, nnz)
    assert (plan.chunk, plan.nrows, plan.nnz) == (S, m, nnz)
    # Sizes known on the host; padding after the real entries.
    assert plan.chunks.shape == (nnz // S + nnz // (S + 1), 4)
    assert plan.counts.shape == (plan.slots,) and not plan.counts.any()
    assert plan.chunks.dtype == torch.int64
    rows = plan.chunks.tolist()
    real = [r for r in rows if r[0] >= 0]
    assert rows[len(real):] == [[-1, 0, 0, -1]] * (len(rows) - len(real))
    assert covered(plan, indptr) == list(range(nnz))
    assert len(split_chunks(plan)) == sum(n > S for n in lengths)
    if case == "row_of_3S_plus_1" and spmv:
        assert max(lengths) == 3 * S + 1


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("case", sorted(PLAN_CASES) + ["poisson"])
def test_spmv_tiles_on_row_boundaries(case, index_dtype):
    """Tile t holds the rows starting in [t T, (t + 1) T), in order, with
    their first and end nonzero; a row longer than T is left to its chunks
    and can only be the last of its tile."""
    if case == "poisson":
        lengths = np.random.default_rng(71).poisson(5, 3000)
        lengths[::7] = 0
        lengths[1000] = 2 * SPMV_TILE + 3
    else:
        lengths = np.asarray(PLAN_CASES[case])
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(index_dtype)
    nnz, m = int(indptr[-1]), len(lengths)
    plan = csr_plan(t(indptr), nnz, spmv=True)
    tiles = plan.tiles.tolist()
    assert plan.tiles.shape == (nnz // SPMV_TILE + 1, 4)
    rows = []
    for k, (first, end, lo, hi) in enumerate(tiles):
        assert (lo, hi) == (indptr[first], indptr[end])
        assert hi - lo <= 2 * SPMV_TILE
        assert all(k * SPMV_TILE <= indptr[r] < (k + 1) * SPMV_TILE
                   for r in range(first, end))
        assert all(lengths[r] <= SPMV_TILE for r in range(first, end))
        nxt = tiles[k + 1][0] if k + 1 < len(tiles) else m
        # The rows between this tile's end and the next tile: its long row.
        assert nxt - end in (0, 1)
        if nxt > end:
            assert lengths[end] > SPMV_TILE
        rows += range(first, nxt)
    assert rows == list(range(m))


def test_row_plans_cached_on_container():
    import scipy.sparse as sps

    a = sps.random(40, 30, density=0.2, format="csr", random_state=72)
    A = formats.to_device(a)
    for transpose in (False, True):
        for spmv in (False, True):
            plan = A.csr_plan(transpose, spmv)
            assert A.csr_plan(transpose, spmv) is plan
            indptr, indices, _ = A.csr_arrays(transpose)
            ref = csr_plan(indptr, indices.numel(), spmv)
            for x, y in zip(plan[:3], ref[:3]):
                assert torch.equal(x, y)
    op = CsrOperator(*A.csr_arrays())
    assert op.plan(True) is op.plan(True) and op.plan(False).tiles.numel() == 0


def test_row_plan_refused_for_other_arrays():
    indptr = t(np.array([0, 2, 5, 5], np.int32))
    plan = csr_plan(indptr, 5)
    assert csr._row_plan("k", plan, indptr, 5, spmv=False) is plan
    with pytest.raises(ValueError, match="other arrays"):
        csr._row_plan("k", plan, indptr, 4, spmv=False)
    with pytest.raises(ValueError, match="other arrays"):
        csr._row_plan("k", plan, indptr, 5, spmv=True)
    built = csr._row_plan("k", None, indptr, 5, spmv=True)
    assert built.chunk == SPMV_TILE and built.tiles.shape == (1, 4)


# ---------------------------------------------------------------------------
# The orders of summation
# ---------------------------------------------------------------------------


def epilogue(acc, alpha, beta, c0, rows):
    v = acc if alpha is None else alpha * acc
    return v if c0 is None else v + beta * c0[rows]


def split_rows(plan, products, out, alpha, beta, c0):
    """The split rows: a partial sum per chunk, added in chunk order."""
    written = []
    for row, parts in split_chunks(plan).items():
        acc = products[parts[0][0]:parts[0][1]].sum(0)
        for p0, p1 in parts[1:]:
            acc = acc + products[p0:p1].sum(0)
        out[row] = epilogue(acc, alpha, beta, c0, row)
        written.append(row)
    assert written, "the case splits no row"
    return written


def emulate_spmm(indptr, indices, data, b, alpha=None, beta=None, c0=None):
    """K2's order: rows of at most S entries whole, split rows by chunks."""
    m = indptr.numel() - 1
    plan = csr_plan(indptr, indices.numel())
    products = data[:, None] * b[indices.long()]
    c = torch.full((m, b.shape[1]), float("nan"), dtype=b.dtype)
    ip = indptr.tolist()
    written = []
    for r in range(m):
        if ip[r + 1] - ip[r] <= plan.chunk:
            c[r] = epilogue(products[ip[r]:ip[r + 1]].sum(0), alpha, beta,
                            c0, r)
            written.append(r)
    written += split_rows(plan, products, c, alpha, beta, c0)
    assert sorted(written) == list(range(m))
    return c


def emulate_spmv(indptr, indices, data, x, alpha=None, beta=None, y0=None):
    """K3's order: tile by tile, the long rows by chunks."""
    m = indptr.numel() - 1
    plan = csr_plan(indptr, indices.numel(), spmv=True)
    products = data * x[indices.long()]
    y = torch.full((m,), float("nan"), dtype=x.dtype)
    ip = indptr.tolist()
    written = []
    for first, end, _, _ in plan.tiles.tolist():
        for r in range(first, end):
            acc = torch.zeros((), dtype=x.dtype)
            for p in range(ip[r], ip[r + 1]):
                acc = acc + products[p]
            y[r] = epilogue(acc, alpha, beta, y0, r)
            written.append(r)
    written += split_rows(plan, products, y, alpha, beta, y0)
    assert sorted(written) == list(range(m))
    return y


def long_row_csr(rng, m, k, long_len, dtype, index_dtype=np.int32):
    lengths = rng.poisson(4, m)
    lengths[::5] = 0
    lengths[m // 2] = long_len
    return csr_of(rng, lengths, k, dtype, index_dtype)


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("accumulate", [False, True])
def test_spmm_chunk_order_matches_plain_and_ell_spmm(dtype, accumulate):
    rng = np.random.default_rng(73)
    m, k, n = 60, 50, 5
    npdt = NP[dtype]
    indptr, indices, data = long_row_csr(rng, m, k, 3 * 128 + 1, npdt)
    assert int(np.diff(indptr).max()) > formats.spmm_chunk_length(
        m, len(indices))
    b = values(rng, (k, n), npdt)
    c0 = values(rng, (m, n), npdt)
    alpha, beta, cc = (0.5, -2.0, c0) if accumulate else (None, None, None)
    args = (t(indptr), t(indices), t(data), t(b), alpha, beta,
            None if cc is None else t(cc))
    port = emulate_spmm(*args).numpy()
    tol = TOL[dtype]
    npt.assert_allclose(port, csr.csr_spmm_plain(*args).numpy(), rtol=tol,
                        atol=tol * np.abs(port).max())
    cols, vals = ell_arrays(indptr, indices, data)
    ref = _xla.ell_spmm(jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(b),
                        alpha=alpha, beta=beta,
                        c0=None if cc is None else jnp.asarray(cc))
    npt.assert_allclose(port, np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("accumulate", [False, True])
def test_spmv_tile_order_matches_plain_and_ell_spmv(dtype, accumulate):
    rng = np.random.default_rng(74)
    m, k = 700, 90
    npdt = NP[dtype]
    indptr, indices, data = long_row_csr(rng, m, k, 3 * SPMV_TILE + 1, npdt)
    x = values(rng, k, npdt)
    y0 = values(rng, m, npdt)
    alpha, beta, yy = (2.0, 0.25, y0) if accumulate else (None, None, None)
    args = (t(indptr), t(indices), t(data), t(x), alpha, beta,
            None if yy is None else t(yy))
    port = emulate_spmv(*args).numpy()
    tol = TOL[dtype]
    npt.assert_allclose(port, csr.csr_spmv_plain(*args).numpy(), rtol=tol,
                        atol=tol * np.abs(port).max())
    cols, vals = ell_arrays(indptr, indices, data)
    ref = _xla.ell_spmv(jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x),
                        alpha=alpha, beta=beta,
                        y0=None if yy is None else jnp.asarray(yy))
    npt.assert_allclose(port, np.asarray(ref), rtol=tol, atol=tol)
