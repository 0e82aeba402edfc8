"""The structural densify route of sparse-output products on the CPU.

K13 (``ops/compact``, ``csrc/csr_compact.cu``) and K12's indicator
template (``ops/densify.csr_indicator``) run only on the card, where
``chip_smoke.py`` phase 2 holds them against their plain versions; here
the wrappers take the plain versions, which are held against the JAX
package's ``_xla.extract_sparse_masked``, ``extract_structure`` and
``_indicator_sorted``.  The route (``ops.host.densified_sparse_product``:
dense values and indicators, two ``torch.matmul``, K13) is forced by
patching its gate and held against ``sparse_dot_tpu``'s ``dot_product`` and
``gram_matrix`` with sparse output: equal ``indptr`` and sorted
``indices``, values at decimal=6 (f64, c128) and 5 (f32, c64).  Off the
route: the CPU gate's rule, non-finite and tracked operands (K4 + K5,
scipy's result), the plane cache (``dense_planes``) with its budget,
switch and in-place changes, and dense x BSR on both SpMM routes.
Inputs come from numpy seeds.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import scipy.sparse as sps
import torch

import sparse_dot_tpu as sdt
import sparse_dot_tpu_torch as sdtt
from sparse_dot_tpu.ops import _xla
from sparse_dot_tpu_torch import formats, interface
from sparse_dot_tpu_torch.config import config
from sparse_dot_tpu_torch.ops import bsr, compact, densify, host, spgemm


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless asked otherwise; these tests ask
    for the CPU, where its wrappers take their plain versions.  The plane
    cache's settings are restored after each test."""
    saved = (config.device, config.spgemm_plane_cache,
             config.spgemm_plane_cache_bytes)
    config.device = "cpu"
    yield
    (config.device, config.spgemm_plane_cache,
     config.spgemm_plane_cache_bytes) = saved


VALUE_TYPES = [np.float32, np.float64, np.complex64, np.complex128]
INDEX_TYPES = [np.int32, np.int64]
DECIMAL = {np.dtype(np.float32): 5, np.dtype(np.complex64): 5,
           np.dtype(np.float64): 6, np.dtype(np.complex128): 6}


def values(rng, size, dtype):
    v = rng.standard_normal(size)
    if np.dtype(dtype).kind == "c":
        v = v + 1j * rng.standard_normal(size)
    return v.astype(dtype)


def random_sparse(rng, shape, density, dtype=np.float64, fmt="csr"):
    a = sps.random(*shape, density=density, format="csr", random_state=rng,
                   dtype=dtype, data_rvs=lambda s: values(rng, s, dtype))
    return a.asformat(fmt)


def same_sparse(got, want, decimal):
    """Equal format-free pattern (indptr, sorted indices) and values."""
    got, want = sps.csr_matrix(got), sps.csr_matrix(want)
    got.sort_indices()
    want.sort_indices()
    assert got.shape == want.shape and got.dtype == want.dtype
    npt.assert_array_equal(got.indptr, want.indptr)
    npt.assert_array_equal(got.indices, want.indices)
    npt.assert_array_almost_equal(got.data, want.data, decimal=decimal)


# ---------------------------------------------------------------------------
# K13's plain version against the JAX package's extraction
# ---------------------------------------------------------------------------

def count_plane(rng, r, n):
    """A structural count P (bf16) with an empty row (3), a full row (5),
    zeros elsewhere at random and counts up to 300 (bf16 rounds them)."""
    p = rng.integers(1, 300, (r, n)).astype(np.float32)
    p[rng.random((r, n)) < 0.6] = 0
    p[3] = 0
    p[5] = rng.integers(1, 4, n)
    return p


@pytest.mark.parametrize("triangular,row0", [(False, 0), (True, 0),
                                             (True, 7)],
                         ids=["full", "triangular", "triangular_row0"])
@pytest.mark.parametrize("itype", INDEX_TYPES)
@pytest.mark.parametrize("dtype", VALUE_TYPES)
def test_plain_compact_matches_jax_extract(dtype, itype, triangular, row0):
    """r = 23 rows of n = 45 columns (not a multiple of 32): the CSR of C at
    P > 0, cut to j >= row0 + i, equals ``extract_sparse_masked`` on the
    same mask (its values C's own, exactly), and its structure
    ``extract_structure``'s; an exact zero of C at the mask stays
    stored."""
    rng = np.random.default_rng(11)
    r, n = 23, 45
    p = count_plane(rng, r, n)
    c = values(rng, (r, n), dtype)
    c[5, 4] = 0  # an exact zero at a stored position
    mask = p > 0
    if triangular:
        mask &= np.arange(n)[None, :] >= row0 + np.arange(r)[:, None]
    nnz = int(mask.sum())
    want_v, want_c, want_p = (np.asarray(t) for t in _xla.extract_sparse_masked(
        jnp.asarray(c), jnp.asarray(mask.reshape(-1)), nnz))
    _, _, s_cols, s_indptr = (np.asarray(t) for t in _xla.extract_structure(
        jnp.asarray(mask.reshape(-1)), r, n, nnz))
    tdt = {np.int32: torch.int32, np.int64: torch.int64}[itype]
    got = compact.csr_compact(torch.from_numpy(c),
                              torch.from_numpy(p).to(torch.bfloat16),
                              triangular, row0, tdt)
    assert [t.dtype for t in got] == [tdt, tdt, torch.from_numpy(c).dtype]
    indptr, indices, data = (t.numpy() for t in got)
    npt.assert_array_equal(indptr, want_p)
    npt.assert_array_equal(indptr, s_indptr)
    npt.assert_array_equal(indices, want_c)
    npt.assert_array_equal(indices, s_cols)
    npt.assert_array_equal(data, c[mask])
    # The JAX package moves f64 values through hi|lo f32 limbs (~2^-49).
    npt.assert_allclose(data, want_v, rtol=1e-13, atol=0)
    assert indptr[4] == indptr[3]  # the empty row
    if not triangular:
        assert indptr[6] - indptr[5] == n  # the full row
        assert data[indptr[5] + 4] == 0
    assert compact.masked_compact.launches == 0


def test_compact_steps_and_checks():
    """``masked_compact`` gives the arrays and the total as a 0-d int64
    tensor; cut at that total they equal the one-call plain version; P of
    another type, a row offset below 0, a C of another shape and an index
    type too narrow for the shape are refused."""
    rng = np.random.default_rng(12)
    p = torch.from_numpy(count_plane(rng, 9, 70)).to(torch.bfloat16)
    c = torch.from_numpy(values(rng, (9, 70), np.float64))
    *arrays, total = compact.masked_compact(c, p, True, 2, torch.int64)
    assert total.dtype == torch.int64 and total.dim() == 0
    assert arrays[0][0] == 0 and arrays[0][-1] == total
    got = compact.cut(arrays, int(total), 70)
    want = compact.csr_compact_plain(c, p, True, 2, torch.int64)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="bfloat16"):
        compact.masked_compact(c, p.float())
    with pytest.raises(ValueError, match="row0"):
        compact.masked_compact(c, p, True, -1)
    with pytest.raises(ValueError, match="ILP64"):
        compact.cut(compact.masked_compact(c, p)[:3], 2 ** 31, 70)
    with pytest.raises(ValueError, match=r"C \(8, 70\)"):
        compact.masked_compact(c[1:], p)


def test_compact_workspaces_are_kept_per_stream_and_bounded():
    """K13's workspace: zeroed status words and ticket, one kept a (device,
    stream) and reused while it holds the tiles, each call's tag one more
    than the last, grown to at least twice its words, the words zeroed
    when the tag wraps, the least recently used dropped past
    ``_MAX_WORKSPACES``."""
    saved = compact._workspaces.copy()
    compact._workspaces.clear()
    cpu = torch.device("cpu")
    try:
        first = compact._workspace(cpu, 0, 5)
        assert first.status.dtype == torch.int64
        assert first.status.numel() == 5 and first.tag == 1
        assert not first.status.any() and not first.ticket.any()
        assert compact._workspace(cpu, 0, 3) is first and first.tag == 2
        grown = compact._workspace(cpu, 0, 6)
        assert grown.status.numel() == 10 and grown.tag == 1
        grown.status.fill_(7)
        grown.tag = compact._MAX_TAG - 1
        assert compact._workspace(cpu, 0, 1).tag == 1
        assert not grown.status.any()
        for stream in range(1, compact._MAX_WORKSPACES + 1):
            compact._workspace(cpu, stream, 1)
        assert len(compact._workspaces) == compact._MAX_WORKSPACES
        assert (cpu, 0) not in compact._workspaces
    finally:
        compact._workspaces.clear()
        compact._workspaces.update(saved)


@pytest.mark.parametrize("r,n,plan", [
    (500, 500, (4, 1, True)), (5000, 5000, (1, 1, True)),
    (23, 45, (8, 1, True)), (6, 70_000, (1, 1, True)),
    (40, 100_000, (1, 1, True)), (3, 400_000, (1, 2, False)),
    (5000, 1, (16, 1, True)), (100, 1_000_000, (1, 4, False))])
def test_compact_plan_fills_the_card_within_shared_memory(r, n, plan):
    """K13's tiles: case a's 500 x 500 takes 125 tiles of 4 rows, its 8
    items (2 steps of 256 columns a row) one a warp; the c128 gram's 5000
    x 5000 a row a tile, its 20 steps shared by the 8 warps; at most 1024
    items a tile (steps of 2 or 4 for the widest rows) and 32 rows; masks
    within ``STAGE_BYTES``, else none (P read again)."""
    assert compact.compact_plan(r, n) == plan
    rows, q, staged = plan
    steps = -(-n // 256)
    assert rows * -(-steps // q) <= compact._MAX_ITEMS
    assert staged == (rows * steps * 32 <= compact.STAGE_BYTES)


@pytest.mark.parametrize("triangular,row0", [(False, 0), (True, 0),
                                             (True, 3), (True, 40)])
@pytest.mark.parametrize("r,n", [(0, 5), (7, 9), (9, 7), (1, 1)])
def test_area_counts_the_positions(r, n, triangular, row0):
    """The fill's arrays hold ``area`` entries: every position of the r x n
    area, cut to j >= row0 + i with ``triangular``."""
    mask = np.ones((r, n), bool)
    if triangular:
        mask &= np.arange(n)[None, :] >= row0 + np.arange(r)[:, None]
    assert compact.area(r, n, triangular, row0) == int(mask.sum())


@pytest.mark.parametrize("itype", INDEX_TYPES)
def test_plain_indicator_matches_jax(itype):
    """K12's indicator template, plain: bf16 1.0 at every stored position
    (explicit zeros included), as ``_xla._indicator_sorted`` writes it for
    the sorted flat ids of a canonical CSR; repeated columns set it once."""
    rng = np.random.default_rng(13)
    a = random_sparse(rng, (31, 43), 0.2)
    a.data[::4] = 0  # explicit zeros
    flat = np.repeat(np.arange(31), np.diff(a.indptr)) * 43 + a.indices
    want = np.asarray(_xla._indicator_sorted(jnp.asarray(flat), 31 * 43),
                      dtype=np.float32).reshape(31, 43)
    got = densify.csr_indicator(torch.from_numpy(a.indptr.astype(itype)),
                                torch.from_numpy(a.indices.astype(itype)),
                                a.shape)
    assert got.dtype == torch.bfloat16
    npt.assert_array_equal(got.float().numpy(), want)
    doubled = densify.csr_indicator(torch.tensor([0, 2, 2]),
                                    torch.tensor([1, 1]), (2, 3))
    npt.assert_array_equal(doubled.float().numpy(), [[0, 1, 0], [0, 0, 0]])
    assert densify.csr_indicator.launches == 0


# ---------------------------------------------------------------------------
# The route, forced, against the JAX package
# ---------------------------------------------------------------------------

def forced(route):
    """The sparse-output gate patched to ``route``, the route's and K4 +
    K5's calls counted."""
    return (mock.patch.object(host, "_prefer_densify_sparse_product",
                              lambda *a, **k: route),
            mock.patch.object(host, "densified_sparse_product",
                              wraps=host.densified_sparse_product),
            mock.patch.object(spgemm, "csr_spgemm",
                              wraps=spgemm.csr_spgemm))


def run_forced(route, fn):
    gate, dense_route, k45 = forced(route)
    with gate, dense_route as r, k45 as k:
        res = fn()
    return res, r.call_count, k.call_count


SPARSE_PRODUCTS = {
    "x_xT": lambda pkg, x, y: pkg.dot_product(x, x.T),
    "x_xT_copy": lambda pkg, x, y: pkg.dot_product(x, x.T.tocsr()),
    "x_csc_y": lambda pkg, x, y: pkg.dot_product(x, y.tocsc()),
    "csc_x_y": lambda pkg, x, y: pkg.dot_product(x.tocsc(), y),
}


@pytest.mark.parametrize("dtype", VALUE_TYPES)
@pytest.mark.parametrize("case", sorted(SPARSE_PRODUCTS))
def test_sparse_route_matches_jax(case, dtype):
    rng = np.random.default_rng(14)
    x = random_sparse(rng, (17, 40), 0.15, dtype)
    y = random_sparse(rng, (40, 21), 0.15, dtype)
    got, routes, k45 = run_forced(
        True, lambda: SPARSE_PRODUCTS[case](sdtt, x, y))
    assert (routes, k45) == (1, 0)
    want = SPARSE_PRODUCTS[case](sdt, x, y)
    assert type(got) is type(want)
    same_sparse(got, want, DECIMAL[np.dtype(dtype)])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("transpose", [False, True], ids=["ata", "aat"])
def test_sparse_gram_route_matches_jax(transpose, dtype):
    """The sparse gram (upper triangle, K13 with ``triangular``) of X and
    of its transpose view, densified once."""
    rng = np.random.default_rng(15)
    x = random_sparse(rng, (19, 33), 0.2, dtype)
    with mock.patch.object(densify, "csr_densify",
                           wraps=densify.csr_densify) as k12:
        got, routes, k45 = run_forced(
            True, lambda: sdtt.gram_matrix(x, transpose=transpose))
    assert (routes, k45, k12.call_count) == (1, 0, 1)
    want = sdt.gram_matrix(x, transpose=transpose)
    same_sparse(got, want, DECIMAL[np.dtype(dtype)])
    assert sps.tril(got, -1).nnz == 0


def test_exact_cancellation_stays_stored():
    """Row 0 of A @ B sums 1 * 2 + 2 * -1 = 0: stored as an explicit zero on
    the route, as on K4 + K5 and in the JAX package's structural product
    (scipy drops it)."""
    a = sps.csr_matrix(np.array([[1.0, 2.0], [0.0, 3.0]]))
    b = sps.csr_matrix(np.array([[2.0, 1.0], [-1.0, 0.0]]))
    want = sdt.dot_product(a, b)
    assert np.diff(want.indptr).tolist() == [2, 1] and want[0, 0] == 0
    for route in (True, False):
        got, routes, k45 = run_forced(route, lambda: sdtt.dot_product(a, b))
        assert (routes, k45) == (int(route), int(not route))
        same_sparse(got, want, 12)


def test_handles_and_sypr_take_the_route():
    """``matmul_handles`` and ``sypr`` reach the route through
    ``spgemm_device`` / ``spgemm_sparse_arrays``."""
    rng = np.random.default_rng(16)
    a = random_sparse(rng, (12, 12), 0.3)
    b = random_sparse(rng, (12, 12), 0.3)
    b = (b + b.T).tocsr()
    ha = interface.create_sparse_handle(a)[0]
    hb = interface.create_sparse_handle(b)[0]
    got, routes, _ = run_forced(True, lambda: interface.export_sparse_handle(
        interface.matmul_handles(ha, hb)))
    assert routes == 1
    same_sparse(got, sdt.dot_product(a, b), 12)
    got, routes, k45 = run_forced(True, lambda: sdtt.sypr(a, b))
    assert (routes, k45) == (2, 0)
    same_sparse(got, sdt.sypr(a, b), 6)


# ---------------------------------------------------------------------------
# The gate, and the ways off the route
# ---------------------------------------------------------------------------

SPARSE_GATE_GRID = [(m, k, n, a_frac, b_frac)
                    for m, k, n in ((1, 1, 1), (7, 300, 9), (200, 20, 200))
                    for a_frac in (0.0, 0.3, 1.0)
                    for b_frac in (0.1, 0.6, 1.0)]


@pytest.mark.parametrize("m,k,n,a_frac,b_frac", SPARSE_GATE_GRID)
def test_cpu_sparse_gate_rule(m, k, n, a_frac, b_frac):
    """On the CPU: the products a_nnz * b_nnz / k past 0.25 m k n, the
    dense-output gate's rule, whatever the type and the triangle."""
    a_nnz, b_nnz = int(a_frac * m * k), int(b_frac * k * n)
    want = a_nnz * b_nnz / k > 0.25 * m * k * n
    for dtype in (torch.float32, torch.complex128):
        for tri in (False, True):
            assert host._prefer_densify_sparse_product(
                m, k, n, a_nnz, b_nnz, dtype, torch.device("cpu"),
                False, tri) == want
    assert want == host._prefer_densify_product(
        m, k, n, a_nnz, b_nnz, torch.float64, torch.device("cpu"))


@pytest.mark.parametrize("density,route", [(0.05, False), (0.6, True)])
def test_dot_product_takes_the_gate(density, route):
    rng = np.random.default_rng(17)
    x = random_sparse(rng, (20, 30), density)
    with mock.patch.object(host, "densified_sparse_product",
                           wraps=host.densified_sparse_product) as r, \
            mock.patch.object(spgemm, "csr_spgemm",
                              wraps=spgemm.csr_spgemm) as k45:
        got = sdtt.dot_product(x, x.T)
    assert (r.call_count, k45.call_count) == (int(route), int(not route))
    same_sparse(got, sdt.dot_product(x, x.T), 6)


def test_card_sparse_gate_cost_models():
    """The card's form: the dense route at the demo X @ X.T and its gram,
    never past the cap (the 1M^2 A @ A, a 50k^2 sypr step), K4 + K5 where
    the products are few, and one densify never dearer than two."""
    cuda, f64 = torch.device("cuda"), torch.float64
    x_nnz = 530_000
    assert host._prefer_densify_sparse_product(500, 5000, 500, x_nnz, x_nnz,
                                               f64, cuda, True)
    assert host._prefer_densify_sparse_product(500, 5000, 500, x_nnz, x_nnz,
                                               f64, cuda, True, True)
    for side, nnz in ((1_000_000, 2_000_000), (50_000, 60_000)):
        assert not host._prefer_densify_sparse_product(
            side, side, side, nnz, nnz, f64, cuda)
    assert not host._prefer_densify_sparse_product(
        10_000, 10_000, 10_000, 100_000, 100_000, f64, cuda)
    for nnz in (10_000, 300_000, 1_000_000):
        one = host._prefer_densify_sparse_product(500, 5000, 500, nnz, nnz,
                                                  f64, cuda, True)
        two = host._prefer_densify_sparse_product(500, 5000, 500, nnz, nnz,
                                                  f64, cuda, False)
        assert one or not two


@pytest.mark.parametrize("bad", [np.nan, np.inf], ids=["nan", "inf"])
@pytest.mark.parametrize("operand", ["a", "b"])
def test_nonfinite_operand_takes_k4_k5(operand, bad):
    """inf or nan in either operand's stored values: the route runs up to
    its host read, drops its product, and K4 + K5 give scipy's structural
    sums (no 0 * inf)."""
    rng = np.random.default_rng(18)
    a = random_sparse(rng, (8, 6), 0.9)
    b = random_sparse(rng, (6, 7), 0.9)
    (a if operand == "a" else b).data[1] = bad
    with mock.patch.object(compact, "masked_compact",
                           wraps=compact.masked_compact) as fill:
        got, routes, k45 = run_forced(True, lambda: sdtt.dot_product(a, b))
    assert (routes, k45, fill.call_count) == (1, 1, 1)
    want = a @ b
    got.sort_indices()
    want.sort_indices()
    npt.assert_array_equal(got.indptr, want.indptr)
    npt.assert_array_equal(got.indices, want.indices)
    npt.assert_array_equal(np.isnan(got.data), np.isnan(want.data))
    ok = ~np.isnan(want.data)
    npt.assert_array_equal(got.data[ok], want.data[ok])


def test_tracked_values_take_k4_k5():
    """A container whose values require grad stays on K4 + K5 (K12 would
    refuse them) without raising, and its result carries the gradient."""
    rng = np.random.default_rng(19)
    x = random_sparse(rng, (9, 14), 0.5)
    A = formats.to_device(x)
    A.data.requires_grad_()
    C, routes, k45 = run_forced(True, lambda: host.spgemm_device(A, A.T))
    assert (routes, k45) == (0, 1)
    assert C.data.grad_fn is not None
    got = sps.csr_matrix((C.data.detach().numpy(), C.indices.numpy(),
                          C.indptr.numpy()), shape=C.shape)
    same_sparse(got, x @ x.T, 12)


# ---------------------------------------------------------------------------
# Planes kept on a container
# ---------------------------------------------------------------------------

def counted_densifies():
    return (mock.patch.object(densify, "csr_densify",
                              wraps=densify.csr_densify),
            mock.patch.object(densify, "csr_indicator",
                              wraps=densify.csr_indicator))


def repeat_calls(fn, calls=3):
    """K12's and its indicator's calls in each of ``calls`` calls of fn."""
    values_, indicators = counted_densifies()
    seen = []
    with values_ as k12, indicators as ind:
        for _ in range(calls):
            before = (k12.call_count, ind.call_count)
            fn()
            seen.append((k12.call_count - before[0],
                         ind.call_count - before[1]))
    return seen


def test_repeat_call_reads_kept_planes():
    """dot_product(A, A.T) on one container: the first call densifies the
    values and the indicator once (the pair), the repeats launch no K12
    and read no finite flag (the planes know it)."""
    rng = np.random.default_rng(20)
    x = random_sparse(rng, (15, 25), 0.4)
    A = formats.to_device(x)
    want = sdt.dot_product(x, x.T)
    results = []
    with mock.patch.object(host, "_prefer_densify_sparse_product",
                           lambda *a, **k: True):
        seen = repeat_calls(lambda: results.append(sdtt.dot_product(A, A.T)))
    assert seen == [(1, 1), (0, 0), (0, 0)]
    assert A._planes.finite is True
    for got in results:
        same_sparse(got, want, 6)


def test_in_place_change_of_data_is_seen():
    rng = np.random.default_rng(21)
    x = random_sparse(rng, (12, 20), 0.4)
    A = formats.to_device(x)
    with mock.patch.object(host, "_prefer_densify_sparse_product",
                           lambda *a, **k: True):
        first = sdtt.dot_product(A, A.T)
        A.data.mul_(2)
        seen = repeat_calls(lambda: sdtt.dot_product(A, A.T), 1)
        second = sdtt.dot_product(A, A.T)
    assert seen == [(1, 1)]
    same_sparse(first, x @ x.T, 12)
    same_sparse(second, 4 * (x @ x.T), 12)
    A.data[0] = np.inf  # in place again: the new flag is read, K4 + K5 run
    with mock.patch.object(spgemm, "csr_spgemm",
                           wraps=spgemm.csr_spgemm) as k45, \
            mock.patch.object(host, "_prefer_densify_sparse_product",
                              lambda *a, **k: True):
        sdtt.dot_product(A, A.T)
        sdtt.dot_product(A, A.T)
    assert k45.call_count == 2 and A._planes.finite is False


@pytest.mark.parametrize("setting", ["budget", "switched_off"])
def test_cache_budget_and_switch(setting):
    """Planes past ``spgemm_plane_cache_bytes``, or with
    ``spgemm_plane_cache = False``, are not kept: every call densifies."""
    rng = np.random.default_rng(22)
    x = random_sparse(rng, (10, 30), 0.5)
    A = formats.to_device(x)
    if setting == "budget":
        # The dense f64 values fit, with the bf16 indicator they do not.
        config.spgemm_plane_cache_bytes = 10 * 30 * 8 + 10
    else:
        config.spgemm_plane_cache = False
    with mock.patch.object(host, "_prefer_densify_sparse_product",
                           lambda *a, **k: True):
        seen = repeat_calls(lambda: sdtt.dot_product(A, A.T), 2)
    assert seen == [(1, 1), (1, 1)]
    assert "_planes" not in A.__dict__


def test_spmm_and_dense_output_read_the_planes():
    """SpMM and the dense-output product on the densify route read the
    kept dense op(A) (no indicator) on a container's repeat use."""
    rng = np.random.default_rng(23)
    x = random_sparse(rng, (16, 12), 0.6)
    b = values(rng, (12, 5), np.float64)
    A = formats.to_device(x)
    seen = repeat_calls(lambda: npt.assert_array_almost_equal(
        sdtt.dot_product(A, b), x @ b, decimal=12))
    assert seen == [(1, 0), (0, 0), (0, 0)]
    seen = repeat_calls(lambda: npt.assert_array_almost_equal(
        sdtt.dot_product(A, A.T, dense=True), (x @ x.T).toarray(),
        decimal=12))
    assert seen == [(0, 0), (0, 0), (0, 0)]


# ---------------------------------------------------------------------------
# Dense x BSR and op(BSR)^T through the densify gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("density", [0.1, 0.6])
@pytest.mark.parametrize("case", ["dense_x_bsr", "bsr_x_dense"])
def test_bsr_spmm_routes(case, density, dtype):
    """dense x BSR (op(A) = Aᵀ) takes the densify route above the CPU gate
    (nnz / (m k) > 0.25) and K1 over the transposed blocks below it; an
    untransposed BSR stays on K1 at any density.  Against the JAX
    package."""
    rng = np.random.default_rng(24)
    a = random_sparse(rng, (6, 4), density, dtype).toarray()
    a = sps.bsr_matrix(np.kron(a, np.ones((3, 3), dtype)), blocksize=(3, 3))
    d = values(rng, (5, 18), dtype) if case == "dense_x_bsr" else \
        values(rng, (12, 5), dtype)
    with mock.patch.object(host, "densified_spmm",
                           wraps=host.densified_spmm) as route, \
            mock.patch.object(bsr, "bsr_spmm", wraps=bsr.bsr_spmm) as k1:
        got = sdtt.dot_product(d, a) if case == "dense_x_bsr" else \
            sdtt.dot_product(a, d)
    dense_route = case == "dense_x_bsr" and a.nnz / (18 * 12) > 0.25
    assert (route.call_count, k1.call_count) == (int(dense_route),
                                                 int(not dense_route))
    want = sdt.dot_product(d, a) if case == "dense_x_bsr" else \
        sdt.dot_product(a, d)
    npt.assert_array_almost_equal(got, want, decimal=12)


# ---------------------------------------------------------------------------
# The C interface
# ---------------------------------------------------------------------------

def test_prototypes_match_the_c_entry_points():
    """Every ``extern "C"`` entry point of ``csrc/`` has a ctypes prototype
    in ``ops/_build`` and every prototype an entry point (K13's one launch
    replaced its count and fill entry points; K7's took ``shared``), each
    with as many parameters: ctypes passes surplus arguments unchecked, so
    a missing one shifts the rest."""
    import re

    from sparse_dot_tpu_torch.ops import _build

    found = {}
    for path in _build.CSRC.glob("*.cu"):
        for name, params in re.findall(
                r'extern "C" int (sdt_\w+)\(([^)]*)\)', path.read_text()):
            found[name] = len([p for p in params.split(",") if p.strip()])
    assert set(_build._PROTOTYPES) == set(found)
    for name, argtypes in _build._PROTOTYPES.items():
        assert len(argtypes) == found[name], name
    assert "sdt_csr_compact_count" not in found
    assert found["sdt_csr_compact"] == 19 and found["sdt_csr_sddmm"] == 23
