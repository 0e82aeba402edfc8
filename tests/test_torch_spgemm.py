"""The port's sparse x sparse products against the JAX package's.

The same scipy inputs, made from a seed, go through
``sparse_dot_tpu.ops.host`` (JAX on the CPU) and the port's
``ops.host`` (torch on the CPU, where the K4/K5/K6 wrappers take their
plain versions).  Sparse results must have equal ``indptr`` and
``indices``, structural patterns included (explicit zeros and exactly
cancelled sums stay stored); values agree within rtol 1e-12 (float64,
complex128) or 1e-5 (float32, complex64), with atol = rtol * max|ref|:
the two sum in different orders.

Also here: the row bounds and row bins that choose K4/K5's accumulators
(``ops.spgemm.spgemm_plan``), the plain versions' chunking, the output
nnz overflow check, and the slice as a whole (``dot_product``,
``gram_matrix``, ``sypr``) against the JAX package.
"""

import contextlib

import numpy as np
import numpy.testing as npt
import pytest
import scipy.sparse as sps
import torch

import sparse_dot_tpu as sdt
import sparse_dot_tpu_torch as sdtt
from sparse_dot_tpu.ops import host as jax_host
from sparse_dot_tpu_torch import formats
from sparse_dot_tpu_torch.config import config
from sparse_dot_tpu_torch.ops import host, spgemm


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless asked otherwise; these tests ask
    for the CPU, where its wrappers take their plain versions."""
    saved = config.device
    config.device = "cpu"
    yield
    config.device = saved


TOL = {
    np.dtype(np.float32): 1e-5,
    np.dtype(np.complex64): 1e-5,
    np.dtype(np.float64): 1e-12,
    np.dtype(np.complex128): 1e-12,
}


def random_sparse(shape, density, dtype=np.float64, seed=0, fmt="csr"):
    rng = np.random.default_rng(seed)
    a = sps.random(*shape, density=density, format="csr", random_state=rng)
    if np.dtype(dtype).kind == "c":
        a = a + 0.5j * sps.random(*shape, density=density, format="csr",
                                  random_state=rng)
    a = a.astype(dtype).tocsr()
    a.data -= 0.5 * a.data.real.mean()
    return a.asformat(fmt)


def rows_of(lengths, width, dtype=np.float64, seed=0):
    """CSR whose row i holds lengths[i] distinct random columns."""
    rng = np.random.default_rng(seed)
    cols = [np.sort(rng.choice(width, n, replace=False)) for n in lengths]
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    data = rng.standard_normal(int(indptr[-1])).astype(dtype)
    return sps.csr_matrix((data, np.concatenate(cols), indptr),
                          shape=(len(lengths), width))


def with_explicit_zeros(a):
    a = a.copy()
    a.data[::3] = 0
    return a


def cancelling():
    """A @ B with exactly cancelled entries: row 0 of the product sums
    1 * 1 + 1 * (-1) in every column."""
    a = sps.csr_matrix(np.array([[1.0, 1.0, 0.0], [0.0, 2.0, 3.0]]))
    b = sps.csr_matrix(np.array([[1.0, 2.0, 0.0, 1.0],
                                 [-1.0, -2.0, 0.0, 0.0],
                                 [0.0, 1.0, 1.0, 0.0]]))
    return a, b


def empty_rows():
    a = random_sparse((30, 40), 0.15, seed=1).tolil()
    a[::4] = 0
    b = random_sparse((40, 25), 0.15, seed=2).tolil()
    b[::3] = 0
    return a.tocsr(), b.tocsr()


WIDE_N = 40_000  # > 32768, and a dense f64 row of it exceeds 200 KB
LONG_ROW = 300   # x 30 per row of B: ub = 9000, past the largest table


def wide():
    a = rows_of([0, 1, 5, 40, LONG_ROW, 2], 600, seed=3)
    b = rows_of([30] * 600, WIDE_N, seed=4)
    return a, b


def random_coo_csr(m, nnz, seed):
    """m x m CSR from nnz random (row, col, N(0, 1)) triples, duplicates
    summed: the recipe of the 1M x 1M A @ A, whose rows have few products
    (about 2 here, none over 32)."""
    rng = np.random.default_rng(seed)
    a = sps.csr_matrix((rng.standard_normal(nnz),
                        (rng.integers(0, m, nnz), rng.integers(0, m, nnz))),
                       shape=(m, m))
    a.sum_duplicates()
    a.sort_indices()
    return a


def few_products():
    a = random_coo_csr(20_000, 40_000, seed=27)
    return a, a


CASES = {
    "csr_f64": lambda: (random_sparse((30, 40), 0.15, seed=5),
                        random_sparse((40, 50), 0.15, seed=6)),
    "csr_f32": lambda: (random_sparse((30, 40), 0.15, np.float32, 5),
                        random_sparse((40, 50), 0.15, np.float32, 6)),
    "csr_c64": lambda: (random_sparse((30, 40), 0.15, np.complex64, 5),
                        random_sparse((40, 50), 0.15, np.complex64, 6)),
    "csr_c128": lambda: (random_sparse((30, 40), 0.15, np.complex128, 5),
                         random_sparse((40, 50), 0.15, np.complex128, 6)),
    "csc_x_csr": lambda: (random_sparse((30, 40), 0.15, seed=7, fmt="csc"),
                          random_sparse((40, 50), 0.15, seed=8)),
    "csr_x_csc": lambda: (random_sparse((30, 40), 0.15, seed=9),
                          random_sparse((40, 50), 0.15, seed=10, fmt="csc")),
    "bsr_x_bsr": lambda: (random_sparse((30, 40), 0.1, seed=11)
                          .tobsr(blocksize=(5, 5)),
                          random_sparse((40, 50), 0.1, seed=12)
                          .tobsr(blocksize=(5, 5))),
    "bsr_x_csr": lambda: (random_sparse((30, 40), 0.1, seed=13)
                          .tobsr(blocksize=(2, 2)),
                          random_sparse((40, 50), 0.15, seed=14)),
    "explicit_zeros": lambda: (
        with_explicit_zeros(random_sparse((30, 40), 0.2, seed=15)),
        with_explicit_zeros(random_sparse((40, 50), 0.2, seed=16))),
    "cancellation": cancelling,
    "empty_rows": empty_rows,
    "nnz_0": lambda: (sps.csr_matrix((20, 30)),
                      random_sparse((30, 40), 0.2, seed=17)),
    "wide_n_long_row": wide,
    "few_products_20k": few_products,
}
TRIANGULAR_CASES = ("csr_f64", "csr_c128", "bsr_x_bsr", "cancellation",
                    "wide_n_long_row", "few_products_20k")


def out_dtype(a, b):
    return np.result_type(a.dtype, b.dtype)


@contextlib.contextmanager
def interface(name):
    """Both packages' index interface set to ``name`` for the block."""
    old_p, old_j = config.interface, sdt.interface_integer_dtype()
    sdtt.set_interface_layer(name)
    sdt.set_interface_layer(name)
    try:
        yield
    finally:
        sdtt.set_interface_layer(old_p)
        sdt.set_interface_layer("ILP64" if old_j == np.int64 else "LP64")


def assert_values(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    tol = TOL[port.dtype]
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    npt.assert_allclose(port, ref, rtol=tol, atol=tol * scale)


def assert_same_csr(port, ref):
    """(data, indices, indptr) triples: equal pattern, close values."""
    npt.assert_array_equal(np.asarray(port[2]), np.asarray(ref[2]))
    npt.assert_array_equal(np.asarray(port[1]), np.asarray(ref[1]))
    assert_values(port[0], ref[0])


def both_arrays(a, b, triangular=False):
    dt = out_dtype(a, b)
    port = host.spgemm_sparse_arrays(formats.to_device(a),
                                     formats.to_device(b), dt, triangular)
    ref = jax_host.spgemm_sparse_arrays(sdt.to_device(a), sdt.to_device(b),
                                        dt, triangular=triangular)
    return port, ref


@pytest.mark.parametrize("case", sorted(CASES))
def test_spgemm_arrays_match_jax(case):
    port, ref = both_arrays(*CASES[case]())
    assert port[1].dtype == np.dtype(config.index_dtype)
    assert_same_csr(port, ref)


@pytest.mark.parametrize("case", TRIANGULAR_CASES)
def test_spgemm_triangular_matches_jax(case):
    assert_same_csr(*both_arrays(*CASES[case](), triangular=True))


@pytest.mark.parametrize("case", ["csr_f64", "bsr_x_csr", "wide_n_long_row"])
def test_spgemm_int64_indices_match_jax(case):
    with interface("ILP64"):
        a, b = CASES[case]()
        port, ref = both_arrays(a, b)
        assert port[1].dtype == port[2].dtype == np.int64
    assert_same_csr(port, ref)


def test_cancelled_entries_stay_stored():
    a, b = cancelling()
    data, indices, indptr = host.spgemm_sparse_arrays(
        formats.to_device(a), formats.to_device(b), np.float64)
    npt.assert_array_equal(indptr, [0, 3, 6])
    npt.assert_array_equal(indices, [0, 1, 3, 0, 1, 2])
    npt.assert_array_equal(data[:2], [0.0, 0.0])


@pytest.mark.parametrize("case", ["csr_f64", "csr_c128", "csr_x_csc",
                                  "bsr_x_bsr", "empty_rows"])
@pytest.mark.parametrize("accumulate", [False, True], ids=["new", "out"])
def test_spgemm_dense_matches_jax(case, accumulate):
    a, b = CASES[case]()
    dt = out_dtype(a, b)
    kwargs = {}
    if accumulate:
        rng = np.random.default_rng(1)
        kwargs = {"out": rng.standard_normal((a.shape[0], b.shape[1]))
                  .astype(dt), "out_scalar": -0.5}
    port = host.spgemm_dense(formats.to_device(a), formats.to_device(b), dt,
                             **kwargs)
    ref = jax_host.spgemm_dense(sdt.to_device(a), sdt.to_device(b), dt,
                                **kwargs)
    assert_values(port, ref)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.complex128])
@pytest.mark.parametrize("aat", [False, True], ids=["ata", "aat"])
def test_gram_matches_jax(dtype, aat):
    a = random_sparse((30, 45), 0.12, dtype, seed=18)
    port_a, ref_a = formats.to_device(a), sdt.to_device(a)
    assert_same_csr(host.gram_sparse(port_a, dtype, aat=aat),
                    jax_host.gram_sparse(ref_a, dtype, aat=aat))
    out = np.random.default_rng(2).standard_normal(
        (30, 30) if aat else (45, 45)).astype(dtype)
    for kwargs in ({}, {"out": out, "out_scalar": 2.0, "full": True},
                   {"out": out, "out_scalar": 2.0}):
        assert_values(
            host.gram_dense_from_sparse(port_a, dtype, aat=aat, **kwargs),
            jax_host.gram_dense_from_sparse(ref_a, dtype, aat=aat, **kwargs))


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_gram_dense_input_matches_jax(dtype):
    d = random_sparse((20, 15), 0.5, dtype, seed=19).toarray()
    out = np.ones((15, 15), dtype)
    for aat, kwargs in ((False, {}), (True, {}),
                        (False, {"out": out, "out_scalar": 3.0})):
        assert_values(
            host.gram_dense_from_dense(d, dtype, aat=aat, **kwargs),
            jax_host.gram_dense_from_dense(d, dtype, aat=aat, **kwargs))


def test_product_of_a_jax_result_carried_into_the_port():
    """A JAX device result, carried over by ``formats.from_arrays``, is a
    port operand whose product matches the JAX package's."""
    a, b = CASES["explicit_zeros"]()
    c = random_sparse((50, 20), 0.2, seed=20)
    mid = jax_host.spgemm_device(sdt.to_device(a), sdt.to_device(b))
    mid_port = formats.from_arrays("csr", mid.data, mid.indices,
                                   mid.indptr, mid.shape)
    port = host.spgemm_sparse_arrays(mid_port, formats.to_device(c),
                                     np.float64)
    ref = jax_host.spgemm_sparse_arrays(mid, sdt.to_device(c), np.float64)
    assert_same_csr(port, ref)


def test_repeated_entries_are_summed_before_a_product():
    """Containers hold each entry once (K4/K5 let one thread own each
    column of a row of op(B)): ``from_arrays`` and a non-canonical scipy
    BSR have their repeats summed, on a copy."""
    data, indices = np.array([1.0, 2.0, 3.0, 4.0]), np.array([1, 1, 0, 1])
    indptr = np.array([0, 3, 4])
    b = formats.from_arrays("csr", data, indices, indptr, (2, 3))
    npt.assert_array_equal(b.indices.numpy(), [0, 1, 1])
    npt.assert_array_equal(b.data.numpy(), [3.0, 3.0, 4.0])
    npt.assert_array_equal(indices, [1, 1, 0, 1])
    a = formats.to_device(sps.csr_matrix(np.ones((2, 2))))
    ref = np.ones((2, 2)) @ np.array([[3.0, 3.0, 0.0], [0.0, 4.0, 0.0]])
    got = host.spgemm_dense(a, b, np.float64)
    npt.assert_array_equal(got, ref)
    blocks = np.arange(12.0).reshape(3, 2, 2)
    bsr = sps.bsr_matrix((blocks, np.array([0, 0, 1]), np.array([0, 2, 3])),
                         shape=(4, 4))
    assert not bsr.has_canonical_format
    port = formats.to_device(bsr)
    assert port.nblocks == 2
    npt.assert_array_equal(port.to_scipy().toarray(), bsr.toarray())


def test_spgemm_device_stays_on_the_device():
    a, b = CASES["csr_f64"]()
    C = host.spgemm_device(formats.to_device(a), formats.to_device(b))
    assert isinstance(C, formats.CSR) and C.shape == (30, 50)
    assert C.indptr.dtype == C.indices.dtype == torch.int32
    npt.assert_allclose(C.to_scipy().toarray(), (a @ b).toarray(),
                        rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# row bounds and row bins (ops.spgemm.spgemm_plan)
# ---------------------------------------------------------------------------


def t(arr):
    return torch.from_numpy(np.ascontiguousarray(arr))


INDEX_TYPES = [torch.int32, torch.int64]
VALUE_TYPES = [torch.float32, torch.float64, torch.complex64,
               torch.complex128]


@pytest.mark.parametrize("case", ["csr_f64", "empty_rows", "nnz_0",
                                  "wide_n_long_row"])
def test_row_bounds_count_products(case):
    a, b = CASES[case]()
    pattern = a.copy()
    pattern.data = np.ones_like(a.data, dtype=np.int64)  # stored zeros too
    ref = pattern @ np.diff(b.indptr).astype(np.int64)
    ub = spgemm.row_bounds(t(a.indptr), t(a.indices), t(b.indptr))
    assert ub.dtype == torch.int64
    npt.assert_array_equal(ub.numpy(), ref)


@pytest.mark.parametrize("dtype", VALUE_TYPES)
@pytest.mark.parametrize("itype", INDEX_TYPES)
@pytest.mark.parametrize("n", [300, 5000, WIDE_N, 10**6])
def test_bins_table(dtype, itype, n):
    bins = spgemm.spgemm_bins(dtype, itype, n)
    kinds, slots, u_max = bins.T
    assert kinds[0] == spgemm.SKIP and u_max[0] == 0
    assert (np.diff(u_max) > 0).all() and u_max[-1] == np.iinfo(np.int64).max
    # The register bins, in the order the kernel launches them, whatever n.
    tiny = len(spgemm.TINY_KINDS)
    assert list(kinds[1:1 + tiny]) == [spgemm.TINY4, spgemm.TINY8,
                                       spgemm.TINY16, spgemm.TINY32]
    assert list(slots[1:1 + tiny]) == list(u_max[1:1 + tiny]) == [4, 8, 16,
                                                                  32]
    entry = dtype.itemsize + itype.itemsize
    hashed = bins[1 + tiny:-1]
    for kind, s, u in hashed:
        assert kind in (spgemm.SORTED_WARP, spgemm.HASH_BLOCK)
        assert s & (s - 1) == 0 and u > spgemm.TINY_MAX
        if kind == spgemm.SORTED_WARP:
            # A warp's products a row, its region sized to them.
            assert u == s and s in spgemm.WARP_PRODUCTS
            assert spgemm.group_bytes(kind, s, dtype, itype, 4) == 8 * (
                s * (2 * itype.itemsize + 2))
        else:
            assert u == s // 2 and s * entry <= spgemm.SHARED_BUDGET
    # The sorted-product bins stand where the warp hash tables of 256 and
    # 1024 slots stood; no bin of 64 (rows of u <= 32 past 32 products
    # have n <= 32, where the dense row takes them).
    warp = [tuple(r) for r in hashed[:, :2] if r[0] == spgemm.SORTED_WARP]
    assert warp == [(spgemm.SORTED_WARP, u)
                    for u in spgemm.WARP_PRODUCTS][:len(warp)]
    assert 64 not in slots
    dense_fits = n * (dtype.itemsize + 1) <= spgemm.SHARED_BUDGET
    assert kinds[-1] == (spgemm.DENSE_SHARED if dense_fits
                         else spgemm.DENSE_GLOBAL)
    assert slots[-1] == n
    if dense_fits:
        # Past 32 products a bin stands only where its hash table (2 u
        # slots) would hold fewer than n / DENSE_RATIO.
        assert (n > spgemm.DENSE_RATIO * 2 * hashed[:, 2]).all()
    else:
        assert slots[-2] == spgemm.max_hash_slots(dtype, itype)
    # Routing on ub picks, past 32 products, the bin that u = min(ub, n)
    # would: the accumulators are sized by a row's distinct columns.
    ubs = np.unique(np.concatenate([
        np.arange(70), u_max[:-1], u_max[:-1] + 1,
        [n - 1, n, n + 1, 2 * n, 10 * n]]))
    u = np.where(ubs <= spgemm.TINY_MAX, ubs,
                 np.maximum(np.minimum(ubs, n), spgemm.TINY_MAX + 1))
    npt.assert_array_equal(np.searchsorted(u_max[:-1], ubs),
                           np.searchsorted(u_max[:-1], u))


@pytest.mark.parametrize("itype", INDEX_TYPES)
def test_plan_groups_rows_by_bin(itype):
    rng = np.random.default_rng(21)
    a = rows_of(rng.integers(0, 400, 400), 500, seed=22)
    b = rows_of(rng.integers(0, 60, 500), WIDE_N, seed=23)
    np_itype = np.int32 if itype == torch.int32 else np.int64
    ip, ix = t(a.indptr.astype(np_itype)), t(a.indices.astype(np_itype))
    plan = spgemm.spgemm_plan(ip, ix, t(b.indptr.astype(np_itype)), WIDE_N,
                              torch.float64, itype)
    assert plan.ub.dtype == torch.int64
    assert sorted(plan.rows.tolist()) == list(range(400))
    assert plan.offsets[0] == 0 and plan.offsets[-1] == 400
    key = plan.ub
    u_max = torch.from_numpy(plan.bins[:, 2])
    for b_id in range(len(plan.bins)):
        rows = plan.rows[plan.offsets[b_id]:plan.offsets[b_id + 1]]
        assert (key[rows] <= u_max[b_id]).all()
        assert (rows.diff() > 0).all()  # row order within a bin
        if b_id:
            assert (key[rows] > u_max[b_id - 1]).all()
    assert set(plan.bins[plan.offsets.diff().numpy() > 0, 0]) >= {
        spgemm.SKIP, spgemm.SORTED_WARP, spgemm.HASH_BLOCK,
        spgemm.DENSE_GLOBAL}


@pytest.mark.parametrize("m, n", [(0, 50), (0, 0), (7, 0)])
def test_empty_plan_equals_spgemm_plan(m, n):
    """Where no row has a product, the plan ``plan_and_count`` makes on the
    card without a launch equals ``spgemm_plan``'s."""
    a = sps.csr_matrix((m, 5))
    b = sps.csr_matrix((5, n))
    plan = spgemm.spgemm_plan(t(a.indptr), t(a.indices), t(b.indptr), n,
                              torch.float64, torch.int32)
    empty = spgemm._empty_plan(m, plan.bins, torch.device("cpu"))
    for got, want in zip(empty[:3], plan[:3]):
        assert got.dtype == want.dtype and torch.equal(got, want)
    npt.assert_array_equal(empty.bins, plan.bins)


def routed(a, b, n):
    """{row: bin kind} of spgemm_plan for a @ b with n columns."""
    plan = spgemm.spgemm_plan(t(a.indptr), t(a.indices), t(b.indptr), n,
                              torch.float64, torch.int32)
    kind = {}
    for b_id, (k, _, _) in enumerate(plan.bins):
        for r in plan.rows[plan.offsets[b_id]:plan.offsets[b_id + 1]]:
            kind[int(r)] = int(k)
    return kind, plan.ub.numpy()


@pytest.mark.parametrize("n", [8, 300, WIDE_N])
def test_rows_route_by_products(n):
    """Rows of 1..32 products go to the register bin of the smallest width
    at or above their products, whatever n (also where n < ub); ub = 0 to
    SKIP; a row of 33 products past the register bins (the dense row at
    n = 8 and 300, the sorted-product bin of a warp at WIDE_N); a row of
    100 op(A)
    entries over mostly empty op(B) rows by its products alone."""
    b_len = [3, 0, 1, 4, 0, 0, 2, 5]  # op(B) rows k, read modulo 8
    ubs = [0, 1, 4, 5, 8, 9, 16, 17, 31, 32, 33, 40]
    k = 800
    a_rows = []
    for ub in ubs:  # entries over op(B) rows 0 (3 each) and 2 (1) reach ub
        a_rows.append([8 * s for s in range(ub // 3)]
                      + [8 * s + 2 for s in range(ub % 3)])
    a_rows.append([8 * s + 1 for s in range(99)] + [2])  # 100 entries, ub 1
    a_rows.append([8 * s + 4 for s in range(90)]
                  + [8 * s + 3 for s in range(7)])  # 97 entries, ub 28
    indptr = np.concatenate([[0], np.cumsum([len(r) for r in a_rows])])
    a = sps.csr_matrix((np.ones(indptr[-1]), np.concatenate(a_rows), indptr),
                       shape=(len(a_rows), k))
    b = rows_of([b_len[i % 8] if b_len[i % 8] <= n else n for i in range(k)],
                n, seed=28)
    kind, ub = routed(a, b, n)
    assert list(ub) == ubs + [1, 28]
    assert len(a_rows[-2]) == 100 and len(a_rows[-1]) == 97
    for row, products in enumerate(ub):
        if products == 0:
            want = spgemm.SKIP
        elif products <= spgemm.TINY_MAX:
            g = min(w for w in spgemm.TINY_KINDS if w >= products)
            want = spgemm.TINY_KINDS[g]
        elif n == WIDE_N:
            want = spgemm.SORTED_WARP
        else:
            want = spgemm.DENSE_SHARED
        assert kind[row] == want, (row, products)
    if n == 8:  # more products than columns, still one a lane
        assert {kind[r] for r in range(len(ubs)) if 8 < ub[r] <= 32} == {
            spgemm.TINY16, spgemm.TINY32}


@pytest.mark.parametrize("sizes", [None, [5, 3, 0, 0, 0, 0, 0, 0, 0, 2],
                                   [5, 0, 0, 0, 0, 0, 1, 0, 0, 0]])
def test_launch_table_skips_empty_bins(sizes):
    """K4's table bounds every bin's grid by m; K5's, given the bin sizes
    read with nnz, by the bin's rows, with the empty bins SKIP, and the
    four register bins (one launch) SKIP only when all four are empty."""
    a, b = wide()
    plan = spgemm.spgemm_plan(t(a.indptr), t(a.indices), t(b.indptr),
                              WIDE_N, torch.float64, torch.int32)
    assert len(plan.bins) == 10
    table = spgemm._launch_table(plan, 6, sizes)
    npt.assert_array_equal(table[:, 1], plan.bins[:, 1])
    if sizes is None:
        npt.assert_array_equal(table[:, 0], plan.bins[:, 0])
        assert (table[:, 2] == 6).all()
        return
    npt.assert_array_equal(table[:, 2], sizes)
    tiny = slice(1, 1 + len(spgemm.TINY_KINDS))
    tiny_rows = any(sizes[tiny])
    for kind, was, size in zip(table[:, 0], plan.bins[:, 0], sizes):
        if was in spgemm.TINY_KINDS.values():
            assert kind == (was if tiny_rows else spgemm.SKIP)
        else:
            assert kind == (was if size else spgemm.SKIP)


@pytest.mark.parametrize("mean_row", [0, 0.5, 1, 2, 2.7, 8, 60, 400, 5000])
def test_plan_tiles_hold_about_2048_entries(mean_row):
    """The plan built on the card takes lanes a row (a power of two from 1
    to 32, at or above the mean row) and tiles of whole rounds of the 256
    / lanes groups of a block, about 2048 op(A) entries a tile."""
    lanes, tile_rows = spgemm._plan_tiles(mean_row)
    assert lanes in (1, 2, 4, 8, 16, 32)
    assert lanes >= min(32, mean_row) and (lanes == 1 or lanes / 2 < mean_row)
    groups = 256 // lanes
    assert tile_rows % groups == 0 and 1 <= tile_rows // groups <= 32
    if groups * max(mean_row, 1) <= 2048:
        assert tile_rows * max(mean_row, 1) <= 2048


NO_KEY = (1 << 64) - 1


def register_row(a, b, i, g, triangular):
    """K4/K5's register path (csrc/csr_spgemm.cu, tiny_bin) for row i of
    a @ b, lane by lane as a group of g lanes runs it: the chunked scan of
    op(B) row lengths, the binary search for each lane's product, the
    bitonic network on (column << 5 | product) keys, the heads and each
    head's fold in product order.  Returns (count, columns, values)."""
    p0, p1 = a.indptr[i], a.indptr[i + 1]
    q, av, carry = [-1] * g, [0] * g, 0
    for c in range(p0, p1, g):
        p = [c + lane for lane in range(g)]
        start = [b.indptr[a.indices[x]] if x < p1 else 0 for x in p]
        length = [b.indptr[a.indices[x] + 1] - b.indptr[a.indices[x]]
                  if x < p1 else 0 for x in p]
        vals = [a.data[x] if x < p1 else 0 for x in p]
        incl = np.cumsum(length)
        excl = incl - length
        total = int(incl[-1])
        for lane in range(g):
            t_ = lane - carry
            s, step = 0, g // 2
            while step:
                if excl[s + step] <= t_:
                    s += step
                step //= 2
            if 0 <= t_ < total:
                q[lane] = start[s] + t_ - excl[s]
                av[lane] = vals[s]
        carry += total
    keys, bv = [], []
    for lane in range(g):
        j = b.indices[q[lane]] if q[lane] >= 0 else -1
        live = q[lane] >= 0 and (not triangular or j >= i)
        keys.append((int(j) << 5 | lane) if live else NO_KEY)
        bv.append(b.data[q[lane]] if q[lane] >= 0 else 0)
    size = 2
    while size <= g:
        stride = size // 2
        while stride:
            other = [keys[lane ^ stride] for lane in range(g)]
            keys = [min(k, o) if ((lane & stride) == 0) == ((lane & size) == 0)
                    else max(k, o)
                    for lane, (k, o) in enumerate(zip(keys, other))]
            stride //= 2
        size *= 2
    assert keys == sorted(keys)
    heads = [keys[lane] != NO_KEY and (lane == 0 or keys[lane - 1] >> 5
                                       != keys[lane] >> 5)
             for lane in range(g)]
    cols, sums = [], []
    for lane in range(g):
        if heads[lane]:
            run = [keys[lane]]
            while (lane + len(run) < g and keys[lane + len(run)] != NO_KEY
                   and keys[lane + len(run)] >> 5 == keys[lane] >> 5):
                run.append(keys[lane + len(run)])
            acc = 0
            for key in run:  # product order: op(A)'s stored order
                acc = acc + av[key & 31] * bv[key & 31]
            cols.append(keys[lane] >> 5)
            sums.append(acc)
    return sum(heads), cols, sums


@pytest.mark.parametrize("triangular", [False, True])
@pytest.mark.parametrize("case", ["few_products_20k", "cancellation",
                                  "sparse_explicit_zeros", "sparse_c128",
                                  "narrow_runs", "long_rows_over_empty"])
def test_register_path_matches_plain(case, triangular):
    """Every row that the plan sends to a register bin, run as its group
    runs it, gives the plain ESC's count, columns and values."""
    a, b = CASES[case]() if case in CASES else EMULATED[case]()
    a, b = a.tocsr(), b.tocsr()
    args = csr_args(a, b)
    indptr, indices, data = spgemm.spgemm_plain(*args, triangular=triangular)
    kind, ub = routed(a, b, b.shape[1])
    width = {v: g for g, v in spgemm.TINY_KINDS.items()}
    seen = set()
    for i in range(min(a.shape[0], 4000)):
        if kind[i] not in width:
            continue
        g = width[kind[i]]
        seen.add(g)
        count, cols, sums = register_row(a, b, i, g, triangular)
        lo, hi = int(indptr[i]), int(indptr[i + 1])
        assert count == hi - lo
        assert cols == indices[lo:hi].tolist()
        assert_values(np.array(sums, dtype=a.dtype), data[lo:hi].numpy())
    assert seen


def narrow_runs():
    """n = 1 and 16: runs of one column as long as 32 lanes, and rows with
    more products than n; values in {-1, 0, 1}, so sums cancel exactly."""
    rng = np.random.default_rng(29)
    a = rows_of([1, 2, 3, 5, 8, 13, 17, 30, 32, 0] * 3, 40, seed=30)
    a.data = rng.choice([-1.0, 0.0, 1.0], a.nnz)
    b = sps.csr_matrix((rng.choice([-1.0, 1.0], 40), np.zeros(40, int),
                        np.arange(41)), shape=(40, 1))
    return a, b


def long_rows_over_empty():
    """op(A) rows of 40-120 entries (more than any group) over op(B) rows
    that are mostly empty: few products, found chunk by chunk."""
    a = rows_of([120, 40, 64, 3, 97, 33], 3000, seed=31)
    b = rows_of(([0] * 29 + [1, 2]) * 96 + [0] * 24, 500, seed=32)
    return a, b


EMULATED = {
    "narrow_runs": narrow_runs,
    "long_rows_over_empty": long_rows_over_empty,
    "sparse_explicit_zeros": lambda: (
        with_explicit_zeros(random_sparse((30, 40), 0.05, seed=33)),
        with_explicit_zeros(random_sparse((40, 50), 0.1, seed=34))),
    "sparse_c128": lambda: (
        random_sparse((30, 40), 0.05, np.complex128, seed=35),
        random_sparse((40, 50), 0.1, np.complex128, seed=36)),
}


PRODUCT_BITS = 9


def sorted_row(a, b, i, u, triangular):
    """K4/K5's sorted-product path (csrc/csr_spgemm.cuh, spgemm_sorted_kernel
    and sorted_finish) for row i of a @ b in a bin of u products, as one
    warp runs it: op(A)'s entries 32 at a time, their op(B) row lengths
    scanned, and in each round t of 32 products (product 32 t + lane on
    lane ``lane``) the lane's entry found by a binary search of the scan,
    the count carried across chunks; keys (column << 9) | product index,
    each product's (op(A) entry, op(B) entry) staged; the bitonic network
    over the 32 R keys (R = u / 64 or u / 32 registers a lane, by the
    row's products), lane strides by exchange between lanes, wider ones
    between a lane's registers; the heads; each head's fold of its run in
    product order through the staged entries, up to the next head or the
    first empty position.  Returns (count, columns, values, the longest
    run)."""
    rm = u // 32
    no_key = (1 << 64) - 1
    p0, p1 = a.indptr[i], a.indptr[i + 1]
    col = [[-1] * 32 for _ in range(rm)]
    staged = {}
    carry = 0
    for c in range(p0, p1, 32):
        p = [c + lane for lane in range(32)]
        start = [b.indptr[a.indices[x]] if x < p1 else 0 for x in p]
        length = [b.indptr[a.indices[x] + 1] - b.indptr[a.indices[x]]
                  if x < p1 else 0 for x in p]
        excl = np.cumsum(length) - length
        total = int(np.sum(length))
        for t in range(rm):
            if not (carry < 32 * (t + 1) and carry + total > 32 * t):
                continue
            for lane in range(32):
                v = 32 * t + lane - carry
                s, step = 0, 16
                while step:
                    if excl[s + step] <= v:
                        s += step
                    step //= 2
                if 0 <= v < total:
                    q = start[s] + v - excl[s]
                    col[t][lane] = int(b.indices[q])
                    staged[32 * t + lane] = (c + s, q)
        carry += total
    assert carry <= u
    r_rows = rm // 2 if carry <= 16 * rm else rm
    # key[e] at position e = 32 r + lane
    key = [no_key] * (32 * r_rows)
    for t in range(r_rows):
        for lane in range(32):
            j = col[t][lane]
            if j >= 0 and (not triangular or j >= i):
                key[32 * t + lane] = j << PRODUCT_BITS | (32 * t + lane)
    size = 2
    while size <= 32 * r_rows:
        stride = size // 2
        while stride:
            new = list(key)
            for e in range(32 * r_rows):
                if stride >= 32 and (e >> 5) & (stride >> 5):
                    continue  # the upper register of a pair moves with it
                partner = e ^ stride
                lo, hi = min(key[e], key[partner]), max(key[e], key[partner])
                if stride >= 32:
                    up = (e & size) == 0
                    new[e], new[partner] = (lo, hi) if up else (hi, lo)
                else:
                    keep_min = ((e & stride) == 0) == ((e & size) == 0)
                    new[e] = lo if keep_min else hi
            key = new
            stride //= 2
        size *= 2
    assert key == sorted(key)
    head = [k != no_key and (e == 0 or key[e - 1] >> PRODUCT_BITS
                             != k >> PRODUCT_BITS)
            for e, k in enumerate(key)]
    order = [0xFFFF if k == no_key else (k & 511) | (0x8000 if h else 0)
             for k, h in zip(key, head)]
    cols, sums, longest = [], [], 0
    for e, k in enumerate(key):
        if not head[e]:
            continue
        pid, acc, run = k & 511, 0, 0
        while True:
            pa, q = staged[pid]
            acc = acc + a.data[pa] * b.data[q]
            run += 1
            e += 1
            if e >= len(key) or order[e] & 0x8000:
                break
            pid = order[e]
        cols.append(k >> PRODUCT_BITS)
        sums.append(acc)
        longest = max(longest, run)
    return sum(head), cols, sums, longest


SORTED_WIDTH = 10_000  # past 8 x 1024: both sorted-product bins
# (op(A) row lengths, op(B) row lengths in turn, the lowest column of
# op(B)): rows of exactly 33, 128, 129 and 512 products (512 op(A)
# entries walked in 16 chunks), then over op(B) rows that share 16
# columns, so that a column's run is longer than a register of 32 keys.
SORTED_CASES = (((33, 128, 129, 512), (1,), 0), ((11, 43), (3,), 0),
                ((32, 128), (4,), 0),
                ((10, 40, 100, 120), (4, 3, 5), SORTED_WIDTH - 16))


def sorted_case(case):
    """op(A) (8 rows, k = 600) and op(B) of SORTED_CASES[case], values
    in {-1, 0, 1, 2}: sums exact, some cancelled to a stored 0."""
    a_rows, b_rows, low = SORTED_CASES[case]
    rng = np.random.default_rng(37 + case)
    k = 600
    a = rows_of([a_rows[i % len(a_rows)] for i in range(8)], k,
                seed=38 + case)
    b = rows_of([b_rows[i % len(b_rows)] for i in range(k)],
                SORTED_WIDTH - low, seed=48 + case)
    b = sps.csr_matrix((b.data, b.indices + low, b.indptr),
                       shape=(k, SORTED_WIDTH))
    a.data = rng.choice([-1.0, 0.0, 1.0, 2.0], a.nnz)
    b.data = rng.choice([-1.0, 1.0, 2.0], b.nnz)
    return a, b


@pytest.mark.parametrize("triangular", [False, True])
@pytest.mark.parametrize("case", range(len(SORTED_CASES)))
def test_sorted_path_matches_plain(case, triangular):
    """Every row that the plan sends to a sorted-product bin, run as its
    warp runs it, gives the plain ESC's count, columns and values; the
    rows of exact sizes reach the bins their products name, and the
    shared columns make runs longer than a register of 32 keys."""
    a, b = sorted_case(case)
    args = csr_args(a, b)
    indptr, indices, data = spgemm.spgemm_plain(*args, triangular=triangular)
    kind, ub = routed(a, b, SORTED_WIDTH)
    plan = spgemm.spgemm_plan(args[0], args[1], args[3], SORTED_WIDTH,
                              torch.float64, torch.int32)
    seen, longest = set(), 0
    for b_id, (k, u, _) in enumerate(plan.bins):
        if k != spgemm.SORTED_WARP:
            continue
        for i in plan.rows[plan.offsets[b_id]:plan.offsets[b_id + 1]]:
            i = int(i)
            assert kind[i] == spgemm.SORTED_WARP and u // 4 < ub[i] <= u
            count, cols, sums, run = sorted_row(a, b, i, int(u), triangular)
            lo, hi = int(indptr[i]), int(indptr[i + 1])
            assert count == hi - lo
            assert cols == indices[lo:hi].tolist()
            npt.assert_array_equal(np.array(sums), data[lo:hi].numpy())
            seen.add(int(u))
            longest = max(longest, run)
    a_rows, b_rows, low = SORTED_CASES[case]
    if not low:
        assert sorted(set(ub)) == sorted({r * b_rows[0] for r in a_rows})
        assert seen == {128 if r * b_rows[0] <= 128 else 512
                        for r in a_rows}
    else:
        assert seen == {128, 512} and longest > 32


def test_long_row_goes_to_the_device_workspace():
    """The row whose products exceed the largest shared-memory table, at
    an n too wide for a dense row in shared memory, takes the workspace."""
    a, b = wide()
    plan = spgemm.spgemm_plan(t(a.indptr), t(a.indices), t(b.indptr),
                              WIDE_N, torch.float64, torch.int32)
    last = plan.rows[plan.offsets[-2]:plan.offsets[-1]].tolist()
    assert plan.bins[-1, 0] == spgemm.DENSE_GLOBAL
    assert last == [list(np.diff(a.indptr)).index(LONG_ROW)]
    assert int(plan.ub[last[0]]) == LONG_ROW * 30


# ---------------------------------------------------------------------------
# the wrappers on the CPU, chunking, overflow
# ---------------------------------------------------------------------------


def csr_args(a, b):
    return (t(a.indptr), t(a.indices), t(a.data), t(b.indptr), t(b.indices),
            t(b.data), b.shape[1])


@pytest.mark.parametrize("triangular", [False, True])
def test_wrappers_on_cpu_take_the_plain_versions(triangular):
    a, b = CASES["explicit_zeros"]()
    args = csr_args(a, b)
    indptr, indices, data = spgemm.csr_spgemm(*args, triangular=triangular)
    plan = spgemm.spgemm_plan(args[0], args[1], args[3], args[6],
                              args[2].dtype, args[0].dtype)
    counts = spgemm.csr_spgemm_count(args[0], args[1], args[3], args[4],
                                     args[6], plan, triangular)
    assert torch.equal(counts, indptr.long().diff())
    fill = spgemm.csr_spgemm_fill(*args, plan, indptr, len(indices),
                                  triangular)
    assert torch.equal(fill[0], indices) and torch.equal(fill[1], data)
    dense = spgemm.csr_spgemm_dense(*args, triangular=triangular)
    ref = (a @ b).toarray()
    npt.assert_allclose(dense.numpy(), np.triu(ref) if triangular else ref,
                        rtol=1e-12, atol=1e-12)
    assert (spgemm.csr_spgemm_count.launches, spgemm.csr_spgemm_fill.launches,
            spgemm.csr_spgemm_dense.launches) == (0, 0, 0)


def test_plain_chunks_give_the_same_bits(monkeypatch):
    a, b = CASES["wide_n_long_row"]()
    args = csr_args(a, b)
    whole = spgemm.spgemm_plain(*args)
    whole_dense = spgemm.csr_spgemm_dense_plain(*args)
    monkeypatch.setattr(config, "spmm_chunk_elements", 7)
    chunked = spgemm.spgemm_plain(*args)
    for x, y in zip(whole, chunked):
        assert torch.equal(x, y)
    assert torch.equal(spgemm.csr_spgemm_dense_plain(*args), whole_dense)


def test_output_nnz_overflow_raises_with_ilp64_hint():
    with pytest.raises(ValueError, match="int32 .*SPARSE_DOT_INTERFACE=ILP64"):
        formats._check_index_bounds(2**31, (10, 10), torch.int32)
    with pytest.raises(ValueError, match="ILP64"):
        formats._check_index_bounds(5, (2**31, 10), torch.int32)
    formats._check_index_bounds(2**31, (10, 10), torch.int64)


# ---------------------------------------------------------------------------
# the slice as a whole: dot_product, gram_matrix, sypr
# ---------------------------------------------------------------------------


def assert_same_result(port, ref):
    """Same class, dtype, shape; sparse: same stored arrays."""
    assert type(port) is type(ref)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    if sps.issparse(ref):
        assert port.format == ref.format
        npt.assert_array_equal(port.indptr, ref.indptr)
        npt.assert_array_equal(port.indices, ref.indices)
        assert_values(port.data, ref.data)
    else:
        assert_values(port, ref)


@pytest.mark.parametrize("case", ["csr_f64", "csr_c64", "csc_x_csr",
                                  "bsr_x_bsr", "explicit_zeros",
                                  "cancellation", "nnz_0"])
@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
def test_dot_product_matches_jax(case, dense):
    a, b = CASES[case]()
    assert_same_result(sdtt.dot_product(a, b, dense=dense),
                       sdt.dot_product(a, b, dense=dense))


def test_dot_product_array_classes_and_cast_match_jax():
    a, b = CASES["csr_f64"]()
    assert_same_result(sdtt.dot_product(sps.csr_array(a), b),
                       sdt.dot_product(sps.csr_array(a), b))
    a32 = a.astype(np.float32)
    assert_same_result(sdtt.dot_product(a32, b, cast=True),
                       sdt.dot_product(a32, b, cast=True))
    out_p, out_j = (np.full((30, 50), 7.0) for _ in range(2))
    assert sdtt.dot_product(a, b, dense=True, out=out_p) is out_p
    assert sdt.dot_product(a, b, dense=True, out=out_j) is out_j
    assert_values(out_p, out_j)


def poisson_csr(m, k, mean_row, seed):
    """m x k CSR with Poisson(mean_row) entries a row at random columns,
    repeats summed (the recipe of the 100,000^2 A @ A timed on the
    card)."""
    rng = np.random.default_rng(seed)
    indptr = np.concatenate([[0], np.cumsum(rng.poisson(mean_row, m))])
    a = sps.csr_matrix((rng.standard_normal(indptr[-1]),
                        rng.integers(0, k, indptr[-1]), indptr),
                       shape=(m, k))
    a.sum_duplicates()
    return a


def test_poisson_product_in_the_warp_bins_matches_jax():
    """A Poisson(10) product of about 100 products a row at n = 20,000,
    whose plan puts rows in both sorted-product bins (128 and 512), through
    both packages' ``dot_product``."""
    n = 20_000
    a, b = poisson_csr(2000, n, 10, 40), poisson_csr(n, n, 10, 41)
    plan = spgemm.spgemm_plan(t(a.indptr), t(a.indices), t(b.indptr), n,
                              torch.float64, torch.int32)
    held = {(int(k), int(s)) for (k, s, _), rows in zip(
        plan.bins, plan.offsets.diff().tolist()) if rows}
    assert {(spgemm.SORTED_WARP, u) for u in spgemm.WARP_PRODUCTS} <= held
    assert_same_result(sdtt.dot_product(a, b), sdt.dot_product(a, b))


@pytest.mark.parametrize("transpose", [False, True], ids=["ata", "aat"])
@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
def test_gram_matrix_matches_jax(transpose, dense):
    a = random_sparse((30, 45), 0.12, seed=24)
    assert_same_result(sdtt.gram_matrix(a, transpose=transpose, dense=dense),
                       sdt.gram_matrix(a, transpose=transpose, dense=dense))
    c = (a + 0.5j * a).astype(np.complex128)
    assert_same_result(
        sdtt.gram_matrix(c, transpose=transpose, dense=dense,
                         allow_complex=True),
        sdt.gram_matrix(c, transpose=transpose, dense=dense,
                        allow_complex=True))


@pytest.mark.parametrize("transpose", [False, True], ids=["atba", "abat"])
def test_sypr_matches_jax(transpose):
    a = random_sparse((40, 25), 0.1, seed=25)
    k = a.shape[1] if transpose else a.shape[0]
    b = random_sparse((k, k), 0.1, seed=26)
    b = (b + b.T).tocsr()
    assert_same_result(sdtt.sypr(a, b, transpose=transpose),
                       sdt.sypr(a, b, transpose=transpose))
    assert_same_result(sdtt.sypr(a.tobsr(blocksize=(5, 5)), b,
                                 transpose=transpose, dense=True),
                       sdt.sypr(a.tobsr(blocksize=(5, 5)), b,
                                transpose=transpose, dense=True))
