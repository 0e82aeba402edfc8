"""K6 (sparse x sparse with dense output) on the CPU: its launch plan, the
sorted-rows flag it is given, and the dense-output slice with unsorted
operands against the JAX package.

The kernel itself runs only on the card (``chip_smoke.py`` phase 2 holds
it against its plain version at every plan); here the wrappers take the
plain version, and what decides the launch is host code:
``ops.spgemm.dense_plan`` (how the work is split among warps),
``formats.*.csr_sorted`` (whether op(B)'s rows may be searched) and
``formats.*.sorted_csr_arrays`` (op(B) sorted once where they may not).  The
JAX package runs on JAX's CPU backend; results agree at decimal=6 (f64)
and decimal=5 (f32), the reference's tolerances.
"""

import numpy as np
import numpy.testing as npt
import pytest
import scipy.sparse as sps
import torch

import sparse_dot_tpu as sdt
import sparse_dot_tpu_torch as sdtt
from sparse_dot_tpu_torch import formats, interface
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


def shuffled(mat, seed=0):
    """A new CSR/CSC of ``mat``'s matrix with each compressed row's
    entries in random order (scipy then reports ``has_sorted_indices``
    False for it)."""
    rng = np.random.default_rng(seed)
    indices, data = mat.indices.copy(), mat.data.copy()
    for r in range(len(mat.indptr) - 1):
        lo, hi = mat.indptr[r], mat.indptr[r + 1]
        perm = lo + rng.permutation(hi - lo)
        indices[lo:hi], data[lo:hi] = indices[perm], data[perm]
    return type(mat)((data, indices, mat.indptr.copy()), shape=mat.shape)


def raw(mat):
    """The port's container of scipy CSR/CSC ``mat``, built from its
    arrays as they are (order unknown to the container)."""
    cls = formats.CSR if mat.format == "csr" else formats.CSC
    return cls(*(torch.from_numpy(np.array(arr)) for arr in
                 (mat.data, mat.indices, mat.indptr)), mat.shape)


def random_csr(shape, density, dtype=np.float64, seed=0):
    a = sps.random(*shape, density=density, format="csr",
                   random_state=np.random.default_rng(seed))
    a = a.astype(dtype)
    a.data -= 0.5
    return a


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case, args, want", [
    # the demo X @ X.T: 500 rows of ~1060 entries, n = 500, f64: a row
    # fits a warp's share of shared memory, and 500 rows alone would
    # leave the card short of warps, so each row is split 8 ways
    ("a", (500, 500, 8, 530_000), spgemm.DensePlan(8, 500, 1)),
    # config 3's BSR x BSR: 8192 rows of ~410, n = 8192, f64: rows too
    # wide, cut into 10 windows of 832 columns; 81920 items fill the card
    ("d", (8192, 8192, 8, 8192 * 410), spgemm.DensePlan(1, 832, 10)),
    # the tests' WIDE_N: 6 rows of 58 on average over 40,000 columns:
    # windows of 896, too short to split
    ("wide", (6, 40_000, 8, 348), spgemm.DensePlan(1, 896, 45)),
    # complex128 at n = 500: two windows of 256
    ("a_c128", (500, 500, 16, 530_000), spgemm.DensePlan(8, 256, 2)),
    # many short rows: one warp a row
    ("short", (6000, 48, 8, 15_000), spgemm.DensePlan(1, 48, 1)),
])
def test_dense_plan_of_the_main_shapes(case, args, want):
    assert spgemm.dense_plan(*args, sms=132) == want


@pytest.mark.parametrize("m", [1, 3, 40, 500, 20_000])
@pytest.mark.parametrize("n", [1, 31, 500, 896, 897, 8192, 100_000])
@pytest.mark.parametrize("itemsize", [4, 8, 16])
def test_dense_plan_covers_the_row_within_shared_memory(m, n, itemsize):
    for mean_row in (0, 3, 200, 2000):
        plan = spgemm.dense_plan(m, n, itemsize, m * mean_row, sms=132)
        assert plan.splits in (1, 2, 4, 8)
        assert plan.windows == -(-n // plan.width)
        if plan.windows > 1:
            assert plan.width % 32 == 0
            assert plan.width * itemsize <= spgemm.DENSE_ROW_BYTES
        else:
            assert plan.width == n
        # a split chunk keeps DENSE_MIN_CHUNK entries on average
        assert (plan.splits == 1
                or mean_row >= spgemm.DENSE_MIN_CHUNK * plan.splits)
        # rows are split only while the card is short of warps
        assert (plan.splits == 1 or m * plan.windows * plan.splits // 2
                < spgemm.DENSE_WARPS_PER_SM * 132)


@pytest.mark.parametrize("m, n, k, a_nnz, want", [
    (8192, 8192, 8192, 8192 * 410, True),   # case d: 8192 x 11 starts
    (500, 500, 5000, 530_000, False),       # case a: one window, no table
    (42, 100_000, 2000, 4830, True),        # phase 2's n = 100,000
    (48, 100_000, 3000, 2918, False),       # fewer entries of op(A) than k
    (1, 100_000, 1_000_000, 2_000_000, False),  # table larger than C
])
def test_window_starts_table_only_where_it_pays(m, n, k, a_nnz, want):
    plan = spgemm.dense_plan(m, n, 8, a_nnz, sms=132)
    assert spgemm.window_starts_pay(plan, m, n, k, a_nnz, 8, 4) is want


# ---------------------------------------------------------------------------
# the sorted-rows flag
# ---------------------------------------------------------------------------


def test_rows_ascend_matches_scipy():
    for seed in range(20):
        a = random_csr((30, 25), 0.2, seed=seed)
        if seed % 2:
            a = shuffled(a, seed)
        indptr = a.indptr.copy()
        indptr[5:8] = indptr[5]  # empty rows between entries
        fresh = sps.csr_matrix((a.data, a.indices, indptr), shape=a.shape)
        got = formats.rows_ascend(torch.from_numpy(fresh.indptr),
                                  torch.from_numpy(fresh.indices))
        assert got == fresh.has_sorted_indices
    tie = torch.tensor([0, 3]), torch.tensor([1, 1, 2])
    assert formats.rows_ascend(*tie)  # ties ascend, as scipy's
    assert formats.rows_ascend(torch.tensor([0, 0]), torch.tensor([]))


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_csr_sorted_matches_scipy(fmt):
    """The flag of the arrays a product reads (``csr_arrays(transpose)``)
    against scipy's ``has_sorted_indices`` of the same arrays, for a
    container from scipy, its transposed view and a row-shuffled copy
    built from its arrays."""
    a = random_csr((40, 30), 0.2, seed=5).asformat(fmt)
    own = fmt == "csc"  # the transpose whose CSR is the container's own
    mats = {"from_scipy": formats.to_device(a),
            "shuffled": raw(shuffled(a, 6)),
            "sorted_raw": raw(a)}
    for name, mat in mats.items():
        for transpose in (False, True):
            ip, ix, dv = mat.csr_arrays(transpose)
            shape = mat.shape[::-1] if transpose else mat.shape
            ref = sps.csr_matrix((dv.numpy(), ix.numpy(), ip.numpy()),
                                 shape=shape)
            assert mat.csr_sorted(transpose) == ref.has_sorted_indices, (
                name, transpose)
            view = mat.T  # the same buffers in the other format
            assert (view.csr_sorted(not transpose)
                    == mat.csr_sorted(transpose))
        assert mat.csr_sorted(not own)  # a converted layout is sorted
    assert mats["from_scipy"].sorted_indices is True
    assert mats["shuffled"].csr_sorted(own) is False


def test_csr_sorted_of_bsr_follows_its_block_order():
    blocks = np.arange(24.0).reshape(6, 2, 2)
    ordered = sps.bsr_matrix((blocks, np.array([0, 2, 1, 0, 1, 2]),
                              np.array([0, 2, 3, 6])), shape=(6, 6))
    unordered = sps.bsr_matrix((blocks, np.array([2, 0, 1, 2, 0, 1]),
                                np.array([0, 2, 3, 6])), shape=(6, 6))
    for mat in (ordered, unordered):
        port = formats.to_device(mat)
        for transpose in (False, True):
            ip, ix, dv = port.csr_arrays(transpose)
            ref = sps.csr_matrix((dv.numpy(), ix.numpy(), ip.numpy()))
            assert port.csr_sorted(transpose) == ref.has_sorted_indices
    assert not formats.to_device(unordered).csr_sorted()


def test_sorted_flag_follows_the_container():
    a = random_csr((20, 20), 0.3, seed=7)
    port = formats.to_device(a)
    assert port.to("cpu").sorted_indices is True
    assert port.astype(np.float32).sorted_indices is True
    bad = raw(shuffled(a, 8))
    assert bad.sorted_indices is None and not bad.csr_sorted()
    handle = interface.sparse_handle_t(raw(shuffled(a, 9)))
    ordered = interface.order_sparse_handle(handle).container
    assert ordered.sorted_indices is True
    ip, ix, _ = ordered.csr_arrays()
    assert formats.rows_ascend(ip, ix)
    product = host.spgemm_device(port, port)
    assert product.sorted_indices is True


# ---------------------------------------------------------------------------
# the wrapper and the slice with unsorted operands
# ---------------------------------------------------------------------------


def test_wrapper_on_cpu_takes_the_plain_version_whatever_it_is_told():
    a = random_csr((12, 30), 0.3, seed=10)
    b = shuffled(random_csr((30, 40), 0.3, seed=11), 12)
    args = [torch.from_numpy(np.array(v)) for v in
            (a.indptr, a.indices, a.data, b.indptr, b.indices, b.data)]
    ref = spgemm.csr_spgemm_dense_plain(*args, 40, triangular=True)
    for b_sorted in (False, True):
        got = spgemm.csr_spgemm_dense(*args, 40, triangular=True,
                                      b_sorted=b_sorted)
        assert torch.equal(got, ref)
    npt.assert_allclose(ref.numpy(), np.triu((a @ b).toarray()),
                        rtol=1e-12, atol=1e-12)
    assert spgemm.csr_spgemm_dense.launches == 0


def test_host_passes_the_flag_of_op_b(monkeypatch):
    """The public path hands K6 op(B)'s rows sorted (sorted once and
    cached where the container's own are not) and says so."""
    seen = []
    real = spgemm.csr_spgemm_dense

    def spy(*args, **kwargs):
        seen.append((kwargs["b_sorted"], formats.rows_ascend(args[3],
                                                             args[4])))
        return real(*args, **kwargs)

    monkeypatch.setattr(spgemm, "csr_spgemm_dense", spy)
    a = random_csr((10, 15), 0.3, seed=13)
    b = random_csr((15, 9), 0.3, seed=14)
    host.spgemm_dense(formats.to_device(a), formats.to_device(b),
                      np.float64)
    unsorted_b = raw(shuffled(b, 15))
    for _ in range(2):
        host.spgemm_dense(formats.to_device(a), unsorted_b, np.float64)
    host.gram_dense_from_sparse(raw(shuffled(a, 16)), np.float64, aat=True)
    host.gram_dense_from_sparse(raw(shuffled(a, 16)), np.float64)
    assert seen == [(True, True)] * 5
    # the unsorted op(B) was sorted once, on its first call: its sorted
    # structure is cached (the values are gathered on every call)
    first, again = unsorted_b.sorted_csr_arrays(), \
        unsorted_b.sorted_csr_arrays()
    assert first[0] is again[0] and first[1] is again[1]
    assert torch.equal(first[2], again[2])
    assert not unsorted_b.csr_sorted()


@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize("transpose", [False, True])
def test_sorted_csr_arrays_match_scipy(fmt, transpose):
    """``sorted_csr_arrays`` against scipy's ``sorted_indices()`` of the
    same op(A): a container's own arrays as they are where sorted (a
    converted layout's cached structure, with its values gathered anew
    from ``data``), else a sorted copy whose structure is cached and
    whose values are gathered anew, so they follow ``data``."""
    a = random_csr((40, 30), 0.2, seed=40).asformat(fmt)
    for mat in (formats.to_device(a), raw(a), raw(shuffled(a, 41))):
        ip, ix, dv = mat.csr_arrays(transpose)
        shape = mat.shape[::-1] if transpose else mat.shape
        ref = sps.csr_matrix((dv.numpy(), ix.numpy(), ip.numpy()),
                             shape=shape).sorted_indices()
        got = mat.sorted_csr_arrays(transpose)
        for arr, want in zip(got, (ref.indptr, ref.indices, ref.data)):
            npt.assert_array_equal(arr.numpy(), want)
        if mat.csr_sorted(transpose):
            assert got[0] is ip and got[1] is ix
            own = (mat.format == "csc") == bool(transpose)
            assert got[2] is dv if own else torch.equal(got[2], dv)
        else:
            again = mat.sorted_csr_arrays(transpose)
            assert again[0] is got[0] and again[1] is got[1]
            mat.data.mul_(2.0)
            npt.assert_array_equal(
                mat.sorted_csr_arrays(transpose)[2].numpy(), 2.0 * ref.data)


UNSORTED = {
    "csr_f64": lambda: (shuffled(random_csr((30, 40), 0.15, seed=20), 1),
                        shuffled(random_csr((40, 50), 0.15, seed=21), 2)),
    "csr_f32": lambda: (shuffled(random_csr((30, 40), 0.15, np.float32,
                                            22), 3),
                        shuffled(random_csr((40, 50), 0.15, np.float32,
                                            23), 4)),
    "csc_x_csr": lambda: (shuffled(random_csr((30, 40), 0.15, seed=24)
                                   .tocsc(), 5),
                          shuffled(random_csr((40, 50), 0.15, seed=25), 6)),
}


def assert_same_dense(port, ref, dtype):
    assert type(port) is type(ref)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    decimal = 5 if np.dtype(dtype) == np.float32 else 6
    npt.assert_array_almost_equal(port, ref, decimal=decimal)


@pytest.mark.parametrize("case", sorted(UNSORTED))
@pytest.mark.parametrize("with_out", [False, True], ids=["new", "out"])
def test_dot_product_dense_unsorted_matches_jax(case, with_out):
    a, b = UNSORTED[case]()
    assert not (a.has_sorted_indices or b.has_sorted_indices)
    dtype = np.result_type(a.dtype, b.dtype)
    if not with_out:
        assert_same_dense(sdtt.dot_product(a, b, dense=True),
                          sdt.dot_product(a, b, dense=True), dtype)
        return
    rng = np.random.default_rng(30)
    out_p = rng.standard_normal((a.shape[0], b.shape[1])).astype(dtype)
    out_j = out_p.copy()
    res_p = sdtt.dot_product(a, b, dense=True, out=out_p, out_scalar=-0.5)
    res_j = sdt.dot_product(a, b, dense=True, out=out_j, out_scalar=-0.5)
    assert res_p is out_p and res_j is out_j
    assert_same_dense(out_p, out_j, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("transpose", [False, True], ids=["ata", "aat"])
def test_gram_matrix_dense_unsorted_matches_jax(dtype, transpose):
    a = shuffled(random_csr((30, 45), 0.12, dtype, seed=31), 7)
    assert not a.has_sorted_indices
    assert_same_dense(sdtt.gram_matrix(a, transpose=transpose, dense=True),
                      sdt.gram_matrix(a, transpose=transpose, dense=True),
                      dtype)
    side = 30 if transpose else 45
    out_p = np.random.default_rng(32).standard_normal(
        (side, side)).astype(dtype)
    out_j = out_p.copy()
    res_p = sdtt.gram_matrix(a, transpose=transpose, dense=True, out=out_p,
                             out_scalar=2.0)
    res_j = sdt.gram_matrix(a, transpose=transpose, dense=True, out=out_j,
                            out_scalar=2.0)
    assert res_p is out_p and res_j is out_j
    assert_same_dense(out_p, out_j, dtype)


def test_port_container_with_unsorted_rows_matches_jax():
    """A port container built from unsorted arrays (its order found out
    on the device) gives what the JAX package gives for the same
    matrix."""
    a = random_csr((25, 35), 0.2, seed=33)
    b = shuffled(random_csr((35, 20), 0.2, seed=34), 8)
    assert_same_dense(
        sdtt.dot_product(formats.to_device(a), raw(b), dense=True),
        sdt.dot_product(a, b, dense=True), np.float64)
    g = shuffled(a, 9)
    assert_same_dense(sdtt.gram_matrix(raw(g), dense=True),
                      sdt.gram_matrix(g, dense=True), np.float64)


@pytest.mark.parametrize("fmt", ["csr", "csc", "bsr"])
@pytest.mark.parametrize("transpose", [False, True])
def test_containers_sum_repeats_before_k6_takes_them_sorted(fmt, transpose):
    """The public path hands K6 ``sorted_csr_arrays`` with
    ``b_sorted=True``, the warrant of ascending columns without repeats:
    every container sums repeated entries (blocks, for a BSR) when it is
    built from scipy, so those arrays pass the check that raw op(B) gets
    (``formats.sorted_unique_columns``) and agree with scipy's sum."""
    rng = np.random.default_rng(80)
    n = 12
    if fmt == "bsr":  # 6 x 6 blocks of 2; block row 0 holds column 4 twice
        indptr = np.array([0, 3, 4, 6, 6, 8, 9])
        indices = np.array([4, 1, 4, 0, 5, 2, 3, 1, 0])
        mat = sps.bsr_matrix((rng.standard_normal((9, 2, 2)), indices,
                              indptr), shape=(n, n))
    else:  # row (column) 3 holds 7 three times, among random repeats
        lengths = rng.poisson(4, n)
        lengths[3] = 5
        indptr = np.concatenate([[0], np.cumsum(lengths)])
        indices = rng.integers(0, n, indptr[-1])
        indices[indptr[3]:indptr[3] + 3] = 7
        cls = sps.csr_matrix if fmt == "csr" else sps.csc_matrix
        mat = cls((rng.standard_normal(indptr[-1]), indices, indptr),
                  shape=(n, n))
    assert not mat.has_canonical_format
    ip, ix, dv = formats.to_device(mat).sorted_csr_arrays(transpose)
    cols_, vals = formats.sorted_unique_columns(ip, ix, dv, n)
    assert torch.equal(cols_, ix) and torch.equal(vals, dv)
    want = (mat.T if transpose else mat).tocsr()
    want.sum_duplicates()
    got = sps.csr_matrix((dv.numpy(), ix.numpy(), ip.numpy()), shape=(n, n))
    npt.assert_allclose(got.toarray(), want.toarray(), rtol=1e-12,
                        atol=1e-12)
