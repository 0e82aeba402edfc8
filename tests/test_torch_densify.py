"""The densify route on the CPU: K12's plain version, the gates and the
dense products built on them, against the JAX package.

K12 (``ops/densify.csr_densify``, ``csrc/csr_densify.cu``) runs only on the
card, where ``chip_smoke.py`` phase 2 holds it against its plain version;
here the wrapper takes the plain version, which is held against
``_xla.densify`` and ``_xla.densify_sorted``.  What decides the route is
host code: ``ops.host._prefer_densify`` (SpMM; on the CPU the JAX
package's rule, so both packages take the same route on the same input)
and ``_prefer_densify_product`` (dense-output sparse x sparse), the finite
check, and ``host.transpose_pair`` (X @ X.T densifies once).  Inputs are
made with numpy from a seed; results agree with the JAX package at
decimal=6 (f64) and decimal=5 (f32), the reference's tolerances.  Where B
holds inf or nan the port is held against scipy, which the JAX package
does not match on its densify route (ROADMAP, weak points).
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
from sparse_dot_tpu_torch import formats
from sparse_dot_tpu_torch.config import config
from sparse_dot_tpu_torch.ops import csr, densify, host, spgemm


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless asked otherwise; these tests ask
    for the CPU, where its wrappers take their plain versions."""
    saved = config.device
    config.device = "cpu"
    yield
    config.device = saved


VALUE_TYPES = [np.float32, np.float64, np.complex64, np.complex128]
INDEX_TYPES = [np.int32, np.int64]
RTOL = {np.float32: 1e-5, np.complex64: 1e-5, np.float64: 1e-12,
        np.complex128: 1e-12}
DECIMAL = {np.float32: 5, np.float64: 6}


def values(rng, size, dtype):
    v = rng.standard_normal(size)
    if np.dtype(dtype).kind == "c":
        v = v + 1j * rng.standard_normal(size)
    return v.astype(dtype)


def raw_csr(rng, m, k, dtype, itype, mean_row=4.0):
    """CSR arrays with empty rows (every third), repeated and unsorted
    columns, and explicit zeros (a tenth of the values)."""
    lengths = rng.poisson(mean_row, m)
    lengths[::3] = 0
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(itype)
    nnz = int(indptr[-1])
    indices = rng.integers(0, k, nnz).astype(itype)
    data = values(rng, nnz, dtype)
    data[rng.random(nnz) < 0.1] = 0
    return indptr, indices, data


def port(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# ---------------------------------------------------------------------------
# K12's plain version against the JAX package's densify
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("itype", INDEX_TYPES)
@pytest.mark.parametrize("dtype", VALUE_TYPES)
def test_plain_densify_matches_jax_densify(dtype, itype):
    rng = np.random.default_rng(1)
    m, k = 41, 23
    indptr, indices, data = raw_csr(rng, m, k, dtype, itype)
    assert len(np.unique(indices)) < len(indices)  # repeats are there
    got = densify.csr_densify(*port(indptr, indices, data), (m, k))
    rows = np.repeat(np.arange(m), np.diff(indptr))
    want = np.asarray(_xla.densify(jnp.asarray(rows), jnp.asarray(indices),
                                   jnp.asarray(data), shape=(m, k)))
    assert got.dtype == torch.from_numpy(data).dtype
    npt.assert_allclose(got.numpy(), want, rtol=RTOL[dtype],
                        atol=RTOL[dtype] * np.abs(want).max())
    assert densify.csr_densify.launches == 0


@pytest.mark.parametrize("itype", INDEX_TYPES)
@pytest.mark.parametrize("dtype", VALUE_TYPES)
def test_plain_densify_matches_jax_densify_sorted(dtype, itype):
    """Sorted, unique flat ids (a canonical CSR, explicit zeros kept)
    through ``_xla.densify_sorted`` (f64 by its hi|lo f32 limbs, exact to
    ~2^-49 of each value)."""
    rng = np.random.default_rng(2)
    m, k = 37, 29
    indptr, indices, data = raw_csr(rng, m, k, dtype, itype)
    rows = np.repeat(np.arange(m), np.diff(indptr))
    flat, inverse = np.unique(rows * k + indices, return_inverse=True)
    summed = np.zeros(len(flat), dtype)
    np.add.at(summed, inverse, data)
    c_rows, c_cols = flat // k, flat % k
    c_indptr = np.searchsorted(c_rows, np.arange(m + 1)).astype(itype)
    got = densify.csr_densify(
        *port(c_indptr, c_cols.astype(itype), summed), (m, k))
    want = np.asarray(_xla.densify_sorted(jnp.asarray(flat),
                                          jnp.asarray(summed), shape=(m, k)))
    npt.assert_allclose(got.numpy(), want, rtol=1e-13 if RTOL[dtype] < 1e-6
                        else 1e-6, atol=0)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("fmt", ["csr", "csc", "bsr"])
def test_container_dense_of_op_a(fmt, transpose):
    """``dense(transpose)`` is op(A); a CSC is densified from its stored
    arrays and read as ``.mT`` (column-major), and its transposed CSR
    layout is never built."""
    rng = np.random.default_rng(3)
    mat = sps.random(30, 20, density=0.3, format="csr", random_state=rng)
    mat = mat.asformat(fmt) if fmt != "bsr" else mat.tobsr((10, 10))
    A = formats.to_device(mat)
    got = A.dense(transpose, torch.float32)
    want = (mat.T if transpose else mat).toarray().astype(np.float32)
    npt.assert_array_equal(got.numpy(), want)
    if fmt == "csc":
        assert got.is_contiguous() == transpose
        assert "csr" not in A.__dict__.get("_layout_cache", {})
    npt.assert_array_equal(A.to_dense().numpy(), mat.toarray())


def test_densify_plan_tiles_and_wide_rows():
    assert densify.densify_plan(100, densify.TILE_BYTES // 8 + 1, 8) == 0
    assert densify.densify_plan(100, densify.TILE_BYTES // 8, 8) == 1
    for m, k, size in ((10, 1, 8), (10_000, 16, 8), (500, 5000, 8),
                       (1, 3, 4), (1_000_000, 4, 16)):
        rows = densify.densify_plan(m, k, size)
        assert 1 <= rows and rows * k * size <= densify.PAIR_BYTES
        # Tiles of several rows only while the card keeps 4 tiles an SM.
        assert rows == 1 or -(-m // rows) >= 4 * 132 - 1 or \
            rows == densify.PAIR_BYTES // (k * size)
    # A row past PAIR_BYTES is a tile of its own.
    assert densify.densify_plan(10_000, 10_000, 16) == 1


def test_wrapper_refuses_tracked_values_and_wrong_shapes():
    indptr, indices, data = port(np.array([0, 1, 2]), np.array([0, 1]),
                                 np.array([1.0, 2.0]))
    with pytest.raises(ValueError, match="requires grad"):
        densify.csr_densify(indptr, indices, data.requires_grad_(), (2, 2))
    with pytest.raises(ValueError, match="do not fit"):
        densify.csr_densify(indptr, indices, data.detach(), (3, 2))


# ---------------------------------------------------------------------------
# The gates
# ---------------------------------------------------------------------------

GATE_GRID = [(m, k, n, frac) for m, k in ((1, 1), (7, 300), (300, 7),
                                          (200, 200))
             for n in (1, 64) for frac in (0.0, 0.25, 0.26, 1.0)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128])
@pytest.mark.parametrize("m,k,n,frac", GATE_GRID)
def test_cpu_gate_matches_jax(m, k, n, frac, dtype):
    nnz = int(round(frac * m * k))
    assert host._prefer_densify(
        m, k, n, nnz, formats.torch_dtype(dtype), torch.device("cpu")
    ) == bool(_xla._prefer_densify(m, k, n, nnz, np.dtype(dtype)))


def test_card_gate_cost_models():
    """The card's forms: the dense route wins where the kernel's work
    grows past the dense product's, never past the cap on dense A, and
    one densify (a transpose pair) is never dearer than two."""
    cuda, f64 = torch.device("cuda"), torch.float64
    side = 10_000
    assert not host._prefer_densify(side, side, 128, side * side // 1000,
                                     f64, cuda)
    assert host._prefer_densify(side, side, 128, side * side // 2, f64, cuda)
    assert not host._prefer_densify(30_000, 30_000, 128, 30_000 ** 2 // 2,
                                    f64, cuda)  # 7.2 GB of dense A
    picks = [host._prefer_densify(side, side, 128, nnz, f64, cuda)
             for nnz in range(0, side * side, side * side // 64)]
    assert picks == sorted(picks)
    for nnz in (10_000, 300_000, 2_500_000):
        one = host._prefer_densify_product(500, 5000, 500, nnz, nnz, f64,
                                           cuda, True)
        two = host._prefer_densify_product(500, 5000, 500, nnz, nnz, f64,
                                           cuda, False)
        assert one or not two


# ---------------------------------------------------------------------------
# SpMM through dot_product: both packages, the route each took
# ---------------------------------------------------------------------------


def spmm_calls(pkg, layout, a, b, d, out):
    """dot_product of ``pkg`` in one of the three SpMM layouts."""
    if layout == "csr":
        return pkg.dot_product(a, b, out=out, out_scalar=None if out is None
                               else 2.0)
    if layout == "csc":
        return pkg.dot_product(a.tocsc(), b, out=out,
                               out_scalar=None if out is None else 2.0)
    return pkg.dot_product(d, a, out=out, out_scalar=None if out is None
                           else 2.0)


@pytest.mark.parametrize("with_out", [False, True], ids=["plain", "out"])
@pytest.mark.parametrize("density", [0.1, 0.4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("layout", ["csr", "csc", "dense_x_csr"])
def test_dot_product_route_matches_jax(layout, dtype, density, with_out):
    rng = np.random.default_rng(4)
    a = sps.random(60, 50, density=density, format="csr", random_state=rng,
                   dtype=dtype, data_rvs=lambda s: values(rng, s, dtype))
    b = values(rng, (50, 7), dtype)
    d = values(rng, (9, 60), dtype)
    shape = (9, 50) if layout == "dense_x_csr" else (60, 7)
    out = values(rng, shape, dtype) if with_out else None
    dense_route = density > 0.25
    with mock.patch.object(host, "densified_spmm",
                           wraps=host.densified_spmm) as route, \
            mock.patch.object(csr, "csr_spmm", wraps=csr.csr_spmm) as k2:
        got = spmm_calls(sdtt, layout, a, b, d,
                         None if out is None else out.copy())
    assert (route.call_count, k2.call_count) == (int(dense_route),
                                                 int(not dense_route))
    with mock.patch.object(_xla, "spmm_densified_sorted",
                           wraps=_xla.spmm_densified_sorted) as jax_route:
        want = spmm_calls(sdt, layout, a, b, d,
                          None if out is None else out.copy())
    assert jax_route.call_count == int(dense_route)
    assert got.dtype == want.dtype and got.shape == want.shape
    npt.assert_array_almost_equal(got, want, decimal=DECIMAL[dtype])


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_complex_spmm_route_matches_scipy(dtype):
    """Complex values take the route natively (one complex matmul)."""
    rng = np.random.default_rng(5)
    a = sps.random(40, 30, density=0.5, format="csr", random_state=rng,
                   dtype=dtype, data_rvs=lambda s: values(rng, s, dtype))
    b = values(rng, (30, 6), dtype)
    with mock.patch.object(host, "densified_spmm",
                           wraps=host.densified_spmm) as route:
        got = sdtt.dot_product(a, b)
    assert route.call_count == 1
    npt.assert_array_almost_equal(got, a @ b, decimal=5)


# ---------------------------------------------------------------------------
# Non-finite B: off the route, scipy's result
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad", [np.nan, np.inf], ids=["nan", "inf"])
@pytest.mark.parametrize("dtype", VALUE_TYPES)
@pytest.mark.parametrize("layout", ["csr", "csc", "dense_x_csr"])
def test_nonfinite_b_takes_k2_and_matches_scipy(layout, dtype, bad):
    """ROADMAP's example: A = [[2, 0], [0, 1]] at density 0.5, above the
    CPU gate, and B = [[bad, 1], [1, 1]].  scipy gives C[1, 0] = 1; a
    densified A would meet B[0, 0] with its zero there."""
    a = sps.csr_matrix(np.array([[2, 0], [0, 1]], dtype=dtype))
    b = np.array([[bad, 1], [1, 1]], dtype=dtype)
    with mock.patch.object(host, "densified_spmm",
                           wraps=host.densified_spmm) as route, \
            mock.patch.object(csr, "csr_spmm", wraps=csr.csr_spmm) as k2, \
            mock.patch.object(torch, "matmul", wraps=torch.matmul) as mm:
        if layout == "dense_x_csr":
            got, want = sdtt.dot_product(b, a), (a.T @ b.T).T
        else:
            mat = a.tocsc() if layout == "csc" else a
            got, want = sdtt.dot_product(mat, b), a @ b
    # The gate sends it to the route; the finite flag, read after the
    # product, drops that product and K2 runs.
    assert (route.call_count, mm.call_count, k2.call_count) == (1, 1, 1)
    assert np.isfinite(got[1] if layout != "dense_x_csr" else got[:, 1]).all()
    npt.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    npt.assert_array_equal(got[ok], want[ok])


@pytest.mark.parametrize("operand", ["a", "b"])
def test_nonfinite_sparse_operand_takes_k6(operand):
    """A dense-output product whose stored values hold inf stays on K6:
    scipy's structural sums, no 0 * inf."""
    rng = np.random.default_rng(6)
    a = sps.random(8, 6, density=0.9, format="csr", random_state=rng)
    b = sps.random(6, 5, density=0.9, format="csr", random_state=rng)
    (a if operand == "a" else b).data[0] = np.inf
    with mock.patch.object(host, "densified_product",
                           wraps=host.densified_product) as route, \
            mock.patch.object(spgemm, "csr_spgemm_dense",
                              wraps=spgemm.csr_spgemm_dense) as k6, \
            mock.patch.object(torch, "matmul", wraps=torch.matmul) as mm:
        got = sdtt.dot_product(a, b, dense=True)
    assert (route.call_count, mm.call_count, k6.call_count) == (1, 1, 1)
    want = (a @ b).toarray()
    npt.assert_array_equal(np.isnan(got), np.isnan(want))
    npt.assert_array_equal(got[~np.isnan(want)], want[~np.isnan(want)])


# ---------------------------------------------------------------------------
# Dense-output sparse x sparse and the dense gram
# ---------------------------------------------------------------------------

PRODUCTS = {
    "x_xT": lambda pkg, x, y: pkg.dot_product(x, x.T, dense=True),
    "x_y": lambda pkg, x, y: pkg.dot_product(x, y, dense=True),
    "x_y_csc": lambda pkg, x, y: pkg.dot_product(x.tocsc(), y.tocsc(),
                                                 dense=True),
    "gram_aat": lambda pkg, x, y: pkg.gram_matrix(x, transpose=True,
                                                  dense=True),
    "gram_ata": lambda pkg, x, y: pkg.gram_matrix(x, dense=True),
    "gram_ata_out": lambda pkg, x, y: pkg.gram_matrix(
        x, dense=True, out=np.ones((x.shape[1], x.shape[1]), x.dtype),
        out_scalar=0.5),
}
# K12 launches of each product on the route: one for X and its
# transpose view, two for two operands.
DENSIFIES = {"x_xT": 1, "x_y": 2, "x_y_csc": 2, "gram_aat": 1,
             "gram_ata": 1, "gram_ata_out": 1}


@pytest.mark.parametrize("density", [0.2, 0.7])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(PRODUCTS))
def test_dense_output_route_matches_jax(case, dtype, density):
    rng = np.random.default_rng(7)
    x = sps.random(20, 30, density=density, format="csr", random_state=rng,
                   dtype=dtype)
    y = sps.random(30, 25, density=density, format="csr", random_state=rng,
                   dtype=dtype)
    dense_route = density > 0.5  # products over 0.25 of m k n
    with mock.patch.object(host, "densified_product",
                           wraps=host.densified_product) as route, \
            mock.patch.object(spgemm, "csr_spgemm_dense",
                              wraps=spgemm.csr_spgemm_dense) as k6, \
            mock.patch.object(densify, "csr_densify",
                              wraps=densify.csr_densify) as k12:
        got = PRODUCTS[case](sdtt, x, y)
    assert (route.call_count, k6.call_count) == (int(dense_route),
                                                 int(not dense_route))
    assert k12.call_count == (DENSIFIES[case] if dense_route else 0)
    want = PRODUCTS[case](sdt, x, y)
    assert got.dtype == want.dtype and got.shape == want.shape
    npt.assert_array_almost_equal(got, want, decimal=DECIMAL[dtype])


def test_scipy_transpose_view_is_a_transpose_pair():
    """``dot_product(X, X.T)`` with scipy X hands the port A and its view
    A.T (one upload; one densify on the route); a copy of X.T is not."""
    rng = np.random.default_rng(8)
    x = sps.random(10, 12, density=0.8, format="csr", random_state=rng)
    seen = []
    real = host.densified_product

    def spy(A, B, *args, **kwargs):
        seen.append(host.transpose_pair(A, B))
        return real(A, B, *args, **kwargs)

    with mock.patch.object(host, "densified_product", spy):
        r1 = sdtt.dot_product(x, x.T, dense=True)
        r2 = sdtt.dot_product(x, x.T.copy(), dense=True)
    assert seen == [True, False]
    npt.assert_array_almost_equal(r1, (x @ x.T).toarray(), decimal=12)
    npt.assert_array_almost_equal(r2, r1, decimal=12)


# ---------------------------------------------------------------------------
# The dense solvers densify through K12's wrapper
# ---------------------------------------------------------------------------


def test_dense_solvers_call_the_wrapper():
    rng = np.random.default_rng(9)
    a = (sps.random(40, 40, density=0.2, format="csr", random_state=rng)
         + 5.0 * sps.eye(40)).tocsr()
    b = rng.standard_normal(40)
    with mock.patch.object(densify, "csr_densify",
                           wraps=densify.csr_densify) as k12:
        x = sdtt.sparse_qr_solve(a, b)
        pt, iparm = sdtt.pardisoinit(11)
        y, pt, _, err = sdtt.pardiso(a, b, pt, 11, iparm, 13)
        sdtt.pardiso(a, b, pt, 11, iparm, -1)
    assert k12.call_count == 2 and err == 0
    npt.assert_allclose(a @ x, b, atol=1e-10)
    npt.assert_allclose(a @ y, b, atol=1e-10)
