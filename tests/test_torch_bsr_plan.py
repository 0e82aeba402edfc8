"""K1's tensor-core design, checked on the CPU.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against ``bsr_spmm_plain``).  What surrounds it is checked here:

- the chunk plan (``formats.bsr_chunk_plan``) against a numpy reference;
- a torch emulation of the kernel's two passes (a partial tile per chunk,
  direct writes for block rows of one chunk, the split rows' partials
  summed in chunk order, then the epilogue) against the plain version,
  the Pallas kernel in interpret mode and ``_xla.bsr_spmm``, at the
  tolerances of ``tests/test_torch_kernels.py`` (1e-12 f64, 1e-5 f32);
- a numpy emulation of the f32 route, 3xTF32, which meets rtol 1e-5
  against f64 at bs=128, k=8192, where plain TF32, and 3xTF32 summed in
  one set of registers that round toward zero, do not.
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax.numpy as jnp

import sparse_dot_tpu  # noqa: F401  (enables x64 before any JAX array)
from sparse_dot_tpu.ops import _xla
from sparse_dot_tpu.ops.pallas_bsr import bsr_spmm_pallas

from sparse_dot_tpu_torch import formats
from sparse_dot_tpu_torch.config import config
from sparse_dot_tpu_torch.formats import bsr_chunk_plan
from sparse_dot_tpu_torch.ops import bsr


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port runs on the card unless asked otherwise; these tests ask
    for the CPU, where its wrappers take their plain versions."""
    saved = config.device
    config.device = "cpu"
    yield
    config.device = saved


TOL = {np.dtype(np.float32): 1e-5, np.dtype(np.float64): 1e-12}


def t(arr):
    return torch.from_numpy(np.ascontiguousarray(arr))


# ---------------------------------------------------------------------------
# The chunk plan
# ---------------------------------------------------------------------------


def plan_reference(lengths):
    """(S, items, splits) of block rows of ``lengths`` stored blocks, by
    a plain loop."""
    nbrows, nblocks = len(lengths), int(sum(lengths))
    S = max(1, -(-nblocks // nbrows))
    items, splits, slot, start = [], [], 0, 0
    for r, length in enumerate(lengths):
        nch = max(1, -(-length // S))
        if nch > 1:
            splits.append((r, slot, nch))
        for j in range(nch):
            p0 = start + j * S
            items.append((r, p0, min(p0 + S, start + length),
                          slot + j if nch > 1 else -1))
        slot += nch if nch > 1 else 0
        start += length
    return S, items, splits, slot


PLAN_CASES = {
    "empty_rows": [0, 3, 0, 2, 0, 0, 5],
    "rows_of_exactly_S": [2, 2, 2, 2],
    "row_of_3S_plus_1": [1, 1, 10, 0, 1, 1],
    "several_split_rows": [9, 0, 1, 7, 2, 0, 0, 13],
    "no_blocks": [0, 0, 0],
    "one_row": [6],
}


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_chunk_plan_matches_reference(case, index_dtype):
    lengths = PLAN_CASES[case]
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(index_dtype)
    nblocks = int(indptr[-1])
    S, items, splits, used = plan_reference(lengths)
    plan = bsr_chunk_plan(t(indptr), nblocks)
    assert (plan.chunk, plan.nbrows, plan.nblocks) == (S, len(lengths),
                                                       nblocks)
    if case == "row_of_3S_plus_1":
        assert max(lengths) == 3 * S + 1
    if case == "rows_of_exactly_S":
        assert set(lengths) == {S} and not splits
    # Sizes known on the host; the real rows first, then padding.
    assert plan.items.shape == (len(lengths) + nblocks // S, 4)
    assert plan.splits.shape == (nblocks // (S + 1), 3)
    assert plan.items.dtype == plan.splits.dtype == torch.int64
    got = plan.items.tolist()
    assert got[:len(items)] == [list(i) for i in items]
    assert all(row == [-1, 0, 0, -1] for row in got[len(items):])
    got = plan.splits.tolist()
    assert got[:len(splits)] == [list(s) for s in splits]
    assert all(row == [-1, 0, 0] for row in got[len(splits):])
    assert used <= plan.slots


def test_chunk_plan_no_block_rows():
    plan = bsr_chunk_plan(torch.zeros(1, dtype=torch.int32), 0)
    assert plan.items.shape == (0, 4) and plan.splits.shape == (0, 3)


def test_chunk_plan_cached_on_container():
    rng = np.random.default_rng(61)
    A = formats.to_device(sparse_bsr(rng, 12, 9, 4, np.float64))
    for transpose in (False, True):
        plan = A.bsr_plan(transpose)
        assert A.bsr_plan(transpose) is plan
        indptr, _, data = A.bsr_arrays(transpose)
        ref = bsr_chunk_plan(indptr, data.shape[0])
        assert torch.equal(plan.items, ref.items)
        assert torch.equal(plan.splits, ref.splits)


@pytest.mark.parametrize("dtype, bs, tc", [
    (torch.float32, 8, True), (torch.float64, 128, True),
    (torch.float64, 24, True), (torch.float32, 3, False),
    (torch.float64, 1, False), (torch.complex64, 64, False),
    (torch.complex128, 16, False),
])
def test_variant_follows_dtype_and_block_size(dtype, bs, tc):
    assert bsr.uses_tensor_cores(dtype, bs) is tc


# ---------------------------------------------------------------------------
# The two passes
# ---------------------------------------------------------------------------


def sparse_bsr(rng, nbrows, nbcols, bs, dtype):
    """scipy BSR with Poisson block rows, one empty and one long."""
    import scipy.sparse as sps

    lengths = rng.poisson(2, nbrows)
    lengths[0] = 0
    lengths[1] = 4 * max(1, -(-int(lengths.sum()) // nbrows)) + 1
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    indices = rng.integers(0, nbcols, indptr[-1])
    data = rng.standard_normal((indptr[-1], bs, bs)).astype(dtype)
    return sps.bsr_matrix((data, indices, indptr),
                          shape=(nbrows * bs, nbcols * bs))


def two_pass(indptr, indices, data, b, alpha=None, beta=None, c0=None):
    """K1's tensor-core algorithm in torch, chunk by chunk."""
    nblocks, bs, _ = data.shape
    nbrows, n = indptr.numel() - 1, b.shape[1]
    plan = bsr_chunk_plan(indptr, nblocks)
    panels = b.reshape(-1, bs, n)
    c = torch.empty((nbrows, bs, n), dtype=b.dtype)
    work = torch.full((plan.slots, bs, n), float("nan"), dtype=b.dtype)
    c0 = None if c0 is None else c0.reshape(nbrows, bs, n)

    def epilogue(acc, brow):
        v = acc if alpha is None else alpha * acc
        return v if c0 is None else v + beta * c0[brow]

    for brow, p0, p1, slot in plan.items.tolist():
        if brow < 0:
            continue
        acc = torch.zeros((bs, n), dtype=b.dtype)
        for p in range(p0, p1):
            acc += data[p] @ panels[int(indices[p])]
        if slot < 0:
            c[brow] = epilogue(acc, brow)
        else:
            work[slot] = acc
    for brow, first, nch in plan.splits.tolist():
        if brow < 0:
            continue
        acc = work[first].clone()
        for j in range(1, nch):
            acc += work[first + j]
        c[brow] = epilogue(acc, brow)
    assert plan.splits[:, 0].max() >= 0, "the case splits no block row"
    return c.reshape(nbrows * bs, n)


def arrays(mat, index_dtype=np.int32):
    return (mat.indptr.astype(index_dtype), mat.indices.astype(index_dtype),
            mat.data)


def row_ids(indptr):
    return np.repeat(np.arange(len(indptr) - 1), np.diff(indptr)).astype(
        np.int32)


@pytest.mark.parametrize("accumulate", [False, True])
def test_two_pass_matches_plain_and_pallas_f32(accumulate):
    rng = np.random.default_rng(62)
    bs, nbrows, nbcols, n = 8, 9, 7, 128
    indptr, indices, data = arrays(sparse_bsr(rng, nbrows, nbcols, bs,
                                              np.float32))
    b = rng.standard_normal((nbcols * bs, n)).astype(np.float32)
    c0 = rng.standard_normal((nbrows * bs, n)).astype(np.float32)
    alpha, beta, cc = (0.5, 2.0, c0) if accumulate else (None, None, None)
    args = (t(indptr), t(indices), t(data), t(b), alpha, beta,
            None if cc is None else t(cc))
    port = two_pass(*args).numpy()
    npt.assert_allclose(port, bsr.bsr_spmm_plain(*args).numpy(), rtol=1e-5,
                        atol=1e-5)
    ref = bsr_spmm_pallas(
        jnp.asarray(row_ids(indptr)), jnp.asarray(indices),
        jnp.asarray(data), jnp.asarray(b), m=nbrows * bs, bs=bs,
        interpret=True, alpha=alpha, beta=beta,
        c0=None if cc is None else jnp.asarray(cc),
    )
    npt.assert_allclose(port, np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("accumulate", [False, True])
def test_two_pass_matches_plain_and_xla_f64(bs, index_dtype, accumulate):
    rng = np.random.default_rng(63)
    nbrows, nbcols, n = 11, 6, 9
    indptr, indices, data = arrays(
        sparse_bsr(rng, nbrows, nbcols, bs, np.float64), index_dtype)
    b = rng.standard_normal((nbcols * bs, n))
    c0 = rng.standard_normal((nbrows * bs, n))
    alpha, beta, cc = (2.0, -0.5, c0) if accumulate else (None, None, None)
    args = (t(indptr), t(indices), t(data), t(b), alpha, beta,
            None if cc is None else t(cc))
    port = two_pass(*args).numpy()
    npt.assert_allclose(port, bsr.bsr_spmm_plain(*args).numpy(),
                        rtol=1e-12, atol=1e-12)
    ref = _xla.bsr_spmm(
        jnp.asarray(data), jnp.asarray(row_ids(indptr)), jnp.asarray(indices),
        jnp.asarray(b), m=nbrows * bs, alpha=alpha, beta=beta,
        c0=None if cc is None else jnp.asarray(cc),
    )
    npt.assert_allclose(port, np.asarray(ref), rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# The f32 route: 3xTF32
# ---------------------------------------------------------------------------


def tf32_round(x):
    """f32 rounded to TF32's 10 mantissa bits, half away from zero, as
    the kernel does it (an integer add and a mask on the bits)."""
    u = x.astype(np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_trunc(x):
    """What the tensor cores read of an f32 operand: its top 10 mantissa
    bits."""
    u = x.astype(np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def round_to_zero(x):
    """f64 -> f32 rounded toward zero, as the tensor cores round their
    f32 sums."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def mma(a, b, c):
    """One tensor-core product a @ b + c: exact products, the sum rounded
    toward zero to f32."""
    return round_to_zero(a.astype(np.float64) @ b.astype(np.float64) + c)


def tf32_emulations(a, b):
    """(1xTF32, 3xTF32 in one accumulator, 3xTF32 as the kernel sums it)
    of a @ b, k8 step by k8 step."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_trunc(a - a_hi), tf32_trunc(b - b_hi)
    shape = (a.shape[0], b.shape[1])
    one = np.zeros(shape, np.float32)
    fused = np.zeros(shape, np.float32)
    acc = np.zeros(shape, np.float32)
    lo = np.zeros(shape, np.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        one = mma(a_hi[:, s], b_hi[s], one)
        fused = mma(a_lo[:, s], b_hi[s], fused)
        fused = mma(a_hi[:, s], b_lo[s], fused)
        fused = mma(a_hi[:, s], b_hi[s], fused)
        # The kernel: hi*hi of the step in fresh registers, added in IEEE
        # f32; the cross products in their own accumulator.
        acc = acc + mma(a_hi[:, s], b_hi[s], 0.0)
        lo = mma(a_lo[:, s], b_hi[s], lo)
        lo = mma(a_hi[:, s], b_lo[s], lo)
    return one, fused, acc + lo


def test_3xtf32_meets_f32_tolerance_where_1xtf32_does_not():
    """bs=128 rows, k=8192: the route of K1's f32 variant is within rtol
    1e-5 (atol 1e-5 * max|ref|, as chip_smoke.py compares) of the f64
    product; plain TF32 and 3xTF32 accumulated in one set of registers
    are not."""
    rng = np.random.default_rng(64)
    a = rng.standard_normal((128, 8192)).astype(np.float32)
    b = rng.standard_normal((8192, 16)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    atol = 1e-5 * np.abs(ref).max()
    one, fused, kernel = tf32_emulations(a, b)
    npt.assert_allclose(kernel, ref, rtol=1e-5, atol=atol)
    for wrong in (one, fused):
        with pytest.raises(AssertionError):
            npt.assert_allclose(wrong, ref, rtol=1e-5, atol=atol)


def test_3xtf32_split_keeps_inf():
    """hi of inf is inf; the kernel then zeroes lo and the cross-product
    copy of hi, so inf * finite gives inf, not nan."""
    x = np.array([np.inf, -np.inf, 1.5, 3.0e38], np.float32)
    hi = tf32_round(x)
    assert np.isinf(hi[:2]).all() and hi[2] == 1.5
    finite = np.isfinite(hi)
    lo = np.where(finite, x - np.where(finite, hi, 0), 0)
    assert (lo[:2] == 0).all() and np.isfinite(lo).all()
