"""The member groups of batched K1, K2, K5 and K6, on the host: which
batches a block serves a group of members (``csr.spmm_group``,
``csr.batched_plan``, ``spgemm.fill_groups``, ``spgemm.dense_group``,
``bsr.spmm_group``), what the members of
a batched K6 launch share (``spgemm.dense_form``), how a batch falls into
groups (``csr.member_groups``, a part-full last group), how K5's launch
table splits by group size (``spgemm._by_group``), K6's plan under a
group (``spgemm.dense_plan``, the single one), the shared memory a group
asks for (``spgemm.group_bytes`` and ``dense_group_bytes``, the kernels'
regions) and that the cached plans are keyed by everything that changes
the group.  The kernels themselves run on the card only (``chip_smoke.py``'s
``check_groups`` holds each group instance against its plain version and
each member against its single launch, bit for bit); the ``vmap`` parity
of the batches they serve is in ``test_torch_batched.py`` and
``test_torch_batched_spgemm.py``.
"""

import numpy as np
import pytest
import torch

from sparse_dot_tpu_torch.ops import bsr, csr, spgemm

TYPES = [torch.float32, torch.float64, torch.complex64, torch.complex128]


@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("index_bytes", [4, 8])
@pytest.mark.parametrize("n", [1, 17, 64, 128, 300])
def test_spmm_group_by_type_and_size(dtype, index_bytes, n):
    """K2's group: 4 members a block, the table's fewer for its (type,
    index bytes) (f32: 2), 2 for a batch of 2, 1 (the per-member instance)
    for a batch of 1, whatever the lane mapping."""
    s = csr.spmm_schedule(n, dtype, 12.0)
    most = csr._K2_FEWER_MEMBERS.get((dtype, index_bytes), 4)
    assert csr.spmm_group(s, dtype, index_bytes, 1) == 1
    assert csr.spmm_group(s, dtype, index_bytes, 2) == min(most, 2)
    for size in (3, 4, 5, 16, 70_000):
        assert csr.spmm_group(s, dtype, index_bytes, size) == most
    assert most == (2 if dtype == torch.float32 else 4)


@pytest.mark.parametrize("shared_b, per_member_values, grouped", [
    (True, True, True), (False, True, False), (True, False, False),
    (False, False, False)])
def test_batched_plan_groups_only_b_shared_and_values_per_member(
        shared_b, per_member_values, grouped):
    """``batched_plan`` takes a group only where b is shared and the
    values are not: with b per member, or the values shared (the
    per-sample form), one member a block; its schedule is
    ``spmm_schedule``'s either way."""
    s, group = csr.batched_plan(128, torch.float64, 100.0, True, 4, 5,
                                shared_b, per_member_values)
    assert s == csr.spmm_schedule(128, torch.float64, 100.0, True)
    assert group == (4 if grouped else 1)


def test_batched_plan_cache_keyed_by_what_changes_the_group():
    """The cached plan is keyed by the value type, index bytes, batch size
    and which operands are shared: each changes the group, and a repeat
    call is a cache hit."""
    csr.batched_plan.cache_clear()
    base = (128, torch.float64, 100.0, True, 4, 4, True, True)
    assert csr.batched_plan(*base)[1] == 4
    assert csr.batched_plan(*base)[1] == 4
    assert csr.batched_plan.cache_info().hits == 1
    # A batch of 2, of 1, b per member, the values shared: each its own
    # entry and group.
    for at, value, group in ((5, 2, 2), (5, 1, 1), (6, False, 1),
                             (7, False, 1)):
        key = list(base)
        key[at] = value
        assert csr.batched_plan(*key)[1] == group
    assert csr.batched_plan.cache_info().currsize == 5
    old = dict(csr._K2_FEWER_MEMBERS)
    try:
        csr._K2_FEWER_MEMBERS[(torch.float64, 8)] = 2
        key = list(base)
        key[4] = 8
        csr.batched_plan.cache_clear()
        assert csr.batched_plan(*key)[1] == 2
        assert csr.batched_plan(*base)[1] == 4
    finally:
        csr._K2_FEWER_MEMBERS.clear()
        csr._K2_FEWER_MEMBERS.update(old)
        csr.batched_plan.cache_clear()


@pytest.mark.parametrize("size, group, want", [
    (1, 4, [(0, 1)]), (2, 2, [(0, 2)]), (3, 4, [(0, 3)]),
    (4, 4, [(0, 4)]), (5, 4, [(0, 4), (4, 1)]), (7, 2, [(0, 2), (2, 2),
                                                     (4, 2), (6, 1)]),
    (16, 4, [(0, 4), (4, 4), (8, 4), (12, 4)]),
    (70_001, 4, None)])
def test_member_groups_end_part_full(size, group, want):
    """A batch falls into whole groups and a part-full last one; the
    groups cover every member once, in order."""
    got = csr.member_groups(size, group)
    if want is not None:
        assert got == want
    assert sum(c for _, c in got) == size
    assert all(c == group for _, c in got[:-1]) and 1 <= got[-1][1] <= group
    assert [f for f, _ in got] == list(range(0, size, group))


def _bins(dtype, itype, n):
    return spgemm.spgemm_bins(dtype, itype, n)


def _expected(kind, slots, dtype, itype, most):
    """The members a block the rule gives a bin, from the region sizes of
    ``csrc/csr_spgemm.cuh`` (one region a group of threads, rounded up to
    16: a sorted-product bin's products' op(A) and op(B) entries and
    16-bit sorted order, whatever the members; a hash or dense bin's
    values of each member, then keys or flags)."""
    if kind in spgemm.TINY_KINDS.values():
        return most
    groups = {spgemm.SORTED_WARP: 8, spgemm.HASH_BLOCK: 1,
              spgemm.DENSE_SHARED: 1}.get(kind)
    if groups is None:
        return 1
    for g in (4, 2):
        if kind == spgemm.SORTED_WARP:
            region = -(-(slots * (2 * itype.itemsize + 2)) // 16) * 16
        else:
            tail = slots * itype.itemsize if kind != spgemm.DENSE_SHARED \
                else slots
            region = -(-(g * slots * dtype.itemsize + tail) // 16) * 16
        if g <= most and groups * region <= spgemm.SHARED_BUDGET:
            return g
    return 1


@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("itype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [8, 300, 5000, 100_000])
@pytest.mark.parametrize("size", [1, 2, 3, 4, 16])
def test_fill_groups_by_bin(dtype, itype, n, size):
    """K5's group a bin: the register bins 4 (2 for a batch of 2, 1 for
    one member), a hash or
    dense-shared bin the most whose members' values fit one table within
    SHARED_BUDGET, the dense rows in the device workspace 1."""
    bins = _bins(dtype, itype, n)
    got = spgemm.fill_groups(bins, dtype, itype, size)
    top = 1 if size < 2 else 2 if size == 2 else 4
    assert got.shape == (len(bins),)
    for (kind, slots, _), g in zip(bins, got):
        assert g == _expected(int(kind), int(slots), dtype, itype, top)
        if kind == spgemm.DENSE_GLOBAL:
            assert g == 1
    for most in (1, 2, 4):
        capped = spgemm.fill_groups(bins, dtype, itype, size, most)
        assert (capped <= max(most, 1)).all()
        assert (capped == np.minimum(capped, got)).all()
    assert (spgemm.fill_groups(bins, dtype, itype, size, 1) == 1).all()


def test_fill_groups_known_bins():
    """The rule at the bins the card checks: f64 with int32 ids at n =
    100,000 gives the register bins and both sorted-product bins 4 (their
    regions do not grow with the members: 8 warps' 128 or 512 products,
    10 bytes each, where the 1024-slot warp hash tables they replaced
    took 2), the 4096-slot block table 4, the largest block table and the
    dense rows in the device workspace 1; with int64 ids and c128 the
    sorted-product bins still 4, 2 at most for a batch of 2; c128 at n =
    300 takes a dense row in shared memory, 4 members a block."""
    bins = _bins(torch.float64, torch.int32, 100_000)
    got = dict(zip(map(tuple, bins[:, :2].tolist()),
                   spgemm.fill_groups(bins, torch.float64, torch.int32, 4)))
    assert got[(spgemm.TINY4, 4)] == got[(spgemm.TINY32, 32)] == 4
    assert got[(spgemm.SORTED_WARP, 128)] == 4
    assert got[(spgemm.SORTED_WARP, 512)] == 4
    wide = _bins(torch.complex128, torch.int64, 100_000)
    for size, want in ((16, 4), (2, 2)):
        groups = dict(zip(map(tuple, wide[:, :2].tolist()),
                          spgemm.fill_groups(wide, torch.complex128,
                                             torch.int64, size)))
        assert groups[(spgemm.SORTED_WARP, 128)] == want
        assert groups[(spgemm.SORTED_WARP, 512)] == want
    assert got[(spgemm.HASH_BLOCK, 4096)] == 4
    assert got[(spgemm.HASH_BLOCK, 16384)] == 1
    assert got[(spgemm.DENSE_GLOBAL, 100_000)] == 1
    bins = _bins(torch.complex128, torch.int64, 300)
    assert bins[-1, 0] == spgemm.DENSE_SHARED
    assert spgemm.fill_groups(bins, torch.complex128, torch.int64,
                              5)[-1] == 4


def test_group_bytes_is_the_kernels_region():
    """``group_bytes``: one region a group of threads, rounded up to 16: a
    sorted-product warp's op(A) and op(B) entry and 16-bit sorted order a
    product, whatever the members and the value type; a hash or dense
    region the members' values and then the keys (hash) or a flag byte a
    column (dense)."""
    f64, i32 = torch.float64, torch.int32
    for members in (1, 2, 4):
        assert spgemm.group_bytes(spgemm.SORTED_WARP, 128, f64, i32,
                                  members) == 8 * 128 * (2 * 4 + 2)
        assert spgemm.group_bytes(spgemm.SORTED_WARP, 512, torch.complex128,
                                  torch.int64, members) == 8 * 512 * 18
    assert spgemm.group_bytes(spgemm.HASH_BLOCK, 4096, f64, torch.int64,
                              2) == 2 * 4096 * 8 + 4096 * 8
    assert spgemm.group_bytes(spgemm.DENSE_SHARED, 300, torch.complex128,
                              i32, 4) == -(-(4 * 300 * 16 + 300) // 16) * 16
    assert spgemm.group_bytes(spgemm.DENSE_SHARED, 7, torch.float32, i32,
                              1) == 48


def test_by_group_splits_the_launch_table():
    """K5's table split by group size: one part a size among the bins it
    launches, every other bin SKIP in it, the table itself where every
    launched bin takes one size; SKIP bins count for no size."""
    bins = _bins(torch.float64, torch.int32, 100_000)
    table = bins.copy()
    table[:, 2] = 10
    groups = spgemm.fill_groups(bins, torch.float64, torch.int32, 4)
    parts = spgemm._by_group(table, groups)
    assert [g for g, _ in parts] == sorted(set(groups[1:].tolist()))
    launched = np.zeros(len(table), dtype=int)
    for g, part in parts:
        live = part[:, 0] != spgemm.SKIP
        assert (groups[live] == g).all()
        launched += live
    assert (launched == (table[:, 0] != spgemm.SKIP)).all()
    one = table.copy()
    one[groups != 4, 0] = spgemm.SKIP
    (g, part), = spgemm._by_group(one, groups)
    assert g == 4 and part is one
    none = table.copy()
    none[:, 0] = spgemm.SKIP
    assert spgemm._by_group(none, groups) == [(1, none)]


def test_fill_groups_cache_keyed_by_what_changes_the_group():
    """``fill_groups`` is cached by the bins' kinds and slots, the value
    type, the index type and the group cap: each changes the result, and
    a repeat call is a hit whose array cannot be written."""
    spgemm._fill_groups.cache_clear()
    bins = _bins(torch.float64, torch.int32, 100_000)
    a = spgemm.fill_groups(bins, torch.float64, torch.int32, 4)
    b = spgemm.fill_groups(bins, torch.float64, torch.int32, 5)
    assert spgemm._fill_groups.cache_info().hits == 1 and a is b
    with pytest.raises(ValueError):
        a[0] = 3
    c = spgemm.fill_groups(bins, torch.complex128, torch.int32, 4)
    d = spgemm.fill_groups(bins, torch.float64, torch.int32, 2)
    e = spgemm.fill_groups(bins, torch.float64, torch.int64, 4)
    assert spgemm._fill_groups.cache_info().currsize == 4
    assert not np.array_equal(a, c) and not np.array_equal(a, d)
    assert e[6] == 4 and a[6] == 4  # the sorted-product bins of 512
    skipped = bins.copy()
    skipped[5, 0] = spgemm.SKIP
    assert spgemm.fill_groups(skipped, torch.float64, torch.int32,
                              4)[5] == 1


# The most shared memory a block of an H100 may ask for (227 KB).
BLOCK_SMEM = 232_448
FORMS = [spgemm.B_SHARED, spgemm.B_PER_MEMBER, spgemm.ONE_SUM]


@pytest.mark.parametrize("s_a, s_b, form", [
    (7, 0, spgemm.B_SHARED), (7, 9, spgemm.B_PER_MEMBER),
    (0, 9, spgemm.B_PER_MEMBER), (0, 0, spgemm.ONE_SUM)])
def test_dense_form_from_strides(s_a, s_b, form):
    """What a batched K6 launch's members share follows op(B)'s member
    stride, then op(A)'s (0: shared): op(B)'s values per member take the
    form that loads them at their stride, op(A)'s alone the one that
    loads op(B)'s once, neither the one sum."""
    assert spgemm.dense_form(s_a, s_b) == form


@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("index_bytes", [4, 8])
@pytest.mark.parametrize("form", FORMS)
def test_dense_group_by_type_form_and_size(dtype, index_bytes, form):
    """K6's group: 4 members a block, the table's fewer for its (type,
    index bytes, form), 2 for a batch of 2, 1 (the per-member instance)
    for a batch of 1; in the ONE_SUM form 4 for any batch past 1 (one sum
    a group, whatever its members)."""
    fewer, from_size = spgemm._K6_FEWER_MEMBERS.get(
        (dtype, index_bytes, form), (4, 0))
    if form == spgemm.ONE_SUM:
        fewer = 4
    assert spgemm.dense_group(dtype, index_bytes, 1, form) == 1
    assert spgemm.dense_group(dtype, index_bytes, 2, form) == (
        4 if form == spgemm.ONE_SUM else 2)
    for size in (3, 4, 5, 8, 9, 16, 70_000):
        want = fewer if size >= from_size else 4
        assert spgemm.dense_group(dtype, index_bytes, size, form) == want
    assert fewer in (1, 2, 4)


def test_dense_group_known_choices():
    """The measured choices (PERF.md): f32 and f64 4 in every form but
    f64's op(B) per member; c64 with 32-bit ids 4 up to 8 members of op(A)
    and 2 past them; op(B)'s values per member 2 in f64 and the complex
    types."""
    f32, f64, c64 = torch.float32, torch.float64, torch.complex64
    group = spgemm.dense_group
    assert group(f32, 4, 16, spgemm.B_SHARED) == 4
    assert group(f32, 8, 4, spgemm.B_PER_MEMBER) == 4
    assert [group(f64, 4, s, spgemm.B_SHARED) for s in (4, 8, 9, 16)] == [
        4, 4, 4, 4]
    assert [group(c64, 4, s, spgemm.B_SHARED) for s in (4, 8, 9, 16)] == [
        4, 4, 2, 2]
    assert group(f64, 8, 16, spgemm.B_SHARED) == 4
    assert group(f64, 4, 4, spgemm.B_PER_MEMBER) == 2
    assert group(torch.complex128, 8, 5, spgemm.B_PER_MEMBER) == 2


@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("members", [1, 2, 4])
@pytest.mark.parametrize("m, n, a_nnz", [
    (500, 500, 530_000), (500, 1, 5000), (40, 300, 24_000),
    (60, 1000, 1200), (12, 1000, 60), (5000, 16_384, 50_000),
    (3, 100_000, 3000)])
def test_dense_plan_under_members(dtype, members, m, n, a_nnz):
    """A group runs on ``dense_plan``'s single plan (so each member has its
    single launch's bits): its windows cover the row with equal widths,
    and a block of ``members`` members' partial rows stays within what an
    H100 block may ask for, in every form."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    plan = spgemm.dense_plan(m, n, itemsize, a_nnz)
    assert (plan.windows - 1) * plan.width < n <= plan.windows * plan.width
    assert plan.width * itemsize <= max(spgemm.DENSE_ROW_BYTES,
                                        32 * itemsize)
    for form in FORMS:
        assert spgemm.dense_group_bytes(plan, members, itemsize,
                                        form) <= BLOCK_SMEM


@pytest.mark.parametrize("dtype", TYPES)
def test_dense_row_cap_fits_four_members(dtype):
    """The window cap leaves room for 4 members' partial rows a warp: the
    widest window of a type at 4 members a block fits a block's shared
    memory, and the demo's 500 columns stay one window."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    wide = spgemm.dense_plan(1, 1_000_000, itemsize, 1)
    assert wide.windows > 1
    assert spgemm.dense_group_bytes(wide, 4, itemsize) <= BLOCK_SMEM
    assert spgemm.DENSE_WARPS * spgemm.DENSE_ROW_BYTES * 4 <= BLOCK_SMEM
    assert spgemm.dense_plan(500, 500, itemsize, 530_000).windows == (
        1 if itemsize <= 8 else 2)


def test_dense_group_bytes_is_the_kernels_region():
    """``dense_group_bytes``: DENSE_WARPS partial rows of the plan's width,
    each column the members' sums side by side (csrc/
    csr_spgemm_dense_group.cu, kWarps * width * sizeof(Sums<T, R>)), one
    sum in the ONE_SUM form; the demo's f64 row at 4 members is 128 KB."""
    plan = spgemm.DensePlan(8, 500, 1)
    assert spgemm.dense_group_bytes(plan, 4, 8) == 8 * 500 * 4 * 8 == 128_000
    assert spgemm.dense_group_bytes(plan, 2, 16,
                                    spgemm.B_PER_MEMBER) == 8 * 500 * 32
    assert spgemm.dense_group_bytes(plan, 4, 8, spgemm.ONE_SUM) == 32_000
    assert spgemm.dense_group_bytes(plan, 1, 4) == 16_000


@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("bs", [3, 8, 16, 20, 64, 128])
@pytest.mark.parametrize("size", [1, 2, 3, 5, 16])
def test_k1_group_by_type_block_and_size(dtype, bs, size):
    """K1's group: ``_K1_GROUP``'s members (f32 4, f64 2) where b is
    shared and the blocks are per member, real values on the tensor cores
    (bs a multiple of 8), 2 for a batch of 2; 1, the per-member instance,
    for a batch of 1, complex values (their row was redesigned apart),
    blocks on the CUDA cores, b per member or the blocks shared."""
    got = bsr.spmm_group(dtype, bs, size)
    if size == 1 or dtype.is_complex or bs % 8:
        assert got == 1
    else:
        most = {torch.float32: 4, torch.float64: 2}[dtype]
        assert got == min(most, 2 if size == 2 else 4)
    assert bsr.spmm_group(dtype, bs, size, shared_b=False) == 1
    assert bsr.spmm_group(dtype, bs, size, per_member_blocks=False) == 1
