"""The member groups of batched K2 and K5, on the host: which batches a
block serves a group of members (``csr.spmm_group``, ``csr.batched_plan``,
``spgemm.fill_groups``), how a batch falls into groups
(``csr.member_groups``, a part-full last group), how K5's launch table
splits by group size (``spgemm._by_group``), the shared memory a group's
table asks for (``spgemm.group_bytes``, the kernels' ``region_bytes``)
and that the cached plans are keyed by everything that changes the
group.  The kernels themselves run on the card only (``chip_smoke.py``'s
``check_groups`` holds each group instance against its plain version and
each member against its single launch, bit for bit); the ``vmap`` parity
of the batches they serve is in ``test_torch_batched.py`` and
``test_torch_batched_spgemm.py``.
"""

import numpy as np
import pytest
import torch

from sparse_dot_tpu_torch.ops import csr, spgemm

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
    ``csrc/csr_spgemm.cuh`` (values of each member, then keys or flags,
    rounded up to 16, one region a group of threads)."""
    if kind in spgemm.TINY_KINDS.values():
        return most
    groups = {spgemm.HASH_WARP: 8, spgemm.HASH_BLOCK: 1,
              spgemm.DENSE_SHARED: 1}.get(kind)
    if groups is None:
        return 1
    for g in (4, 2):
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
    100,000 gives the register bins and the 256-slot warp tables 4, the
    1024-slot warp tables 2 (four members' values would pass 200 KB for
    8 tables), the 4096-slot block table 4, the largest block table and
    the dense rows in the device workspace 1; c128 at n = 300 takes a
    dense row in shared memory, 4 members a block."""
    bins = _bins(torch.float64, torch.int32, 100_000)
    got = dict(zip(map(tuple, bins[:, :2].tolist()),
                   spgemm.fill_groups(bins, torch.float64, torch.int32, 4)))
    assert got[(spgemm.TINY4, 4)] == got[(spgemm.TINY32, 32)] == 4
    assert got[(spgemm.HASH_WARP, 256)] == 4
    assert got[(spgemm.HASH_WARP, 1024)] == 2
    assert got[(spgemm.HASH_BLOCK, 4096)] == 4
    assert got[(spgemm.HASH_BLOCK, 16384)] == 1
    assert got[(spgemm.DENSE_GLOBAL, 100_000)] == 1
    bins = _bins(torch.complex128, torch.int64, 300)
    assert bins[-1, 0] == spgemm.DENSE_SHARED
    assert spgemm.fill_groups(bins, torch.complex128, torch.int64,
                              5)[-1] == 4


def test_group_bytes_is_the_kernels_region():
    """``group_bytes``: one region a group of threads, the members' values
    and then the keys (hash) or a flag byte a column (dense), rounded up
    to 16."""
    f64, i32 = torch.float64, torch.int32
    assert spgemm.group_bytes(spgemm.HASH_WARP, 256, f64, i32, 4) == 8 * (
        4 * 256 * 8 + 256 * 4)
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
    assert e[6] == 2 and a[6] == 2  # the 1024-slot warp tables
    skipped = bins.copy()
    skipped[5, 0] = spgemm.SKIP
    assert spgemm.fill_groups(skipped, torch.float64, torch.int32,
                              4)[5] == 1
