"""Batched K9 and K11 (``spgemm_grad.sampled_batched``,
``sparse_sampled_batched``): the plan that gives a thread block a group
of members (``group_members``, ``group_plan``, ``group_items``),
the work items sized over the member groups and the runs cached per group
size (``sparse_schedule``, ``_k9_record``), and the batched functions at
2 to 5 members against a dense numpy oracle and against the JAX package's
``jax.vmap`` of ``jax.grad`` of ``_xla.spgemm_numeric_sorted`` (K9) and
``_xla.esc_spgemm_block`` (K11).

On the CPU the wrappers run their batched plain versions, which the card's
kernels are held to.  Inputs are made from a seed with numpy.
Tolerances: against the oracle rtol 1e-12 (atol 1e-12 times the largest
|ref|) in float64 and complex128; against ``esc_spgemm_block`` 1e-12;
against ``spgemm_numeric_sorted`` 1e-6, since its float64 gradient runs
through ``densify_sorted``'s float32 limbs.  PyTorch's gradient of a real
loss in complex values is the conjugate of JAX's.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

import sparse_dot_tpu  # noqa: F401  (enables x64 before any JAX array)
from sparse_dot_tpu.ops import _xla

from sparse_dot_tpu_torch.config import config
from sparse_dot_tpu_torch.formats import CsrPattern
from sparse_dot_tpu_torch.ops import spgemm_grad

from .test_torch_batched_spgemm import (K, M, N, close, dense, esc_values,
                                        flat, operands, pattern, sampled,
                                        structure, values)

SIZES = (2, 3, 4, 5)
# Which operands the members share: D (K9) or G (K11), Y's values, or
# neither.
SHARED = ("d", "y", "none")


@pytest.fixture(autouse=True)
def on_the_cpu():
    """These tests ask for the CPU, where the wrappers take their plain
    versions."""
    saved = config.device
    config.device = "cpu"
    yield
    config.device = saved


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("shared_y", [False, True])
def test_group_members_fit_one_reduce_scatter(lanes, shared_y):
    """Members a group: never more than one reduce-scatter of the lanes
    holds (a round of ``group_round`` entries for each member), the most
    that does at ``_GROUP_MIN_LANES`` lanes or more, and 1 below them or
    where no group fits: Y's values per member."""
    members = spgemm_grad.group_members(lanes, shared_y)
    if members > 1:
        assert spgemm_grad.group_round(lanes, members) * members <= lanes
        assert spgemm_grad.group_fits(lanes, members, shared_y)
        assert not spgemm_grad.group_fits(lanes, 2 * members, shared_y)
    assert members == (4 if shared_y and lanes >= 8 else 1)


@pytest.mark.parametrize(
    "line, itemsize, mean_row, size, shared_d, shared_y, sizes, want", [
        # The demo's X @ X.T (lines of 500 f64, 32 lanes), 4 G's, values
        # shared: 4 members, 14 lines each in 226 KB; 2 members, 28.
        (500, 8, 106, 4, False, True, (4, 2), (4, 14)),
        (500, 8, 106, 4, False, True, (2,), (2, 28)),
        # c128: 7 lines a member.
        (500, 16, 106, 4, False, True, (4, 2), (4, 7)),
        # D shared: one panel for the group, as many lines as one member.
        (500, 8, 106, 4, True, True, (4, 2), (4, 32)),
        (500, 8, 106, 4, True, True, (2,), (2, 32)),
        # Y's values per member: the per-member kernel.
        (500, 8, 106, 4, False, False, (4, 2), (1, 28)),
        (500, 8, 106, 4, True, False, (4, 2), (1, 28)),
        # A batch of 2 takes 2; the per-member kernel where no group size
        # is allowed.
        (500, 8, 106, 2, False, True, (4, 2), (2, 28)),
        (500, 8, 106, 4, False, True, (), (1, 28)),
        # 2 lanes and 1: one member a block.
        (200, 8, 3, 5, False, True, (4, 2), (1, 32)),
        (200, 8, 1, 5, False, True, (4, 2), (1, 32)),
        # Lines so long that 4 a member do not fit beside 3 others, but
        # 4 of 2 members' do.
        (3000, 8, 106, 4, False, True, (4, 2), (2, 4)),
        (3000, 8, 106, 4, False, True, (2,), (2, 4)),
    ])
def test_group_plan(line, itemsize, mean_row, size, shared_d, shared_y,
                    sizes, want, monkeypatch):
    """``group_plan`` with the group sizes ``sizes`` allowed: the group's
    members and lines a member within ``_GROUP_SMEM`` (one panel where D
    is shared), at least SAMPLED_MIN_STAGED lines a member and at most
    SAMPLED_MAX_PANEL, a smaller group or the per-member plan where it
    does not fit."""
    monkeypatch.setattr(spgemm_grad, "_GROUP_SIZES", sizes)
    single = spgemm_grad.sampled_plan(line, itemsize, mean_row)
    plan = spgemm_grad.group_plan(single, itemsize, size, shared_d,
                                  shared_y)
    assert (plan.members, plan.panel) == want
    assert (plan.lanes, plan.staged, plan.pitch) == (
        single.lanes, single.staged, single.pitch)
    if plan.members == 1:
        assert tuple(plan[:4]) == tuple(single)
    else:
        panels = 1 if shared_d else plan.members
        assert panels * plan.panel * plan.pitch * itemsize <= \
            spgemm_grad._GROUP_SMEM
        assert spgemm_grad.SAMPLED_MIN_STAGED <= plan.panel <= \
            spgemm_grad.SAMPLED_MAX_PANEL
        assert spgemm_grad.group_fits(plan.lanes, plan.members, shared_y)


@pytest.mark.parametrize("mean_row, min_lanes, want", [
    # 2 lanes: a group of 2 fits one reduce-scatter, but the rule keeps
    # one member a block below _GROUP_MIN_LANES.
    (3, None, (2, 1)), (3, 1, (2, 2)),
    # 4 lanes: 4 members fit; 8 and 16 lanes take them.
    (6, None, (4, 1)), (6, 1, (4, 4)), (12, None, (8, 4)),
    (24, None, (16, 4)), (1, 1, (1, 1))])
def test_group_plan_by_lanes(mean_row, min_lanes, want, monkeypatch):
    """The group by the lanes that rows of Y of ``mean_row`` entries
    give: ``group_fits``' most at ``_GROUP_MIN_LANES`` (here
    ``min_lanes`` where given) or more, one member a block below."""
    if min_lanes is not None:
        monkeypatch.setattr(spgemm_grad, "_GROUP_MIN_LANES", min_lanes)
    single = spgemm_grad.sampled_plan(200, 8, mean_row)
    plan = spgemm_grad.group_plan(single, 8, 5, False, True)
    assert (plan.lanes, plan.members) == want
    assert plan.members == 1 or spgemm_grad.group_fits(
        plan.lanes, plan.members, True)


@pytest.mark.parametrize("transposed, mean_row, want", [
    (False, 12, 4), (True, 12, 1), (True, 30, 1), (True, 64, 4),
    (False, 64, 4)])
def test_sparse_group_plan_groups_the_db_form_from_32_lanes(
        transposed, mean_row, want):
    """K11's group: in the dL/dA form as K9's (from 8 lanes), in the
    dL/dB form, which stages columns of G by searching C's rows, from
    ``_GROUP_MIN_LANES_DB`` (32) lanes."""
    single = spgemm_grad.sparse_plan(200, 8, mean_row)
    plan = spgemm_grad.sparse_group_plan(single, 8, 4, (False, True),
                                         transposed)
    assert plan.members == want


def test_group_plan_rule_and_its_fallbacks():
    """The rule takes ``group_members`` members; a single product, a plan
    that reads its lines in place (no budget) and a batch of one take the
    per-member plan."""
    single = spgemm_grad.sampled_plan(500, 8, 106)
    plan = spgemm_grad.group_plan(single, 8, 4, False, True)
    assert plan.members == spgemm_grad.group_members(32, True) == 4
    for size, s in ((1, single), (4, spgemm_grad.sampled_plan(
            500, 8, 106, budget=0))):
        plan = spgemm_grad.group_plan(s, 8, size, False, True)
        assert plan.members == 1 and tuple(plan[:4]) == tuple(s)


@pytest.mark.parametrize("sizes, size, shared_d, per_member, want", [
    # The per-member kernel: its items a resident block, two blocks an SM
    # (28 lines of 500 f64 in 112 KB), over the 4 members.
    ((), 4, False, 2, -(-2 * 132 * 2 // 4)),
    ((), 5, False, 1, -(-1 * 132 * 2 // 5)),
    # A group: _GROUP_ITEMS a block, one block an SM, over the groups.
    ((2,), 4, False, 2, -(-2 * 132 // 2)),
    ((4, 2), 4, False, 2, 2 * 132),
    ((4, 2), 5, True, 2, -(-2 * 132 // 2))])
def test_group_items(sizes, size, shared_d, per_member, want, monkeypatch):
    """``group_items``: the work items of the resident blocks of a card
    of 132 SMs shared out over the member groups, each group's block
    alone on its SM, the per-member kernel's blocks as many as its
    panels let an SM hold."""
    monkeypatch.setattr(spgemm_grad, "_GROUP_SIZES", sizes)
    monkeypatch.setattr(spgemm_grad, "_GROUP_ITEMS", 2)
    single = spgemm_grad.sampled_plan(500, 8, 106)
    plan = spgemm_grad.group_plan(single, 8, size, shared_d, True)
    assert spgemm_grad.group_items(plan, 8, per_member, 132, size) == want


def test_sparse_schedule_sizes_items_over_groups_and_keys_runs_by_group(
        monkeypatch):
    """K11's schedule for a batch: the work items are the resident blocks
    of the group's plan over the member groups, and the runs of each
    group size are cached under their own key (the members last), so
    runs sized for one group size never serve another, while a repeat
    of one size reuses its own."""
    a, b = operands(41, m=40, k=30, n=36)
    pa = CsrPattern(*pattern(a), 30)
    pb = CsrPattern(*pattern(b), 36)
    sms = 4
    got = {}
    for size, sizes, want in ((1, (4, 2), 1), (4, (), 1), (4, (2,), 2),
                              (4, (4, 2), 4), (5, (4, 2), 4)):
        monkeypatch.setattr(spgemm_grad, "_GROUP_SIZES", sizes)
        plan, runs = spgemm_grad.sparse_schedule(
            pa, pb, 36, 8, False, sms, size, (False, True))
        again = spgemm_grad.sparse_schedule(
            pa, pb, 36, 8, False, sms, size, (False, True))[1]
        assert again is runs
        assert plan.members == want
        items = spgemm_grad.group_items(plan, 8, spgemm_grad._SPARSE_ITEMS,
                                        sms, size)
        key = ("k11", False, plan.panel, 30, items, plan.members)
        assert pa.plans[key] is runs
        got[(size, plan.members)] = runs
    keys = [k for k in pa.plans if k[0] == "k11"]
    assert len(keys) == len(set(keys)) == len(got)
    assert len({k[-1] for k in keys}) == 3  # members 1, 2 and 4


def test_k9_record_keys_runs_by_group(monkeypatch):
    """K9's launch record for a batch holds ``group_plan``'s plan, is
    cached per (launch shape, sharing) on P's pattern, and its runs are
    keyed with the group's members: 1 for the single launch and the
    per-member kernel, 2 and 4 for the groups."""
    class Props:
        multi_processor_count = 4

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props)
    a, b = operands(43, m=40, k=30, n=36)
    a_ip, a_ix = pattern(a)
    b_ip, b_ix = pattern(b)
    d = torch.zeros(4, 40, 36, dtype=torch.float64)
    members = set()
    for size, sizes, want in ((1, (4, 2), 1), (4, (), 1), (4, (2,), 2),
                              (4, (4, 2), 4)):
        monkeypatch.setattr(spgemm_grad, "_GROUP_SIZES", sizes)
        # A pattern of its own each time: the record is cached per launch
        # shape, not per allowed group size.
        pa = CsrPattern(a_ip, a_ix, 30)
        strides = (0, 0, 0) if size == 1 else (d.stride(0), 0, a.nnz)
        rec = spgemm_grad._k9_record(a_ip, a_ix, d, b_ip, b_ix, False, pa,
                                     40, 36, size, strides)
        assert spgemm_grad._k9_record(a_ip, a_ix, d, b_ip, b_ix, False, pa,
                                      40, 36, size, strides) is rec
        assert rec.plan.members == want
        run_keys = [k for k, v in pa.plans.items()
                    if k[0] == "k9" and v is rec.runs]
        assert [k[-1] for k in run_keys] == [want]
        members.add(want)
    assert members == {1, 2, 4}


@pytest.mark.parametrize("itemsize", [4, 8, 16])
@pytest.mark.parametrize("itype", [torch.int32, torch.int64])
def test_bank_order_deals_rows_over_banks(itemsize, itype):
    """``bank_order``: each row's entries permuted within the row, its
    column ids in that order, dealt round-robin by column mod B (B = 128
    / itemsize): the first entry of each bucket in bucket order, then the
    second, ...; built once per pattern and value size."""
    rng = np.random.default_rng(70)
    lengths = [0, 1, 30, 106, 0, 300, 7]
    cols = [rng.choice(500, n, replace=False) for n in lengths]
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    indices = np.concatenate(cols)
    y = CsrPattern(torch.tensor(indptr, dtype=itype),
                   torch.tensor(indices, dtype=itype), 500)
    order, ids = spgemm_grad.bank_order(y, itemsize)
    assert spgemm_grad.bank_order(y, itemsize)[0] is order
    assert order.dtype == torch.int64 and ids.dtype == itype
    assert torch.equal(ids, y.indices[order])
    b = 128 // itemsize
    want = []
    for r, c in enumerate(cols):
        pos = indptr[r] + np.arange(len(c))
        buckets = [pos[c % b == k] for k in range(b)]
        for rank in range(max(map(len, buckets), default=0)):
            want += [int(x[rank]) for x in buckets if len(x) > rank]
    assert order.tolist() == want


# ---------------------------------------------------------------------------
# The batched functions against numpy and JAX
# ---------------------------------------------------------------------------


def member_values(rng, size, shape, dtype, batched):
    """``size`` members of ``shape`` where ``batched``, else one shared
    set (also returned broadcast to the members, for the oracle)."""
    if batched:
        v = values(rng, (size, *shape), dtype)
        return v, v
    v = values(rng, shape, dtype)
    return v, np.broadcast_to(v, (size, *shape))


@pytest.mark.parametrize("dtype, size", [
    *((np.float64, s) for s in SIZES), (np.complex128, 3)])
@pytest.mark.parametrize("shared", SHARED)
@pytest.mark.parametrize("transposed", [False, True])
def test_sampled_batched(dtype, size, shared, transposed):
    """``sampled_batched`` (K9) at ``size`` members, D or Y's values
    shared or neither: member i is W_i op(B_i)^H at op(A)'s entries (dA)
    or op(A_i)^H W_i at op(B)'s (dB) at 1e-12, and the conjugate of
    ``jax.vmap(jax.grad)`` of sum(Re(C conj(W))) through
    ``spgemm_numeric_sorted`` at 1e-6."""
    rng = np.random.default_rng(50 + size)
    a, b = operands(51)
    a_ip, a_ix = pattern(a)
    b_ip, b_ix = pattern(b)
    w, w_all = member_values(rng, size, (M, N), dtype, shared != "d")
    yv, yv_all = member_values(rng, size, ((a if transposed else b).nnz,),
                               dtype, shared != "y")
    other = values(rng, (b if transposed else a).nnz, dtype)
    if transposed:
        t, order = CsrPattern(a_ip, a_ix, K).transpose()
        y_data = torch.tensor(yv)[..., order]
        out = spgemm_grad.sampled_batched(b_ip, b_ix, torch.tensor(w),
                                          t.indptr, t.indices, y_data,
                                          None, True)
    else:
        out = spgemm_grad.sampled_batched(a_ip, a_ix, torch.tensor(w),
                                          b_ip, b_ix, torch.tensor(yv))
    assert out.shape == (size, (b if transposed else a).nnz)
    for i in range(size):
        want = (sampled(dense(a, yv_all[i]).conj().T @ w_all[i], b)
                if transposed
                else sampled(w_all[i] @ dense(b, yv_all[i]).conj().T, a))
        close(out[i], want, dtype)

    def jax_loss(x, y, ww):
        c = _xla.spgemm_numeric_sorted(flat(a), x, flat(b), y, M, K, N)
        return jnp.sum(jnp.real(c * jnp.conj(ww)))

    yv_axis = None if shared == "y" else 0
    w_axis = None if shared == "d" else 0
    if transposed:
        ref = jax.vmap(jax.grad(jax_loss, argnums=1),
                       in_axes=(yv_axis, None, w_axis))(
            jnp.asarray(yv), jnp.asarray(other), jnp.asarray(w))
    else:
        ref = jax.vmap(jax.grad(jax_loss, argnums=0),
                       in_axes=(None, yv_axis, w_axis))(
            jnp.asarray(other), jnp.asarray(yv), jnp.asarray(w))
    close(out, np.conj(np.asarray(ref)), rtol=1e-6)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("shared", SHARED)
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("triangular", [False, True])
def test_sparse_sampled_batched(size, shared, transposed, triangular):
    """``sparse_sampled_batched`` (K11) at ``size`` members in float64,
    G or Y's values shared or neither: member i is G_i op(B_i)^H at
    op(A)'s entries (dA) or op(A_i)^H G_i at op(B)'s (dB), G_i on C's
    pattern, at 1e-12, and ``jax.vmap(jax.grad)`` of sum(C G) through
    ``esc_spgemm_block`` at 1e-12."""
    rng = np.random.default_rng(60 + size)
    a, b = operands(61)
    a_ip, a_ix = pattern(a)
    b_ip, b_ix = pattern(b)
    c_ptr, c_idx = structure(a, b, triangular)
    gv, gv_all = member_values(rng, size, (len(c_idx),), np.float64,
                               shared != "d")
    yv, yv_all = member_values(rng, size, ((a if transposed else b).nnz,),
                               np.float64, shared != "y")
    other = values(rng, (b if transposed else a).nnz, np.float64)
    av, bv = (yv, other) if transposed else (other, yv)
    out = spgemm_grad.sparse_sampled_batched(
        a_ip, a_ix, torch.tensor(av), b_ip, b_ix, torch.tensor(bv),
        torch.tensor(c_ptr.astype(np.int32)),
        torch.tensor(c_idx.astype(np.int32)), torch.tensor(gv), N,
        transposed, triangular)
    c = sps.csr_matrix((np.ones(len(c_idx)), c_idx, c_ptr), shape=(M, N))
    for i in range(size):
        g = dense(c, gv_all[i])
        want = (sampled(dense(a, yv_all[i]).T @ g, b) if transposed
                else sampled(g @ dense(b, yv_all[i]).T, a))
        close(out[i], want)

    yv_axis = None if shared == "y" else 0
    g_axis = None if shared == "d" else 0

    def jax_loss(x, y, gg):
        return jnp.sum(esc_values(a, b, x, y, triangular) * gg)

    if transposed:
        ref = jax.vmap(jax.grad(jax_loss, argnums=1),
                       in_axes=(yv_axis, None, g_axis))(
            jnp.asarray(yv), jnp.asarray(other), jnp.asarray(gv))
    else:
        ref = jax.vmap(jax.grad(jax_loss, argnums=0),
                       in_axes=(None, yv_axis, g_axis))(
            jnp.asarray(other), jnp.asarray(yv), jnp.asarray(gv))
    close(out, np.asarray(ref))
