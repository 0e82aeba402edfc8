"""Sampled sparse-row products: the value gradients of a sparse x sparse
product, with dense output (kernel K9, ``csr_spgemm_sddmm``) and with
sparse output (kernel K11, ``csr_spgemm_sparse_sddmm``, at the end of
this module).

``csr_spgemm_sddmm(indptr, indices, d, y_indptr, y_indices, y_data,
alpha, transposed)`` gives, for each stored entry p of a CSR P at row
r_p, column c_p, one of two forms (conj only for complex values):

- the dA form (``transposed=False``):
  ``out[p] = alpha * sum over (s, v) in row c_p of Y of d[r_p, s] conj(v)``;
- the dB form (``transposed=True``):
  ``out[p] = alpha * sum over (i, v) in row r_p of Y of d[i, c_p] conj(v)``,

with ``d`` dense and row-major and Y a CSR: K7's gather with a sparse row
of Y in place of a dense row of B.  For C = alpha * op(A) @ op(B) + beta
* c0 and G = dL/dC they are both value gradients, as PyTorch's convention
for complex gradients has them, with alpha conjugated and d = G:

- dL/d(op(A)'s values) at A's pattern, the dA form with Y = op(B);
- dL/d(op(B)'s values) at B's pattern, the dB form with Y = op(A)^T
  (``CsrPattern.transpose``'s structure, op(A)'s values gathered through
  its permutation): no transposed copy of G.

Each form has its plain version (``sampled_rows_plain``,
``sampled_cols_plain``; ``csr_spgemm_sddmm_plain`` picks by
``transposed``).  On a CUDA tensor the wrapper launches the hand-written
kernel (``csrc/csr_spgemm_sddmm.cu``) or raises; on a CPU tensor it runs
the plain version, which is also what the kernel is checked against on
the card.  ``csr_spgemm_sddmm.launches`` counts calls that launched the
kernel.

K9 replaces XLA's transpose of ``_xla.spgemm_numeric_sorted``
(``sparse_dot_tpu/ops/_xla.py``, through ``densify_sorted``), which
``jax.grad`` runs as a dense G @ op(B)^H (op(A)^H @ G) gathered at the
operand's scatter positions.  Its work is one multiply-add per entry of
P and entry of the row of Y it names.  Call a line of D the row r_p (dA)
or the column c_p (dB) that entry p reads.  The kernel's plan
(``sampled_plan``) cuts D's lines into panels of ``panel`` lines that a
thread block holds in shared memory where they fit its budget, and the
entries of P into runs (``sampled_runs``, built once per pattern and
cached): the entries of one panel that name one row of Y, which a group
of ``lanes`` lanes serves with one load of that row.

Batches (the backward of ``torch.func.vmap`` over the values, ``jacrev``'s
cotangents, a batch of tangents): ``sampled_batched`` (K9) and
``sparse_sampled_batched`` (K11) take members that share the patterns,
D (G) and Y's values each per member or shared, in one launch.  Where
the lines are staged, ``group_plan`` gives a thread block a group of 2
or 4 members, which walks the runs and loads each row of Y once for all
of them (the members' panels side by side in shared memory, fewer lines
a member); elsewhere a block serves one member.  The work items are
sized over the member groups, and the runs, the plan and the type codes
are cached on P's pattern per launch shape (``SampledRecord``).  Each
has a plain version vectorised over the members.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..config import config
from ..formats import CsrPattern, expand_indptr, structure_only
from . import _build
from .csr import (_add_rows, _check, batch_size, check_members,
                  member_chunks, member_ptr, member_stride, refuse_tracked,
                  refuse_views)

# Lanes a group may take: 1 to 32, a power of two.
_MAX_LANES = 32
# Shared memory a thread block of K9 gives its panel of D's lines (two
# blocks share an SM's 227 KB), the most lines a staged panel holds, and
# the fewest worth staging; longer lines are read in place in panels of
# SAMPLED_L1_PANEL lines.
SAMPLED_SMEM = 112 * 1024
SAMPLED_MAX_PANEL = 32
SAMPLED_MIN_STAGED = 4
SAMPLED_L1_PANEL = 8
# Threads a block (csrc/csr_spgemm_sddmm.cu's kThreads, at 64 registers
# a thread, so 1024 threads an SM), and work items a resident block of
# the grid: few where each stages its panel, more where lines are read
# in place (the finer the items, the shorter the last wave).
_THREADS = 512
_ITEMS_STAGED = 2
_ITEMS_IN_PLACE = 8


def sampled_lanes(mean_row):
    """K9's lanes per group for rows of Y with ``mean_row`` entries on
    average: the power of two at or above half of it, 1 to 32, so a lane
    takes about two entries of a row of mean length (``csrc/
    csr_spgemm_sddmm.cu`` instantiates each)."""
    lanes = 1
    while lanes < min(mean_row / 2, _MAX_LANES):
        lanes *= 2
    return lanes


class SampledPlan(NamedTuple):
    """K9's launch: ``lanes`` a group; ``panel`` lines of D a thread block
    holds, staged in shared memory at ``pitch`` elements a line when
    ``staged`` (else read through L1)."""

    lanes: int
    panel: int
    staged: bool
    pitch: int


def sampled_plan(line, itemsize, mean_y_row, columns=False, budget=None):
    """K9's plan for lines of D of ``line`` elements of ``itemsize``
    bytes (n in the dA form; m in the dB form, whose lines are
    ``columns`` of D) and rows of Y of ``mean_y_row`` entries on
    average: as many lines as fit ``budget`` bytes (``SAMPLED_SMEM``) at
    an odd pitch (so a warp's writes of a column of lines fall in
    distinct banks), at most SAMPLED_MAX_PANEL, in shared memory, with
    ``sampled_lanes`` lanes a group walking a row of Y.  When fewer than
    SAMPLED_MIN_STAGED fit, the lines are read in place: rows in panels of
    SAMPLED_L1_PANEL, the same groups; columns in panels of 32, a lane an
    entry of a run, so a warp reads 32 neighbours in a row of D."""
    budget = SAMPLED_SMEM if budget is None else budget
    lanes = sampled_lanes(mean_y_row)
    pitch = line | 1
    panel = min(SAMPLED_MAX_PANEL, budget // (pitch * itemsize))
    if panel >= SAMPLED_MIN_STAGED:
        return SampledPlan(lanes, panel, True, pitch)
    if columns:
        return SampledPlan(_MAX_LANES, _MAX_LANES, False, 0)
    return SampledPlan(lanes, SAMPLED_L1_PANEL, False, 0)


def sampled_blocks_per_sm(plan, itemsize):
    """Thread blocks of K9 an SM holds at once: 1024 threads' worth (its
    registers at 64 a thread), or fewer where the staged panels fill its
    shared memory (227 KB)."""
    blocks = 1024 // _THREADS
    if not plan.staged:
        return blocks
    smem = plan.panel * plan.pitch * itemsize
    return max(1, min(blocks, 227 * 1024 // smem))


# A batch's staged lines (``group_plan``): where the members share Y's
# values, a thread block of 1024 threads serves a group of 2 or 4 members
# (``csrc/sampled.cuh``, sampled_group_kernel), one block an SM with
# ``_GROUP_SMEM`` for the members' panels (the SM's 227 KB, less K11's
# row bounds) and ``_GROUP_ITEMS`` work items a resident block.  Timed
# (PERF.md): at case a (the demo's X @ X.T, f64, 4 G's) one block of 1024
# threads in 226 KB beat two of 512 in 112 KB each at every group size,
# and 2 items a block beat 1, 4 and 8; with Y's values per member, 2
# members a group (a row of values a member in registers) ran slower
# than the per-member kernel, so a group needs them shared.  The rule
# tries ``_GROUP_SIZES``, largest first, at ``_GROUP_MIN_LANES`` lanes or
# more, and in K11's dB form (which stages columns of G by searching C's
# rows) at ``_GROUP_MIN_LANES_DB``: in f32, f64 and c128 with int32 and
# int64 ids at 32 lanes, and in f64 at 8, a group of 4 beat 1 and 2 (in
# K11's dB form, f32 and f64, 2 and 4 within 8% of each other either
# way); at 2 and 4 lanes groups ran up to 2x slower (K9 at 4 lanes
# level), and K11's dB form 1.3x slower at 8.
_GROUP_SMEM = 226 * 1024
_GROUP_ITEMS = 2
_GROUP_SIZES = (4, 2)
_GROUP_MIN_LANES = 8
_GROUP_MIN_LANES_DB = 32


class GroupPlan(NamedTuple):
    """A batched launch's plan: ``SampledPlan``'s fields for one member's
    lines (``panel`` lines a member), and ``members`` a thread block (1:
    the per-member kernel)."""

    lanes: int
    panel: int
    staged: bool
    pitch: int
    members: int = 1


def group_round(lanes, members):
    """Entries of a run a round of the group kernel takes: K9's round
    (kRound = 4, at most the lanes) split over the members, at least 1."""
    return max(1, min(4, lanes) // members)


def group_fits(lanes, members, shared_y):
    """Whether the group kernel takes ``members`` a group at ``lanes``
    lanes: Y's values shared by the members, and a round's sums
    (``group_round`` entries for each member) within one reduce-scatter
    of the lanes (``csrc/csr_spgemm_sddmm_group.cu``, launch_lanes)."""
    return (bool(shared_y) and members in (2, 4)
            and group_round(lanes, members) * members <= lanes)


def group_members(lanes, shared_y, min_lanes=None):
    """Members a group of the staged kernel serves at once: at
    ``min_lanes`` (``_GROUP_MIN_LANES``) lanes or more, the first of
    ``_GROUP_SIZES`` that ``group_fits``; 1 (the per-member kernel) where
    none does."""
    if lanes < (_GROUP_MIN_LANES if min_lanes is None else min_lanes):
        return 1
    for members in _GROUP_SIZES:
        if group_fits(lanes, members, shared_y):
            return members
    return 1


def group_plan(single, itemsize, size, shared_d, shared_y, min_lanes=None):
    """The ``GroupPlan`` of a batched launch of ``size`` members whose
    single launch takes ``single`` (``sampled_plan`` or ``sparse_plan``),
    for values of ``itemsize`` bytes: where ``single`` stages lines and
    the batch has 2 or more members, ``group_members`` members a group
    (at most 2 for a batch of 2), each member's panel as many lines as
    fit ``_GROUP_SMEM`` beside the others' (one panel for all where D,
    or G, is shared: ``shared_d``), at most SAMPLED_MAX_PANEL; half the
    group where fewer than SAMPLED_MIN_STAGED lines a member fit, and the
    per-member kernel on ``single``'s plan where no group does.
    ``min_lanes``: as ``group_members``."""
    if not single.staged or size < 2:
        return GroupPlan(*single)
    members = min(group_members(single.lanes, shared_y, min_lanes),
                  2 if size == 2 else 4)
    while members > 1:
        if group_fits(single.lanes, members, shared_y):
            panels = 1 if shared_d else members
            panel = min(SAMPLED_MAX_PANEL,
                        _GROUP_SMEM // (panels * single.pitch * itemsize))
            if panel >= SAMPLED_MIN_STAGED:
                return GroupPlan(single.lanes, panel, True, single.pitch,
                                 members)
        members //= 2
    return GroupPlan(*single)


def group_items(plan, itemsize, per_member, sms, size):
    """Work items of a ``GroupPlan``'s launch of ``size`` members on a
    card of ``sms`` SMs: ``per_member`` (the per-member kernel's items a
    resident block, ``sampled_blocks_per_sm`` of them an SM) or
    ``_GROUP_ITEMS`` (a group's, one block an SM) for each resident
    block, shared out over the member groups."""
    if plan.members == 1:
        items = per_member * sms * sampled_blocks_per_sm(
            SampledPlan(*plan[:4]), itemsize)
    else:
        items = _GROUP_ITEMS * sms
    return -(-items // -(-size // plan.members))


def bank_order(y, itemsize):
    """(order, indices) for the CSR pattern ``y`` of Y, for the group
    kernel: a permutation of each row's entries (int64), and the column
    ids in that order, that deals the row's entries
    round-robin over the shared-memory banks that a staged line's
    elements at those ids fall in (bucketed by column mod B, B = 128 /
    ``itemsize`` elements of one 128-byte wavefront: the first entry of
    each bucket, then the second, ...).  The lanes of a group take a
    row's entries in turn, so B lanes that read one staged line at once
    mostly hit distinct banks, where a row in column order puts
    neighbouring ids in one bank.  Y's values are gathered into this
    order once a call (``_bank_values``); sums over a row are taken in
    it.  Device ops, built once per pattern and value size and cached on
    ``y.plans``."""
    b = 128 // itemsize
    key = ("bank", b)
    if key not in y.plans:
        with structure_only():
            nnz = y.nnz
            rows = expand_indptr(y.indptr, nnz)
            res = y.indices.long() % b
            pos = torch.arange(nnz, device=y.indices.device)
            # Each entry's rank among its row's entries of its bucket.
            by_bucket = torch.argsort(rows.long() * b + res, stable=True)
            bucket = (rows.long() * b + res)[by_bucket]
            first = torch.ones(nnz, dtype=torch.bool, device=pos.device)
            first[1:] = bucket[1:] != bucket[:-1]
            rank = torch.empty_like(pos)
            rank[by_bucket] = pos - torch.cummax(
                torch.where(first, pos, 0), 0).values
            # By (row, rank, bucket): two stable sorts.
            inner = torch.argsort(rank * b + res, stable=True)
            order = inner[torch.argsort(rows[inner], stable=True)]
            y.plans[key] = (order, y.indices[order])
    return y.plans[key]


def _bank_values(y_data, order):
    """Y's values, shared by the members (1-d, or expanded along the
    members), gathered in ``order``: one row for all of them."""
    return (y_data[0] if y_data.dim() == 2 else y_data)[order]


class SampledRuns(NamedTuple):
    """The entries of P in run order.  ``perm`` (nnz,): the entry at each
    position; ``line`` (nnz,): its line of D; ``run_ptr`` (n_runs + 1,):
    where each run starts; ``run_q`` (n_runs,): the row of Y it names;
    ``items`` (n_items + 1,) int64: the first run of each work item (a
    thread block), the runs of one panel that start within one span of
    ``chunk`` of its entries."""

    perm: torch.Tensor
    line: torch.Tensor
    run_ptr: torch.Tensor
    run_q: torch.Tensor
    items: torch.Tensor
    chunk: int


def entry_ids(indptr, indices, transposed):
    """(line, q) of every stored entry of the CSR P: its line of D and the
    row of Y it names, (row, column), or (column, row) with
    ``transposed``."""
    rows = expand_indptr(indptr, indices.numel())
    return (indices, rows) if transposed else (rows, indices)


def sampled_runs(indptr, indices, transposed, panel, y_rows, target):
    """K9's runs of P's entries (``SampledRuns``): entries sorted stably
    by (panel of their line, row of Y), a run for each (panel, row of Y)
    that holds any, and work items of the runs of one panel that start
    within one span of ``chunk`` of its entries: the smallest ``chunk``
    that makes at most ``target`` items, or one item a panel where the
    panels are more.  Device ops and two host reads (the runs' count,
    and the panels' sizes)."""
    nnz = indices.numel()
    device = indices.device
    line, q = (ids.long() for ids in entry_ids(indptr, indices, transposed))
    perm = torch.argsort((line // panel) * y_rows + q, stable=True)
    key = ((line // panel) * y_rows + q)[perm]
    first = torch.ones(nnz, dtype=torch.bool, device=device)
    first[1:] = key[1:] != key[:-1]
    starts = first.nonzero().squeeze(1)
    n_runs = starts.numel()
    run_panel = key[starts] // y_rows
    new_panel = torch.ones(n_runs, dtype=torch.bool, device=device)
    new_panel[1:] = run_panel[1:] != run_panel[:-1]
    sizes = np.diff(torch.cat((starts[new_panel],
                               torch.tensor([nnz], device=device))).cpu()
                    .numpy())
    chunk = _smallest_chunk(sizes, target)
    # Each run's first position within its panel, in spans of chunk.
    panel_start = torch.cummax(torch.where(new_panel, starts, 0), 0).values
    span = (starts - panel_start) // chunk
    new_item = new_panel.clone()
    new_item[1:] |= span[1:] != span[:-1]
    items = torch.cat((new_item.nonzero().squeeze(1),
                       torch.tensor([n_runs], device=device)))
    itype = indices.dtype
    return SampledRuns(
        perm.to(itype), line[perm].to(itype),
        torch.cat((starts, torch.tensor([nnz], device=device))).to(itype),
        q[perm][starts].to(itype), items, chunk)


def _smallest_chunk(sizes, target):
    """The smallest span c with sum(ceil(sizes / c)) <= target (the
    largest size when no span does: one item a panel)."""
    lo, hi = 1, max(1, int(sizes.max()))
    while lo < hi:
        mid = (lo + hi) // 2
        if int((-(-sizes // mid)).sum()) <= target:
            hi = mid
        else:
            lo = mid + 1
    return lo


def _sampled_plain(q, gather, nnz, y_indptr, y_indices, y_data, dtype,
                   device, alpha, lead=()):
    """``alpha * sum over (y, v) in row q[p] of Y of gather(p, y) conj(v)``
    for each p: every product expanded and gathered, summed by
    ``index_add_``, chunked so that at most ``config.spmm_chunk_elements``
    products are held.  ``lead``: the output's leading shape, (B,) for a
    batch's members (``gather`` and ``y_data`` then give each member's,
    or one for all)."""
    out = torch.zeros((*lead, nnz), dtype=dtype, device=device)
    if nnz == 0:
        return out
    y_start = y_indptr[:-1].long()[q]
    y_len = y_indptr[1:].long()[q] - y_start
    ends = torch.cumsum(y_len, 0)
    total = int(ends[-1])
    budget = max(1, config.spmm_chunk_elements // (lead[0] if lead else 1))
    p0 = 0
    while p0 < nnz and total:
        # Entries [p0, p1) hold at most ``budget`` products (a longer
        # entry is a chunk alone).
        done = int(ends[p0 - 1]) if p0 else 0
        p1 = int(torch.searchsorted(ends, done + budget, right=True))
        p1 = min(max(p1, p0 + 1), nnz)
        count = y_len[p0:p1]
        n_prod = int(count.sum())
        entry = torch.repeat_interleave(
            torch.arange(p0, p1, device=device), count, output_size=n_prod)
        first = torch.cumsum(count, 0) - count
        t = (y_start[entry] + torch.arange(n_prod, device=device)
             - first[entry - p0])
        prods = gather(entry, y_indices[t].long()) * y_data[..., t].conj()
        _add_rows(out, entry, prods.expand(*lead, -1), dim=len(lead))
        p0 = p1
    if alpha is not None and complex(alpha) != 1:
        out = out * alpha
    return out


def sampled_rows_plain(indptr, indices, d, y_indptr, y_indices, y_data,
                       alpha=None):
    """The dA form in plain PyTorch: ``out[p] = alpha * sum_{(s, v) in
    row c_p of Y} d[r_p, s] conj(v)``."""
    r, q = (ids.long() for ids in entry_ids(indptr, indices, False))
    return _sampled_plain(q, lambda p, s: d[r[p], s], indices.numel(),
                          y_indptr, y_indices, y_data, d.dtype, d.device,
                          alpha)


def sampled_cols_plain(indptr, indices, d, y_indptr, y_indices, y_data,
                       alpha=None):
    """The dB form in plain PyTorch: ``out[p] = alpha * sum_{(i, v) in
    row r_p of Y} d[i, c_p] conj(v)``."""
    c, q = (ids.long() for ids in entry_ids(indptr, indices, True))
    return _sampled_plain(q, lambda p, i: d[i, c[p]], indices.numel(),
                          y_indptr, y_indices, y_data, d.dtype, d.device,
                          alpha)


def csr_spgemm_sddmm_plain(indptr, indices, d, y_indptr, y_indices, y_data,
                           alpha=None, transposed=False):
    """K9's function in plain PyTorch: the dB form's plain version with
    ``transposed``, else the dA form's."""
    plain = sampled_cols_plain if transposed else sampled_rows_plain
    return plain(indptr, indices, d, y_indptr, y_indices, y_data, alpha)


def csr_spgemm_sddmm_batched_plain(indptr, indices, d, y_indptr, y_indices,
                                   y_data, alpha=None, transposed=False):
    """``sampled_batched`` in plain PyTorch: K9's function for each member
    of ``d`` ((B, rows, cols) or shared (rows, cols)) and ``y_data`` ((B,
    nnz(Y)) or shared), at least one with the member dimension,
    vectorised over the members; (B, nnz(P))."""
    size = batch_size("csr_spgemm_sddmm", ((d, 2), (y_data, 1)))
    line, q = (ids.long() for ids in entry_ids(indptr, indices, transposed))
    gather = ((lambda p, i: d[..., i, line[p]]) if transposed
              else (lambda p, s: d[..., line[p], s]))
    return _sampled_plain(q, gather, indices.numel(), y_indptr, y_indices,
                          y_data, d.dtype, d.device, alpha, (size,))


def csr_spgemm_sddmm(indptr, indices, d, y_indptr, y_indices, y_data,
                     alpha=None, transposed=False):
    """K9's function (module docstring) for each entry of the CSR
    (``indptr``, ``indices``) in its stored order, for row-major ``d`` and
    the CSR Y (``y_indptr``, ``y_indices``, ``y_data``): the dA form,
    or the dB form with ``transposed``.  Returns a new (nnz,) tensor.  Not
    differentiable itself (``ops.autograd.CsrSpgemmSddmm`` is): it raises
    on a tracked ``d`` or ``y_data`` (``csr.refuse_tracked``), on both
    devices."""
    refuse_tracked("csr_spgemm_sddmm", d, y_data)
    return sampled(indptr, indices, d, y_indptr, y_indices, y_data, alpha,
                   transposed)


def sampled(indptr, indices, d, y_indptr, y_indices, y_data, alpha=None,
            transposed=False, pattern=None, y_pattern=None):
    """``csr_spgemm_sddmm`` without the tracked check, for the Function's
    forward: K9 on the card, the plain version on the CPU; counted in
    ``csr_spgemm_sddmm.launches``.  ``pattern`` (``y_pattern``) is P's
    (Y's) ``CsrPattern``, on which the runs (the column ids' range) are
    cached; when None, the one ``autograd.patterns`` holds for these
    index tensors.  On either device it raises ``ValueError`` where d, P
    and Y do not fit: d's rows against P's rows (dA) or Y's rows against
    P's rows (dB), P's column ids against Y's rows (dA) or d's columns
    (dB), Y's column ids against d's columns (dA) or rows (dB); the ids
    are read once per pattern."""
    refuse_views("csr_spgemm_sddmm", indptr, indices, d, y_indptr,
                 y_indices, y_data)
    m, y_rows = indptr.numel() - 1, y_indptr.numel() - 1
    if d.dim() != 2 or (y_rows != m if transposed else d.shape[0] != m):
        raise ValueError(f"csr_spgemm_sddmm: d {tuple(d.shape)} and Y of "
                         f"{y_rows} rows do not fit P of {m} rows")
    ne, ny = (d.shape[1], d.shape[0]) if transposed else d.shape
    from .autograd import patterns

    if pattern is None:
        pattern = patterns.get(indptr, indices, ne if transposed else y_rows)
    if y_pattern is None:
        y_pattern = patterns.get(y_indptr, y_indices, ny)
    _check_ids(pattern, ne if transposed else y_rows, y_pattern, ny,
               transposed, d.shape)
    if d.device.type == "cpu":
        return csr_spgemm_sddmm_plain(indptr, indices, d, y_indptr,
                                      y_indices, y_data, alpha, transposed)
    if not d.is_cuda:
        raise ValueError(f"csr_spgemm_sddmm: no kernel for device "
                         f"{d.device}")
    _check("csr_spgemm_sddmm", (indptr, indices, y_indptr, y_indices),
           (d, y_data))
    nnz = indices.numel()
    out = torch.empty(nnz, dtype=d.dtype, device=d.device)
    if nnz == 0:
        return out
    rec = _k9_record(indptr, indices, d, y_indptr, y_indices, transposed,
                     pattern, ne, ny, 1, (0, 0, 0))
    _k9_launch(rec, indptr, d, y_indptr, y_indices, y_data, out, alpha, 1,
               (0, 0, 0), 0, _build.stream_of(d))
    return out


def sampled_batched(indptr, indices, d, y_indptr, y_indices, y_data,
                    alpha=None, transposed=False, pattern=None,
                    y_pattern=None):
    """K9 for a batch of members that share P's and Y's patterns: member i
    is K9's function of ``d[i]`` and Y with values ``y_data[i]``, ``d``
    (B, rows, cols) or (rows, cols), ``y_data`` (B, nnz(Y)) or (nnz(Y),),
    at least one with the member dimension, each member contiguous; an
    operand without it (or expanded along it) is shared, read in place by
    every member.  Returns a new (B, nnz(P)) tensor.  One launch on the
    card (one per ``_build.MAX_MEMBERS`` members) on the plan of
    ``group_plan``: where it stages lines, a block serves a group of
    members at once; the runs and the launch's record are cached on P's
    pattern (``_k9_record``).  Counted in ``csr_spgemm_sddmm.launches``
    and ``launches_batched``.  The batched plain version on the CPU.
    Raises as ``sampled`` does where the operands do not fit."""
    refuse_views("csr_spgemm_sddmm", indptr, indices, d, y_indptr,
                 y_indices, y_data)
    operands = ((d, 2), (y_data, 1))
    size = batch_size("csr_spgemm_sddmm", operands)
    m, y_rows = indptr.numel() - 1, y_indptr.numel() - 1
    d_shape = tuple(d.shape[-2:])
    if d.dim() not in (2, 3) or (y_rows != m if transposed
                                 else d_shape[0] != m):
        raise ValueError(f"csr_spgemm_sddmm: d {tuple(d.shape)} and Y of "
                         f"{y_rows} rows do not fit P of {m} rows")
    ne, ny = (d_shape[1], d_shape[0]) if transposed else d_shape
    from .autograd import patterns

    if pattern is None:
        pattern = patterns.get(indptr, indices, ne if transposed else y_rows)
    if y_pattern is None:
        y_pattern = patterns.get(y_indptr, y_indices, ny)
    _check_ids(pattern, ne if transposed else y_rows, y_pattern, ny,
               transposed, d_shape)
    if y_data.shape[-1] != y_indices.numel():
        raise ValueError(f"csr_spgemm_sddmm: Y's values "
                         f"{tuple(y_data.shape)} do not fit its "
                         f"{y_indices.numel()} entries")
    if d.device.type == "cpu":
        return csr_spgemm_sddmm_batched_plain(indptr, indices, d, y_indptr,
                                              y_indices, y_data, alpha,
                                              transposed)
    if not d.is_cuda:
        raise ValueError(f"csr_spgemm_sddmm: no kernel for device "
                         f"{d.device}")
    strides = check_members("csr_spgemm_sddmm",
                            (indptr, indices, y_indptr, y_indices),
                            operands, views=False)
    nnz = indices.numel()
    out = torch.empty((size, nnz), dtype=d.dtype, device=d.device)
    if nnz == 0 or size == 0:
        return out
    strides = (*strides, nnz)
    rec = _k9_record(indptr, indices, d, y_indptr, y_indices, transposed,
                     pattern, ne, ny, size, strides)
    if rec.plan.members > 1:
        # A group reads Y's rows in bank order, its values gathered once.
        order, y_indices = bank_order(y_pattern, d.element_size())
        y_data = _bank_values(y_data, order)
    stream = _build.stream_of(d)
    for first, count in member_chunks(size):
        _k9_launch(rec, indptr, d, y_indptr, y_indices, y_data, out, alpha,
                   count, strides, first, stream)
        csr_spgemm_sddmm.launches_batched += 1
    return out


class SampledRecord(NamedTuple):
    """What a K9 or K11 launch needs besides the operands' addresses,
    built once per P's pattern and launch shape and cached with the runs
    (``_k9_record``, ``_k11_record``): the ``GroupPlan``, the runs (None
    where lines are read in place), the type codes, and ``dims``: K9's
    (se, sy, ne, ny), a line's step and an element's in d and the lines'
    count and length; K11's (ne, ny)."""

    plan: "GroupPlan"
    runs: "SampledRuns"
    codes: tuple
    dims: tuple


def _k9_record(indptr, indices, d, y_indptr, y_indices, transposed,
               pattern, ne, ny, size, strides):
    """K9's ``SampledRecord`` for P (``indptr``, ``indices``; its
    ``CsrPattern`` ``pattern`` caches the record and the runs), Y's
    pattern, d's lines of ``ne`` x ``ny`` (d's last two dimensions) and a
    launch of ``size`` members at member ``strides`` (d, Y's values, the
    output; 1 and zeros for one product): the plan is ``group_plan``'s,
    its work items (``group_items``: ``_ITEMS_STAGED`` or
    ``_ITEMS_IN_PLACE`` a resident block of the per-member kernel, or a
    group's) shared out over the member groups.  Keyed on all that the plan and the runs depend
    on, so a record (and the runs) sized for one group size is never
    reused for another."""
    y_rows = y_indptr.numel() - 1
    key = ("k9-launch", bool(transposed), ne, ny, d.shape[-1], y_rows,
           y_indices.numel(), d.dtype, indices.dtype, d.device, size,
           strides[0] == 0, strides[1] == 0)
    rec = pattern.plans.get(key)
    if rec is not None:
        return rec
    itemsize = d.element_size()
    single = sampled_plan(ny, itemsize, y_indices.numel() / max(y_rows, 1),
                          transposed)
    plan = group_plan(single, itemsize, size, strides[0] == 0,
                      strides[1] == 0)
    sms = torch.cuda.get_device_properties(d.device).multi_processor_count
    items = group_items(plan, itemsize, _ITEMS_STAGED if plan.staged
                        else _ITEMS_IN_PLACE, sms, size)
    run_key = ("k9", bool(transposed), plan.panel, y_rows, items,
               plan.members)
    if run_key not in pattern.plans:
        with structure_only():
            pattern.plans[run_key] = sampled_runs(
                indptr, indices, transposed, plan.panel, y_rows, items)
    # A line's elements lie 1 apart along a row of d (dA) or ld apart
    # down a column (dB); lines lie ld or 1 apart.
    se, sy = (1, d.shape[-1]) if transposed else (d.shape[-1], 1)
    rec = SampledRecord(plan, pattern.plans[run_key],
                        _build.type_codes(d, indptr), (se, sy, ne, ny))
    pattern.plans[key] = rec
    return rec


def _k9_launch(rec, indptr, d, y_indptr, y_indices, y_data, out, alpha,
               count, strides, first, stream):
    """One launch of K9 on ``rec`` for ``count`` members from ``first``
    at ``strides`` (d, Y's values, the output): a group of members a
    block where the plan says so and the launch has 2 or more, else one
    member a block; counted in ``csr_spgemm_sddmm.launches``."""
    plan, runs = rec.plan, rec.runs
    group = plan.members > 1 and count > 1
    arrays = (*rec.codes, runs.items.data_ptr(), runs.items.numel() - 1,
              runs.run_ptr.data_ptr(), runs.run_q.data_ptr(),
              runs.perm.data_ptr(), runs.line.data_ptr(),
              member_ptr(d, strides[0], first), *rec.dims, plan.panel,
              plan.pitch)
    y = (y_indptr.data_ptr(), y_indices.data_ptr(),
         member_ptr(y_data, strides[1], first),
         member_ptr(out, strides[2], first), plan.lanes,
         *_build.scalar_parts(alpha), count)
    if group:
        _build.launch("sdt_csr_spgemm_sddmm_group", *arrays, *y, strides[0],
                      strides[2], plan.members, stream)
    else:
        _build.launch("sdt_csr_spgemm_sddmm", *arrays, int(plan.staged), *y,
                      *strides, stream)
    csr_spgemm_sddmm.launches += 1


def _check_ids(pattern, p_cols, y_pattern, ny, transposed, d_shape):
    """Raises ``ValueError`` when P's column ids (``pattern``) fall
    outside [0, p_cols) or Y's (``y_pattern``) outside [0, ny): K9 would
    read past d or Y.  The dB form takes d = G, whose columns are P's: a
    G^T of another shape lands here."""
    form = ("the dB form (transposed=True) takes d = G, not G^T"
            if transposed else "the dA form")
    for name, pat, limit, what in (
            ("P", pattern, p_cols,
             "d's columns" if transposed else "Y's rows"),
            ("Y", y_pattern, ny, "d's rows" if transposed else
             "d's columns")):
        lo, hi = pat.column_span()
        if lo < 0 or hi > limit:
            raise ValueError(
                f"csr_spgemm_sddmm: {name}'s column ids span [{lo}, {hi}), "
                f"outside the {limit} of {what} (d {tuple(d_shape)}; "
                f"{form})")


csr_spgemm_sddmm.launches = 0
csr_spgemm_sddmm.launches_batched = 0


# ---------------------------------------------------------------------------
# K11: the sparse-output product's gradients
# ---------------------------------------------------------------------------
#
# For C = op(A) @ op(B) on its structural pattern (``spgemm.csr_spgemm``:
# every product a(i, k) b(k, j) has its entry (i, j) in C, each row's
# columns ascending; only j >= i under ``triangular``) and G = dL/dC given
# as values ``g`` on C's pattern, as PyTorch's convention for complex
# gradients has them:
#
# - dL/d(op(A)'s values)[p = (i, k)] = sum over j of op(B)'s row k of
#   G[i, j] conj(op(B)[k, j]) (the dA form);
# - dL/d(op(B)'s values)[q = (k, j)] = sum over i of op(A)'s column k of
#   conj(op(A)[i, k]) G[i, j] (the dB form, ``transposed``), which the
#   kernel reads through op(A)'s cached transposed structure
#   (``CsrPattern.transpose``), op(A)'s values gathered through its
#   permutation.
#
# K11 (``csrc/csr_spgemm_sparse_sddmm.cu``) replaces XLA's transpose of
# ``_xla.esc_spgemm_block`` (``sparse_dot_tpu/ops/_xla.py``): ``jax.grad``
# of the expand-sort-compress product in its values.  Its sums are K9's,
# with G on C's sparse pattern in place of a dense D: where G's lines (its
# rows in the dA form, its columns in the dB form) are short enough, a
# thread block stages a panel of them from C's storage and serves K9's
# runs (``sampled_runs``) of P's entries (op(A) in the dA form, op(B) in
# the dB form); a product whose entry C lacks adds nothing.

# K11's plan (``sparse_plan``): lines of G staged as K9 stages them, in
# SPARSE_SMEM bytes a block, where at least SAMPLED_MIN_STAGED fit, and
# otherwise read in place (256 threads a block, a group of lanes a row of
# P).
SPARSE_SMEM = SAMPLED_SMEM
# Staged work items a resident block: one, where K9 takes two.  K11
# stages a panel from C's storage (a scatter, or a search a row of C),
# which costs more than K9's copy of dense lines, and every item stages
# its panel anew.
_SPARSE_ITEMS = 1


def sparse_plan(line, itemsize, mean_y_row, budget=None):
    """K11's ``SampledPlan`` for lines of G of ``line`` elements (n in the
    dA form, G's rows; m in the dB form, its columns) of ``itemsize``
    bytes and rows of Y (op(B), or op(A)^T in the dB form) of
    ``mean_y_row`` entries on average: K9's (``sampled_plan``, its lines
    staged in ``budget`` bytes, ``SPARSE_SMEM``) where it stages lines;
    else ``sampled_lanes`` lanes a group and lines read in place
    (``panel`` 0)."""
    plan = sampled_plan(line, itemsize, mean_y_row, False,
                        SPARSE_SMEM if budget is None else budget)
    return plan if plan.staged else plan._replace(panel=0)


def sparse_group_plan(single, itemsize, size, shared, transposed):
    """K11's ``group_plan`` for a launch of ``size`` members whose G and
    Y's values are or are not ``shared``: in the dB form (``transposed``)
    a group from ``_GROUP_MIN_LANES_DB`` lanes."""
    return group_plan(single, itemsize, size, *shared,
                      _GROUP_MIN_LANES_DB if transposed else None)


def sparse_schedule(p, y, line, itemsize, transposed, sms, members=1,
                    shared=(False, False)):
    """(``GroupPlan``, runs) of K11 for P's ``CsrPattern`` ``p`` (op(A)
    in the dA form, op(B) in the dB form), Y's ``y`` and lines of G of
    ``line`` elements on a card of ``sms`` SMs, for a launch of
    ``members`` members whose G and Y's values are or are not
    ``shared``: ``sparse_group_plan``'s plan on ``sparse_plan``'s, and
    the
    runs (``sampled_runs``, ``group_items``' work items:
    ``_SPARSE_ITEMS`` a resident block of the per-member kernel, or a
    group's) where the plan stages lines, else None.  The runs depend on
    P's pattern, the panel and the work items alone, never on C: they are
    cached on ``p``'s ``plans`` (keyed with the group's members too, so
    runs sized for one group size serve no other) and built once over a
    training loop whose C tensors are new at every step."""
    k = y.shape[0]
    plan = sparse_group_plan(sparse_plan(line, itemsize, y.nnz / max(k, 1)),
                             itemsize, members, shared, transposed)
    if not plan.staged:
        return plan, None
    items = group_items(plan, itemsize, _SPARSE_ITEMS, sms, members)
    key = ("k11", bool(transposed), plan.panel, k, items, plan.members)
    if key not in p.plans:
        with structure_only():
            p.plans[key] = sampled_runs(p.indptr, p.indices, transposed,
                                        plan.panel, k, items)
    return plan, p.plans[key]


def csr_spgemm_sparse_sddmm_plain(a_indptr, a_indices, a_data, b_indptr,
                                  b_indices, b_data, c_indptr, c_indices, g,
                                  n, transposed=False, triangular=False):
    """K11's function in plain PyTorch, read as the JAX package's autodiff
    reads the ESC product: every product a(i, k) b(k, j) expanded
    (``spgemm.products``), its entry of C found by ``searchsorted`` on the
    keys row * n + col, and G there times conj(b) added onto op(A)'s entry
    (dA form), or conj(a) times G onto op(B)'s (dB form, ``transposed``),
    by ``index_add_``; chunked as ``spgemm_plain``.  A product whose entry
    C lacks adds nothing."""
    return _sparse_plain(a_indptr, a_indices, a_data, b_indptr, b_indices,
                         b_data, c_indptr, c_indices, g, n, transposed,
                         triangular, ())


def csr_spgemm_sparse_sddmm_batched_plain(a_indptr, a_indices, a_data,
                                          b_indptr, b_indices, b_data,
                                          c_indptr, c_indices, g, n,
                                          transposed=False,
                                          triangular=False):
    """``sparse_sampled_batched`` in plain PyTorch: K11's function for each
    member of ``a_data``, ``b_data`` and ``g`` (each (B, nnz) or shared
    (nnz,), at least one with the member dimension), vectorised over the
    members; (B, nnz(P))."""
    size = batch_size("csr_spgemm_sparse_sddmm",
                      ((a_data, 1), (b_data, 1), (g, 1)))
    return _sparse_plain(a_indptr, a_indices, a_data, b_indptr, b_indices,
                         b_data, c_indptr, c_indices, g, n, transposed,
                         triangular, (size,))


def _sparse_plain(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data,
                  c_indptr, c_indices, g, n, transposed, triangular, lead):
    """``csr_spgemm_sparse_sddmm_plain`` with an output of leading shape
    ``lead``: () for one product, (B,) for a batch's members."""
    from .spgemm import _row_chunks, products, row_bounds

    out = torch.zeros((*lead, (b_indices if transposed else
                               a_indices).numel()),
                      dtype=g.dtype, device=g.device)
    if c_indices.numel() == 0:
        return out
    c_keys = (expand_indptr(c_indptr.long(), c_indices.numel()) * n
              + c_indices.long())
    last = c_keys.numel() - 1
    a_rows = expand_indptr(a_indptr.long(), a_indices.numel())
    for r0, r1 in _row_chunks(row_bounds(a_indptr, a_indices, b_indptr),
                              lead[0] if lead else 1):
        p, q, rows, cols = products(a_indptr, a_indices, b_indptr, b_indices,
                                    a_rows, r0, r1, triangular)
        key = rows * n + cols
        at = torch.searchsorted(c_keys, key).clamp_(max=last)
        found = c_keys[at] == key
        p, q, at = p[found], q[found], at[found]
        if transposed:
            ids, prods = q, a_data[..., p].conj() * g[..., at]
        else:
            ids, prods = p, g[..., at] * b_data[..., q].conj()
        _add_rows(out, ids, prods.expand(*lead, -1), dim=len(lead))
    return out


def csr_spgemm_sparse_sddmm(a_indptr, a_indices, a_data, b_indptr,
                            b_indices, b_data, c_indptr, c_indices, g, n,
                            transposed=False, triangular=False):
    """K11's function (the comment above) for op(A) = (``a_indptr``,
    ``a_indices``, ``a_data``) of m rows, op(B) = (``b_indptr``,
    ``b_indices``, ``b_data``) of n columns, and G as values ``g`` on C =
    op(A) @ op(B)'s pattern (``c_indptr``, ``c_indices``; each row's
    columns ascending, as ``spgemm.csr_spgemm`` writes them): the dA form,
    an (nnz(op(A)),) tensor in op(A)'s stored order, or with
    ``transposed`` the dB form, (nnz(op(B)),) in op(B)'s.  The dA form
    reads no ``a_data``, the dB form no ``b_data``.  Not differentiable
    itself (``ops.autograd.CsrSpgemmSparseSddmm`` is): it raises on a
    tracked operand (``csr.refuse_tracked``), on both devices."""
    refuse_tracked("csr_spgemm_sparse_sddmm", a_data, b_data, g)
    return sparse_sampled(a_indptr, a_indices, a_data, b_indptr, b_indices,
                          b_data, c_indptr, c_indices, g, n, transposed,
                          triangular)


def sparse_sampled(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data,
                   c_indptr, c_indices, g, n, transposed=False,
                   triangular=False, a=None, b=None, c=None):
    """``csr_spgemm_sparse_sddmm`` without the tracked check, for the
    Function's forward: K11 on the card, the plain version on the CPU;
    counted in ``csr_spgemm_sparse_sddmm.launches``.  ``a``, ``b`` and
    ``c`` are op(A)'s, op(B)'s and C's ``CsrPattern``s (op(A)'s holds the
    cached transpose the dB form reads); when None, the ones
    ``autograd.patterns`` holds for these index tensors (C's: a new one).
    On either device it raises ``ValueError`` where the operands do not
    fit (``_check_sparse_ids``)."""
    refuse_views("csr_spgemm_sparse_sddmm", a_indptr, a_indices, a_data,
                 b_indptr, b_indices, b_data, c_indptr, c_indices, g)
    a, b, c = _sparse_patterns(a_indptr, a_indices, b_indptr, b_indices,
                               c_indptr, c_indices, n, a, b, c)
    _check_sparse_ids(a, a_data, b, b_data, c, g)
    if g.device.type == "cpu":
        return csr_spgemm_sparse_sddmm_plain(
            a_indptr, a_indices, a_data, b_indptr, b_indices, b_data,
            c_indptr, c_indices, g, n, transposed, triangular)
    if not g.is_cuda:
        raise ValueError(f"csr_spgemm_sparse_sddmm: no kernel for device "
                         f"{g.device}")
    _check("csr_spgemm_sparse_sddmm",
           (a_indptr, a_indices, b_indptr, b_indices, c_indptr, c_indices),
           (a_data, b_data, g))
    out = torch.empty((b if transposed else a).nnz, dtype=g.dtype,
                      device=g.device)
    if out.numel() == 0:
        return out
    rec, p, *y = _k11_record(a, a_data, b, b_data, g, n, transposed)
    _k11_launch(rec, p, *y, c, g, out, transposed, triangular, 1,
                (0, 0, 0), 0, _build.stream_of(g))
    return out


def sparse_sampled_batched(a_indptr, a_indices, a_data, b_indptr, b_indices,
                           b_data, c_indptr, c_indices, g, n,
                           transposed=False, triangular=False, a=None,
                           b=None, c=None):
    """K11 for a batch of members that share op(A)'s, op(B)'s and C's
    patterns: member i is K11's function of op(A)'s values ``a_data[i]``,
    op(B)'s ``b_data[i]`` and G's ``g[i]``, each (B, nnz) or (nnz,)
    shared, at least one with the member dimension, each member
    contiguous; an operand without it (or expanded along it) is read in
    place by every member (the dB form's op(A)^T values are gathered once
    for the batch, ``a_data[..., order]``).  Returns a new (B, nnz(P))
    tensor, P = op(A) (dA) or op(B) (dB).  One launch on the card (one per
    ``_build.MAX_MEMBERS`` members) on the plan of ``group_plan``: staged
    on the runs cached on P's pattern, a group of members a block where
    they share Y's values, or in place; counted in
    ``csr_spgemm_sparse_sddmm.launches`` and ``launches_batched``.  The
    batched plain version on the CPU.  ``a``, ``b``, ``c`` and the checks
    as in ``sparse_sampled``."""
    refuse_views("csr_spgemm_sparse_sddmm", a_indptr, a_indices, a_data,
                 b_indptr, b_indices, b_data, c_indptr, c_indices, g)
    operands = ((a_data, 1), (b_data, 1), (g, 1))
    size = batch_size("csr_spgemm_sparse_sddmm", operands)
    a, b, c = _sparse_patterns(a_indptr, a_indices, b_indptr, b_indices,
                               c_indptr, c_indices, n, a, b, c)
    _check_sparse_ids(a, a_data, b, b_data, c, g, batched=True)
    if g.device.type == "cpu":
        return csr_spgemm_sparse_sddmm_batched_plain(
            a_indptr, a_indices, a_data, b_indptr, b_indices, b_data,
            c_indptr, c_indices, g, n, transposed, triangular)
    if not g.is_cuda:
        raise ValueError(f"csr_spgemm_sparse_sddmm: no kernel for device "
                         f"{g.device}")
    *_, s_g = check_members(
        "csr_spgemm_sparse_sddmm",
        (a_indptr, a_indices, b_indptr, b_indices, c_indptr, c_indices),
        operands, views=False)
    nnz = (b if transposed else a).nnz
    out = torch.empty((size, nnz), dtype=g.dtype, device=g.device)
    if nnz == 0 or size == 0:
        return out
    rec, p, *y = _k11_record(a, a_data, b, b_data, g, n, transposed, size,
                             s_g == 0)
    strides = (member_stride("csr_spgemm_sparse_sddmm", y[2], 1), s_g, nnz)
    stream = _build.stream_of(g)
    for first, count in member_chunks(size):
        _k11_launch(rec, p, *y, c, g, out, transposed, triangular, count,
                    strides, first, stream)
        csr_spgemm_sparse_sddmm.launches_batched += 1
    return out


def _sparse_patterns(a_indptr, a_indices, b_indptr, b_indices, c_indptr,
                     c_indices, n, a, b, c):
    """op(A)'s, op(B)'s and C's ``CsrPattern``s: ``a``, ``b`` and ``c``,
    or where None the ones ``autograd.patterns`` holds for these index
    tensors (C's: a new one)."""
    from .autograd import patterns

    k = b_indptr.numel() - 1
    if a is None:
        a = patterns.get(a_indptr, a_indices, k)
    if b is None:
        b = patterns.get(b_indptr, b_indices, n)
    if c is None:
        c = CsrPattern(c_indptr, c_indices, n)
    return a, b, c


def _k11_record(a, a_data, b, b_data, g, n, transposed, size=1,
                shared_g=False):
    """(``SampledRecord``, P, Y's indptr, indices and values) of a K11
    launch of ``size`` members for op(A), op(B) and their
    ``CsrPattern``s ``a``, ``b``, G shared by the members or not
    (``shared_g``): P is op(A) with Y = op(B) (dA), or op(B) with Y =
    op(A)^T (dB, its values gathered from ``a_data`` through op(A)'s
    cached transpose, once for the batch).  Where the plan gives a block
    a group of members, Y's rows come in ``bank_order``, the members'
    shared values gathered once in that order (in the dB form through
    both orders, composed once per pattern).  The record
    (``sparse_schedule``'s plan and runs, the type codes, (ne, ny)) is
    cached on P's pattern, keyed on all that the plan and the runs depend
    on."""
    if transposed:
        p, (y, order) = b, a.transpose()
        src = a_data
    else:
        p, y, order, src = a, b, None, b_data
    m = a.shape[0]
    shared = (bool(shared_g), src.dim() == 1 or src.stride(0) == 0)
    key = ("k11-launch", bool(transposed), m, n, y.shape[0], y.nnz, g.dtype,
           a.indptr.dtype, g.device, size, *shared)
    rec = p.plans.get(key)
    if rec is None:
        sms = torch.cuda.get_device_properties(
            g.device).multi_processor_count
        plan, runs = sparse_schedule(p, y, m if transposed else n,
                                     g.element_size(), transposed, sms,
                                     size, shared)
        rec = SampledRecord(plan, runs, _build.type_codes(g, a.indptr),
                            (n, m) if transposed else (m, n))
        p.plans[key] = rec
    if rec.plan.members == 1:
        return (rec, p, y.indptr, y.indices,
                src if order is None else src[..., order])
    bank, y_indices = bank_order(y, g.element_size())
    if order is not None:
        gather = ("bank-gather", g.element_size())
        if gather not in y.plans:
            y.plans[gather] = order[bank]
        bank = y.plans[gather]
    return rec, p, y.indptr, y_indices, _bank_values(src, bank)


def _k11_launch(rec, p, y_indptr, y_indices, y_data, c, g, out, transposed,
                triangular, count, strides, first, stream):
    """One launch of K11 on ``rec`` (``_k11_record``) for ``count``
    members from ``first`` at ``strides`` (Y's values, G, the output):
    staged on the record's runs, a group of members a block where the
    plan says so and the launch has 2 or more, or one member a block,
    staged or in place; counted in
    ``csr_spgemm_sparse_sddmm.launches``."""
    plan, runs = rec.plan, rec.runs
    args = (y_indptr.data_ptr(), y_indices.data_ptr(),
            member_ptr(y_data, strides[0], first), c.indptr.data_ptr(),
            c.indices.data_ptr(), member_ptr(g, strides[1], first),
            member_ptr(out, strides[2], first), int(transposed),
            int(triangular), plan.lanes, count)
    # The runs' arrays, or null pointers where lines are read in place.
    staged = (0,) * 6 if runs is None else (
        runs.items.data_ptr(), runs.items.numel() - 1,
        runs.run_ptr.data_ptr(), runs.run_q.data_ptr(),
        runs.perm.data_ptr(), runs.line.data_ptr())
    if plan.members > 1 and count > 1:
        _build.launch("sdt_csr_spgemm_sparse_sddmm_group", *rec.codes,
                      *staged, *rec.dims, plan.panel, plan.pitch, *args,
                      strides[1], strides[2], plan.members, stream)
    else:
        _build.launch("sdt_csr_spgemm_sparse_sddmm", *rec.codes, *staged,
                      *rec.dims, plan.panel, plan.pitch, int(plan.staged),
                      p.indptr.data_ptr(), p.indices.data_ptr(), p.shape[0],
                      *args, *strides, stream)
    csr_spgemm_sparse_sddmm.launches += 1


def _check_sparse_ids(a, a_data, b, b_data, c, g, batched=False):
    """Raises ``ValueError`` where K11's operands do not fit: op(A)'s
    column ids outside op(B)'s k rows, op(B)'s or C's outside the n
    columns, C's rows other than op(A)'s m, or a value tensor whose length
    (each member's, ``batched``) is not its pattern's nnz.  The ids'
    spans are read once per pattern."""
    (m, k), n = a.shape, b.ncols
    if b.shape[0] != k or c.shape != (m, n):
        raise ValueError(
            f"csr_spgemm_sparse_sddmm: op(A) {a.shape}, op(B) {b.shape} "
            f"and C {c.shape} do not fit")
    for what, data, name, pat in (("op(A)'s values", a_data, "op(A)", a),
                                  ("op(B)'s values", b_data, "op(B)", b),
                                  ("G", g, "C", c)):
        if data.dim() not in ((1, 2) if batched else (1,)) or \
                data.shape[-1] != pat.nnz:
            raise ValueError(
                f"csr_spgemm_sparse_sddmm: {what} {tuple(data.shape)} do "
                f"not fit the {pat.nnz} entries of {name}")
        lo, hi = pat.column_span()
        if lo < 0 or hi > pat.ncols:
            raise ValueError(
                f"csr_spgemm_sparse_sddmm: {name}'s column ids span "
                f"[{lo}, {hi}), outside its {pat.ncols} columns")


csr_spgemm_sparse_sddmm.launches = 0
csr_spgemm_sparse_sddmm.launches_batched = 0
