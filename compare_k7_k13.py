#!/usr/bin/env python3
"""Side-by-side timings of batched K1, K2, K5, K6, K7, K9 and K11, of K13
and of complex K1 and K8 on one NVIDIA GPU.

Run from the root of a checkout, on a machine with the card:

    python3 compare_k7_k13.py schedules        # batched K7's schedules
    python3 compare_k7_k13.py members          # members a group, by type
    python3 compare_k7_k13.py rows [--root DIR]
    python3 compare_k7_k13.py route [--root DIR]
    python3 compare_k7_k13.py groups           # batched K9/K11 groups
    python3 compare_k7_k13.py sampled [--root DIR]
    python3 compare_k7_k13.py walls [--root DIR]
    python3 compare_k7_k13.py bsr [--root DIR]
    python3 compare_k7_k13.py bsr_gate         # dense x complex BSR routes
    python3 compare_k7_k13.py plain_cpu [--root DIR]   # no card needed
    python3 compare_k7_k13.py k2k5 [--root DIR]        # batched K2/K5 groups
    python3 compare_k7_k13.py k5 [--root DIR]          # K5's half alone
    python3 compare_k7_k13.py k4k5 [--root DIR]        # K4, K5, K4 + K5
    python3 compare_k7_k13.py sorted                   # sorted-bin variants
    python3 compare_k7_k13.py block                    # K4's block count
    python3 compare_k7_k13.py k6k1 [--root DIR]        # batched K6/K1 groups
    python3 compare_k7_k13.py k6_banks                 # no card needed

``schedules`` times batched K7 at config 1 (f64, n = 128, 16 members) as
one launch with spans sized over all members' entries, with spans that
fill whole waves of the card and as four launches of 4, beside 16 single
launches and cuSPARSE's batched SDDMM; then B shared and G shared
(``k7_batch_diagnosis``).  ``members`` times K7 with B shared by 16 G's
at config 1 (n = 128) in each value type and index width, the kernel
forced to 1 (the per-member kernel), 2 and 4 members a group, beside the
wrapper's own choice (``members_by_type``).  ``rows`` prints K13's and
batched K7's phase-4 rows (``chip_smoke.k13_rows``,
``chip_smoke.k7_batched_rows``); with ``--root DIR`` it times the package
of the checkout at DIR instead of this one, so that two checkouts are
compared by running this script for each in turns (parent, change,
change, parent).  ``route`` times the structural densify route at case a
host to host (``route_rows``), with ``--root DIR`` the package at DIR
too, imported beside this one, both in the same turns.  ``groups``
times batched K9 and K11 (4 G's, values shared, both forms) at one
member a block and at groups of 2 and 4, and the group of 4 with Y's
rows in column order, beside the rule's launch and the 4 single
launches, in each value type and index width and at rows of Y short
enough for 2 and 8 lanes (``group_sweep``).  ``sampled`` times batched
K9 and K11 (case a, K11 also at case c, and ensembles with per-member
values) beside the same members' single launches, by events, on the
device and on the host (``sampled_turns``); with ``--root DIR`` the
package at DIR too, in the same turns.  ``walls`` times the ``vmap``
transforms of ``chip_smoke.py``'s phase 6 that run K7, K9 and K11 host
to host, with ``--root DIR`` the package at DIR too, in alternating
turns (``vmap_walls``).  ``bsr`` times K1 and K8 at phase 3's complex
BSR in c128 and c64 beside the CUDA-core variants launched directly, with
``--root DIR`` the package at DIR too, in the same turns
(``bsr_turns``).  ``bsr_gate`` times dense x BSR at that BSR's shape at
several densities of blocks on K1 and on the densify route, beside the
gate's choice (``bsr_gate``).  ``plain_cpu`` times the plain K1 on the
CPU at that BSR, with ``--root DIR`` the package at DIR's too, in turns
(``plain_cpu``); it is the one mode that runs without a card.  ``k2k5``
times batched K2 (b shared) and batched K5 at 1, 2 and 4 members a
block beside the wrappers' choice and the single launches, K2 at config
1 in each value type and index width and at the 1M^2 SpMV matrix, K5 at
case c and at a product of hash-bin rows (``k2_group_sweep``,
``k5_group_sweep``; ``k5`` the K5 half alone), with ``--root DIR`` the
package at DIR's wrappers too, in the same turns.  ``k4k5`` times K4,
K4 with its plan, K5 and K4 + K5 as one product beside
``torch.sparse.mm`` at phase 4's sparse-output cases (a, c, d, h, hb,
hc), and batched K5 over 4 value sets at cases c, h and hb beside 4 x
``torch.sparse.mm``, with ``--root DIR`` the package at DIR's wrappers
too, in the same turns, C checked bit for bit against DIR's
(``k4k5_turns``).  ``sorted`` times K4, K5 and
batched K5 at case h and at a 100,000^2 Poisson(16) A @ A beside two
variants of the sorted-product bins built from copies of the package
under ``build/`` (keys sorted in shared memory; every row sorting its
bin's U keys; the bin of 512 alone sorting its 512 keys) in the same
turns (``sorted_variants``).  ``block`` times K4 at cases hb and hc
beside a copy of the package under ``build/`` whose block-sorted bins
count the heads of the sort in place of a table (``block_variants``).  ``k6k1`` times
batched K6 at case a (op(A)'s values per member in every value type and
index width at 4, 8 and 16 sets, op(B)'s over 4, c0's over 4) and
batched K1 at config 3 (f64 and f32, 4 block sets, b shared) at 1, 2
and 4 members a block (K6 also on two windows, and in f64 beside a
conflict-free stand-in of its group kernel built from a copy of the
package under ``build/``, with the SM clock read; K1 also on 32-row
tiles, from another such copy) beside the wrappers' choice and the
single launches (``k6_group_sweep``, ``k1_group_sweep``; ``k1`` and
``k6`` each half alone), with ``--root DIR`` the package at DIR's wrappers
too, in the same turns.  ``k6_banks`` counts, from the demo X alone
(no card needed), the shared-memory wavefronts of K6's sum updates a
member-product in the per-member kernel's layout and in its groups'
(``k6_banks``).  Each mode
prints one JSON line, also written to
``--out`` when given.  The helpers (timing in turns after a 1 GiB read,
the plain versions' comparison, the inputs) are ``chip_smoke.py``'s.
"""

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

import chip_smoke
from chip_smoke import (REPS, SEED, SIZES, batched_sddmm_library, compare,
                        cuda, spread, time_turns, values)

# Blocks of K7's span kernel that one wave of the card holds: 132 SMs,
# 8 blocks of 4 warps each (``csrc/csr_sddmm.cu``, kSpanBlocks).
K7_WAVE_BLOCKS = 132 * 8


def k7_batch_diagnosis(inputs, rng, size=16):
    """Batched K7 at config 1 (f64, n = 128) over ``size`` (G, B) pairs,
    three schedules of the same launch timed in the same turns: the
    parent's (spans sized over all members' entries, capped at 512, a
    ragged last wave), spans sized so that the groups fill a whole number
    of waves, and ``member_chunks(size, 4)`` (launches of 4 members); beside
    them the wrapper's own call, the ``size`` single launches and batched
    cuSPARSE.  Then ``size`` G's with B shared: the wrapper's call, the
    single launches and cuSPARSE given B expanded.  Each schedule's blocks
    and waves are in the row.  With B shared also the shared kernel forced
    to 1, 2 and 4 members a group and 1 or 2 loads a lane (the wrapper
    picks by ``shared_members``); with G shared the swapped roles, the
    per-member kernel, the single launches and cuSPARSE given G
    expanded."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import sddmm
    from sparse_dot_tpu_torch.ops.csr import member_chunks

    n1 = SIZES["config1"]
    A1 = formats.to_device(inputs["a1"])
    ip, ix, _ = A1.csr_arrays()
    nnz = ix.numel()
    g = cuda(values(rng, (size, n1, 128), np.float64))
    bb = cuda(values(rng, (size, n1, 128), np.float64))
    out = torch.empty((size, nnz), dtype=g.dtype, device="cuda")
    strides = (g.stride(0), bb.stride(0), nnz)
    base = sddmm.sddmm_schedule(128, g.dtype, size * nnz)
    per_block = 128 // base.lanes

    def blocks(span, members):
        groups = -(-nnz // span)
        return members * -(-groups // per_block)

    waves = -(-blocks(base.span, size) // K7_WAVE_BLOCKS)
    span_w = -(-nnz // (waves * K7_WAVE_BLOCKS // size * per_block))
    whole = base._replace(span=span_w)

    def launch(s, most=None):
        def run():
            for first, count in member_chunks(size, most):
                sddmm._launch_k7(
                    ip, ix, s, None, count, strides,
                    *(t.data_ptr() + first * st * t.element_size()
                      for t, st in zip((g, bb, out), strides)), g)
            return out
        return run

    want = sddmm.csr_sddmm_batched_plain(ip, ix, g, bb)
    fns = {"parent_schedule": launch(base),
           "whole_waves": launch(whole),
           "4_launches_of_4": launch(base, 4),
           "wrapper": lambda: sddmm.sddmm_batched(ip, ix, g, bb),
           f"{size}_single_launches": lambda: [
               sddmm.csr_sddmm(ip, ix, g[i], bb[i]) for i in range(size)]}
    errs = {}
    for name in ("parent_schedule", "whole_waves", "4_launches_of_4",
                 "wrapper"):
        errs[name] = compare(fns[name]().clone(), want, g.dtype)
    lib, note = batched_sddmm_library(ip, ix, g, bb, A1.shape)
    if lib is not None:
        fns["library"] = lib
    for fn in fns.values():
        fn()
    times = time_turns(fns, REPS)
    per_member = {"shape": f"config1 CSR f64 {n1}x{n1} 1%, {size} (G, B) "
                           "pairs of (10000,128)",
                  "max_abs_err": errs, "library": note,
                  "schedules": {
                      "parent_schedule": {"span": base.span, "blocks": blocks(
                          base.span, size), "waves": blocks(
                          base.span, size) / K7_WAVE_BLOCKS},
                      "whole_waves": {"span": span_w, "blocks": blocks(
                          span_w, size), "waves": blocks(
                          span_w, size) / K7_WAVE_BLOCKS},
                      "4_launches_of_4": {"span": base.span, "blocks": blocks(
                          base.span, 4), "waves": blocks(
                          base.span, 4) / K7_WAVE_BLOCKS, "launches": 4}},
                  "ms": {k: dict(zip(("ms", "p10", "p90"), spread(t)))
                         for k, t in times.items()}}
    del out, want
    b0 = bb[0]
    want = sddmm.csr_sddmm_batched_plain(ip, ix, g, b0)
    out = torch.empty((size, nnz), dtype=g.dtype, device="cuda")
    fns = {"wrapper": lambda: sddmm.sddmm_batched(ip, ix, g, b0),
           f"{size}_single_launches": lambda: [
               sddmm.csr_sddmm(ip, ix, g[i], b0) for i in range(size)]}
    # The shared kernel's members a group and strips a lane, forced, and
    # the per-member kernel.
    variants = {}
    shared_strides = (g.stride(0), 0, nnz)
    for members, per_lane in ((1, 2), (2, 2), (2, 1), (4, 2), (4, 1)):
        load = per_lane * base.vec * g.element_size()
        groups = -(-size // members)
        vs = base._replace(
            per_lane=per_lane,
            round=(sddmm.round_entries(base.lanes, load) if members == 1
                   else sddmm.shared_round(base.lanes, load, members)),
            span=sddmm.sddmm_schedule(128, g.dtype, groups * nnz).span)
        variants[f"members_{members}_per_lane_{per_lane}"] = vs

        def run(vs=vs, members=members):
            sddmm._launch_k7(ip, ix, vs, None, size, shared_strides,
                             g.data_ptr(), b0.data_ptr(), out.data_ptr(),
                             g, members)
            return out
        fns[f"members_{members}_per_lane_{per_lane}"] = run
    errs = {name: compare(fn().clone(), want, g.dtype)
            for name, fn in fns.items() if not name.endswith("launches")}
    lib, note = batched_sddmm_library(ip, ix, g, b0, A1.shape)
    if lib is not None:
        fns["library_b_expanded"] = lib
    lib, _ = batched_sddmm_library(
        ip, ix, g, b0.expand(size, -1, -1).contiguous(), A1.shape)
    if lib is not None:
        fns["library_b_copied"] = lib
    for fn in fns.values():
        fn()
    times = time_turns(fns, REPS)
    shared_b = {"shape": f"config1 CSR f64 {n1}x{n1} 1%, {size} G's of "
                         "(10000,128), B shared", "max_abs_err": errs,
                "library": note,
                "wrapper_schedule": list(sddmm.batched_schedule(
                    128, g.dtype, nnz, size, shared_strides[:2])[0]),
                "wrapper_members": sddmm.batched_schedule(
                    128, g.dtype, nnz, size, shared_strides[:2])[1],
                "variants": {k: list(v) for k, v in variants.items()},
                "ms": {k: dict(zip(("ms", "p10", "p90"), spread(t)))
                       for k, t in times.items()}}
    del want
    # G shared, B per member: the roles swapped on A's transpose.
    g0 = g[0]
    transpose = formats.CsrPattern(ip, ix, n1).transpose
    want = sddmm.csr_sddmm_batched_plain(ip, ix, g0, bb)
    t, order = transpose()
    swapped = sddmm.sddmm_batched(t.indptr, t.indices, bb, g0)
    back = torch.empty_like(order)
    back[order] = torch.arange(order.numel(), device="cuda")
    fns = {"wrapper_swapped": lambda: sddmm.sddmm_batched(ip, ix, g0, bb,
                                                          None, transpose),
           "swapped_launch_alone": lambda: sddmm.sddmm_batched(
               t.indptr, t.indices, bb, g0),
           "gather_alone": lambda: swapped.index_select(-1, back),
           "per_member_kernel": lambda: sddmm.sddmm_batched(ip, ix, g0, bb),
           f"{size}_single_launches": lambda: [
               sddmm.csr_sddmm(ip, ix, g0, bb[i]) for i in range(size)]}
    errs = {name: compare(fns[name](), want, g.dtype)
            for name in ("wrapper_swapped", "per_member_kernel")}
    lib, note = batched_sddmm_library(
        ip, ix, g0.expand(size, -1, -1).contiguous(), bb, A1.shape)
    if lib is not None:
        fns["library_g_copied"] = lib
    for fn in fns.values():
        fn()
    times = time_turns(fns, REPS)
    del swapped, back
    shared_g = {"shape": f"config1 CSR f64 {n1}x{n1} 1%, {size} B's of "
                         "(10000,128), G shared", "max_abs_err": errs,
                "library": note,
                "ms": {k: dict(zip(("ms", "p10", "p90"), spread(t)))
                       for k, t in times.items()}}
    return {"per_member": per_member, "shared_b": shared_b,
            "shared_g": shared_g}


# The value types and index widths of ``members_by_type``.
MEMBER_TYPES = ((torch.float32, torch.int32), (torch.float64, torch.int32),
                (torch.float64, torch.int64), (torch.complex64, torch.int32),
                (torch.complex128, torch.int32),
                (torch.complex128, torch.int64))


def members_by_type(inputs, rng, size=16, n=128):
    """K7 with B shared by ``size`` G's at config 1's pattern (n columns)
    in each of ``MEMBER_TYPES``: the kernel forced to 1 (the per-member
    kernel), 2 and 4 members a group, and the wrapper's call, each held
    against the plain version and timed in the same turns."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import sddmm

    n1 = SIZES["config1"]
    ip32, ix32, _ = formats.to_device(inputs["a1"]).csr_arrays()
    nnz = ix32.numel()
    result = {}
    for tdt, itype in MEMBER_TYPES:
        ip, ix = ip32.to(itype), ix32.to(itype)
        npdt = chip_smoke.NP_DTYPES[tdt]
        g = cuda(values(rng, (size, n1, n), npdt))
        b0 = cuda(values(rng, (n1, n), npdt))
        out = torch.empty((size, nnz), dtype=tdt, device="cuda")
        base = sddmm.sddmm_schedule(n, tdt, size * nnz)
        load = base.per_lane * base.vec * tdt.itemsize
        fns = {"wrapper": lambda: sddmm.sddmm_batched(ip, ix, g, b0)}
        for members in (1, 2, 4):
            if members == 1:
                s = base
            else:
                e = sddmm.shared_round(base.lanes, load, members)
                if e * members > base.lanes:
                    continue
                s = base._replace(round=e, span=sddmm.sddmm_schedule(
                    n, tdt, -(-size // members) * nnz).span)

            def run(s=s, members=members):
                sddmm._launch_k7(ip, ix, s, None, size,
                                 (g.stride(0), 0, nnz), g.data_ptr(),
                                 b0.data_ptr(), out.data_ptr(), g, members)
                return out
            fns[f"members_{members}"] = run
        want = sddmm.csr_sddmm_batched_plain(ip, ix, g, b0)
        errs = {name: compare(fn().clone(), want, tdt)
                for name, fn in fns.items()}
        del want
        times = time_turns(fns, REPS)
        result[f"{tdt} {itype}"] = {
            "schedule": list(base),
            "wrapper_members": sddmm.batched_schedule(
                n, tdt, nnz, size, (g.stride(0), 0), True,
                ix.element_size())[1],
            "max_abs_err": errs,
            "ms": {k: dict(zip(("ms", "p10", "p90"), spread(t)))
                   for k, t in times.items()}}
        del g, b0, out
        torch.cuda.empty_cache()
    return {"shape": f"config1 CSR {n1}x{n1} 1%, {size} G's of ({n1},{n}), "
                     "B shared", "by_type": result}


def host_times(fns, reps=50):
    """{name: the ``reps`` times in ms of ``fns[name]()``} host to host (a
    sync before and after), the calls taken in turns."""
    times = {name: [] for name in fns}
    for fn in fns.values():
        fn()
    for _ in range(reps):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return times


def load_package(root, name):
    """The package of the checkout at ``root`` imported as module ``name``
    (its modules import one another relatively), beside this checkout's;
    its kernels are built from its own sources."""
    import importlib.util

    init = os.path.join(os.path.abspath(root), "sparse_dot_tpu_torch",
                        "__init__.py")
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[os.path.dirname(init)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def route_rows(packages, reps=100):
    """The structural densify route at case a (the demo X @ X.T, f64) host
    to host, for each of ``packages`` ({label: module name}) in the same
    turns: ``dot_product(X, X.T)`` from scipy to scipy, and the route
    (``ops.host.densified_sparse_product``) on a device container with no
    planes kept (K12, its indicator, two ``torch.matmul``, K13, the host
    read) and with them kept (K13 and the host read), each held against
    scipy."""
    import importlib

    x = chip_smoke.demo_x()
    want = (x @ x.T).toarray()
    fns = {}
    for label, name in packages.items():
        sdt = importlib.import_module(name)
        config = importlib.import_module(f"{name}.config").config
        host = importlib.import_module(f"{name}.ops.host")
        A = sdt.formats.to_device(x)

        def route(kept, A=A, config=config, host=host):
            def run():
                cache = config.spgemm_plane_cache
                config.spgemm_plane_cache = kept
                try:
                    return host.densified_sparse_product(A, A.T,
                                                         torch.float64)
                finally:
                    config.spgemm_plane_cache = cache
            return run

        fns[f"{label}: dot_product_x_xT"] = (
            lambda sdt=sdt: sdt.dot_product(x, x.T))
        fns[f"{label}: route_no_planes_kept"] = route(False)
        fns[f"{label}: route_planes_kept"] = route(True)
    errs = {}
    for name, fn in fns.items():
        got = fn()
        # scipy's result, or the route's device CSR.
        got = (got.toarray() if hasattr(got, "toarray")
               else got.to_dense().cpu().numpy())
        errs[name] = float(np.abs(got - want).max())
    times = host_times(fns, reps)
    # Each call's turns won by each package, where two are timed.
    first, *others = packages
    wins = {}
    for other in others:
        for call in ("dot_product_x_xT", "route_no_planes_kept",
                     "route_planes_kept"):
            mine, theirs = (np.array(times[f"{label}: {call}"])
                            for label in (first, other))
            wins[call] = {first: int((mine < theirs).sum()),
                          other: int((theirs < mine).sum())}
    return {"shape": "case a: demo X @ X.T, 500 x 5000 21.2% f64",
            "packages": packages, "max_abs_err_vs_scipy": errs,
            "ms": {name: dict(zip(("ms", "p10", "p90"), spread(t)))
                   for name, t in times.items()},
            "turns_won": wins}


SAMPLED_DEVICE_NAMES = ("sampled_kernel", "sampled_group_kernel",
                        "sparse_in_place_kernel")
# ``group_sweep``'s settings: (value type, index type, density of a
# 500 x 5000 X, None: the demo X itself, 21.2%): case a in f64, f32 and
# c128 with int32 ids and in f64 and c128 with int64 ids, then X at 0.7%
# (rows of Y of ~3.5 entries: 2 lanes), 1.2% (~6: 4 lanes) and 2% (~10:
# 8 lanes).
SWEEP_SETTINGS = ((np.float64, np.int32, None), (np.float32, np.int32, None),
                  (np.complex128, np.int32, None),
                  (np.float64, np.int64, None),
                  (np.complex128, np.int64, None),
                  (np.float64, np.int32, 0.007), (np.float64, np.int32, 0.012),
                  (np.float64, np.int32, 0.02))
# The group sizes a launch may take at each point (``_GROUP_SIZES``, at
# any number of lanes): one member a block, 2, 4.
SWEEP_POINTS = {"members 1": (), "members 2": (2,), "members 4": (4,)}


def sampled_cases(sdt, inputs, rng, size=4):
    """The operands of batched K9 and K11 at case a (the demo X @ X.T,
    f64) and K11 at case c (the 1M² A @ A), both forms, ``size`` G's
    with the values shared, and at case a also an ensemble (G and the
    values per member): {name: (kernel, args, P's arrays, Y's arrays)}
    (K11: (op(A)'s, op(B)'s and C's arrays), None), made with package
    ``sdt``'s containers."""
    x = inputs["x"]
    A, B = sdt.formats.to_device(x), sdt.formats.to_device(x.T)
    ip, ix, dv = A.csr_arrays()
    bip, bix, bdv = B.csr_arrays()
    n = x.shape[0]
    g = cuda(values(rng, (size, n, n), np.float64))
    pa = sdt.formats.CsrPattern(ip, ix, x.shape[1])
    t, order = pa.transpose()
    cases = {}
    for transposed in (False, True):
        form = "dB" if transposed else "dA"
        args = ((bip, bix, g, t.indptr, t.indices, dv[order].contiguous(),
                 None, True) if transposed
                else (ip, ix, g, bip, bix, bdv, None, False))
        cases[f"K9 a {form}"] = ("K9", args, args[:2], args[3:5])
    bv = bdv[None] * (1 + 0.1 * cuda(values(rng, (size, bix.numel()),
                                            np.float64)))
    cases["K9 a dA ensemble"] = ("K9", (ip, ix, g, bip, bix, bv, None,
                                        False), (ip, ix), (bip, bix))
    for case, a_np, b_np in (("a", x, x.T.tocsr()),
                             ("c", inputs["a1m"], inputs["a1m"])):
        Ad, Bd = sdt.formats.to_device(a_np), sdt.formats.to_device(b_np)
        a, b = Ad.csr_arrays(), Bd.csr_arrays()
        nn = b_np.shape[1]
        c = sdt.ops.spgemm.csr_spgemm(*a, *b, nn)[:2]
        gc = cuda(values(rng, (size, c[1].numel()), np.float64))
        for transposed in (False, True):
            form = "dB" if transposed else "dA"
            cases[f"K11 {case} {form}"] = (
                "K11", (*a, *b, *c, gc, nn, transposed), (a, b, c), None)
        if case == "a":
            bvs = b[2][None] * (1 + 0.1 * cuda(values(
                rng, (size, b[1].numel()), np.float64)))
            cases["K11 a dA ensemble"] = (
                "K11", (*a[:3], *b[:2], bvs, *c, gc, nn, False), (a, b, c),
                None)
    return cases


def sampled_fns(sdt, cases, size=4):
    """({name: fn} of each case's batched call and its ``size`` single
    launches, through package ``sdt`` with patterns made once, as the
    Functions hand them; {name: plain version} of the batched calls;
    {name: the pattern of P, on which the launch's record is cached})."""
    grad = sdt.ops.spgemm_grad
    fns, plain, owners = {}, {}, {}
    for name, (kernel, args, p_arr, y_arr) in cases.items():
        if kernel == "K9":
            transposed = args[7]
            d = args[2]
            ne = d.shape[-1] if transposed else args[3].numel() - 1
            ny = d.shape[-2] if transposed else d.shape[-1]
            pats = {"pattern": sdt.formats.CsrPattern(*p_arr, ne),
                    "y_pattern": sdt.formats.CsrPattern(*y_arr, ny)}
            y = args[5]
            owners[name] = pats["pattern"]

            def batched(args=args, pats=pats):
                return grad.sampled_batched(*args, **pats)

            def single(args=args, pats=pats, y=y):
                return [grad.sampled(*args[:2], args[2][i], *args[3:5],
                                     y[i] if y.dim() == 2 else y,
                                     *args[6:], **pats)
                        for i in range(size)]
            plain[name] = lambda args=args: (
                grad.csr_spgemm_sddmm_batched_plain(*args))
        else:
            a, b, c = p_arr
            nn = args[9]
            pats = {"a": sdt.formats.CsrPattern(a[0], a[1],
                                                b[0].numel() - 1),
                    "b": sdt.formats.CsrPattern(b[0], b[1], nn),
                    "c": sdt.formats.CsrPattern(c[0], c[1], nn,
                                                span=(0, nn))}
            owners[name] = pats["b"] if args[10] else pats["a"]

            def batched(args=args, pats=pats):
                return grad.sparse_sampled_batched(*args, **pats)

            def single(args=args, pats=pats):
                bv = args[5]
                return [grad.sparse_sampled(
                    *args[:5], bv[i] if bv.dim() == 2 else bv, *args[6:8],
                    args[8][i], *args[9:], **pats) for i in range(size)]
            plain[name] = lambda args=args: (
                grad.csr_spgemm_sparse_sddmm_batched_plain(*args))
        fns[name] = batched
        fns[f"{name}: {size} single launches"] = single
    return fns, plain, owners


def enqueue_times(fns, reps=25):
    """{name: the ``reps`` host times in ms of ``fns[name]()`` from an
    idle card until the call returns (its launches enqueued, not run)}."""
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times[name].append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return times


def timed_fns(fns, plain=None, reps=REPS):
    """Each fn timed in turns (``time_turns``: events, a 1 GiB read
    before each), its kernels' device time (``kernel_device_ms``), all
    its device work (``device_busy_ms``: gathers and fills too), its host
    enqueue time (``enqueue_times``) and, where ``plain`` has its name,
    its largest error against the plain version."""
    errs = {}
    for name, fn in fns.items():
        out = fn()
        if plain and name in plain:
            errs[name] = compare(out, plain[name](), out.dtype)
    times = time_turns(fns, reps)
    host = enqueue_times(fns)
    result = {}
    for name, fn in fns.items():
        ms, p10, p90 = spread(times[name])
        result[name] = {
            "ms": ms, "p10": p10, "p90": p90,
            "device_ms": chip_smoke.kernel_device_ms(
                fn, SAMPLED_DEVICE_NAMES),
            "device_all_ms": chip_smoke.device_busy_ms(fn),
            "host_enqueue_ms": spread(host[name])[0],
            "max_abs_err": errs.get(name)}
    return result


def sweep_cases(sdt, setting, rng, size=4):
    """``sampled_cases``' case a (K9 and K11, both forms, ``size`` G's,
    values shared) for a ``SWEEP_SETTINGS`` entry: X (the demo X, or a
    random 500 x 5000 X of that density) in that value type with ids of
    that index type."""
    import scipy.sparse as sps

    dtype, itype, density = setting
    x = chip_smoke.demo_x() if density is None else sps.random(
        500, 5000, density=density, format="csr", random_state=SEED + 28)
    x = sps.csr_matrix((values(rng, x.nnz, dtype), x.indices, x.indptr),
                       shape=x.shape)
    xt = x.T.tocsr()
    ip, ix, dv = (cuda(a.astype(t)) for a, t in (
        (x.indptr, itype), (x.indices, itype), (x.data, dtype)))
    bip, bix, bdv = (cuda(a.astype(t)) for a, t in (
        (xt.indptr, itype), (xt.indices, itype), (xt.data, dtype)))
    n = x.shape[0]
    g = cuda(values(rng, (size, n, n), dtype))
    t, order = sdt.formats.CsrPattern(ip, ix, x.shape[1]).transpose()
    cases = {}
    for transposed in (False, True):
        form = "dB" if transposed else "dA"
        args = ((bip, bix, g, t.indptr, t.indices, dv[order].contiguous(),
                 None, True) if transposed
                else (ip, ix, g, bip, bix, bdv, None, False))
        cases[f"K9 {form}"] = ("K9", args, args[:2], args[3:5])
    a, b = (ip, ix, dv), (bip, bix, bdv)
    c = sdt.ops.spgemm.csr_spgemm(*a, *b, n)[:2]
    gc = cuda(values(rng, (size, c[1].numel()), dtype))
    for transposed in (False, True):
        form = "dB" if transposed else "dA"
        cases[f"K11 {form}"] = ("K11", (*a, *b, *c, gc, n, transposed),
                                (a, b, c), None)
    return cases


def column_order(y, itemsize):
    """``bank_order``'s stand-in that keeps Y's rows in column order (the
    identity: Y's values are gathered as they lie)."""
    key = ("column", itemsize)
    if key not in y.plans:
        y.plans[key] = (torch.arange(y.nnz, device=y.indices.device),
                        y.indices)
    return y.plans[key]


def group_sweep(rng, size=4):
    """Batched K9 and K11, both forms, ``size`` G's, values shared, at
    each of SWEEP_SETTINGS: at each of SWEEP_POINTS (one member a block,
    groups of 2 and of 4 at any lanes: ``_GROUP_SIZES`` and the lanes'
    minimums set while the launch's record is built), the
    group of 4 with Y's rows in column order
    (``column_order``), the rule's own launch and the same members' single
    launches, all in the same turns for one setting: events, the
    kernels' device time, all the call's device time, the plans; held
    against the plain version."""
    import sparse_dot_tpu_torch as sdt

    grad = sdt.ops.spgemm_grad
    result = {}
    for setting in SWEEP_SETTINGS:
        dtype, itype, density = setting
        label = (f"{np.dtype(dtype).name}, {np.dtype(itype).name}, X "
                 f"{'demo 21.2%' if density is None else density}")
        cases = sweep_cases(sdt, setting, rng, size)
        fns, plain, plans = {}, {}, {}
        points = dict(SWEEP_POINTS, **{"rule": None,
                                       "members 4, column order": (4,)})
        for point, sizes in points.items():
            saved = (grad._GROUP_SIZES, grad._GROUP_MIN_LANES,
                     grad._GROUP_MIN_LANES_DB, grad.bank_order)
            if sizes is not None:
                grad._GROUP_SIZES = sizes
                grad._GROUP_MIN_LANES = grad._GROUP_MIN_LANES_DB = 1
            if point.endswith("column order"):
                grad.bank_order = column_order
            try:
                f, p, owners = sampled_fns(sdt, cases, size)
                for name in cases:
                    f[name]()  # the plan, runs and record, built now
                    fns[f"{name}, {point}"] = f[name]
                    plain[f"{name}, {point}"] = p[name]
                    plans[f"{name}, {point}"] = launch_plan(owners[name])
                    if point == "rule":
                        key = f"{name}: {size} single launches"
                        fns[f"{name}, {key}"] = f[key]
            finally:
                (grad._GROUP_SIZES, grad._GROUP_MIN_LANES,
                 grad._GROUP_MIN_LANES_DB, grad.bank_order) = saved
        if any(p.endswith("column order") for p in fns):
            fns = {k: (_in_column_order(grad, fn)
                       if k.endswith("column order") else fn)
                   for k, fn in fns.items()}
        result[label] = {"plans": plans, "ms": timed_fns(fns, plain)}
    return {"shape": f"{size} G's, values shared; X 500 x 5000",
            "by_setting": result}


def _in_column_order(grad, fn):
    """fn run with ``column_order`` in place of ``bank_order``."""
    def run():
        saved = grad.bank_order
        grad.bank_order = column_order
        try:
            return fn()
        finally:
            grad.bank_order = saved
    return run


def launch_plan(pattern):
    """The plan and runs of the batched launch record cached on P's
    ``pattern`` (the one record of more than one member)."""
    for key, rec in pattern.plans.items():
        if key[0].endswith("-launch") and \
                key[9 if key[0] == "k11-launch" else 10] > 1:
            runs = rec.runs
            return {"members": rec.plan.members,
                    "lines_a_member": rec.plan.panel,
                    "lanes": rec.plan.lanes,
                    "items": None if runs is None else runs.items.numel() - 1,
                    "runs": None if runs is None else runs.run_q.numel()}
    return None


def sampled_turns(packages, inputs, rng, size=4):
    """Batched K9 and K11 (``sampled_cases``) and the same members' single
    launches, through each of ``packages`` ({label: module name}), all in
    the same turns: events, device time, host enqueue time, the error
    against this checkout's plain versions."""
    import importlib

    fns, plain = {}, {}
    cases = None
    for label, name in packages.items():
        sdt = importlib.import_module(name)
        cases = sampled_cases(sdt, inputs, np.random.default_rng(
            SEED + 27), size)
        f, p, _ = sampled_fns(sdt, cases, size)
        for key, fn in f.items():
            fns[f"{label}: {key}"] = fn
            if key in p:
                plain[f"{label}: {key}"] = p[key]
    return {"shape": f"{size} members, f64; case a: demo X @ X.T (500 x "
                     "5000 21.2%), case c: 1M x 1M 2M nnz A @ A; values "
                     "shared unless 'ensemble' (G and Y's values per "
                     "member)", "packages": packages,
            "ms": timed_fns(fns, plain)}


def bsr_turns(packages, inputs, rng):
    """K1 and K8 at phase 3's complex BSR (4000^2, bs 16, 5% of blocks,
    n = 64) in c128 and c64 through each of ``packages`` ({label: module
    name}; K1 given its chunk plan, as ``dot_product`` passes it), beside
    this checkout's CUDA-core variants launched directly, all in the same
    turns: events, all device work, host enqueue, the error against this
    checkout's plain versions."""
    import importlib

    from sparse_dot_tpu_torch.formats import bsr_chunk_plan
    from sparse_dot_tpu_torch.ops import bsr

    nc = SIZES["complex"]
    fns, plain = {}, {}
    for npdt in (np.complex128, np.complex64):
        tag = np.dtype(npdt).name
        A, b = chip_smoke.complex_bsr_operands(inputs, npdt)
        ip, ix, data = A.bsr_arrays()
        g = cuda(values(rng, (nc, 64), npdt))
        plan = bsr_chunk_plan(ip, data.shape[0])
        k1_args, k8_args = (ip, ix, data, b), (ip, ix, g, b, 16)
        for label, name in packages.items():
            wrapper = importlib.import_module(f"{name}.ops.bsr")
            fns[f"{label}: K1 {tag}"] = (
                lambda w=wrapper, a=k1_args: w.bsr_spmm(*a, plan=plan))
            fns[f"{label}: K8 {tag}"] = (
                lambda w=wrapper, a=k8_args: w.bsr_sddmm(*a))
            plain[f"{label}: K1 {tag}"] = (
                lambda a=k1_args: bsr.bsr_spmm_plain(*a))
            plain[f"{label}: K8 {tag}"] = (
                lambda a=k8_args: bsr.bsr_sddmm_plain(*a))
        fns[f"CUDA cores: K1 {tag}"] = lambda a=k1_args: chip_smoke.k1_simt(*a)
        fns[f"CUDA cores: K8 {tag}"] = lambda a=k8_args: chip_smoke.k8_simt(*a)
        plain[f"CUDA cores: K1 {tag}"] = plain[f"this checkout: K1 {tag}"]
        plain[f"CUDA cores: K8 {tag}"] = plain[f"this checkout: K8 {tag}"]
    return {"shape": f"BSR {nc}x{nc}, bs 16, 5% of blocks, n = 64 (K8: G "
                     f"({nc},64), B ({nc},64))", "packages": packages,
            "ms": timed_fns(fns, plain)}


# (block size, percent of blocks stored, value types) at which
# ``bsr_gate`` times dense x BSR: bs 16 on the tensor cores, bs 20 (phase
# 3's dense x BSR case) on the CUDA cores.
GATE_POINTS = ([(16, pct, (np.complex128, np.complex64))
                for pct in (10, 30, 50, 70, 90)]
               + [(20, pct, (np.complex128,)) for pct in (50, 90)])


def bsr_gate(rng, n=64):
    """Dense x BSR, D (n, 4000) @ A for A of phase 3's complex BSR shape
    (4000^2) at GATE_POINTS' block sizes and percents of blocks stored:
    K1 over the transposed blocks as ``ops.host._spmm_pass`` runs it (the
    blocks gathered into A^T's order, the cached chunk plan) against the
    densify route as ``ops.host.densified_spmm`` runs it with no planes
    kept (K12, ``torch.matmul``, the finite checks read on the host), each
    up to a host sync, in the same turns (``chip_smoke.sweep_point``),
    beside K1 alone on the gathered blocks and the gather alone; with the
    gate's choice, both cost models' forecasts and the FLOP rate K1 alone
    reaches (8 real FLOP a complex multiply-add, after the model's fixed
    seconds)."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.config import config
    from sparse_dot_tpu_torch.ops import bsr, host

    nc = SIZES["complex"]
    dev = torch.device("cuda")
    points = []
    config.spgemm_plane_cache = False
    try:
        for bs, pct, types in GATE_POINTS:
            a = chip_smoke.config3_bsr(rng, nc, np.complex128, bs,
                                       pct / 100.0)
            for npdt in types:
                A = formats.to_device(a.astype(npdt))
                b = cuda(values(rng, (nc, n), npdt))
                arrays, plan = A.bsr_arrays(True), A.bsr_plan(True)
                tdt, nnz = b.dtype, int(A.nnz)
                point = chip_smoke.sweep_point(
                    lambda: bsr.bsr_spmm(*A.bsr_arrays(True), b,
                                         plan=A.bsr_plan(True)),
                    lambda: host.densified_spmm(A, b, True),
                    {"k1_alone": lambda: bsr.bsr_spmm(*arrays, b, plan=plan),
                     "gather": lambda: A.bsr_arrays(True)},
                    host._prefer_densify(nc, nc, n, nnz, tdt, dev, bs))
                route_s = (host._DENSE_ROUTE_S
                           + host._densify_seconds(nc * nc, nnz, tdt)
                           + host._matmul_seconds(nc, nc, n, tdt))
                point.update(
                    bs=bs, percent=pct, dtype=str(tdt), nnz=nnz,
                    forecast_k1_ms=host._k1_seconds(nnz, n, tdt, bs) * 1e3,
                    forecast_route_ms=route_s * 1e3,
                    k1_alone_flops_per_s=8.0 * nnz * n / max(
                        point["k1_alone_ms"] * 1e-3 - host._K1_S, 1e-9))
                points.append(point)
                del A, b, arrays, plan
                torch.cuda.empty_cache()
    finally:
        config.spgemm_plane_cache = True
    return {"shape": f"D ({n},{nc}) @ BSR {nc}x{nc}",
            "gate_constants": {"K1_S": host._K1_S,
                               "K1_FLOPS": host._K1_FLOPS},
            "points": points}


def plain_cpu(packages, reps=15, n=64):
    """The plain K1 (``bsr_spmm_plain``) on the CPU at phase 3's complex
    BSR shape (4000^2, bs 16, 5% of blocks, n = 64), made from SEED + 1,
    in c128 and c64 through each of ``packages`` ({label: module name}),
    in turns: wall ms (median, p10, p90) and each package's largest
    difference from the first's result."""
    import importlib
    import platform

    nc = SIZES["complex"]
    rng = np.random.default_rng(SEED + 1)
    a = chip_smoke.config3_bsr(rng, nc, np.complex128, 16)
    result = {}
    for npdt in (np.complex128, np.complex64):
        ip, ix = (torch.from_numpy(t.astype(np.int64))
                  for t in (a.indptr, a.indices))
        data = torch.from_numpy(a.data.astype(npdt))
        b = torch.from_numpy(values(rng, (nc, n), npdt))
        fns = {label: (lambda w=importlib.import_module(f"{name}.ops.bsr"):
                       w.bsr_spmm_plain(ip, ix, data, b))
               for label, name in packages.items()}
        outs = {label: fn() for label, fn in fns.items()}
        first = next(iter(outs.values()))
        times = {label: [] for label in fns}
        for _ in range(reps):
            for label, fn in fns.items():
                t0 = time.perf_counter()
                fn()
                times[label].append((time.perf_counter() - t0) * 1e3)
        result[np.dtype(npdt).name] = {
            label: {"ms": spread(t),
                    "max_abs_diff": float((outs[label] - first).abs().max())}
            for label, t in times.items()}
    return {"shape": f"BSR {nc}x{nc}, bs 16, 5% of blocks, n = {n}",
            "timer": "time.perf_counter around each call, median/p10/p90 "
                     f"of {reps} turns",
            "cpu": {"machine": platform.machine(),
                    "cpus": os.cpu_count(),
                    "torch_threads": torch.get_num_threads()},
            "plain_ms": result}


def vmap_transforms(sdt, inp, rng):
    """{name: fn} of phase 6's transforms through package ``sdt`` that
    launch batched K7, K9 or K11 (``chip_smoke.batched_training`` and
    ``batched_spgemm_training``, the same shapes): ``hessian`` of
    sum(sin(``coo_spmm_raw``)) at JAC_PATTERN (K2, K7), the ensemble of 4
    demo X's through ``csr_spgemm_dense`` (K6, K9), ``jacrev`` of
    ``csr_spgemm_dense`` and ``hessian`` of sum(sin(``csr_spgemm``)) at
    SPGEMM_JAC_PATTERN (K9; K4, K5, K11), and the ensemble of 4 1M² A's
    through ``csr_spgemm`` (K4, K5, K11)."""
    autograd, spgemm = sdt.ops.autograd, sdt.ops.spgemm
    fns = {}
    m, k, mean_row, n = chip_smoke.JAC_PATTERN
    indptr, indices, data = chip_smoke.random_csr(rng, m, k, mean_row,
                                                  np.float64)
    r, c, v, b = (cuda(a) for a in (
        np.repeat(np.arange(m), np.diff(indptr)).astype(np.int32), indices,
        data, values(rng, (k, n), np.float64)))
    fns["hessian_values_and_b_small_f64"] = lambda: torch.func.hessian(
        lambda x, y: torch.sin(autograd.coo_spmm_raw(r, c, x, y, m)).sum(),
        argnums=(0, 1))(v, b)
    x = inp["x"]
    A, B = sdt.formats.to_device(x), sdt.formats.to_device(x.T.tocsr())
    ip, ix, dv = A.csr_arrays()
    bip, bix, bdv = B.csr_arrays()
    nx = x.shape[0]
    target = cuda((x @ x.T).toarray())
    avs = dv[None] * (1 + 0.1 * cuda(values(
        rng, (chip_smoke.ENSEMBLE, ix.numel()), np.float64)))

    def dense_loss(av, bv):
        cc = spgemm.csr_spgemm_dense(ip, ix, av, bip, bix, bv, nx)
        return ((cc - target) ** 2).sum()

    fns["ensemble_grads_spgemm_dense_demo_f64"] = lambda: torch.func.vmap(
        torch.func.grad(dense_loss, argnums=(0, 1)),
        in_dims=(0, None))(avs, bdv)
    mm, kk, nn, a_rows, b_rows = chip_smoke.SPGEMM_JAC_PATTERN
    a_ip, a_ix, av, b_ip, b_ix, bv = (cuda(arr) for arr in (
        *chip_smoke.distinct_rows(rng, np.resize(a_rows, mm), kk,
                                  np.float64, np.int32),
        *chip_smoke.distinct_rows(rng, np.resize(b_rows, kk), nn,
                                  np.float64, np.int32)))
    fns["jacrev_spgemm_dense_small_f64"] = lambda: torch.func.jacrev(
        lambda z: spgemm.csr_spgemm_dense(a_ip, a_ix, z, b_ip, b_ix, bv,
                                          nn))(av)
    fns["hessian_spgemm_sparse_small_f64"] = lambda: torch.func.hessian(
        lambda y, z: torch.sin(spgemm.csr_spgemm(
            a_ip, a_ix, y, b_ip, b_ix, z, nn)[2]).sum(),
        argnums=(0, 1))(av, bv)
    A1 = sdt.formats.to_device(inp["a1m"])
    p1, x1, d1 = A1.csr_arrays()
    n1 = inp["a1m"].shape[1]
    c1 = spgemm.csr_spgemm(p1, x1, d1, p1, x1, d1, n1)[2]
    t1 = c1 * (1 + 0.1 * cuda(values(rng, c1.numel(), np.float64)))
    avs1 = d1[None] * (1 + 0.1 * cuda(values(
        rng, (chip_smoke.ENSEMBLE, x1.numel()), np.float64)))

    def sparse_loss(aa, bb):
        return ((spgemm.csr_spgemm(p1, x1, aa, p1, x1, bb, n1)[2] - t1)
                ** 2).sum()

    fns["ensemble_grads_spgemm_sparse_1m_f64"] = lambda: torch.func.vmap(
        torch.func.grad(sparse_loss, argnums=(0, 1)),
        in_dims=(0, None))(avs1, d1)
    return fns


def vmap_walls(packages, inp, reps=20):
    """``vmap_transforms`` through each of ``packages`` ({label: module
    name}), each timed host to host (a sync before and after) ``reps``
    times, the packages in alternating turns (A B, B A, ...) after one
    warm call each; the device's busy ms of one more call
    (``device_busy_ms``) and the idle share of the median wall."""
    import importlib

    fns = {}
    for label, name in packages.items():
        sdt = importlib.import_module(name)
        for key, fn in vmap_transforms(
                sdt, inp, np.random.default_rng(SEED + 29)).items():
            fns[key, label] = fn
    times = {key: [] for key in fns}
    for fn in fns.values():
        fn()
    labels = list(packages)
    for rep in range(reps):
        turn = labels if rep % 2 == 0 else labels[::-1]
        for key in dict.fromkeys(k for k, _ in fns):
            for label in turn:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fns[key, label]()
                torch.cuda.synchronize()
                times[key, label].append((time.perf_counter() - t0) * 1e3)
    result = {}
    for (key, label), fn in fns.items():
        ms, p10, p90 = spread(times[key, label])
        busy = chip_smoke.device_busy_ms(fn)
        result.setdefault(key, {})[label] = {
            "wall_ms": ms, "p10": p10, "p90": p90,
            "min": min(times[key, label]), "device_busy_ms": busy,
            "device_idle_share": None if busy is None else 1 - busy / ms}
    return {"timer": f"host clock, a sync before and after, median of "
                     f"{reps} turns, packages alternating",
            "packages": packages, "walls": result}


# Value and index types of the member-group sweeps of batched K2 and K5.
GROUP_SWEEP_TYPES = ((torch.float32, torch.int32), (torch.float32, torch.int64),
                     (torch.float64, torch.int32), (torch.float64, torch.int64),
                     (torch.complex128, torch.int32),
                     (torch.complex128, torch.int64))


def plan_of(spgemm, a_indptr, a_indices, b_indptr, n, dtype):
    """``spgemm_plan`` of any checkout's ``ops.spgemm`` module ``spgemm``:
    an older checkout's took the index dtype too."""
    import inspect

    if len(inspect.signature(spgemm.spgemm_plan).parameters) == 6:
        return spgemm.spgemm_plan(a_indptr, a_indices, b_indptr, n, dtype,
                                  a_indptr.dtype)
    return spgemm.spgemm_plan(a_indptr, a_indices, b_indptr, n, dtype)


def other_packages(packages):
    """The modules of ``packages`` ({label: module name}) other than this
    checkout's."""
    import importlib

    return {label: importlib.import_module(name)
            for label, name in packages.items() if label != "this checkout"}


def timed_group_fns(fns, want, tdt, match, reps=REPS, unchecked=()):
    """Each fn of ``fns`` held against ``want`` (a list's members
    stacked; those named in ``unchecked``, stand-ins, not held), timed in
    turns (``time_turns``) and its kernels' device time
    (``kernel_device_ms`` of ``match``)."""
    errs = {}
    for name, fn in fns.items():
        out = fn()
        out = torch.stack(out) if isinstance(out, list) else out
        errs[name] = None if name in unchecked else compare(out, want, tdt)
    del out
    times = time_turns(fns, reps)
    return {name: {**dict(zip(("ms", "p10", "p90"), spread(times[name]))),
                   "device_ms": chip_smoke.kernel_device_ms(fn, match),
                   "max_abs_err": errs[name]}
            for name, fn in fns.items()}


def k2_group_sweep(packages, inputs, rng):
    """Batched K2 with b shared by per-member values: at config 1 (n =
    128) over 4 and 16 value sets in each type of GROUP_SWEEP_TYPES, and
    at the 1M^2 SpMV matrix (n = 1, f64, 4 sets), the launch at 1 (the
    per-member instance), 2 and 4 members a block
    (``chip_smoke.k2_batched_at``), the wrapper's call, the same members'
    single launches and each other package's wrapper call, in the same
    turns, each against the batched plain version."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import csr

    others = other_packages(packages)
    cases = [("config1", inputs["a1"], 128, tdt, itype, size)
             for tdt, itype in GROUP_SWEEP_TYPES for size in (4, 16)]
    cases += [("spmv", inputs["av"], 1, torch.float64, torch.int32, 4)]
    result = {}
    for name, a_np, n, tdt, itype, size in cases:
        ip, ix, _ = formats.to_device(a_np).csr_arrays()
        ip, ix = ip.to(itype), ix.to(itype)
        nnz, k = ix.numel(), a_np.shape[1]
        plan = formats.csr_plan(ip, nnz)
        npdt = chip_smoke.NP_DTYPES[tdt]
        data = cuda(values(rng, (size, nnz), npdt, 0.1))
        b = cuda(values(rng, (k, n), npdt))
        fns = {"wrapper": lambda: csr.spmm_batched(ip, ix, data, b,
                                                    plan=plan)}
        for g in (1, 2, 4):
            fns[f"members_{g}"] = (
                lambda g=g: chip_smoke.k2_batched_at(ip, ix, data, b, plan,
                                                     g))
        fns["single_launches"] = lambda: [
            csr.csr_spmm(ip, ix, data[i], b, plan=plan) for i in range(size)]
        for label, other in others.items():
            oplan = other.formats.csr_plan(ip, nnz)
            fns[f"{label}: wrapper"] = (
                lambda other=other, oplan=oplan: other.ops.csr.spmm_batched(
                    ip, ix, data, b, plan=oplan))
        want = csr.csr_spmm_batched_plain(ip, ix, data, b)
        s = csr.spmm_schedule(n, tdt, nnz / (ip.numel() - 1))
        result[f"{name} {tdt} {itype} x{size}"] = {
            "schedule": list(s),
            "wrapper_members": csr.spmm_group(s, tdt, ix.element_size(),
                                              size),
            "bound": chip_smoke.csr_batched_bound(ip, ix, data, b, size),
            "times": timed_group_fns(fns, want, tdt,
                                     ("csr_spmm_kernel", "csr_spmm"))}
        del data, b, want, fns
        torch.cuda.empty_cache()
    return {"shape": {"config1": "CSR 10000x10000 1%, b (10000,128) shared",
                      "spmv": "CSR 1000000x1000000, 10 a row, x "
                              "(1000000,1) shared"},
            "cases": result}


def k5_group_sweep(packages, inputs, rng, size=4):
    """Batched K5 over ``size`` value sets of op(A), op(B) shared, one
    plan: at case c (the 1M^2 A @ A: register bins) in f64, f32 and c128
    and f64 with int64 indices, and at ``chip_smoke.k5_case_h_row``'s
    product (case h: the sorted-product bins) in f64: each bin at up to
    1 (the per-member instance), 2 and 4 members a block
    (``_fill_launcher``'s ``most``), the wrapper's call, the same
    members' single fills and each other package's wrapper call, in the
    same turns, each against the batched plain version."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import spgemm

    others = other_packages(packages)
    side = 100_000
    cases = [("c", inputs["a1m"], tdt, itype) for tdt, itype in (
        (torch.float64, torch.int32), (torch.float32, torch.int32),
        (torch.complex128, torch.int32), (torch.float64, torch.int64))]
    cases += [("h", chip_smoke.poisson_square(side, 10), torch.float64,
               torch.int32)]
    result = {}
    for name, a_np, tdt, itype in cases:
        npdt = chip_smoke.NP_DTYPES[tdt]
        A = formats.to_device(a_np.astype(npdt))
        ip, ix, dv = (t.to(itype) if i < 2 else t
                      for i, t in enumerate(A.csr_arrays()))
        n = a_np.shape[1]
        c_ip, c_ix, _ = spgemm.csr_spgemm(ip, ix, dv, ip, ix, dv, n)
        nnz = c_ix.numel()
        plan = spgemm.spgemm_plan(ip, ix, ip, n, tdt)
        sizes = plan.offsets.diff().tolist()
        av = dv[None] * (1 + 0.1 * cuda(values(rng, (size, ix.numel()),
                                               npdt)))
        args = (ip, ix, av, ip, ix, dv, n)
        launcher = spgemm._fill_launcher(*args, plan, c_ip, False, size)
        fns = {"wrapper": lambda: spgemm.fill_batched(
            *args, plan, c_ip, nnz, bin_sizes=sizes)[1]}
        for g in (1, 2, 4):
            fns[f"members_{g}"] = (
                lambda g=g: launcher(nnz, sizes, most=g)[1])
        fns["single_launches"] = lambda: [
            spgemm.csr_spgemm_fill(ip, ix, av[i], ip, ix, dv, n, plan, c_ip,
                                   nnz, bin_sizes=sizes)[1]
            for i in range(size)]
        for label, other in others.items():
            oplan = plan_of(other.ops.spgemm, ip, ix, ip, n, tdt)
            fns[f"{label}: wrapper"] = (
                lambda other=other, oplan=oplan: other.ops.spgemm
                .fill_batched(*args, oplan, c_ip, nnz, bin_sizes=sizes)[1])
        want = spgemm.csr_spgemm_fill_batched_plain(*args)[1]
        groups = spgemm.fill_groups(plan.bins, tdt, ip.dtype, size)
        result[f"{name} {tdt} {itype} x{size}"] = {
            "bins": chip_smoke.bin_groups(plan, sizes, groups),
            "times": timed_group_fns(fns, want, tdt,
                                     chip_smoke.K45_KERNELS)}
        del A, av, want, fns, launcher
        torch.cuda.empty_cache()
    return {"shape": {"c": "1M x 1M CSR, 2M random nnz, A @ A",
                      "h": f"{side}^2 CSR, Poisson(10) a row, A @ A"},
            "cases": result}


def k4k5_turns(packages, inputs, rng, size=4):
    """K4, K4 with its plan (``plan_and_count``), K5 (the bin sizes
    given, as ``csr_spgemm`` launches it) and K4 + K5 as one product
    (``csr_spgemm``) of each package of ``packages``, beside
    ``torch.sparse.mm(A_csr, B_csr)`` (cuSPARSE SpGEMM), in the same
    turns, at ``chip_smoke.spgemm_cases``' cases (a, c, d, h, hb, hc; hb
    and hc at their fewer reps), each call's output first held against
    this checkout's plain versions, and each package's product against
    the first's, bit for bit (``same_bits``); and at cases c, h and hb
    batched K5 over ``size`` value sets of op(A) (``fill_batched``)
    beside ``size`` x ``torch.sparse.mm``.  Rows a bin at each case."""
    import importlib

    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import spgemm

    mods = {label: importlib.import_module(f"{name}.ops.spgemm")
            for label, name in packages.items()}
    result = {}
    for case, (shape, a_np, b_np, reps) in chip_smoke.spgemm_cases(
            inputs).items():
        A, B = formats.to_device(a_np), formats.to_device(b_np)
        ip, ix, dv = A.csr_arrays()
        bip, bix, bdv = B.csr_arrays()
        n = b_np.shape[1]
        args = (ip, ix, dv, bip, bix, bdv, n)
        ref = spgemm.spgemm_plain(*args)
        counts = ref[0].long().diff()
        nnz = ref[1].numel()
        fns = {}
        first = None
        for label, mod in mods.items():
            plan = plan_of(mod, ip, ix, bip, n, dv.dtype)
            sizes = plan.offsets.diff().tolist()
            got = mod.csr_spgemm_count(ip, ix, bip, bix, n, plan)
            chip_smoke.compare(got, counts, got.dtype)
            got = mod.plan_and_count(ip, ix, bip, bix, n, dv.dtype)[1]
            chip_smoke.compare(got, counts, got.dtype)
            got = mod.csr_spgemm_fill(*args, plan, ref[0], nnz,
                                      bin_sizes=sizes)
            chip_smoke.compare(got[0], ref[1], got[0].dtype)
            chip_smoke.compare(got[1], ref[2], dv.dtype)
            got = mod.csr_spgemm(*args)
            chip_smoke.compare(got[1], ref[1], got[1].dtype)
            chip_smoke.compare(got[2], ref[2], dv.dtype)
            if first is None:
                first = got
            elif not (torch.equal(got[0], first[0])
                      and torch.equal(got[1], first[1])
                      and chip_smoke.same_bits(got[2], first[2])):
                raise AssertionError(f"case {case}: {label}'s C differs "
                                     f"from the first package's bits")
            del got
            fns[f"{label}: K4"] = (
                lambda mod=mod, plan=plan: mod.csr_spgemm_count(
                    ip, ix, bip, bix, n, plan))
            fns[f"{label}: K4 with its plan"] = (
                lambda mod=mod: mod.plan_and_count(ip, ix, bip, bix, n,
                                                   dv.dtype))
            fns[f"{label}: K5"] = (
                lambda mod=mod, plan=plan, sizes=sizes: mod.csr_spgemm_fill(
                    *args, plan, ref[0], nnz, bin_sizes=sizes))
            fns[f"{label}: K4+K5 product"] = (
                lambda mod=mod: mod.csr_spgemm(*args))
            if label == "this checkout":
                bins = chip_smoke.bin_rows(plan, sizes)
        a_t = torch.sparse_csr_tensor(ip, ix, dv, size=a_np.shape)
        b_t = torch.sparse_csr_tensor(bip, bix, bdv, size=b_np.shape)
        fns["torch.sparse.mm"] = lambda: torch.sparse.mm(a_t, b_t)
        fns["torch.sparse.mm"]()  # warm-up (cuSPARSE handles, buffers)
        times = time_turns(fns, reps)
        result[case] = {
            "shape": shape, "reps": reps, "nnz": nnz, "bins": bins,
            "products": int(spgemm.row_bounds(ip, ix, bip).sum()),
            "same_bits_across_packages": len(mods) > 1,
            "times": {name: dict(zip(("ms", "p10", "p90"), spread(t)))
                      for name, t in times.items()}}
        del first
        if case in ("c", "h", "hb"):
            result[case]["batched"] = k5_batched_turns(
                mods, a_np, args, ref, rng, reps, size)
        del A, B, args, ref, fns, a_t, b_t
        torch.cuda.empty_cache()
    return result


def k5_batched_turns(mods, a_np, args, ref, rng, reps, size):
    """Batched K5 over ``size`` value sets of op(A), op(B) shared, on one
    plan (``fill_batched``, the wrapper's groups) of each module of
    ``mods`` ({label: ops.spgemm}), beside ``size`` x
    ``torch.sparse.mm(A_csr, B_csr)``, in the same turns, each held
    against the batched plain version first."""
    from sparse_dot_tpu_torch.ops import spgemm

    ip, ix, dv, bip, bix, bdv, n = args
    nnz = ref[1].numel()
    av = dv[None] * (1 + 0.1 * cuda(values(rng, (size, ix.numel()),
                                           np.float64)))
    fill_args = (ip, ix, av, bip, bix, bdv, n)
    want = spgemm.csr_spgemm_fill_batched_plain(*fill_args)[1]
    fns = {}
    for label, mod in mods.items():
        plan = plan_of(mod, ip, ix, bip, n, dv.dtype)
        sizes = plan.offsets.diff().tolist()
        fn = (lambda mod=mod, plan=plan, sizes=sizes: mod.fill_batched(
            *fill_args, plan, ref[0], nnz, bin_sizes=sizes)[1])
        compare(fn(), want, dv.dtype)
        fns[f"{label}: batched K5"] = fn
    mats = [torch.sparse_csr_tensor(ip, ix, av[i], size=a_np.shape)
            for i in range(size)]
    b_t = torch.sparse_csr_tensor(bip, bix, bdv, size=(bip.numel() - 1, n))
    fns[f"{size} x torch.sparse.mm"] = lambda: [torch.sparse.mm(m, b_t)
                                                for m in mats]
    fns[f"{size} x torch.sparse.mm"]()
    times = time_turns(fns, reps)
    return {"members": size,
            "times": {name: dict(zip(("ms", "p10", "p90"), spread(t)))
                      for name, t in times.items()}}


# Edits of a variant package (``variant_package``): (source in csrc/,
# line, its replacement).  K6_CONFLICT_FREE: K6's group kernel updates
# column ``lane`` for every product (the same loads, fmas and accesses,
# no bank met twice; its sums are wrong and only timed).  K1_ROWS_32:
# K1's group kernel takes 32-row tiles for blocks past 32 rows (two row
# tiles at bs 64, half the accumulators; its results are checked).
K6_CONFLICT_FREE = ("csr_spgemm_dense_group.cu",
                    "const int col = static_cast<int>(j[u] - first);",
                    "const int col = lane;")
K1_ROWS_32 = ("bsr_spmm_group.cu",
              "return launch_group_tiles<T, I, 64, M>(SDT_K1_GROUP_ARGS);",
              "return launch_group_tiles<T, I, 32, M>(SDT_K1_GROUP_ARGS);")


# Variants of the sorted-product bins (``variant_package`` edits of
# csr_spgemm.cuh), timed against this checkout's choices by ``sorted``.
# SORT_IN_SHARED: the keys sorted in the warp's shared memory (each lane
# loads, compares and stores 16 R / 32 pairs a stage, a __syncwarp each)
# in place of registers and shuffles; the region grows by 8 bytes a
# product (the keys after the sorted order) and K4 is given one too.
# SORT_ALL_KEYS: every row sorts its bin's U keys, in place of the
# pow2(ub) of its products (U / 2 or U).  ALL_KEYS_512: the bin of 512
# alone sorts its 512 keys (one unrolled network in its kernel, not two).
SHARED_SORT = """  {
    K* sk = reinterpret_cast<K*>(order + U);
#pragma unroll
    for (int r = 0; r < R; ++r) sk[(r << 5) | lane] = key[r];
    __syncwarp();
    for (int size = 2; size <= 32 * R; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
        for (int t = lane; t < 16 * R; t += 32) {
          const int lo = 2 * t - (t & (stride - 1));
          const int hi = lo + stride;
          const bool up = (lo & size) == 0;
          const K a = sk[lo], b = sk[hi];
          if ((a > b) == up) {
            sk[lo] = b;
            sk[hi] = a;
          }
        }
        __syncwarp();
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) key[r] = sk[(r << 5) | lane];
    __syncwarp();
  }"""
SORT_IN_SHARED = (
    ("csr_spgemm.cuh",
     "  return (U * (2 * int64_t(sizeof(I)) + 2) + 15) / 16 * 16;",
     "  return (U * (2 * int64_t(sizeof(I)) + 10) + 15) / 16 * 16;"),
    ("csr_spgemm.cuh",
     "      FILL ? static_cast<size_t>(sorted_region_bytes<I>(U)) * "
     "(kThreads / 32)\n           : 0;",
     "      static_cast<size_t>(sorted_region_bytes<I>(U)) * "
     "(kThreads / 32);"),
    ("csr_spgemm.cuh", "  sort_warp_keys<K, R>(key, lane);", SHARED_SORT),
)
SORT_ALL_KEYS = (("csr_spgemm.cuh", "    if (carry <= 16 * RM) {",
                  "    if (false) {"),)
ALL_KEYS_512 = (("csr_spgemm.cuh", "    if (carry <= 16 * RM) {",
                 "    if (U == 128 && carry <= 16 * RM) {"),)


# K4's count in the block-sorted bins by the heads of a sort of its keys,
# as K5 sorts them, in place of a table of pow2(2 ub) slots
# (csr_spgemm_block.cuh, block_count_by_table), timed against this
# checkout by ``block``: the region holds the keys while they cross warps.
COUNT_BY_SORT_FN = """template <typename I, typename K, int U, int RR, int RM>
__device__ __forceinline__ void block_count_by_sort(
    const Args<float, I>& args, int64_t i, const I (&col)[RM], K* xs,
    uint64_t* last, int* heads_of) {
  constexpr K kNoKey = ~K(0);
  constexpr int P = log2_of(U);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  K key[RM];
#pragma unroll
  for (int t = 0; t < RM; ++t) {
    const bool live =
        t < RR && col[t] >= 0 && (!args.triangular || col[t] >= i);
    key[t] = live ? (static_cast<K>(col[t]) << P) |
                        static_cast<K>(kThreads * t + tid)
                  : kNoKey;
  }
  sort_block_keys<K, RR>(key, xs, lane, warp);
  if (lane == 31) last[warp] = key[RR - 1];
  __syncthreads();
  int count = 0;
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    const K up = __shfl_up_sync(kFullMask, key[r], 1);
    const K wrap = __shfl_sync(kFullMask, key[r > 0 ? r - 1 : 0], 31);
    K prev = lane > 0 ? up : wrap;
    if (r == 0 && lane == 0) {
      prev = warp > 0 ? static_cast<K>(last[warp - 1]) : kNoKey;
    }
    const bool head = key[r] != kNoKey && (prev == kNoKey ||
                                           (prev >> P) != (key[r] >> P));
    count += __popc(__ballot_sync(kFullMask, head));
  }
  if (lane == 0) heads_of[warp] = count;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kBlockWarps; ++w) total += heads_of[w];
    store_streaming(args.counts + i, static_cast<int64_t>(total));
  }
}

"""
COUNT_BY_SORT = (
    ("csr_spgemm_block.cuh",
     "// K4's count of row i in a block bin: the columns of the row's ub\n",
     COUNT_BY_SORT_FN
     + "// K4's count of row i in a block bin: the columns of the row's ub\n"),
    ("csr_spgemm_block.cuh",
     "      block_count_by_table<I, R>(args, i, carry, col,\n"
     "                                 reinterpret_cast<I*>(smem), s_heads);",
     "      K* keys = reinterpret_cast<K*>(smem);\n"
     "      if (carry <= U / 2) {\n"
     "        block_count_by_sort<I, K, U, R / 2, R>(args, i, col, keys,\n"
     "                                               s_last, s_heads);\n"
     "      } else {\n"
     "        block_count_by_sort<I, K, U, R, R>(args, i, col, keys, s_last,\n"
     "                                           s_heads);\n"
     "      }"),
    ("csr_spgemm_block.cuh",
     "FILL ? U * (2 * int64_t(sizeof(I)) + 8) : 2 * U * int64_t(sizeof(I));",
     "FILL ? U * (2 * int64_t(sizeof(I)) + 8) : U * 8;"),
    ("csr_spgemm_block.cuh",
     "  if constexpr (FILL) {\n    if (args.n >= block_narrow_columns<U>()) {",
     "  {\n    if (args.n >= block_narrow_columns<U>()) {"),
)


def block_variants():
    """K4 (and K4 with its plan) of this checkout (a table a row in the
    block-sorted bins) and of a copy built under ``build/`` that counts
    the heads of the sort (COUNT_BY_SORT), in the same turns, each held
    against the plain version first, at ``chip_smoke.spgemm_cases``'
    hb and hc."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import spgemm

    dest = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "sdt_count_by_sort")
    mods = {"this checkout (table)": spgemm,
            "heads of the sort": variant_package(
                dest, "sdt_count_by_sort", COUNT_BY_SORT).ops.spgemm}
    result = {}
    cases = chip_smoke.spgemm_cases(chip_smoke.spgemm_inputs())
    for case in ("hb", "hc"):
        shape, a_np, _, reps = cases[case]
        A = formats.to_device(a_np)
        ip, ix, dv = A.csr_arrays()
        n = a_np.shape[1]
        counts = spgemm.csr_spgemm_count_plain(ip, ix, ip, ix, n)
        fns = {}
        for label, mod in mods.items():
            plan = mod.spgemm_plan(ip, ix, ip, n, dv.dtype)
            k4 = (lambda mod=mod, plan=plan: mod.csr_spgemm_count(
                ip, ix, ip, ix, n, plan))
            with_plan = (lambda mod=mod: mod.plan_and_count(
                ip, ix, ip, ix, n, dv.dtype)[1])
            compare(k4(), counts, counts.dtype)
            compare(with_plan(), counts, counts.dtype)
            fns.update({f"{label}: K4": k4,
                        f"{label}: K4 with its plan": with_plan})
        times = time_turns(fns, max(reps, 15))
        result[case] = {
            "shape": shape,
            "times": {name: dict(zip(("ms", "p10", "p90"), spread(t)))
                      for name, t in times.items()}}
        del A, fns
        torch.cuda.empty_cache()
    return result


def sorted_variants(rng, size=4):
    """K4, K5 and batched K5 (``size`` value sets of op(A), op(B) shared,
    the wrapper's groups) of this checkout and of three variants built
    under ``build/`` (SORT_IN_SHARED, SORT_ALL_KEYS, ALL_KEYS_512), in
    the same turns,
    each held against the plain versions first: at case h (100,000^2,
    Poisson(10) a row, A @ A, f64: 79,933 rows of 33-128 products, 19,059
    of 129-512) and at 100,000^2, Poisson(16) (about 270 products a row:
    most rows in the bin of 512)."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import spgemm

    mods = {"this checkout": spgemm}
    for label, name, edits in (("keys in shared memory", "sdt_sort_shared",
                                SORT_IN_SHARED),
                               ("all U keys sorted", "sdt_sort_all",
                                SORT_ALL_KEYS),
                               ("512 keys in the bin of 512",
                                "sdt_all_512", ALL_KEYS_512)):
        dest = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", name)
        mods[label] = variant_package(dest, name, edits).ops.spgemm
    result = {}
    for case, mean_row in (("h", 10), ("h16", 16)):
        a_np = chip_smoke.poisson_square(100_000, mean_row)
        A = formats.to_device(a_np)
        ip, ix, dv = A.csr_arrays()
        n = a_np.shape[1]
        args = (ip, ix, dv, ip, ix, dv, n)
        ref = spgemm.spgemm_plain(*args)
        counts = ref[0].long().diff()
        nnz = ref[1].numel()
        av = dv[None] * (1 + 0.1 * cuda(values(rng, (size, ix.numel()),
                                               np.float64)))
        fill_args = (ip, ix, av, ip, ix, dv, n)
        want = spgemm.csr_spgemm_fill_batched_plain(*fill_args)[1]
        fns = {}
        for label, mod in mods.items():
            plan = mod.spgemm_plan(ip, ix, ip, n, dv.dtype)
            sizes = plan.offsets.diff().tolist()
            k4 = (lambda mod=mod, plan=plan: mod.csr_spgemm_count(
                ip, ix, ip, ix, n, plan))
            k5 = (lambda mod=mod, plan=plan, sizes=sizes: mod.csr_spgemm_fill(
                *args, plan, ref[0], nnz, bin_sizes=sizes)[1])
            group = (lambda mod=mod, plan=plan, sizes=sizes: mod.fill_batched(
                *fill_args, plan, ref[0], nnz, bin_sizes=sizes)[1])
            compare(k4(), counts, counts.dtype)
            compare(k5(), ref[2], dv.dtype)
            compare(group(), want, dv.dtype)
            fns.update({f"{label}: K4": k4, f"{label}: K5": k5,
                        f"{label}: batched K5": group})
            if label == "this checkout":
                bins = chip_smoke.bin_rows(plan, sizes)
        times = time_turns(fns, REPS)
        result[case] = {
            "shape": f"100k x 100k CSR, Poisson({mean_row}) a row, A @ A, "
                     f"f64; batched: {size} value sets of op(A)",
            "bins": bins,
            "times": {name: dict(zip(("ms", "p10", "p90"), spread(t)))
                      for name, t in times.items()}}
        del A, args, ref, av, want, fns
        torch.cuda.empty_cache()
    return result


def variant_package(dest, name, edits):
    """A copy of this checkout's package at ``dest`` with ``edits`` made to
    its kernels' sources, imported as ``name``, its kernels built from
    the copy's sources."""
    import importlib
    import shutil

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "sparse_dot_tpu_torch")
    root = os.path.join(os.path.abspath(dest), "sparse_dot_tpu_torch")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(src, root, ignore=shutil.ignore_patterns("__pycache__"))
    for source, line, replacement in edits:
        path = os.path.join(root, "csrc", source)
        with open(path) as f:
            text = f.read()
        if text.count(line) != 1:
            raise AssertionError(f"{source}: the line to edit moved")
        with open(path, "w") as f:
            f.write(text.replace(line, replacement))
    module = load_package(dest, name)
    importlib.import_module(f"{name}.config").config.device = "cuda"
    importlib.import_module(f"{name}.ops._build").library()
    return module


class SmClocks:
    """The SM clock (MHz) as ``nvidia-smi`` reads it every 50 ms while the
    block runs: ``samples`` after it."""

    def __enter__(self):
        import subprocess

        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader,nounits", "-i", "0", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=60)
        self.samples = [[int(v) for v in line.split(",")]
                        for line in out.splitlines() if line.strip()]
        return False


def k6_group_sweep(packages, inputs, rng):
    """Batched K6 at case a (the demo X @ X.T) over 4, 8 and 16 value sets
    of op(A), op(B) shared, over 4 sets of op(B)'s values, op(A)'s
    shared, and over 4 c0's, both operands shared (the ONE_SUM form), in
    every value type and index width: the launch at 1 (the per-member
    instance), 2 and 4 members a block (ONE_SUM: 1 and 4;
    ``chip_smoke.k6_batched_at``), at 4 also on two windows of 256
    columns (a quarter of the shared memory a block), the wrapper's call,
    the same members' single launches and each other package's wrapper
    call, in the same turns, each against the batched plain version.  At
    f64 with int32 ids over 4 sets of op(A), also the conflict-free
    stand-in of the group kernel at 2 and 4 members a block
    (``variant_package`` with K6_CONFLICT_FREE, unchecked) and the SM
    clock while the turns ran."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import spgemm

    others = other_packages(packages)
    stand_in = variant_package(os.path.join("build", "k6_conflict_free"),
                               "sdt_conflict_free", [K6_CONFLICT_FREE])
    x = inputs["x"]
    A, B = formats.to_device(x), formats.to_device(x.T)
    n = x.shape[0]
    types = [(tdt, itype) for tdt in (torch.float32, torch.float64,
                                      torch.complex64, torch.complex128)
             for itype in (torch.int32, torch.int64)]
    cases = [(tdt, itype, size, "a") for tdt, itype in types
             for size in (4, 8, 16)]
    cases += [(tdt, itype, 4, over) for over in ("b", "c0")
              for tdt, itype in types]
    result = {}
    for tdt, itype, size, over in cases:
        ip, ix, dv = (t.to(itype) if i < 2 else t.to(tdt)
                      for i, t in enumerate(A.csr_arrays()))
        bip, bix, bdv = (t.to(itype) if i < 2 else t.to(tdt)
                         for i, t in enumerate(B.csr_arrays()))
        npdt = chip_smoke.NP_DTYPES[tdt]
        av, bv, c0, beta = dv, bdv, None, None
        if over == "a":
            av = dv[None] * (1 + 0.1 * cuda(values(
                rng, (size, ix.numel()), npdt)))
        elif over == "b":
            bv = bdv[None] * (1 + 0.1 * cuda(values(
                rng, (size, bix.numel()), npdt)))
        else:
            c0, beta = cuda(values(rng, (size, n, n), npdt)), 1.0
        args = (ip, ix, av, bip, bix, bv, n)
        plan = spgemm.dense_plan(n, n, av.element_size(), ix.numel())
        fns = {"wrapper": lambda: spgemm.spgemm_dense_batched(
            *args, None, beta, c0, b_sorted=True)}
        for g in ((1, 4) if over == "c0" else (1, 2, 4)):
            fns[f"members_{g}"] = lambda g=g: chip_smoke.k6_batched_at(
                args, g, None, beta, c0)
        if over != "c0":
            two = spgemm.DensePlan(plan.splits, 256, 2)

            def two_windows(two=two):
                # A plain swap of the planner: a mock's set-up would add
                # host time to the turn.
                single, spgemm.dense_plan = (spgemm.dense_plan,
                                             lambda *_: two)
                try:
                    return chip_smoke.k6_batched_at(args, 4)
                finally:
                    spgemm.dense_plan = single

            fns["members_4_two_windows"] = two_windows
        fns["single_launches"] = lambda: [
            spgemm.csr_spgemm_dense(
                ip, ix, av[i] if over == "a" else av, bip, bix,
                bv[i] if over == "b" else bv, n, None, beta,
                None if c0 is None else c0[i], b_sorted=True)
            for i in range(size)]
        for label, other in others.items():
            fns[f"{label}: wrapper"] = (
                lambda other=other: other.ops.spgemm.spgemm_dense_batched(
                    *args, None, beta, c0, b_sorted=True))
        unchecked = ()
        probe = (tdt, itype, size, over) == (torch.float64, torch.int32, 4,
                                             "a")
        if probe:
            for g in (2, 4):
                fns[f"conflict_free_stand_in_{g}"] = (
                    lambda g=g: k6_stand_in_at(stand_in, args, g))
            unchecked = ("conflict_free_stand_in_2",
                         "conflict_free_stand_in_4")
        want = spgemm.csr_spgemm_dense_batched_plain(*args, None, beta, c0)
        form = spgemm.dense_form(over == "a", over == "b")
        with SmClocks() if probe else contextlib.nullcontext() as clocks:
            times = timed_group_fns(fns, want, tdt, (
                "spgemm_dense_kernel", "spgemm_dense_group_kernel"),
                unchecked=unchecked)
        result[f"a {tdt} {itype} x{size} {over}"] = {
            "plan": list(plan), "form": form,
            "wrapper_members": spgemm.dense_group(tdt, ix.element_size(),
                                                  size, form),
            "bound": chip_smoke.k6_batched_bound(args, size),
            "times": times,
            **({"sm_clock_mhz_and_max": clocks.samples} if probe else {})}
        del av, bv, c0, want, fns
        torch.cuda.empty_cache()
    return {"shape": "demo X @ X.T, X 500x5000 CSR 21.2%", "cases": result}


def k6_stand_in_at(module, args, group):
    """The stand-in package's (``variant_package``) K6 group
    launch of ``args`` as ``chip_smoke.k6_batched_at`` makes it, op(A)'s
    values per member, op(B)'s shared."""
    from sparse_dot_tpu_torch.ops import csr

    ip, ix, av, bip, bix, bv, n = args
    m, size = ip.numel() - 1, av.shape[0]
    c = torch.empty((size, m, n), dtype=av.dtype, device=av.device)
    module.ops.spgemm._k6_launcher(ip, ix, av, bip, n, None, None, False,
                                   False)(
        bix, size, (csr.member_stride("", av, 1), 0, 0, m * n),
        av.data_ptr(), bv.data_ptr(), None, c.data_ptr(), False, group)
    return c


def k1_group_sweep(packages, inputs, rng, size=4):
    """Batched K1 at config 3 (BSR 8192^2, bs 64, 5% of blocks, b (8192,
    256) shared) over ``size`` block sets in f64 and f32: the launch at 1
    (the per-member instance), 2 and 4 members a block
    (``chip_smoke.k1_batched_at``), at 2 and 4 also on 32-row tiles (a
    variant package, K1_ROWS_32), the wrapper's
    call, the same members' single launches and each other package's
    wrapper call, in the same turns, each against the batched plain
    version."""
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import bsr

    others = other_packages(packages)
    rows_32 = variant_package(os.path.join("build", "k1_rows_32"),
                              "sdt_rows_32", [K1_ROWS_32])
    result = {}
    for dt in (np.float64, np.float32):
        a = inputs["bsrs"][(64, dt)]
        A = formats.to_device(a)
        bp, bx, _ = A.bsr_arrays()
        plan = A.bsr_plan()
        tdt = torch.from_numpy(np.zeros(0, dt)).dtype
        blocks = cuda(values(rng, (size, *a.data.shape), dt,
                             1.0 / np.sqrt(64 * 20)))
        b = cuda(inputs["b3"][dt])
        fns = {"wrapper": lambda: bsr.spmm_batched(bp, bx, blocks, b,
                                                   plan=plan)}
        for g in (1, 2, 4):
            fns[f"members_{g}"] = lambda g=g: chip_smoke.k1_batched_at(
                bp, bx, blocks, b, plan, g)
        for g in (2, 4):
            fns[f"members_{g}_rows_32"] = lambda g=g: k1_variant_at(
                rows_32, bp, bx, blocks, b, plan, g)
        fns["single_launches"] = lambda: [
            bsr.bsr_spmm(bp, bx, blocks[i], b, plan=plan)
            for i in range(size)]
        for label, other in others.items():
            oplan = other.formats.bsr_chunk_plan(bp, bx.numel())
            fns[f"{label}: wrapper"] = (
                lambda other=other, oplan=oplan: other.ops.bsr.spmm_batched(
                    bp, bx, blocks, b, plan=oplan))
        want = bsr.bsr_spmm_batched_plain(bp, bx, blocks, b)
        result[f"config3 {tdt} x{size}"] = {
            "wrapper_members": bsr.spmm_group(tdt, 64, size),
            "bound": chip_smoke.bsr_batched_bound(bp, bx, blocks, b, size),
            "times": timed_group_fns(fns, want, tdt, (
                "bsr_spmm_tc_kernel", "bsr_spmm_group_kernel",
                "bsr_reduce_kernel"))}
        del A, blocks, want, fns
        torch.cuda.empty_cache()
    return {"shape": "config 3 BSR 8192x8192, bs 64, 5% of blocks, b "
                     "(8192,256) shared", "cases": result}


def _wavefronts(cols, width, lanes_per_phase, plane_offset=0, halves=1):
    """Shared-memory wavefronts of one warp-wide access a lane a column of
    ``cols`` (the active lanes' columns, lane order), each lane reading
    ``width`` bytes at ``width * (plane_offset + column * halves)`` (and
    ``halves`` - 1 more 16-byte pieces after it, one access each): per
    phase of ``lanes_per_phase`` lanes, the most distinct words that
    meet in one of the 128-byte line's slots."""
    slots = 128 // width
    total = 0
    for h in range(halves):
        words = plane_offset + cols * halves + h
        for p in range(0, len(cols), lanes_per_phase):
            phase = np.unique(words[p:p + lanes_per_phase])
            total += int(np.bincount(phase % slots).max())
    return total


def k1_variant_at(module, ip, ix, data, b, plan, group):
    """A variant package's (``variant_package``) batched K1 launch of
    ``data``'s members, b shared, at ``group`` members a block, as
    ``chip_smoke.k1_batched_at`` makes it."""
    size, _, bs, _ = data.shape
    m, n = (ip.numel() - 1) * bs, b.shape[-1]
    c = torch.empty((size, m, n), dtype=b.dtype, device=b.device)
    module.ops.bsr._launch_k1(ip, ix, plan, None, None, False, size,
                              (data.stride(0), 0, 0, m * n), data.data_ptr(),
                              b.data_ptr(), None, c.data_ptr(), data, b,
                              group)
    return c


def k6_banks(x, positions=4, width=None):
    """The shared-memory wavefronts of K6's sum updates at the product
    op(A) @ op(B) of CSR ``x`` by its transpose (the demo X @ X.T), f64,
    one window, counted from the data as the kernels issue them: a round
    gives lane l the positions l + 32 u (u < ``positions``) of one row of
    op(B), one warp-wide access a u, a load and a store a product.  Per
    layout: the per-member kernel (8 bytes a sum), a group of 2 (16-byte
    columns), a group of 4 in two 16-byte planes (this kernel's) and in
    32-byte columns (the first design).  Each row of op(B) costs the same
    wherever op(A) names it, so its cost is counted once and weighted by
    op(A)'s entries naming it.  Returns wavefronts a member-product."""
    xt = x.T.tocsr()
    xt.sort_indices()
    named = np.bincount(x.indices, minlength=x.shape[1])
    width = width or x.shape[0]
    layouts = {"members_1": (8, 16, 1, 1), "members_2": (16, 8, 1, 2),
               "members_4_planes": (16, 8, 2, 4),
               "members_4_32_byte_columns": (16, 8, 0, 4)}
    cost = dict.fromkeys(layouts, 0)
    products = 0
    for k in range(xt.shape[0]):
        if not named[k]:
            continue
        row = xt.indices[xt.indptr[k]:xt.indptr[k + 1]].astype(np.int64)
        products += named[k] * len(row)
        span = 32 * positions
        for q0 in range(0, len(row), span):
            part = row[q0:q0 + span]
            for u in range(positions):
                cols = part[32 * u:32 * u + 32]
                if not len(cols):
                    break
                for name, (bytes_, lanes, planes, members) in layouts.items():
                    if planes == 0:  # one 32-byte column: two halves
                        w = _wavefronts(cols, bytes_, lanes, halves=2)
                    else:
                        w = sum(_wavefronts(cols, bytes_, lanes,
                                            plane_offset=p * width)
                                for p in range(planes))
                    cost[name] += 2 * named[k] * w  # a load and a store
    members = {name: spec[3] for name, spec in layouts.items()}
    return {"products_a_member": int(products),
            "wavefronts_a_member_product": {
                name: cost[name] / (products * members[name])
                for name in layouts},
            "wavefronts_a_member_product_conflict_free": {
                name: 2 * (spec[0] * 32 / 128) / (32 * spec[3])
                * (2 if spec[2] == 0 else spec[2] or 1)
                for name, spec in layouts.items()}}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", choices=("schedules", "members", "rows",
                                         "route", "groups", "sampled",
                                         "walls", "bsr", "bsr_gate",
                                         "plain_cpu", "k2k5", "k5",
                                         "k4k5", "sorted", "block",
                                         "k6k1", "k1",
                                         "k6", "k6_banks"))
    parser.add_argument("--root", help="rows: time the package of the "
                                       "checkout at ROOT instead; route, "
                                       "sampled, walls, bsr, plain_cpu, "
                                       "k2k5, k4k5 and k6k1: time it beside "
                                       "this one")
    parser.add_argument("--out", help="also write the JSON line here")
    args = parser.parse_args()
    if args.mode == "k6_banks":
        emit_line({"mode": args.mode, "shape": "demo X @ X.T, f64, one "
                   "window of 500 columns, 4 positions a lane a round",
                   **k6_banks(chip_smoke.demo_x())}, args.out)
        return
    if args.mode == "plain_cpu":
        packages = {"this checkout": "sparse_dot_tpu_torch"}
        if args.root:
            load_package(args.root, "sdt_other")
            packages["other checkout"] = "sdt_other"
        emit_line({"mode": args.mode, **plain_cpu(packages)}, args.out)
        return
    if not torch.cuda.is_available():
        print("compare_k7_k13: no CUDA device visible", file=sys.stderr)
        sys.exit(2)
    if args.mode == "k4k5":
        # cuSPARSE's SpGEMM asks for one 40 GiB buffer at case a; taken in
        # turns with the kernels' small outputs it would find the cached
        # block split.
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    packages = {"this checkout": "sparse_dot_tpu_torch"}
    if args.root and args.mode == "rows":
        # chip_smoke is this checkout's; the package is ROOT's.
        sys.path.insert(0, os.path.abspath(args.root))
    elif args.root:
        load_package(args.root, "sdt_other")
        packages["other checkout"] = "sdt_other"
    import importlib

    for name in packages.values():
        importlib.import_module(f"{name}.config").config.device = "cuda"
        importlib.import_module(f"{name}.ops.dense").ieee_matmul()
        importlib.import_module(f"{name}.ops._build").library()
    from sparse_dot_tpu_torch.ops import _build, sddmm

    rng = np.random.default_rng(SEED + 4)
    line = {"card": chip_smoke.card_line(), "mode": args.mode,
            "package": os.path.dirname(os.path.dirname(_build.__file__)),
            "library_hash": _build.source_hash()}
    if args.mode == "schedules":
        line.update(k7_batch_diagnosis(chip_smoke.path_inputs(), rng))
    elif args.mode == "members":
        line.update(members_by_type(chip_smoke.path_inputs(), rng))
    elif args.mode == "route":
        line.update(route_rows(packages))
    elif args.mode == "groups":
        line.update(group_sweep(rng))
    elif args.mode == "sampled":
        line.update(sampled_turns(packages, chip_smoke.spgemm_inputs(),
                                  rng))
    elif args.mode == "walls":
        line.update(vmap_walls(packages, chip_smoke.spgemm_inputs()))
    elif args.mode == "bsr":
        line.update(bsr_turns(packages, chip_smoke.path_inputs(), rng))
    elif args.mode == "bsr_gate":
        line.update(bsr_gate(rng))
    elif args.mode == "k5":
        line["k5"] = k5_group_sweep(packages, chip_smoke.spgemm_inputs(),
                                    rng)
    elif args.mode == "k4k5":
        line["k4k5"] = k4k5_turns(packages, chip_smoke.spgemm_inputs(), rng)
    elif args.mode == "sorted":
        line["sorted"] = sorted_variants(rng)
    elif args.mode == "block":
        line["block"] = block_variants()
    elif args.mode == "k1":
        line["k1"] = k1_group_sweep(packages, chip_smoke.path_inputs(), rng)
    elif args.mode == "k6":
        line["k6"] = k6_group_sweep(packages, chip_smoke.spgemm_inputs(),
                                    rng)
    elif args.mode == "k6k1":
        line["k1"] = k1_group_sweep(packages, chip_smoke.path_inputs(), rng)
        emit_line(line, args.out)  # the K1 half, should K6's fail
        line["k6"] = k6_group_sweep(packages, chip_smoke.spgemm_inputs(),
                                    rng)
    elif args.mode == "k2k5":
        inputs = chip_smoke.path_inputs()
        line["k2"] = k2_group_sweep(packages, inputs, rng)
        emit_line(line, args.out)  # the K2 half, should K5's fail
        line["k5"] = k5_group_sweep(packages, chip_smoke.spgemm_inputs(),
                                    rng)
    else:
        if not hasattr(sddmm, "batched_schedule"):
            # A checkout before member groups: its schedule, one member a
            # group, as its sddmm_batched takes it.
            sddmm.batched_schedule = (
                lambda n, dtype, nnz, size, strides, aligned=True,
                index_bytes=4: (sddmm.sddmm_schedule(n, dtype, size * nnz,
                                                     aligned), 1))
        rows = chip_smoke.k13_rows(device_match=("compact", "Scan"))
        chip_smoke.k7_batched_rows(rows, chip_smoke.path_inputs(), rng)
        line["rows"] = rows
    emit_line(line, args.out)


def emit_line(line, out=None):
    """Print ``line`` as one JSON line, also written to ``out`` when
    given."""
    text = json.dumps(line)
    print(text, flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
