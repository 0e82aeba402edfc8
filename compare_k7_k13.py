#!/usr/bin/env python3
"""Side-by-side timings of batched K7, K9 and K11, of K13 and of complex
K1 and K8 on one NVIDIA GPU.

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
(``plain_cpu``); it is the one mode that runs without a card.  Each mode
prints one JSON line, also written to
``--out`` when given.  The helpers (timing in turns after a 1 GiB read,
the plain versions' comparison, the inputs) are ``chip_smoke.py``'s.
"""

import argparse
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", choices=("schedules", "members", "rows",
                                         "route", "groups", "sampled",
                                         "walls", "bsr", "bsr_gate",
                                         "plain_cpu"))
    parser.add_argument("--root", help="rows: time the package of the "
                                       "checkout at ROOT instead; route, "
                                       "sampled, walls, bsr and plain_cpu: "
                                       "time it beside this one")
    parser.add_argument("--out", help="also write the JSON line here")
    args = parser.parse_args()
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
