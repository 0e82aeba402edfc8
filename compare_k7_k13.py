#!/usr/bin/env python3
"""Side-by-side timings of batched K7 and K13 on one NVIDIA GPU.

Run from the root of a checkout, on a machine with the card:

    python3 compare_k7_k13.py schedules        # batched K7's schedules
    python3 compare_k7_k13.py members          # members a group, by type
    python3 compare_k7_k13.py rows [--root DIR]
    python3 compare_k7_k13.py route [--root DIR]

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
too, imported beside this one, both in the same turns.  Each mode
prints one JSON line, also written to ``--out`` when given.  The helpers (timing in turns after a 1 GiB read,
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", choices=("schedules", "members", "rows",
                                         "route"))
    parser.add_argument("--root", help="rows: time the package of the "
                                       "checkout at ROOT instead; route: "
                                       "time it beside this one")
    parser.add_argument("--out", help="also write the JSON line here")
    args = parser.parse_args()
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
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
