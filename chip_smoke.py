#!/usr/bin/env python3
"""Smoke run of sparse_dot_tpu_torch on one NVIDIA GPU (built for H100).

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. card and build: the card's name and power limit, torch and CUDA
   versions; the hand kernels (``sparse_dot_tpu_torch/csrc``) built with
   one nvcc per source for sm_90a, all started together, with the
   build's seconds;
2. each kernel against its plain PyTorch version on the card, for every
   value type and both index widths, at rtol 1e-12 (f64, c128) and 1e-5
   (f32, c64) with atol = rtol * max|plain|: the two sum in different
   orders, neither uses plain TF32.  K2 CSR SpMM and K3 CSR SpMV at empty
   rows, nnz == 0 and n not a multiple of 32.  K1 BSR SpMM in both
   variants: the tensor-core one (real values, bs in {8, 16, 24, 64,
   128, 256}) and the CUDA-core one (complex values, and bs in {1, 3}),
   at n in {1, 37, 64, 256}, with empty block rows, no stored block, a
   block row at least 3x the chunk length (split and summed; run twice,
   same bits), f32 values log-uniform over 1e-3..1e3 (plain TF32 would
   fail) and inf in A and B; each call's variant is checked by the
   per-variant launch counts;
3. the main path, ``dot_product`` with scipy/numpy operands at real
   sizes, against the scipy oracle at the reference's decimal=6 (f64)
   and decimal=5 (f32), with each kernel's launch count checked (the
   config-3 and dense x BSR calls on K1's tensor-core variant, a complex
   BSR on its CUDA-core one);
4. kernel and plain-version times at the phase-3 shapes: median, p10 and
   p90 of 25 launches timed with CUDA events, L2 evicted by a 1 GiB read
   before each; for K1 also TFLOP/s and the stored blocks per block row.

Then the card line, a JSON line of per-kernel results and, last,
``{"ok": true, "device": {...}}``.  Any failure is an uncaught exception
and a non-zero exit; without a CUDA device it exits 2 before any work.
"""

import json
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sps
import torch

SEED = 20261016
REPS = 25
# Phase-3 sizes: BASELINE config 1 (CSR side), config 3 (BSR side), the
# SpMV rows and the complex SpMM side.
SIZES = {"config1": 10_000, "config3": 8192, "spmv": 1_000_000,
         "complex": 4000}
RTOL = {
    torch.float32: 1e-5,
    torch.complex64: 1e-5,
    torch.float64: 1e-12,
    torch.complex128: 1e-12,
}
NP_DTYPES = {
    torch.float32: np.float32,
    torch.float64: np.float64,
    torch.complex64: np.complex64,
    torch.complex128: np.complex128,
}
KERNELS = {
    "K1_bsr_spmm_tc": {
        "source": "sparse_dot_tpu_torch/csrc/bsr_spmm.cu",
        "replaces": "sparse_dot_tpu/ops/pallas_bsr.py:57",
    },
    "K1_bsr_spmm_simt": {
        "source": "sparse_dot_tpu_torch/csrc/bsr_spmm_simt.cu",
        "replaces": "sparse_dot_tpu/ops/pallas_bsr.py:57",
    },
    "K2_csr_spmm": {
        "source": "sparse_dot_tpu_torch/csrc/csr_spmm.cu",
        "replaces": "sparse_dot_tpu/ops/_xla.py:648",
    },
    "K3_csr_spmv": {
        "source": "sparse_dot_tpu_torch/csrc/csr_spmv.cu",
        "replaces": "sparse_dot_tpu/ops/_xla.py:769",
    },
}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return proc.stdout.strip()


def values(rng, size, dtype, scale=1.0):
    """Random values of a numpy dtype, N(0, scale^2) parts."""
    v = rng.standard_normal(size)
    if np.dtype(dtype).kind == "c":
        v = v + 1j * rng.standard_normal(size)
    return (v * scale).astype(dtype)


def cuda(arr):
    return torch.from_numpy(np.ascontiguousarray(arr)).cuda()


def compare(kernel_out, plain_out, dtype):
    """Largest |kernel - plain|; raises past rtol * (|plain| + max|plain|)."""
    torch.cuda.synchronize()
    rtol = RTOL[dtype]
    scale = float(plain_out.abs().max()) if plain_out.numel() else 0.0
    torch.testing.assert_close(
        kernel_out, plain_out, rtol=rtol, atol=rtol * scale,
        equal_nan=False,
    )
    if not plain_out.numel():
        return 0.0
    return float((kernel_out - plain_out).abs().max())


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def random_csr(rng, m, k, mean_row, dtype, index_dtype=np.int32,
               empty_every=0, long_row=0):
    """CSR arrays with Poisson row lengths (some rows empty, one long row
    optional) and unsorted, possibly repeated column indices."""
    lengths = rng.poisson(mean_row, m) if m else np.zeros(0, np.int64)
    if empty_every:
        lengths[::empty_every] = 0
    if long_row and m:
        lengths[m // 2] = long_row
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(index_dtype)
    nnz = int(indptr[-1])
    indices = rng.integers(0, k, nnz).astype(index_dtype)
    data = values(rng, nnz, dtype, 1.0 / np.sqrt(max(mean_row, 1)))
    return indptr, indices, data


def log_uniform(rng, size, dtype):
    """Random signs times magnitudes spread log-uniformly over 1e-3..1e3:
    f32 products that plain TF32 (11 bits) would round by up to ~1e-4 of
    the largest, past the f32 tolerance."""
    mag = 10.0 ** rng.uniform(-3.0, 3.0, size)
    return (mag * rng.choice([-1.0, 1.0], size)).astype(dtype)


def random_bsr(rng, nbrows, nbcols, bs, blocks_per_row, dtype,
               index_dtype=np.int32, empty_every=0, split=False):
    """BSR arrays with Poisson block rows (every empty_every-th empty).
    split=True makes block row 1 at least 3x the chunk length S (the mean
    number of stored blocks per block row, rounded up), so K1's
    tensor-core variant splits it and sums the partial tiles; f32 values
    are log-uniform there (``log_uniform``)."""
    lengths = rng.poisson(blocks_per_row, nbrows)
    if empty_every:
        lengths[::empty_every] = 0
    if split:
        rest = int(lengths.sum() - lengths[1])
        lengths[1] = 1
        while lengths[1] < 3 * -(-(rest + lengths[1]) // nbrows):
            lengths[1] += 1
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(index_dtype)
    nblocks = int(indptr[-1])
    indices = rng.integers(0, nbcols, nblocks).astype(index_dtype)
    if split and np.dtype(dtype) == np.float32:
        data = log_uniform(rng, (nblocks, bs, bs), dtype)
    else:
        scale = 1.0 / np.sqrt(max(bs * blocks_per_row, 1))
        data = values(rng, (nblocks, bs, bs), dtype, scale)
    return indptr, indices, data


def check_kernels():
    from sparse_dot_tpu_torch.ops import bsr, csr

    rng = np.random.default_rng(SEED)
    results = {name: {"cases": 0, "max_abs_err": 0.0} for name in KERNELS}

    def record(name, err):
        results[name]["cases"] += 1
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)

    for tdt, npdt in NP_DTYPES.items():
        for itype in (np.int32, np.int64):
            # K2 / K3: mean row 3 (4 lanes), 12 (16 lanes), 40 (32 lanes,
            # and rows longer than a warp's batch of 32), empty rows, one
            # long row, nnz == 0, an empty matrix.
            for m, k, mean_row, empty_every, long_row in (
                (300, 200, 3, 5, 0),
                (257, 190, 12, 0, 500),
                (128, 300, 40, 3, 0),
                (50, 40, 0, 0, 0),
                (0, 40, 2, 0, 0),
            ):
                indptr, indices, data = random_csr(
                    rng, m, k, mean_row, npdt, itype, empty_every, long_row)
                ip, ix, dv = cuda(indptr), cuda(indices), cuda(data)
                for n in (1, 37, 128, 200):
                    b = cuda(values(rng, (k, n), npdt))
                    c0 = cuda(values(rng, (m, n), npdt))
                    for alpha, beta, cc in ((None, None, None),
                                            (0.5, 2.0, c0)):
                        out = csr.csr_spmm(ip, ix, dv, b, alpha, beta, cc)
                        ref = csr.csr_spmm_plain(ip, ix, dv, b, alpha, beta,
                                                 cc)
                        record("K2_csr_spmm", compare(out, ref, tdt))
                x = cuda(values(rng, k, npdt))
                y0 = cuda(values(rng, m, npdt))
                for alpha, beta, yy in ((None, None, None), (-1.5, 3.0, y0)):
                    out = csr.csr_spmv(ip, ix, dv, x, alpha, beta, yy)
                    ref = csr.csr_spmv_plain(ip, ix, dv, x, alpha, beta, yy)
                    record("K3_csr_spmv", compare(out, ref, tdt))
            check_k1(rng, tdt, npdt, itype, record)
    check_k1_special(rng, record)
    emit(2, kernels=results)
    return results


# K1 cases: (bs, nbrows, nbcols, blocks per row, every k-th block row
# empty, one block row split).  bs % 8 == 0 runs the tensor-core variant
# for real values, the rest (and complex values) the CUDA-core one.
K1_CASES = (
    (1, 40, 30, 4, 3, False),
    (3, 30, 20, 3, 4, False),
    (8, 24, 20, 3, 5, True),
    (16, 16, 12, 2, 4, True),
    (24, 12, 10, 2, 3, True),
    (64, 8, 6, 1, 3, True),
    (128, 6, 5, 1, 3, True),
    (256, 6, 4, 1, 3, True),
    (8, 5, 5, 0, 0, False),  # no stored block
)
K1_NS = (1, 37, 64, 256)


def k1_call(*args):
    """(variant, bsr_spmm(*args)): the K1 variant that the value type and
    block size select, checked to be the one the launch counts show."""
    from sparse_dot_tpu_torch.ops import bsr

    data = args[2]
    tc = bsr.uses_tensor_cores(data.dtype, data.shape[1])
    before = (bsr.bsr_spmm.launches_tc, bsr.bsr_spmm.launches_simt)
    out = bsr.bsr_spmm(*args)
    variant = "K1_bsr_spmm_tc" if tc else "K1_bsr_spmm_simt"
    if (bsr.bsr_spmm.launches_tc - before[0],
            bsr.bsr_spmm.launches_simt - before[1]) != (tc, not tc):
        raise AssertionError(f"bsr_spmm did not launch {variant} once")
    return variant, out


def check_k1(rng, tdt, npdt, itype, record):
    """K1 against bsr_spmm_plain at every case of K1_CASES and n of K1_NS,
    with and without the alpha/beta/C0 epilogue; a split case is run
    twice and must give the same bits."""
    from sparse_dot_tpu_torch.formats import bsr_chunk_length
    from sparse_dot_tpu_torch.ops import bsr

    for bs, nbrows, nbcols, per_row, empty_every, split in K1_CASES:
        indptr, indices, data = random_bsr(
            rng, nbrows, nbcols, bs, per_row, npdt, itype, empty_every,
            split)
        ip, ix, dv = cuda(indptr), cuda(indices), cuda(data)
        lengths = np.diff(indptr)
        if split and (lengths.max() < 3 * bsr_chunk_length(nbrows,
                                                           len(indices))
                      or lengths.min() > 0):
            raise AssertionError(f"K1 case bs={bs}: no split or empty row")
        log_b = split and npdt == np.float32
        for n in K1_NS:
            b = cuda((log_uniform if log_b else values)(
                rng, (nbcols * bs, n), npdt))
            c0 = cuda(values(rng, (nbrows * bs, n), npdt))
            for alpha, beta, cc in ((None, None, None), (2.0, -1.0, c0)):
                args = (ip, ix, dv, b, alpha, beta, cc)
                variant, out = k1_call(*args)
                record(variant, compare(out, bsr.bsr_spmm_plain(*args), tdt))
                if split and n == 37:
                    if not torch.equal(out, k1_call(*args)[1]):
                        raise AssertionError(f"K1 bs={bs}: runs differ")


def check_k1_special(rng, record):
    """inf in A and in B on the tensor-core variant: the same inf/nan
    pattern as the plain version (3xTF32 must not make inf * 0), finite
    values within tolerance."""
    from sparse_dot_tpu_torch.ops import bsr

    for tdt in (torch.float32, torch.float64):
        npdt = NP_DTYPES[tdt]
        indptr, indices, data = random_bsr(rng, 8, 6, 64, 1, npdt,
                                           split=True)
        data[0, 5, 7] = np.inf
        b = values(rng, (6 * 64, 64), npdt)
        b[100, 3] = -np.inf
        args = (cuda(indptr), cuda(indices), cuda(data), cuda(b))
        variant, out = k1_call(*args)
        ref = bsr.bsr_spmm_plain(*args)
        torch.cuda.synchronize()
        for what in (torch.isnan, torch.isposinf, torch.isneginf):
            if not torch.equal(what(out), what(ref)):
                raise AssertionError(f"K1 {tdt}: {what.__name__} differs")
        fin = torch.isfinite(ref)
        if not bool(torch.isinf(ref).any()):
            raise AssertionError("K1 inf case: no inf reached the output")
        record(variant, compare(out[fin], ref[fin], tdt))


# ---------------------------------------------------------------------------
# Phase 3: the main path through dot_product at real sizes
# ---------------------------------------------------------------------------


def config1_csr(rng, size, dtype=np.float64, density=0.01):
    """BASELINE config 1: CSR, 10,000 x 10,000 at 1% density; values
    N(0, 1/100) so products of a 100-nonzero row are of order 1."""
    scale = 1.0 / np.sqrt(size * density)
    return sps.random(
        size, size, density=density, format="csr", dtype=dtype,
        random_state=rng,
        data_rvs=lambda s: values(rng, s, dtype, scale),
    )


def config3_bsr(rng, size, dtype, bs, block_density=0.05):
    """BASELINE config 3: BSR, 8192 x 8192, 5% of blocks stored."""
    nb = size // bs
    pattern = sps.random(nb, nb, density=block_density, format="csr",
                         random_state=rng)
    scale = 1.0 / np.sqrt(bs * nb * block_density)
    data = values(rng, (pattern.nnz, bs, bs), dtype, scale)
    return sps.bsr_matrix((data, pattern.indices, pattern.indptr),
                          shape=(size, size))


def spmv_csr(rng, size, per_row=10):
    """CSR f64, 1,000,000 x 1,000,000, 10 nonzeros per row: one column in
    each tenth of the width, so rows are sorted and free of repeats."""
    band = size // per_row
    cols = (rng.integers(0, band, (size, per_row))
            + np.arange(per_row) * band).reshape(-1)
    indptr = np.arange(0, size * per_row + 1, per_row)
    data = values(rng, size * per_row, np.float64, 1.0 / np.sqrt(per_row))
    return sps.csr_matrix((data, cols, indptr), shape=(size, size))


def main_path():
    import sparse_dot_tpu_torch as sdt
    from sparse_dot_tpu_torch.ops import bsr, csr

    rng = np.random.default_rng(SEED + 1)
    cases = {}

    def check(name, res, ref, decimal):
        if res.shape != ref.shape or not np.isfinite(res).all():
            raise AssertionError(f"{name}: shape {res.shape} or non-finite")
        np.testing.assert_array_almost_equal(res, ref, decimal=decimal)
        cases[name] = {"shape": list(res.shape), "dtype": str(res.dtype),
                       "max_abs_err": float(np.abs(res - ref).max())}

    n1, n3, nc = SIZES["config1"], SIZES["config3"], SIZES["complex"]
    a1 = config1_csr(rng, n1)
    b1 = values(rng, (n1, 128), np.float64)
    d1 = values(rng, (128, n1), np.float64)
    bsrs = {(bs, dt): config3_bsr(rng, n3, dt, bs)
            for bs in (64, 128) for dt in (np.float32, np.float64)}
    b3 = {dt: values(rng, (n3, 256), dt) for dt in (np.float32, np.float64)}
    out3 = {key: values(rng, (n3, 256), key[1]) for key in bsrs}
    av = spmv_csr(rng, SIZES["spmv"])
    xv = values(rng, av.shape[1], np.float64)
    xt = values(rng, av.shape[0], np.float64)
    ac = config1_csr(rng, nc, np.complex128)
    bc = values(rng, (nc, 64), np.complex128)
    # Complex BSR: K1's CUDA-core variant.
    abc = config3_bsr(rng, nc, np.complex128, 16)
    # The other layouts of the path: CSC (K2 on its CSR), dense x BSR (K1
    # on transposed blocks), BSR x vector (K3 on its element CSR).
    a1c = a1.tocsc()
    a3 = bsrs[(64, np.float64)]
    d3 = values(rng, (256, n3), np.float64)
    x3 = values(rng, n3, np.float64)

    csr.csr_spmm.launches = 0
    csr.csr_spmv.launches = 0
    bsr.bsr_spmm.launches = 0
    bsr.bsr_spmm.launches_tc = 0
    bsr.bsr_spmm.launches_simt = 0
    t0 = time.perf_counter()
    r1 = sdt.dot_product(a1, b1)
    r1t = sdt.dot_product(d1, a1)
    r3 = {}
    for (bs, dt), a3 in bsrs.items():
        out = out3[(bs, dt)].copy()
        r3[(bs, dt)] = sdt.dot_product(a3, b3[dt], out=out, out_scalar=2.0)
        if r3[(bs, dt)] is not out:
            raise AssertionError("dot_product(out=...) did not return out")
    rv = sdt.dot_product(av, xv)
    rvt = sdt.dot_product(xt, av)
    rc = sdt.dot_product(ac, bc)
    r1c = sdt.dot_product(a1c, b1)
    r3t = sdt.dot_product(d3, a3)
    r3v = sdt.dot_product(a3, x3)
    rbc = sdt.dot_product(abc, bc)
    seconds = time.perf_counter() - t0
    launches = {
        "K1_bsr_spmm_tc": bsr.bsr_spmm.launches_tc,
        "K1_bsr_spmm_simt": bsr.bsr_spmm.launches_simt,
        "K2_csr_spmm": csr.csr_spmm.launches,
        "K3_csr_spmv": csr.csr_spmv.launches,
    }
    # The four config-3 calls and dense x BSR on the tensor cores, the
    # complex BSR on the CUDA cores.
    expected = {"K1_bsr_spmm_tc": len(bsrs) + 1, "K1_bsr_spmm_simt": 1,
                "K2_csr_spmm": 4, "K3_csr_spmv": 3}
    if (launches != expected or bsr.bsr_spmm.launches
            != launches["K1_bsr_spmm_tc"] + launches["K1_bsr_spmm_simt"]):
        raise AssertionError(f"launch counts {launches}, expected {expected}")

    check("config1_csr_f64_spmm", r1, a1 @ b1, 6)
    check("config1_dense_x_csr_f64", r1t, (a1.T @ d1.T).T, 6)
    for (bs, dt), a3 in bsrs.items():
        ref = (a3.astype(np.float64) @ b3[dt].astype(np.float64)
               + 2.0 * out3[(bs, dt)].astype(np.float64))
        check(f"config3_bsr{bs}_{np.dtype(dt).name}_out",
              r3[(bs, dt)], ref, 6 if dt == np.float64 else 5)
    check("spmv_csr_f64_1M", rv, av @ xv, 6)
    check("vector_x_csr_f64_1M", rvt, av.T @ xt, 6)
    check("csr_c128_spmm", rc, ac @ bc, 6)
    check("config1_csc_f64_spmm", r1c, a1 @ b1, 6)
    check("config3_dense_x_bsr64_f64", r3t, (a3.T @ d3.T).T, 6)
    check("config3_bsr64_f64_x_vector", r3v, a3 @ x3, 6)
    check("bsr16_c128_spmm", rbc, abc @ bc, 6)
    emit(3, seconds=seconds, launches=launches, cases=cases)
    return launches, {"a1": a1, "b1": b1, "d1": d1, "bsrs": bsrs, "b3": b3,
                      "out3": out3, "av": av, "xv": xv, "ac": ac, "bc": bc,
                      "abc": abc}


# ---------------------------------------------------------------------------
# Phase 4: times
# ---------------------------------------------------------------------------


def time_pair(kernel_fn, plain_fn):
    """The REPS times in ms of each, taken in turns, and the largest
    |kernel - plain|.  Before each launch a 1 GiB read evicts L2 with
    clean lines (a write would leave dirty lines to drain inside the timed
    launch) and keeps the card busy for ~0.3 ms while the host enqueues
    the call, so the events time the device, not the Python call (a
    256 MB read covered ~85 us, less than the plain versions' host side
    of up to 0.36 ms)."""
    flush = torch.ones(256 << 20, dtype=torch.float32, device="cuda")
    out_k, out_p = kernel_fn(), plain_fn()
    err = compare(out_k, out_p, out_k.dtype)
    times = {"kernel": [], "plain": []}
    for _ in range(REPS):
        for name, fn in (("plain", plain_fn), ("kernel", kernel_fn)):
            flush.sum()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return times["kernel"], times["plain"], err


def spread(times):
    """Median, p10 and p90 of a list of ms."""
    p10, p50, p90 = np.percentile(times, [10, 50, 90])
    return float(p50), float(p10), float(p90)


def timings(inputs):
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import bsr, csr

    rows = []

    def add(kernel, shape, wrapper, plain, *args, flop=None, **extra):
        kt, pt, err = time_pair(lambda: wrapper(*args), lambda: plain(*args))
        (ms, p10, p90), (plain_ms, plain_p10, plain_p90) = (spread(kt),
                                                            spread(pt))
        if flop:
            extra.update(gflop=flop / 1e9, tflops=flop / ms / 1e9,
                         plain_tflops=flop / plain_ms / 1e9)
        rows.append({"kernel": kernel, "shape": shape, "ms": ms,
                     "p10": p10, "p90": p90, "plain_ms": plain_ms,
                     "plain_p10": plain_p10, "plain_p90": plain_p90,
                     "max_abs_err": err, **extra})

    n1, n3, nc = SIZES["config1"], SIZES["config3"], SIZES["complex"]
    A1 = formats.to_device(inputs["a1"])
    add("K2_csr_spmm", f"config1 CSR f64 {n1}x{n1} 1% @ ({n1},128)",
        csr.csr_spmm, csr.csr_spmm_plain, *A1.csr_arrays(),
        cuda(inputs["b1"]))
    add("K2_csr_spmm", f"config1 (128,{n1}) @ CSR f64 (transposed CSR)",
        csr.csr_spmm, csr.csr_spmm_plain, *A1.csr_arrays(transpose=True),
        cuda(inputs["d1"].T))
    Ac = formats.to_device(inputs["ac"])
    add("K2_csr_spmm", f"CSR c128 {nc}x{nc} 1% @ ({nc},64)",
        csr.csr_spmm, csr.csr_spmm_plain, *Ac.csr_arrays(),
        cuda(inputs["bc"]))
    for (bs, dt), a3 in inputs["bsrs"].items():
        A3 = formats.to_device(a3)
        lengths = np.diff(a3.indptr)
        plan = A3.bsr_plan()  # as dot_product passes it, built once
        add("K1_bsr_spmm_tc",
            f"config3 BSR bs={bs} {np.dtype(dt).name} {n3}x{n3} 5% blocks "
            f"@ ({n3},256), out_scalar=2",
            lambda *a: bsr.bsr_spmm(*a, plan=plan), bsr.bsr_spmm_plain,
            *A3.bsr_arrays(), cuda(inputs["b3"][dt]), None, 2.0,
            cuda(inputs["out3"][(bs, dt)]), flop=2.0 * a3.nnz * 256,
            blocks_per_row_mean=float(lengths.mean()),
            blocks_per_row_max=int(lengths.max()), chunk=plan.chunk)
    Abc = formats.to_device(inputs["abc"])
    add("K1_bsr_spmm_simt", f"BSR c128 bs=16 {nc}x{nc} 5% blocks @ ({nc},64)",
        bsr.bsr_spmm, bsr.bsr_spmm_plain, *Abc.bsr_arrays(),
        cuda(inputs["bc"]))
    Av = formats.to_device(inputs["av"])
    nv = SIZES["spmv"]
    add("K3_csr_spmv", f"CSR f64 {nv}x{nv}, 10 per row @ ({nv},)",
        csr.csr_spmv, csr.csr_spmv_plain, *Av.csr_arrays(),
        cuda(inputs["xv"]))
    emit(4, reps=REPS, rows=rows,
         timer="cuda events, median (p10, p90), 1 GiB read before each")
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        sys.exit(2)

    from sparse_dot_tpu_torch.config import config
    from sparse_dot_tpu_torch.ops import _build, dense

    config.device = "cuda"
    dense.ieee_matmul()
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.library()
    emit(1, card=card, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         nvcc_seconds=_build.build_seconds,
         build_and_load_seconds=time.perf_counter() - t0,
         library_hash=_build.source_hash())

    check_kernels()
    launches, inputs = main_path()
    rows = timings(inputs)

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    summary = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        summary.append({
            "name": name, "route": "cuda", **meta,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": mine[0]["ms"], "plain_ms": mine[0]["plain_ms"],
        })
    print(card, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
