#!/usr/bin/env python3
"""Smoke run of sparse_dot_tpu_torch on one NVIDIA GPU (built for H100).

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. card and build: the card's name and power limit, torch and CUDA
   versions; the hand kernels (``sparse_dot_tpu_torch/csrc``) built with
   nvcc for sm_90a, with the build's seconds;
2. each kernel (K1 BSR SpMM, K2 CSR SpMM, K3 CSR SpMV) against its plain
   PyTorch version on the card, for every value type and the edge cases
   (empty rows and block rows, nnz == 0, bs in {1, 3, 64, 128}, n not a
   multiple of 32), at rtol 1e-12 (f64, c128) and 1e-5 (f32, c64) with
   atol = rtol * max|plain|: the two sum in different orders, neither
   uses TF32;
3. the main path, ``dot_product`` with scipy/numpy operands at real
   sizes, against the scipy oracle at the reference's decimal=6 (f64)
   and decimal=5 (f32), with each kernel's launch count checked;
4. kernel and plain-version times at the phase-3 shapes: median of 25
   launches timed with CUDA events, L2 evicted by a read before each.

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
    "K1_bsr_spmm": {
        "source": "sparse_dot_tpu_torch/csrc/bsr_spmm.cu",
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


def random_bsr(rng, nbrows, nbcols, bs, blocks_per_row, dtype,
               index_dtype=np.int32, empty_every=0):
    lengths = rng.poisson(blocks_per_row, nbrows)
    if empty_every:
        lengths[::empty_every] = 0
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(index_dtype)
    nblocks = int(indptr[-1])
    indices = rng.integers(0, nbcols, nblocks).astype(index_dtype)
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
            # K1: block sizes 1, 3, 64, 128; empty block rows; no blocks.
            for bs, nbrows, nbcols, per_row, empty_every in (
                (1, 40, 30, 4, 3),
                (3, 30, 20, 3, 4),
                (64, 6, 5, 2, 3),
                (128, 3, 4, 2, 2),
                (8, 5, 5, 0, 0),
            ):
                indptr, indices, data = random_bsr(
                    rng, nbrows, nbcols, bs, per_row, npdt, itype,
                    empty_every)
                ip, ix, dv = cuda(indptr), cuda(indices), cuda(data)
                for n in (1, 37, 256):
                    b = cuda(values(rng, (nbcols * bs, n), npdt))
                    c0 = cuda(values(rng, (nbrows * bs, n), npdt))
                    for alpha, beta, cc in ((None, None, None),
                                            (2.0, -1.0, c0)):
                        out = bsr.bsr_spmm(ip, ix, dv, b, alpha, beta, cc)
                        ref = bsr.bsr_spmm_plain(ip, ix, dv, b, alpha, beta,
                                                 cc)
                        record("K1_bsr_spmm", compare(out, ref, tdt))
    emit(2, kernels=results)
    return results


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
    # The other layouts of the path: CSC (K2 on its CSR), dense x BSR (K1
    # on transposed blocks), BSR x vector (K3 on its element CSR).
    a1c = a1.tocsc()
    a3 = bsrs[(64, np.float64)]
    d3 = values(rng, (256, n3), np.float64)
    x3 = values(rng, n3, np.float64)

    csr.csr_spmm.launches = 0
    csr.csr_spmv.launches = 0
    bsr.bsr_spmm.launches = 0
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
    seconds = time.perf_counter() - t0
    launches = {
        "K1_bsr_spmm": bsr.bsr_spmm.launches,
        "K2_csr_spmm": csr.csr_spmm.launches,
        "K3_csr_spmv": csr.csr_spmv.launches,
    }
    expected = {"K1_bsr_spmm": len(bsrs) + 1, "K2_csr_spmm": 4,
                "K3_csr_spmv": 3}
    if launches != expected:
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
    emit(3, seconds=seconds, launches=launches, cases=cases)
    return launches, {"a1": a1, "b1": b1, "d1": d1, "bsrs": bsrs, "b3": b3,
                      "out3": out3, "av": av, "xv": xv, "ac": ac, "bc": bc}


# ---------------------------------------------------------------------------
# Phase 4: times
# ---------------------------------------------------------------------------


def time_pair(kernel_fn, plain_fn):
    """Median ms of each over REPS launches, taken in turns, and the
    largest |kernel - plain|.  Before each launch a 256 MB read evicts L2
    with clean lines (a write would leave dirty lines to drain inside the
    timed launch) and keeps the card busy while the host enqueues the
    launch, so the events time the device, not the Python call."""
    flush = torch.ones(64 << 20, dtype=torch.float32, device="cuda")
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
    return (float(np.median(times["kernel"])),
            float(np.median(times["plain"])), err)


def timings(inputs):
    from sparse_dot_tpu_torch import formats
    from sparse_dot_tpu_torch.ops import bsr, csr

    rows = []

    def add(kernel, shape, wrapper, plain, *args):
        ms, plain_ms, err = time_pair(lambda: wrapper(*args),
                                      lambda: plain(*args))
        rows.append({"kernel": kernel, "shape": shape, "ms": ms,
                     "plain_ms": plain_ms, "max_abs_err": err})

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
        add("K1_bsr_spmm",
            f"config3 BSR bs={bs} {np.dtype(dt).name} {n3}x{n3} 5% blocks "
            f"@ ({n3},256), out_scalar=2",
            bsr.bsr_spmm, bsr.bsr_spmm_plain, *A3.bsr_arrays(),
            cuda(inputs["b3"][dt]), None, 2.0, cuda(inputs["out3"][(bs, dt)]))
    Av = formats.to_device(inputs["av"])
    nv = SIZES["spmv"]
    add("K3_csr_spmv", f"CSR f64 {nv}x{nv}, 10 per row @ ({nv},)",
        csr.csr_spmv, csr.csr_spmv_plain, *Av.csr_arrays(),
        cuda(inputs["xv"]))
    emit(4, reps=REPS, timer="cuda events, median, L2 evicted by a read",
         rows=rows)
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
