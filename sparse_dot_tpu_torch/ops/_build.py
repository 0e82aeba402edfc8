"""Build and load the hand-written CUDA kernels of ``csrc/``.

The JAX package compiled its device code through XLA; the port's kernels
are CUDA C++ for Hopper (``sm_90a``), compiled at first use by one

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c -o <name>.o csrc/<name>.cu

for each source, all started together, and linked with ``nvcc -shared``
into one shared library with a plain C interface, loaded with ``ctypes``
(no PyTorch headers, so the build takes seconds).  The library's name
carries a hash of the sources and flags, so a changed source rebuilds.
It goes to ``build/sparse_dot_tpu_torch/`` at the root of the checkout,
or to ``$SPARSE_DOT_BUILD_DIR``.  Nothing is built when the module is
imported; ``library()`` builds on its first call.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

# Element / index type codes of the C interface (csrc/common.cuh).
DTYPE_CODES = {
    torch.float32: 0,
    torch.float64: 1,
    torch.complex64: 2,
    torch.complex128: 3,
}
ITYPE_CODES = {torch.int32: 0, torch.int64: 1}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_D = ctypes.c_double
_INT = ctypes.c_int
# Members of one batched launch of K1, K2, K5, K6, K7, K8, K9 or K11: the
# grid's y and z dimensions hold at most 65,535 blocks (``kMaxMembers`` in
# ``csrc/common.cuh``); a larger batch is cut into launches of at most
# this many.
MAX_MEMBERS = 65535

# Every pointer and the stream are c_void_p: ctypes would cut a Python
# int passed as a plain int to 32 bits.  ``batch, s_*``: the members of a
# launch (1 for one product) and each operand's member stride in elements
# (0: shared by all members).
_PROTOTYPES = {
    # dtype, itype, indptr, indices, data, b, c0, c, work, counts, chunks,
    # n_chunks, m, n, chunk, vec, lanes, split, per_lane, alpha_re,
    # alpha_im, beta_re, beta_im, batch, s_data, s_b, s_c0, s_c, stream
    "sdt_csr_spmm": (_INT, _INT, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64,
                     _I64, _I64, _I64, _INT, _INT, _INT, _INT,
                     _D, _D, _D, _D, _I64, _I64, _I64, _I64, _I64, _P),
    # dtype, itype, indptr, indices, data, b, c0, c, work, counts, chunks,
    # n_chunks, m, n, chunk, vec, lanes, split, per_lane, alpha_re,
    # alpha_im, beta_re, beta_im, batch, s_data, s_c0, s_c, group, stream
    # (b shared by the batch, ``group`` members a block)
    "sdt_csr_spmm_group": (_INT, _INT, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I64, _I64, _I64, _I64, _INT, _INT, _INT, _INT,
                           _D, _D, _D, _D, _I64, _I64, _I64, _I64, _INT,
                           _P),
    # dtype, itype, indptr, indices, data, x, y0, y, work, counts, tiles,
    # n_tiles, chunks, n_chunks, m, tile, alpha_re, alpha_im, beta_re,
    # beta_im, stream
    "sdt_csr_spmv": (_INT, _INT, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64,
                     _P, _I64, _I64, _INT, _D, _D, _D, _D, _P),
    # dtype, itype, indptr, indices, data, b, c0, c, nbrows, bs, n,
    # alpha_re, alpha_im, beta_re, beta_im, batch, s_data, s_b, s_c0, s_c,
    # stream
    "sdt_bsr_spmm_simt": (_INT, _INT, _P, _P, _P, _P, _P, _P, _I64, _I64,
                          _I64, _D, _D, _D, _D, _I64, _I64, _I64, _I64,
                          _I64, _P),
    # dtype, itype, items, n_items, splits, n_splits, indices, data, b, c0,
    # c, work, slots, bs, n, alpha_re, alpha_im, beta_re, beta_im, batch,
    # s_data, s_b, s_c0, s_c, stream
    "sdt_bsr_spmm_tc": (_INT, _INT, _P, _I64, _P, _I64, _P, _P, _P, _P, _P,
                        _P, _I64, _I64, _I64, _D, _D, _D, _D, _I64, _I64,
                        _I64, _I64, _I64, _P),
    # dtype, itype, items, n_items, splits, n_splits, indices, data, b, c0,
    # c, work, slots, bs, n, alpha_re, alpha_im, beta_re, beta_im, batch,
    # s_data, s_c0, s_c, group, stream (b shared by the batch, ``group``
    # members a block)
    "sdt_bsr_spmm_tc_group": (_INT, _INT, _P, _I64, _P, _I64, _P, _P, _P,
                              _P, _P, _P, _I64, _I64, _I64, _D, _D, _D, _D,
                              _I64, _I64, _I64, _I64, _INT, _P),
    # itype, a_indptr, a_indices, b_indptr, b_indices, rows, offsets,
    # bins (host), nbins, n, triangular, counts, work, work_groups,
    # u_max (host, or None), m, lanes, tile_rows, ub, tile_bins, stream
    "sdt_csr_spgemm_count": (_INT, _P, _P, _P, _P, _P, _P, _P, _INT, _I64,
                             _INT, _P, _P, _I64, _P, _I64, _INT, _INT, _P,
                             _P, _P),
    # dtype, itype, a_indptr, a_indices, a_data, b_indptr, b_indices,
    # b_data, rows, offsets, bins (host), nbins, n, triangular, c_indptr,
    # c_indices, c_data, work, work_groups, batch, s_a, s_b, s_c,
    # write_indices, stream
    "sdt_csr_spgemm_fill": (_INT, _INT, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _INT, _I64, _INT, _P, _P, _P, _P, _I64, _I64,
                            _I64, _I64, _I64, _INT, _P),
    # dtype, itype, a_indptr, a_indices, a_data, b_indptr, b_indices,
    # b_data, rows, offsets, bins (host, no DENSE_GLOBAL bin), nbins, n,
    # triangular, c_indptr, c_indices, c_data, batch, s_a, s_b, s_c,
    # write_indices, group, stream (``group`` members a block)
    "sdt_csr_spgemm_fill_group": (_INT, _INT, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _P, _INT, _I64, _INT, _P, _P, _P,
                                  _I64, _I64, _I64, _I64, _INT, _INT, _P),
    # dtype, itype, indptr, indices, g, b, out, m, n, nnz, vec, lanes,
    # per_lane, round, span, alpha_re, alpha_im, batch, s_g, s_b, s_out,
    # shared, stream
    "sdt_csr_sddmm": (_INT, _INT, _P, _P, _P, _P, _P, _I64, _I64, _I64, _INT,
                      _INT, _INT, _INT, _I64, _D, _D, _I64, _I64, _I64, _I64,
                      _INT, _P),
    # dtype, itype, a_indptr, a_indices, a_data, b_indptr, b_indices,
    # b_data, c0, c, m, n, alpha_re, alpha_im, beta_re, beta_im,
    # triangular, splits, width, k, starts (scratch), starts_ready, batch,
    # s_a, s_b, s_c0, s_c, stream
    "sdt_csr_spgemm_dense": (_INT, _INT, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I64, _I64, _D, _D, _D, _D, _INT, _INT, _I64,
                             _I64, _P, _INT, _I64, _I64, _I64, _I64, _I64,
                             _P),
    # the same, then group (``group`` members a block), stream
    "sdt_csr_spgemm_dense_group": (_INT, _INT, _P, _P, _P, _P, _P, _P, _P,
                                   _P, _I64, _I64, _D, _D, _D, _D, _INT,
                                   _INT, _I64, _I64, _P, _INT, _I64, _I64,
                                   _I64, _I64, _I64, _INT, _P),
    # dtype, itype, indptr, nbrows, indices, nblocks, g, b, out, bs, n,
    # alpha_re, alpha_im, batch, s_g, s_b, s_out, stream
    "sdt_bsr_sddmm_simt": (_INT, _INT, _P, _I64, _P, _I64, _P, _P, _P, _I64,
                           _I64, _D, _D, _I64, _I64, _I64, _I64, _P),
    # dtype, itype, indptr, nbrows, indices, nblocks, g, b, out, bs, n,
    # alpha_re, alpha_im, batch, s_g, s_b, s_out, stream
    "sdt_bsr_sddmm_tc": (_INT, _INT, _P, _I64, _P, _I64, _P, _P, _P, _I64,
                         _I64, _D, _D, _I64, _I64, _I64, _I64, _P),
    # dtype, itype, items, n_items, run_ptr, run_q, perm, line, d, se, sy,
    # ne, ny, panel, pitch, staged, y_indptr, y_indices, y_data, out,
    # lanes, alpha_re, alpha_im, batch, s_d, s_y, s_out, stream
    "sdt_csr_spgemm_sddmm": (_INT, _INT, _P, _I64, _P, _P, _P, _P, _P, _I64,
                             _I64, _I64, _I64, _INT, _INT, _INT, _P, _P, _P,
                             _P, _INT, _D, _D, _I64, _I64, _I64, _I64, _P),
    # dtype, itype, items, n_items, run_ptr, run_q, perm, line, ne, ny,
    # panel, pitch, staged, p_indptr, p_indices, p_rows, y_indptr,
    # y_indices, y_data, c_indptr, c_indices, g, out, transposed,
    # triangular, lanes, batch, s_y, s_g, s_out, stream
    "sdt_csr_spgemm_sparse_sddmm": (_INT, _INT, _P, _I64, _P, _P, _P, _P,
                                    _I64, _I64, _INT, _INT, _INT, _P, _P,
                                    _I64, _P, _P, _P, _P, _P, _P, _P, _INT,
                                    _INT, _INT, _I64, _I64, _I64, _I64, _P),
    # dtype, itype, items, n_items, run_ptr, run_q, perm, line, d, se, sy,
    # ne, ny, panel, pitch, y_indptr, y_indices, y_data, out, lanes,
    # alpha_re, alpha_im, batch, s_d, s_out, group, stream
    "sdt_csr_spgemm_sddmm_group": (_INT, _INT, _P, _I64, _P, _P, _P, _P, _P,
                                   _I64, _I64, _I64, _I64, _INT, _INT, _P,
                                   _P, _P, _P, _INT, _D, _D, _I64, _I64,
                                   _I64, _INT, _P),
    # dtype, itype, items, n_items, run_ptr, run_q, perm, line, ne, ny,
    # panel, pitch, y_indptr, y_indices, y_data, c_indptr, c_indices, g,
    # out, transposed, triangular, lanes, batch, s_g, s_out, group, stream
    "sdt_csr_spgemm_sparse_sddmm_group": (_INT, _INT, _P, _I64, _P, _P, _P,
                                          _P, _I64, _I64, _INT, _INT, _P,
                                          _P, _P, _P, _P, _P, _P, _INT,
                                          _INT, _INT, _I64, _I64, _I64,
                                          _INT, _P),
    # dtype, itype, indptr, indices, data, out, m, k, rows_per_tile, stream
    "sdt_csr_densify": (_INT, _INT, _P, _P, _P, _P, _I64, _I64, _I64, _P),
    # itype, indptr, indices, out, m, k, rows_per_tile, stream
    "sdt_csr_indicator": (_INT, _P, _P, _P, _I64, _I64, _I64, _P),
    # dtype, itype, c, p, r, n, triangular, row0, rows_per_tile, q,
    # staged, status, ticket, tag, indptr, indices, data, total, stream
    "sdt_csr_compact": (_INT, _INT, _P, _P, _I64, _I64, _INT, _I64, _INT,
                        _INT, _INT, _P, _P, _I64, _P, _P, _P, _P, _P),
}

_lib = None
build_seconds = None  # wall time of the nvcc run, None when none ran


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir():
    env = os.environ.get("SPARSE_DOT_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "sparse_dot_tpu_torch"


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built"
    )


def _run(procs):
    """Wait for every (command, process); raise on the first failure."""
    failed = None
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out, err)
    if failed:
        cmd, rc, out, err = failed
        raise RuntimeError(
            f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}\n{err}"
        )


def _compile(target):
    global build_seconds
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    units = [p for p in sources() if p.suffix == ".cu"]
    objects = [tmp.with_name(f"{tmp.name}.{p.stem}.o") for p in units]
    nvcc = _nvcc()

    def start(*args):
        cmd = [nvcc, *NVCC_FLAGS, *args]
        return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)

    t0 = time.perf_counter()
    try:
        _run([start("-c", "-o", str(obj), str(src))
              for src, obj in zip(units, objects)])
        _run([start("-shared", "-o", str(tmp), *map(str, objects))])
        build_seconds = time.perf_counter() - t0
        os.replace(tmp, target)  # atomic: a concurrent build cannot tear it
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objects:
            obj.unlink(missing_ok=True)


def library():
    """The loaded kernel library, built from ``csrc/`` on first use."""
    global _lib
    if _lib is None:
        target = build_dir() / f"libsdt_kernels_{source_hash()}.so"
        if not target.exists():
            _compile(target)
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _PROTOTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.sdt_error_string.argtypes = (ctypes.c_int,)
        lib.sdt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(name, *args):
    """Call the C entry point ``name``; raise if the launch failed."""
    err = getattr(library(), name)(*args)
    if err != 0:
        msg = library().sdt_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")


def stream_of(tensor):
    return torch.cuda.current_stream(tensor.device).cuda_stream


def type_codes(data, index):
    """(dtype code, index code) of the C interface; raises for types the
    kernels do not take."""
    if data.dtype not in DTYPE_CODES:
        raise TypeError(f"kernels take float32/float64/complex64/"
                        f"complex128 values, not {data.dtype}")
    return DTYPE_CODES[data.dtype], index_code(index)


def index_code(index):
    """The index code of the C interface; raises for other types."""
    if index.dtype not in ITYPE_CODES:
        raise TypeError(f"kernels take int32/int64 indices, not "
                        f"{index.dtype}")
    return ITYPE_CODES[index.dtype]


def scalar_parts(x):
    """(re, im) doubles of a Python or numpy scalar (None -> (1, 0))."""
    if x is None:
        return 1.0, 0.0
    z = complex(x)
    return z.real, z.imag
