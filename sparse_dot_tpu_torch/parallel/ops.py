"""Mesh-sharded sparse ops on torch.distributed.

Port of ``sparse_dot_tpu/parallel/ops.py``.  Where the JAX package runs a
``shard_map`` body per device over padded COO, each rank here computes its
part on the port's kernels and the parts meet in a collective
(``parallel/comm.py``):

* row partition (``shard_csr_rows``): a rank's row block @ replicated b
  on K2 (K3 for a vector), the blocks all-gathered (``sharded_spmm``,
  ``sharded_spmv``); the same block over a window of x made of its own
  segment and its ±halo neighbours' (``sharded_spmv_halo``, K3); its
  block's AᵀA on K6, summed over the ranks (``sharded_gram``); CG and
  Jacobi-scaled CGLS with K3 matvecs (``sharded_cg``, ``sharded_cgls``);
* contraction partition (``shard_csr_cols``): a column block @ its block
  of b on K2, summed over the ranks (``sharded_spmm_2d``);
* the ring (``shard_csr_grid`` with a b or ``shard_csr_krows`` B sharded
  along k): at step t a rank multiplies its column block (s + t) mod S by
  the shard of b or B it holds while that shard travels one hop on
  (``sharded_spmm_ring`` on K2, ``sharded_spgemm`` on K6 for a dense value
  panel and a dense pattern panel, compacted to CSR on the device).

A ``ShardedCSR`` holds this rank's shard as CSR containers
(``formats.CSR``) on the rank's device, so the kernels' row plans, the
transposed layout and the sorted rows are built once and cached.  Row
blocks are padded to ``m_local = ceil(m / S)`` rows and column blocks to
``k_local = ceil(k / S)`` columns, so gathers and rotations are uniform;
the entries are padded only where a rotation needs equal shapes (B's
shards in ``sharded_spgemm``).  Complex values are stored natively (the
JAX package's planar channels are a TPU layout).  Each op keeps the JAX
package's memory bounds: per rank |A| / S plus the replicated b, or
|b| / S on the ring; ``sharded_spgemm`` keeps its dense m_local x n
panels.

Ops return full arrays as the JAX package does: torch tensors on the
rank's device (``multihost.gather_to_host`` gives numpy), numpy for
``sharded_spmv_halo``, ``sharded_cg`` and ``sharded_cgls``, and a scipy
CSR for ``sharded_spgemm``.
"""

import numpy as np
import scipy.sparse as _sps
import torch
import torch.distributed as dist

from .. import formats
from ..ops import csr, spgemm
from ..solvers.iterative import _cg_loop
from ..solvers.qr import _cgls_loop, _col_sumsq, _jacobi_colscale
from . import comm

LAYOUTS = ("rows", "cols", "grid", "krows")


def _ceil_div(a, b):
    return -(-a // b)


class ShardedCSR:
    """This rank's shard of a partitioned sparse matrix, with the global
    metadata.

    ``layout`` names the partition: "rows" (``shard_csr_rows``: row block
    ``index`` of ``m_local`` rows, global column ids), "krows" (the same
    form for a B sharded along the contraction axis, ``shard_csr_krows``),
    "cols" (``shard_csr_cols``: column block ``index`` of ``k_local``
    columns, all m rows, ``m_local = m``) or "grid" (``shard_csr_grid``:
    row block ``index`` cut into S column blocks of ``k_local`` columns,
    block-local column ids).  ``blocks`` holds the ``formats.CSR``
    containers on the rank's device: one, or S for "grid".  ``mesh`` and
    ``axis`` let ``dot_product`` and ``sparse_qr_solve`` route the
    operand."""

    ndim = 2

    def __init__(self, layout, blocks, shape, m_local, n_shards, index,
                 mesh=None, axis="rows", k_local=None):
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}; got "
                             f"{layout!r}")
        self.layout = layout
        self.blocks = tuple(blocks)
        self.shape = tuple(int(s) for s in shape)
        self.m_local = int(m_local)
        self.n_shards = int(n_shards)
        self.index = int(index)
        self.mesh = mesh
        self.axis = axis
        self.k_local = None if k_local is None else int(k_local)
        self._cache = {}

    @property
    def dtype(self):
        """numpy dtype of the values."""
        return self.blocks[0].dtype

    def __repr__(self):
        return (f"<ShardedCSR {self.layout} shape={self.shape} shard "
                f"{self.index}/{self.n_shards} dtype={self.dtype}>")


def _check_mesh_axis(mesh, axis, n_shards):
    """The sharded kernels map exactly one shard per device on the named
    mesh axis: a size mismatch is an error, not a wrong answer."""
    if mesh is None:
        return
    sizes = dict(zip(mesh.mesh_dim_names or (), mesh.mesh.shape))
    size = sizes.get(axis)
    if size is None:
        raise ValueError(
            f"mesh has no axis named {axis!r} (axes: {mesh.mesh_dim_names})"
        )
    if int(size) != int(n_shards):
        raise ValueError(
            f"n_shards={n_shards} must equal the mesh {axis!r} axis "
            f"size ({size}): the sharded kernels map one shard per "
            "device"
        )


def _check_contraction(A, b_rows, what="b"):
    if int(b_rows) != int(A.shape[1]):
        raise ValueError(
            f"Bad shapes for sharded multiply: A is {A.shape} but "
            f"{what} has {int(b_rows)} rows (need {A.shape[1]})"
        )


def _shard_index(mesh, axis):
    """This rank's position on the mesh axis (with no mesh: its rank in
    the group, its position on ``make_mesh()``'s first axis)."""
    if mesh is None:
        return dist.get_rank() if dist.is_initialized() else 0
    at = mesh.get_coordinate()
    if at is None:
        raise ValueError("this process is not in the mesh")
    return at[mesh.mesh_dim_names.index(axis)]


def _group(mesh, axis, A):
    """(process group of ``axis``, position) after the checks every op
    makes: the mesh's axis has A's shard count, and this rank holds the
    shard of its position."""
    _check_mesh_axis(mesh, axis, A.n_shards)
    at = _shard_index(mesh, axis)
    if at != A.index:
        raise ValueError(
            f"this process is at {at} on the mesh {axis!r} axis but holds "
            f"shard {A.index}")
    return mesh.get_group(axis), at


def _scipy_csr(matrix, fmt="csr"):
    if formats.is_device_sparse(matrix):
        return matrix.to_scipy().asformat(fmt)
    if _sps.issparse(matrix):
        return matrix.asformat(fmt)
    raise ValueError(f"Expected a sparse matrix, got {type(matrix)}")


def _row_block(mat, lo, hi, nrows):
    """Rows [lo, hi) of scipy CSR ``mat`` as a CSR of ``nrows`` rows (the
    rows past the matrix empty): the numpy port of
    ``native.csr_shard_rows`` for one shard."""
    m = mat.shape[0]
    lo, hi = min(lo, m), min(hi, m)
    ip = mat.indptr[lo:hi + 1].astype(np.int64)
    indptr = np.full(nrows + 1, ip[-1] - ip[0], np.int64)
    indptr[: hi - lo + 1] = ip - ip[0]
    return _sps.csr_matrix(
        (mat.data[ip[0]:ip[-1]], mat.indices[ip[0]:ip[-1]], indptr),
        shape=(nrows, mat.shape[1]))


def _col_block(mat, c, k_local):
    """Columns [c k_local, (c + 1) k_local) of scipy ``mat`` as a CSR of
    ``k_local`` columns (block-local ids; the columns past the matrix
    empty)."""
    k = mat.shape[1]
    blk = mat[:, min(c * k_local, k):min((c + 1) * k_local, k)].tocsr()
    return _sps.csr_matrix((blk.data, blk.indices, blk.indptr),
                           shape=(mat.shape[0], k_local))


def _device_blocks(blocks):
    return [formats.CSR.from_scipy(b) for b in blocks]


def _row_sharded(layout, matrix, n_shards, mesh, axis):
    """This rank's block of ``ceil(m / n_shards)`` contiguous rows (the
    last blocks padded with empty rows)."""
    _check_mesh_axis(mesh, axis, n_shards)
    matrix = _scipy_csr(matrix)
    m, k = matrix.shape
    m_local = _ceil_div(m, n_shards)
    s = _shard_index(mesh, axis)
    block = _row_block(matrix, s * m_local, (s + 1) * m_local, m_local)
    return ShardedCSR(layout, _device_blocks([block]), (m, k), m_local,
                      n_shards, s, mesh=mesh, axis=axis)


def shard_csr_rows(matrix, n_shards, mesh=None, axis="rows"):
    """scipy CSR (or convertible, or a container) -> this rank's
    ShardedCSR: rows split into ``n_shards`` contiguous blocks of
    ``m_local = ceil(m / n_shards)`` rows; every rank passes the same
    global matrix."""
    return _row_sharded("rows", matrix, n_shards, mesh, axis)


def shard_csr_cols(matrix, n_shards, mesh=None, axis="cols"):
    """Column-partition A along the contraction axis: shard s owns
    columns [s*k_local, (s+1)*k_local) with LOCAL column ids."""
    _check_mesh_axis(mesh, axis, n_shards)
    matrix = _scipy_csr(matrix, "csc")
    if np.iscomplexobj(matrix.data):
        raise NotImplementedError(
            "shard_csr_cols does not implement the planar-complex "
            "strategy; use shard_csr_rows / shard_csr_grid for "
            "complex operands"
        )
    m, k = matrix.shape
    k_local = _ceil_div(k, n_shards)
    s = _shard_index(mesh, axis)
    block = _col_block(matrix, s, k_local)
    return ShardedCSR("cols", _device_blocks([block]), (m, k), m, n_shards,
                      s, mesh=mesh, axis=axis, k_local=k_local)


def shard_csr_grid(matrix, n_shards, mesh=None, axis="rows"):
    """Partition A for the ring algorithm: rows into S contiguous blocks,
    and each row block's columns into S blocks aligned with b's row
    shards (block-LOCAL column ids)."""
    _check_mesh_axis(mesh, axis, n_shards)
    matrix = _scipy_csr(matrix)
    m, k = matrix.shape
    m_local = _ceil_div(m, n_shards)
    k_local = _ceil_div(k, n_shards)
    s = _shard_index(mesh, axis)
    rows = _row_block(matrix, s * m_local, (s + 1) * m_local, m_local)
    return ShardedCSR("grid",
                      _device_blocks([_col_block(rows, c, k_local)
                                      for c in range(n_shards)]),
                      (m, k), m_local, n_shards, s, mesh=mesh, axis=axis,
                      k_local=k_local)


def shard_csr_krows(matrix, n_shards, mesh=None, axis="rows"):
    """Shard a sparse B along its ROW (contraction) axis for the ring
    SpGEMM: row block s of ``k_local = ceil(k / S)`` rows (the form of
    ``shard_csr_rows``)."""
    return _row_sharded("krows", matrix, n_shards, mesh, axis)


def from_padded_coo(rows, cols, vals, shape, m_local, n_shards,
                    k_local=None, layout="rows", mesh=None, axis="rows"):
    """This rank's ShardedCSR from a JAX ``ShardedCSR``'s arrays as numpy:
    padded COO with a leading shard axis, (S, nnz_pad) or (S, S, nnz_pad)
    for "grid", local row ids with pads at ids >= ``m_local`` (dropped);
    ``vals`` with a channel axis before the entries, (..., 2, nnz_pad), is
    planar complex (real and imaginary parts).  ``layout`` names the JAX
    constructor that built the arrays ("rows", "cols", "grid", "krows");
    ``m_local`` and ``k_local`` are the JAX object's.  Repeated entries are
    summed, as the JAX package's scatters sum them."""
    _check_mesh_axis(mesh, axis, n_shards)
    rows, cols, vals = (np.asarray(a) for a in (rows, cols, vals))
    if vals.ndim == rows.ndim + 1:
        cdt = np.complex64 if vals.dtype == np.float32 else np.complex128
        vals = (vals[..., 0, :] + 1j * vals[..., 1, :]).astype(cdt)
    s = _shard_index(mesh, axis)
    ncols = shape[1] if layout in ("rows", "krows") else k_local
    per_block = (zip(rows[s], cols[s], vals[s]) if layout == "grid"
                 else [(rows[s], cols[s], vals[s])])
    blocks = []
    for r, c, v in per_block:
        keep = r < m_local
        blocks.append(_sps.csr_matrix((v[keep], (r[keep], c[keep])),
                                      shape=(m_local, ncols)))
    return ShardedCSR(layout, _device_blocks(blocks), shape, m_local,
                      n_shards, s, mesh=mesh, axis=axis, k_local=k_local)


# ---------------------------------------------------------------------------
# Dense operands and result types
# ---------------------------------------------------------------------------


def _dense(b, device):
    """numpy (or torch) array -> tensor on ``device``."""
    if isinstance(b, torch.Tensor):
        return b.to(device)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(b))).to(device)


def _typed(t, dtype):
    return t.to(formats.torch_dtype(dtype))


def _operand(A, b):
    """(b on the rank's device in the work dtype, work dtype, result
    dtype) of A @ b as the JAX package types it: the promoted type; a
    complex result takes A's complex type, or b's when only b is
    complex."""
    b = _dense(b, A.blocks[0].device)
    b_dtype = torch.empty((), dtype=b.dtype).numpy().dtype
    work = np.result_type(A.dtype, b_dtype)
    formats._validate_dtype(work)
    out = (A.dtype if A.dtype.kind == "c"
           else b_dtype if b_dtype.kind == "c" else work)
    return _typed(b, work), work, out


def _arrays(block, dtype, transpose=False):
    """(indptr, indices, data) of a block (its transpose), values in
    ``dtype``."""
    indptr, indices, data = block.csr_arrays(transpose)
    return indptr, indices, _typed(data, dtype)


# ---------------------------------------------------------------------------
# Row-sharded SpMM / SpMV
# ---------------------------------------------------------------------------


def _row_layout(A, name):
    if A.layout not in ("rows", "krows"):
        raise ValueError(f"{name} requires A partitioned with "
                         f"shard_csr_rows; got a {A.layout!r} ShardedCSR")


def sharded_spmm(mesh, A, b, axis="rows"):
    """C = A @ b with row-sharded A and replicated b: each rank's row
    block on K2, the blocks all-gathered.  Returns the full (m, n) tensor
    on the rank's device."""
    group, _ = _group(mesh, axis, A)
    _check_contraction(A, np.shape(b)[0])
    _row_layout(A, "sharded_spmm")
    b, work, out = _operand(A, b)
    block = A.blocks[0]
    c = csr.csr_spmm(*_arrays(block, work), b, plan=block.csr_plan())
    c = comm.all_gather(c, group)[: A.shape[0]]
    return _typed(c, out)


def sharded_spmv(mesh, A, x, axis="rows"):
    """y = A @ x with row-sharded A and replicated x: K3 on each rank's
    row block (complex operands through ``sharded_spmm``)."""
    group, _ = _group(mesh, axis, A)
    _check_contraction(A, np.shape(x)[0], what="x")
    _row_layout(A, "sharded_spmv")
    x = _dense(x, A.blocks[0].device)
    if A.dtype.kind == "c" or x.is_complex():
        return sharded_spmm(mesh, A, x.reshape(-1, 1), axis=axis).reshape(-1)
    x, work, out = _operand(A, x)
    block = A.blocks[0]
    y = csr.csr_spmv(*_arrays(block, work), x,
                     plan=block.csr_plan(spmv=True))
    return _typed(comm.all_gather(y, group)[: A.shape[0]], out)


def _halo_block(A, s, halo, k_local):
    """(indptr, indices, data, plan, dropped) of this rank's row block
    with its columns rebased into the window [(s - halo) k_local, (s +
    halo + 1) k_local): the entries outside it are left out, and
    ``dropped`` counts those whose value is nonzero.  Cached per halo."""
    key = ("halo", halo)
    if key not in A._cache:
        block = A.blocks[0]
        indptr, indices, data = block.csr_arrays()
        rows = formats.expand_indptr(indptr, indices.numel()).long()
        lc = indices.long() - (s - halo) * k_local
        keep = (lc >= 0) & (lc < (2 * halo + 1) * k_local)
        dropped = (~keep & (data != 0)).sum()
        counts = torch.bincount(rows[keep], minlength=A.m_local)
        new_ip = torch.zeros(A.m_local + 1, dtype=indptr.dtype,
                             device=indptr.device)
        new_ip[1:] = torch.cumsum(counts, 0)
        new_ix = lc[keep].to(indices.dtype)
        A._cache[key] = (new_ip, new_ix, data[keep],
                         formats.csr_plan(new_ip, new_ix.numel(), True),
                         dropped)
    return A._cache[key]


def sharded_spmv_halo(mesh, A, x, halo=1, axis="rows"):
    """Nearest-neighbor (halo-exchange) SpMV for BANDED row-sharded A:
    y = A @ x with x split like A's columns (segments of ``k_local =
    ceil(k / S)``), each rank receiving only its ±``halo`` ring
    neighbours' segments (2·halo rotations) and running K3 on its row
    block with the columns rebased into that window.

    Every nonzero's column must lie inside its row block's window
    ``[(s-halo)·k_local, (s+halo+1)·k_local)``; the ends of the ring do
    not wrap (rank 0's left halo and rank S-1's right one hold no valid
    column), so a wrap-around band raises too.  Violations are counted
    (summed over the ranks) and raise ``ValueError``; use
    :func:`sharded_spmv` for general matrices.  Returns numpy."""
    group, s = _group(mesh, axis, A)
    x = _dense(x, A.blocks[0].device)
    if A.dtype.kind == "c" or x.is_complex():
        raise NotImplementedError(
            "sharded_spmv_halo supports real dtypes; use sharded_spmv"
        )
    _row_layout(A, "sharded_spmv_halo")
    S, k = A.n_shards, A.shape[1]
    k_local = _ceil_div(k, S)
    x = _typed(x, A.dtype).reshape(-1)
    if x.shape[0] != k:
        raise ValueError(f"x must have length {k}; got {x.shape[0]}")
    x_pad = torch.zeros(S * k_local, dtype=x.dtype, device=x.device)
    x_pad[:k] = x
    xb = x_pad[s * k_local:(s + 1) * k_local]
    # x_{s+h} arrives from the rank h to the right, x_{s-h} from the rank
    # h to the left; all 2·halo transfers are in flight together.
    right = [comm.start_rotate([xb], group, h, tag=2 * h)
             for h in range(1, halo + 1)]
    left = [comm.start_rotate([xb], group, -h, tag=2 * h + 1)
            for h in range(1, halo + 1)]
    window = torch.cat([r.wait()[0] for r in reversed(left)] + [xb]
                       + [r.wait()[0] for r in right])
    indptr, indices, data, plan, dropped = _halo_block(A, s, halo, k_local)
    dropped = int(comm.all_reduce(dropped.clone(), group))
    if dropped != 0:
        raise ValueError(
            f"sharded_spmv_halo: {dropped} nonzeros fall outside "
            f"the halo={halo} window (bandwidth exceeds "
            f"halo * ceil(k / n_shards) = {halo * k_local}); widen "
            "halo or use sharded_spmv"
        )
    y = csr.csr_spmv(indptr, indices, data, window, plan=plan)
    return comm.all_gather(y, group)[: A.shape[0]].cpu().numpy()


# ---------------------------------------------------------------------------
# k-sharded SpMM, summed over the ranks
# ---------------------------------------------------------------------------


def sharded_spmm_2d(mesh, A_colsharded, b, axis="cols"):
    """C = A @ b with the contraction axis sharded: rank s computes
    A[:, s-block] @ b[s-block, :] on K2 and the partials are summed
    (``all_reduce``).  Returns the full (m, n) tensor."""
    A = A_colsharded
    group, s = _group(mesh, axis, A)
    _check_contraction(A, np.shape(b)[0])
    if A.layout != "cols":
        raise ValueError("sharded_spmm_2d requires A partitioned with "
                         f"shard_csr_cols; got a {A.layout!r} ShardedCSR")
    b, work, out = _operand(A, b)
    k_local = A.k_local
    b_block = _padded_rows(b, A.n_shards * k_local)[
        s * k_local:(s + 1) * k_local]
    block = A.blocks[0]
    c = csr.csr_spmm(*_arrays(block, work), b_block, plan=block.csr_plan())
    return _typed(comm.all_reduce(c, group), out)


def _padded_rows(b, rows):
    """b with zero rows appended up to ``rows``."""
    if b.shape[0] >= rows:
        return b
    pad = torch.zeros((rows - b.shape[0], *b.shape[1:]), dtype=b.dtype,
                      device=b.device)
    return torch.cat([b, pad])


# ---------------------------------------------------------------------------
# Ring SpMM: b sharded along k, its shards rotating
# ---------------------------------------------------------------------------


def _grid_layout(A, name):
    if A.layout != "grid":
        raise ValueError(f"{name} requires A partitioned with "
                         f"shard_csr_grid; got a {A.layout!r} ShardedCSR")


def sharded_spmm_ring(mesh, A_grid, b, axis="rows"):
    """C = A @ b with BOTH operands sharded: A row+column blocked
    (:func:`shard_csr_grid`), b row-sharded along k.  At step t rank s
    multiplies its column block (s + t) mod S by the b shard it holds,
    accumulating through K2's ``c0``; the shard's rotation to the next
    rank is issued before that K2 and received into a second buffer, and
    the last step rotates nothing: S - 1 rotations for S steps.  Per rank
    |A| / S + |b| / S; no operand is replicated.  Returns the full (m, n)
    tensor (row blocks all-gathered)."""
    group, s = _group(mesh, axis, A_grid)
    _check_contraction(A_grid, np.shape(b)[0])
    _grid_layout(A_grid, "sharded_spmm_ring")
    S, k_local = A_grid.n_shards, A_grid.k_local
    b, work, out = _operand(A_grid, b)
    b_cur = _padded_rows(b, S * k_local)[s * k_local:(s + 1) * k_local]
    c = None
    for t in range(S):
        rotation = (comm.start_rotate([b_cur], group) if t < S - 1
                    else None)
        block = A_grid.blocks[(s + t) % S]
        c = csr.csr_spmm(*_arrays(block, work), b_cur, c0=c,
                         plan=block.csr_plan())
        if rotation is not None:
            (b_cur,) = rotation.wait()
    c = comm.all_gather(c, group)[: A_grid.shape[0]]
    return _typed(c, out)


# ---------------------------------------------------------------------------
# Sharded SpGEMM: row-sharded A x k-sharded sparse B over the same ring
# ---------------------------------------------------------------------------


def _ring_shard(B, dtype, group):
    """B's shard as the rotating buffers (indptr, indices padded to the
    largest shard's nnz, values padded likewise, in ``dtype``), columns
    sorted in each row, with every shard's nnz (host ints, by shard)."""
    indptr, indices, data = B.blocks[0].sorted_csr_arrays()
    nnz = torch.tensor([indices.numel()], dtype=torch.int64,
                       device=indices.device)
    counts = comm.all_gather(nnz, group).tolist()
    pad = max(counts) - indices.numel()
    data = _typed(data, dtype)
    return ([indptr, torch.cat([indices, indices.new_zeros(pad)]),
             torch.cat([data, data.new_zeros(pad)])], counts)


def sharded_spgemm(mesh, A_grid, B_krows, axis="rows"):
    """C = A @ B with sparse A row+column blocked (:func:`shard_csr_grid`)
    and sparse B sharded along the contraction axis
    (:func:`shard_csr_krows`).  B's CSR shards rotate around the ring
    (S - 1 rotations, each issued before the step's kernels) while each
    rank accumulates its dense m_local x n value panel (K6) and its
    structural pattern panel (K6 in float32 on all-ones values: a count
    above 0 marks a stored product, so exactly cancelled entries stay as
    explicit zeros, as MKL and scipy keep them).  The panels compact to
    CSR on the device; the ranks all-gather their counts and the compacted
    buffers, and every rank assembles the scipy CSR of the full product."""
    group, s = _group(mesh, axis, A_grid)
    _check_contraction(A_grid, B_krows.shape[0], what="B")
    _grid_layout(A_grid, "sharded_spgemm")
    _check_mesh_axis(mesh, axis, B_krows.n_shards)
    if B_krows.layout not in ("rows", "krows") or B_krows.index != s:
        raise ValueError("sharded_spgemm requires B partitioned with "
                         "shard_csr_krows on the same mesh axis")
    S, m = A_grid.n_shards, A_grid.shape[0]
    n = B_krows.shape[1]
    work = np.result_type(A_grid.dtype, B_krows.dtype)
    held, counts = _ring_shard(B_krows, work, group)
    ones_b = torch.ones(held[1].numel(), dtype=torch.float32,
                        device=held[1].device)
    panel = pattern = None
    for t in range(S):
        rotation = comm.start_rotate(held, group) if t < S - 1 else None
        c = (s + t) % S
        a_ip, a_ix, a_dv = _arrays(A_grid.blocks[c], work)
        b_ip, b_ix, b_dv = held[0], held[1][: counts[c]], held[2][: counts[c]]
        panel = spgemm.csr_spgemm_dense(a_ip, a_ix, a_dv, b_ip, b_ix, b_dv,
                                        n, c0=panel, b_sorted=True)
        pattern = spgemm.csr_spgemm_dense(
            a_ip, a_ix, torch.ones_like(a_dv, dtype=torch.float32), b_ip,
            b_ix, ones_b[: counts[c]], n, c0=pattern, b_sorted=True)
        if rotation is not None:
            held = rotation.wait()
    return _gather_csr(panel, pattern, m, n, A_grid.dtype, group)


def _gather_csr(panel, pattern, m, n, dtype, group):
    """The product's CSR from each rank's panels: the entries where the
    pattern count is above 0, compacted on the device in row-major order,
    all-gathered with their counts and assembled on the host."""
    mask = pattern > 0
    row_counts = mask.sum(1)
    flat = mask.reshape(-1).nonzero().reshape(-1)
    cols = (flat % n).to(torch.int32)
    vals = panel.reshape(-1)[flat]
    nnz = torch.tensor([flat.numel()], dtype=torch.int64, device=flat.device)
    counts = comm.all_gather(nnz, group).tolist()
    cap = max(counts)
    cols = torch.cat([cols, cols.new_zeros(cap - cols.numel())])
    vals = torch.cat([vals, vals.new_zeros(cap - vals.numel())])
    cols = comm.all_gather(cols, group).cpu().numpy().reshape(-1, cap)
    vals = comm.all_gather(vals, group).cpu().numpy().reshape(-1, cap)
    row_counts = comm.all_gather(row_counts, group).cpu().numpy()[:m]
    data = np.concatenate([v[:c] for v, c in zip(vals, counts)])
    indices = np.concatenate([i[:c] for i, c in zip(cols, counts)])
    indptr = np.concatenate([[0], np.cumsum(row_counts)])
    return _sps.csr_matrix((data.astype(dtype, copy=False), indices, indptr),
                           shape=(m, n))


# ---------------------------------------------------------------------------
# Sharded gram, CG and CGLS
# ---------------------------------------------------------------------------


def _real_only(A, name):
    if A.dtype.kind == "c":
        raise NotImplementedError(f"{name} supports real dtypes only")


def sharded_gram(mesh, A, axis="rows"):
    """AᵀA via row-sharded A: each rank computes its block's full k x k
    A_sᵀ A_s on K6 (the block's transposed CSR times the block) and the
    results are summed over the ranks.  Returns the (k, k) tensor."""
    group, _ = _group(mesh, axis, A)
    _real_only(A, "sharded_gram")
    _row_layout(A, "sharded_gram")
    block = A.blocks[0]
    b_ip, b_ix, b_dv = block.sorted_csr_arrays()
    g = spgemm.csr_spgemm_dense(*block.csr_arrays(transpose=True), b_ip,
                                b_ix, b_dv, A.shape[1], b_sorted=True)
    return comm.all_reduce(g, group)


class _RowShardedOperator:
    """A row-sharded A as an operator: K3 on the rank's row block over the
    first k entries of x, re-replicated by ``all_gather`` into the padded
    rows (the interface of ``solvers.iterative.CsrOperator`` that the
    single-device loops call)."""

    def __init__(self, A, block, work, group):
        self.arrays = _arrays(block, work)
        self.plan = block.csr_plan(spmv=True)
        self.k, self.group = A.shape[1], group

    def __call__(self, x):
        y = csr.csr_spmv(*self.arrays, x[:self.k], plan=self.plan)
        return comm.all_gather(y, self.group)

    def residual(self, b, x):
        return b - self(x)


def sharded_cg(mesh, A, b, tol=1e-10, maxiter=1000, axis="rows"):
    """Distributed CG on a row-sharded SPD matrix: each matvec is K3 on
    the rank's row block, re-replicated by ``all_gather``; the reductions
    are computed on every rank on the replicated vectors, by the
    single-device CG loop (``solvers.iterative._cg_loop``).  Stops when
    sqrt(r·r) <= ``tol`` (absolute) or after ``maxiter`` steps; a start
    that already meets ``tol`` takes no step, as the JAX package's
    ``while_loop``.  Returns (x, residual norm, iterations) as numpy,
    float and int."""
    group, _ = _group(mesh, axis, A)
    _real_only(A, "sharded_cg")
    _row_layout(A, "sharded_cg")
    m = A.shape[0]
    b, work, _ = _operand(A, b)
    op = _RowShardedOperator(A, A.blocks[0], work, group)
    b = _padded_rows(b.reshape(-1), A.n_shards * A.m_local)
    x, rs, it = _cg_loop(op, b, torch.zeros_like(b), tol, maxiter,
                         at_least_one=False)
    return x[:m].cpu().numpy(), float(torch.sqrt(rs)), int(it)


def _jacobi_scale(A, block, dtype, group):
    """d_j = 1 / ||a_j|| (1 for an empty column) from the column sums of
    squares of every rank's block, summed over the ranks, in float64;
    cached on A."""
    if "jacobi" not in A._cache:
        _, indices, data = block.csr_arrays()
        sq = comm.all_reduce(_col_sumsq(indices, data, A.shape[1]), group)
        A._cache["jacobi"] = _jacobi_colscale(sq)
    return _typed(A._cache["jacobi"], dtype)


def sharded_cgls(mesh, A, b, tol=1e-12, maxiter=500, axis="rows"):
    """Distributed least squares min ||Ax - b|| via Jacobi-scaled CGLS on a
    row-sharded A, by the single-device CGLS loop (``solvers.qr.
    _cgls_loop``): the forward matvec is K3 on the rank's row block,
    re-replicated with ``all_gather``; the adjoint is K3 on the block's
    transposed CSR, summed over the ranks (``all_reduce``).  The column
    scaling d (1 / column norm) solves min ||(A diag(d)) y - b|| and
    returns x = d y.  Stops when sqrt(||s||²) <= ``tol`` (absolute, s the
    scaled normal-equations residual) or after ``maxiter`` steps.  Returns
    (x, ||b - A x||, iterations) as numpy, float and int."""
    group, s = _group(mesh, axis, A)
    _real_only(A, "sharded_cgls")
    _row_layout(A, "sharded_cgls")
    k, m_local = A.shape[1], A.m_local
    b, work, _ = _operand(A, b)
    block = A.blocks[0]
    fwd = _RowShardedOperator(A, block, work, group)
    adj_arrays = _arrays(block, work, transpose=True)
    adj_plan = block.csr_plan(transpose=True, spmv=True)

    def adj(y):
        part = csr.csr_spmv(*adj_arrays, y[s * m_local:(s + 1) * m_local],
                            plan=adj_plan)
        return comm.all_reduce(part, group)

    b = _padded_rows(b.reshape(-1), A.n_shards * m_local)
    x, r, it = _cgls_loop(
        lambda v: fwd(v.reshape(-1)).unsqueeze(1),
        lambda v: adj(v.reshape(-1)).unsqueeze(1), b.unsqueeze(1), k,
        maxiter, _jacobi_scale(A, block, work, group), atol=tol)
    return (x.reshape(-1).cpu().numpy(), float(torch.linalg.vector_norm(r)),
            int(it))
