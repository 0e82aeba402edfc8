"""Sampled sparse-row product (kernel K9): the value gradients of a sparse
x sparse product with dense output.

``csr_spgemm_sddmm(indptr, indices, d, y_indptr, y_indices, y_data,
alpha, transposed)`` gives, for each stored entry p of a CSR P read as
(r_p, q_p) (its row and column; with ``transposed``, its column and row),

    out[p] = alpha * sum over (s, v) in row q_p of Y of d[r_p, s] * conj(v)

(conj only for complex values), with ``d`` dense and row-major and Y a
CSR: K7's gather with a sparse row of Y in place of a dense row of B.  For
C = alpha * op(A) @ op(B) + beta * c0 and G = dL/dC it is both value
gradients, as PyTorch's convention for complex gradients has them:

- dL/d(op(A)'s values) at A's pattern, with d = G and Y = op(B), alpha
  conjugated;
- dL/d(op(B)'s values) at B's pattern read as (column, row) pairs, with
  d = G^T (contiguous) and Y = op(A)^T (``CsrPattern.transpose``'s
  structure, op(A)'s values gathered through its permutation).

On a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/csr_spgemm_sddmm.cu``) or raises; on a CPU tensor it runs the
plain version beside it, which is also what the kernel is checked against
on the card.  ``csr_spgemm_sddmm.launches`` counts calls that launched the
kernel.

K9 replaces XLA's transpose of ``_xla.spgemm_numeric_sorted``
(``sparse_dot_tpu/ops/_xla.py``, through ``densify_sorted``), which
``jax.grad`` runs as a dense G @ op(B)^H (op(A)^H @ G) gathered at the
operand's scatter positions.  Its work is one multiply-add per entry of
P and entry of Y's row q_p; a group of ``sampled_lanes`` lanes walks a
row of Y, so a row's products take one pass of the group.
"""

import torch

from ..config import config
from ..formats import expand_indptr
from . import _build
from .csr import _add_rows, _check, refuse_tracked, refuse_views

# Groups of lanes a group may take: 1 to 32, a power of two.
_MAX_LANES = 32


def sampled_lanes(mean_row):
    """K9's lanes per entry for rows of Y with ``mean_row`` entries on
    average: the power of two at or above half of it, 1 to 32, so a lane
    takes about two entries of a row of mean length (``csrc/
    csr_spgemm_sddmm.cu`` instantiates each)."""
    lanes = 1
    while lanes < min(mean_row / 2, _MAX_LANES):
        lanes *= 2
    return lanes


def entry_ids(indptr, indices, transposed):
    """(r, q) of every stored entry of the CSR P: (row, column), or
    (column, row) with ``transposed``."""
    rows = expand_indptr(indptr, indices.numel())
    return (indices, rows) if transposed else (rows, indices)


def csr_spgemm_sddmm_plain(indptr, indices, d, y_indptr, y_indices, y_data,
                           alpha=None, transposed=False):
    """``out[p] = alpha * sum_{(s, v) in row q_p of Y} d[r_p, s] conj(v)``
    in plain PyTorch: every product of entry p and an entry of Y's row q_p
    expanded and gathered, summed by ``index_add_`` into out, chunked so
    that at most ``config.spmm_chunk_elements`` products are held."""
    nnz = indices.numel()
    out = torch.zeros(nnz, dtype=d.dtype, device=d.device)
    if nnz == 0:
        return out
    r, q = (ids.long() for ids in entry_ids(indptr, indices, transposed))
    y_start = y_indptr[:-1].long()[q]
    y_len = y_indptr[1:].long()[q] - y_start
    ends = torch.cumsum(y_len, 0)
    total = int(ends[-1])
    budget = config.spmm_chunk_elements
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
            torch.arange(p0, p1, device=d.device), count, output_size=n_prod)
        first = torch.cumsum(count, 0) - count
        t = (y_start[entry] + torch.arange(n_prod, device=d.device)
             - first[entry - p0])
        prods = d[r[entry], y_indices[t].long()] * y_data[t].conj()
        _add_rows(out, entry, prods)
        p0 = p1
    if alpha is not None and complex(alpha) != 1:
        out = out * alpha
    return out


def csr_spgemm_sddmm(indptr, indices, d, y_indptr, y_indices, y_data,
                     alpha=None, transposed=False):
    """``alpha * sum_{(s, v) in row q_p of Y} d[r_p, s] conj(v)`` for each
    entry p = (r_p, q_p) of the CSR (``indptr``, ``indices``) in its
    stored order (with ``transposed`` an entry at row i, column j is read
    as (j, i)), for row-major ``d`` whose columns Y's column ids index and
    the CSR Y (``y_indptr``, ``y_indices``, ``y_data``), whose rows the
    q_p name.  Returns a new (nnz,) tensor.  Not differentiable itself
    (``ops.autograd.CsrSpgemmSddmm`` is): it raises on a tracked ``d`` or
    ``y_data`` (``csr.refuse_tracked``), on both devices."""
    refuse_tracked("csr_spgemm_sddmm", d, y_data)
    return sampled(indptr, indices, d, y_indptr, y_indices, y_data, alpha,
                   transposed)


def sampled(indptr, indices, d, y_indptr, y_indices, y_data, alpha=None,
            transposed=False):
    """``csr_spgemm_sddmm`` without the tracked check, for the Function's
    forward: K9 on the card, the plain version on the CPU; counted in
    ``csr_spgemm_sddmm.launches``."""
    refuse_views("csr_spgemm_sddmm", indptr, indices, d, y_indptr,
                 y_indices, y_data)
    if d.device.type == "cpu":
        return csr_spgemm_sddmm_plain(indptr, indices, d, y_indptr,
                                      y_indices, y_data, alpha, transposed)
    if not d.is_cuda:
        raise ValueError(f"csr_spgemm_sddmm: no kernel for device "
                         f"{d.device}")
    _check("csr_spgemm_sddmm", (indptr, indices, y_indptr, y_indices),
           (d, y_data))
    if d.dim() != 2:
        raise ValueError(f"csr_spgemm_sddmm: d is {tuple(d.shape)}, "
                         "need 2-d")
    nnz = indices.numel()
    out = torch.empty(nnz, dtype=d.dtype, device=d.device)
    if nnz == 0:
        return out
    r, q = entry_ids(indptr, indices, transposed)
    y_rows = y_indptr.numel() - 1
    lanes = sampled_lanes(y_indices.numel() / max(y_rows, 1))
    dt, it = _build.type_codes(d, indptr)
    _build.launch(
        "sdt_csr_spgemm_sddmm", dt, it, r.data_ptr(), q.data_ptr(), nnz,
        d.data_ptr(), d.shape[1], y_indptr.data_ptr(), y_indices.data_ptr(),
        y_data.data_ptr(), out.data_ptr(), lanes,
        *_build.scalar_parts(alpha), _build.stream_of(d),
    )
    csr_spgemm_sddmm.launches += 1
    return out


csr_spgemm_sddmm.launches = 0
