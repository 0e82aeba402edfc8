"""Differentiable sparse products: the port's device API.

``coo_spmm_raw(rows, cols, vals, b, m)``, ``coo_spmv(rows, cols, vals,
x, m, alpha, beta, y0)`` and ``bsr_spmm(block_data, block_rows,
block_cols, b, m, alpha, beta, c0)`` are the counterparts of the JAX
package's ``_xla.coo_spmm_raw``, ``_xla.coo_spmv`` and ``_xla.bsr_spmm``:
A given as expanded COO (of entries or of square blocks), the result a
dense tensor, and the functions open to PyTorch's transforms as the JAX
ones are to JAX's.  Each runs one ``torch.autograd.Function``
(``setup_context`` form, which ``torch.func`` needs):

- ``CsrSpmm``: forward C = alpha A b + beta c0 on K2 (``ops/csr``);
  backward dL/d(values) = conj(alpha) (G b^H) at A's pattern on K7
  (``ops/sddmm``), dL/db = conj(alpha) A^H G on K2 over A's transposed
  structure, dL/dc0 = conj(beta) G; ``jvp`` alpha (A(dvals) b + A db) on
  K2 (two launches, the second adding the first in its epilogue); ``vmap``
  folds a batch of b (and c0) into the columns, one K2 launch for all,
  and takes a batch of values to the batched form below, one K2 launch
  for all members.
- ``CsrSpmv``: the same with K3 for y = alpha A x + beta y0, K7 at n = 1
  and K3 over A^H; its ``vmap`` makes a batch of x the columns of one
  K2, and a batch of values one batched K2 launch at n = 1.
- ``BsrSpmm``: the same for BSR A (``formats.BsrPattern``) on K1, with
  dL/d(blocks) on K8 (``ops/bsr.bsr_sddmm``, block SDDMM) and dL/db on K1
  over A^H's blocks ``data[order].transpose(1, 2)``, conjugated.
- ``CsrSpgemmDense``: C = alpha op(A) op(B) + beta c0 with dense output
  on K6 (``ops/spgemm``); backward dL/d(op(A)'s values) = conj(alpha)
  G op(B)^H at op(A)'s pattern and dL/d(op(B)'s values) =
  conj(alpha) op(A)^H G at op(B)'s, both on K9 (``ops/spgemm_grad``; G's
  upper triangle under ``triangular``, which keeps only j >= i of the
  product while c0 is added everywhere), dL/dc0 = conj(beta) G; ``jvp``
  two K6 launches; ``vmap`` one batched K6 launch.
- ``CsrSpgemm``: C = op(A) op(B) with sparse output on K4 + K5
  (``ops/spgemm``), returning C's (indptr, indices, data); backward
  dL/d(op(A)'s values) = G op(B)^H at op(A)'s pattern and dL/d(op(B)'s
  values) = op(A)^H G at op(B)'s, G = dL/d(data) on C's structural
  pattern, both on K11 (``ops/spgemm_grad.csr_spgemm_sparse_sddmm``);
  ``jvp`` two K5 launches on the saved pattern (``CsrSpgemmFill``, no
  second K4); ``vmap`` one K4 and one batched K5 (the members share C's
  pattern).
- ``CsrSddmm``, ``BsrSddmm``, ``CsrSpgemmSddmm``,
  ``CsrSpgemmSparseSddmm`` and ``CsrSpgemmFill``: K7, K8, K9, K11 and K5
  themselves, so that the backward's launches are open to the transforms
  too (``torch.func.grad`` runs the backward on wrapped tensors, which
  only a Function's forward sees unwrapped, and ``vmap`` of ``grad``
  batches them).

Batches (``torch.func.vmap``, and ``jacrev``, ``jacfwd``, ``hessian`` and
per-sample gradients, which are built on it).  Every Function here but
``CsrSpmv`` takes its operands with a member dimension ahead (values (B, nnz) or blocks (B,
nblocks, bs, bs), b (B, k, n), c0 and g (B, m, n) or G's values (B,
nnz(C)), each per member or shared) and runs them as one batched launch
(``csr.spmm_batched``, ``sddmm.sddmm_batched``, ``bsr.spmm_batched``,
``bsr.sddmm_batched``, ``spgemm.spgemm_dense_batched``,
``spgemm.fill_batched``, ``spgemm.product_batched`` (one K4 for the
batch), ``spgemm_grad.sampled_batched``,
``spgemm_grad.sparse_sampled_batched``): their ``vmap`` rules move the
batch to the front and call that form, so each ``vmap`` level is one
launch whatever its size; a level outside another merges its batch with
the members already there.  Their backward and ``jvp`` take the same
form (the gradient of a shared operand summed over the members), so the
transforms compose to any depth.  ``CsrSpmv``'s ``vmap`` runs
``CsrSpmm``'s batched form at n = 1.

Gradients follow PyTorch's convention for complex values, the conjugate
of JAX's: for |z|^2 at 3+4j JAX gives 6-8j, PyTorch 6+8j.  Every Function
here is differentiable to any order: each backward runs Functions, and
the gradient Functions' own derivatives run the same kernels again, so
``torch.func.hessian``, a double backward, ``jvp`` of ``grad`` and
``gradgradcheck`` work through every device function:

- ``CsrSddmm`` (K7): backward K2 over P and over P^T, ``jvp`` two K7;
- ``BsrSddmm`` (K8): backward K1 over A's pattern and over its cached
  transpose, ``jvp`` two K8;
- ``CsrSpgemmSddmm`` (K9): backward K6 (the dense-output product of W,
  the incoming gradient on P's pattern, with op(B), or of op(A) with W)
  and K9 in the other form, ``jvp`` two K9;
- ``CsrSpgemmSparseSddmm`` (K11): backward K5 on C's saved pattern (W
  times op(B), or op(A) times W) and K11 in the other form, ``jvp`` two
  K11;
- ``CsrSpgemmFill`` (K5): backward the two K11 forms, ``jvp`` two K5.

Without a second-order request the first-order launches are unchanged:
a backward that builds no graph saves nothing in the gradient Functions.

A^H's structure (``CsrPattern.transpose``, ``BsrPattern.transpose``) is
built once per pattern and cached; its values are gathered from the
current values at every backward (``data[order]``, conjugated by
``_conj_values``, never by the lazy ``conj()`` alone, whose bit the kernels
cannot see), so the gradient follows values that a training step updates
in place.  ``csr.csr_spmm``, ``csr.csr_spmv``, ``bsr.bsr_spmm``,
``spgemm.csr_spgemm`` and ``spgemm.csr_spgemm_dense`` take these
Functions whenever autograd or a transform follows an operand, on either
device: the CPU and the card build the same graph.  The wrappers that
carry no gradient (K5's fill, and K7, K8, K9 and K11 called directly)
raise on such an operand (``csr.refuse_tracked``).
"""

import torch

from ..formats import BsrPattern, CsrPattern, coo_structure, structure_only
from . import bsr, csr, sddmm, spgemm, spgemm_grad


def _conj(s):
    """The conjugate of a Python scalar (None stays None)."""
    return s.conjugate() if isinstance(s, complex) else s


def _beta(beta, c0):
    """The factor of c0 in the kernels' epilogue: beta, 1 when None."""
    if c0 is None:
        return None
    return 1.0 if beta is None else beta


def _conj_values(t):
    """conj(t) as a tensor of its own (``conj().resolve_conj()``: the
    kernels cannot see a lazy conjugate's bit, and ``torch.func.vmap``
    batches this in one call where it runs ``conj_physical`` once a
    member)."""
    return t.conj().resolve_conj()


def _transposed(pattern, data):
    """(pattern of A^H, its values): A's cached transposed structure and
    conj(data) gathered through its permutation (each member's, for
    values (B, nnz))."""
    t, order = pattern.transpose()
    return t, _conj_values(data[..., order])


def _bsr_transposed(pattern, data):
    """(pattern of A^H, its blocks) for the BSR A of ``pattern`` with
    blocks ``data`` ((nblocks, bs, bs), or (B, nblocks, bs, bs) for a
    batch): the cached transposed structure, the blocks gathered through
    its permutation, each transposed and conjugated."""
    t, order = pattern.transpose()
    return t, _conj_values(data[..., order, :, :].mT)


def _plain(*tensors):
    return [None if t is None else t.contiguous() for t in tensors]


def _fold(t, dim, size, at):
    """``t`` with its batch dimension ``dim`` (None: not batched, then
    expanded to ``size``) moved to position ``at`` and merged with the
    next one, contiguous: the batch of (k, n) operands as one (k, B * n)."""
    if t is None:
        return None
    t = t.unsqueeze(at).expand(*t.shape[:at], size, *t.shape[at:]) \
        if dim is None else t.movedim(dim, at)
    return t.contiguous().flatten(at, at + 1)


def _member(t, core):
    """Whether operand ``t`` comes with a member dimension ahead of its
    ``core`` dimensions: the batched form of the Functions, whose forward
    is one batched launch."""
    return t is not None and t.dim() > core


def _sum_to(t, dims):
    """The gradient ``t`` of an operand of ``dims`` dimensions: summed
    over the members when the operand had no member dimension (every
    member read it)."""
    return t.sum(0) if t is not None and t.dim() > dims else t


def _to_shape(t, shape):
    """A tangent ``t`` of a batched output of ``shape``: a term that no
    member's operand touched is the same for every member."""
    return t if t.shape == shape else t.expand(shape).contiguous()


def _members(info, in_dims, tensors, cores):
    """A ``vmap`` rule's operands as one batched call of its Function:
    each of ``tensors`` (operands of ``cores`` dimensions, perhaps with a
    member dimension already, from a ``vmap`` level inside this one)
    with this level's batch dimension ``in_dims`` moved to 0.  Without
    members inside, this level's batch is the members and an operand it
    does not batch stays shared (no copy).  With members inside (B1 of
    them), the B members of this level and those B1 are merged into
    B * B1 members (member (i, j) at i * B1 + j), and an operand that
    only one of the two batches is copied for the other.  Returns the
    operands and B1 (None without members inside)."""
    size = info.batch_size
    inner = None
    for t, d, core in zip(tensors, in_dims, cores):
        if t is not None and t.dim() - (d is not None) > core:
            inner = (t if d is None else t.movedim(d, 0)[0]).shape[0]
    out = []
    for t, d, core in zip(tensors, in_dims, cores):
        if t is None:
            out.append(None)
            continue
        x = t if d is None else t.movedim(d, 0)
        if inner is not None:
            has = x.dim() - (d is not None) > core
            if d is None and has:
                x = x.expand(size, *x.shape).flatten(0, 1)
            elif d is not None and not has:
                x = x.unsqueeze(1).expand(size, inner,
                                          *x.shape[1:]).flatten(0, 1)
            elif d is not None:
                x = x.flatten(0, 1)
        out.append(x)
    return out, inner


def _unmerge(out, info, inner):
    """A batched call's (members, ...) result as ``vmap``'s: (B, B1, ...)
    after ``_members`` merged two batches, else as it is."""
    if inner is None:
        return out, 0
    return out.unflatten(0, (info.batch_size, inner)), 0


class CsrSddmm(torch.autograd.Function):
    """out[p] = alpha * sum_n g[r_p, n] conj(b[c_p, n]) (K7), for the
    backward of ``CsrSpmm`` and ``CsrSpmv``, where ``vmap`` of ``grad``
    batches it.  Its own derivatives, the second derivatives of those
    two, run on the same kernels: with W the CSR of P's pattern holding
    the incoming gradient w, dL/dg = conj(alpha) W b and dL/db = alpha
    W^H g on K2 (over P and its cached transpose), and the ``jvp`` alpha
    (dg b^H + g db^H) at P's entries is two K7 launches.  ``g`` (m, n) and
    ``b`` (k, n) may each come with a member dimension ahead (the batched
    form): the output is then (B, nnz), one batched K7 launch, and the
    ``vmap`` rule calls that form."""

    @staticmethod
    def forward(pattern, g, b, alpha):
        g, b = _plain(g, b)
        if _member(g, 2) or _member(b, 2):
            return sddmm.sddmm_batched(pattern.indptr, pattern.indices, g, b,
                                       alpha, pattern.transpose)
        return sddmm.sddmm(pattern.indptr, pattern.indices, g, b, alpha)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pattern, g, b, alpha = inputs
        ctx.pattern, ctx.alpha = pattern, alpha
        ctx.dims = (g.dim(), b.dim())
        ctx.save_for_backward(g, b)
        ctx.save_for_forward(g, b)

    @staticmethod
    def backward(ctx, grad):
        g, b = ctx.saved_tensors
        pattern, alpha = ctx.pattern, ctx.alpha
        _, need_g, need_b, _ = ctx.needs_input_grad
        g_g = g_b = None
        if need_g:
            g_g = _sum_to(CsrSpmm.apply(pattern, grad, b, _conj(alpha), None,
                                        None), ctx.dims[0])
        if need_b:
            t, grad_t = _transposed(pattern, grad)
            g_b = _sum_to(CsrSpmm.apply(t, grad_t, g, alpha, None, None),
                          ctx.dims[1])
        return None, g_g, g_b, None

    @staticmethod
    def jvp(ctx, _pattern, d_g, d_b, _alpha):
        g, b = ctx.saved_tensors
        out = None
        if d_g is not None:
            out = CsrSddmm.apply(ctx.pattern, d_g, b, ctx.alpha)
        if d_b is not None:
            d_out = CsrSddmm.apply(ctx.pattern, g, d_b, ctx.alpha)
            out = d_out if out is None else out + d_out
        return out

    @staticmethod
    def vmap(info, in_dims, pattern, g, b, alpha):
        (g, b), inner = _members(info, in_dims[1:3], (g, b), (2, 2))
        return _unmerge(CsrSddmm.apply(pattern, g, b, alpha), info, inner)


class CsrSpmm(torch.autograd.Function):
    """C = alpha * A @ b + beta * c0 on K2, A the CSR of ``pattern`` with
    values ``data``; differentiable in ``data``, ``b`` and ``c0``.
    ``data`` (nnz,), ``b`` (k, n) and ``c0`` (m, n) may each come with a
    member dimension ahead (the batched form): the output is then (B, m,
    n), one batched K2 launch, and the gradient of an operand without it
    is summed over the members."""

    @staticmethod
    def forward(pattern, data, b, alpha, beta, c0):
        data, b, c0 = _plain(data, b, c0)
        if _member(data, 1) or _member(b, 2) or _member(c0, 2):
            return csr.spmm_batched(pattern.indptr, pattern.indices, data, b,
                                    alpha, beta, c0, pattern.plan())
        return csr.spmm(pattern.indptr, pattern.indices, data, b, alpha,
                        beta, c0, pattern.plan())

    @staticmethod
    def setup_context(ctx, inputs, output):
        pattern, data, b, alpha, beta, c0 = inputs
        ctx.pattern, ctx.alpha, ctx.beta = pattern, alpha, _beta(beta, c0)
        ctx.dims = (data.dim(), b.dim(), None if c0 is None else c0.dim())
        ctx.shape = output.shape
        ctx.save_for_backward(data, b)
        ctx.save_for_forward(data, b)

    @staticmethod
    def backward(ctx, grad):
        data, b = ctx.saved_tensors
        pattern, alpha = ctx.pattern, _conj(ctx.alpha)
        _, need_data, need_b, _, _, need_c0 = ctx.needs_input_grad
        grad = grad.contiguous()
        g_data = g_b = g_c0 = None
        if need_data:
            g_data = _sum_to(CsrSddmm.apply(pattern, grad, b, alpha),
                             ctx.dims[0])
        if need_b:
            t, data_t = _transposed(pattern, data)
            g_b = _sum_to(CsrSpmm.apply(t, data_t, grad, alpha, None, None),
                          ctx.dims[1])
        if need_c0:
            g_c0 = _sum_to(grad * _conj(ctx.beta), ctx.dims[2])
        return None, g_data, g_b, None, None, g_c0

    @staticmethod
    def jvp(ctx, _pattern, d_data, d_b, _alpha, _beta, d_c0):
        data, b = ctx.saved_tensors
        pattern, alpha = ctx.pattern, ctx.alpha
        out = None if d_c0 is None else d_c0 * ctx.beta
        if d_data is not None:
            out = CsrSpmm.apply(pattern, d_data, b, alpha,
                                None if out is None else 1.0, out)
        if d_b is not None:
            out = CsrSpmm.apply(pattern, data, d_b, alpha,
                                None if out is None else 1.0, out)
        return _to_shape(out, ctx.shape)

    @staticmethod
    def vmap(info, in_dims, pattern, data, b, alpha, beta, c0):
        _, d_data, d_b, _, _, d_c0 = in_dims
        size, m = info.batch_size, pattern.shape[0]
        if (d_data is None and not _member(data, 1)
                and not _member(b, 2 + (d_b is not None))
                and not _member(c0, 2 + (d_c0 is not None))):
            # A batch of b (and c0) alone: the columns of one K2 launch.
            out = CsrSpmm.apply(pattern, data, _fold(b, d_b, size, 1),
                                alpha, beta, _fold(c0, d_c0, size, 1))
            return out.view(m, size, out.shape[1] // size), 1
        (data, b, c0), inner = _members(info, (d_data, d_b, d_c0),
                                        (data, b, c0), (1, 2, 2))
        return _unmerge(CsrSpmm.apply(pattern, data, b, alpha, beta, c0),
                        info, inner)


class CsrSpmv(torch.autograd.Function):
    """y = alpha * A @ x + beta * y0 on K3, A the CSR of ``pattern`` with
    values ``data``; differentiable in ``data``, ``x`` and ``y0``."""

    @staticmethod
    def forward(pattern, data, x, alpha, beta, y0):
        data, x, y0 = _plain(data, x, y0)
        return csr.spmv(pattern.indptr, pattern.indices, data, x, alpha,
                        beta, y0, pattern.plan(spmv=True))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pattern, data, x, alpha, beta, y0 = inputs
        ctx.pattern, ctx.alpha, ctx.beta = pattern, alpha, _beta(beta, y0)
        ctx.save_for_backward(data, x)
        ctx.save_for_forward(data, x)

    @staticmethod
    def backward(ctx, grad):
        data, x = ctx.saved_tensors
        pattern, alpha = ctx.pattern, _conj(ctx.alpha)
        _, need_data, need_x, _, _, need_y0 = ctx.needs_input_grad
        grad = grad.contiguous()
        g_data = g_x = g_y0 = None
        if need_data:
            g_data = CsrSddmm.apply(pattern, grad[:, None], x[:, None],
                                    alpha)
        if need_x:
            t, data_t = _transposed(pattern, data)
            g_x = CsrSpmv.apply(t, data_t, grad, alpha, None, None)
        if need_y0:
            g_y0 = grad * _conj(ctx.beta)
        return None, g_data, g_x, None, None, g_y0

    @staticmethod
    def jvp(ctx, _pattern, d_data, d_x, _alpha, _beta, d_y0):
        data, x = ctx.saved_tensors
        pattern, alpha = ctx.pattern, ctx.alpha
        out = None if d_y0 is None else d_y0 * ctx.beta
        if d_data is not None:
            out = CsrSpmv.apply(pattern, d_data, x, alpha,
                                None if out is None else 1.0, out)
        if d_x is not None:
            out = CsrSpmv.apply(pattern, data, d_x, alpha,
                                None if out is None else 1.0, out)
        return out

    @staticmethod
    def vmap(info, in_dims, pattern, data, x, alpha, beta, y0):
        _, d_data, d_x, _, _, d_y0 = in_dims
        size = info.batch_size
        if d_data is None:
            # The batch of x as the columns of one (k, B) operand: one K2.
            cols = _fold(x[..., None], d_x, size, 1)
            rhs = _fold(None if y0 is None else y0[..., None], d_y0, size, 1)
            return CsrSpmm.apply(pattern, data, cols, alpha, beta, rhs), 1
        # A batch of values: K2 at n = 1 over the members, x and y0 as
        # (k, 1) and (m, 1) members (or shared), one launch.
        data = data.movedim(d_data, 0)
        x = (x if d_x is None else x.movedim(d_x, 0))[..., None]
        if y0 is not None:
            y0 = (y0 if d_y0 is None else y0.movedim(d_y0, 0))[..., None]
        return CsrSpmm.apply(pattern, data, x, alpha, beta, y0)[..., 0], 0


class BsrSddmm(torch.autograd.Function):
    """out[b] = alpha * g's block row r_b @ (b's block row c_b)^H (K8),
    for the backward of ``BsrSpmm``, open to the transforms as
    ``CsrSddmm`` is.  Its own derivatives, the second derivatives of
    ``BsrSpmm``, run on K1 and K8: with W the BSR of ``pattern`` holding
    the incoming gradient's blocks w, dL/dg = conj(alpha) W b on K1 and
    dL/db = alpha W^H g on K1 over the cached transpose (W^H's blocks
    ``w[order].transpose(1, 2)``, conjugated); the ``jvp`` alpha (dg
    b^H + g db^H) at the stored blocks is two K8 launches.  ``g`` and
    ``b`` may each come with a member dimension ahead (the batched form,
    output (B, nblocks, bs, bs), one batched K8 launch), as for
    ``CsrSddmm``."""

    @staticmethod
    def forward(pattern, g, b, alpha):
        g, b = _plain(g, b)
        if _member(g, 2) or _member(b, 2):
            return bsr.sddmm_batched(pattern.indptr, pattern.indices, g, b,
                                     pattern.bs, alpha)
        return bsr.sddmm(pattern.indptr, pattern.indices, g, b, pattern.bs,
                         alpha)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pattern, g, b, alpha = inputs
        ctx.pattern, ctx.alpha = pattern, alpha
        ctx.dims = (g.dim(), b.dim())
        ctx.save_for_backward(g, b)
        ctx.save_for_forward(g, b)

    @staticmethod
    def backward(ctx, grad):
        g, b = ctx.saved_tensors
        pattern, alpha = ctx.pattern, ctx.alpha
        _, need_g, need_b, _ = ctx.needs_input_grad
        g_g = g_b = None
        if need_g:
            g_g = _sum_to(BsrSpmm.apply(pattern, grad, b, _conj(alpha), None,
                                        None), ctx.dims[0])
        if need_b:
            t, grad_t = _bsr_transposed(pattern, grad)
            g_b = _sum_to(BsrSpmm.apply(t, grad_t, g, alpha, None, None),
                          ctx.dims[1])
        return None, g_g, g_b, None

    @staticmethod
    def jvp(ctx, _pattern, d_g, d_b, _alpha):
        g, b = ctx.saved_tensors
        out = None
        if d_g is not None:
            out = BsrSddmm.apply(ctx.pattern, d_g, b, ctx.alpha)
        if d_b is not None:
            d_out = BsrSddmm.apply(ctx.pattern, g, d_b, ctx.alpha)
            out = d_out if out is None else out + d_out
        return out

    @staticmethod
    def vmap(info, in_dims, pattern, g, b, alpha):
        (g, b), inner = _members(info, in_dims[1:3], (g, b), (2, 2))
        return _unmerge(BsrSddmm.apply(pattern, g, b, alpha), info, inner)


class BsrSpmm(torch.autograd.Function):
    """C = alpha * A @ b + beta * c0 on K1, A the BSR of ``pattern``
    (``formats.BsrPattern``) with blocks ``data``; differentiable in
    ``data``, ``b`` and ``c0``, to any order (its backward runs
    ``BsrSddmm`` and itself).  ``data`` (nblocks, bs, bs), ``b`` and
    ``c0`` may each come with a member dimension ahead (the batched form,
    output (B, m, n), one batched K1 launch), as for ``CsrSpmm``."""

    @staticmethod
    def forward(pattern, data, b, alpha, beta, c0):
        data, b, c0 = _plain(data, b, c0)
        if _member(data, 3) or _member(b, 2) or _member(c0, 2):
            return bsr.spmm_batched(pattern.indptr, pattern.indices, data, b,
                                    alpha, beta, c0, pattern.plan())
        return bsr.spmm(pattern.indptr, pattern.indices, data, b, alpha,
                        beta, c0, pattern.plan())

    @staticmethod
    def setup_context(ctx, inputs, output):
        pattern, data, b, alpha, beta, c0 = inputs
        ctx.pattern, ctx.alpha, ctx.beta = pattern, alpha, _beta(beta, c0)
        ctx.dims = (data.dim(), b.dim(), None if c0 is None else c0.dim())
        ctx.shape = output.shape
        ctx.save_for_backward(data, b)
        ctx.save_for_forward(data, b)

    @staticmethod
    def backward(ctx, grad):
        data, b = ctx.saved_tensors
        pattern, alpha = ctx.pattern, _conj(ctx.alpha)
        _, need_data, need_b, _, _, need_c0 = ctx.needs_input_grad
        grad = grad.contiguous()
        g_data = g_b = g_c0 = None
        if need_data:
            g_data = _sum_to(BsrSddmm.apply(pattern, grad, b, alpha),
                             ctx.dims[0])
        if need_b:
            t, data_t = _bsr_transposed(pattern, data)
            g_b = _sum_to(BsrSpmm.apply(t, data_t, grad, alpha, None, None),
                          ctx.dims[1])
        if need_c0:
            g_c0 = _sum_to(grad * _conj(ctx.beta), ctx.dims[2])
        return None, g_data, g_b, None, None, g_c0

    @staticmethod
    def jvp(ctx, _pattern, d_data, d_b, _alpha, _beta, d_c0):
        data, b = ctx.saved_tensors
        pattern, alpha = ctx.pattern, ctx.alpha
        out = None if d_c0 is None else d_c0 * ctx.beta
        if d_data is not None:
            out = BsrSpmm.apply(pattern, d_data, b, alpha,
                                None if out is None else 1.0, out)
        if d_b is not None:
            out = BsrSpmm.apply(pattern, data, d_b, alpha,
                                None if out is None else 1.0, out)
        return _to_shape(out, ctx.shape)

    @staticmethod
    def vmap(info, in_dims, pattern, data, b, alpha, beta, c0):
        _, d_data, d_b, _, _, d_c0 = in_dims
        size, m = info.batch_size, pattern.shape[0]
        if (d_data is None and not _member(data, 3)
                and not _member(b, 2 + (d_b is not None))
                and not _member(c0, 2 + (d_c0 is not None))):
            # A batch of b (and c0) alone: the columns of one K1 launch.
            out = BsrSpmm.apply(pattern, data, _fold(b, d_b, size, 1),
                                alpha, beta, _fold(c0, d_c0, size, 1))
            return out.view(m, size, out.shape[1] // size), 1
        (data, b, c0), inner = _members(info, (d_data, d_b, d_c0),
                                        (data, b, c0), (3, 2, 2))
        return _unmerge(BsrSpmm.apply(pattern, data, b, alpha, beta, c0),
                        info, inner)


class CsrSpgemmSddmm(torch.autograd.Function):
    """K9's function (``ops/spgemm_grad``) at the entries (r_p, c_p) of
    ``p`` (a ``CsrPattern``, on whose plans K9's runs are cached), for
    row-major ``d`` and X the CSR of ``x`` with values ``x_data``:

    - the dA form: out[p] = alpha sum_s d[r_p, s] conj(X[c_p, s]), with
      X = op(B) (K9's Y);
    - the dB form (``transposed``): out[p] = alpha sum_i d[i, c_p]
      conj(X[i, r_p]), with X = op(A), which K9 reads as Y = X^T through
      X's cached transpose (``x_data`` gathered through its permutation).

    These are the backward's launches of ``CsrSpgemmDense``, open to the
    transforms as ``CsrSddmm`` is.  The function is bilinear in (d,
    x_data); with W the CSR of ``p``'s pattern holding the incoming
    gradient w, its own derivatives are dL/dd = conj(alpha) W X (dA) or
    conj(alpha) X W (dB), on K6 (``CsrSpgemmDense``, which sorts the
    rows of its op(B), ``p`` or ``x``, once per pattern: they come in the
    caller's order), and dL/d(x_data) = the other form at X's entries
    with W in place of X (``CsrSpgemmSddmm`` again, K9); the ``jvp`` is
    two K9 launches.  ``d`` and ``x_data`` may each come with a member
    dimension ahead (the batched form: output (B, nnz(P)), one batched K9
    launch), as for ``CsrSddmm``."""

    @staticmethod
    def forward(p, d, x, x_data, alpha, transposed):
        d, x_data = _plain(d, x_data)
        y, y_data = x, x_data
        if transposed:
            y, order = x.transpose()
            y_data = x_data[..., order]
        sampled = (spgemm_grad.sampled_batched
                   if _member(d, 2) or _member(x_data, 1)
                   else spgemm_grad.sampled)
        return sampled(p.indptr, p.indices, d, y.indptr, y.indices, y_data,
                       alpha, transposed, p, y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        p, d, x, x_data, alpha, transposed = inputs
        ctx.p, ctx.x, ctx.alpha, ctx.transposed = p, x, alpha, transposed
        ctx.dims, ctx.shape = (d.dim(), x_data.dim()), output.shape
        ctx.save_for_backward(d, x_data)
        ctx.save_for_forward(d, x_data)

    @staticmethod
    def backward(ctx, grad):
        d, x_data = ctx.saved_tensors
        p, x, alpha = ctx.p, ctx.x, ctx.alpha
        _, need_d, _, need_x, _, _ = ctx.needs_input_grad
        g_d = g_x = None
        if need_d:
            # W X (dA) or X W (dB); K6's op(B), X or W, in caller order.
            left, right = ((x, x_data), (p, grad)) if ctx.transposed else (
                (p, grad), (x, x_data))
            g_d = _sum_to(CsrSpgemmDense.apply(*left, *right, _conj(alpha),
                                               None, None, False, False),
                          ctx.dims[0])
        if need_x:
            g_x = _sum_to(CsrSpgemmSddmm.apply(x, d, p, grad, alpha,
                                               not ctx.transposed),
                          ctx.dims[1])
        return None, g_d, None, g_x, None, None

    @staticmethod
    def jvp(ctx, _p, d_d, _x, d_x, _alpha, _transposed):
        d, x_data = ctx.saved_tensors
        out = None
        for dd, xx in ((d_d, x_data), (d, d_x)):
            if dd is None or xx is None:
                continue
            d_out = CsrSpgemmSddmm.apply(ctx.p, dd, ctx.x, xx, ctx.alpha,
                                         ctx.transposed)
            out = d_out if out is None else out + d_out
        return _to_shape(out, ctx.shape)

    @staticmethod
    def vmap(info, in_dims, p, d, x, x_data, alpha, transposed):
        (d, x_data), inner = _members(info, (in_dims[1], in_dims[3]),
                                      (d, x_data), (2, 1))
        return _unmerge(CsrSpgemmSddmm.apply(p, d, x, x_data, alpha,
                                             transposed), info, inner)


class CsrSpgemmDense(torch.autograd.Function):
    """C = alpha * op(A) @ op(B) + beta * c0 with dense output on K6 (only
    j >= i of the product with ``triangular``, c0 added everywhere), op(A)
    and op(B) the CSRs of ``a`` and ``b`` (``CsrPattern``s) with values
    ``a_data`` and ``b_data``; differentiable in ``a_data``, ``b_data``
    and ``c0``, to any order (its backward runs ``CsrSpgemmSddmm``).
    ``a_data``, ``b_data`` (nnz,) and ``c0`` (m, n) may each come with a
    member dimension ahead (the batched form: output (B, m, n), one
    batched K6 launch), as for ``CsrSpmm``."""

    @staticmethod
    def forward(a, a_data, b, b_data, alpha, beta, c0, triangular,
                b_sorted):
        a_data, b_data, c0 = _plain(a_data, b_data, c0)
        b_indices = b.indices
        if not b_sorted:
            # Sorted and checked for repeated columns once per pattern.
            b_indices, order = b.sorted_columns()
            b_data = b_data[..., order]
        dense = (spgemm.spgemm_dense_batched
                 if _member(a_data, 1) or _member(b_data, 1)
                 or _member(c0, 2) else spgemm.spgemm_dense)
        return dense(a.indptr, a.indices, a_data, b.indptr, b_indices,
                     b_data, b.ncols, alpha, beta, c0, triangular, True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, a_data, b, b_data, alpha, beta, c0, triangular, b_sorted = inputs
        ctx.a, ctx.b, ctx.alpha, ctx.beta = a, b, alpha, _beta(beta, c0)
        ctx.triangular, ctx.b_sorted = triangular, b_sorted
        ctx.dims = (a_data.dim(), b_data.dim(),
                    None if c0 is None else c0.dim())
        ctx.shape = output.shape
        ctx.save_for_backward(a_data, b_data)
        ctx.save_for_forward(a_data, b_data)

    @staticmethod
    def backward(ctx, grad):
        a_data, b_data = ctx.saved_tensors
        need = ctx.needs_input_grad
        grad = grad.contiguous()
        # The product reaches only j >= i under ``triangular``; c0 all.
        g = torch.triu(grad) if ctx.triangular else grad
        alpha = _conj(ctx.alpha)
        g_a = g_b = g_c0 = None
        if need[1]:
            g_a = _sum_to(CsrSpgemmSddmm.apply(ctx.a, g, ctx.b, b_data, alpha,
                                               False), ctx.dims[0])
        if need[3]:
            # The dB form reads G's columns: no transposed copy.
            g_b = _sum_to(CsrSpgemmSddmm.apply(ctx.b, g, ctx.a, a_data, alpha,
                                               True), ctx.dims[1])
        if need[6]:
            g_c0 = _sum_to(grad * _conj(ctx.beta), ctx.dims[2])
        return None, g_a, None, g_b, None, None, g_c0, None, None

    @staticmethod
    def jvp(ctx, _a, d_a, _b, d_b, _alpha, _beta, d_c0, _tri, _sorted):
        a_data, b_data = ctx.saved_tensors
        out = None if d_c0 is None else d_c0 * ctx.beta

        def add(a_vals, b_vals, out):
            return CsrSpgemmDense.apply(
                ctx.a, a_vals, ctx.b, b_vals, ctx.alpha,
                None if out is None else 1.0, out, ctx.triangular,
                ctx.b_sorted)

        if d_a is not None:
            out = add(d_a, b_data, out)
        if d_b is not None:
            out = add(a_data, d_b, out)
        return _to_shape(out, ctx.shape)

    @staticmethod
    def vmap(info, in_dims, a, a_data, b, b_data, alpha, beta, c0,
             triangular, b_sorted):
        _, d_a, _, d_b, _, _, d_c0, _, _ = in_dims
        (a_data, b_data, c0), inner = _members(info, (d_a, d_b, d_c0),
                                               (a_data, b_data, c0),
                                               (1, 1, 2))
        return _unmerge(CsrSpgemmDense.apply(a, a_data, b, b_data, alpha,
                                             beta, c0, triangular, b_sorted),
                        info, inner)


def _sparse_value_grads(ctx, a_data, b_data, indptr, indices, grad):
    """(dL/d(op(A)'s values), dL/d(op(B)'s values)) of op(A) @ op(B)'s
    values on C's pattern (``indptr``, ``indices``) for G = ``grad`` on
    it, each None where ``ctx.needs_input_grad`` does not ask for it (at
    positions 1 and 3): the two K11 forms (``CsrSpgemmSparseSddmm``),
    each summed over the members where its operand had none
    (``ctx.dims``)."""
    need = ctx.needs_input_grad

    def grad_of(transposed):
        return _sum_to(CsrSpgemmSparseSddmm.apply(
            ctx.a, a_data, ctx.b, b_data, indptr, indices, grad, transposed,
            ctx.triangular), ctx.dims[1 if transposed else 0])

    return (grad_of(False) if need[1] else None,
            grad_of(True) if need[3] else None)


def _sparse_value_tangent(ctx, a_data, b_data, indptr, indices, d_a, d_b):
    """The tangent of op(A) @ op(B)'s values on C's pattern (``indptr``,
    ``indices``): K5 of (dA, B) plus K5 of (A, dB) (``CsrSpgemmFill``; no
    second K4), as a batch where an operand has members (``ctx.shape``),
    None where neither tangent is given."""
    out = None
    for a_vals, b_vals in ((d_a, b_data), (a_data, d_b)):
        if a_vals is None or b_vals is None:
            continue
        d_out = CsrSpgemmFill.apply(ctx.a, a_vals, ctx.b, b_vals, indptr,
                                    indices, ctx.triangular)
        out = d_out if out is None else out + d_out
    return None if out is None else _to_shape(out, ctx.shape)


class CsrSpgemmSparseSddmm(torch.autograd.Function):
    """K11's function (``ops/spgemm_grad.csr_spgemm_sparse_sddmm``; the dA
    form, or the dB form with ``transposed``) for op(A) and op(B) the CSRs
    of ``a`` and ``b`` (``CsrPattern``s, op(A)'s holding the transpose
    the dB form reads) with values ``a_data`` and ``b_data``, and G as
    values ``g`` on the pattern (``c_indptr``, ``c_indices``) of their
    product as K5 wrote it: the backward's launches of ``CsrSpgemm``, open
    to the transforms as ``CsrSddmm`` is.  The dA form (at op(A)'s
    entries, sum_j G[i, j] conj(op(B)[k, j])) is bilinear in (b_data, g)
    and reads no ``a_data``; the dB form (at op(B)'s, sum_i conj(op(A)[i,
    k]) G[i, j]) in (a_data, g), and reads no ``b_data``: the gradient
    there is None.  With W the incoming gradient on the output's pattern,
    dL/dg is W op(B) (dA) or op(A) W (dB) on C's pattern, by K5 on it
    (``CsrSpgemmFill``; C's pattern is the structural product of the same
    two patterns: no K4), and dL/d(the operand values a form reads) is
    the other form with W in place of the values it does not read (K11
    again); the ``jvp`` is two K11 launches (none for a tangent of the
    values it does not read).  ``a_data``, ``b_data`` and ``g`` may each
    come with a member dimension ahead (the batched form: output (B,
    nnz(P)), one batched K11 launch)."""

    @staticmethod
    def forward(a, a_data, b, b_data, c_indptr, c_indices, g, transposed,
                triangular):
        a_data, b_data, g = _plain(a_data, b_data, g)
        n = b.ncols
        # K5 writes C's column ids in [0, n): no read of them.
        c = CsrPattern(c_indptr, c_indices, n, span=(0, n))
        sampled = (spgemm_grad.sparse_sampled_batched
                   if _member(a_data, 1) or _member(b_data, 1)
                   or _member(g, 1) else spgemm_grad.sparse_sampled)
        return sampled(a.indptr, a.indices, a_data, b.indptr, b.indices,
                       b_data, c_indptr, c_indices, g, n, transposed,
                       triangular, a, b, c)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, a_data, b, b_data, c_indptr, c_indices, g, transposed, \
            triangular = inputs
        ctx.a, ctx.b = a, b
        ctx.transposed, ctx.triangular = transposed, triangular
        ctx.dims, ctx.shape = (a_data.dim(), b_data.dim(), g.dim()), \
            output.shape
        ctx.save_for_backward(a_data, b_data, c_indptr, c_indices, g)
        ctx.save_for_forward(a_data, b_data, c_indptr, c_indices, g)

    @staticmethod
    def backward(ctx, grad):
        a_data, b_data, indptr, indices, g = ctx.saved_tensors
        need = ctx.needs_input_grad
        a_vals, b_vals = (a_data, grad) if ctx.transposed else (grad,
                                                                b_data)
        g_a = g_b = g_g = None
        if ctx.transposed and need[1]:
            g_a = _sum_to(CsrSpgemmSparseSddmm.apply(
                ctx.a, a_data, ctx.b, grad, indptr, indices, g, False,
                ctx.triangular), ctx.dims[0])
        if not ctx.transposed and need[3]:
            g_b = _sum_to(CsrSpgemmSparseSddmm.apply(
                ctx.a, grad, ctx.b, b_data, indptr, indices, g, True,
                ctx.triangular), ctx.dims[1])
        if need[6]:
            g_g = _sum_to(CsrSpgemmFill.apply(ctx.a, a_vals, ctx.b, b_vals,
                                              indptr, indices,
                                              ctx.triangular), ctx.dims[2])
        return None, g_a, None, g_b, None, None, g_g, None, None

    @staticmethod
    def jvp(ctx, _a, d_a, _b, d_b, _ip, _ix, d_g, _transposed, _tri):
        a_data, b_data, indptr, indices, g = ctx.saved_tensors
        d_read = d_a if ctx.transposed else d_b
        out = None
        for a_vals, b_vals, gg in (
                (a_data, b_data, d_g),
                (d_read, b_data, g) if ctx.transposed else
                (a_data, d_read, g)):
            if a_vals is None or b_vals is None or gg is None:
                continue
            d_out = CsrSpgemmSparseSddmm.apply(ctx.a, a_vals, ctx.b, b_vals,
                                               indptr, indices, gg,
                                               ctx.transposed,
                                               ctx.triangular)
            out = d_out if out is None else out + d_out
        return None if out is None else _to_shape(out, ctx.shape)

    @staticmethod
    def vmap(info, in_dims, a, a_data, b, b_data, c_indptr, c_indices, g,
             transposed, triangular):
        _, d_a, _, d_b, _, _, d_g, _, _ = in_dims
        (a_data, b_data, g), inner = _members(info, (d_a, d_b, d_g),
                                              (a_data, b_data, g), (1, 1, 1))
        return _unmerge(CsrSpgemmSparseSddmm.apply(
            a, a_data, b, b_data, c_indptr, c_indices, g, transposed,
            triangular), info, inner)


class CsrSpgemmFill(torch.autograd.Function):
    """K5 alone: the values of op(A) @ op(B) (the CSRs of ``a`` and ``b``
    with values ``a_data`` and ``b_data``) on the pattern (``c_indptr``,
    ``c_indices``) of their product already counted (only j >= i with
    ``triangular``): the tangents of ``CsrSpgemm``, and the derivatives
    of ``CsrSpgemmSparseSddmm`` in G, open to the transforms.  Its own
    derivatives are ``CsrSpgemm``'s: backward the two K11 forms, ``jvp``
    two K5 fills.  K5's plan and bin sizes are the pattern pair's, made
    once and cached (``spgemm.pair_plan``).  ``a_data`` and ``b_data`` may
    each come with a member dimension ahead (the batched form: output (B,
    nnz(C)), one batched K5 launch)."""

    @staticmethod
    def forward(a, a_data, b, b_data, c_indptr, c_indices, triangular):
        a_data, b_data = _plain(a_data, b_data)
        plan = sizes = None
        if a_data.is_cuda:
            plan, sizes = spgemm.pair_plan(a, b, a_data.dtype)
        if _member(a_data, 1) or _member(b_data, 1):
            return spgemm.fill_batched(
                a.indptr, a.indices, a_data, b.indptr, b.indices, b_data,
                b.ncols, plan, c_indptr, c_indices.numel(), triangular,
                sizes)[1]
        return spgemm.fill(a.indptr, a.indices, a_data, b.indptr, b.indices,
                           b_data, b.ncols, plan, c_indptr,
                           c_indices.numel(), triangular, sizes)[1]

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, a_data, b, b_data, c_indptr, c_indices, triangular = inputs
        ctx.a, ctx.b, ctx.triangular = a, b, triangular
        ctx.dims, ctx.shape = (a_data.dim(), b_data.dim()), output.shape
        ctx.save_for_backward(a_data, b_data, c_indptr, c_indices)
        ctx.save_for_forward(a_data, b_data, c_indptr, c_indices)

    @staticmethod
    def backward(ctx, grad):
        g_a, g_b = _sparse_value_grads(ctx, *ctx.saved_tensors, grad)
        return None, g_a, None, g_b, None, None, None

    @staticmethod
    def jvp(ctx, _a, d_a, _b, d_b, _ip, _ix, _tri):
        return _sparse_value_tangent(ctx, *ctx.saved_tensors, d_a, d_b)

    @staticmethod
    def vmap(info, in_dims, a, a_data, b, b_data, c_indptr, c_indices,
             triangular):
        _, d_a, _, d_b, _, _, _ = in_dims
        (a_data, b_data), inner = _members(info, (d_a, d_b),
                                           (a_data, b_data), (1, 1))
        return _unmerge(CsrSpgemmFill.apply(a, a_data, b, b_data, c_indptr,
                                            c_indices, triangular),
                        info, inner)


class CsrSpgemm(torch.autograd.Function):
    """C = op(A) @ op(B) with sparse output on K4 + K5 (only j >= i with
    ``triangular``), op(A) and op(B) the CSRs of ``a`` and ``b``
    (``CsrPattern``s) with values ``a_data`` and ``b_data``: returns C's
    (indptr, indices, data), differentiable in ``a_data`` and ``b_data``
    through ``data``, to any order; ``indptr`` and ``indices`` carry no
    gradient.  C's pattern is structural and fixed by the operands'
    patterns, so G = dL/d(data) lies on it: backward K11 twice
    (``CsrSpgemmSparseSddmm``), ``jvp`` K5 of (dA, B) plus K5 of (A, dB)
    on the saved pattern (``CsrSpgemmFill``; no second K4).  ``a_data``
    and ``b_data`` may each come with a member dimension ahead (the
    batched form: one plan and K4, one nnz read and one batched K5,
    ``spgemm.product_batched``; ``data`` (B, nnz(C)) on the members' one
    pattern), which the ``vmap`` rule calls."""

    @staticmethod
    def forward(a, a_data, b, b_data, triangular):
        a_data, b_data = _plain(a_data, b_data)
        product = (spgemm.product_batched
                   if _member(a_data, 1) or _member(b_data, 1)
                   else spgemm.product)
        return product(a.indptr, a.indices, a_data, b.indptr, b.indices,
                       b_data, b.ncols, triangular)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, a_data, b, b_data, triangular = inputs
        indptr, indices, data = output
        ctx.mark_non_differentiable(indptr, indices)
        ctx.a, ctx.b, ctx.triangular = a, b, triangular
        ctx.dims, ctx.shape = (a_data.dim(), b_data.dim()), data.shape
        ctx.save_for_backward(a_data, b_data, indptr, indices)
        ctx.save_for_forward(a_data, b_data, indptr, indices)

    @staticmethod
    def backward(ctx, _g_indptr, _g_indices, grad):
        g_a, g_b = _sparse_value_grads(ctx, *ctx.saved_tensors, grad)
        return None, g_a, None, g_b, None

    @staticmethod
    def jvp(ctx, _a, d_a, _b, d_b, _tri):
        return None, None, _sparse_value_tangent(ctx, *ctx.saved_tensors,
                                                 d_a, d_b)

    @staticmethod
    def vmap(info, in_dims, a, a_data, b, b_data, triangular):
        _, d_a, _, d_b, _ = in_dims
        (a_data, b_data), inner = _members(info, (d_a, d_b),
                                           (a_data, b_data), (1, 1))
        # The members share C's pattern: one indptr and indices for all.
        indptr, indices, data = CsrSpgemm.apply(a, a_data, b, b_data,
                                                triangular)
        data, _ = _unmerge(data, info, inner)
        return (indptr, indices, data), (None, None, 0)


class _CooStructure:
    """The CSR form of expanded COO (``rows``, ``cols``) with m rows and k
    columns, ids read by the JAX package's rules
    (``formats.coo_structure``: an id in [-m, 0) or [-k, 0) counts from the
    end, entries with a row outside [-m, m) are dropped, a column outside
    [-k, k) raises), so ``vals[order]`` are the CSR's values in the order
    of ``pattern``.  Built once (one stable sort; one host read, of the
    kept count and of the columns' range) and cached per structure."""

    def __init__(self, rows, cols, m, k):
        with structure_only():
            self.order, indptr, indices = coo_structure(rows, cols, m, k)
        self.pattern = CsrPattern(indptr, indices, k)


class _StructureCache:
    """The last few structures ``build(first, second, *sizes)`` made of two
    index tensors, most recent first: a training loop calls with the same
    index tensors at every step, and their structure is built once.  One
    is found again only for the same tensors, unchanged since (their
    version counters), and the same sizes; it holds them, so their
    storage is not reused meanwhile."""

    def __init__(self, build, size=8):
        self.build, self.size = build, size
        self.entries = []

    def get(self, first, second, *sizes):
        key = (first._version, second._version, *sizes)
        for i, (f, s, k, value) in enumerate(self.entries):
            if f is first and s is second and k == key:
                self.entries.insert(0, self.entries.pop(i))
                return value
        value = self.build(first, second, *sizes)
        self.entries = [(first, second, key, value),
                        *self.entries[:self.size - 1]]
        return value

    def clear(self):
        self.entries = []


# The COO structures of ``coo_spmm_raw`` and ``coo_spmv``, per (rows,
# cols, m, k); the ``CsrPattern``s of ``csr.csr_spmm``, ``csr.csr_spmv``
# and ``spgemm.csr_spgemm_dense``'s tracked calls, per (indptr, indices,
# k); the ``BsrPattern``s of ``bsr_spmm``, per (block rows, block cols, m,
# k, bs), and of ``bsr.bsr_spmm``'s tracked calls, per (indptr, indices,
# nbcols, bs): the transpose's sort and the plans are made once per
# structure.
structures = _StructureCache(_CooStructure)
patterns = _StructureCache(CsrPattern)
bsr_structures = _StructureCache(BsrPattern.from_coo)
bsr_patterns = _StructureCache(BsrPattern)


def _common(vals, dense):
    """``vals`` and ``dense`` in their common dtype (as JAX's
    ``result_type``)."""
    dtype = torch.promote_types(vals.dtype, dense.dtype)
    return vals.to(dtype), dense.to(dtype)


def coo_spmm_raw(rows, cols, vals, b, m):
    """A @ b for A of m rows as expanded COO (``rows``, ``cols``,
    ``vals``), b of (k, n): the counterpart of ``_xla.coo_spmm_raw``, on
    K2, differentiable in ``vals`` and ``b``.  Ids follow NumPy's rules,
    as JAX's: a row id in [-m, 0) (a column id in [-k, 0)) counts from the
    end, entries whose row is outside [-m, m) are dropped (JAX's
    ``mode="drop"``), and a column outside [-k, k) raises; repeated (row,
    col) entries stay separate values, each with its own gradient.  The
    result is on the operands' device (``config.device`` unless the caller
    asks for the CPU)."""
    vals, b = _common(vals, b)
    s = structures.get(rows, cols, m, b.shape[0])
    return CsrSpmm.apply(s.pattern, vals[s.order], b, None, None, None)


def coo_spmv(rows, cols, vals, x, m, alpha=1.0, beta=0.0, y0=None):
    """alpha * A @ x (+ beta * y0) for A of m rows as expanded COO and
    1-d x: the counterpart of ``_xla.coo_spmv``, on K3, differentiable in
    ``vals``, ``x`` and ``y0``; ids are read, rows outside [-m, m)
    dropped and repeated entries kept apart as in ``coo_spmm_raw``."""
    vals, x = _common(vals, x)
    s = structures.get(rows, cols, m, x.shape[0])
    return CsrSpmv.apply(s.pattern, vals[s.order], x, alpha,
                         None if y0 is None else beta, y0)


def bsr_spmm(block_data, block_rows, block_cols, b, m, alpha=None,
             beta=None, c0=None):
    """``alpha * A @ b + beta * c0`` for A of m rows given as square
    blocks ``block_data`` (nb, bs, bs) at block coordinates
    (``block_rows``, ``block_cols``), b of (k, n) with k % bs == 0: the
    counterpart of ``_xla.bsr_spmm``, on K1, differentiable in
    ``block_data``, ``b`` and ``c0`` (K8 and K1 over A^H).  Block ids are
    read as ``coo_spmm_raw`` reads ids (``formats.coo_structure``):
    blocks whose block row lies outside [-m / bs, m / bs) are dropped,
    and repeated blocks stay separate, each with its own gradient.
    Non-square blocks raise, as both packages' containers do.  The blocks
    are sorted by block row once per structure (``bsr_structures``)."""
    if block_data.dim() != 3 or block_data.shape[1] != block_data.shape[2]:
        raise ValueError(f"bsr_spmm: blocks {tuple(block_data.shape)} must "
                         "be square")
    bs = block_data.shape[1]
    if b.dim() != 2 or b.shape[0] % bs or m % bs:
        raise ValueError(f"bsr_spmm: blocks of {bs} must divide m = {m} "
                         f"and b's rows {tuple(b.shape)}")
    data, b = _common(block_data, b)
    c0 = None if c0 is None else c0.to(data.dtype)
    p = bsr_structures.get(block_rows, block_cols, m, b.shape[0], bs)
    return BsrSpmm.apply(p, data[p.order], b, alpha, beta, c0)
