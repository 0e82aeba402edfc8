"""The collectives of the sharded ops, on ``torch.distributed``.

The counterparts of the JAX package's ``shard_map`` collectives:
``jax.lax.psum`` is ``all_reduce``, ``jax.lax.all_gather`` is
``all_gather`` and ``jax.lax.ppermute`` over a ring is ``rotate`` (one
``batch_isend_irecv``).  Each takes the process group of one mesh axis
(``DeviceMesh.get_group(axis)``).  Complex tensors travel as their
``torch.view_as_real`` views.  In a group of one each collective has
JAX's meaning on one device: a sum or a gather is the tensor itself and a
rotation a local copy, so NCCL is not called; a rotation that maps a rank
to itself is never an NCCL self-send either.
"""

import torch
import torch.distributed as dist


def _real(t):
    return torch.view_as_real(t) if t.is_complex() else t


def all_reduce(t, group):
    """Sum ``t`` over the ranks of ``group``, in place; returns ``t``."""
    if dist.get_world_size(group) == 1:
        return t
    dist.all_reduce(_real(t), group=group)
    return t


def all_gather(t, group):
    """The ranks' ``t`` concatenated along dim 0 in rank order (each rank's
    ``t`` of the same shape); ``t`` itself in a group of one."""
    size = dist.get_world_size(group)
    if size == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather([_real(p) for p in parts], _real(t.contiguous()),
                    group=group)
    return torch.cat(parts)


class Rotation:
    """Tensors on their way one ``shift`` around the ring of a group:
    ``wait()`` returns the received tensors.  Until then the received
    buffers are not to be read and the sent tensors not to be written."""

    def __init__(self, received, works, sent=()):
        self.received = received
        self.works = works
        self.sent = sent  # kept alive until the sends complete

    def wait(self):
        for work in self.works:
            work.wait()
        return self.received


def start_rotate(tensors, group, shift=1, tag=0):
    """Start sending each of ``tensors`` from the rank at position r of
    ``group`` to the rank at r - ``shift`` (mod the group's size), and
    receiving the same shapes from r + ``shift`` into new buffers: after
    ``wait()`` rank r holds what rank r + ``shift`` sent.  ``shift`` 1 is
    the JAX package's ring perm ``[(i, (i - 1) % S)]``, -1 its reverse.
    Tensor i of the batch goes with tag ``tag + i``, so each receive is
    matched by position on every backend; rotations in flight together
    take tags that do not overlap."""
    size = dist.get_world_size(group)
    if shift % size == 0:
        return Rotation([t.clone() for t in tensors], [])
    me = dist.get_rank(group)
    to = dist.get_global_rank(group, (me - shift) % size)
    frm = dist.get_global_rank(group, (me + shift) % size)
    sent = [_real(t.contiguous()) for t in tensors]
    received = [torch.empty_like(t) for t in tensors]
    ops = []
    for i, (s, r) in enumerate(zip(sent, received)):
        ops.append(dist.P2POp(dist.isend, s, to, group=group, tag=tag + i))
        ops.append(dist.P2POp(dist.irecv, _real(r), frm, group=group,
                              tag=tag + i))
    return Rotation(received, dist.batch_isend_irecv(ops), sent)
