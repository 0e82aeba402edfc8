"""Multi-process execution on ``torch.distributed``.

Port of ``sparse_dot_tpu/parallel/multihost.py``.  The JAX package runs
one controller over a mesh of devices, or one process per host under
``jax.distributed``; the port is SPMD with one process per device: every
rank calls the same function with the same global inputs, as JAX's
processes do under ``jax.distributed``.

* ``initialize`` is ``init_process_group``: NCCL when ``config.device``
  is "cuda", gloo when it is "cpu" (never gloo on the card, never the CPU
  when the card is missing: ``backend.torch_device`` raises first).  The
  coordinator's ``host:port`` (or any ``init_method`` URL) and the
  process grid become ``init_method``, ``world_size`` and ``rank``; with no
  arguments it reads torchrun's environment (``WORLD_SIZE``, ``RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``) and, with none of it, stays one
  process.  A rank's card is ``cuda:{LOCAL_RANK}`` (or
  ``local_device_ids[0]``), made current before the first NCCL call.
* ``put_sharded`` gives this rank's block of a global host array as a
  ``DTensor`` and ``gather_to_host`` the global array as numpy on every
  rank.  A JAX ``PartitionSpec`` has no torch counterpart: ``spec`` is a
  mesh axis name (dim 0 split over that axis) or ``()`` / None
  (replicated).
* ``sync_global_devices`` is a barrier.

Everything stays single-process when no group has been started; the mesh
constructor (``mesh.make_mesh``) then starts a one-rank group on an
in-process store, so a single-device script needs no ``initialize``.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from ..backend import torch_device
from ..config import config


def is_initialized():
    """True once a process group has been started in this process."""
    return dist.is_available() and dist.is_initialized()


def _rank_device(local_device_ids=None):
    """This rank's device: the card ``cuda:{LOCAL_RANK}`` (or
    ``local_device_ids[0]``), made current, or the CPU."""
    device = torch_device()
    if device.type != "cuda":
        return device
    index = (int(local_device_ids[0]) if local_device_ids
             else int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def _start(device, **kwargs):
    if device.type == "cuda":
        dist.init_process_group("nccl", device_id=device, **kwargs)
    else:
        dist.init_process_group("gloo", **kwargs)


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, local_device_ids=None, **kwargs):
    """Join (or start) the process group: ``coordinator_address``
    ("host:port", or a URL such as "file:///path" or "tcp://host:port"),
    ``num_processes`` and ``process_id`` give ``init_method``,
    ``world_size`` and ``rank``; other keywords go to
    ``init_process_group``.  With no arguments, torchrun's environment, and
    without it a no-op.  No-op when already initialized.  Returns
    ``process_info()``."""
    if is_initialized():
        return process_info()
    if coordinator_address is None and num_processes is None:
        if "WORLD_SIZE" not in os.environ:
            return process_info()
        init = {"init_method": "env://"}
    else:
        url = str(coordinator_address)
        init = {"init_method": url if "://" in url else f"tcp://{url}",
                "world_size": num_processes, "rank": process_id}
    _start(_rank_device(local_device_ids), **init, **kwargs)
    return process_info()


def start_local_group():
    """A one-rank group on an in-process store, when no group has been
    started: what a single-device mesh runs in."""
    if not is_initialized():
        _start(_rank_device(), store=dist.HashStore(), rank=0, world_size=1)


def shutdown():
    """Leave the process group (no-op when not initialized)."""
    if is_initialized():
        dist.destroy_process_group()


def process_info():
    """Process/device topology visible to this process: one device per
    process."""
    init = is_initialized()
    world = dist.get_world_size() if init else 1
    return {
        "process_index": dist.get_rank() if init else 0,
        "process_count": world,
        "local_device_count": 1,
        "global_device_count": world,
        "platform": config.device,
    }


def _mesh_dim(mesh, axis):
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis named {axis!r} (axes: {names})")
    return names.index(axis)


def put_sharded(host_array, mesh, spec):
    """This rank's part of the global ``host_array`` (the same on every
    rank) as a ``DTensor`` on ``mesh``: dim 0 split evenly over the mesh
    axis named ``spec``, or the whole array when ``spec`` is ``()`` or None
    (replicated)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    arr = np.asarray(host_array)
    placements = [Replicate()] * mesh.ndim
    if spec not in (None, ()):
        dim = _mesh_dim(mesh, spec)
        size = mesh.size(dim)
        if arr.shape[0] % size:
            raise ValueError(
                f"dimension 0 of length {arr.shape[0]} does not divide "
                f"evenly over the mesh {spec!r} axis of size {size}")
        rows = arr.shape[0] // size
        at = mesh.get_coordinate()[dim]
        arr = arr[at * rows:(at + 1) * rows]
        placements[dim] = Shard(0)
    local = torch.from_numpy(np.ascontiguousarray(arr)).to(
        torch.device(mesh.device_type))
    return DTensor.from_local(local, mesh, placements, run_check=False)


def gather_to_host(x):
    """A global array as a numpy array on every rank: a ``DTensor`` is
    gathered first; a tensor (a sharded op's full result) is copied to the
    host."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def sync_global_devices(name="sparse_dot_tpu"):
    """Barrier across all processes (no-op single-process).  ``name`` is
    the JAX package's barrier label; a barrier of torch.distributed has
    none."""
    if is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
