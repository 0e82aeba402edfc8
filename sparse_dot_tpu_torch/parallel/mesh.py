"""Device mesh construction.

Port of ``sparse_dot_tpu/parallel/mesh.py``: a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the process
group, one device per rank, of ``config.device``'s type.  An axis's size
is ``mesh.size(dim)`` and its process group ``mesh.get_group(name)``.
"""

import numpy as np
import torch
import torch.distributed as dist

from ..config import config
from .multihost import is_initialized, start_local_group


def make_mesh(shape=None, axis_names=("rows", "cols"), devices=None):
    """A mesh over the ranks ``devices`` (global ranks; default every rank
    of the group), shaped ``shape``; None gives ``(len(devices), 1)``, all
    on the first axis.  In a process where no group has been started, a
    one-rank group is started first (``multihost.start_local_group``).
    Every rank of the group calls this, also those left out of
    ``devices``."""
    start_local_group()
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(d) for d in devices])
    n = len(ranks)
    if shape is None:
        shape = (n, 1)
    if int(np.prod(shape)) != n:
        raise ValueError(
            f"Mesh shape {shape} does not match device count {n}"
        )
    from torch.distributed.device_mesh import DeviceMesh

    grid = torch.tensor(ranks, dtype=torch.int64).reshape(shape)
    return DeviceMesh(config.device, grid,
                      mesh_dim_names=tuple(axis_names[: grid.dim()]))


def device_mesh_info():
    return {
        "devices": dist.get_world_size() if is_initialized() else 1,
        "local_devices": 1,
        "platform": config.device,
    }
