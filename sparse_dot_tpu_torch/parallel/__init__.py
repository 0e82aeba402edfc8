"""The sharded (multi-device) layer: port of ``sparse_dot_tpu/parallel``.

SPMD over ``torch.distributed``, one process per device (NCCL on the
cards, gloo on the CPU): ``mesh`` builds a ``DeviceMesh``, ``multihost``
starts and leaves the process group and places and gathers arrays, and
``ops`` holds ``ShardedCSR``, its constructors and the sharded products
and solvers, whose per-rank work runs on the port's kernels (K2, K3, K6)
and meets in the collectives of ``comm``.
"""

from .mesh import make_mesh, device_mesh_info
from .multihost import (
    initialize,
    is_initialized,
    shutdown,
    process_info,
    put_sharded,
    gather_to_host,
    sync_global_devices,
)
from .ops import (
    ShardedCSR,
    shard_csr_rows,
    shard_csr_cols,
    shard_csr_grid,
    shard_csr_krows,
    sharded_spmm,
    sharded_spmv,
    sharded_spmv_halo,
    sharded_gram,
    sharded_cg,
    sharded_spmm_2d,
    sharded_spmm_ring,
    sharded_spgemm,
    sharded_cgls,
)

__all__ = [
    "make_mesh",
    "device_mesh_info",
    "initialize",
    "is_initialized",
    "shutdown",
    "process_info",
    "put_sharded",
    "gather_to_host",
    "sync_global_devices",
    "ShardedCSR",
    "shard_csr_rows",
    "shard_csr_cols",
    "shard_csr_grid",
    "shard_csr_krows",
    "sharded_spmm",
    "sharded_spmv",
    "sharded_spmv_halo",
    "sharded_gram",
    "sharded_cg",
    "sharded_spmm_2d",
    "sharded_spmm_ring",
    "sharded_spgemm",
    "sharded_cgls",
]
