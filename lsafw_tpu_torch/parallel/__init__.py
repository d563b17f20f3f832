"""Scale-out on ``torch.distributed``: one process per rank, the DOF axis
distributed by rows.

Counterpart of the reference's ``parallel`` package (the reference's
MPI domain decomposition, done there by GSPMD over a ``jax.sharding``
mesh): RCB partitioning of the cells (``partition``), the process group
(``launch``), and row-distributed operators and solvers with explicit
collectives (``sharded``, ``collectives``).  The solvers of
:mod:`lsafw_tpu_torch.solver` take ``group=`` and run on a rank's rows.
"""

from lsafw_tpu_torch.parallel.launch import global_mesh, initialize_distributed, is_rank0
from lsafw_tpu_torch.parallel.partition import partition_cells
from lsafw_tpu_torch.parallel.sharded import (
    ShardedOperator,
    device_mesh,
    shard_csr,
    shard_vector,
    sharded_eigensolve,
    sharded_si_eigensolve,
    sharded_solve,
)

__all__ = [
    "device_mesh",
    "shard_vector",
    "shard_csr",
    "ShardedOperator",
    "sharded_solve",
    "sharded_eigensolve",
    "sharded_si_eigensolve",
    "partition_cells",
    "initialize_distributed",
    "global_mesh",
    "is_rank0",
]
