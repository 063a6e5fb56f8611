"""Scale-out of the port (counterpart of meta_learning_pacoh_tpu/parallel/):
device meshes and the task-sharded SVGD step, the distributed Cholesky and
MLL, and seed-parallel fits."""

from meta_learning_pacoh_torch.parallel.dist_chol import (
    distributed_cholesky,
    distributed_gp_mll,
    distributed_gp_mll_batch,
)
from meta_learning_pacoh_torch.parallel.mesh import (
    build_svgd_parallel_step,
    initialize_distributed,
    make_mesh,
    make_seed_mesh,
    shard_task_batch,
)
from meta_learning_pacoh_torch.parallel.seed_parallel import fit_models_parallel

__all__ = [
    "initialize_distributed",
    "make_mesh",
    "shard_task_batch",
    "build_svgd_parallel_step",
    "distributed_cholesky",
    "distributed_gp_mll",
    "distributed_gp_mll_batch",
    "fit_models_parallel",
    "make_seed_mesh",
]
