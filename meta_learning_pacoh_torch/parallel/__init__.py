"""Scale-out of the port: seed-parallel fits (counterpart of
meta_learning_pacoh_tpu/parallel/). The JAX package's device meshes and
distributed Cholesky are not ported."""

from meta_learning_pacoh_torch.parallel.seed_parallel import fit_models_parallel

__all__ = ["fit_models_parallel"]
