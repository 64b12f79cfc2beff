"""Parallelism over torch.distributed (impx/parallel): process groups and
meshes (`mesh`), collectives (`collectives`), tensor parallelism (`tp`) and
the GPipe forward (`pp`). Each rank is one process on one card; NCCL is the
backend on cards, gloo on the CPU."""
from impx_torch.parallel.mesh import Mesh, init_distributed, make_mesh, replicate, shard_batch

__all__ = ["Mesh", "init_distributed", "make_mesh", "replicate", "shard_batch"]
