"""Process groups over torch.distributed (impx/parallel/mesh.py).

impx lays a 1-D `data` mesh over every chip and lets XLA insert the
collectives of its sharded step. The port runs one process a card (one rank),
so a mesh here is a grid of ranks with one process group an axis, and the
code that needs a collective is handed that group explicitly
(impx_torch/parallel/collectives.py). NCCL is the backend on cards, gloo on
the CPU.

  init_distributed()                  the launcher's env:// (torchrun), or a
                                      file:// / tcp:// rendezvous given
  make_mesh()                         a (data,) mesh over the world
  shard_batch(mesh, batch)            this rank's contiguous block of every
                                      array's leading axis (impx's P('data'))
  replicate(mesh, module_or_tensors)  a broadcast from the group's rank 0
"""
from __future__ import annotations

import math
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def init_distributed(init_method: str | None = None, rank: int | None = None, world_size: int | None = None,
                     device: torch.device | str | None = None, backend: str | None = None) -> tuple[int, int]:
    """Join the default process group; returns (rank, world size).

    init_method None is 'env://', the launcher's environment, which must name
    MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE (RuntimeError naming the
    missing ones otherwise: the run never continues as one process). A
    'file://' or 'tcp://' rendezvous takes rank and world_size. The backend
    is NCCL for a CUDA device (which becomes the current one) and gloo
    otherwise. A process already in a group keeps it."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if init_method in (None, "env://"):
        missing = [k for k in LAUNCHER_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(f"distributed run without the launcher's environment: {', '.join(missing)} "
                               "not set (launch with torchrun)")
        init_method = "env://"
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if rank is None or world_size is None:
        raise ValueError(f"init_method {init_method!r} needs rank and world_size")
    device = torch.device(device) if device is not None else None
    if backend is None:
        backend = "nccl" if device is not None and device.type == "cuda" else "gloo"
    if device is not None and device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    return rank, world_size


class Mesh:
    """A row-major grid of the world's ranks, axes named in order, with one
    process group an axis: the ranks that differ from this one in that
    coordinate only. Every rank must build the same meshes in the same order
    (making a group is a collective call). An axis that spans the world uses
    the default group."""

    def __init__(self, shape: dict[str, int]):
        if not dist.is_initialized():
            raise RuntimeError("a Mesh needs torch.distributed: call init_distributed() first")
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        world = dist.get_world_size()
        if math.prod(self.shape.values()) != world:
            raise ValueError(f"mesh {self.shape} does not cover the {world} ranks")
        grid = np.arange(world).reshape(tuple(self.shape.values()))
        me = dist.get_rank()
        self.coords = dict(zip(self.axis_names, (int(c) for c in np.argwhere(grid == me)[0])))
        self._groups: dict[str, Any] = {}
        for i, name in enumerate(self.axis_names):
            if self.shape[name] == world:
                self._groups[name] = dist.group.WORLD
                continue
            lines = np.moveaxis(grid, i, -1).reshape(-1, self.shape[name])
            for line in lines:
                group = dist.new_group([int(r) for r in line])
                if me in line:
                    self._groups[name] = group

    def group(self, axis: str = DATA_AXIS):
        return self._groups[axis]

    def size(self, axis: str = DATA_AXIS) -> int:
        return self.shape[axis]

    def index(self, axis: str = DATA_AXIS) -> int:
        return self.coords[axis]


def make_mesh(axis_name: str = DATA_AXIS) -> Mesh:
    """A 1-D mesh over every rank of the world."""
    return Mesh({axis_name: dist.get_world_size()})


def shard_rows(x, index: int, n: int):
    """Block `index` of n contiguous blocks of x's leading axis."""
    if x.shape[0] % n:
        raise ValueError(f"leading axis {x.shape[0]} does not split into {n} equal blocks")
    rows = x.shape[0] // n
    return x[index * rows:(index + 1) * rows]


def shard_batch(mesh: Mesh, batch, axis_name: str = DATA_AXIS):
    """This rank's contiguous block of the leading axis of every array or
    tensor in `batch` (a dict, list or tuple of them, or one), the block that
    impx's P(axis_name) places on this device. Other leaves pass through."""
    i, n = mesh.index(axis_name), mesh.size(axis_name)

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(one(v) for v in x)
        if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim > 0:
            return shard_rows(x, i, n)
        return x

    return one(batch)


def replicate(mesh: Mesh, module_or_tensors, axis_name: str = DATA_AXIS):
    """Every parameter and buffer of a module (or every tensor of a list or
    dict) set, in place, to the values of the group's rank 0; returns the
    argument."""
    from impx_torch.parallel.collectives import broadcast

    obj = module_or_tensors
    if isinstance(obj, torch.nn.Module):
        tensors = [*obj.parameters(), *obj.buffers()]
    elif isinstance(obj, dict):
        tensors = list(obj.values())
    else:
        tensors = list(obj)
    for t in tensors:
        broadcast(t, 0, mesh.group(axis_name))
    return obj


def set_data_group(model, group):
    """Hand a matcher the data-parallel group (None: one device): its MLPs'
    batch norm then takes the moments of the ranks' union batch, and its
    losses return this rank's share of the global batch's
    (impx_torch/models/loss.py). Build the training step afterwards. Returns
    the model."""
    from impx_torch.models.gnn import MLP

    model.data_group = group
    for m in model.modules():
        if isinstance(m, MLP):
            m.data_group = group
    return model


def set_seq_group(model, group):
    """Hand a matcher (GM, DGNNS, AdaGMN) the sequence-parallel group
    (impx_torch/parallel/tp.py:shard_batch_sp splits the keypoints over it);
    returns the model. Each rank then holds its block of every image's
    keypoints: the masked InstanceNorm sums its moments over the group,
    attention gathers k and v along the keys (its backward the
    reduce-scatter), the final projection gathers both images' rows, and the
    score head runs whole on every rank, whose outputs are full. Batch
    statistics and make_train_step's gradient sum run over the union of the
    data and sequence groups, the world, which a (data, sequence) mesh
    covers. No trainer or CLI reaches it. Raises
    ValueError for a tensor-parallel model (both take the mesh's second
    axis) and for SuperGlue, whose loop the port does not split."""
    from impx_torch.models.gnn import MLP, AttentionalPropagation
    from impx_torch.models.superglue import SuperGlue

    if getattr(model, "model_group", None) is not None:
        raise ValueError("sequence parallelism and tensor parallelism both take the mesh's second axis")
    if isinstance(model, SuperGlue):
        raise ValueError("sequence parallelism runs GM, DGNNS and AdaGMN; SuperGlue's loop is not split")
    union = dist.group.WORLD
    model.seq_group, model.seq_union = group, union
    model.seq_size, model.seq_index = dist.get_world_size(group), dist.get_rank(group)
    for m in model.modules():
        if isinstance(m, (MLP, AttentionalPropagation)):
            m.seq_group = group
        if isinstance(m, MLP):
            m.seq_union = union
    return model
