"""Tensor parallelism over a (data, model) grid of ranks (impx/parallel/tp.py).

impx annotates shardings and lets GSPMD insert the collectives; the port
places them by hand, Megatron's way (impx_torch/parallel/collectives.py:
`copy_to_group` f, `reduce_from_group` g), and each rank holds its slices of
the weights (impx_torch/tools/convert.py:param_spec):

- attention: q, k, v and a shared layer's proj are column-parallel by
  HEADS, not by contiguous channels as in impx. Head-minor channels (c =
  d * H + h) make impx's contiguous shard a d-slice of every head, whose
  q.k^T GSPMD sums across devices; a hand-written attention kernel cannot
  take a partial contraction, so rank r holds the channels {d * H + h : h in
  its H / k heads} and runs the attention kernels unchanged on
  [2B, H / k, N, dh]. merge is row-parallel on the same channels, then g.
  Both layouts equal the single-device result up to summation order. k must
  divide num_heads (SystemExit otherwise), where impx takes any k dividing
  the channels.
- the MLP chains (each layer's, the keypoint encoder) alternate column and
  row blocks, as `_dense_chain_specs` does; InstanceNorm and batch norm are
  per channel, so they need no communication, and batch-norm parameters are
  sharded with their channel.
- EIMP's key mass (kernel 6) sums over heads, so each rank's partial mass is
  summed over the model group before pooling (AdaGMN._key_masses).
- final_proj, bin_score and the norms after a row block stay replicated: the
  score head runs whole on every model rank.

Without a model group every module runs its single-device path.

Sequence parallelism (`shard_batch_sp`, impx/parallel/tp.py:124-150) splits
the keypoint axis instead, over the same second axis of the grid; its
collectives are placed by impx_torch/parallel/mesh.py:set_seq_group's
modules.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from impx_torch.parallel.collectives import all_gather
from impx_torch.parallel.mesh import DATA_AXIS, Mesh, shard_rows
from impx_torch.tools.convert import param_spec, tp_gather_state_dict, tp_shard_state_dict

MODEL_AXIS = "model"


def make_2d_mesh(n_data: int, n_model: int) -> Mesh:
    """A (data, model) grid: rank = data index * n_model + model index, so a
    model group is n_model consecutive ranks (one node's cards under torchrun)."""
    return Mesh({DATA_AXIS: n_data, MODEL_AXIS: n_model})


def matcher_param_specs(model) -> dict:
    """{state_dict key: (axis, 'heads' | 'blocks') or None} of a matcher (GM,
    DGNNS, AdaGMN): which slice of each weight a model rank holds."""
    return {key: param_spec(key, model.config) for key in model.state_dict()}


def _check_divides(model, k: int) -> None:
    cfg = model.config
    if cfg.num_heads % k:
        raise SystemExit(f"--model_parallel {k} does not divide num_heads={cfg.num_heads}: the port shards "
                         "attention by heads")
    sd = model.state_dict()
    for key, spec in matcher_param_specs(model).items():
        if spec is not None and spec[1] == "blocks":
            size = sd[key].shape[spec[0]]
            if size % k:
                raise SystemExit(f"--model_parallel {k} does not divide the {size} channels of {key}")


def shard_params_tp(model, mesh: Mesh, model_axis: str = MODEL_AXIS):
    """Replace the model's full weights by this rank's slices over `mesh`'s
    model axis and hand the model group to the modules that communicate;
    returns the model. Build optimizer state afterwards: its moments take the
    slices' shapes."""
    k, rank = mesh.size(model_axis), mesh.index(model_axis)
    _check_divides(model, k)
    specs = matcher_param_specs(model)
    group = mesh.group(model_axis)
    with torch.no_grad():
        sliced = tp_shard_state_dict(dict(model.named_parameters()), model.config, rank, k)
        for name, p in model.named_parameters():
            p.data = sliced[name].detach().clone()
    from impx_torch.models.gnn import MLP, AttentionalPropagation

    for m in model.modules():
        if isinstance(m, AttentionalPropagation):
            m.num_heads = model.config.num_heads // k
        if isinstance(m, (MLP, AttentionalPropagation)):
            m.model_group = group
    model.model_group = group
    model.tp_sharded = frozenset(n for n, s in specs.items() if s is not None)
    return model


def gather_full(model, tensors: dict) -> dict:
    """The full single-device layout of `tensors` keyed as the model's
    parameters (the parameters themselves, or an optimizer moment), gathered
    from the model group's slices; every model rank must call it. Without a
    model group, the tensors as they are."""
    group = getattr(model, "model_group", None)
    if group is None:
        return dict(tensors)
    n = dist.get_world_size(group)
    shards = [{} for _ in range(n)]
    for key, x in tensors.items():
        spec = param_spec(key, model.config)
        parts = (all_gather(x.detach(), group, axis=0, tiled=False).unbind(0) if spec is not None
                 else [x] * n)
        for r in range(n):
            shards[r][key] = parts[r]
    return tp_gather_state_dict(shards, model.config)



# ------------------------------------------------------------------ sequence parallel

_SEQ_KEYS = ("descriptors0", "descriptors1", "keypoints0", "keypoints1",
             "norm_keypoints0", "norm_keypoints1", "scores0", "scores1")


def shard_batch_sp(mesh: Mesh, batch: dict, data_axis: str = DATA_AXIS, seq_axis: str = MODEL_AXIS) -> dict:
    """Sequence parallelism: this rank's block of batch rows over `data_axis`
    and, for the arrays of _SEQ_KEYS, its contiguous block of keypoints over
    `seq_axis`, as impx's P(data, seq). Every other array (the validity
    masks, matching_mask's N+1 rows, intrinsics, poses) is split over the
    data axis only, so the masks stay whole. Arrays or tensors; other
    leaves pass through. Raises ValueError when the sequence size does not
    divide a keypoint axis. Hand the model the group with
    mesh.set_seq_group(model, mesh.group(seq_axis)).

    impx's docstring (impx/parallel/tp.py:130-133) has the norms "over
    channels" stay keypoint-local; the matcher's InstanceNorm normalises
    over the keypoints of each channel, so the port sums its moments over
    the sequence group (impx_torch/ops/norms.py:instance_norm), as GSPMD's
    reduction does."""
    di, dn = mesh.index(data_axis), mesh.size(data_axis)
    si, sn = mesh.index(seq_axis), mesh.size(seq_axis)
    out = {}
    for key, x in batch.items():
        if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim > 0:
            x = shard_rows(x, di, dn)
            if key in _SEQ_KEYS and x.ndim >= 2:
                if x.shape[1] % sn:
                    raise ValueError(f"{key}: {x.shape[1]} keypoints do not split over a sequence size of {sn}")
                n = x.shape[1] // sn
                x = x[:, si * n:(si + 1) * n]
        out[key] = x
    return out
