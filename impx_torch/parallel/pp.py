"""Pipeline parallelism: a GPipe forward of DGNNS over stage ranks
(impx/parallel/pp.py).

Stage s of S runs the contiguous iterations `convert.stage_layers` (n_layers
/ S of them, self layer then cross layer each) and the batch is cut into M
microbatches. The schedule is GPipe's:

    step t: stage s runs microbatch t - s (when 0 <= t - s < M); M + S - 1 steps

Each microbatch is the stacked [2 Bm, N, D] of impx_torch/models/fast.py
(image 0's Bm pairs, then image 1's). Its carry (desc, the self layers'
(q, k), the cross layers' (q, k)) goes from stage to stage by send/recv, so
a shared layer whose source layer lives on the previous stage still attends
with that layer's q and k: stage boundaries are invisible to the IMP sharing
pattern. impx's bubble steps compute values that are never collected; here a
stage idles in a bubble. The last stage's descriptors are broadcast over the
stage group, and every stage then runs the score head
(`final_matches_from_desc`: kernel 2). Attention runs kernel 1 on each stage.
A stage reads only its own layers' weights (`convert.stage_state_dict` gives
them); the model object may hold the others.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from impx_torch.parallel.mesh import Mesh
from impx_torch.tools.convert import stage_layers

STAGE_AXIS = "stage"


class StageMesh(Mesh):
    """A 1-D mesh over the first n_stages ranks of the world (impx takes the
    first n devices); the other ranks hold no group (`group()` is None)."""

    def __init__(self, n_stages: int, axis_name: str = STAGE_AXIS):
        world = dist.get_world_size()
        if n_stages > world:
            raise ValueError(f"need {n_stages} ranks, have {world}")
        self.axis_names = (axis_name,)
        self.shape = {axis_name: n_stages}
        me = dist.get_rank()
        self.coords = {axis_name: me} if me < n_stages else {}
        group = dist.group.WORLD if n_stages == world else dist.new_group(list(range(n_stages)))
        self._groups = {axis_name: group if me < n_stages else None}


def make_stage_mesh(n_stages: int, axis_name: str = STAGE_AXIS) -> StageMesh:
    """The stage mesh over ranks 0..n_stages-1; every rank must call it."""
    return StageMesh(n_stages, axis_name)


@torch.no_grad()
def pipeline_forward_scan(model, data: dict[str, Any], mesh: Mesh, n_microbatches: int = 2, p: float = 0.2,
                          with_scores: bool = True, axis_name: str = STAGE_AXIS):
    """DGNNS produce_matches(only_last=True) pipelined over the stage ranks of
    `mesh`: the dict of fast.forward_scan, on every stage rank. data: tensors
    on the model's device (the same on every stage). Needs norm_fn='in';
    ValueError when n_layers is not divisible by the stages or the batch by
    n_microbatches."""
    from impx_torch.models.fast import _encode, _swap_half, final_matches_from_desc
    from impx_torch.parallel.collectives import broadcast, recv, send

    cfg = model.config
    assert cfg.norm_fn == "in", "scan fast path supports norm_fn='in' only"
    n_stages = mesh.size(axis_name)
    if cfg.n_layers % n_stages:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by {n_stages} stages")
    b = data["descriptors0"].shape[0]
    m = n_microbatches
    if b % m:
        raise ValueError(f"batch={b} not divisible by {m} microbatches")
    group = mesh.group(axis_name)
    if group is None:
        return None  # this rank is no stage
    s = mesh.index(axis_name)
    bm = b // m

    desc, valid0, valid1, _, n = _encode(model, model._on_device(data))
    mask = torch.cat([valid0, valid1], dim=0)
    mask_swap = torch.cat([valid1, valid0], dim=0)

    def rows(x, mb):  # microbatch mb of a stacked [2B, ...]: image 0's rows, then image 1's
        return torch.cat([x[mb * bm:(mb + 1) * bm], x[b + mb * bm:b + (mb + 1) * bm]], dim=0)

    h_local = model.gnn[0].num_heads
    dh = cfg.descriptor_dim // cfg.num_heads
    qk_like = desc.new_empty((2 * bm, h_local, n, dh))
    kw = dict(ac_fn=cfg.ac_fn, use_kernels=model.use_kernels)
    outputs = [None] * m
    for t in range(m + n_stages - 1):
        mb = t - s
        if not 0 <= mb < m:
            continue  # a bubble
        if s == 0:
            x, qk_self, qk_cross = rows(desc, mb), None, None
        else:
            x = recv(rows(desc, mb), s - 1, group)
            qk_self = (recv(qk_like, s - 1, group), recv(qk_like, s - 1, group))
            qk_cross = (recv(qk_like, s - 1, group), recv(qk_like, s - 1, group))
        mk, mks = rows(mask, mb), rows(mask_swap, mb)
        for i in stage_layers(cfg, s, n_stages):
            delta, qk_self = model.gnn[2 * i](x, x, qk_self, mk, mk, **kw)
            x = x + delta
            delta, qk_cross = model.gnn[2 * i + 1](x, _swap_half(x), qk_cross, mks, mk, **kw)
            x = x + delta
        if s < n_stages - 1:
            for tensor in (x, *qk_self, *qk_cross):
                send(tensor, s + 1, group)
        else:
            outputs[mb] = x

    # the last stage's descriptors, [2B, N, D] (image 0 halves then image 1)
    if s == n_stages - 1:
        final = torch.cat([o[:bm] for o in outputs] + [o[bm:] for o in outputs], dim=0)
    else:
        final = torch.empty_like(desc)
    broadcast(final, n_stages - 1, group)
    return final_matches_from_desc(model, final, b, valid0, valid1, p, with_scores)
