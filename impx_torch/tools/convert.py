"""Weights into the port's matchers (DGNNS, AdaGMN, SuperGlue), from two
layouts.

`params_from_jax` takes impx's params pytree with numpy leaves (for example
`jax.tree.map(np.asarray, params)`), SuperGlue's included (sharing=False);
`load_reference_state_dict` takes the reference PyTorch module layout that
the published imp_spp.pth uses (`load_matcher_checkpoint` reads it from a
.pth file), and `load_superglue_state_dict` SuperGlue's
(magicleap/SuperGluePretrainedNetwork, as impx/models/superglue.py:
convert_superglue_matcher reads it). All return a state_dict of the port's
layout, for `load_state_dict`:
  kenc.blocks.{i}.{weight,bias}                      weight [in, out]
  kenc.norms.{i}.{bn_scale,bn_bias,bn_mean,bn_var}   norm_fn='bn' only
  gnn.{i}.attn.{q,k,v,merge}.{weight,bias}           full layers
  gnn.{i}.{proj,merge}.{weight,bias}                 shared layers
  gnn.{i}.mlp.blocks.{0,1}.{weight,bias}, gnn.{i}.mlp.norms.0.*
  final_proj.{i}.{weight,bias}                       SuperGlue: final_proj.0
  bin_score

SuperPoint (impx/tools/convert_torch.py:181-190): `superpoint_params_from_jax`
takes impx's SuperPoint pytree (HWIO kernels), `load_superpoint_state_dict`
the reference superpoint_v1.pth layout, which is the port's own
(`conv1a.weight` OIHW, `conv1a.bias`, ... `convDb`), and
`load_superpoint_checkpoint` reads that from a file.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from impx_torch.models.config import MatcherConfig

_ATTN = ("q", "k", "v", "merge")
_BN = ("bn_scale", "bn_bias", "bn_mean", "bn_var")
# the reference BatchNorm1d's names of the same leaves
_BN_REFERENCE = ("weight", "bias", "running_mean", "running_var")


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _check_layers(n: int, config: MatcherConfig, sharing: bool) -> list[bool]:
    share = config.sharing_layers(sharing)
    if n != len(share):
        raise ValueError(f"{n} gnn layers, config wants {len(share)}")
    return share


def params_from_jax(tree: Mapping, config: MatcherConfig, sharing: bool = True) -> dict:
    """impx params pytree (numpy leaves) -> the port's state_dict."""
    sd: dict[str, torch.Tensor] = {}

    def dense(prefix, blk):
        sd[f"{prefix}.weight"] = _t(blk["w"])
        sd[f"{prefix}.bias"] = _t(blk["b"])

    def mlp(prefix, blocks):
        for i, blk in enumerate(blocks):
            dense(f"{prefix}.blocks.{i}", blk)
            if "bn_scale" in blk:
                for leaf in _BN:
                    sd[f"{prefix}.norms.{i}.{leaf}"] = _t(blk[leaf])

    mlp("kenc", tree["kenc"])
    share = _check_layers(len(tree["gnn"]), config, sharing)
    for i, layer in enumerate(tree["gnn"]):
        if share[i] != ("proj" in layer):
            raise ValueError(f"gnn layer {i}: sharing does not match the config")
        if share[i]:
            dense(f"gnn.{i}.proj", layer["proj"])
            dense(f"gnn.{i}.merge", layer["merge"])
        else:
            for name in _ATTN:
                dense(f"gnn.{i}.attn.{name}", layer["attn"][name])
        mlp(f"gnn.{i}.mlp", layer["mlp"])
    for i, blk in enumerate(tree["final_proj"]):
        dense(f"final_proj.{i}", blk)
    sd["bin_score"] = _t(tree["bin_score"]).reshape(())
    return sd


def load_reference_state_dict(state: Mapping, config: MatcherConfig, sharing: bool = True) -> dict:
    """Reference layout (Conv1d weights [out, in, 1]; MLP Sequentials of
    conv, norm, activation, so convs at indices 0, 3, 6, ... and, for
    norm_fn='bn', the BatchNorm1d one index after its conv) -> the port's
    state_dict. A checkpoint file's {'model': state} wrapper is unwrapped."""
    return _from_reference(state, config, sharing,
                           [f"final_proj.{i}" for i in range(config.n_layers)])


def load_superglue_state_dict(state: Mapping, config: MatcherConfig) -> dict:
    """The reference SuperGlue layout (one Conv1d `final_proj`, batch norm in
    the MLPs; impx/models/superglue.py:57-78) -> the port's SuperGlue
    state_dict. config.norm_fn must be 'bn'."""
    if config.norm_fn != "bn":
        raise ValueError("SuperGlue's MLPs use batch norm: config.norm_fn must be 'bn'")
    return _from_reference(state, config, False, ["final_proj"])


def _from_reference(state: Mapping, config: MatcherConfig, sharing: bool, final_proj: list) -> dict:
    if "model" in state:
        state = state["model"]
    sd: dict[str, torch.Tensor] = {}

    def conv(dst, src):
        w = _t(state[f"{src}.weight"])
        sd[f"{dst}.weight"] = w[:, :, 0].T.contiguous()
        sd[f"{dst}.bias"] = _t(state[f"{src}.bias"])

    def mlp(dst, src, n_convs):
        for i in range(n_convs):
            conv(f"{dst}.blocks.{i}", f"{src}.{3 * i}")  # conv, norm, activation
            if config.norm_fn == "bn" and i < n_convs - 1:
                for leaf, ref in zip(_BN, _BN_REFERENCE):
                    sd[f"{dst}.norms.{i}.{leaf}"] = _t(state[f"{src}.{3 * i + 1}.{ref}"])

    mlp("kenc", "kenc.encoder", len(config.keypoint_encoder) + 1)
    share = _check_layers(2 * config.n_layers, config, sharing)
    for i in range(2 * config.n_layers):
        src = f"gnn.layers.{i}"
        mlp(f"gnn.{i}.mlp", f"{src}.mlp", 2)
        if share[i]:
            conv(f"gnn.{i}.proj", f"{src}.proj")
            conv(f"gnn.{i}.merge", f"{src}.merge")
        else:
            for j, name in enumerate(_ATTN[:3]):
                conv(f"gnn.{i}.attn.{name}", f"{src}.attn.proj.{j}")
            conv(f"gnn.{i}.attn.merge", f"{src}.attn.merge")
    for i, src in enumerate(final_proj):
        conv(f"final_proj.{i}", src)
    sd["bin_score"] = _t(state["bin_score"]).reshape(())
    return sd


def load_matcher_checkpoint(path: str, config: MatcherConfig, sharing: bool) -> dict:
    """A reference .pth checkpoint ({'model': state_dict, ...} or a bare
    state_dict) -> the port's state_dict, for `load_state_dict`
    (impx/tools/convert_torch.py:load_matcher_checkpoint). Read with
    weights_only=True: tensors, numbers and containers, no arbitrary objects."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt["model"] if "model" in ckpt else ckpt
    return load_reference_state_dict(state, config, sharing)


SUPERPOINT_CONVS = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a", "conv4b",
                    "convPa", "convPb", "convDa", "convDb")


def superpoint_params_from_jax(tree: Mapping) -> dict:
    """impx's SuperPoint pytree ({name: {'w': HWIO, 'b'}}, numpy leaves) ->
    the port's state_dict (OIHW)."""
    sd: dict[str, torch.Tensor] = {}
    for name in SUPERPOINT_CONVS:
        sd[f"{name}.weight"] = _t(tree[name]["w"]).permute(3, 2, 0, 1).contiguous()
        sd[f"{name}.bias"] = _t(tree[name]["b"])
    return sd


def load_superpoint_state_dict(state: Mapping) -> dict:
    """The reference superpoint_v1.pth layout -> the port's state_dict (the
    same names and OIHW shapes, as float32; other entries are ignored)."""
    missing = [f"{n}.{leaf}" for n in SUPERPOINT_CONVS for leaf in ("weight", "bias")
               if f"{n}.{leaf}" not in state]
    if missing:
        raise KeyError(f"not a SuperPoint state_dict: missing {missing}")
    return {f"{n}.{leaf}": _t(state[f"{n}.{leaf}"]) for n in SUPERPOINT_CONVS for leaf in ("weight", "bias")}


def load_superpoint_checkpoint(path: str) -> dict:
    """superpoint_v1.pth -> the port's state_dict, read with weights_only=True
    as `load_matcher_checkpoint` reads a matcher's."""
    return load_superpoint_state_dict(torch.load(path, map_location="cpu", weights_only=True))


# ------------------------------------------------ slices for parallel ranks
def param_spec(key: str, config: MatcherConfig) -> tuple[int, str] | None:
    """Which slice of the port's state_dict entry `key` a tensor-parallel
    rank holds: (axis, 'heads') for the channels of its attention heads
    (head-minor, channel c = d * H + h: the channels {d * H + h : h in its
    heads}), (axis, 'blocks') for a contiguous block of channels, or None
    for a replicated entry (impx/parallel/tp.py:matcher_param_specs, with q,
    k, v, proj and merge sharded by heads where impx shards contiguous
    channels). The MLP chains alternate column and row blocks
    (impx_torch/ops/mlp.py:chain_roles); a norm is sharded with the channels
    of the column block before it."""
    from impx_torch.ops.mlp import chain_roles

    parts = key.split(".")
    leaf = parts[-1]

    def chain(kind, i, n):
        role = chain_roles(n)[i]
        if kind == "norms":
            return (0, "blocks") if role == "col" else None
        if role == "col":
            return (1, "blocks") if leaf == "weight" else (0, "blocks")
        if role == "row" and leaf == "weight":
            return (0, "blocks")
        return None

    if parts[0] == "kenc":
        return chain(parts[1], int(parts[2]), len(config.keypoint_encoder) + 1)
    if parts[0] != "gnn":
        return None  # final_proj, bin_score
    name = parts[3] if parts[2] == "attn" else parts[2]
    if name in ("q", "k", "v", "proj"):
        return (1, "heads") if leaf == "weight" else (0, "heads")
    if name == "merge":
        return (0, "heads") if leaf == "weight" else None
    if name == "mlp":
        return chain(parts[3], int(parts[4]), 2)
    raise KeyError(f"no tensor-parallel spec for {key!r}")


def shard_indices(spec: tuple[int, str], size: int, rank: int, n_ranks: int, num_heads: int) -> torch.Tensor:
    """The channel indices of `rank`'s slice of an axis of `size` channels."""
    _, kind = spec
    if kind == "heads":
        per = num_heads // n_ranks
        heads = torch.arange(rank * per, (rank + 1) * per)
        return (torch.arange(size // num_heads)[:, None] * num_heads + heads[None, :]).reshape(-1)
    per = size // n_ranks
    return torch.arange(rank * per, (rank + 1) * per)


def tp_shard_state_dict(sd: Mapping, config: MatcherConfig, rank: int, n_ranks: int) -> dict:
    """The slice of a port-layout state_dict (or of any dict keyed alike, an
    optimizer moment's) that tensor-parallel model rank `rank` of n_ranks
    holds."""
    out = {}
    for key, x in sd.items():
        spec = param_spec(key, config)
        if spec is None:
            out[key] = x
        else:
            idx = shard_indices(spec, x.shape[spec[0]], rank, n_ranks, config.num_heads).to(x.device)
            out[key] = x.index_select(spec[0], idx).contiguous()
    return out


def tp_gather_state_dict(shards: list, config: MatcherConfig) -> dict:
    """The full single-device layout from every model rank's slice, in rank
    order (the inverse of `tp_shard_state_dict`)."""
    n = len(shards)
    out = {}
    for key, x in shards[0].items():
        spec = param_spec(key, config)
        if spec is None:
            out[key] = x
            continue
        axis = spec[0]
        shape = list(x.shape)
        shape[axis] *= n
        full = x.new_empty(shape)
        for r, part in enumerate(shards):
            full.index_copy_(axis, shard_indices(spec, shape[axis], r, n, config.num_heads).to(x.device),
                             part[key])
        out[key] = full
    return out


def stage_layers(config: MatcherConfig, stage: int, n_stages: int) -> range:
    """The iterations (self layer 2i, cross layer 2i + 1) of pipeline stage
    `stage`: a contiguous n_layers / n_stages of them."""
    per = config.n_layers // n_stages
    return range(stage * per, (stage + 1) * per)


def stage_state_dict(sd: Mapping, config: MatcherConfig, stage: int, n_stages: int) -> dict:
    """The entries a pipeline stage reads: the keypoint encoder, the final
    projections and bin_score (every stage encodes and scores), and its own
    layers' weights."""
    its = stage_layers(config, stage, n_stages)
    return {k: v for k, v in sd.items()
            if not k.startswith("gnn.") or int(k.split(".")[1]) // 2 in its}
