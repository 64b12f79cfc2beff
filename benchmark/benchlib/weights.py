"""Random matcher weights made from the seed, on the device, in one draw.

The names and [in, out] layouts are those of the matcher's state dict
(keypoint encoder `kenc`, the attentional layers `gnn.<l>`, the per-iteration
`final_proj.<i>`, `bin_score`), so the same tensors load into the program
and into the plain reference. Each dense weight and bias is uniform in
+-1/sqrt(fan_in) (torch's Conv1d default, as the published model is built);
the last block of every MLP has a zero bias; the dustbin score is the
configuration's."""
from __future__ import annotations

import torch

from reference.matcher import sharing_layers


def dense_shapes(matcher: dict) -> list[tuple[str, int, int, bool]]:
    """(name, fan_in, fan_out, zero_bias) of every dense block, in order."""
    d = matcher["descriptor_dim"]
    out = []
    chans = [3, *matcher["keypoint_encoder"], d]
    for i, (a, b) in enumerate(zip(chans[:-1], chans[1:])):
        out.append((f"kenc.blocks.{i}", a, b, i == len(chans) - 2))
    for layer, shared in enumerate(sharing_layers(matcher["n_layers"])):
        names = ("proj", "merge") if shared else ("attn.q", "attn.k", "attn.v", "attn.merge")
        out += [(f"gnn.{layer}.{n}", d, d, False) for n in names]
        out += [(f"gnn.{layer}.mlp.blocks.0", 2 * d, 2 * d, False), (f"gnn.{layer}.mlp.blocks.1", 2 * d, d, True)]
    out += [(f"final_proj.{i}", d, d, False) for i in range(matcher["n_layers"])]
    return out


def make_weights(config: dict, generator: torch.Generator, device) -> dict[str, torch.Tensor]:
    """Every parameter of the configuration's matcher, fp32, drawn on
    `device` from `generator` in one call and cut into the named tensors."""
    shapes = dense_shapes(config["matcher"])
    total = sum(fi * fo + fo for _, fi, fo, _ in shapes)
    flat = torch.rand(total, generator=generator, device=device, dtype=torch.float32).mul_(2).sub_(1)
    weights, at = {}, 0
    for name, fan_in, fan_out, zero_bias in shapes:
        bound = fan_in ** -0.5
        w = flat[at: at + fan_in * fan_out].view(fan_in, fan_out)
        at += fan_in * fan_out
        b = flat[at: at + fan_out]
        at += fan_out
        weights[f"{name}.weight"] = w.mul_(bound)
        weights[f"{name}.bias"] = b.zero_() if zero_bias else b.mul_(bound)
    weights["bin_score"] = torch.tensor(float(config["bin_score"]), device=device)
    return weights
