"""Pointwise MLP (the reference's Conv1d(k=1) stacks) in [B, N, C] layout
(impx/ops/mlp.py).

Weights are [in, out], as in the JAX params. Matmul and bias add run in the
activation's dtype, as two ops: under bf16 the product is rounded before the
bias is added, as in impx/models/fast.py:87-88.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from impx_torch.ops import norms


def dense_apply(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w.to(x.dtype)) + b.to(x.dtype)


def activation(x: torch.Tensor, ac_fn: str) -> torch.Tensor:
    if ac_fn == "relu":
        return F.relu(x)
    if ac_fn == "gelu":
        return F.gelu(x)  # erf-exact, as nn.GELU and jax.nn.gelu(approximate=False)
    if ac_fn == "lrelu":
        return F.leaky_relu(x, negative_slope=0.1)
    raise ValueError(f"unknown ac_fn {ac_fn!r}")


def mlp_apply(
    blocks: Sequence[tuple[torch.Tensor, torch.Tensor]],
    x: torch.Tensor,
    *,
    ac_fn: str = "relu",
    mask: torch.Tensor | None = None,
    batch_norms: Sequence[tuple[torch.Tensor, ...]] | None = None,
    batch_stats: bool = False,
) -> torch.Tensor:
    """Dense -> [norm -> activation] for every block but the last
    (impx/ops/mlp.py:71).

    The norm is the masked InstanceNorm, or, given `batch_norms` (scale,
    bias, running mean, running var for each block but the last), batch
    norm: from the running statistics, which ignores the mask (impx's
    train=False), or with batch_stats from the moments of the tokens of
    `mask` over the whole batch (impx's train=True). As in impx, the batch
    moments do not update the running statistics. The norm runs in fp32 and
    casts back to x's dtype (a no-op at fp32; under bf16 it is the contract
    of impx/models/fast.py:109)."""
    n = len(blocks)
    for i, (w, b) in enumerate(blocks):
        x = dense_apply(w, b, x)
        if i < n - 1:
            if batch_norms is None:
                y = norms.instance_norm(x.float(), mask=mask)
            elif batch_stats:
                scale, bias = batch_norms[i][:2]
                y, _, _ = norms.batch_norm_train(x.float(), scale, bias, mask=mask)
            else:
                y = norms.batch_norm_eval(x.float(), *batch_norms[i])
            x = activation(y.to(x.dtype), ac_fn)
    return x
