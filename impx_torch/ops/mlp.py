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
from impx_torch.ops.kernels.attention import plain_under_autograd
from impx_torch.ops.kernels.norm import norm_act
from impx_torch.tools.profiling import NORMS, count


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


def chain_roles(n: int) -> list[str]:
    """Each block's role in a tensor-parallel chain of n dense blocks
    (impx/parallel/tp.py:_dense_chain_specs): 'col' (column-parallel, output
    channels sharded) at even indices, 'row' (row-parallel, input channels
    sharded, output summed over the model group) at odd ones, and 'rep'
    (replicated) for a last block at an even index."""
    return ["rep" if i % 2 == 0 and i == n - 1 else ("col" if i % 2 == 0 else "row") for i in range(n)]


def mlp_apply(
    blocks: Sequence[tuple[torch.Tensor, torch.Tensor]],
    x: torch.Tensor,
    *,
    ac_fn: str = "relu",
    mask: torch.Tensor | None = None,
    batch_norms: Sequence[tuple[torch.Tensor, ...]] | None = None,
    batch_stats: bool = False,
    data_group=None,
    model_group=None,
    seq_group=None,
    use_kernels: bool = False,
) -> torch.Tensor:
    """Dense -> [norm -> activation] for every block but the last
    (impx/ops/mlp.py:71).

    The norm is the masked InstanceNorm, or, given `batch_norms` (scale,
    bias, running mean, running var for each block but the last), batch
    norm: from the running statistics, which ignores the mask (impx's
    train=False), or with batch_stats from the moments of the tokens of
    `mask` over the whole batch (impx's train=True), over the union of the
    batches of data_group's ranks when one is given (impx's `axis_name`;
    norms.batch_norm_train's global_batch). As in impx, the batch
    moments do not update the running statistics. The norm runs in fp32 and
    casts back to x's dtype (a no-op at fp32; under bf16 it is the contract
    of impx/models/fast.py:109).

    model_group: the blocks hold this rank's shards of a tensor-parallel
    chain (`chain_roles`); x is replicated over the group, a column block's
    output and the norm after it are this rank's channels (per-channel norms
    need no communication), and a row block's partial products are summed
    over the group before its bias.

    seq_group (sequence parallelism): x holds this rank's block of the
    tokens; the InstanceNorm's moments are summed over the group
    (norms.instance_norm). Batch norm from batch statistics then takes
    data_group as the union of the data and sequence groups.

    use_kernels: a block's bias add, InstanceNorm and activation run as one
    op (`impx::norm_act`, ops/kernels/norm.py) where autograd is off for
    the blocks and the norm is the InstanceNorm over this rank's tokens
    alone (no seq_group): on a CUDA tensor it launches the kernel, or raises
    for what the kernel does not take (a width not a multiple of 8, a mask
    other than bool); on the CPU it runs the chain. Batch norm, sequence
    groups and training under grad keep the chain above. Counter NORMS
    records for each norm whether it took the op."""
    n = len(blocks)
    roles = chain_roles(n) if model_group is not None else ["rep"] * n
    if model_group is not None:
        from impx_torch.parallel.collectives import copy_to_group, reduce_from_group
    fused = (use_kernels and batch_norms is None and seq_group is None
             and not plain_under_autograd(x, *(t for block in blocks for t in block)))
    for i, (w, b) in enumerate(blocks):
        if roles[i] == "col":
            x = copy_to_group(x, model_group)
        x = torch.matmul(x, w.to(x.dtype))
        if roles[i] == "row":
            x = reduce_from_group(x, model_group)
        if i == n - 1:
            return x + b.to(x.dtype)
        count(NORMS, fused)
        if fused:
            x = norm_act(x, b.to(x.dtype), mask, ac_fn)
            continue
        x = x + b.to(x.dtype)
        if batch_norms is None:
            y = norms.instance_norm(x.float(), mask=mask, group=seq_group)
        elif batch_stats:
            scale, bias = batch_norms[i][:2]
            y, _, _ = norms.batch_norm_train(x.float(), scale, bias, mask=mask, group=data_group,
                                             global_batch=True)
        else:
            y = norms.batch_norm_eval(x.float(), *batch_norms[i])
        x = activation(y.to(x.dtype), ac_fn)
    return x
