"""Attentional-propagation layers (impx/models/gnn.py, and the per-layer body
of impx/models/fast.py: `_attn_block` :120 and `_tail` :99).

A layer attends from x to a source, merges the heads, and passes
concat([x, message]) through a 2-block MLP with masked InstanceNorm or batch
norm (from running statistics, or from the batch's where the caller asks);
the caller adds the residual. A full layer owns q/k/v/merge. A shared layer (IMP
attention sharing) owns only proj (the value projection) and merge, and
attends with the q/k that the previous layer of its kind projected, which
gives the same probabilities as reusing that layer's softmax.

The layer is differentiable. The attention core is route A's (`mha_fused`,
whose backward is the kernel that recomputes the softmax) or, with
lse_core=True, route B's (`MhaLseFunction`, impx/models/fast.py:
_make_fused_layer). The carried q/k of a shared layer gets gradient from both
layers that use it, and autograd sums the two in the stream dtype, as
impx/models/fast.py:242-249 does by hand.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from impx_torch.ops.attention import merge_heads, project_heads
from impx_torch.ops.kernels.attention import MhaFunction, MhaLseFunction, mha_fused, mha_fused_lse
from impx_torch.ops.mlp import dense_apply, mlp_apply
from impx_torch.tools.profiling import KEYS, count, span


class Dense(nn.Module):
    """A 1x1 Conv1d as a dense map over channels; weight [in, out] as in the
    JAX params."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_in, n_out))
        self.bias = nn.Parameter(torch.empty(n_out))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator, zero_bias: bool = False) -> None:
        """torch Conv1d's default init, U(+-1/sqrt(fan_in))."""
        bound = 1.0 / self.weight.shape[0] ** 0.5
        for p in (self.weight, self.bias):
            p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)
        if zero_bias:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense_apply(self.weight, self.bias, x)


class BatchNorm(nn.Module):
    """Batch norm of one MLP block: bn_scale, bn_bias, bn_mean and bn_var, as
    impx's block leaves (impx/ops/mlp.py:55-62), at their initial values 1,
    0, 0, 1. All four are parameters: impx keeps the running statistics as
    ordinary leaves of its params, so its optimizer moves them by their
    gradient (and weight decay) like any weight, and nothing updates them
    from batch moments. make_train_step moves them alike (ROADMAP section C)."""

    def __init__(self, channels: int):
        super().__init__()
        self.bn_scale = nn.Parameter(torch.ones(channels))
        self.bn_bias = nn.Parameter(torch.zeros(channels))
        self.bn_mean = nn.Parameter(torch.zeros(channels))
        self.bn_var = nn.Parameter(torch.ones(channels))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        for t, value in ((self.bn_scale, 1.0), (self.bn_bias, 0.0), (self.bn_mean, 0.0), (self.bn_var, 1.0)):
            t.fill_(value)

    def stats(self) -> tuple[torch.Tensor, ...]:
        return self.bn_scale, self.bn_bias, self.bn_mean, self.bn_var


class MLP(nn.Module):
    """Dense -> [norm -> activation] per block but the last. norm_fn 'in' is
    the masked InstanceNorm; 'bn' is batch norm, from the running statistics
    or, with batch_stats=True, from the batch's (impx's `train=` of
    mlp_apply, which each call site chooses: nn.Module.training does not)."""

    def __init__(self, channels: Sequence[int], norm_fn: str = "in"):
        super().__init__()
        if norm_fn not in ("in", "bn"):
            raise ValueError(f"unknown norm_fn {norm_fn!r}")
        self.blocks = nn.ModuleList(Dense(a, b) for a, b in zip(channels[:-1], channels[1:]))
        self.norms = (nn.ModuleList(BatchNorm(c) for c in channels[1:-1]) if norm_fn == "bn"
                      else None)
        self.data_group = None
        self.model_group = None
        # sequence parallelism (impx_torch/parallel/mesh.py:set_seq_group):
        # the sequence group, and the union of the data and sequence groups,
        # over which batch statistics are taken
        self.seq_group = None
        self.seq_union = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        for blk in self.blocks:
            blk.reset_parameters(generator)
        self.blocks[-1].bias.data.zero_()  # nn.init.constant_(mlp[-1].bias, 0)
        for norm in self.norms or ():
            norm.reset_parameters()

    def forward(self, x, *, ac_fn: str, mask=None, batch_stats: bool = False, use_kernels: bool = False):
        batch_norms = None if self.norms is None else [norm.stats() for norm in self.norms]
        return mlp_apply([(b.weight, b.bias) for b in self.blocks], x, ac_fn=ac_fn, mask=mask,
                         batch_norms=batch_norms, batch_stats=batch_stats,
                         data_group=self.data_group if self.seq_group is None else self.seq_union,
                         model_group=self.model_group, seq_group=self.seq_group, use_kernels=use_kernels)


class AttentionalPropagation(nn.Module):
    def __init__(self, d_model: int, num_heads: int, shared: bool, norm_fn: str = "in"):
        super().__init__()
        self.num_heads = num_heads
        self.shared = shared
        self.model_group = None
        self.seq_group = None
        if shared:
            self.proj = Dense(d_model, d_model)
            self.merge = Dense(d_model, d_model)
        else:
            self.attn = nn.ModuleDict({n: Dense(d_model, d_model) for n in ("q", "k", "v", "merge")})
        self.mlp = MLP([2 * d_model, 2 * d_model, d_model], norm_fn)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in ((self.proj, self.merge) if self.shared else self.attn.values()):
            m.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def forward(self, x, source, qk, key_mask, query_mask, *, ac_fn: str, use_kernels: bool = True,
                lse_core: bool = False, attn_dtype: torch.dtype | None = None, with_lse: bool = False,
                batch_stats: bool = False):
        """x, source [B, N, D] in the stream dtype; `qk` the (q, k) carried from
        the previous layer of this kind (used only by shared layers). Returns
        (delta, (q, k)) with q/k [B, H, N, dh]. use_kernels=False runs the
        plain versions of the kernels; lse_core picks route B's attention.
        attn_dtype: GM's contract (impx/ops/attention.py:114-120), q/k/v
        projected in the stream dtype and cast to it for the attention core;
        the fast path's stream is already in the compute dtype. with_lse
        (inference, kernel path): the attention is kernel 4, and the return
        is (delta, (q, k), lse) with each query row's log-sum-exp [B, H, N]
        fp32, from which EIMP's key masses take one pass. batch_stats: batch
        norm from the moments of query_mask's tokens (norm_fn='bn')."""
        with span("impx.layer"):
            h = self.num_heads
            xq = x
            if self.model_group is not None:  # Megatron's f before the column-parallel projections
                from impx_torch.parallel.collectives import copy_to_group

                xq = copy_to_group(x, self.model_group)
                source = xq if source is x else copy_to_group(source, self.model_group)
            if self.shared:
                q, k = qk
                v = project_heads(self.proj.weight, self.proj.bias, source, h)
                merge = self.merge
            else:
                a = self.attn
                q = project_heads(a["q"].weight, a["q"].bias, xq, h)
                k = project_heads(a["k"].weight, a["k"].bias, source, h)
                v = project_heads(a["v"].weight, a["v"].bias, source, h)
                merge = a["merge"]
            if self.seq_group is not None:
                from impx_torch.parallel.collectives import all_gather

                if self.shared:
                    v = all_gather(v, self.seq_group, axis=2)
                else:
                    k, v = all_gather(torch.stack([k, v]), self.seq_group, axis=3).unbind(0)
            if attn_dtype is not None:
                q, k, v = q.to(attn_dtype), k.to(attn_dtype), v.to(attn_dtype)
            with span("impx.attn"):
                count(KEYS, key_mask, q.shape[0] * q.shape[1] * q.shape[2], k.shape[2])
                if with_lse:
                    out, lse = mha_fused_lse(q, k, v, key_mask)
                elif use_kernels and not lse_core:
                    out = mha_fused(q, k, v, key_mask)
                else:  # the plain versions keep the kernels' residuals: q, k, v (and o, lse)
                    out = (MhaLseFunction if lse_core else MhaFunction).apply(q, k, v, key_mask, not use_kernels)
            delta = self.tail(x, out, merge, query_mask, ac_fn, batch_stats, use_kernels)
            return (delta, (q, k), lse) if with_lse else (delta, (q, k))

    def tail(self, x, out, merge: Dense, query_mask, ac_fn: str, batch_stats: bool = False,
             use_kernels: bool = False):
        """Head merge, then the concat-MLP (its norm in fp32; the fused kernel
        under use_kernels where autograd is off), all in x's dtype
        (impx/models/fast.py:_tail)."""
        if self.model_group is None:
            message = merge_heads(merge.weight, merge.bias, out.to(x.dtype))
        else:  # row-parallel merge of this rank's heads, then Megatron's g
            from impx_torch.parallel.collectives import reduce_from_group

            partial = merge_heads(merge.weight, torch.zeros_like(merge.bias), out.to(x.dtype))
            message = reduce_from_group(partial, self.model_group) + merge.bias.to(x.dtype)
        return self.mlp(torch.cat([x, message], dim=-1), ac_fn=ac_fn, mask=query_mask,
                        batch_stats=batch_stats, use_kernels=use_kernels)
