"""Normalization in [B, N, C] layout (impx/ops/norms.py).

InstanceNorm1d(eps=1e-3, affine=False) over the token axis, with statistics
over valid tokens only, and BatchNorm1d(eps=1e-3) from running statistics
(eval mode) or from the batch's (train mode, masked). impx's `axis_name`,
which averages the batch moments across a data mesh, is the `group` of
`batch_norm_train`; under sequence parallelism `instance_norm`'s `group`
sums the moments of the tokens that the ranks hold.
"""
from __future__ import annotations

import torch

EPS = 1e-3


def instance_norm(x: torch.Tensor, mask: torch.Tensor | None = None, group=None) -> torch.Tensor:
    """InstanceNorm over N of [B, N, C], per (batch, channel), in x's dtype.

    With `mask` [B, N], mean and variance come from the valid tokens only
    (count clamped at 1), which equals running on the unpadded token set.

    group (sequence parallelism): x holds this rank's block of the tokens,
    and the masked sum and count, then the centred sum of squares, are
    summed over the group before they are divided (two all-reduces, with a
    gradient through them): the single-device moments up to summation
    order."""
    if group is not None:
        from impx_torch.parallel.collectives import psum

        m = torch.ones_like(x[..., :1]) if mask is None else mask[:, :, None].to(x.dtype)
        c = x.shape[-1]
        tot = psum(torch.cat([(x * m).sum(dim=1), m.sum(dim=1)], dim=1), group)   # [B, C + 1]
        count = tot[:, None, c:].clamp_min(1.0)
        mean = tot[:, None, :c] / count
        var = psum((((x - mean) ** 2) * m).sum(dim=1), group)[:, None] / count
    elif mask is None:
        mean = x.mean(dim=1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=1, keepdim=True)
    else:
        m = mask[:, :, None].to(x.dtype)
        count = m.sum(dim=1, keepdim=True).clamp_min(1.0)
        mean = (x * m).sum(dim=1, keepdim=True) / count
        var = (((x - mean) ** 2) * m).sum(dim=1, keepdim=True) / count
    return (x - mean) * torch.rsqrt(var + EPS)


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     mask: torch.Tensor | None = None, group=None, global_batch: bool = False):
    """Batch norm over (B, N) per channel of [B, N, C] from the batch's own
    moments, counting only the tokens of `mask` [B, N] (count clamped at 1);
    returns (y, mean, var) (impx/ops/norms.py:40). The variance is
    E[x^2] - E[x]^2, as impx computes it, not the centred sum.

    group (a process group of data-parallel ranks): impx's `axis_name`, each
    rank's mean and E[x^2] averaged over the group (`pmean`, with a gradient
    through the all-reduce). With global_batch the moments are instead those
    of the union of the ranks' batches: the masked sums and the token counts
    are all-reduced, which differs from the mean of the ranks' moments when
    their counts differ; the data-parallel trainer normalises so, as impx's
    sharded step computes the global batch's moments."""
    if group is not None and global_batch:
        from impx_torch.parallel.collectives import psum

        m = torch.ones_like(x[..., :1]) if mask is None else mask[:, :, None].to(x.dtype)
        c = x.shape[-1]
        tot = psum(torch.cat([(x * m).sum(dim=(0, 1)), (x * x * m).sum(dim=(0, 1)), m.sum().reshape(1)]), group)
        count = tot[-1].clamp_min(1.0)
        mean, sq = tot[:c] / count, tot[c:2 * c] / count
    elif mask is None:
        mean = x.mean(dim=(0, 1))
        sq = (x * x).mean(dim=(0, 1))
    else:
        m = mask[:, :, None].to(x.dtype)
        count = m.sum().clamp_min(1.0)
        mean = (x * m).sum(dim=(0, 1)) / count
        sq = (x * x * m).sum(dim=(0, 1)) / count
    if group is not None and not global_batch:
        from impx_torch.parallel.collectives import pmean

        mean, sq = pmean(torch.stack([mean, sq]), group).unbind(0)
    var = sq - mean * mean
    return (x - mean) * torch.rsqrt(var + EPS) * scale + bias, mean, var


def batch_norm_eval(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    running_mean: torch.Tensor, running_var: torch.Tensor) -> torch.Tensor:
    """Batch norm from running statistics, per channel of [B, N, C]
    (impx/ops/norms.py:68): a per-channel affine map, the same for every
    token and batch entry."""
    return (x - running_mean) * torch.rsqrt(running_var + EPS) * scale + bias
