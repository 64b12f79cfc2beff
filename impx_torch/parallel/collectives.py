"""Collectives over torch.distributed process groups
(impx/parallel/collectives.py).

impx names a mesh axis and runs inside `shard_map`; here every function takes
the process group of that axis (`Mesh.group(axis)`, None for the world) and
runs in each rank's own process. The gradient convention is that of a
data-parallel objective: the objective is the sum of the ranks' objectives,
so `psum`'s backward is the all-reduce of the cotangents and `all_gather`'s
is their reduce-scatter. Megatron's two operators for tensor parallelism,
where every rank of the model group computes the same loss, are
`copy_to_group` (f: identity forward, all-reduce backward) and
`reduce_from_group` (g: all-reduce forward, identity backward). Sequence
parallelism, where every rank of the sequence group runs the score head
whole on the gathered rows, has two more: `gather_for_replicated` (an
all-gather whose backward takes this rank's block of the cotangent without
summing it) and `count_once` (identity forward; the backward keeps the
cotangent on the group's rank 0 only, so a replicated parameter's gradient
is counted once when the ranks' gradients are summed).

Backends. NCCL takes CUDA tensors for every collective. Gloo takes CUDA
tensors for broadcast and all_reduce only, so a gloo group handed CUDA
tensors copies them through the host for the others (all_gather,
reduce_scatter, send/recv): the choice is made by the group's backend name
(`_through_host`), before the call. Nothing catches a failure of one backend
to retry on another.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _through_host(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _global(group, rank: int) -> int:
    """The world rank of the group's rank `rank`."""
    if group is None or group is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


def axis_index(group=None) -> int:
    """This rank's index in the group."""
    return dist.get_rank(group)


def axis_size(group=None) -> int:
    return dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=op, group=group)
    return out


def _all_gather(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """Tiled all-gather along `axis`, in rank order."""
    host = _through_host(x, group)
    src = (x.detach().cpu() if host else x.detach()).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=axis).to(x.device)


def _reduce_scatter(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """Sum over the group, then this rank's block of `axis`."""
    n = dist.get_world_size(group)
    if x.shape[axis] % n:
        raise ValueError(f"reduce_scatter: axis {axis} of size {x.shape[axis]} does not split over {n} ranks")
    host = _through_host(x, group)
    src = x.detach().cpu() if host else x.detach()
    chunks = [c.contiguous() for c in torch.chunk(src, n, dim=axis)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out.to(x.device)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return _all_gather(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.axis), None, None


class _GatherForReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis, ctx.n = group, axis, x.shape[axis]
        return _all_gather(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        i = dist.get_rank(ctx.group)
        return g.narrow(ctx.axis, i * ctx.n, ctx.n).contiguous(), None, None


class _CountOnce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.keep = dist.get_rank(group) == 0
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return _reduce_scatter(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.axis), None, None


class _CopyToGroup(torch.autograd.Function):
    """Megatron's f."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's g."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce sum; differentiable (the backward all-reduces the cotangents)."""
    return _AllReduceSum.apply(x, group) if _needs_grad(x) else _all_reduce(x, group)


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce mean, the reference's `reduce_tensor`."""
    return psum(x, group) / dist.get_world_size(group)


def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce max (no gradient)."""
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, group=None, axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """Every rank's x along `axis` (tiled), or stacked on a new leading axis
    (tiled=False). The backward is the reduce-scatter of the cotangent."""
    if not tiled:
        x, axis = x.unsqueeze(0), 0
    return _AllGather.apply(x, group, axis) if _needs_grad(x) else _all_gather(x, group, axis)


def gather_for_replicated(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """Tiled all-gather along `axis` for a consumer that every rank of the
    group computes whole (the score head under sequence parallelism): each
    rank already holds the full cotangent, so the backward takes this rank's
    block of it and sums nothing."""
    return _GatherForReplicated.apply(x, group, axis) if _needs_grad(x) else _all_gather(x, group, axis)


def count_once(x: torch.Tensor, group) -> torch.Tensor:
    """x as it is; its gradient kept on the group's rank 0 and zero on the
    others, for a parameter that every rank of the group uses on the same
    replicated values."""
    return _CountOnce.apply(x, group) if _needs_grad(x) else x


def reduce_scatter(x: torch.Tensor, group=None, axis: int = 0) -> torch.Tensor:
    """Sum over the group, then this rank's contiguous block of `axis` (ZeRO's
    building block). The backward is the all-gather of the cotangent."""
    return _ReduceScatter.apply(x, group, axis) if _needs_grad(x) else _reduce_scatter(x, group, axis)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f, before a column-parallel layer: identity forward,
    all-reduce backward."""
    return _CopyToGroup.apply(x, group) if _needs_grad(x) else x


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g, after a row-parallel layer: all-reduce forward, identity
    backward."""
    return _ReduceFromGroup.apply(x, group) if _needs_grad(x) else _all_reduce(x, group)


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """x of the group's rank `src`, in place on every rank (no gradient)."""
    dist.broadcast(x.data, src=_global(group, src), group=group)
    return x


def send(x: torch.Tensor, dst: int, group=None) -> None:
    """Blocking send to the group's rank `dst`."""
    peer = _global(group, dst)
    dist.send((x.detach().cpu() if _through_host(x, group) else x.detach()).contiguous(), peer, group=group)


def recv(like: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """A tensor shaped and typed as `like`, from the group's rank `src`."""
    peer = _global(group, src)
    buf = torch.empty(like.shape, dtype=like.dtype, device="cpu" if _through_host(like, group) else like.device)
    dist.recv(buf, peer, group=group)
    return buf.to(like.device)


def ppermute(x: torch.Tensor, perm, group=None) -> torch.Tensor:
    """Point-to-point exchange: perm lists (source, destination) pairs of
    group ranks; a rank that is no destination receives zeros, as in impx."""
    me = dist.get_rank(group)
    host = _through_host(x, group)
    src = (x.detach().cpu() if host else x.detach()).contiguous()
    out = torch.zeros_like(src)
    reqs = [dist.isend(src, _global(group, d), group=group) for s, d in perm if s == me and d != me]
    reqs += [dist.irecv(out, _global(group, s), group=group) for s, d in perm if d == me and s != me]
    for s, d in perm:
        if s == d == me:
            out.copy_(src)
    for r in reqs:
        r.wait()
    return out.to(x.device)


def ring_shift(x: torch.Tensor, group=None, shift: int = 1) -> torch.Tensor:
    """Each rank's x to rank (i + shift) mod n."""
    n = dist.get_world_size(group)
    return ppermute(x, [(i, (i + shift) % n) for i in range(n)], group)


def under(mesh, fn, *args, axis_name: str = "data"):
    """fn on this rank's shard of every argument (the leading axis split in
    contiguous blocks over `axis_name`, as impx's P(axis_name)); returns what
    fn returns on this rank."""
    from impx_torch.parallel.mesh import shard_batch

    return fn(*shard_batch(mesh, list(args), axis_name))
