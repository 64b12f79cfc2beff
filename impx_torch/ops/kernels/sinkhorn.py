"""The Sinkhorn head with match statistics: the CUDA kernel's wrapper and
its plain PyTorch version.

Replaces the TPU kernel impx/ops/pallas/sinkhorn.py:sinkhorn_fused_stats
(:206, kernel `_sinkhorn_kernel` :62), which holds the whole dustbin-padded
plan of one pair on chip. At N = M = 2048 that plan is about 8.4 MB in bf16,
beyond one SM; impx_torch/csrc/sinkhorn.cu spreads it over every SM in one
persistent, cooperative launch (csrc/persistent.cuh): each CTA builds a
fixed block of the plan's rows [B, N+1, M+1] once (the row softmax of the
masked, dustbin-padded scores, dustbin row included) and keeps as many as
fit in its shared memory for every iteration, the rest in an overflow buffer
in device memory (`schedule` reports the split). Per iteration one pass over
a CTA's rows gives u and the CTA's column partials; two grid barriers
around a fixed-order column reduce give v (no atomics, deterministic). The
statistics (max0, idx0, rowmass; idx1, colmass) of the final plan's
interior come from the same launch. The marginals are computed in the
kernel from the bool validity masks, so a call issues one device launch.
What bounds it on the H100: reading dist once (4 bytes a cell) and the fp32
multiply-adds of the iterations, both about 20 us at B = 4, N = M = 2048.

Numerics, as the TPU kernel: invalid rows/columns are masked to -1e30 before
the softmax (in the kernel, where the TPU wrapper did it in XLA: identical
values); marginals valid0/valid1 with dustbin marginals n0+1 / n1+1; EPS
1e-8; the plan is fp32 when round_up(N+1,16) * round_up(M+1,128) * 4 <= 6 MiB
and bf16 otherwise (a rule from the TPU's VMEM, kept because the numbers
depend on it); u and v are rounded to the plan dtype before each product,
sums are fp32; the statistics use the unrounded u and v; max0 has a -1 fill
and the masses a 0 fill at invalid cells; argmax takes the first index on
ties, by row and by column.

Kernel 2 is the `torch.library` op `impx::sinkhorn_stats` (CUDA: the
launch; CPU: the plain version; a fake implementation for the output
shapes), so that an exported graph (impx_torch/tools/export.py) holds it.
"""
from __future__ import annotations

import ctypes

import torch

from impx_torch.ops.kernels import _build, _ops
from impx_torch.ops.kernels.attention import plain_under_autograd
from impx_torch.ops.sinkhorn import NEG, _uv_iterate, marginals, masked_scores


def _round_up(x: int, k: int) -> int:
    return -(-x // k) * k


def plan_dtype(n: int, m: int) -> torch.dtype:
    """Storage dtype of the [N+1, M+1] plan (impx/ops/pallas/sinkhorn.py:231-236)."""
    fits = _round_up(n + 1, 16) * _round_up(m + 1, 128) * 4 <= 6 * 1024 * 1024
    return torch.float32 if fits else torch.bfloat16


def _flags(dist, valid0, valid1):
    b, n, m = dist.shape
    f0 = (torch.ones((b, n), device=dist.device) if valid0 is None
          else valid0.to(device=dist.device, dtype=torch.float32))
    f1 = (torch.ones((b, m), device=dist.device) if valid1 is None
          else valid1.to(device=dist.device, dtype=torch.float32))
    return f0, f1


def sinkhorn_stats_reference(dist, dustbin, iterations: int, valid0=None, valid1=None):
    """Plain version of `sinkhorn_fused_stats`, the kernel's arithmetic step
    for step. Invalid rows softmax onto the dustbin column (their u is 0, so
    they carry no mass, as in sink_algorithm)."""
    b, n, m = dist.shape
    f0, f1 = _flags(dist, valid0, valid1)
    r, c = marginals(f0, f1)
    ok = (f0[:, :, None] > 0) & (f1[:, None, :] > 0)
    scores = torch.where(ok, dist.float(), NEG)
    bin_ = torch.as_tensor(dustbin, dtype=torch.float32, device=dist.device)
    p = torch.softmax(torch.cat([scores, bin_.expand(b, n, 1)], dim=2), dim=2)
    inv = 1.0 / c[:, m:]                                          # 1 / (n1 + 1)
    dust = torch.cat([torch.where(f1 > 0, inv, 0.0), inv], dim=1)
    p = torch.cat([p, dust[:, None, :]], dim=1)
    pd = plan_dtype(n, m)
    u, v = _uv_iterate(p, r, c, iterations, pd)

    val = p.to(pd).float()[:, :n, :m] * u[:, :n, None] * v[:, None, :m]
    filled = torch.where(ok, val, -1.0)
    masked = torch.where(ok, val, 0.0)
    return {
        "u": u, "v": v,
        "max0": filled.amax(dim=2),
        "idx0": filled.argmax(dim=2).to(torch.int32),   # first index on ties
        "idx1": filled.argmax(dim=1).to(torch.int32),
        "rowmass": masked.sum(dim=2),
        "colmass": masked.sum(dim=1),
    }


SCHEDULE_KEYS = ("ctas", "slots", "rows_on_chip", "overflow_rows", "stride", "smem_bytes",
                 "cap", "ctas_a_pair")
_barriers: dict[tuple[int, int], torch.Tensor] = {}


def barrier_words(device: torch.device, stream: int) -> torch.Tensor:
    """The two grid-barrier words of the persistent kernels on (device,
    stream): zeroed once, and left at zero by every launch, so that a call
    issues no memset. Launches on one stream run in order; each stream has
    its own words."""
    key = (device.index if device.index is not None else -1, stream)
    words = _barriers.get(key)
    if words is None:
        words = _barriers[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return words


def kernel_mask(t, b: int, size: int, device, name: str):
    """A validity mask as the persistent kernels read it: a contiguous bool
    [B, size] tensor (handed over as it is when it already is one), or None
    for all valid."""
    if t is None:
        return None
    if t.shape != (b, size) or t.device != device:
        raise ValueError(f"{name}: want [{b}, {size}] on {device}")
    return t if t.dtype == torch.bool and t.is_contiguous() else (t > 0).contiguous()


def query_schedule(fn, what: str, b: int, n: int, m: int, dtype: torch.dtype) -> dict:
    """The persistent kernel's schedule on the current card: CTAs, column
    slots, rows kept on chip, overflow rows and bytes, row stride, shared
    memory a CTA (csrc/persistent.cuh:schedule_query). Raises when the card
    cannot hold the cooperative grid."""
    out = (ctypes.c_int * len(SCHEDULE_KEYS))()
    _build.check(fn(b, n, m, int(dtype == torch.bfloat16), out), what)
    sched = dict(zip(SCHEDULE_KEYS, out))
    sched["overflow_bytes"] = sched["overflow_rows"] * sched["stride"] * dtype.itemsize
    return sched


def schedule(b: int, n: int, m: int, device=None) -> dict:
    """Kernel 2's schedule for dist [b, n, m] on `device` (the current card
    when None)."""
    with torch.cuda.device(device):
        return query_schedule(_build.load("sinkhorn").impx_sinkhorn_schedule,
                              "impx_sinkhorn_schedule", b, n, m, plan_dtype(n, m))


STATS_KEYS = ("u", "v", "max0", "idx0", "idx1", "rowmass", "colmass")


def sinkhorn_fused_stats(dist, dustbin, iterations: int, valid0=None, valid1=None):
    """Sinkhorn head without returning the plan, through the op
    `impx::sinkhorn_stats`. dist [B, N, M] fp32, dustbin a scalar,
    valid0/valid1 bool [B, N]/[B, M] (others are read as > 0). Returns u
    [B, N+1], v [B, M+1] (plan = softmax_pad * u v^T), max0/idx0/rowmass
    [B, N] and idx1/colmass [B, M]. CPU tensors run
    `sinkhorn_stats_reference`; CUDA tensors launch the kernel or raise."""
    if dist.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no Sinkhorn kernel for device {dist.device}")
    if iterations < 1:
        raise ValueError("the Sinkhorn kernel runs at least one iteration")
    if dist.device.type == "cpu" and plain_under_autograd(dist, dustbin):
        return sinkhorn_stats_reference(dist, dustbin, iterations, valid0, valid1)
    bin_ = torch.as_tensor(dustbin, dtype=torch.float32, device=dist.device).reshape(1)
    return dict(zip(STATS_KEYS, _stats_op(dist, bin_, iterations, valid0, valid1)))


def _stats_cpu(dist, dustbin, iterations, valid0, valid1):
    out = sinkhorn_stats_reference(dist, dustbin[0], iterations, valid0, valid1)
    return tuple(out[k] for k in STATS_KEYS)


def _stats_cuda(dist, dustbin, iterations, valid0, valid1):
    if dist.dtype != torch.float32 or dist.dim() != 3 or not dist.is_contiguous():
        raise ValueError(f"dist: want a contiguous fp32 [B, N, M], got "
                         f"{tuple(dist.shape)} {dist.dtype}")
    b, n, m = dist.shape
    m0 = kernel_mask(valid0, b, n, dist.device, "valid0")
    m1 = kernel_mask(valid1, b, m, dist.device, "valid1")
    with torch.cuda.device(dist.device):
        out = _launch(dist, dustbin.contiguous(), iterations, m0, m1, torch.cuda.current_stream().cuda_stream)
    return tuple(out[k] for k in STATS_KEYS)


def stats_fake(dist, dustbin, iterations, valid0, valid1, keys=STATS_KEYS):
    """Fake outputs of a Sinkhorn statistics op: u, v, then [B, N] / [B, M]
    statistics (idx0, idx1 int32)."""
    b, n, m = dist.shape
    shapes = {"u": (b, n + 1), "v": (b, m + 1), "max0": (b, n), "idx0": (b, n), "idx1": (b, m),
              "rowmass": (b, n), "colmass": (b, m)}
    return tuple(dist.new_empty(shapes[k], dtype=torch.int32 if k.startswith("idx") else torch.float32)
                 for k in keys)


_stats_op = _ops.define(
    "sinkhorn_stats(Tensor dist, Tensor dustbin, int iterations, Tensor? valid0, Tensor? valid1) -> "
    "(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
    cpu=_stats_cpu, cuda=_stats_cuda, fake=stats_fake)


def _launch(dist, bin_, iterations: int, mask0, mask1, stream: int) -> dict:
    """Allocate the outputs, the overflow rows and the workspace, and launch
    kernel 2 on `stream`; raises on any error the launch reports."""
    b, n, m = dist.shape
    pd = plan_dtype(n, m)
    lib = _build.load("sinkhorn")
    sched = query_schedule(lib.impx_sinkhorn_schedule, "impx_sinkhorn_schedule", b, n, m, pd)
    dev = dist.device
    spill = torch.empty(max(1, sched["overflow_rows"] * sched["stride"]), dtype=pd, device=dev)
    work = torch.empty(3 * sched["slots"] * (m + 1), dtype=torch.float32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    out = {
        "u": torch.empty((b, n + 1), **f32), "v": torch.empty((b, m + 1), **f32),
        "max0": torch.empty((b, n), **f32),
        "idx0": torch.empty((b, n), dtype=torch.int32, device=dev),
        "idx1": torch.empty((b, m), dtype=torch.int32, device=dev),
        "rowmass": torch.empty((b, n), **f32), "colmass": torch.empty((b, m), **f32),
    }
    ptr = lambda t: None if t is None else t.data_ptr()
    sinkhorn_fused_stats.launches += 1
    err = lib.impx_sinkhorn_stats(
        dist.data_ptr(), bin_.data_ptr(), ptr(mask0), ptr(mask1), spill.data_ptr(),
        *(out[k].data_ptr() for k in ("u", "v", "max0", "idx0", "idx1", "rowmass", "colmass")),
        work.data_ptr(), barrier_words(dev, stream).data_ptr(),
        b, n, m, iterations, int(pd == torch.bfloat16), stream)
    _build.check(err, "impx_sinkhorn_stats")
    return out


sinkhorn_fused_stats.launches = 0


def sinkhorn_plan_from_uv(dist, dustbin, u, v, valid0=None, valid1=None):
    """The fp32 [B, N+1, M+1] plan from u and v in one pass: row softmax of
    the masked padded scores, scaled by u v^T (impx/ops/pallas/sinkhorn.py:306).
    Plain PyTorch on every device; only with_scores=True callers need it."""
    scores = masked_scores(dist, dustbin, valid0, valid1)
    return torch.softmax(scores, dim=-1) * u[:, :, None] * v[:, None, :]
