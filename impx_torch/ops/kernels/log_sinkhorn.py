"""The log-domain Sinkhorn head with match statistics: the CUDA kernel's
wrapper and its plain PyTorch version.

Replaces the TPU kernel impx/ops/pallas/log_sinkhorn.py:log_sinkhorn_fused_stats
(:208, kernel `_log_sinkhorn_kernel` :59), which holds the dustbin-padded,
masked score matrix Z of one pair on chip and runs every iteration there. At
N = M = 2048 one pair's Z is 8.4 MB in bf16, beyond one SM;
impx_torch/csrc/log_sinkhorn.cu spreads it over every SM in one persistent,
cooperative launch (csrc/persistent.cuh): each CTA builds a fixed block of
the rows of Z [B, N+1, M+1] (Z dtype, dustbin row and column included) once
and keeps as many as fit in its shared memory for every iteration, the rest
in an overflow buffer in device memory (`schedule` reports the split). Per
iteration one pass over a CTA's rows gives u_i = log_mu_i -
logsumexp_j(Z_ij + v_j) and the CTA's column partials, an online (max, sum)
of Z_ij + u_i in row order; two grid barriers around a fixed-order column
merge give v_j = log_nu_j - logsumexp_i(Z_ij + u_i) (no atomics, the same
bits on every run). The row and column statistics (max0, idx0; idx1) of the
final log plan's interior Z + u + v - norm come from the same launch, and
the log-marginals are computed in the kernel from the bool validity masks,
so a call issues one device launch. What bounds it on the H100: the
exponentials, one per cell in each of the 2 * iterations sweeps, at the
special-function units' rate; reading dist once is small beside them.

Numerics, as the TPU kernel: invalid cells of Z are -1e30, the dustbin cell
of an invalid row too; the dustbin row is the bin score at valid columns and
the corner. Z is stored fp32 when round_up(N+1,16) * round_up(M+1,128) * 4
<= 6 MiB and bf16 otherwise (the Sinkhorn plan's rule, `plan_dtype`: a rule
from the TPU's VMEM, kept because the numbers depend on it; dist, the bin
score and -1e30 are all rounded); every
sum runs in fp32, u and v stay fp32. The statistics read the stored Z; the
log plan (`log_plan_from_uv`) reads the fp32 dist. Argmax takes the first
index on ties; an invalid row has max0 -1e30 and idx0 0, an invalid column
idx1 0.

Under the bf16 rule, Z holds bf16(-1e30) = -1.00026e30 where log_mu holds
-1e30, so u at an invalid row is -1e30 - bf16(-1e30) = +2.56e26 (0 under the
fp32 rule); the plan stays right, since Z + u is -1e30 again. The column sweep
starts each column's log-sum-exp from one term of exactly -1e30, the
contribution of a fully masked row: the TPU layout's alignment rows give it
at N = 2048 (round_up(N+1, 16) > N+1), and with it v is 0 at every invalid
column, as in impx. It changes no valid column (exp(-1e30 - x) is 0). impx
without alignment rows and without an invalid row, under the bf16 rule,
starts from -1e30 with weight 0 and sets v to +inf, then NaN, at an invalid
column (ROADMAP.md §C); the port does not.

Kernel 7 is the `torch.library` op `impx::log_sinkhorn_stats` (CUDA:
the launch; CPU: the plain version; a fake implementation for the output
shapes), so that an exported graph (impx_torch/tools/export.py) holds it.
"""
from __future__ import annotations

import torch

from impx_torch.ops.kernels import _build, _ops
from impx_torch.ops.kernels.attention import plain_under_autograd
from impx_torch.ops.kernels.sinkhorn import (
    _flags, barrier_words, kernel_mask, plan_dtype, query_schedule, stats_fake)
from impx_torch.ops.sinkhorn import NEG, log_marginals, log_optimal_transport, masked_scores


def log_sinkhorn_stats_reference(dist, dustbin, iterations: int, valid0=None, valid1=None):
    """Plain version of `log_sinkhorn_fused_stats`, the kernel's function
    step by step: Z rounded to its storage dtype, fp32 sweeps, each column's
    log-sum-exp started from one term of -1e30, statistics of the rounded Z."""
    b, n, m = dist.shape
    f0, f1 = _flags(dist, valid0, valid1)
    log_mu, log_nu, norm = log_marginals(f0, f1)
    z = masked_scores(dist.float(), dustbin, valid0, valid1).to(plan_dtype(n, m)).float()
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(iterations):
        u = log_mu - torch.logsumexp(z + v[:, None, :], dim=2)
        v = log_nu - torch.logaddexp(torch.logsumexp(z + u[:, :, None], dim=1),
                                     torch.tensor(NEG, device=dist.device))
    ok = (f0[:, :, None] > 0) & (f1[:, None, :] > 0)
    val = z[:, :n, :m] + u[:, :n, None] + v[:, None, :m] - norm[:, :, None]
    filled = torch.where(ok, val, NEG)
    return {
        "u": u, "v": v,
        "max0": filled.amax(dim=2),
        "idx0": filled.argmax(dim=2).to(torch.int32),   # first index on ties
        "idx1": filled.argmax(dim=1).to(torch.int32),
    }


def schedule(b: int, n: int, m: int, device=None) -> dict:
    """Kernel 7's schedule for dist [b, n, m] on `device` (the current card
    when None)."""
    with torch.cuda.device(device):
        return query_schedule(_build.load("log_sinkhorn").impx_log_sinkhorn_schedule,
                              "impx_log_sinkhorn_schedule", b, n, m, plan_dtype(n, m))


def log_sinkhorn_fused_stats(dist, dustbin, iterations: int, valid0=None, valid1=None):
    """Log-domain Sinkhorn head without returning the plan. dist [B, N, M]
    fp32, dustbin a scalar, valid0/valid1 bool [B, N]/[B, M] (others are
    read as > 0). Returns u [B, N+1], v [B, M+1] (log plan = Z + u + v -
    norm, see `log_plan_from_uv`), max0/idx0 [B, N] (row max and argmax of
    the log plan's interior) and idx1 [B, M]. CPU tensors run
    `log_sinkhorn_stats_reference`; CUDA tensors launch the kernel or raise.
    The statistics have no gradient: under autograd a CUDA call raises (the
    differentiable head is `log_optimal_transport_fused`)."""
    if dist.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no log-Sinkhorn kernel for device {dist.device}")
    if dist.device.type == "cpu" and plain_under_autograd(dist, dustbin):
        return log_sinkhorn_stats_reference(dist, dustbin, iterations, valid0, valid1)
    if plain_under_autograd(dist, dustbin):
        raise NotImplementedError("the log-Sinkhorn kernel's statistics have no gradient; train "
                                  "through log_optimal_transport_fused, whose backward recomputes the "
                                  "plain fp32 head, or call this under torch.no_grad()")
    if iterations < 1:
        raise ValueError("the log-Sinkhorn kernel runs at least one iteration")
    bin_ = torch.as_tensor(dustbin, dtype=torch.float32, device=dist.device).reshape(1)
    return dict(zip(LOG_STATS_KEYS, _log_stats_op(dist, bin_, iterations, valid0, valid1)))


LOG_STATS_KEYS = ("u", "v", "max0", "idx0", "idx1")


def _log_stats_cpu(dist, dustbin, iterations, valid0, valid1):
    out = log_sinkhorn_stats_reference(dist, dustbin[0], iterations, valid0, valid1)
    return tuple(out[k] for k in LOG_STATS_KEYS)


def _log_stats_cuda(dist, dustbin, iterations, valid0, valid1):
    if dist.dtype != torch.float32 or dist.dim() != 3 or not dist.is_contiguous():
        raise ValueError(f"dist: want a contiguous fp32 [B, N, M], got "
                         f"{tuple(dist.shape)} {dist.dtype}")
    b, n, m = dist.shape
    m0 = kernel_mask(valid0, b, n, dist.device, "valid0")
    m1 = kernel_mask(valid1, b, m, dist.device, "valid1")
    with torch.cuda.device(dist.device):
        out = _launch(dist, dustbin.contiguous(), iterations, m0, m1, torch.cuda.current_stream().cuda_stream)
    return tuple(out[k] for k in LOG_STATS_KEYS)


_log_stats_op = _ops.define(
    "log_sinkhorn_stats(Tensor dist, Tensor dustbin, int iterations, Tensor? valid0, Tensor? valid1) -> "
    "(Tensor, Tensor, Tensor, Tensor, Tensor)",
    cpu=_log_stats_cpu, cuda=_log_stats_cuda,
    fake=lambda dist, dustbin, iterations, valid0, valid1: stats_fake(dist, dustbin, iterations, valid0, valid1,
                                                                      LOG_STATS_KEYS))


def _launch(dist, bin_, iterations: int, mask0, mask1, stream: int) -> dict:
    """Allocate the outputs, the overflow rows and the workspace, and launch
    kernel 7 on `stream`; raises on any error the launch reports."""
    b, n, m = dist.shape
    zd = plan_dtype(n, m)   # Z's storage rule is the Sinkhorn plan's
    lib = _build.load("log_sinkhorn")
    sched = query_schedule(lib.impx_log_sinkhorn_schedule, "impx_log_sinkhorn_schedule", b, n, m, zd)
    dev = dist.device
    spill = torch.empty(max(1, sched["overflow_rows"] * sched["stride"]), dtype=zd, device=dev)
    work = torch.empty(3 * sched["slots"] * (m + 1), dtype=torch.float32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    out = {
        "u": torch.empty((b, n + 1), **f32), "v": torch.empty((b, m + 1), **f32),
        "max0": torch.empty((b, n), **f32),
        "idx0": torch.empty((b, n), dtype=torch.int32, device=dev),
        "idx1": torch.empty((b, m), dtype=torch.int32, device=dev),
    }
    ptr = lambda t: None if t is None else t.data_ptr()
    log_sinkhorn_fused_stats.launches += 1
    err = lib.impx_log_sinkhorn_stats(
        dist.data_ptr(), bin_.data_ptr(), ptr(mask0), ptr(mask1), spill.data_ptr(),
        *(out[k].data_ptr() for k in ("u", "v", "max0", "idx0", "idx1")),
        work.data_ptr(), barrier_words(dev, stream).data_ptr(),
        b, n, m, iterations, int(zd == torch.bfloat16), stream)
    _build.check(err, "impx_log_sinkhorn_stats")
    return out


log_sinkhorn_fused_stats.launches = 0


def log_plan_from_uv(dist, dustbin, u, v, valid0=None, valid1=None):
    """The fp32 log plan [B, N+1, M+1] from u and v in one pass: Z + u + v -
    norm over the fp32 dist (impx/ops/pallas/log_sinkhorn.py:292). Plain
    PyTorch on every device."""
    _, _, norm = log_marginals(*_flags(dist, valid0, valid1))
    z = masked_scores(dist.float(), dustbin, valid0, valid1)
    return z + u[:, :, None] + v[:, None, :] - norm[:, :, None]


def log_optimal_transport_fused(dist, dustbin, iterations: int, valid0=None, valid1=None,
                                plain: bool = False):
    """Drop-in for `log_optimal_transport` (impx/ops/pallas/log_sinkhorn.py:307):
    the kernel's u and v, then the log plan in one pass; differentiable
    with respect to dist and the dustbin (`LogOTFused`). plain=True takes u
    and v from `log_sinkhorn_stats_reference` on any device."""
    dustbin = torch.as_tensor(dustbin, dtype=torch.float32, device=dist.device)
    return LogOTFused.apply(dist, dustbin, iterations, valid0, valid1, plain)


class LogOTFused(torch.autograd.Function):
    """impx's custom VJP of the fused head (impx/ops/pallas/log_sinkhorn.py:
    _lot_fwd, _lot_bwd :328-338). The forward takes u and v from one kernel 7
    launch (its plain version when plain) and stores nothing per sweep; the
    backward recomputes the plain fp32 `log_optimal_transport` and returns
    its gradient (LogUV's restructured reverse pass) for dist and for the
    dustbin, the learned bin score. So the gradient is the same on every
    device and with either forward. At the training shape (N = M = 1024)
    kernel 7 keeps Z in fp32, so forward and recomputation read the same Z;
    under the bf16 rule (larger N and M) the forward's Z is rounded and the
    gradient is that of the fp32 head, as in impx."""

    @staticmethod
    def forward(ctx, dist, dustbin, iterations: int, valid0, valid1, plain: bool):
        stats_fn = log_sinkhorn_stats_reference if plain else log_sinkhorn_fused_stats
        stats = stats_fn(dist, dustbin, iterations, valid0, valid1)
        ctx.iterations = iterations
        ctx.save_for_backward(dist, dustbin, valid0, valid1)
        return log_plan_from_uv(dist, dustbin, stats["u"], stats["v"], valid0, valid1)

    @staticmethod
    def backward(ctx, g):
        dist, dustbin, valid0, valid1 = ctx.saved_tensors
        with torch.enable_grad():
            leaves = (dist.detach().requires_grad_(), dustbin.detach().requires_grad_())
            out = log_optimal_transport(*leaves, ctx.iterations, valid0, valid1)
            gd, gb = torch.autograd.grad(out, leaves, g)
        return gd, gb, None, None, None, None
