"""Sinkhorn with a learned dustbin, masked (impx/ops/sinkhorn.py): the
non-log head and the log-domain optimal transport.

Padded rows and columns get zero marginals (-1e30 log-marginals) and -1e30
scores, which makes the padded iteration identical to running on the
unpadded keypoint sets. `sink_algorithm` is the plain oracle of the Sinkhorn
kernel (impx_torch/ops/kernels/sinkhorn.py) and the training head, whose
gradient is `SinkhornUV`'s; `log_optimal_transport` is the plain log-domain
head, whose gradient is `LogUV`'s; `dual_softmax` is the head of
`with_sinkhorn=False`, differentiated by plain autograd.
"""
from __future__ import annotations

import torch

from impx_torch.tools.profiling import span

EPS = 1e-8
NEG = -1e30


def _pad_with_dustbin(dist: torch.Tensor, dustbin: torch.Tensor) -> torch.Tensor:
    """Append a dustbin column and row filled with the learned bin score."""
    b, n, m = dist.shape
    bin_ = torch.as_tensor(dustbin, dtype=dist.dtype, device=dist.device)
    dist = torch.cat([dist, bin_.expand(b, n, 1)], dim=-1)
    return torch.cat([dist, bin_.expand(b, 1, m + 1)], dim=-2)


def _padded_masks(b, n, m, valid0, valid1, dtype, device):
    if valid0 is None:
        valid0 = torch.ones((b, n), dtype=torch.bool, device=device)
    if valid1 is None:
        valid1 = torch.ones((b, m), dtype=torch.bool, device=device)
    one = torch.ones((b, 1), dtype=torch.bool, device=device)
    v0p = torch.cat([valid0, one], dim=1)  # the dustbin row is always valid
    v1p = torch.cat([valid1, one], dim=1)
    return valid0.to(dtype), valid1.to(dtype), v0p, v1p


def masked_scores(dist: torch.Tensor, dustbin: torch.Tensor, valid0=None, valid1=None) -> torch.Tensor:
    """The dustbin-padded scores [B, N+1, M+1] with -1e30 in every invalid
    row and column, the dustbin cells of invalid rows and columns included
    (the dustbin row and column themselves are valid)."""
    b, n, m = dist.shape
    _, _, v0p, v1p = _padded_masks(b, n, m, valid0, valid1, dist.dtype, dist.device)
    return torch.where(v0p[:, :, None] & v1p[:, None, :], _pad_with_dustbin(dist, dustbin), NEG)


def marginals(f0: torch.Tensor, f1: torch.Tensor):
    """Row and column marginals: 1 per valid keypoint, dustbin = count + 1."""
    r = torch.cat([f0, f0.sum(dim=1, keepdim=True) + 1.0], dim=1)  # [B, N+1]
    c = torch.cat([f1, f1.sum(dim=1, keepdim=True) + 1.0], dim=1)  # [B, M+1]
    return r, c


def dual_softmax(dist: torch.Tensor, dustbin: torch.Tensor, valid0=None, valid1=None) -> torch.Tensor:
    """exp(log_softmax over rows + log_softmax over columns) of the
    dustbin-padded, masked scores [B, N+1, M+1] (impx/ops/sinkhorn.py:182);
    every invalid cell, pad-pad cells included, is exactly 0."""
    b, n, m = dist.shape
    _, _, v0p, v1p = _padded_masks(b, n, m, valid0, valid1, dist.dtype, dist.device)
    ok = v0p[:, :, None] & v1p[:, None, :]
    scores = torch.where(ok, _pad_with_dustbin(dist, dustbin), NEG)
    score = torch.log_softmax(scores, dim=-1) + torch.log_softmax(scores, dim=-2)
    return torch.where(ok, torch.exp(score), 0.0)


def sink_algorithm(
    dist: torch.Tensor,
    dustbin: torch.Tensor,
    iterations: int,
    valid0: torch.Tensor | None = None,
    valid1: torch.Tensor | None = None,
    plan_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Returns the fp32 [B, N+1, M+1] transport plan (impx/ops/sinkhorn.py:44).

    plan_dtype: storage dtype of the initial plan inside the u/v iteration;
    u and v are rounded to it before each product, sums stay fp32."""
    b, n, m = dist.shape
    f0, f1, _, _ = _padded_masks(b, n, m, valid0, valid1, dist.dtype, dist.device)
    r, c = marginals(f0, f1)
    p = torch.softmax(masked_scores(dist, dustbin, valid0, valid1), dim=-1)
    return SinkhornUV.apply(p, r, c, iterations, plan_dtype)


def _mv(p_loop, x, pd):
    """p @ x over the columns, x rounded to the plan's storage dtype, fp32 sums."""
    return torch.matmul(p_loop, x.to(pd).float()[:, :, None])[:, :, 0]


def _mtv(p_loop, x, pd):
    """x @ p over the rows, as `_mv`."""
    return torch.matmul(x.to(pd).float()[:, None, :], p_loop)[:, 0, :]


def _uv_sweeps(p, r, c, iterations: int, plan_dtype: torch.dtype | None):
    """`iterations` u/v marginal updates against the fixed plan p stored in
    `plan_dtype` (impx/ops/sinkhorn.py:92). Returns each sweep's (su, sv, u,
    v), u = r / su and v = c / sv, stacked [T, B, N+1] / [T, B, M+1]."""
    pd = plan_dtype or p.dtype
    p_loop = p.to(pd).float()
    u, v = torch.ones_like(r), torch.ones_like(c)
    hist = []
    for _ in range(iterations):
        su = _mv(p_loop, v, pd) + EPS
        u = r / su
        sv = _mtv(p_loop, u, pd) + EPS
        v = c / sv
        hist.append((su, sv, u, v))
    return tuple(torch.stack(x) for x in zip(*hist))


def _uv_iterate(p, r, c, iterations: int, plan_dtype: torch.dtype | None):
    """The last sweep's u, v of `_uv_sweeps`."""
    _, _, us, vs = _uv_sweeps(p, r, c, iterations, plan_dtype)
    return us[-1], vs[-1]


class SinkhornUV(torch.autograd.Function):
    """The u/v marginal iteration and the scaling P = p u v^T, with the
    restructured reverse pass of impx/ops/sinkhorn.py:_sinkhorn_uv_bwd (:143).
    The forward keeps the per-sweep u, v and their denominators; the reverse
    recurrence runs on vectors (two products with the plan a sweep) and all
    2T rank-1 terms of the plan's gradient come from one [N+1, 2T] x
    [2T, M+1] product, instead of a plan-sized accumulation a sweep under
    plain autograd. The plan stays in `plan_dtype` inside the loop, forward
    and reverse. The marginals r, c come from the validity masks and get no
    gradient. Plain PyTorch: impx computes it outside any Pallas kernel."""

    @staticmethod
    def forward(ctx, p, r, c, iterations: int, plan_dtype: torch.dtype | None):
        sus, svs, us, vs = _uv_sweeps(p, r, c, iterations, plan_dtype)
        ctx.save_for_backward(p, r, c, sus, svs, us, vs)
        ctx.pd = plan_dtype or p.dtype
        return p * us[-1][:, :, None] * vs[-1][:, None, :]

    @staticmethod
    def backward(ctx, g):
        with span("impx.head.backward"):
            p, r, c, sus, svs, us, vs = ctx.saved_tensors
            pd = ctx.pd
            p_loop = p.to(pd).float()
            u_t, v_t = us[-1], vs[-1]
            gp = g * p
            u_bar = torch.einsum("bnm,bm->bn", gp, v_t)   # output -> u_T
            v_bar = torch.einsum("bnm,bn->bm", gp, u_t)   # output -> v_T
            v_prevs = torch.cat([torch.ones_like(vs[:1]), vs[:-1]], dim=0)
            sv_bars, su_bars = [], []
            for t in reversed(range(us.shape[0])):
                su, sv = sus[t], svs[t]
                sv_bar = -(v_bar * c) / (sv * sv)              # v_t = c / sv
                u_tot = u_bar + _mv(p_loop, sv_bar, pd)        # u_t is used in sv
                su_bar = -(u_tot * r) / (su * su)              # u_t = r / su
                sv_bars.insert(0, sv_bar)
                su_bars.insert(0, su_bar)
                u_bar, v_bar = torch.zeros_like(u_bar), _mtv(p_loop, su_bar, pd)  # v_{t-1} in su
            a = torch.cat([us, torch.stack(su_bars)])               # [2T, B, N+1]
            bm = torch.cat([torch.stack(sv_bars), v_prevs])         # [2T, B, M+1]
            p_bar = g * (u_t[:, :, None] * v_t[:, None, :]) + torch.einsum("tbn,tbm->bnm", a, bm)
            return p_bar, None, None, None, None


def log_marginals(f0: torch.Tensor, f1: torch.Tensor):
    """Log-marginals of the log-domain head from validity flags f0 [B, N],
    f1 [B, M] (impx/ops/sinkhorn.py:223-225): norm = -log(n0 + n1) [B, 1];
    log_mu [B, N+1] is norm at valid rows, -1e30 at invalid ones and
    log(n1) + norm at the dustbin; log_nu [B, M+1] likewise."""
    n0 = f0.sum(dim=1, keepdim=True)
    n1 = f1.sum(dim=1, keepdim=True)
    norm = -torch.log(n0 + n1)
    log_mu = torch.cat([torch.where(f0 > 0, norm, NEG), torch.log(n1) + norm], dim=1)
    log_nu = torch.cat([torch.where(f1 > 0, norm, NEG), torch.log(n0) + norm], dim=1)
    return log_mu, log_nu, norm


def log_optimal_transport(
    dist: torch.Tensor,
    dustbin: torch.Tensor,
    iterations: int,
    valid0: torch.Tensor | None = None,
    valid1: torch.Tensor | None = None,
) -> torch.Tensor:
    """Log-domain Sinkhorn (impx/ops/sinkhorn.py:201), fp32: the log
    transport plan Z + u + v - norm [B, N+1, M+1], Z the dustbin-padded,
    masked scores; u_i = log_mu_i - logsumexp_j(Z_ij + v_j) and
    v_j = log_nu_j - logsumexp_i(Z_ij + u_i) from u = v = 0 (:249-257)."""
    b, n, m = dist.shape
    f0, f1, _, _ = _padded_masks(b, n, m, valid0, valid1, dist.dtype, dist.device)
    log_mu, log_nu, norm = log_marginals(f0, f1)
    z = masked_scores(dist, dustbin, valid0, valid1)
    return LogUV.apply(z, log_mu, log_nu, iterations) - norm[:, :, None]


class LogUV(torch.autograd.Function):
    """The log-domain u/v iteration and its output Z + u + v, with the
    restructured reverse pass of impx/ops/sinkhorn.py:_log_uv_bwd (:273).

    The row-softmax weights of sweep t factor through the fixed matrix
    E = exp(Z - rowmax) over the valid cells: w_t = E * exp(s + u_t -
    log_mu) exp(v_{t-1}), and the column sweep's alike. So the forward keeps
    only each sweep's u and v (when an input needs a gradient), the reverse
    recurrence runs on vectors with two products with E a sweep, and the
    gradient of Z is g + E * (one [N+1, 2T] x [2T, M+1] product of the
    stacked rank-1 factors), formed once, instead of a plan-sized softmax
    backward a sweep under plain autograd. The gradients of log_mu and
    log_nu are the summed totals of each sweep. Plain PyTorch: impx
    computes it outside any Pallas kernel."""

    @staticmethod
    def forward(ctx, z, log_mu, log_nu, iterations: int):
        keep = any(ctx.needs_input_grad[:3])
        u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
        us, vs = [], []
        for _ in range(iterations):
            u = log_mu - torch.logsumexp(z + v[:, None, :], dim=2)
            v = log_nu - torch.logsumexp(z + u[:, :, None], dim=1)
            if keep:
                us.append(u)
                vs.append(v)
        if keep:
            ctx.save_for_backward(z, log_mu, log_nu, torch.stack(us), torch.stack(vs))
        return z + u[:, :, None] + v[:, None, :]

    @staticmethod
    def backward(ctx, g):
        with span("impx.head.backward"):
            z, log_mu, log_nu, us, vs = ctx.saved_tensors
            row_ok = log_mu > NEG / 2
            col_ok = log_nu > NEG / 2
            ok = row_ok[:, :, None] & col_ok[:, None, :]
            s = torch.where(ok, z, NEG).amax(dim=2)                          # [B, N+1] row shift
            e = torch.where(ok, torch.exp(z - s[:, :, None]), 0.0)           # in [0, 1]
            u_bar, v_bar = g.sum(dim=2), g.sum(dim=1)                        # output Z + u_T + v_T
            v_prevs = torch.cat([torch.zeros_like(vs[:1]), vs[:-1]])
            a_ts, vds, uas, ev_prevs, u_tots, v_bars = [], [], [], [], [], []
            for t in reversed(range(us.shape[0])):
                u_t, v_t, v_prev = us[t], vs[t], v_prevs[t]
                # v_t = log_nu - LSE_n(Z + u_t): weights E a_t[n] d_t[m]
                a_t = torch.where(row_ok, torch.exp(s + u_t), 0.0)
                d_t = torch.where(col_ok, torch.exp(v_t - log_nu), 0.0)
                vd = v_bar * d_t
                u_tot = u_bar - a_t * torch.matmul(e, vd[:, :, None])[:, :, 0]
                # u_t = log_mu - LSE_m(Z + v_{t-1}): weights E alpha_t[n] exp(v_prev[m])
                ua = u_tot * torch.where(row_ok, torch.exp(s + u_t - log_mu), 0.0)
                ev_prev = torch.where(col_ok, torch.exp(v_prev), 0.0)
                for lst, x in ((a_ts, a_t), (vds, vd), (uas, ua), (ev_prevs, ev_prev), (u_tots, u_tot),
                               (v_bars, v_bar)):
                    lst.append(x)
                u_bar, v_bar = torch.zeros_like(u_bar), -ev_prev * torch.matmul(ua[:, None, :], e)[:, 0, :]
            a = -torch.stack(a_ts[::-1] + uas[::-1])                         # [2T, B, N+1], sweeps in order
            bm = torch.stack(vds[::-1] + ev_prevs[::-1])                     # [2T, B, M+1]
            z_bar = g + e * torch.einsum("tbn,tbm->bnm", a, bm)
            return z_bar, torch.stack(u_tots).sum(0), torch.stack(v_bars).sum(0), None
