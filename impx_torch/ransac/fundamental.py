"""On-device fundamental-matrix RANSAC (impx/ransac/fundamental.py), the
`f_backend: device` of FMBenchEval in place of cv2.findFundamentalMat.

Pixel coordinates, Hartley-normalised for the solves; batched over
hypotheses. Minimal sets of 7 points are solved by the 7-point solver (up to
three real F a set, every one scored), of 8 or more by the least-squares
eight-point solver with its rank-2 projection. The score is the
sigma-marginalised truncated gain on the squared symmetric epipolar distance;
the local optimisation is annealed IRLS from the best `lo_starts`
hypotheses, the best final gain kept.

The solves use torch.linalg.eigh, svd, det and solve, as impx uses their jnp
counterparts (on the card these are batched library calls, and each checks
its result on the host). As in `ransac/ransac.py`, the draws are split from
the rest: `estimate_fundamental_ransac` is `_sample_minimal_sets` followed by
`fundamental_ransac_from_samples`, which is deterministic given the minimal
sets, so the port is held against impx on impx's own draws (JAX's threefry
stream has no torch counterpart).
"""
from __future__ import annotations

import math

import torch

from impx_torch.ransac.eight_point import _design_matrix
from impx_torch.ransac.ransac import _gather_points, _sample_minimal_sets


def _hartley_normalize(x: torch.Tensor, valid: torch.Tensor):
    """(x translated to the valid points' centroid and scaled to a mean
    distance of sqrt(2), T [3, 3] with x_normalised = T x_homogeneous)
    (impx/ransac/fundamental.py:19)."""
    f = valid.to(x.dtype)[:, None]
    count = torch.clamp(f.sum(), min=1.0)
    mean = (x * f).sum(dim=0) / count
    d = torch.sqrt((((x - mean) ** 2) * f).sum(dim=-1).sum() / count + 1e-12)
    s = math.sqrt(2.0) / (d + 1e-12)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([torch.stack([s, zero, -s * mean[0]]), torch.stack([zero, s, -s * mean[1]]),
                     torch.stack([zero, zero, one])])
    return (x - mean) * s, T


def _normalized_f(F: torch.Tensor) -> torch.Tensor:
    return F / (torch.linalg.norm(F, dim=(-2, -1), keepdim=True) + 1e-15)


def fundamental_from_points(x0: torch.Tensor, x1: torch.Tensor, weights: torch.Tensor | None = None):
    """Least-squares F [..., 3, 3] from >= 8 correspondences x0, x1 [..., N, 2]
    (weights [..., N] scale the rows), projected to rank 2 and scaled to unit
    norm (impx/ransac/fundamental.py:29)."""
    A = _design_matrix(x0, x1)
    if weights is not None:
        A = A * weights[..., :, None]
    _, V = torch.linalg.eigh(A.mT @ A)
    F = V[..., :, 0].reshape(*A.shape[:-2], 3, 3)
    U, S, Vh = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return _normalized_f((U * S[..., None, :]) @ Vh)


def _sym_epi_dist2(x0: torch.Tensor, x1: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """Squared symmetric epipolar distance in pixels [..., N] of x0, x1
    [..., N, 2] under F [..., 3, 3]: the larger of the two point-to-line
    distances (impx/ransac/fundamental.py:43)."""
    x0h = torch.cat([x0, torch.ones_like(x0[..., :1])], dim=-1)
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    l1 = x0h @ F.mT
    l0 = x1h @ F
    num = torch.sum(x1h * l1, dim=-1) ** 2
    d1 = num / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-15)
    d0 = num / (l0[..., 0] ** 2 + l0[..., 1] ** 2 + 1e-15)
    return torch.maximum(d0, d1)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _cubic_roots(c3, c2, c1, c0):
    """Real roots of c3 x^3 + c2 x^2 + c1 x + c0 for each batch entry
    (impx/ransac/fundamental.py:55): (roots [..., 3], ok [..., 3]). Closed
    form (trigonometric for three real roots, Cardano for one), the quadratic's
    roots in slots 0 and 1 when |c3| is negligible, then two Newton steps on
    the cubic itself. A spurious root costs nothing: every candidate is
    scored."""
    tiny = 1e-12
    quad = torch.abs(c3) < tiny * (torch.abs(c2) + torch.abs(c1) + torch.abs(c0) + 1.0)
    c3s = torch.where(quad, 1.0, c3)
    b, c, d = c2 / c3s, c1 / c3s, c0 / c3s
    p = c - b * b / 3.0                                  # t^3 + p t + q, x = t - b/3
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + d
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    k = torch.arange(3.0, dtype=c3.dtype, device=c3.device)

    pr = torch.clamp(p, max=-tiny)                        # three real roots
    m = 2.0 * torch.sqrt(-pr / 3.0)
    theta = torch.arccos(torch.clamp(3.0 * q / (pr * m), -1.0, 1.0)) / 3.0
    t_trig = m[..., None] * torch.cos(theta[..., None] - 2.0 * math.pi * k / 3.0)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))          # one real root
    t_card = (_cbrt(-q / 2.0 + sq) + _cbrt(-q / 2.0 - sq))[..., None] * torch.ones_like(k)

    three = disc < 0.0
    x = torch.where(three[..., None], t_trig, t_card) - (b / 3.0)[..., None]
    ok = three[..., None] | (k == 0.0)

    c2s = torch.where(torch.abs(c2) < tiny, 1.0, c2)    # c2 x^2 + c1 x + c0
    qd = c1 * c1 - 4.0 * c2 * c0
    sqq = torch.sqrt(torch.clamp(qd, min=0.0))
    xq = torch.stack([(-c1 + sqq) / (2.0 * c2s), (-c1 - sqq) / (2.0 * c2s), torch.zeros_like(c1)], dim=-1)
    okq = torch.stack([qd >= 0, qd >= 0, torch.zeros_like(qd, dtype=torch.bool)], dim=-1)
    x = torch.where(quad[..., None], xq, x)
    ok = torch.where(quad[..., None], okq, ok)

    c3e, c2e, c1e, c0e = (v[..., None] for v in (c3, c2, c1, c0))
    for _ in range(2):
        f = ((c3e * x + c2e) * x + c1e) * x + c0e
        fp = (3.0 * c3e * x + 2.0 * c2e) * x + c1e
        x = x - f / torch.where(torch.abs(fp) < tiny, tiny, fp)
    return x, ok & torch.isfinite(x)


def solve_fundamental_7pt(x0: torch.Tensor, x1: torch.Tensor):
    """The 7-point minimal solver on x0, x1 [H, 7, 2] (normalised
    coordinates; impx/ransac/fundamental.py:111): the two-dimensional null
    space (F1, F2) of the [7, 9] design matrix, the cubic det(F1 + l F2) = 0
    from its values at l = 0, 1, -1, 2, and F1 + l F2 at each real root, unit
    norm. Returns (F [H, 3, 3, 3], ok [H, 3])."""
    A = _design_matrix(x0, x1)
    _, V = torch.linalg.eigh(A.mT @ A)
    F1 = V[..., :, 0].reshape(-1, 3, 3)
    F2 = V[..., :, 1].reshape(-1, 3, 3)
    lams = torch.tensor([0.0, 1.0, -1.0, 2.0], dtype=x0.dtype, device=x0.device)
    dets = torch.stack([torch.linalg.det(F1 + lam * F2) for lam in lams.tolist()])      # [4, H]
    vm = torch.stack([lams ** 0, lams, lams ** 2, lams ** 3], dim=1)
    coef = torch.linalg.solve(vm, dets)                                                   # c0..c3 [4, H]
    roots, ok = _cubic_roots(coef[3], coef[2], coef[1], coef[0])
    return _normalized_f(F1[:, None] + roots[..., None, None] * F2[:, None]), ok


def _score_f(F, x0, x1, valid, t2: float, sigmas):
    """Sigma-marginalised truncated gain [...] and the inlier mask [..., N] at
    the base threshold (impx/ransac/fundamental.py:137), F [..., 3, 3]
    against every point."""
    d2 = _sym_epi_dist2(x0, x1, F)
    inlier = (d2 < t2) & valid
    gain = sum(torch.sum(torch.where(valid, torch.clamp(1.0 - d2 / (t2 * s * s), min=0.0), 0.0), dim=-1) / s
               for s in sigmas)
    return gain, inlier


def fundamental_ransac_from_samples(idx: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor, valid: torch.Tensor,
                                    threshold_px: float = 1.0, lo_iterations: int = 8,
                                    score_sigmas: tuple = (1.0, 2.0, 3.0), lo_anneal: float = 8.0,
                                    lo_starts: int = 8) -> dict:
    """RANSAC for F given the minimal sets idx [H, S] into x0, x1 [N, 2]
    (pixels; valid [N] bool) (impx/ransac/fundamental.py:153-209 after its
    draw). S = 7 runs the 7-point solver (an invalid candidate gains -inf),
    S >= 8 the eight-point one. The best `lo_starts` hypotheses by gain (the
    first of equal gains first, as lax.top_k orders them) each run
    `lo_iterations` IRLS refits whose support threshold shrinks from
    lo_anneal x threshold_px to threshold_px; a refit is kept if its gain
    held and it had 8 supports. Returns dict(F [3, 3] unit norm, inliers [N],
    num_inliers)."""
    x0n, T0 = _hartley_normalize(x0, valid)
    x1n, T1 = _hartley_normalize(x1, valid)
    t2 = threshold_px * threshold_px
    sx0, sx1 = _gather_points(x0n, idx), _gather_points(x1n, idx)
    if idx.shape[-1] == 7:
        Fs_n, ok = solve_fundamental_7pt(sx0, sx1)
        Fs_n, ok = Fs_n.reshape(-1, 3, 3), ok.reshape(-1)
    elif idx.shape[-1] >= 8:
        Fs_n, ok = fundamental_from_points(sx0, sx1), None
    else:
        raise ValueError(f"minimal sets of {idx.shape[-1]} points: want 7 or at least 8")
    Fs = T1.T @ Fs_n @ T0                                        # denormalise: F = T1^T Fn T0
    gains, _ = _score_f(Fs, x0, x1, valid, t2, score_sigmas)
    if ok is not None:
        gains = torch.where(ok, gains, -torch.inf)

    top = torch.sort(gains, descending=True, stable=True).indices[:min(lo_starts, gains.shape[0])]
    F = Fs[top]                                                  # [K, 3, 3]
    g, _ = _score_f(F, x0, x1, valid, t2, score_sigmas)
    for i in range(lo_iterations):
        frac = (lo_iterations - 1.0 - i) / max(lo_iterations - 1.0, 1.0)
        m2 = (1.0 + (lo_anneal - 1.0) * frac) ** 2
        d2 = _sym_epi_dist2(x0, x1, F)
        w = torch.where((d2 < t2 * m2) & valid, 1.0 / (1.0 + d2 / (t2 * m2)), 0.0)
        n_in = torch.sum(w > 0, dim=-1)
        F_new = T1.T @ fundamental_from_points(x0n, x1n, weights=w) @ T0
        g_new, _ = _score_f(F_new, x0, x1, valid, t2, score_sigmas)
        better = (g_new >= g) & (n_in >= 8)
        F = torch.where(better[:, None, None], F_new, F)
        g = torch.where(better, g_new, g)
    F = F[torch.argmax(g)]
    _, inliers = _score_f(F, x0, x1, valid, t2, score_sigmas)
    return {"F": _normalized_f(F), "inliers": inliers, "num_inliers": inliers.sum()}


def estimate_fundamental_ransac(generator: torch.Generator, x0: torch.Tensor, x1: torch.Tensor,
                                valid: torch.Tensor, threshold_px: float = 1.0, num_hypotheses: int = 1024,
                                lo_iterations: int = 8, sample_size: int = 7,
                                score_sigmas: tuple = (1.0, 2.0, 3.0), lo_anneal: float = 8.0,
                                lo_starts: int = 8) -> dict:
    """x0, x1 [N, 2] pixel coordinates, valid [N] bool, generator a
    torch.Generator on their device; returns dict(F, inliers, num_inliers)
    (impx/ransac/fundamental.py:153). impx's defaults: 7-point sets, the
    sigma-marginalised score, annealed IRLS LO from the best 8."""
    idx = _sample_minimal_sets(generator, valid, num_hypotheses, sample_size)
    return fundamental_ransac_from_samples(idx, x0, x1, valid, threshold_px, lo_iterations, score_sigmas,
                                           lo_anneal, lo_starts)
