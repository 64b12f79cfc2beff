"""Batched on-device RANSAC for the essential matrix (impx/ransac/ransac.py).

Fixed-shape tensor work in place of a host cv2.findEssentialMat call:

  1. sample H minimal subsets at once, uniform through a dense valid-index
     table, or weighted (PROSAC-style) through Gumbel top-k;
  2. solve every hypothesis with the batched eight-point solver, or the
     five-point minimal solver (up to 10 candidates a sample);
  3. score every hypothesis against every point in one [H, N] Sampson matrix
     with a truncated-quadratic gain;
  4. local optimisation: iteratively reweighted least squares on the best
     model's support, a fixed number of iterations.

The random draws are split from the rest: `estimate_essential_ransac` is
`_sample_minimal_sets` (a torch.Generator on the points' device) followed by
`essential_ransac_from_samples`, which is deterministic given the sample
indices. JAX's threefry stream has no torch counterpart, so the port is held
against impx on the indices impx draws. No step synchronises with the host.
"""
from __future__ import annotations

import torch

from impx_torch.geometry.epipolar import sampson_distance
from impx_torch.ransac.eight_point import essential_from_points
from impx_torch.ransac.five_point import solve_essential_5pt

# impx's defaults, which none of its callers of the essential RANSAC changes:
# the gain's truncation scales and the local optimisation's first support
# threshold, LO_ANNEAL times the base one. impx's lo_starts (LO from the best
# k hypotheses) is 1 at every caller; the port keeps that one start.
SCORE_SIGMAS = (1.0, 2.0)
LO_ANNEAL = 3.0


def _sample_minimal_sets(generator: torch.Generator, valid: torch.Tensor, num_hypotheses: int,
                         sample_size: int) -> torch.Tensor:
    """[H, sample_size] indices of valid points, about uniform.

    A stable argsort puts the valid indices first; H*S uniform draws in
    [0, n_valid) index that table (rare within-sample collisions give
    degenerate hypotheses that score low). The draw is floor(u * n_valid)
    with u uniform in [0, 1), so n_valid stays on the device."""
    order = torch.argsort((~valid).to(torch.uint8), stable=True)
    nv = valid.sum().clamp(min=1)
    u = torch.rand((num_hypotheses, sample_size), generator=generator, device=valid.device)
    r = torch.minimum((u * nv).long(), nv - 1)
    return order[r]


def _sample_minimal_sets_weighted(generator: torch.Generator, weights: torch.Tensor, valid: torch.Tensor,
                                  num_hypotheses: int, sample_size: int) -> torch.Tensor:
    """[H, sample_size] indices drawn without replacement per hypothesis with
    probability proportional to `weights` (Gumbel top-k), so confident
    matches are sampled first. Cost is an [H, N] top-k: run it on
    match-compacted points."""
    logw = torch.where(valid & (weights > 0), torch.log(torch.clamp(weights, min=1e-20)), -torch.inf)
    u = torch.rand((num_hypotheses, weights.shape[-1]), generator=generator, device=weights.device)
    g = -torch.log(-torch.log(u.clamp(min=torch.finfo(u.dtype).tiny)))
    return torch.topk(logw[None, :] + g, sample_size, dim=-1).indices


def _score(E, x0, x1, valid, threshold, sigmas=(1.0,)):
    """Truncated-quadratic gain and inlier mask of models E [..., 3, 3]. With
    several `sigmas` the gain marginalises the truncation scale (the cheap
    form of MAGSAC's sigma-consensus); the inlier mask stays at the base
    threshold. Returns (gain [...], inlier [..., N], d2 [..., N])."""
    d2 = sampson_distance(x0, x1, E)
    t2 = threshold * threshold
    inlier = (d2 < t2) & valid
    gain = sum(
        torch.sum(torch.where(valid, torch.clamp(1.0 - d2 / (t2 * s * s), min=0.0), 0.0), dim=-1) / s
        for s in sigmas)
    return gain, inlier, d2


def _gather_points(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., N, 2] at the minimal sets idx [..., H, S] -> [..., H, S, 2]."""
    flat = idx.flatten(-2).long()
    return torch.gather(x, -2, flat[..., None].expand(*flat.shape, 2)).view(*idx.shape, 2)


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x [..., K, 3, 3] at the model index i [...] -> [..., 3, 3]."""
    return torch.take_along_dim(x, i[..., None, None, None], dim=-3)[..., 0, :, :]


def essential_ransac_from_samples(idx: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor,
                                  valid: torch.Tensor, threshold, lo_iterations: int = 4,
                                  E_init: torch.Tensor | None = None) -> dict:
    """RANSAC given the minimal sets idx [..., H, S] into x0, x1 [..., N, 2]
    (valid [..., N]; any leading batch shape, one problem per batch entry):
    hypotheses, scores, and LO-RANSAC from the best hypothesis (the first of
    equal gains, as lax.top_k picks) and from `E_init` [..., 3, 3], a finite
    nonzero warm-start model, when given, keeping the best final gain.

    S = 5 solves each set with the five-point solver (up to 10 candidates a
    set, all scored; invalid candidates get gain -inf); S >= 8 with the
    eight-point solver. The local optimisation is IRLS with truncated
    weights and an annealed support threshold: it starts at LO_ANNEAL x
    threshold and shrinks to the threshold by its last iteration; a refit is
    kept only if the gain at the base threshold held and it had 8 supports.
    threshold: a float, or a tensor [...] of one threshold a problem.

    Returns dict(E [..., 3, 3], inliers [..., N] bool, gain, num_inliers)."""
    if isinstance(threshold, torch.Tensor):
        threshold = threshold[..., None, None]   # over (model, point)
    sx0, sx1 = _gather_points(x0, idx), _gather_points(x1, idx)
    xs0, xs1, vs = x0[..., None, :, :], x1[..., None, :, :], valid[..., None, :]
    if idx.shape[-1] == 5:
        Es, ok = solve_essential_5pt(sx0, sx1)                   # [..., H, R, 3, 3], [..., H, R]
        Es, ok = Es.flatten(-4, -3), ok.flatten(-2)
        gains, _, _ = _score(Es, xs0, xs1, vs, threshold, SCORE_SIGMAS)
        gains = torch.where(ok, gains, -torch.inf)
    elif idx.shape[-1] >= 8:
        # project=False: scoring tolerates near-essential candidates; the
        # winner is refined (and projected) by the IRLS loop below
        Es = essential_from_points(sx0, sx1, project=False)       # [..., H, 3, 3]
        gains, _, _ = _score(Es, xs0, xs1, vs, threshold, SCORE_SIGMAS)
    else:
        raise ValueError(f"minimal sets of {idx.shape[-1]} points: want 5 or at least 8")
    E = _pick(Es, torch.argmax(gains, dim=-1))[..., None, :, :]      # [..., 1, 3, 3]
    if E_init is not None:
        E = torch.cat([E, E_init[..., None, :, :].to(E.dtype)], dim=-3)
    g, _, _ = _score(E, xs0, xs1, vs, threshold, SCORE_SIGMAS)
    t2 = threshold * threshold
    for i in range(lo_iterations):
        frac = (lo_iterations - 1.0 - i) / max(lo_iterations - 1.0, 1.0)
        m2 = (1.0 + (LO_ANNEAL - 1.0) * frac) ** 2
        d2 = sampson_distance(xs0, xs1, E)
        w = torch.where((d2 < t2 * m2) & vs, 1.0 / (1.0 + d2 / (t2 * m2)), 0.0)
        n_in = torch.sum(w > 0, dim=-1)
        E_new = essential_from_points(xs0, xs1, weights=w)
        g_new, _, _ = _score(E_new, xs0, xs1, vs, threshold, SCORE_SIGMAS)
        better = (g_new >= g) & (n_in >= 8)
        E = torch.where(better[..., None, None], E_new, E)
        g = torch.where(better, g_new, g)
    E = _pick(E, torch.argmax(g, dim=-1))
    if isinstance(threshold, torch.Tensor):
        threshold = threshold[..., 0]
    gain, inliers, _ = _score(E, x0, x1, valid, threshold, SCORE_SIGMAS)
    return {"E": E, "inliers": inliers, "gain": gain, "num_inliers": torch.sum(inliers, dim=-1)}


def estimate_essential_ransac(generator: torch.Generator, x0: torch.Tensor, x1: torch.Tensor,
                              valid: torch.Tensor, threshold: float, num_hypotheses: int = 1024,
                              sample_size: int = 8, lo_iterations: int = 4,
                              weights: torch.Tensor | None = None,
                              E_init: torch.Tensor | None = None) -> dict:
    """x0, x1: [N, 2] normalized camera coordinates; valid: [N] bool;
    threshold: inlier threshold in normalized coordinates (Sampson);
    generator: a torch.Generator on the points' device.

    weights: optional [N] sampling confidences: minimal sets are then drawn
    in proportion to weight (Gumbel top-k). sample_size=5 solves them with
    the five-point solver, 8 with the eight-point one.

    Returns dict(E [3, 3], inliers [N] bool, gain, num_inliers)."""
    if weights is not None:
        idx = _sample_minimal_sets_weighted(generator, weights, valid, num_hypotheses, sample_size)
    else:
        idx = _sample_minimal_sets(generator, valid, num_hypotheses, sample_size)
    return essential_ransac_from_samples(idx, x0, x1, valid, threshold, lo_iterations=lo_iterations,
                                         E_init=E_init)
