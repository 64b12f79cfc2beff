"""(Weighted) eight-point essential-matrix solver, batched
(impx/ransac/eight_point.py).

The RANSAC loop solves hundreds of hypotheses at once; the winner is refined
by iteratively reweighted least squares on its inliers (ransac.py). No batched
SVD or eigh: inverse iteration on a Cholesky factor, a closed-form polar
factor and a closed-form 3x3 eigenvector, with no host synchronisation.
"""
from __future__ import annotations

import math

import torch


def _design_matrix(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Rows of the epipolar constraint x1hᵀ E x0h = 0 as A @ vec(E) = 0.

    x0, x1: [..., N, 2] normalized camera coordinates. Returns [..., N, 9]:
    [x1*x0, x1*y0, x1, y1*x0, y1*y0, y1, x0, y0, 1].
    """
    x0h = torch.cat([x0, torch.ones_like(x0[..., :1])], dim=-1)
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    return (x1h[..., :, None] * x0h[..., None, :]).reshape(*x0.shape[:-1], 9)


def _smallest_eigvec(M: torch.Tensor, iterations: int = 16) -> torch.Tensor:
    """Smallest eigenvector of a batched symmetric PSD [..., d, d] matrix by
    inverse iteration: one Cholesky factorization of (M + eps·I), then a few
    pairs of triangular solves, from a fixed start (so the sign is fixed).

    A degenerate sample's factorization fails: torch.linalg.cholesky_ex
    reports it in `info` (where JAX returns NaN) and the factor becomes I, as
    impx substitutes it for a non-finite factor. No host synchronisation."""
    d = M.shape[-1]
    eye = torch.eye(d, dtype=M.dtype, device=M.device)
    eps = 1e-6 * torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)[..., None, None] + 1e-12
    L, info = torch.linalg.cholesky_ex(M + eps * eye)
    bad = (info != 0)[..., None, None] | ~torch.isfinite(L).all(dim=-1, keepdim=True).all(dim=-2, keepdim=True)
    L = torch.where(bad, eye, L)
    x = (torch.arange(1.0, d + 1.0, dtype=M.dtype, device=M.device) / d).expand(M.shape[:-1])
    for _ in range(iterations):
        y = torch.linalg.solve_triangular(L, x[..., None], upper=False)
        z = torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]
        x = z / (torch.linalg.norm(z, dim=-1, keepdim=True) + 1e-30)
    return x


def _inv3_scaled(M):
    """(adjugate(M)ᵀ / det pieces: adjᵀ, det) — closed-form 3x3 inverse."""
    a = M

    def c(i0, i1, j0, j1):
        return a[..., i0, j0] * a[..., i1, j1] - a[..., i0, j1] * a[..., i1, j0]

    # cofactor matrix C with C[i,j] = (-1)^{i+j} minor(i,j); inv = Cᵀ / det
    C00, C01, C02 = c(1, 2, 1, 2), -c(1, 2, 0, 2), c(1, 2, 0, 1)
    C10, C11, C12 = -c(0, 2, 1, 2), c(0, 2, 0, 2), -c(0, 2, 0, 1)
    C20, C21, C22 = c(0, 1, 1, 2), -c(0, 1, 0, 2), c(0, 1, 0, 1)
    det = a[..., 0, 0] * C00 + a[..., 0, 1] * C01 + a[..., 0, 2] * C02
    adjT = torch.stack([
        torch.stack([C00, C10, C20], dim=-1),
        torch.stack([C01, C11, C21], dim=-1),
        torch.stack([C02, C12, C22], dim=-1),
    ], dim=-2)
    return adjT, det


def _polar_q(E, iterations: int = 8):
    """Orthogonal polar factor Q of batched 3x3 E by determinant-scaled
    Newton: X <- (g X + X^{-T}/g)/2, g = |det X|^{-1/3}. Closed-form inverse,
    no SVD."""
    X = E / (torch.linalg.matrix_norm(E)[..., None, None] + 1e-20)
    for _ in range(iterations):
        adjT, det = _inv3_scaled(X)
        det = torch.where(torch.abs(det) < 1e-20, 1e-20, det)
        inv_t = adjT.mT / det[..., None, None]
        g = torch.abs(det) ** (-1.0 / 3.0)
        X = 0.5 * (g[..., None, None] * X + inv_t / g[..., None, None])
    return X


def _smallest_eigvec3_sym(S):
    """Smallest eigenvector of batched symmetric 3x3 via the trigonometric
    eigenvalue formula and a cross-product null direction. Closed-form."""
    eye = torch.eye(3, dtype=S.dtype, device=S.device)
    q = torch.diagonal(S, dim1=-2, dim2=-1).sum(-1) / 3.0
    D = S - q[..., None, None] * eye
    p = torch.sqrt(torch.clamp(torch.sum(D * D, dim=(-2, -1)) / 6.0, min=1e-30))
    B = D / p[..., None, None]
    _, detB = _inv3_scaled(B)
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    A = S - lam_min[..., None, None] * eye
    r0, r1, r2 = A[..., 0, :], A[..., 1, :], A[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], dim=-2)          # [..., 3, 3]
    norms = torch.linalg.norm(cands, dim=-1)
    best = torch.argmax(norms, dim=-1)
    v = torch.take_along_dim(cands, best[..., None, None].expand(*best.shape, 1, 3), dim=-2)[..., 0, :]
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-30)


def project_essential(E):
    """Closed-form projection of batched 3x3 matrices onto the essential
    manifold (singular values (s, s, 0), s the mean of the top two): with the
    polar decomposition E = Q·S, the projection is ((tr S − λ3)/2)·Q·(I − v3 v3ᵀ)
    where (λ3, v3) is S's smallest eigenpair. No batched SVD."""
    Q = _polar_q(E)
    S = Q.mT @ E
    S = 0.5 * (S + S.mT)
    v3 = _smallest_eigvec3_sym(S)
    lam3 = torch.einsum("...i,...ij,...j->...", v3, S, v3)
    sbar = 0.5 * (torch.diagonal(S, dim1=-2, dim2=-1).sum(-1) - lam3)
    P = torch.eye(3, dtype=E.dtype, device=E.device) - v3[..., :, None] * v3[..., None, :]
    out = sbar[..., None, None] * (Q @ P)
    # degenerate inputs (det ~ 0 polar failures): keep the unprojected E
    ok = torch.isfinite(out).all(dim=-1, keepdim=True).all(dim=-2, keepdim=True)
    return torch.where(ok, out, E)


def essential_from_points(x0: torch.Tensor, x1: torch.Tensor, weights: torch.Tensor | None = None,
                          project: bool = True) -> torch.Tensor:
    """Least-squares essential matrix from >= 8 correspondences.

    Solves min |W A e| via the smallest eigenvector of Aᵀ W A (inverse
    iteration on a Cholesky factor; _smallest_eigvec), then optionally
    projects onto the essential manifold. Hypothesis generators pass
    project=False: scoring tolerates near-essential candidates.

    x0, x1: [..., N, 2]; weights: [..., N] (zero disables a row, so it
    doubles as the validity mask). Returns [..., 3, 3] of unit norm.
    """
    A = _design_matrix(x0, x1)  # [..., N, 9]
    if weights is not None:
        A = A * weights[..., :, None]
    AtA = A.mT @ A
    e = _smallest_eigvec(AtA)
    E = e.reshape(*e.shape[:-1], 3, 3)
    if project:
        E = project_essential(E)
    # fix scale for numerical comparability
    return E / (torch.linalg.matrix_norm(E)[..., None, None] + 1e-15)
