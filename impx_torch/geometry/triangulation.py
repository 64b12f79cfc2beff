"""Triangulation, essential-matrix decomposition, cheirality
(impx/geometry/triangulation.py): closed-form SVD decomposition and batched
DLT triangulation, so the pose pipeline runs on the device.

JAX's `vmap` over points and over the four pose hypotheses becomes a leading
batch axis: the hypotheses are stacked [4, ...] and scored in one pass.
"""
from __future__ import annotations

import torch

from impx_torch.geometry.epipolar import skew_symmetric


def triangulate_points(P0, P1, x0, x1):
    """DLT triangulation (cv2.triangulatePoints semantics).

    P0, P1: [..., 3, 4] projection matrices; x0, x1: [..., N, 2] points.
    Returns [..., N, 4] homogeneous points (the smallest eigenvector of AᵀA for each
    point's 4x4 design matrix A, by inverse iteration)."""
    from impx_torch.ransac.eight_point import _smallest_eigvec

    def rows(x, P):  # [..., N, 2, 4]: x * P[2] - P[:2]
        return x[..., None] * P[..., None, 2:3, :] - P[..., None, :2, :]

    A = torch.cat(torch.broadcast_tensors(rows(x0, P0), rows(x1, P1)), dim=-2)  # [..., N, 4, 4]
    return _smallest_eigvec(A.mT @ A)


def two_ray_depths(R, t, x0, x1):
    """Closed-form per-point depths (z0 in cam0, z1 in cam1): the least-
    squares solution of  z0 * (R x0h) - z1 * x1h + t = 0  via Cramer on the
    2x2 normal equations. Exact enough for cheirality everywhere except
    parallel rays, where depths blow up and the distance threshold rejects
    the point, as DLT does at infinity.

    R [..., 3, 3], t [..., 3]; x0, x1: [..., N, 2] normalized camera coords.
    Returns (z0, z1) [..., N]."""
    x0h = torch.cat([x0, torch.ones_like(x0[..., :1])], dim=-1)
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    u = x0h @ R.mT                      # ray of x0 rotated into cam1
    v = x1h
    uu = torch.sum(u * u, -1)
    vv = torch.sum(v * v, -1)
    uv = torch.sum(u * v, -1)
    ut = (u @ t[..., :, None])[..., 0]
    vt = (v @ t[..., :, None])[..., 0]
    det = uv * uv - uu * vv             # <= 0; ~0 only for parallel rays
    det = torch.where(torch.abs(det) < 1e-20, -1e-20, det)
    z0 = (ut * vv - uv * vt) / det
    z1 = (uv * ut - uu * vt) / det
    return z0, z1


def cheirality_mask_fast(R, t, x0, x1, distance_thresh: float = 1000.0, valid=None):
    """cheirality_mask semantics (positive, finite depths in both cameras)
    from the closed-form two-ray depths: no triangulation chain."""
    z0, z1 = two_ray_depths(R, t, x0, x1)
    mask = (z0 > 0) & (z0 < distance_thresh) & (z1 > 0) & (z1 < distance_thresh)
    if valid is not None:
        mask = mask & valid
    return mask


def cheirality_mask(pts4d, P, distance_thresh: float = 1000.0, valid=None):
    """Positive-depth / finite-distance mask for triangulated points
    pts4d [..., N, 4] under P [..., 3, 4]: depth in cam0 positive and below
    the threshold, and reprojected depth in cam1 positive and below it."""
    Q = pts4d
    w = Q[..., 3]
    mask = (Q[..., 2] * w) > 0
    z0 = Q[..., 2] / torch.where(w == 0, 1e-15, w)
    mask = mask & (z0 < distance_thresh)
    Qn = Q / torch.where(w == 0, 1e-15, w)[..., None]
    z1 = (Qn @ P.mT)[..., 2]
    mask = mask & (z1 > 0) & (z1 < distance_thresh)
    if valid is not None:
        mask = mask & valid
    return mask


def decompose_E(E, svd: bool = True):
    """E -> (R1, R2, t) candidates (cv2.decomposeEssentialMat semantics).

    SVD sign conventions differ between libraries: a flip of the first two
    singular pairs swaps R1 and R2 and may negate t, so the four hypotheses
    (R1, R2) x (t, -t) are the same set, in another order.

    svd=False: the same set in closed form, for an essential E (singular
    values (s, s, 0), as every model of the RANSAC is), with no SVD (whose
    convergence check synchronises the host with the device): E is scaled to
    singular values (1, 1, 0); t is its left null vector, the smallest
    eigenvector of E·Eᵀ; and with E = [t]x R, cof(E) = t tᵀ R, so
    R = cof(E) − [t]x E and its twist R' = cof(E) + [t]x E (the rotation by
    pi about t)."""
    if not svd:
        from impx_torch.ransac.eight_point import _inv3_scaled, _smallest_eigvec3_sym

        En = E * (2.0 ** 0.5 / (torch.linalg.matrix_norm(E)[..., None, None] + 1e-30))
        t = _smallest_eigvec3_sym(En @ En.mT)
        cof = _inv3_scaled(En)[0].mT          # the cofactor matrix: adjugate transposed
        tE = skew_symmetric(t) @ En
        return cof - tE, cof + tE, t
    U, _, Vt = torch.linalg.svd(E)
    # enforce proper rotations
    U = U * torch.sign(torch.linalg.det(U))[..., None, None]
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    return R1, R2, t


def projection(R, t):
    """[R | t]: [..., 3, 4]."""
    return torch.cat([R, t[..., :, None]], dim=-1)


def decompose_essential_mat(E, x0, x1, distance_thresh: float = 1000.0, valid=None,
                            fast: bool = True, svd: bool = True):
    """Pick the (R, t) among {R1, R2} x {t, -t} with the most cheirality
    inliers.

    E [..., 3, 3]; x0, x1: [..., N, 2] *normalized camera* coordinates, one
    problem per leading batch entry. Returns (R, t, mask, n_good). No
    data-dependent control flow: all four hypotheses are scored and the first
    with the most inliers wins (argmax returns the first maximum, the
    preference order good1 >= good2 >= good3 >= good4).

    fast=True uses the closed-form two-ray depths for the cheirality test
    (cheirality_mask_fast); fast=False the DLT triangulation of
    cv2.triangulatePoints. svd: see decompose_E."""
    R1, R2, t = decompose_E(E, svd=svd)
    Rs = torch.stack([R1, R2, R1, R2])
    ts = torch.stack([t, t, -t, -t])
    if fast:
        masks = cheirality_mask_fast(Rs, ts, x0, x1, distance_thresh, valid=valid)
    else:
        eye = torch.eye(3, dtype=E.dtype, device=E.device)
        P0 = projection(eye, torch.zeros(3, dtype=E.dtype, device=E.device))
        P = projection(Rs, ts)
        masks = cheirality_mask(triangulate_points(P0, P, x0, x1), P, distance_thresh, valid=valid)
    goods = masks.sum(dim=-1)                      # [4, ...]
    best = torch.argmax(goods, dim=0)              # [...]

    def pick(x):
        return torch.take_along_dim(x, best.view(1, *best.shape, *[1] * (x.dim() - 1 - best.dim())), dim=0)[0]

    return pick(Rs), pick(ts), pick(masks), pick(goods)
