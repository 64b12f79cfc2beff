"""Epipolar geometry: E/F construction and point-to-epipolar-line errors
(impx/geometry/epipolar.py).

Torch versions of the batched functions, and a verbatim numpy copy of
`compute_epi_inlier_np` for the host-side eval loops.
"""
from __future__ import annotations

import numpy as np
import torch


def skew_symmetric(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    zero = torch.zeros_like(v[..., 0])
    rows = [
        torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def essential_from_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """E = [t]_x R from relative pose (0 -> 1). R [..., 3, 3], t [..., 3]."""
    return skew_symmetric(t) @ R


def fundamental_from_essential(E, K0, K1):
    """F = K1^-T E K0^-1."""
    return torch.linalg.inv(K1).mT @ E @ torch.linalg.inv(K0)


def _to_h(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def epipolar_distance(x0, x1, E):
    """Symmetric-normalized epipolar distance of the eval protocol:
    |x1^T E x0| * mean(1/|l1|, 1/|l0|).

    x0, x1: [..., N, 2] in *normalized camera* coordinates; E [..., 3, 3].
    """
    x0h = _to_h(x0)
    x1h = _to_h(x1)
    l1 = x0h @ E.mT  # epipolar line of x0 in image 1
    l0 = x1h @ E
    norm = (
        1.0 / torch.sqrt(torch.sum(l1[..., :2] ** 2, dim=-1) + 1e-15)
        + 1.0 / torch.sqrt(torch.sum(l0[..., :2] ** 2, dim=-1) + 1e-15)
    ) / 2.0
    return torch.abs(torch.sum(l1 * x1h, dim=-1)) * norm


def compute_epi_inlier(x0, x1, E, inlier_th, return_error: bool = False):
    dis = epipolar_distance(x0, x1, E)
    mask = dis < inlier_th
    if return_error:
        return mask, dis
    return mask


def compute_epi_inlier_np(x0, x1, E, inlier_th, return_error: bool = False):
    """Numpy twin of compute_epi_inlier for host-side eval loops."""
    x0 = np.asarray(x0, np.float64)
    x1 = np.asarray(x1, np.float64)
    E = np.asarray(E, np.float64)
    x0h = np.concatenate([x0, np.ones_like(x0[:, :1])], axis=-1)
    x1h = np.concatenate([x1, np.ones_like(x1[:, :1])], axis=-1)
    l1 = x0h @ E.T
    l0 = x1h @ E
    norm = (1.0 / np.sqrt((l1[:, :2] ** 2).sum(1) + 1e-15)
            + 1.0 / np.sqrt((l0[:, :2] ** 2).sum(1) + 1e-15)) / 2.0
    dis = np.abs((l1 * x1h).sum(-1)) * norm
    mask = dis < inlier_th
    if return_error:
        return mask, dis
    return mask


def pairwise_epipolar_distance(x0, x1, E):
    """All-pairs symmetric-normalized epipolar distance: `epipolar_distance`
    over every (i, j) keypoint combination, the weighting matrix of the
    geometry-supervised training loss.

    x0 [..., N, 2], x1 [..., M, 2] in normalized camera coordinates;
    E [..., 3, 3] with x1ᵀ E x0 = 0. Returns [..., N, M].
    """
    x0h = _to_h(x0)
    x1h = _to_h(x1)
    l1 = x0h @ E.mT  # [..., N, 3] epipolar lines in image 1
    l0 = x1h @ E     # [..., M, 3] epipolar lines in image 0
    s = l1 @ x1h.mT  # [..., N, M]: x1h_j . (E x0h_i)
    n1 = 1.0 / torch.sqrt(torch.sum(l1[..., :2] ** 2, dim=-1) + 1e-15)  # [..., N]
    n0 = 1.0 / torch.sqrt(torch.sum(l0[..., :2] ** 2, dim=-1) + 1e-15)  # [..., M]
    return torch.abs(s) * (n1[..., :, None] + n0[..., None, :]) / 2.0


def normalize_by_intrinsics(kpts, K):
    """Pixel keypoints [..., N, 2] -> normalized camera coordinates via
    K^-1 (zero-skew pinhole: subtract principal point, divide by focal)."""
    f = torch.stack([K[..., 0, 0], K[..., 1, 1]], dim=-1)  # [..., 2]
    c = torch.stack([K[..., 0, 2], K[..., 1, 2]], dim=-1)
    return (kpts - c[..., None, :]) / f[..., None, :]


def sampson_distance(x0, x1, E):
    """Squared Sampson distance (first-order geometric error).

    x0, x1: [..., N, 2] normalized coordinates; E [..., 3, 3].
    """
    x0h = _to_h(x0)
    x1h = _to_h(x1)
    Ex0 = x0h @ E.mT  # [..., N, 3]
    Etx1 = x1h @ E
    num = torch.sum(x1h * Ex0, dim=-1) ** 2
    den = Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2
    return num / (den + 1e-15)
