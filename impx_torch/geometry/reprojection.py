"""Depth-based reprojection and ground-truth match labelling
(impx/geometry/reprojection.py), on tensors of the caller's device.

`reproject_points` (reference tools/geometry.py:53-89: the COLMAP +0.5
pixel-centre convention, optional crop boxes) and
`match_from_projection_points` (geometry.py:239-280: the nearest reprojection
within inlier_th is a match, one beyond outlier_th a certain non-match, an
optional cycle check). The MegaDepth dump runs them on the card. Inputs are
float32, as impx runs them without x64, the 4x4 inverse included.
"""
from __future__ import annotations

import torch


def reproject_points(pos1, depth1, K1, pose1, K2, pose2, bbox1=None, bbox2=None):
    """pos1 [N, 2] (x, y) pixels in image 1 with depth [N] -> projected
    pixels [N, 2] in image 2. pose* are world->cam 4x4."""
    if bbox1 is not None:
        u1 = pos1[:, 0] + bbox1[1] + 0.5
        v1 = pos1[:, 1] + bbox1[0] + 0.5
    else:
        u1 = pos1[:, 0] + 0.5
        v1 = pos1[:, 1] + 0.5
    Z1 = depth1
    X1 = (u1 - K1[0, 2]) * (Z1 / K1[0, 0])
    Y1 = (v1 - K1[1, 2]) * (Z1 / K1[1, 1])
    XYZ1 = torch.stack([X1, Y1, Z1, torch.ones_like(Z1)], dim=0)   # [4, N]

    P = pose2 @ torch.linalg.inv(pose1)
    XYZ2h = P @ XYZ1
    XYZ2 = XYZ2h[:3] / (XYZ2h[3:4] + 1e-5)
    uv2h = K2 @ XYZ2
    uv2 = uv2h[:2] / (uv2h[2:3] + 1e-5)
    if bbox2 is not None:
        u2 = uv2[0] - bbox2[1] - 0.5
        v2 = uv2[1] - bbox2[0] - 0.5
    else:
        u2 = uv2[0] - 0.5
        v2 = uv2[1] - 0.5
    return torch.stack([u2, v2], dim=1)                              # [N, 2]


def match_from_projection_points(pos1, depth1, K1, pose1, pos2, depth2, K2, pose2,
                                 inlier_th: float = 3.0, outlier_th: float = 5.0,
                                 cycle_check: bool = True, valid1=None, valid2=None):
    """Ground-truth correspondences by depth reprojection with a cycle check.

    Returns (matches12 [N] int32: an index into pos2 or -1; is_outlier [N]
    bool: reprojects >= outlier_th from every keypoint). Fixed shapes:
    callers filter with the masks."""
    proj12 = reproject_points(pos1, depth1, K1, pose1, K2, pose2)
    d = torch.linalg.vector_norm(proj12[:, None, :] - pos2[None, :, :], dim=-1)   # [N, M]
    if valid2 is not None:
        d = torch.where(valid2[None, :], d, torch.full((), float("inf"), device=d.device))
    errors12, matches12 = torch.min(d, dim=1)

    inlier = errors12 <= inlier_th
    outlier = errors12 >= outlier_th
    if valid1 is not None:
        inlier = inlier & valid1
        outlier = outlier & valid1

    if cycle_check:
        proj21 = reproject_points(pos2[matches12], depth2[matches12], K2, pose2, K1, pose1)
        err21 = torch.linalg.vector_norm(proj21 - pos1, dim=-1)
        inlier = inlier & (err21 <= inlier_th)

    minus_one = torch.full((), -1, dtype=matches12.dtype, device=matches12.device)
    return torch.where(inlier, matches12, minus_one).to(torch.int32), outlier
