"""Small geometry utilities (impx/geometry/misc.py; reference
components/utils/data_utils.py, train_utils.py, tools/geometry.py:470-481).

`norm_kpt`, `unnorm_kp`, `normalize_points_3d` and `denormalize_points_3d`
are torch versions of impx's jnp functions; `interpolate_depth`,
`get_rnd_homography` and `rotation_matrix_to_euler_angles` are numpy in impx
and copies here.
"""
from __future__ import annotations

import numpy as np
import torch


def norm_kpt(K, kp):
    """Pixel -> normalised camera coordinates via K^-1 (data_utils.py:4-7)."""
    K = torch.as_tensor(K, dtype=kp.dtype, device=kp.device)
    kph = torch.cat([kp, torch.ones_like(kp[..., :1])], dim=-1)
    return (kph @ torch.linalg.inv(K).T)[..., :2]


def unnorm_kp(K, kp):
    """Normalised camera -> pixel coordinates (data_utils.py:10-13)."""
    K = torch.as_tensor(K, dtype=kp.dtype, device=kp.device)
    kph = torch.cat([kp, torch.ones_like(kp[..., :1])], dim=-1)
    return (kph @ K.T)[..., :2]


def interpolate_depth(pos, depth):
    """Bilinear depth lookup at (y, x) positions, rejecting zero-depth corners
    (data_utils.py:16-...). Returns (depth_values [M], valid_ids [M])."""
    pos = np.asarray(pos, np.float64)
    depth = np.asarray(depth)
    h, w = depth.shape
    ids = np.arange(pos.shape[0])
    i, j = pos[:, 0], pos[:, 1]
    ok = (i > 0) & (i < h - 1) & (j > 0) & (j < w - 1)
    i, j, ids = i[ok], j[ok], ids[ok]
    i0, j0 = np.floor(i).astype(int), np.floor(j).astype(int)
    i1, j1 = np.ceil(i).astype(int), np.ceil(j).astype(int)
    d00, d01 = depth[i0, j0], depth[i0, j1]
    d10, d11 = depth[i1, j0], depth[i1, j1]
    valid = (d00 > 0) & (d01 > 0) & (d10 > 0) & (d11 > 0)
    i, j, ids = i[valid], j[valid], ids[valid]
    d00, d01, d10, d11 = d00[valid], d01[valid], d10[valid], d11[valid]
    wi = i - np.floor(i)
    wj = j - np.floor(j)
    d = ((1 - wi) * (1 - wj) * d00 + (1 - wi) * wj * d01
         + wi * (1 - wj) * d10 + wi * wj * d11)
    return d, ids


def get_rnd_homography(rs, batch_size: int, pert_ratio: float = 0.25):
    """Random perspective-perturbation homographies over the [-1,1] square
    (train_utils.py:37-47), solved with numpy DLT (no OpenCV needed)."""
    corners = np.array([[-1, 1], [1, 1], [-1, -1], [1, -1]], np.float64)
    out = []
    for _ in range(batch_size):
        pert = corners + rs.uniform(-2 * pert_ratio, 2 * pert_ratio, (4, 2))
        A = []
        for (x, y), (u, v) in zip(corners, pert):
            A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
            A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
        _, _, vt = np.linalg.svd(np.asarray(A))
        H = vt[-1].reshape(3, 3)
        out.append(H / H[2, 2])
    return np.stack(out)


def rotation_matrix_to_euler_angles(R):
    """(x, y, z) Euler angles in degrees (tools/geometry.py:470-481)."""
    R = np.asarray(R)
    sy = np.sqrt(R[0, 0] ** 2 + R[1, 0] ** 2)
    if sy >= 1e-6:
        x = np.arctan2(R[2, 1], R[2, 2])
        y = np.arctan2(-R[2, 0], sy)
        z = np.arctan2(R[1, 0], R[0, 0])
    else:
        x = np.arctan2(-R[1, 2], R[1, 1])
        y = np.arctan2(-R[2, 0], sy)
        z = 0.0
    return np.rad2deg(np.array([x, y, z]))


def normalize_points_3d(x, scale: float = 1.0):
    """(dataset/utils.py:22-28)."""
    max_x = torch.amax(torch.abs(x), dim=0)
    return x / (max_x * scale) - 0.5


def denormalize_points_3d(x, max_x, scale: float = 1.0):
    return (x + 0.5) * (max_x * scale)
