"""Pose errors and pose AUC (impx/geometry/pose.py).

Rotation and translation errors as torch functions (usable on the device);
their numpy twins and the AUC aggregation are verbatim numpy copies, run on
the host once per pair or per eval.
"""
from __future__ import annotations

import numpy as np
import torch


def quaternion_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) from a rotation matrix [..., 3, 3]: the
    eigenvector of the largest eigenvalue of the symmetric 4x4 K. Its sign is
    arbitrary; consumers square the dot product."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    a = m01 + m10
    b = m02 + m20
    c = m12 + m21
    d = m21 - m12
    e = m02 - m20
    f = m10 - m01
    K = torch.stack(
        [
            torch.stack([m00 - m11 - m22, a, b, d], dim=-1),
            torch.stack([a, m11 - m00 - m22, c, e], dim=-1),
            torch.stack([b, c, m22 - m00 - m11, f], dim=-1),
            torch.stack([d, e, f, m00 + m11 + m22], dim=-1),
        ],
        dim=-2,
    ) / 3.0
    _, V = torch.linalg.eigh(K)
    q = V[..., :, -1]  # eigenvector of the largest eigenvalue: (x, y, z, w)
    return torch.stack([q[..., 3], q[..., 0], q[..., 1], q[..., 2]], dim=-1)


def evaluate_R_t(R_gt, t_gt, R, t, eps: float = 1e-15):
    """(rotation_err_deg, translation_err_deg) via quaternion / vector angles."""
    t = torch.reshape(t, (-1,))
    t_gt = torch.reshape(t_gt, (-1,))
    q = quaternion_from_matrix(R)
    q_gt = quaternion_from_matrix(R_gt)
    q = q / (torch.linalg.norm(q) + eps)
    q_gt = q_gt / (torch.linalg.norm(q_gt) + eps)
    loss_q = torch.clamp(1.0 - torch.sum(q * q_gt) ** 2, min=eps)
    err_q = torch.arccos(1.0 - 2.0 * loss_q)

    t = t / (torch.linalg.norm(t) + eps)
    t_gt = t_gt / (torch.linalg.norm(t_gt) + eps)
    loss_t = torch.clamp(1.0 - torch.sum(t * t_gt) ** 2, min=eps)
    err_t = torch.arccos(torch.sqrt(1.0 - loss_t))
    return torch.rad2deg(err_q), torch.rad2deg(err_t)


def angle_error_mat(R1, R2):
    cos = (torch.trace(R1.T @ R2) - 1.0) / 2.0
    cos = torch.clamp(cos, -1.0, 1.0)
    return torch.rad2deg(torch.abs(torch.arccos(cos)))


def angle_error_vec(v1, v2):
    n = torch.linalg.norm(v1) * torch.linalg.norm(v2)
    return torch.rad2deg(torch.arccos(torch.clamp(torch.dot(v1, v2) / (n + 1e-15), -1.0, 1.0)))


def compute_pose_error(T_0to1, R, t):
    """(error_t, error_R) in degrees; translation has the +-t ambiguity folded
    in (min(err, 180 - err))."""
    R_gt = T_0to1[:3, :3]
    t_gt = T_0to1[:3, 3]
    error_t = angle_error_vec(t, t_gt)
    error_t = torch.minimum(error_t, 180.0 - error_t)
    error_R = angle_error_mat(R, R_gt)
    return error_t, error_R


def quaternion_from_matrix_np(R):
    """Numpy twin of quaternion_from_matrix for host-side eval loops."""
    R = np.asarray(R, np.float64)
    m00, m01, m02 = R[0]
    m10, m11, m12 = R[1]
    m20, m21, m22 = R[2]
    K = np.array([
        [m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12],
        [m01 + m10, m11 - m00 - m22, m12 + m21, m02 - m20],
        [m02 + m20, m12 + m21, m22 - m00 - m11, m10 - m01],
        [m21 - m12, m02 - m20, m10 - m01, m00 + m11 + m22],
    ]) / 3.0
    w, V = np.linalg.eigh(K)
    q = V[:, -1]
    return np.array([q[3], q[0], q[1], q[2]])


def evaluate_R_t_np(R_gt, t_gt, R, t, eps: float = 1e-15):
    """Numpy twin of evaluate_R_t."""
    t = np.asarray(t, np.float64).ravel()
    t_gt = np.asarray(t_gt, np.float64).ravel()
    q = quaternion_from_matrix_np(R)
    q_gt = quaternion_from_matrix_np(R_gt)
    q = q / (np.linalg.norm(q) + eps)
    q_gt = q_gt / (np.linalg.norm(q_gt) + eps)
    loss_q = max(eps, 1.0 - float(np.sum(q * q_gt)) ** 2)
    err_q = np.arccos(1.0 - 2.0 * loss_q)
    t = t / (np.linalg.norm(t) + eps)
    t_gt = t_gt / (np.linalg.norm(t_gt) + eps)
    loss_t = max(eps, 1.0 - float(np.sum(t * t_gt)) ** 2)
    err_t = np.arccos(np.sqrt(1.0 - loss_t))
    return np.rad2deg(err_q), np.rad2deg(err_t)


def compute_pose_error_np(T_0to1, R, t):
    """Numpy twin of compute_pose_error."""
    T = np.asarray(T_0to1, np.float64)
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64).ravel()
    R_gt, t_gt = T[:3, :3], T[:3, 3]
    n = np.linalg.norm(t) * np.linalg.norm(t_gt)
    error_t = np.rad2deg(np.arccos(np.clip(np.dot(t, t_gt) / (n + 1e-15), -1, 1)))
    error_t = min(error_t, 180.0 - error_t)
    cos = np.clip((np.trace(R.T @ R_gt) - 1.0) / 2.0, -1.0, 1.0)
    error_R = np.rad2deg(np.abs(np.arccos(cos)))
    return error_t, error_R


def pose_auc(errors, thresholds):
    """Exact AUC of the recall/error curve at each threshold. Host-side numpy."""
    errors = np.sort(np.asarray(errors, dtype=np.float64))
    recall = (np.arange(len(errors)) + 1) / len(errors)
    errors = np.r_[0.0, errors]
    recall = np.r_[0.0, recall]
    trapz = getattr(np, "trapezoid", None) or np.trapz
    aucs = []
    for t in thresholds:
        last_index = np.searchsorted(errors, t)
        r = np.r_[recall[:last_index], recall[last_index - 1]]
        e = np.r_[errors[:last_index], t]
        aucs.append(trapz(r, x=e) / t)
    return aucs


def approx_pose_auc(errors, thresholds):
    """Histogram-cumsum approximation of the pose AUC."""
    qt_acc_hist, _ = np.histogram(errors, thresholds)
    num_pair = float(len(errors))
    qt_acc_hist = qt_acc_hist.astype(float) / num_pair
    qt_acc = np.cumsum(qt_acc_hist)
    return [np.mean(qt_acc[:i]) for i in range(1, len(thresholds))]
