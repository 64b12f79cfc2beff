"""Synthetic relative-pose accuracy study: the device RANSAC (five- and
eight-point minimal sets) against OpenCV's USAC_MAGSAC (impx/eval/pose_study.py).

The reference's headline pose AUC rides on cv2.findEssentialMat(USAC_MAGSAC)
(reference eval/pose_estimation.py:96-105). This study holds the on-device
backend (impx_torch/ransac/pose_solver.py:estimate_pose_device) against it
on a controlled protocol: random poses, 3D points projected into two
cameras, Gaussian pixel noise, uniform outliers, across noise and outlier
grids with matched hypothesis budgets, reporting pose AUC@5/10/20 as the
YFCC protocol does. Backends: 'cv2', 'torch8' and 'torch5' (impx's 'jax8'
and 'jax5'); a backend's draws come from one torch.Generator on the device,
seeded once.

CLI: python -m impx_torch.eval.pose_study [--trials 100] [--n 500] [--fast] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

FOCAL = 500.0
SIZE = 1000.0
BACKENDS = ("cv2", "torch8", "torch5")


def synth_pair(rs: np.random.RandomState, n: int, noise_px: float,
               outlier_ratio: float):
    """Random pose + 3D scene -> pixel matches with noise and outliers.
    Returns (kpts0, kpts1 [N,2] px, K, R_gt, t_gt). A copy of impx's."""
    aa = rs.randn(3) * 0.4
    th = np.linalg.norm(aa)
    k = aa / max(th, 1e-9)
    K_ = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * K_ + (1 - np.cos(th)) * K_ @ K_
    t = rs.randn(3)
    t /= np.linalg.norm(t)

    P = rs.randn(n, 3) * np.array([2.0, 2.0, 1.0]) + np.array([0, 0, 6.0])
    x0 = P[:, :2] / P[:, 2:]
    Pc = P @ R.T + t
    x1 = Pc[:, :2] / Pc[:, 2:]

    K = np.array([[FOCAL, 0, SIZE / 2], [0, FOCAL, SIZE / 2], [0, 0, 1.0]])
    k0 = x0 * FOCAL + SIZE / 2
    k1 = x1 * FOCAL + SIZE / 2
    k0 += rs.randn(n, 2) * noise_px
    k1 += rs.randn(n, 2) * noise_px

    n_out = int(n * outlier_ratio)
    if n_out:
        idx = rs.choice(n, n_out, replace=False)
        k1[idx] = rs.rand(n_out, 2) * SIZE  # random wrong partners
    return k0.astype(np.float32), k1.astype(np.float32), K, R, t


def pose_err(R_gt, t_gt, R, t):
    """max(rotation, translation) angular error in degrees (reference
    tools/utils.py:425-443). A copy of impx's."""
    if R is None:
        return np.inf
    cos = (np.trace(R_gt.T @ R) - 1) / 2
    e_r = np.rad2deg(np.arccos(np.clip(cos, -1, 1)))
    c = np.dot(t_gt, t) / (np.linalg.norm(t_gt) * np.linalg.norm(t) + 1e-15)
    e_t = np.rad2deg(np.arccos(np.clip(abs(c), -1, 1)))
    return max(e_r, e_t)


def run_backend(backend, pairs, threshold_px=1.0, num_hypotheses=1024, device=None, seed: int = 0):
    """backend: 'cv2' | 'torch8' | 'torch5'. Returns the list of pose errors.
    The device backends run on `device` (the card unless named) from one
    generator seeded with `seed`."""
    from impx_torch.ransac.pose_solver import _norm_threshold, estimate_pose_cv2, estimate_pose_device, normalize_pts

    errors = []
    if backend == "cv2":
        for k0, k1, K, R_gt, t_gt in pairs:
            ret = estimate_pose_cv2(k0, k1, K, K, _norm_threshold(threshold_px, K, K))
            errors.append(pose_err(R_gt, t_gt, None if ret is None else ret[1], None if ret is None else ret[2]))
        return errors
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of {BACKENDS})")

    from impx_torch.device import resolve_device

    device = resolve_device(device)
    generator = torch.Generator(device).manual_seed(seed)
    sample_size = 5 if backend == "torch5" else 8
    for k0, k1, K, R_gt, t_gt in pairs:
        x0n = torch.as_tensor(normalize_pts(k0, K), dtype=torch.float32, device=device)
        x1n = torch.as_tensor(normalize_pts(k1, K), dtype=torch.float32, device=device)
        valid = torch.ones(len(k0), dtype=torch.bool, device=device)
        out = estimate_pose_device(generator, x0n, x1n, valid, _norm_threshold(threshold_px, K, K),
                                   num_hypotheses=num_hypotheses, sample_size=sample_size)
        errors.append(pose_err(R_gt, t_gt, out["R"].double().cpu().numpy(), out["t"].double().cpu().numpy()))
    return errors


def pose_auc(errors, thresholds=(5, 10, 20)):
    from impx_torch.geometry.pose import pose_auc as _auc

    return [100 * a for a in _auc(errors, list(thresholds))]


def study(trials=50, n=500, noises=(0.5, 1.0, 2.0), outliers=(0.2, 0.5),
          backends=BACKENDS, num_hypotheses=1024, seed=0, device=None):
    """Returns {(noise, outlier, backend): auc@[5,10,20]}."""
    results = {}
    for noise in noises:
        for outl in outliers:
            rs = np.random.RandomState(seed)
            pairs = [synth_pair(rs, n, noise, outl) for _ in range(trials)]
            for backend in backends:
                errs = run_backend(backend, pairs, num_hypotheses=num_hypotheses, device=device)
                results[(noise, outl, backend)] = pose_auc(errs)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=100)
    ap.add_argument("--n", type=int, default=500)
    ap.add_argument("--hypotheses", type=int, default=1024)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None, help="the device backends' device (the card unless named)")
    args = ap.parse_args(argv)
    trials = 20 if args.fast else args.trials

    res = study(trials=trials, n=args.n, num_hypotheses=args.hypotheses, device=args.device)
    print(f"\nPose AUC@5/10/20 over {trials} synthetic pairs "
          f"(N={args.n}, {args.hypotheses} hypotheses):")
    print(f"{'noise_px':>9} {'outliers':>9} {'backend':>7}  AUC@5   AUC@10  AUC@20")
    for (noise, outl, backend), aucs in sorted(res.items()):
        print(f"{noise:>9} {outl:>9} {backend:>7}  "
              f"{aucs[0]:6.2f}  {aucs[1]:6.2f}  {aucs[2]:6.2f}")
    return res


if __name__ == "__main__":
    main()
