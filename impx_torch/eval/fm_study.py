"""Fundamental-matrix estimation study: the device F-RANSAC against cv2
MAGSAC (impx/eval/fm_study.py).

Companion to impx_torch.eval.pose_study for the FM-Bench native dependency
(reference components/evaluators.py:216-220 uses cv2.findFundamentalMat
USAC_MAGSAC): synthetic two-view scenes (random pose, 3D points projected
to pixels, Gaussian pixel noise + uniform outliers), both estimators run at
matched thresholds, scored with the FM-Bench metrics of
impx_torch/eval/evaluator.py: the post-RANSAC inlier rate on ground-truth
inliers (symmetric epipolar distance < th, `_fm_inlier_rate`) and the SGD
line distance to the ground-truth F (`_compute_sgd`). The device estimator
is impx_torch/ransac/fundamental.py:estimate_fundamental_ransac, one
torch.Generator a trial seeded with the trial's index (impx's PRNGKey(tr)).

Usage: python -m impx_torch.eval.fm_study [--trials 32] [--fast] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def _scene(rs, n_in, n_out, size=(640, 480), noise_px=1.0):
    """A copy of impx's: (x0, x1 [n, 2] float64 px, is_inlier [n], F_gt, size)."""
    import cv2

    f = 600.0
    K = np.array([[f, 0, size[0] / 2], [0, f, size[1] / 2], [0, 0, 1.0]])
    # random relative pose with bounded rotation + baseline
    rvec = rs.normal(0, 0.15, 3)
    R = cv2.Rodrigues(rvec)[0]
    t = rs.normal(0, 1.0, 3)
    t = t / (np.linalg.norm(t) + 1e-12)

    # 3D points in front of both cameras
    X = np.stack([rs.uniform(-2, 2, n_in * 3), rs.uniform(-1.5, 1.5, n_in * 3),
                  rs.uniform(4, 10, n_in * 3)], 1)
    x0 = (X @ K.T)
    x0 = x0[:, :2] / x0[:, 2:]
    X1 = X @ R.T + t
    ok = X1[:, 2] > 0.1
    x1 = (X1 @ K.T)
    x1 = x1[:, :2] / x1[:, 2:]
    inb = ok & (np.abs(x0[:, 0] - size[0] / 2) < size[0] / 2) & \
        (np.abs(x0[:, 1] - size[1] / 2) < size[1] / 2) & \
        (np.abs(x1[:, 0] - size[0] / 2) < size[0] / 2) & \
        (np.abs(x1[:, 1] - size[1] / 2) < size[1] / 2)
    x0, x1 = x0[inb][:n_in], x1[inb][:n_in]
    n_in = len(x0)

    x0 = x0 + rs.normal(0, noise_px, x0.shape)
    x1 = x1 + rs.normal(0, noise_px, x1.shape)
    # outliers: random pixel pairs
    o0 = np.stack([rs.uniform(0, size[0], n_out), rs.uniform(0, size[1], n_out)], 1)
    o1 = np.stack([rs.uniform(0, size[0], n_out), rs.uniform(0, size[1], n_out)], 1)
    x0 = np.concatenate([x0, o0]).astype(np.float64)
    x1 = np.concatenate([x1, o1]).astype(np.float64)
    is_inlier = np.zeros(len(x0), bool)
    is_inlier[:n_in] = True

    Tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = Tx @ R
    Ki = np.linalg.inv(K)
    F = Ki.T @ E @ Ki
    F = F / (np.linalg.norm(F) + 1e-15)
    return x0, x1, is_inlier, F, size


NOISES, OUTLIER_FRACTIONS = (0.5, 1.0, 2.0), (0.2, 0.5)


def study(trials=32, n_in=250, n_out=250, threshold_px=1.0,
          num_hypotheses=1024, device=None, noises=NOISES, fractions=OUTLIER_FRACTIONS):
    """{(noise, outlier fraction, 'cv2' | 'device'): (GT-inlier %, SGD)}.
    n_out is impx's unused argument (the outliers follow the fraction)."""
    import cv2

    from impx_torch.device import resolve_device
    from impx_torch.eval.evaluator import _compute_sgd, _fm_inlier_rate
    from impx_torch.ransac.fundamental import estimate_fundamental_ransac

    device = resolve_device(device)
    res = {}
    for noise in noises:
        for frac_out in fractions:
            n_o = int(n_in * frac_out / (1 - frac_out))
            rows = {"cv2": [], "device": []}
            for tr in range(trials):
                rs = np.random.RandomState(1000 * tr + int(noise * 10) + n_o)
                x0, x1, is_in, F_gt, size = _scene(rs, n_in, n_o, noise_px=noise)
                # cv2 USAC_MAGSAC (the reference's evaluator call)
                F_cv, _ = cv2.findFundamentalMat(x0, x1, cv2.USAC_MAGSAC, threshold_px, 0.99, num_hypotheses)
                out = estimate_fundamental_ransac(
                    torch.Generator(device).manual_seed(tr),
                    torch.as_tensor(x0, dtype=torch.float32, device=device),
                    torch.as_tensor(x1, dtype=torch.float32, device=device),
                    torch.ones(len(x0), dtype=torch.bool, device=device),
                    threshold_px=threshold_px, num_hypotheses=num_hypotheses)
                F_d = out["F"].double().cpu().numpy()

                for name, F_hat in (("cv2", F_cv), ("device", F_d)):
                    if F_hat is None or F_hat.shape != (3, 3):
                        rows[name].append((0.0, 1.0))
                        continue
                    inl = _fm_inlier_rate(x0[is_in], x1[is_in], size, size, F_hat, threshold_px * 3)
                    sgd = _compute_sgd(F_gt, F_hat, size, size)
                    rows[name].append((float(np.mean(inl)), sgd))
            for name in ("cv2", "device"):
                arr = np.array(rows[name])
                res[(noise, frac_out, name)] = (100 * arr[:, 0].mean(), arr[:, 1].mean())
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=32)
    ap.add_argument("--hypotheses", type=int, default=1024)
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None, help="the device estimator's device (the card unless named)")
    args = ap.parse_args(argv)
    trials = 8 if args.fast else args.trials

    res = study(trials=trials, num_hypotheses=args.hypotheses, device=args.device)
    print(f"\nF-matrix study over {trials} synthetic pairs/cell "
          f"({args.hypotheses} hypotheses, th 1px):")
    print(f"{'noise_px':>9} {'outliers':>9} {'backend':>7}  "
          f"{'GT-inlier %':>11}  {'SGD':>8}")
    for (noise, outl, backend), (inl, sgd) in sorted(res.items()):
        print(f"{noise:>9} {outl:>9} {backend:>7}  {inl:>11.2f}  {sgd:>8.4f}")
    return res


if __name__ == "__main__":
    main()
