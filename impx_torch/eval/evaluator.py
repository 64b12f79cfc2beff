"""Pose-AUC and fundamental-matrix evaluators (impx/eval/evaluator.py).

`AucEval`: pose from matched points (cv2 USAC_MAGSAC on the host, or the
device backend), cheirality-checked; pose error against the ground truth by
quaternion angles; epipolar-inlier precision and matching score; exact and
approximate AUC at 5..30 degrees. `FMBenchEval`: the fundamental-matrix
benchmark, F by cv2 USAC_MAGSAC on the host or (f_backend 'device', or
impx's name 'jax') by `ransac/fundamental.py` on the evaluator's device.

pose_backend: 'cv2' (the published protocol, host) or 'device'
(`estimate_pose_device` on the evaluator's device; 'jax', impx's name for it,
is a synonym, so that impx's config files work). Each pair draws from its
own generator, seeded from (seed, pair index), so a pair's pose does not
depend on the order in which threads or batches reach it.
"""
from __future__ import annotations

import numpy as np
import torch

from impx_torch import geometry as G
from impx_torch.device import resolve_device
from impx_torch.geometry.epipolar import compute_epi_inlier_np
from impx_torch.geometry.pose import evaluate_R_t_np

POSE_BACKENDS = {"cv2": "cv2", "device": "device", "jax": "device"}


def pose_backend(name: str, option: str = "pose_backend") -> str:
    """'cv2' or 'device' ('jax' is read as 'device'); raises on other names,
    naming `option`."""
    if name not in POSE_BACKENDS:
        raise ValueError(f"unknown {option} {name!r} (expected one of {sorted(POSE_BACKENDS)})")
    return POSE_BACKENDS[name]


def pair_generator(device: torch.device, seed: int, index: int) -> torch.Generator:
    """The generator of pair `index`: seeded from (seed, index) alone."""
    return torch.Generator(device=device).manual_seed(seed * 2**32 + index)


def device_pose(corr_n0, corr_n1, norm_thresh: float, device: torch.device,
                generator: torch.Generator):
    """(R, t) as numpy from `estimate_pose_device` on normalized matched
    points [n, 2] (numpy), on `device`."""
    from impx_torch.ransac.pose_solver import estimate_pose_device

    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    n = len(corr_n0)
    out = estimate_pose_device(generator, as_t(corr_n0), as_t(corr_n1),
                               torch.ones((n,), dtype=torch.bool, device=device), norm_thresh)
    return out["R"].cpu().numpy(), out["t"].cpu().numpy()


class AucEval:
    """config: inlier_th, and optionally pose_backend ('cv2' by default) and
    seed (0). device: where the device backend runs; the CUDA device unless
    named (raises without one)."""

    def __init__(self, config: dict, device: str | torch.device | None = None):
        self.config = config
        self.backend = pose_backend(config.get("pose_backend", "cv2"))
        self.device = resolve_device(device) if self.backend == "device" else None
        self.seed = config.get("seed", 0)
        self.err_r, self.err_t, self.err = [], [], []
        self.ms, self.precision = [], []

    def run(self, info: dict, th: float = 1.0) -> dict:
        """info: e, r_gt, t_gt, K1, K2, corr1/corr2 (matched pixel coordinates),
        n_kpts1, and index (the pair's index, which seeds its generator)."""
        E, r_gt, t_gt = info["e"], info["r_gt"], info["t_gt"]
        K1, K2 = info["K1"], info["K2"]
        corr1, corr2 = info["corr1"], info["corr2"]
        n_kpts1 = info["n_kpts1"]

        norm1 = (corr1 - np.asarray(K1)[:2, 2]) / np.array([K1[0][0], K1[1][1]])
        norm2 = (corr2 - np.asarray(K2)[:2, 2]) / np.array([K2[0][0], K2[1][1]])

        R_hat, t_hat = self._estimate(corr1, corr2, norm1, norm2, K1, K2, th, info["index"])
        err_r, err_t = evaluate_R_t_np(r_gt, t_gt, R_hat, t_hat)
        err = max(err_r, err_t)

        if len(corr1) > 1:
            inlier = compute_epi_inlier_np(norm1, norm2, E, self.config["inlier_th"])
            precision = float(inlier.mean())
            ms = float(inlier.sum() / max(n_kpts1, 1))
        else:
            precision = ms = 0.0
        return {"err_r": err_r, "err_t": err_t, "err": err, "ms": ms, "precision": precision}

    def _estimate(self, corr1, corr2, norm1, norm2, K1, K2, th, index):
        if corr1.shape[0] < 5:
            return np.eye(3), np.zeros(3)
        if self.backend == "device":
            from impx_torch.ransac.pose_solver import _norm_threshold

            return device_pose(norm1, norm2, _norm_threshold(th, K1, K2), self.device,
                               pair_generator(self.device, self.seed, index))
        from impx_torch.ransac.pose_solver import estimate_pose_cv2

        ret = estimate_pose_cv2(corr1, corr2, K1, K2, th)
        if ret is None:
            return np.eye(3), np.zeros(3)
        _, R, t, _ = ret
        return R, t

    def res_inqueue(self, res: dict):
        self.err_r.append(res["err_r"])
        self.err_t.append(res["err_t"])
        self.err.append(res["err"])
        self.ms.append(res["ms"])
        self.precision.append(res["precision"])

    def parse(self) -> dict:
        ths = np.arange(7) * 5
        return {
            "auc_th": ths[1:],
            "approx_auc": G.approx_pose_auc(self.err, ths),
            "exact_auc": G.pose_auc(self.err, ths[1:]),
            "mean_match_score": float(np.mean(self.ms)) * 100,
            "mean_precision": float(np.mean(self.precision)) * 100,
        }


class FMBenchEval:
    """Fundamental-matrix benchmark (impx/eval/evaluator.py:95). config:
    inlier_th, seq and sgd_inlier_th (parse), and optionally f_backend
    ('cv2' by default; 'device', or impx's 'jax', runs
    `estimate_fundamental_ransac` at 1 px on `device`, the CUDA device unless
    named) and seed (0). The device backend's pair i draws from
    pair_generator(device, seed, i), i counting the pairs run so far, as
    impx keys its draw by that count."""

    def __init__(self, config: dict, device: str | torch.device | None = None):
        self.config = config
        self.backend = pose_backend(config.get("f_backend", "cv2"), "f_backend")
        self.device = resolve_device(device) if self.backend == "device" else None
        self.seed = config.get("seed", 0)
        self.pre, self.pre_post, self.sgd = [], [], []
        self.num_corr, self.num_corr_post = [], []

    def _estimate(self, corr1, corr2):
        """(F_hat, inlier mask) from matched pixel coordinates [n, 2]; cv2 may
        give (None, None)."""
        if self.backend == "device":
            from impx_torch.ransac.fundamental import estimate_fundamental_ransac

            as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)  # noqa: E731
            out = estimate_fundamental_ransac(
                pair_generator(self.device, self.seed, len(self.pre)), as_t(corr1), as_t(corr2),
                torch.ones(len(corr1), dtype=torch.bool, device=self.device), threshold_px=1.0)
            return out["F"].cpu().numpy(), out["inliers"].cpu().numpy()
        import cv2

        return cv2.findFundamentalMat(corr1, corr2, method=cv2.USAC_MAGSAC, ransacReprojThreshold=1,
                                      confidence=1 - 1e-5)

    def run(self, info: dict, **_) -> dict:
        """info: corr1/corr2 (matched pixel coordinates), f (the true F),
        img_size1/img_size2 ((H, W))."""
        corr1, corr2 = info["corr1"], info["corr2"]
        F = info["f"]
        size1 = np.flip(np.asarray(info["img_size1"]))
        size2 = np.flip(np.asarray(info["img_size2"]))
        if len(corr1) <= 1:
            return {"pre": 0, "pre_post": 0, "sgd": 1e8, "num_corr": 0, "num_corr_post": 0}

        pre_bf = _fm_inlier_rate(corr1, corr2, size1, size2, F, self.config["inlier_th"]).mean()
        F_hat, mask_F = self._estimate(corr1, corr2) if len(corr1) >= 8 else (None, None)
        if F_hat is None:
            F_hat = np.ones((3, 3))
            mask_F = np.ones(len(corr1), bool)
        else:
            mask_F = mask_F.squeeze().astype(bool)
        F_hat = F_hat[:3]
        pre_af = _fm_inlier_rate(corr1[mask_F], corr2[mask_F], size1, size2, F,
                                 self.config["inlier_th"]).mean()
        sgd = _compute_sgd(F, F_hat, size1, size2)
        return {"pre": pre_bf, "pre_post": pre_af, "sgd": sgd,
                "num_corr": len(corr1), "num_corr_post": int(mask_F.sum())}

    def res_inqueue(self, res: dict):
        self.pre.append(res["pre"])
        self.pre_post.append(res["pre_post"])
        self.sgd.append(res["sgd"])
        self.num_corr.append(res["num_corr"])
        self.num_corr_post.append(res["num_corr_post"])

    def parse(self) -> dict:
        out = {}
        for seq_index, seq in enumerate(self.config["seq"]):
            o = seq_index * 1000
            out[seq] = {
                "f_recall": float((np.asarray(self.sgd)[o:o + 1000]
                                   < self.config["sgd_inlier_th"]).mean()),
                "precision": float(np.asarray(self.pre)[o:o + 1000].mean()),
                "precision_post": float(np.asarray(self.pre_post)[o:o + 1000].mean()),
                "num_corr": float(np.asarray(self.num_corr)[o:o + 1000].mean()),
                "num_corr_post": float(np.asarray(self.num_corr_post)[o:o + 1000].mean()),
            }
        return out


def _to_h(x):
    return np.concatenate([x, np.ones_like(x[:, :1])], axis=-1)


def _fm_inlier_rate(x1, x2, size1, size2, F, th):
    """Symmetric epipolar distance in pixels < th."""
    x1h, x2h = _to_h(x1), _to_h(x2)
    l2 = x1h @ F.T
    l1 = x2h @ F
    d1 = np.abs(np.sum(x1h * l1, 1)) / np.sqrt(l1[:, 0] ** 2 + l1[:, 1] ** 2 + 1e-15)
    d2 = np.abs(np.sum(x2h * l2, 1)) / np.sqrt(l2[:, 0] ** 2 + l2[:, 1] ** 2 + 1e-15)
    return np.maximum(d1, d2) < th


def _compute_sgd(F_gt, F_hat, size1, size2, n_samples: int = 1000, seed: int = 0):
    """Symmetric epipolar line distance between two F's via point sampling."""
    rs = np.random.RandomState(seed)
    pts1 = np.stack([rs.uniform(0, size1[0], n_samples),
                     rs.uniform(0, size1[1], n_samples)], 1)
    pts1h = _to_h(pts1)

    def sym_d(F_a, F_b, pts_h):
        la = pts_h @ F_a.T
        lb = pts_h @ F_b.T
        na = la[:, :2] / (np.linalg.norm(la[:, :2], axis=1, keepdims=True) + 1e-15)
        nb = lb[:, :2] / (np.linalg.norm(lb[:, :2], axis=1, keepdims=True) + 1e-15)
        cos = np.abs(np.sum(na * nb, 1))
        return 1.0 - cos

    return float(np.mean(sym_d(F_gt, F_hat, pts1h)))
