"""Relative-pose estimation from matched keypoints (impx/ransac/pose_solver.py).

Two backends behind one interface (findEssentialMat, then a
cheirality-checked decomposition):

  * `estimate_pose_device`: on the points' device (the counterpart of impx's
    `estimate_pose_jax`): eight-point RANSAC with local optimisation, the
    decomposition with cheirality, and a Gauss-Newton polish. Fixed-count
    loops, no host synchronisation; the randomness comes from a
    torch.Generator on that device.
  * `estimate_pose_cv2`: host OpenCV USAC_MAGSAC, the published protocol.
    cv2 is imported inside it.

Thresholds: the reference passes a pixel threshold and camera matrices to
OpenCV, which normalises internally by the mean focal length; the device
backend does that conversion explicitly (`_norm_threshold`).

`estimate_pose_from_matches` is the iterative loop's checkpoint solver
(impx/ransac/pose_solver.py:188): the matches compacted into a bucket by
score, score-weighted five-point RANSAC warm-started from the previous pose,
the decomposition and the polish, over a leading pair axis in one batch.
"""
from __future__ import annotations

import numpy as np
import torch

from impx_torch.geometry.epipolar import sampson_distance, skew_symmetric
from impx_torch.geometry.triangulation import (cheirality_mask, decompose_essential_mat, projection,
                                                triangulate_points)
from impx_torch.ransac.ransac import (_sample_minimal_sets, _sample_minimal_sets_weighted,
                                      essential_ransac_from_samples, estimate_essential_ransac)


def _norm_threshold(threshold_px: float, K0, K1) -> float:
    """Pixel -> normalized threshold via the mean focal length (OpenCV's
    convention)."""
    f = (K0[0][0] + K0[1][1] + K1[0][0] + K1[1][1]) / 4.0
    return threshold_px / f


def _expm_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: so(3) vectors [..., 3] -> rotation matrices (series-safe at 0)."""
    th = torch.sqrt(torch.sum(w * w, dim=-1) + 1e-24)[..., None, None]
    K = skew_symmetric(w)
    a = torch.sinc(th / torch.pi)                     # sin(th)/th
    b = 0.5 * torch.sinc(th / (2 * torch.pi)) ** 2    # (1-cos th)/th^2
    return torch.eye(3, dtype=w.dtype, device=w.device) + a * K + b * (K @ K)


def _tangent_basis(t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 2] orthonormal basis of the plane orthogonal to unit t [..., 3]."""
    # the axis least aligned with t seeds Gram-Schmidt (axes from an eye made
    # on the device: a tensor copied from the host synchronises with it)
    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    a = torch.where(torch.abs(t[..., :1]) < 0.9, eye[0], eye[1])
    b1 = torch.linalg.cross(t, a)
    b1 = b1 / (torch.linalg.norm(b1, dim=-1, keepdim=True) + 1e-18)
    b2 = torch.linalg.cross(t, b1)
    return torch.stack([b1, b2], dim=-1)


def _sampson_residual(E, x0, x1):
    """Signed first-order (Sampson) epipolar residual [..., N] of E [..., 3, 3]
    at x0, x1 [..., N, 2]."""
    x0h = torch.cat([x0, torch.ones_like(x0[..., :1])], dim=-1)
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    Ex0 = x0h @ E.mT
    Etx1 = x1h @ E
    num = torch.sum(x1h * Ex0, dim=-1)
    den = torch.sqrt(Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2 + 1e-18)
    return num / den


def _perturbed(R, t, B, p):
    """The pose moved by p [..., 5]: R by the rotation exp(p[:3]), the unit t
    in its tangent plane (basis B [..., 3, 2]) by p[3:]."""
    tn = t + (B @ p[..., 3:5, None])[..., 0]
    return _expm_so3(p[..., :3]) @ R, tn / (torch.linalg.norm(tn, dim=-1, keepdim=True) + 1e-18)


def _sampson_jvp(E, dE, x0, x1):
    """`_sampson_residual` r [..., N] at E [..., 3, 3] and its derivatives
    [..., K, N] along the directions dE [..., K, 3, 3]: forward-mode
    differentiation written out."""
    x0h = torch.cat([x0, torch.ones_like(x0[..., :1])], dim=-1)
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    Ex0, dEx0 = x0h @ E.mT, x0h[..., None, :, :] @ dE.mT        # [..., N, 3], [..., K, N, 3]
    Etx1, dEtx1 = x1h @ E, x1h[..., None, :, :] @ dE
    num, dnum = torch.sum(x1h * Ex0, dim=-1), torch.sum(x1h[..., None, :, :] * dEx0, dim=-1)
    den = torch.sqrt(Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2 + 1e-18)
    num, den = num[..., None, :], den[..., None, :]
    e0, e1, f0, f1 = (x[..., None, :] for x in (Ex0[..., 0], Ex0[..., 1], Etx1[..., 0], Etx1[..., 1]))
    dden = (e0 * dEx0[..., 0] + e1 * dEx0[..., 1] + f0 * dEtx1[..., 0] + f1 * dEtx1[..., 1]) / den
    return (num / den)[..., 0, :], dnum / den - num * dden / (den * den)


def _gn_system(R, t, x0, x1, sw):
    """The weighted Sampson residual r [..., N] at (R, t), its Jacobian
    J [..., N, 5] over the perturbation p of `_perturbed` at p = 0, and the
    tangent basis.

    impx takes J by jax.jacfwd; here the forward-mode derivatives are written
    out (torch.func's forward-mode levels are global state, which the
    evaluator's threads would share). At p = 0 the rotation's derivative
    along p_k is [e_k]_x R (sinc's terms have zero derivative there), and the
    normalised translation's along B_k is the derivative of
    v / (|v| + 1e-18) at v = t."""
    B = _tangent_basis(t)
    nv = torch.linalg.norm(t, dim=-1)[..., None, None]
    n = nv + 1e-18
    Bt = B.mT                                                            # [..., 2, 3]
    dt = Bt / n - t[..., None, :] * (Bt @ t[..., None]) / (nv * n * n)    # [..., 2, 3]
    gens = skew_symmetric(torch.eye(3, dtype=R.dtype, device=R.device))  # [e_k]_x
    St = skew_symmetric(t)
    Rk = R[..., None, :, :] if R.dim() > 2 else R   # unbatched: one folded product, as before
    dE = torch.cat([St[..., None, :, :] @ gens @ Rk, skew_symmetric(dt) @ Rk], dim=-3)   # [..., 5, 3, 3]
    r, dr = _sampson_jvp(St @ R, dE, x0, x1)
    return r * sw, (dr * sw[..., None, :]).mT, B


def refine_pose_gn(R, t, x0, x1, w, iters: int = 8, damping: float = 1e-8):
    """Gauss-Newton polish on the 5-DOF essential manifold: minimise the
    weighted Sampson error over a so(3) perturbation of R and the tangent of
    the translation direction; each step is kept only if the weighted cost
    fell. The geometric final polish that cv2's USAC applies to its winner.

    R [..., 3, 3], t [..., 3], x0, x1 [..., N, 2], w: [..., N] nonnegative
    weights (0 = excluded); one problem per leading batch entry. Returns
    (R, t)."""
    sw = torch.sqrt(torch.clamp(w, min=0.0))
    eye5 = torch.eye(5, dtype=R.dtype, device=R.device)

    def cost_of(R, t):
        r = _sampson_residual(skew_symmetric(t) @ R, x0, x1) * sw
        return torch.sum(r * r, dim=-1)

    c = cost_of(R, t)
    for _ in range(iters):
        r, J, B = _gn_system(R, t, x0, x1, sw)
        H = J.mT @ J + damping * eye5
        # solve_ex: no error check, so no host synchronisation
        delta = -torch.linalg.solve_ex(H, (J.mT @ r[..., None])[..., 0])[0]
        Rn, tn = _perturbed(R, t, B, delta)
        cn = cost_of(Rn, tn)
        better = cn < c
        R = torch.where(better[..., None, None], Rn, R)
        t = torch.where(better[..., None], tn, t)
        c = torch.where(better, cn, c)
    return R, t


def normalize_pts(pts, K):
    K = np.asarray(K)
    return (np.asarray(pts) - K[:2, 2]) / np.array([K[0, 0], K[1, 1]])


def prior_essential(R, t, has_pose):
    """Warm-start model for `E_init`: the essential matrix of (R, t) where
    `has_pose`, else a fixed valid essential (pure z-translation) that simply
    competes and loses. R [..., 3, 3], t [..., 3], has_pose [...] bool."""
    E_z = skew_symmetric(torch.eye(3, dtype=R.dtype, device=R.device)[2])
    has_pose = torch.as_tensor(has_pose, device=R.device)[..., None, None]
    return torch.where(has_pose, skew_symmetric(t) @ R, E_z)


def estimate_pose_device(generator: torch.Generator, x0n: torch.Tensor, x1n: torch.Tensor,
                         valid: torch.Tensor, norm_thresh: float, num_hypotheses: int = 1024,
                         lo_iterations: int = 4, distance_thresh: float = 1000.0,
                         sample_size: int = 8, refine_iters: int = 8) -> dict:
    """Pose on the points' device. x0n/x1n [N, 2] normalized coordinates,
    valid [N] bool, generator a torch.Generator on their device.
    sample_size=5 draws five-point minimal sets.

    Returns dict(E, R, t, inliers [N] bool, num_inliers, num_e_inliers)."""
    out = estimate_essential_ransac(generator, x0n, x1n, valid, norm_thresh,
                                    num_hypotheses=num_hypotheses, lo_iterations=lo_iterations,
                                    sample_size=sample_size)
    E = out["E"]
    e_mask = out["inliers"]
    # cheirality disambiguation restricted to the E-inliers
    R, t, mask_p, _ = decompose_essential_mat(E, x0n, x1n, distance_thresh=distance_thresh, valid=e_mask)
    if refine_iters > 0:
        t2 = norm_thresh * norm_thresh
        d2 = sampson_distance(x0n, x1n, E)
        w = torch.where(e_mask, 1.0 / (1.0 + d2 / t2), 0.0)
        R, t = refine_pose_gn(R, t, x0n, x1n, w, iters=refine_iters)
        E = skew_symmetric(t) @ R
        # the inlier mask at the refined pose: the epipolar gate at the base
        # threshold and one cheirality pass
        d2 = sampson_distance(x0n, x1n, E)
        e_inl = (d2 < t2) & valid
        eye = torch.eye(3, dtype=E.dtype, device=E.device)
        P0 = projection(eye, torch.zeros(3, dtype=E.dtype, device=E.device))
        P1 = projection(R, t)
        mask_p = cheirality_mask(triangulate_points(P0, P1, x0n, x1n), P1, distance_thresh, valid=e_inl)
    return {"E": E, "R": R, "t": t, "inliers": mask_p, "num_inliers": torch.sum(mask_p),
            "num_e_inliers": out["num_inliers"]}


def compact_matches(x0n, x1n, indices0, mscores0, bucket: int = 512):
    """The matched pairs in the top-`bucket` slots by match score: x0n
    [..., N, 2], x1n [..., M, 2], indices0 [..., N] (-1 unmatched), mscores0
    [..., N]. Ties keep the lower index first, as lax.top_k does (every
    unmatched slot ties at -1). Returns (mx0, mx1 [..., b, 2], valid [..., b]
    bool, weights [..., b]: the match scores, at least 1e-4, 0 off valid)."""
    b = min(bucket, x0n.shape[-2])
    keym = torch.where(indices0 > -1, mscores0, -1.0)
    vals, order = torch.sort(keym, dim=-1, descending=True, stable=True)
    vals, sel = vals[..., :b], order[..., :b]
    valid = vals > -0.5
    j = torch.gather(indices0, -1, sel).clamp(0, x1n.shape[-2] - 1)
    take = lambda x, i: torch.gather(x, -2, i[..., None].expand(*i.shape, 2))  # noqa: E731
    return take(x0n, sel), take(x1n, j), valid, torch.where(valid, vals.clamp(min=1e-4), 0.0)


def estimate_pose_from_matches(generators, x0n: torch.Tensor, x1n: torch.Tensor, indices0: torch.Tensor,
                               mscores0: torch.Tensor, norm_thresh, bucket: int = 512,
                               num_hypotheses: int = 256, lo_iterations: int = 4,
                               distance_thresh: float = 1000.0, sample_size: int = 5,
                               weighted: bool = True, refine_iters: int = 8,
                               E_init: torch.Tensor | None = None,
                               samples: torch.Tensor | None = None) -> dict:
    """Pose from a matcher's output, for P pairs at once (impx's
    estimate_pose_from_matches, vmapped over pairs as its batched iterative
    loop does): compact each pair's matches into `bucket` slots by score
    (`compact_matches`), draw num_hypotheses minimal sets from each pair's
    generator (in proportion to match score when `weighted`), then one
    batched RANSAC warm-started from E_init, the decomposition with
    cheirality (closed form: no host synchronisation) and the Gauss-Newton
    polish over all pairs; last, one full-length Sampson and cheirality pass
    at the chosen pose puts the inlier mask back into keypoint indexing.

    x0n [P, N, 2], x1n [P, M, 2] normalized coordinates, indices0 and
    mscores0 [P, N], norm_thresh a float or [P], E_init [P, 3, 3] (finite,
    nonzero; see prior_essential), generators a sequence of P
    torch.Generators on the points' device. Without the pair axis (x0n
    [N, 2], ...) generators is one generator. samples [P, H, S]: the minimal
    sets, into the compacted slots, in place of the draws.

    Returns dict(E, R, t, inliers [P, N] bool, num_inliers, num_e_inliers)."""
    batched = indices0.dim() == 2
    if not batched:
        generators = [generators]
        x0n, x1n, indices0, mscores0 = x0n[None], x1n[None], indices0[None], mscores0[None]
        E_init = None if E_init is None else E_init[None]
        samples = None if samples is None else samples[None]
    dev = x0n.device
    thr = torch.as_tensor(norm_thresh, dtype=torch.float32, device=dev).expand(x0n.shape[0])
    mx0, mx1, valid_r, w = compact_matches(x0n, x1n, indices0, mscores0, bucket)
    if samples is None:
        draw = (lambda g, i: _sample_minimal_sets_weighted(g, w[i], valid_r[i], num_hypotheses, sample_size)
                if weighted else _sample_minimal_sets(g, valid_r[i], num_hypotheses, sample_size))
        samples = torch.stack([draw(g, i) for i, g in enumerate(generators)])
    out = essential_ransac_from_samples(samples, mx0, mx1, valid_r, thr, lo_iterations=lo_iterations,
                                        E_init=E_init)
    E = out["E"]
    R, t, _, _ = decompose_essential_mat(E, mx0, mx1, distance_thresh=distance_thresh,
                                         valid=out["inliers"], svd=False)
    t2 = (thr * thr)[:, None]
    if refine_iters > 0:
        d2c = sampson_distance(mx0, mx1, E)
        wr = torch.where(out["inliers"], 1.0 / (1.0 + d2c / t2), 0.0)
        R, t = refine_pose_gn(R, t, mx0, mx1, wr, iters=refine_iters)
        E = skew_symmetric(t) @ R
    # the compaction is internal to the solver: the inlier mask covers every
    # match (a pair may have more than `bucket`), from one full-length
    # Sampson and one cheirality pass at the chosen pose
    m_valid = indices0 > -1
    j = indices0.clamp(0, x1n.shape[-2] - 1)
    fx1 = torch.gather(x1n, -2, j[..., None].expand(*j.shape, 2))
    e_inl = (sampson_distance(x0n, fx1, E) < t2) & m_valid
    eye = torch.eye(3, dtype=E.dtype, device=dev)
    P0, P1 = projection(eye, torch.zeros(3, dtype=E.dtype, device=dev)), projection(R, t)
    inliers = cheirality_mask(triangulate_points(P0, P1, x0n, fx1), P1, distance_thresh, valid=e_inl)
    res = {"E": E, "R": R, "t": t, "inliers": inliers, "num_inliers": inliers.sum(dim=-1),
           "num_e_inliers": out["num_inliers"]}
    return res if batched else {k: v[0] for k, v in res.items()}


def estimate_pose_cv2(kpts0, kpts1, K0, K1, norm_thresh, conf: float = 0.99999,
                      method: str = "magsac"):
    """Host OpenCV path, the reference protocol (findEssentialMat, then the
    cheirality-checked decomposition of this package, in float32 as impx runs
    it without x64). kpts0/kpts1: [N, 2] pixel coordinates. Returns
    (E, R, t, mask) as numpy, or None."""
    import cv2

    # Keep the caller's float dtype: cv2's USAC returns a different
    # (deterministic) model for float32 and float64 inputs of equal values,
    # and the reference feeds its reader's float32 keypoints as they are.
    kpts0 = np.ascontiguousarray(kpts0)
    kpts1 = np.ascontiguousarray(kpts1)
    if kpts0.dtype not in (np.float32, np.float64):
        kpts0 = kpts0.astype(np.float64)
    if kpts1.dtype not in (np.float32, np.float64):
        kpts1 = kpts1.astype(np.float64)
    if len(kpts0) < 5:
        return None
    m = cv2.USAC_MAGSAC if method == "magsac" else cv2.RANSAC
    E, E_mask = cv2.findEssentialMat(
        points1=kpts0, points2=kpts1,
        cameraMatrix1=np.asarray(K0, np.float64), cameraMatrix2=np.asarray(K1, np.float64),
        distCoeffs1=None, distCoeffs2=None,
        threshold=norm_thresh, prob=conf, mask=None, method=m,
    )
    if E is None or E.shape[0] != 3 or E.shape[1] != 3:
        return None

    sel = E_mask.ravel() > 0
    # normalise by the averaged intrinsics, as the reference does
    K = (np.asarray(K0) + np.asarray(K1)) / 2.0
    x0n = (kpts0[sel] - K[:2, 2]) / np.array([K[0, 0], K[1, 1]])
    x1n = (kpts1[sel] - K[:2, 2]) / np.array([K[0, 0], K[1, 1]])
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    R, t, mask_p, _ = decompose_essential_mat(f32(E), f32(x0n), f32(x1n))
    mask = E_mask.ravel() >= 0
    mask[sel] = mask_p.numpy()
    return E, R.numpy(), t.numpy(), mask


def estimate_pose(kpts0, kpts1, K0, K1, norm_thresh, conf: float = 0.99999, method: str = "magsac"):
    """Reference-compatible host entry point (pixel inputs, cv2 backend)."""
    return estimate_pose_cv2(kpts0, kpts1, K0, K1, norm_thresh, conf, method)
