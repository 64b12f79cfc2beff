"""Synthetic two-view scene generator (a copy of impx/data/synthetic.py,
numpy only: the same seed gives the same arrays).

The reference verifies itself against downloaded YFCC/ScanNet/MegaDepth dumps;
those are unavailable in CI, so impx generates physically-consistent synthetic
pairs (random pose + 3D points + pinhole projection + descriptor noise) in the
*same formats* the real pipelines produce:

  * eval: HDF5 with the standard_reader layout (components/readers.py:8-39);
  * train: sample dicts with keypoints/descriptors/scores/matching_mask
    matching dataset/megadepth.py:231-262.

This gives end-to-end tests and benchmarks a ground truth with known pose, and
a training signal a matcher can actually learn (descriptors of true
correspondences are correlated, outliers are not).
"""
from __future__ import annotations

import numpy as np


def random_rotation(rs, max_angle_deg: float = 60.0):
    axis = rs.randn(3)
    axis /= np.linalg.norm(axis)
    angle = np.deg2rad(rs.uniform(5.0, max_angle_deg))
    K = np.array([
        [0, -axis[2], axis[1]],
        [axis[2], 0, -axis[0]],
        [-axis[1], axis[0], 0],
    ])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def synthesize_pair(
    rs: np.random.RandomState,
    n_inliers: int = 512,
    n_outliers0: int = 488,
    n_outliers1: int = 488,
    desc_dim: int = 256,
    image_size=(480, 640),
    desc_noise: float = 0.15,
    pixel_noise: float = 0.5,
):
    """Returns a dict in the standard_reader layout (kpt = [x, y, score])."""
    h, w = image_size
    f = 0.9 * max(h, w)
    K = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1.0]])

    R = random_rotation(rs)
    t = rs.randn(3)
    t = t / np.linalg.norm(t)

    # sample 3D points visible in both cameras (rejection-free: generate in
    # cam0 frustum, keep those landing inside image 1)
    n_try = n_inliers * 4
    z = rs.uniform(4.0, 12.0, n_try)
    x_pix = rs.uniform(0, w, n_try)
    y_pix = rs.uniform(0, h, n_try)
    X = np.stack([(x_pix - K[0, 2]) / f * z, (y_pix - K[1, 2]) / f * z, z], axis=1)
    X1 = X @ R.T + t * 0.3 * z.mean()  # modest baseline relative to depth
    u1 = X1 @ K.T
    u1 = u1[:, :2] / u1[:, 2:3]
    ok = (X1[:, 2] > 0.1) & (u1[:, 0] >= 0) & (u1[:, 0] < w) & (u1[:, 1] >= 0) & (u1[:, 1] < h)
    keep = np.where(ok)[0][:n_inliers]
    n_in = len(keep)
    x0_in = np.stack([x_pix[keep], y_pix[keep]], axis=1) + rs.randn(n_in, 2) * pixel_noise
    x1_in = u1[keep] + rs.randn(n_in, 2) * pixel_noise

    # shared descriptors for true correspondences, independent for outliers
    d_shared = rs.randn(n_in, desc_dim)
    d0_in = d_shared + rs.randn(n_in, desc_dim) * desc_noise
    d1_in = d_shared + rs.randn(n_in, desc_dim) * desc_noise
    x0_out = np.stack([rs.uniform(0, w, n_outliers0), rs.uniform(0, h, n_outliers0)], 1)
    x1_out = np.stack([rs.uniform(0, w, n_outliers1), rs.uniform(0, h, n_outliers1)], 1)
    d0_out = rs.randn(n_outliers0, desc_dim)
    d1_out = rs.randn(n_outliers1, desc_dim)

    def _norm(d):
        return d / np.linalg.norm(d, axis=1, keepdims=True)

    kpt0 = np.vstack([x0_in, x0_out])
    kpt1 = np.vstack([x1_in, x1_out])
    desc0 = _norm(np.vstack([d0_in, d0_out])).astype(np.float32)
    desc1 = _norm(np.vstack([d1_in, d1_out])).astype(np.float32)
    score0 = rs.uniform(0.1, 1.0, len(kpt0)).astype(np.float32)
    score1 = rs.uniform(0.1, 1.0, len(kpt1)).astype(np.float32)

    # shuffle both sides, tracking the correspondence
    perm0 = rs.permutation(len(kpt0))
    perm1 = rs.permutation(len(kpt1))
    inv0 = np.argsort(perm0)
    inv1 = np.argsort(perm1)
    kpt0, desc0, score0 = kpt0[perm0], desc0[perm0], score0[perm0]
    kpt1, desc1, score1 = kpt1[perm1], desc1[perm1], score1[perm1]
    matches = np.stack([inv0[:n_in], inv1[:n_in]], axis=1)  # gt index pairs

    t_skew = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = t_skew @ R
    F = np.linalg.inv(K).T @ E @ np.linalg.inv(K)

    return {
        "K1": K, "K2": K, "R": R, "T": t, "e": E, "f": F,
        "kpt1": np.concatenate([kpt0, score0[:, None]], 1).astype(np.float32),
        "kpt2": np.concatenate([kpt1, score1[:, None]], 1).astype(np.float32),
        "desc1": desc0, "desc2": desc1,
        "img_size1": image_size, "img_size2": image_size,
        "gt_matches": matches,
    }


def eval_feed_from_pair(pair, n_kpts: int):
    """Fixed-shape matcher feed (numpy, unbatched) from a synthesize_pair
    dict: padded descriptors/keypoints/scores + validity masks, SuperGlue
    keypoint normalization (the SAME (k - size/2 - 0.5) / (0.7*max) rule as
    training_sample — keep this convention in ONE place), and
    intrinsics-normalized x0n/x1n for the pose solvers."""
    def pad(a):
        return np.pad(a, [(0, n_kpts - a.shape[0])] + [(0, 0)] * (a.ndim - 1))

    k0 = pad(pair["kpt1"][:n_kpts])
    k1 = pad(pair["kpt2"][:n_kpts])
    h0, w0 = pair["img_size1"]
    h1, w1 = pair["img_size2"]
    size0 = np.array([w0, h0], np.float32)
    size1 = np.array([w1, h1], np.float32)
    K0, K1 = pair["K1"], pair["K2"]
    f0 = np.array([K0[0, 0], K0[1, 1]])
    f1 = np.array([K1[0, 0], K1[1, 1]])
    return {
        "descriptors0": pad(pair["desc1"][:n_kpts]),
        "descriptors1": pad(pair["desc2"][:n_kpts]),
        "norm_keypoints0": (k0[:, :2] - size0 / 2 - 0.5) / (size0.max() * 0.7),
        "norm_keypoints1": (k1[:, :2] - size1 / 2 - 0.5) / (size1.max() * 0.7),
        "scores0": k0[:, 2],
        "scores1": k1[:, 2],
        "valid0": np.arange(n_kpts) < min(len(pair["kpt1"]), n_kpts),
        "valid1": np.arange(n_kpts) < min(len(pair["kpt2"]), n_kpts),
        "x0n": (k0[:, :2] - K0[:2, 2]) / f0,
        "x1n": (k1[:, :2] - K1[:2, 2]) / f1,
    }


def write_eval_hdf5(path: str, num_pairs: int, seed: int = 0,
                    image_dir: str | None = None, **pair_kwargs):
    """Write a standard_reader-layout HDF5 of synthetic pairs
    (reference dump/dumper/base_dumper.py:78-111 `form_standard_dataset`).

    image_dir: when given, also write flat gray PNGs of each pair's image
    size there and add `img_path1`/`img_path2` groups — the REFERENCE
    standard_reader (components/readers.py:26-29) cv2.imread's actual files
    (it uses them only for their shape), which the cross-framework study
    needs; impx's reader uses the img_size groups instead."""
    import h5py

    rs = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        groups = {}
        names = ["K1", "K2", "R", "T", "e", "f", "kpt1", "kpt2",
                 "desc1", "desc2", "img_size1", "img_size2"]
        if image_dir is not None:
            names += ["img_path1", "img_path2"]
        for name in names:
            groups[name] = f.create_group(name)
        for i in range(num_pairs):
            pair = synthesize_pair(rs, **pair_kwargs)
            if image_dir is not None:
                import os

                import cv2

                os.makedirs(image_dir, exist_ok=True)
                for side, key in ((1, "img_size1"), (2, "img_size2")):
                    h, w = pair[key]
                    fn = f"synth_{i}_{side}.png"
                    fp = os.path.join(image_dir, fn)
                    if not os.path.exists(fp):
                        cv2.imwrite(fp, np.full((h, w, 3), 128, np.uint8))
                    pair[f"img_path{side}"] = np.array([fn.encode()])
            for name, g in groups.items():
                g.create_dataset(str(i), data=np.asarray(pair[name]))
    return path


def training_sample(rs, nfeatures: int = 512, desc_dim: int = 256, **kwargs):
    """A training dict in the megadepth layout (dataset/megadepth.py:231-262):
    exactly `nfeatures` keypoints per image and an (N+1)x(N+1) matching_mask."""
    pair = synthesize_pair(rs, n_inliers=min(nfeatures // 2, 256),
                           n_outliers0=nfeatures, n_outliers1=nfeatures,
                           desc_dim=desc_dim, **kwargs)
    k0, k1 = pair["kpt1"], pair["kpt2"]
    gt = pair["gt_matches"]
    sel0 = np.concatenate([gt[:, 0], np.setdiff1d(np.arange(len(k0)), gt[:, 0])])[:nfeatures]
    sel1 = np.concatenate([gt[:, 1], np.setdiff1d(np.arange(len(k1)), gt[:, 1])])[:nfeatures]
    pos0 = {g: i for i, g in enumerate(sel0)}
    pos1 = {g: i for i, g in enumerate(sel1)}

    mask = np.zeros((nfeatures + 1, nfeatures + 1), np.float32)
    matched0 = set()
    matched1 = set()
    for a, b in gt:
        if a in pos0 and b in pos1:
            mask[pos0[a], pos1[b]] = 1
            matched0.add(pos0[a])
            matched1.add(pos1[b])
    for i in range(nfeatures):
        if i not in matched0:
            mask[i, nfeatures] = 1
        if i not in matched1:
            mask[nfeatures, i] = 1

    h, w = pair["img_size1"]
    size = np.array([w, h], np.float32)
    norm0 = (k0[sel0, :2] - size / 2 - 0.5) / (size.max() * 0.7)
    norm1 = (k1[sel1, :2] - size / 2 - 0.5) / (size.max() * 0.7)
    return {
        "keypoints0": k0[sel0, :2],
        "keypoints1": k1[sel1, :2],
        "norm_keypoints0": norm0.astype(np.float32),
        "norm_keypoints1": norm1.astype(np.float32),
        "descriptors0": pair["desc1"][sel0],
        "descriptors1": pair["desc2"][sel1],
        "scores0": k0[sel0, 2],
        "scores1": k1[sel1, 2],
        "matching_mask": mask,
        "intrinsics0": pair["K1"].astype(np.float32),
        "intrinsics1": pair["K2"].astype(np.float32),
        "gt_E": pair["e"].astype(np.float32),
    }
