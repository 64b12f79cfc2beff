"""Image IO / resize / rotation helpers with intrinsics bookkeeping
(reference tools/utils.py:248-344; a copy of impx/tools/image.py)."""
from __future__ import annotations

import numpy as np


def scale_intrinsics(K, scales):
    """Adjust K for an image resized by (sx, sy) (reference utils.py:340-342)."""
    d = np.diag([1.0 / scales[0], 1.0 / scales[1], 1.0])
    return d @ np.asarray(K)


def rotate_intrinsics(K, image_shape, rot: int):
    """Adjust K for a k*90-degree image rotation (reference utils.py semantics)."""
    assert rot in (0, 1, 2, 3)
    K = np.asarray(K)
    h, w = image_shape[:2]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    if rot == 0:
        return K.copy()
    if rot == 1:  # 90 deg ccw
        return np.array([[fy, 0, cy], [0, fx, w - 1 - cx], [0, 0, 1]])
    if rot == 2:
        return np.array([[fx, 0, w - 1 - cx], [0, fy, h - 1 - cy], [0, 0, 1]])
    return np.array([[fy, 0, h - 1 - cy], [0, fx, cx], [0, 0, 1]])


def rotate_pose_inplane(T, rot: int):
    """Apply an in-plane rotation to a 4x4 pose (reference utils.py)."""
    theta = -np.deg2rad(90.0 * rot)
    R_inplane = np.array([
        [np.cos(theta), -np.sin(theta), 0.0, 0.0],
        [np.sin(theta), np.cos(theta), 0.0, 0.0],
        [0.0, 0.0, 1.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ])
    return R_inplane @ np.asarray(T)


def read_image(path, resize=None, rotation: int = 0, resize_float: bool = False):
    """Grayscale read + resize (+ k*90 rotation). Returns
    (image float32 [0,1], inp [H,W], scales (sx, sy))."""
    import cv2

    image = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    if image is None:
        return None, None, None
    w, h = image.shape[1], image.shape[0]
    if resize:
        if len(resize) == 1:
            scale = resize[0] / max(h, w)
            w_new, h_new = int(round(w * scale)), int(round(h * scale))
        else:
            w_new, h_new = resize[1], resize[0]
        scales = (float(w) / float(w_new), float(h) / float(h_new))
        if resize_float:
            image = cv2.resize(image.astype("float32"), (w_new, h_new))
        else:
            image = cv2.resize(image, (w_new, h_new)).astype("float32")
    else:
        scales = (1.0, 1.0)
        image = image.astype("float32")
    if rotation:
        image = np.rot90(image, k=rotation)
    return image / 255.0, image, scales
