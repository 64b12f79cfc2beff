"""Feature extractors and the plugin registry (impx/data/extractors.py).

`resize_image` and `ExtractSIFT` (OpenCV SIFT with RootSIFT normalisation)
are copies of impx's, host-side numpy and cv2. `ExtractSuperpoint` runs
impx_torch/models/superpoint.py on the CUDA device unless a device is named
(its argument, or the config's 'device'). `load_component` maps a string to a
component, as the dumpers and eval drivers call it; its reader, evaluator and
matcher entries are the port's.

cv2 is imported inside the functions that use it. The extractors run under
the dumpers' thread pool (impx_torch/data/dump/base.py): SuperPoint's model is
built once, under a lock, on the first `run`.
"""
from __future__ import annotations

import os.path as osp
import threading

import numpy as np
import torch

from impx_torch.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resize_image(img, resize):
    """max-side or (h, w) resize; returns (img, scale[sx, sy]) — reference
    components/extractors.py:14-24."""
    import cv2

    img_h, img_w = img.shape[:2]
    cur_size = max(img_h, img_w)
    if len(resize) == 1:
        scale1 = scale2 = resize[0] / cur_size
    else:
        scale1, scale2 = resize[0] / img_h, resize[1] / img_w
    new_h, new_w = int(img_h * scale1), int(img_w * scale2)
    new_img = cv2.resize(img.astype("float32"), (new_w, new_h)).astype("uint8")
    return new_img, np.asarray([scale2, scale1])


class ExtractSIFT:
    """OpenCV SIFT + RootSIFT norm, response-sorted top-k
    (reference components/extractors.py:27-47)."""

    def __init__(self, config: dict, root: bool = True):
        self.num_kp = config["num_kpt"]
        self.contrastThreshold = config.get("det_th", 1e-5)
        self.resize = config.get("resize", [-1])
        self.root = root

    def run(self, img_or_path):
        import cv2

        if isinstance(img_or_path, str):
            img = cv2.imread(img_or_path, cv2.IMREAD_GRAYSCALE)
        else:
            img = img_or_path
        scale = [1, 1]
        if self.resize[0] != -1:
            img, scale = resize_image(img, self.resize)
        sift = cv2.SIFT_create(nfeatures=self.num_kp,
                               contrastThreshold=self.contrastThreshold)
        cv_kp, desc = sift.detectAndCompute(img, None)
        if not cv_kp:
            return np.zeros((0, 3), np.float32), np.zeros((0, 128), np.float32)
        kp = np.array([[k.pt[0] / scale[0], k.pt[1] / scale[1], k.response]
                       for k in cv_kp])
        index = np.flip(np.argsort(kp[:, 2]))
        kp, desc = kp[index], desc[index]
        if self.root:
            desc = np.sqrt(
                np.abs(desc / (np.linalg.norm(desc, axis=-1, ord=1)[:, None] + 1e-8)))
        return kp[: self.num_kp].astype(np.float32), desc[: self.num_kp]


class ExtractSuperpoint:
    """SuperPoint on the device behind the same interface (reference
    components/extractors.py:50-89, the padding option included).

    config: num_kpt, det_th (0.005), resize ([-1]), padding (False),
    weight_path ('weights/superpoint_v1.pth', read on the first run;
    FileNotFoundError if absent), compute_dtype ('float32' or 'bfloat16'),
    device. `rng` draws the padding rows (impx draws them from numpy's global
    generator; ROADMAP C)."""

    def __init__(self, config: dict, device: str | torch.device | None = None,
                 rng: np.random.Generator | None = None):
        self.num_kp = config["num_kpt"]
        self.det_th = config.get("det_th", 0.005)
        self.resize = config.get("resize", [-1])
        self.padding = config.get("padding", False)
        self.weight_path = config.get("weight_path", "weights/superpoint_v1.pth")
        self.compute_dtype = _DTYPES[config.get("compute_dtype", "float32")]
        self.device = resolve_device(device if device is not None else config.get("device"))
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self._model = None
        self._lock = threading.Lock()

    @property
    def model(self):
        with self._lock:
            if self._model is None:
                if not osp.isfile(self.weight_path):
                    raise FileNotFoundError(f"SuperPoint weights not found at {self.weight_path}")
                from impx_torch.models.superpoint import SuperPoint
                from impx_torch.tools.convert import load_superpoint_checkpoint

                model = SuperPoint(device=self.device)
                model.load_state_dict(load_superpoint_checkpoint(self.weight_path))
                self._model = model
            return self._model

    def run(self, img_or_path):
        import cv2

        if isinstance(img_or_path, str):
            img = cv2.imread(img_or_path, cv2.IMREAD_GRAYSCALE)
        else:
            img = img_or_path
        scale = 1
        if self.resize[0] != -1:
            img, scale = resize_image(img, self.resize)
        # pad to a multiple of 8, the encoder's stride
        h, w = img.shape
        ph, pw = (-h) % 8, (-w) % 8
        if ph or pw:
            img = np.pad(img, ((0, ph), (0, pw)))
        x = torch.from_numpy(np.asarray(img / 255.0, np.float32))[None, None]
        out = self.model(x, compute_dtype=self.compute_dtype, max_keypoints=self.num_kp,
                         keypoint_threshold=self.det_th)
        valid = out["valid"][0].cpu().numpy()
        kpt = out["keypoints"][0].cpu().numpy()[valid]
        score = out["scores"][0].cpu().numpy()[valid]
        desc = out["descriptors"][0].cpu().numpy()[valid]
        if isinstance(scale, np.ndarray):
            kpt = kpt / scale[None]
        kpt = np.concatenate([kpt, score[:, None]], axis=-1)

        if self.padding and len(kpt) < self.num_kp:
            res = self.num_kp - len(kpt)
            with self._lock:
                pad_x = self.rng.uniform(size=[res, 2]) * (img.shape[0] + img.shape[1]) / 2
                pad_desc = self.rng.uniform(size=[res, desc.shape[1] if len(desc) else 256])
            pad_desc = pad_desc / np.linalg.norm(pad_desc, axis=-1)[:, None]
            kpt = np.concatenate([kpt, np.concatenate([pad_x, np.zeros([res, 1])], -1)], 0)
            desc = np.concatenate([desc, pad_desc], 0) if len(desc) else pad_desc
        return kpt.astype(np.float32), desc.astype(np.float32)


def load_component(kind: str, name: str, config: dict):
    """Plugin registry (reference components/load_component.py). The reader,
    evaluators and matchers are the port's; a matcher or a device evaluator
    takes config['device'] (the CUDA device if absent)."""
    registry = {
        ("extractor", "root"): lambda c: ExtractSIFT(c, root=True),
        ("extractor", "sift"): lambda c: ExtractSIFT(c, root=False),
        ("extractor", "sp"): ExtractSuperpoint,
    }
    if kind == "reader":
        from impx_torch.data.reader import StandardReader

        return StandardReader(config)
    if kind == "evaluator":
        from impx_torch.eval.evaluator import AucEval, FMBenchEval

        return {"auc": AucEval, "fm": FMBenchEval}[name](config, device=config.get("device"))
    if kind == "matcher":
        from impx_torch.eval.eval_imp import build_model

        return build_model(name, config.get("feature", "spp"), device=config.get("device"))
    try:
        return registry[(kind, name)](config)
    except KeyError:
        raise ValueError(f"unknown component {kind}/{name}") from None
