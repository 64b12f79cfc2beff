"""The MegaDepth training dataset over the offline dump (impx/data/megadepth.py),
numpy only.

Reads the file layout of the MegaDepth dump (impx_torch/data/dump/
dump_megadepth.py writes it, as the reference's pipeline does): per-scene
pair counts in `mega_scene_nmatches_{feat}.npy`, per-pair metadata in
`matches_sep_{feat}/{scene}/{id}.npy`, per-image features in
`keypoints_{feat}/{scene}/{img}_{feat}.npy`.

The sampling rules are impx's: `pairs_per_scene` pairs resampled per epoch
(`build_dataset(seed)`, seed = epoch; a fixed 42 for validation), exactly
`nfeatures` keypoints an image = the (optionally random-count) inliers and a
shuffled unmatched fill, a dense (N+1) x (N+1) 0/1 matching_mask with the
dustbin row and column, and the linear probing past invalid samples in
`__getitem__`.

One departure: impx draws a training sample's randomness from numpy's global
stream (impx/data/megadepth.py:101, :140-141). The port draws it from a
`np.random.RandomState` the dataset holds, seeded with `seed` and reseeded
with seed + epoch by `build_dataset`; with numpy's global state seeded to the
same number, impx draws the same numbers in the same order (ROADMAP.md
section C).

`SyntheticMegadepth` makes the same sample dicts from seeded synthetic scenes
when no dump exists (tests, smoke training, the card).
"""
from __future__ import annotations

import os.path as osp
from typing import Any

import numpy as np

from impx_torch.data.synthetic import training_sample


def normalize_size_spg(x, size, scale: float = 0.7):
    """Pixel keypoints to the matcher's normalized coordinates: centred on the
    image (size = (width, height)) and divided by 0.7 times its larger side."""
    size = np.asarray(size, np.float32).reshape(1, 2)
    return (x - size / 2.0 - 0.5) / (size.max() * scale)


class Megadepth:
    def __init__(
        self,
        base_path: str,
        scene_list_fn: str,
        pairs_per_scene: int = 200,
        nfeatures: int = 1024,
        feature_type: str = "spp",
        train: bool = True,
        min_inliers: int = 32,
        max_inliers: int = 512,
        random_inliers: bool = False,
        seed: int = 0,
        **_,
    ):
        with open(scene_list_fn) as f:
            self.scenes = [line.strip() for line in f if line.strip()]
        self.base_path = base_path
        self.pairs_per_scene = pairs_per_scene
        self.nfeatures = nfeatures
        self.feature_type = feature_type
        self.train = train
        self.min_inliers = min_inliers
        self.max_inliers = max_inliers
        self.random_inliers = random_inliers
        self.seed = seed
        self.invalid_fns: set[str] = set()
        self.dataset: list[tuple[str, int]] = []

        counts_fn = osp.join(base_path, f"mega_scene_nmatches_{feature_type}.npy")
        self.scene_nvalid_pairs = np.load(counts_fn, allow_pickle=True).item()
        self.build_dataset(seed=0)

    def build_dataset(self, seed: int = -1):
        """Resample pairs_per_scene pairs a scene (impx/data/megadepth.py:77)
        and reseed the samples' stream with self.seed + seed."""
        self.dataset = []
        self.rs = np.random.RandomState(self.seed + max(seed, 0))
        rs = np.random.RandomState(42 if not self.train else max(seed, 0))
        for scene in self.scenes:
            if scene not in self.scene_nvalid_pairs:
                continue
            n = self.scene_nvalid_pairs[scene]
            if n <= self.pairs_per_scene:
                ids = np.arange(n)
            else:
                ids = rs.choice(n, self.pairs_per_scene)
            self.dataset.extend((scene, int(i)) for i in ids)
        rs.shuffle(self.dataset)

    def __len__(self):
        return len(self.dataset)

    @property
    def draws_from_stream(self) -> bool:
        """Whether a sample's draws follow from the samples drawn before it:
        training's draw from self.rs; validation's each from RandomState(0)."""
        return self.train

    def __getitem__(self, idx):
        for i in range(len(self.dataset)):
            out = self.sample_matches_from_offline((i + idx) % len(self.dataset))
            if out is not None:
                return out
        raise RuntimeError("no valid training sample found")

    def _load_feat(self, image_path: str):
        scene = image_path.split("/")[1]
        fn = osp.join(self.base_path, f"keypoints_{self.feature_type}", scene,
                      image_path.split("/")[-1] + f"_{self.feature_type}.npy")
        if fn in self.invalid_fns:
            return None, fn
        return np.load(fn, allow_pickle=True).item(), fn

    def sample_matches_from_offline(self, idx) -> dict[str, Any] | None:
        """One pair's sample, or None (and the image remembered as invalid)
        when an image has fewer than nfeatures keypoints
        (impx/data/megadepth.py:99)."""
        rs = self.rs if self.train else np.random.RandomState(0)
        scene_fn, pair_id = self.dataset[idx]
        data = np.load(
            osp.join(self.base_path, f"matches_sep_{self.feature_type}", scene_fn,
                     f"{pair_id}.npy"), allow_pickle=True).item()

        feat1, fn1 = self._load_feat(data["image_path1"])
        feat2, fn2 = self._load_feat(data["image_path2"])
        if feat1 is None or feat2 is None:
            return None
        nf = self.nfeatures
        if feat1["keypoints"].shape[0] < nf:
            self.invalid_fns.add(fn1)
            return None
        if feat2["keypoints"].shape[0] < nf:
            self.invalid_fns.add(fn2)
            return None

        matched_ids1 = list(data["matched_ids1"])
        matched_ids2 = list(data["matched_ids2"])
        unmatched_ids1 = np.setdiff1d(np.arange(feat1["keypoints"].shape[0]), matched_ids1)
        unmatched_ids2 = np.setdiff1d(np.arange(feat2["keypoints"].shape[0]), matched_ids2)

        n_matches = len(matched_ids1)
        if self.train and self.random_inliers:
            n_inliers = rs.randint(self.min_inliers, self.max_inliers + 1)
            n_matches = min(n_matches, n_inliers)
            n_left = min(len(unmatched_ids1), len(unmatched_ids2))
            n_matches = max(n_matches, nf - n_left)
            order = rs.permutation(len(matched_ids1))
            matched_ids1 = np.asarray(matched_ids1)[order[:n_matches]].tolist()
            matched_ids2 = np.asarray(matched_ids2)[order[:n_matches]].tolist()

        if n_matches > nf:
            sel1 = matched_ids1[:nf]
            sel2 = matched_ids2[:nf]
            n_matches = nf
        else:
            rs.shuffle(unmatched_ids1)
            rs.shuffle(unmatched_ids2)
            sel1 = list(matched_ids1) + unmatched_ids1[: nf - n_matches].tolist()
            sel2 = list(matched_ids2) + unmatched_ids2[: nf - n_matches].tolist()

        shuffle1 = rs.permutation(nf) if self.train else np.arange(nf)
        shuffle2 = rs.permutation(nf) if self.train else np.arange(nf)

        # row inv1[i] (slot i of image 0 after its shuffle) marries column
        # inv2[i]; slots >= n_matches go to the dustbins
        mask = np.zeros((nf + 1, nf + 1), np.float32)
        inv1 = np.argsort(shuffle1)
        inv2 = np.argsort(shuffle2)
        for i in range(nf):
            i1, i2 = inv1[i], inv2[i]
            if i >= n_matches:
                mask[i1, nf] = 1
                mask[nf, i2] = 1
            else:
                mask[i1, i2] = 1

        kpts1 = feat1["keypoints"][sel1][shuffle1]
        kpts2 = feat2["keypoints"][sel2][shuffle2]
        size1 = feat1["image_size"]
        size2 = feat2["image_size"]

        pose1, pose2 = data["pose1"], data["pose2"]
        K1, K2 = data["intrinsics1"], data["intrinsics2"]
        P21 = pose2 @ np.linalg.inv(pose1)
        t0, t1, t2 = P21[:3, 3]
        t_skew = np.array([[0, -t2, t1], [t2, 0, -t0], [-t1, t0, 0]])
        E21 = t_skew @ P21[:3, :3]

        return {
            "keypoints0": kpts1.astype(np.float32),
            "keypoints1": kpts2.astype(np.float32),
            "norm_keypoints0": normalize_size_spg(kpts1, np.array([size1[1], size1[0]])).astype(np.float32),
            "norm_keypoints1": normalize_size_spg(kpts2, np.array([size2[1], size2[0]])).astype(np.float32),
            "descriptors0": feat1["descriptors"][sel1][shuffle1].astype(np.float32),
            "descriptors1": feat2["descriptors"][sel2][shuffle2].astype(np.float32),
            "scores0": feat1["scores"][sel1][shuffle1].astype(np.float32),
            "scores1": feat2["scores"][sel2][shuffle2].astype(np.float32),
            "matching_mask": mask,
            "intrinsics0": np.asarray(K1, np.float32),
            "intrinsics1": np.asarray(K2, np.float32),
            "gt_E": E21.astype(np.float32),
        }


class SyntheticMegadepth:
    """Seeded synthetic pairs in Megadepth's sample layout
    (impx/data/megadepth.py:190): sample idx of epoch seed draws from
    RandomState(seed * 100003 + idx)."""

    def __init__(self, num_pairs: int = 256, nfeatures: int = 512, desc_dim: int = 256, seed: int = 0, **_):
        self.num_pairs = num_pairs
        self.nfeatures = nfeatures
        self.desc_dim = desc_dim
        self.seed = seed

    def build_dataset(self, seed: int = 0):
        self.seed = seed

    def __len__(self):
        return self.num_pairs

    def __getitem__(self, idx):
        rs = np.random.RandomState(self.seed * 100003 + idx)
        return training_sample(rs, nfeatures=self.nfeatures, desc_dim=self.desc_dim)
