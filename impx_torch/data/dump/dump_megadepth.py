"""MegaDepth training-data factory (impx/data/dump/dump_megadepth.py;
reference dump/dump_megadepth.py).

Two passes over the raw MegaDepth release:
  1. per-image feature extraction (SuperPoint 4096 kpts det_th 0.001 / RootSIFT)
     + depth lookup at keypoints, saved as per-image
     `keypoints_{feat}/{scene}/{img}_{feat}.npy` dicts;
  2. `build_correspondence`: select image pairs by 3D-overlap ratio
     0.1-0.7 from `scene_info/{scene}.0.npz`, label GT matches by cycle-checked
     depth reprojection (inlier 5px / outlier 15px — on the device via
     impx_torch.geometry.reprojection), de-duplicate, and save per-scene
     `matches_{feat}/{scene}.npy` + per-pair `matches_sep_{feat}/{scene}/{i}.npy`
     + the per-scene pair-count table `mega_scene_nmatches_{feat}.npy` the
     training dataset samples from (impx/data/megadepth.py).

SuperPoint and the labelling run on the CUDA device unless --device names
another. cv2 and h5py are imported inside the functions that use them.

CLI: python -m impx_torch.data.dump.dump_megadepth --feature_type spp \
        --base_path <megadepth root> --save_dir <dump root> \
        --scene_list_fn assets/megadepth_train_scenes.txt [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np
import torch

from impx_torch.device import resolve_device

parser = argparse.ArgumentParser()
parser.add_argument("--base_path", type=str, required=True)
parser.add_argument("--save_dir", type=str, required=True)
parser.add_argument("--scene_info_path", type=str, default=None)
parser.add_argument("--scene_list_fn", type=str, required=True)
parser.add_argument("--feature_type", type=str, default="spp", choices=["spp", "sift"])
parser.add_argument("--nfeatures", type=int, default=4096)
parser.add_argument("--min_overlap_ratio", type=float, default=0.1)
parser.add_argument("--max_overlap_ratio", type=float, default=0.7)
parser.add_argument("--inlier_th", type=float, default=5.0)
parser.add_argument("--outlier_th", type=float, default=15.0)
parser.add_argument("--spp_weights", type=str, default="weights/superpoint_v1.pth")
parser.add_argument("--device", type=str, default=None,
                    help="SuperPoint's and the labelling's device (default: the CUDA card)")


class MegadepthDumper:
    def __init__(self, args):
        self.args = args
        self.scene_info_path = args.scene_info_path or osp.join(args.base_path, "scene_info")
        with open(args.scene_list_fn) as f:
            self.scenes = [line.strip() for line in f if line.strip()]
        self.feature_type = args.feature_type
        self.device = resolve_device(args.device)
        if args.feature_type == "spp":
            from impx_torch.data.extractors import ExtractSuperpoint

            self.extractor = ExtractSuperpoint({
                "num_kpt": args.nfeatures, "det_th": 0.001, "resize": [-1],
                "weight_path": args.spp_weights,
            }, device=self.device)
        else:
            from impx_torch.data.extractors import ExtractSIFT

            self.extractor = ExtractSIFT(
                {"num_kpt": args.nfeatures, "det_th": 0.04, "resize": [-1]}, root=True)

    # --------------------------------------------------------- pass 1: features
    def keypoint_path(self, save_dir, scene, image_path):
        return osp.join(save_dir, f"keypoints_{self.feature_type}", scene,
                        osp.basename(image_path) + f"_{self.feature_type}.npy")

    def extract_scene_features(self, scene):
        """Extract features + keypoint depths for every image of a scene
        (reference dump_megadepth.py:143-170, :447-477)."""
        import cv2
        import h5py

        info_fn = osp.join(self.scene_info_path, f"{scene}.0.npz")
        if not osp.exists(info_fn):
            print(f"scene_info missing for {scene}")
            return
        info = np.load(info_fn, allow_pickle=True)
        out_dir = osp.join(self.args.save_dir, f"keypoints_{self.feature_type}", scene)
        os.makedirs(out_dir, exist_ok=True)

        for image_path, depth_path, pose, K in zip(
                info["image_paths"], info["depth_paths"], info["poses"], info["intrinsics"]):
            if image_path is None:
                continue
            out_fn = self.keypoint_path(self.args.save_dir, scene, image_path)
            if osp.isfile(out_fn):
                continue
            img = cv2.imread(osp.join(self.args.base_path, image_path))
            if img is None:
                continue
            kp, desc = self.extractor.run(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
            with h5py.File(osp.join(self.args.base_path, depth_path), "r") as hf:
                depth = np.asarray(hf["/depth"])
            xi = np.clip(kp[:, 0].astype(int), 0, depth.shape[1] - 1)
            yi = np.clip(kp[:, 1].astype(int), 0, depth.shape[0] - 1)
            np.save(out_fn, {
                "image_path": image_path, "depth_path": depth_path,
                "keypoints": kp[:, :2], "scores": kp[:, 2], "descriptors": desc,
                "image_size": np.array(img.shape, int),
                "depth": depth[yi, xi], "pose": pose, "intrinsics": K,
            })

    # ------------------------------------------------- pass 2: correspondences
    def build_correspondence(self, scene):
        """Reference dump_megadepth.py:175-361."""
        from impx_torch.geometry.reprojection import match_from_projection_points

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

        args = self.args
        match_dir = osp.join(args.save_dir, f"matches_{self.feature_type}")
        os.makedirs(match_dir, exist_ok=True)
        if osp.isfile(osp.join(match_dir, scene + ".npy")):
            return

        info_fn = osp.join(self.scene_info_path, f"{scene}.0.npz")
        if not osp.exists(info_fn):
            return
        info = np.load(info_fn, allow_pickle=True)
        overlap = info["overlap_matrix"]
        scale_ratio = info["scale_ratio_matrix"]
        valid = (overlap >= args.min_overlap_ratio) & (overlap <= args.max_overlap_ratio)
        valid &= scale_ratio <= np.inf
        pairs = np.vstack(np.where(valid))

        image_paths = info["image_paths"]
        pts3d_to_2d = info["points3D_id_to_2D"]
        poses = info["poses"]
        intrinsics = info["intrinsics"]

        cache: dict[str, dict] = {}

        def load_feat(path):
            fn = self.keypoint_path(args.save_dir, scene, path)
            if fn not in cache:
                if not osp.isfile(fn):
                    return None
                cache[fn] = np.load(fn, allow_pickle=True).item()
            return cache[fn]

        valid_pairs = []
        for pair_idx in range(pairs.shape[1]):
            idx1, idx2 = pairs[0, pair_idx], pairs[1, pair_idx]
            shared_3d = pts3d_to_2d[idx1].keys() & pts3d_to_2d[idx2].keys()
            if len(shared_3d) < 20:
                continue
            d1 = load_feat(image_paths[idx1])
            d2 = load_feat(image_paths[idx2])
            if d1 is None or d2 is None:
                continue
            if d1["keypoints"].shape[0] < 1024 or d2["keypoints"].shape[0] < 1024:
                continue

            v1 = d1["depth"] > 0
            v2 = d2["depth"] > 0
            ids1 = np.where(v1)[0]
            ids2 = np.where(v2)[0]
            if len(ids1) <= 20 or len(ids2) <= 20:
                continue

            m12, _ = match_from_projection_points(
                f32(d1["keypoints"][ids1]), f32(d1["depth"][ids1]),
                f32(intrinsics[idx1]), f32(poses[idx1]),
                f32(d2["keypoints"][ids2]), f32(d2["depth"][ids2]),
                f32(intrinsics[idx2]), f32(poses[idx2]),
                inlier_th=args.inlier_th, outlier_th=args.outlier_th, cycle_check=True)
            m12 = m12.cpu().numpy()
            matched = np.where(m12 >= 0)[0]
            if len(matched) <= 20:
                continue

            # de-duplicate (reference dump_megadepth.py:320-328)
            matched_ids1, matched_ids2 = [], []
            seen1, seen2 = set(), set()
            for i in matched:
                g1 = int(ids1[i])
                g2 = int(ids2[m12[i]])
                if g1 in seen1 or g2 in seen2:
                    continue
                seen1.add(g1)
                seen2.add(g2)
                matched_ids1.append(g1)
                matched_ids2.append(g2)

            valid_pairs.append({
                "image_path1": image_paths[idx1], "depth_path1": info["depth_paths"][idx1],
                "intrinsics1": intrinsics[idx1], "pose1": poses[idx1],
                "image_path2": image_paths[idx2], "depth_path2": info["depth_paths"][idx2],
                "intrinsics2": intrinsics[idx2], "pose2": poses[idx2],
                "matched_ids1": np.array(matched_ids1, int),
                "matched_ids2": np.array(matched_ids2, int),
            })

        if valid_pairs:
            np.save(osp.join(match_dir, scene), valid_pairs)
        print(f"{scene}: {len(valid_pairs)}/{pairs.shape[1]} valid pairs")
        return len(valid_pairs)

    def write_matches_sep(self, scene):
        """Per-pair npy files (reference write_matches, dump_megadepth.py:363-376)."""
        match_dir = osp.join(self.args.save_dir, f"matches_{self.feature_type}")
        fn = osp.join(match_dir, scene + ".npy")
        if not osp.isfile(fn):
            return 0
        data = np.load(fn, allow_pickle=True)
        out_dir = osp.join(self.args.save_dir, f"matches_sep_{self.feature_type}", scene)
        os.makedirs(out_dir, exist_ok=True)
        for idx, d in enumerate(data):
            np.save(osp.join(out_dir, f"{idx}"), d)
        return len(data)

    def run(self):
        counts = {}
        for scene in self.scenes:
            self.extract_scene_features(scene)
            self.build_correspondence(scene)
            counts[scene] = self.write_matches_sep(scene)
        # merge per-scene counts (reference dump_megadepth.py:491-499)
        table_fn = osp.join(self.args.save_dir,
                            f"mega_scene_nmatches_{self.feature_type}.npy")
        if osp.isfile(table_fn):
            merged = np.load(table_fn, allow_pickle=True).item()
        else:
            merged = {}
        merged.update({k: v for k, v in counts.items() if v})
        np.save(table_fn, merged)
        print(f"pair-count table -> {table_fn} ({len(merged)} scenes)")


def main(argv=None):
    args = parser.parse_args(argv)
    MegadepthDumper(args).run()


if __name__ == "__main__":
    main()
