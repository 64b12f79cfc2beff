"""Two-image matching demo (impx/demo.py).

  python -m impx_torch.demo --image0 a.jpg --image1 b.jpg --feature sift \\
      [--weights weights/imp_sift.pth] [--output matches.png] [--fx 1200] \\
      [--matching_method EIMP] [--device cpu]

Extract features (SIFT needs no weights; SuperPoint reads superpoint_v1.pth,
FileNotFoundError without it), run the matcher's produce_matches, estimate
the relative pose with cv2 when --fx > 0 (principal point at the image
centre), and write the matches as a PNG. SuperPoint and the matcher run on
the CUDA device unless --device names another. Without --weights the matcher
keeps its random seed-0 weights, which differ from impx's PRNGKey(0) ones:
compare the two demos on one .pth in the reference layout.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from impx_torch.data.reader import pad_features, round_up
from impx_torch.device import resolve_device
from impx_torch.eval.eval_imp import build_model, load_params
from impx_torch.geometry.keypoints import normalize_keypoints

parser = argparse.ArgumentParser()
parser.add_argument("--image0", type=str, required=True)
parser.add_argument("--image1", type=str, required=True)
parser.add_argument("--feature", type=str, default="sift", choices=["sift", "spp"])
parser.add_argument("--num_kpt", type=int, default=1024)
parser.add_argument("--weights", type=str, default=None,
                    help="the matcher's .pth in the reference layout")
parser.add_argument("--matching_method", type=str, default="IMP",
                    choices=["IMP", "EIMP"])
parser.add_argument("--match_threshold", type=float, default=0.2)
parser.add_argument("--output", type=str, default="matches.png")
parser.add_argument("--fx", type=float, default=0.0,
                    help="focal length in px; >0 enables pose estimation "
                         "(principal point assumed at the image center)")
parser.add_argument("--sp_weights", type=str, default="weights/superpoint_v1.pth")
parser.add_argument("--device", type=str, default=None,
                    help="SuperPoint's and the matcher's device (default: the CUDA card)")


def feature_extractor(args, device: torch.device):
    if args.feature == "sift":
        from impx_torch.data.extractors import ExtractSIFT

        return ExtractSIFT({"num_kpt": args.num_kpt, "det_th": 1e-5, "resize": [-1]})
    from impx_torch.data.extractors import ExtractSuperpoint

    return ExtractSuperpoint({"num_kpt": args.num_kpt, "det_th": 0.005,
                              "resize": [-1], "weight_path": args.sp_weights}, device=device)


def load_image_features(extractor, path):
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise SystemExit(f"cannot read {path}")
    kpt, desc = extractor.run(img)
    return img, kpt, desc


def main(argv=None):
    import cv2

    from impx_torch.tools.viz import draw_matches, matches_from_indices0

    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    extractor = feature_extractor(args, device)
    img0, kpt0, desc0 = load_image_features(extractor, args.image0)
    img1, kpt1, desc1 = load_image_features(extractor, args.image1)
    print(f"features: {len(kpt0)} / {len(kpt1)}")

    model = build_model(args.matching_method, args.feature, device=device)
    load_params(model, args.weights)

    bucket = round_up(max(len(kpt0), len(kpt1), 128), 128)
    x0, d0, v0 = pad_features(kpt0, desc0, bucket)
    x1, d1, v1 = pad_features(kpt1, desc1, bucket)

    def t(a):
        return torch.as_tensor(a, device=device)[None]

    feed = {
        "descriptors0": t(d0), "descriptors1": t(d1),
        "norm_keypoints0": normalize_keypoints(t(x0[:, :2]), img0.shape[0], img0.shape[1]),
        "norm_keypoints1": normalize_keypoints(t(x1[:, :2]), img1.shape[0], img1.shape[1]),
        "scores0": t(x0[:, 2]), "scores1": t(x1[:, 2]),
        "valid0": t(v0), "valid1": t(v1),
    }
    out = model.produce_matches(feed, p=args.match_threshold, only_last=True)
    indices0 = out["indices0"][-1][0].cpu().numpy()
    matches = matches_from_indices0(indices0)
    print(f"matches: {len(matches)}")

    inliers = None
    if args.fx > 0 and len(matches) >= 5:
        from impx_torch.ransac.pose_solver import estimate_pose

        K0 = np.array([[args.fx, 0, img0.shape[1] / 2],
                       [0, args.fx, img0.shape[0] / 2], [0, 0, 1]])
        K1 = np.array([[args.fx, 0, img1.shape[1] / 2],
                       [0, args.fx, img1.shape[0] / 2], [0, 0, 1]])
        ret = estimate_pose(x0[matches[:, 0], :2], x1[matches[:, 1], :2],
                            K0, K1, norm_thresh=1.0)
        if ret is not None:
            _, R, t_, mask = ret
            inliers = mask[: len(matches)]
            print(f"pose inliers: {int(np.sum(inliers))}; R=\n{R}\nt={t_}")

    canvas = draw_matches(img0, img1, x0[:, :2], x1[:, :2], matches, inliers)
    cv2.imwrite(args.output, canvas)
    print(f"wrote {args.output}")
    return {"features": (len(kpt0), len(kpt1)), "matches": matches, "inliers": inliers}


if __name__ == "__main__":
    main()
