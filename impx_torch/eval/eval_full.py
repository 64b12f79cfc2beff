"""Full evaluation over a standard-reader HDF5 (impx/eval/eval_full.py).

`evaluate_full(model, opt)`: iterate the reader, match each pair with
keypoints normalized by image size (scale 0.7, the reference's feed_match_v2),
score with AucEval, return auc@5/10/15/20, precision and matching score
(impx's trainer runs it every five epochs). AucEval's device backend runs on
the model's device, one generator per pair seeded from (seed, pair index).
"""
from __future__ import annotations

import numpy as np

from impx_torch.data.reader import pad_features, round_up
from impx_torch.eval.evaluator import AucEval


def normalize_by_size(x, size_wh):
    """(x - size/2 - 0.5) / (0.7 * max(size)), size = (w, h)."""
    size = np.asarray(size_wh, np.float32).reshape(1, 2)
    return (x - size / 2.0 - 0.5) / (size.max() * 0.7)


def pair_feed(info, bucket: int):
    """One pair padded to `bucket`: (feed of unbatched numpy arrays, x0, x1),
    x0/x1 the padded [bucket, 3] keypoints."""
    x0, d0, v0 = pad_features(info["x1"], info["desc1"], bucket)
    x1, d1, v1 = pad_features(info["x2"], info["desc2"], bucket)
    h0, w0 = info.get("img_size1", (480, 640))
    h1, w1 = info.get("img_size2", (480, 640))
    feed = {
        "descriptors0": d0, "descriptors1": d1,
        "norm_keypoints0": normalize_by_size(x0[:, :2], [w0, h0]),
        "norm_keypoints1": normalize_by_size(x1[:, :2], [w1, h1]),
        "scores0": x0[:, 2], "scores1": x1[:, 2],
        "valid0": v0, "valid1": v1,
    }
    return feed, x0, x1


def matched_points(x0, x1, indices0, bucket: int):
    """Pixel coordinates (corr1, corr2) of the matched keypoints."""
    valid = indices0 > -1
    return x0[valid, :2], x1[np.clip(indices0[valid], 0, bucket - 1), :2]


def produce_indices(model, feed: dict) -> np.ndarray:
    """indices0 of the last iteration for a batched numpy feed, [B, N]."""
    out = model.produce_matches(feed, p=model.config.match_threshold, only_last=True,
                                with_scores=False)
    return out["indices0"][-1].cpu().numpy()


def feed_match(model, info, bucket: int):
    """Match one pair; returns the matched pixel coordinates (corr1, corr2)."""
    feed, x0, x1 = pair_feed(info, bucket)
    indices0 = produce_indices(model, {k: v[None] for k, v in feed.items()})[0]
    return matched_points(x0, x1, indices0, bucket)


def eval_payload(info, corr1, corr2) -> dict:
    """AucEval.run's input for one pair."""
    return {"e": info["e"], "r_gt": info["r_gt"], "t_gt": info["t_gt"],
            "K1": info["K1"], "K2": info["K2"], "corr1": corr1, "corr2": corr2,
            "n_kpts1": len(info["x1"]), "index": info["index"]}


def split_opt(opt: dict, dataset: str):
    """(reader config, evaluator config) of `opt`, per dataset or shared."""
    sub = opt[dataset] if dataset in opt else opt
    return sub["reader"], sub["evaluator"]


def summary(evaluator: AucEval) -> dict:
    parsed = evaluator.parse()
    exact = parsed["exact_auc"]
    return {
        "auc5": 100 * exact[0], "auc10": 100 * exact[1],
        "auc15": 100 * exact[2], "auc20": 100 * exact[3],
        "prec": parsed["mean_precision"],
        "mscore": parsed["mean_match_score"],
    }


def evaluate_full(model, opt: dict, dataset: str = "yfcc", feat_type: str = "spp",
                  max_pairs: int = -1) -> dict:
    """opt: {'reader': ..., 'evaluator': ...}, or the same under opt[dataset].
    The evaluator config's ransac_th (1.0) is the pose threshold in pixels."""
    from impx_torch.data.reader import StandardReader

    read_cfg, eval_cfg = split_opt(opt, dataset)
    evaluator = AucEval(eval_cfg, device=model.device)
    reader = StandardReader(read_cfg)
    try:
        bucket = round_up(reader.num_kpt, 128)
        n = len(reader) if max_pairs < 0 else min(max_pairs, len(reader))
        for index in range(n):
            info = reader.run(index)
            corr1, corr2 = feed_match(model, info, bucket)
            res = evaluator.run(eval_payload(info, corr1, corr2), th=eval_cfg.get("ransac_th", 1.0))
            evaluator.res_inqueue(res)
    finally:
        reader.close()
    return summary(evaluator)
