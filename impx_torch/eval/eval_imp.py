"""Main eval CLI (impx/eval/eval_imp.py).

Usage:
  python -m impx_torch.eval.eval_imp --matching_method IMP --dataset yfcc \\
      --feature_type spp [--pose_backend cv2|device] [--use_iterative \\
      [--use_uncertainty] [--checkpoint_backend jax|cv2]] [--config_path ...] \\
      [--weight_path ...] [--device cpu]

--use_iterative runs the iterative match-pose loop with early stopping
(impx_torch/eval/iterative.py): batches of --eval_batch pairs with the pose
solved on the device at each checkpoint when eval_batch > 1, else pair by
pair, and always pair by pair under --checkpoint_backend cv2 (host
USAC_MAGSAC on pixel coordinates, the reference protocol). A pair's
generator, seeded from (seed, pair index), serves every checkpoint, so the
serial and the batched loops give it the same samples. A pair scores the
loop's own pose when the loop has one.

Each batch of `--eval_batch` pairs, padded to one keypoint bucket, goes
through the matcher in one `produce_matches` call (the CUDA kernels on the
card, their plain versions with --device cpu); each pair's matches are then
scored on the host: epipolar precision and matching score against the
ground-truth E, and the pose error of the pose estimated from the matches by
`--pose_backend`. impx's non-iterative path ignores that flag and always runs
cv2 (impx/eval/eval_imp.py:171); here it is honoured, and 'cv2' stays the
default. The device backend draws from a generator per pair, seeded from
(seed, pair index).

--data_parallel (impx/eval/eval_imp.py:197-217) splits each batch's pairs
over the ranks of a process group, launched by torchrun (each rank on
cuda:LOCAL_RANK): rank r runs the matcher, or the batched iterative loop, on
the r-th contiguous block of the batch, the outputs are all-gathered, and
rank 0 scores and prints; every rank returns rank 0's results. The loop's
all-converged test is all-reduced. --eval_batch must divide over the ranks
(SystemExit). At world size 1, or outside a process group, it changes
nothing, as impx on one device.

  torchrun --nproc_per_node=4 -m impx_torch.eval.eval_imp --config_path <yaml> --eval_batch 8 \
      --data_parallel [--use_iterative]

h5py (the reader), yaml (the config) and cv2 (the cv2 backend) are imported
only where they are used: the module imports without them.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import os.path as osp
import time

import numpy as np
import torch

from impx_torch.data.reader import pad_features, round_up
from impx_torch.device import resolve_device
from impx_torch.eval.evaluator import device_pose, pair_generator, pose_backend
from impx_torch.eval.iterative import CHECKPOINT_BACKENDS, BatchedIterativeMatcher
from impx_torch.geometry import pose as pose_metrics
from impx_torch.geometry.epipolar import compute_epi_inlier_np
from impx_torch.geometry.pose import compute_pose_error_np
from impx_torch.models import AdaGMN, DGNNS, MatcherConfig
from impx_torch.ransac.pose_solver import _norm_threshold, estimate_pose

parser = argparse.ArgumentParser(
    description="IMP / EIMP evaluation on the H100 (impx_torch)",
    epilog="impx's --attn_impl has no counterpart: the port picks the attention by "
           "device, the CUDA kernels on the card and their plain PyTorch versions on the "
           "CPU (--device cpu).")
parser.add_argument("--matching_method", type=str, default="IMP",
                    choices=["IMP", "IMP_geo", "EIMP", "EIMP_geo"])
parser.add_argument("--dataset", type=str, default="scannet")
parser.add_argument("--feature_type", type=str, default="spp")
parser.add_argument("--pose_backend", type=str, default="cv2", choices=["cv2", "device", "jax"],
                    help="cv2 = host USAC_MAGSAC (the published protocol); device = "
                         "eight-point RANSAC on the matcher's device ('jax' is a synonym)")
parser.add_argument("--config_path", type=str, default=None)
parser.add_argument("--weight_path", type=str, default=None)
parser.add_argument("--weight_root", type=str, default="weights")
parser.add_argument("--max_pairs", type=int, default=-1)
parser.add_argument("--layers", type=int, default=15,
                    help="matcher iterations (15 = the published eval config; "
                         "smaller values are for CPU smoke runs only)")
parser.add_argument("--bucket", type=int, default=-1, help="keypoint padding bucket")
parser.add_argument("--compute_dtype", type=str, default="float32", choices=["float32", "bfloat16"])
parser.add_argument("--eval_batch", type=int, default=4, help="pairs per matcher call")
parser.add_argument("--compaction", type=str, default="",
                    help="EIMP bucketed compaction schedule 'it:bucket[,it:bucket]' "
                         "(e.g. '4:1024'); a pair whose survivors overflow a bucket is "
                         "re-run mask-only")
parser.add_argument("--device", type=str, default=None,
                    help="the matcher's device (default: the CUDA card; 'cpu' runs the "
                         "kernels' plain versions)")
parser.add_argument("--use_dual_softmax", action="store_true", default=False,
                    help="the dual-softmax score head in place of the dustbin Sinkhorn")
parser.add_argument("--use_iterative", action="store_true", default=False,
                    help="the iterative match-pose loop with early stopping")
parser.add_argument("--use_uncertainty", action="store_true", default=False,
                    help="with --use_iterative and EIMP: pool keypoints after each checkpoint")
parser.add_argument("--checkpoint_backend", type=str, default="jax", choices=["jax", "device", "cv2"],
                    help="pose solver at the iterative loop's checkpoints: jax (impx's name) or "
                         "device = five-point RANSAC on the matcher's device; cv2 = host "
                         "USAC_MAGSAC as the reference's loop (pair by pair)")
parser.add_argument("--ransac_hypotheses", type=int, default=4096,
                    help="minimal sets a checkpoint of the device checkpoint solver")
parser.add_argument("--data_parallel", action="store_true", default=False,
                    help="split each eval batch's pairs over the ranks of the process group (torchrun); "
                         "--eval_batch must be a multiple of the world size")

# reference weight-name table (reference eval/eval_imp.py:274-329)
WEIGHT_TABLE = {
    "IMP_geo": {"spp": {"scannet": "imp_geo_spp_scannet.pth", "yfcc": "imp_geo_spp_yfcc.pth"},
                "sift": {"scannet": "imp_geo_sift.pth", "yfcc": "imp_geo_sift.pth"}},
    "IMP": {"spp": {"scannet": "imp_spp.pth", "yfcc": "imp_spp.pth"},
            "sift": {"scannet": "imp_sift.pth", "yfcc": "imp_sift.pth"}},
    "EIMP": {"spp": {"scannet": "eimp_spp.pth", "yfcc": "eimp_spp.pth"},
             "sift": {"scannet": "eimp_sift.pth", "yfcc": "eimp_sift.pth"}},
    "EIMP_geo": {"spp": {"scannet": "eimp_geo_spp_scannet.pth", "yfcc": "eimp_geo_spp_yfcc.pth"},
                 "sift": {"scannet": "eimp_geo_sift.pth", "yfcc": "eimp_geo_sift.pth"}},
}


def data_parallel_group(args):
    """The world's process group under --data_parallel at a world size above
    1, else None (impx on one device). SystemExit when --eval_batch does not
    split over the ranks (impx/eval/eval_imp.py:203-208)."""
    import torch.distributed as dist

    if not getattr(args, "data_parallel", False) or not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    n = dist.get_world_size()
    if args.eval_batch % n:
        raise SystemExit(f"--data_parallel requires --eval_batch divisible by the world size ({n}); "
                         f"got --eval_batch {args.eval_batch}")
    if dist.get_rank() == 0:
        print(f"data-parallel eval over {n} ranks" + (" (iterative)" if args.use_iterative else ""))
    return dist.group.WORLD


def _gather_pairs(out: dict, group) -> dict:
    """Each tensor of `out` ([B_rank, ...] a rank) all-gathered along its pair
    axis; bools travel as uint8."""
    from impx_torch.parallel.collectives import all_gather

    gathered = {}
    for k, v in out.items():
        if isinstance(v, torch.Tensor):
            g = all_gather(v.to(torch.uint8) if v.dtype == torch.bool else v, group)
            v = g.bool() if v.dtype == torch.bool else g
        gathered[k] = v
    return gathered


def _shard(batch: dict, group) -> dict:
    """This rank's contiguous block of a batch's pairs."""
    import torch.distributed as dist

    from impx_torch.parallel.mesh import shard_rows

    return {k: shard_rows(v, dist.get_rank(group), dist.get_world_size(group)) for k, v in batch.items()}


def _share_results(results: dict | None, group) -> dict:
    """Rank 0's results on every rank."""
    if group is None:
        return results
    import torch.distributed as dist

    box = [results]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


def _normalize_keypoints_np(kpts, height, width, scale=0.7):
    size = np.array([width, height], np.float32)
    return (kpts - size / 2.0) / (size.max() * scale)


def _normalize_intrinsic_np(x, K):
    K = np.asarray(K)
    return (x - K[:2, 2]) / np.array([K[0, 0], K[1, 1]])


def parse_compaction(spec: str) -> tuple:
    """'4:1024,8:512' -> ((4, 1024), (8, 512))."""
    if not spec:
        return ()
    return tuple(tuple(int(v) for v in part.split(":")) for part in spec.split(","))


def build_model(matching_method: str, feature: str, use_sinkhorn: bool = True, n_layers: int = 15,
                compute_dtype: str = "float32", compaction: tuple = (), device=None):
    """DGNNS (IMP) or AdaGMN (EIMP) at MatcherConfig.eval_config, with random
    weights from seed 0 until `load_params`; use_sinkhorn=False is the
    dual-softmax head (impx/eval/eval_imp.py:110-121)."""
    cfg = dataclasses.replace(MatcherConfig.eval_config(feature, n_layers=n_layers),
                              with_sinkhorn=use_sinkhorn, compute_dtype=compute_dtype,
                              compaction=tuple(compaction))
    cls = AdaGMN if matching_method.startswith("EIMP") else DGNNS
    return cls(cfg, device=device)


def load_params(model, weight_file: str | None) -> None:
    """Load a reference checkpoint into `model` if the file exists; else keep
    its random weights (synthetic / development runs)."""
    if weight_file and osp.isfile(weight_file):
        from impx_torch.tools.convert import load_matcher_checkpoint

        print(f"Loading converted torch weights from {weight_file}")
        model.load_state_dict(load_matcher_checkpoint(weight_file, model.config, model.sharing))
        return
    print("WARNING: no weights found — using random init (synthetic/dev mode)")


def _pair_feed_np(info, bucket):
    x0, d0, v0 = pad_features(info["x1"], info["desc1"], bucket)
    x1, d1, v1 = pad_features(info["x2"], info["desc2"], bucket)
    h0, w0 = info.get("img_size1", (480, 640))
    h1, w1 = info.get("img_size2", (480, 640))
    return {
        "descriptors0": d0, "descriptors1": d1,
        "norm_keypoints0": _normalize_keypoints_np(x0[:, :2], h0, w0),
        "norm_keypoints1": _normalize_keypoints_np(x1[:, :2], h1, w1),
        "scores0": x0[:, 2], "scores1": x1[:, 2],
        "valid0": v0, "valid1": v1,
    }, x0, x1


def _score_pair(info, x0, x1, matches, bucket, pose_errors, precisions, matching_scores, error_th,
                backend: str = "cv2", device=None, generator=None, pred_R=None, pred_t=None,
                has_pose: bool = False):
    """Append one pair's pose error (max of the rotation and translation
    angles, inf without a pose), precision and matching score. With has_pose
    the error is that of (pred_R, pred_t), the iterative loop's own pose
    (impx/eval/eval_imp.py:148); otherwise the pose is estimated from the
    matches, backend 'device' on `device` drawing from `generator`."""
    K0, K1 = info["K1"], info["K2"]
    valid = matches > -1
    mkpts0 = x0[valid, :2]
    mkpts1 = x1[np.clip(matches[valid], 0, bucket - 1), :2]
    T_0to1 = np.hstack([info["r_gt"], info["t_gt"].reshape(3, 1)])

    norm_m0 = _normalize_intrinsic_np(mkpts0, K0)
    norm_m1 = _normalize_intrinsic_np(mkpts1, K1)
    if len(norm_m0) > 0:
        correct = compute_epi_inlier_np(norm_m0, norm_m1, info["e"], 0.005)
        precision = float(correct.mean())
        matching_score = float(correct.sum() / max(len(info["x1"]), 1))
    else:
        precision = matching_score = 0.0

    pose = (pred_R, pred_t) if has_pose else None
    if not has_pose and len(mkpts0) >= 5:
        if backend == "device":
            pose = device_pose(norm_m0, norm_m1, _norm_threshold(error_th, K0, K1), device, generator)
        else:
            ret = estimate_pose(mkpts0, mkpts1, K0, K1, error_th)
            pose = None if ret is None else ret[1:3]
    if pose is None:
        err_t = err_R = np.inf
    else:
        err_t, err_R = compute_pose_error_np(T_0to1, *pose)
    pose_errors.append(max(err_R, err_t))
    precisions.append(precision)
    matching_scores.append(matching_score)


def _print_progress(index, n_pairs, thresholds, pose_errors, precisions, matching_scores, t_device):
    aucs = [100 * a for a in pose_metrics.pose_auc(pose_errors, thresholds)]
    print(f"[{index}/{n_pairs}] AUC@5/10/20/50: "
          f"{aucs[0]:.2f}/{aucs[1]:.2f}/{aucs[2]:.2f}/{aucs[3]:.2f} "
          f"Prec {100 * np.mean(precisions):.2f} "
          f"MScore {100 * np.mean(matching_scores):.2f} "
          f"({t_device / max(index, 1) * 1000:.1f} ms/pair device)")


def _results(thresholds, pose_errors, precisions, matching_scores, stop_its, t_device, t_start) -> dict:
    aucs = [100 * a for a in pose_metrics.pose_auc(pose_errors, thresholds)]
    return {
        "auc": dict(zip(thresholds, aucs)),
        "precision": 100 * float(np.mean(precisions)),
        "matching_score": 100 * float(np.mean(matching_scores)),
        "mean_stop_iteration": float(np.mean(stop_its)),
        "pairs_per_sec_device": (len(pose_errors) / t_device) if t_device > 0 else 0.0,
        "total_time": time.time() - t_start,
    }


def evaluate(model, reader, error_th: float, eval_config: dict, args) -> dict:
    """The eval loop over `reader` (StandardReader's interface: num_kpt,
    __len__, run(index)). Non-iterative: batches of args.eval_batch pairs
    (the last padded by repeating its last pair) through
    `model.produce_matches`, then each pair scored by `_score_pair` with
    args.pose_backend on the model's device; under EIMP compaction, a pair
    whose survivors overflowed a bucket is re-run through a mask-only copy of
    the model. args.use_iterative: `evaluate_iterative`.

    args: max_pairs, bucket (<= 0: round_up(num_kpt, 128)), eval_batch,
    pose_backend, use_iterative, use_uncertainty, checkpoint_backend,
    ransac_hypotheses, data_parallel (see the module docstring). eval_config:
    seed (0) seeds each pair's generator."""
    group = data_parallel_group(args)
    if getattr(args, "use_iterative", False):
        return evaluate_iterative(model, reader, error_th, eval_config, args, group)
    main_rank = group is None or torch.distributed.get_rank(group) == 0
    backend = pose_backend(getattr(args, "pose_backend", "cv2"))
    seed = eval_config.get("seed", 0)
    thresholds = [5, 10, 20, 50]
    pose_errors, precisions, matching_scores = [], [], []
    n_pairs = len(reader) if args.max_pairs < 0 else min(args.max_pairs, len(reader))
    bucket = args.bucket if args.bucket > 0 else round_up(reader.num_kpt, 128)
    eb = max(1, getattr(args, "eval_batch", 4))

    def produce(m, batch):
        return m.produce_matches(batch, p=0.2, only_last=True, with_scores=False)

    t_start = time.time()
    t_device = 0.0
    index = 0
    n_overflow_pairs = 0
    fallback = None  # the mask-only model, built on the first overflow
    while index < n_pairs:
        infos, x0s, x1s, feeds = [], [], [], []
        for _ in range(min(eb, n_pairs - index)):
            info = reader.run(index)
            feed, x0, x1 = _pair_feed_np(info, bucket)
            infos.append(info)
            x0s.append(x0)
            x1s.append(x1)
            feeds.append(feed)
            index += 1
        while len(feeds) < eb:  # pad the last batch
            feeds.append(feeds[-1])
        batch = {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}
        t0 = time.time()
        if group is None:
            out = produce(model, batch)
            out = {"indices0": out["indices0"][-1], **{k: out[k] for k in ("overflow0", "overflow1") if k in out}}
        else:
            out = produce(model, _shard(batch, group))
            out = _gather_pairs({"indices0": out["indices0"][-1],
                                 **{k: out[k] for k in ("overflow0", "overflow1") if k in out}}, group)
        t_device += time.time() - t0
        if not main_rank:
            continue
        t0 = time.time()
        matches_b = out["indices0"].cpu().numpy()
        # compaction overflow: re-run the affected pairs mask-only (which keeps
        # every survivor), so a tight schedule never silently loses matches
        if "overflow0" in out:
            ovf = (out["overflow0"] + out["overflow1"]).cpu().numpy()
            bad = np.flatnonzero(ovf[:len(infos)] > 0)
            if len(bad):
                n_overflow_pairs += len(bad)
                print(f"WARNING: compaction overflow on pairs "
                      f"{(index - len(infos) + bad).tolist()} "
                      f"(dropped {ovf[bad].tolist()} survivors) — re-running mask-only")
                if fallback is None:
                    fallback = type(model)(dataclasses.replace(model.config, compaction=()),
                                           device=model.device, use_kernels=model.use_kernels)
                    fallback.load_state_dict(model.state_dict())
                matches_b[bad] = produce(fallback, batch)["indices0"][-1].cpu().numpy()[bad]
        t_device += time.time() - t0
        for bi, info in enumerate(infos):
            pair = index - len(infos) + bi
            generator = pair_generator(model.device, seed, pair) if backend == "device" else None
            _score_pair(info, x0s[bi], x1s[bi], matches_b[bi], bucket, pose_errors, precisions,
                        matching_scores, error_th, backend=backend, device=model.device,
                        generator=generator)
        if index % 100 < eb or index >= n_pairs:
            _print_progress(index, n_pairs, thresholds, pose_errors, precisions, matching_scores,
                            t_device)
    if not main_rank:
        return _share_results(None, group)
    results = _results(thresholds, pose_errors, precisions, matching_scores, [model.config.n_layers],
                       t_device, t_start)
    if model.config.compaction:
        results["compaction_overflow_pairs"] = n_overflow_pairs
    return _share_results(results, group)


# the matcher's arrays of a feed (`_pair_feed_np`), which take a batch axis
MATCHER_FEED = ("descriptors0", "descriptors1", "norm_keypoints0", "norm_keypoints1", "scores0", "scores1",
                "valid0", "valid1")


def _iterative_feed(info, bucket: int, error_th: float, pixels: bool):
    """One pair's feed of the iterative loop: the matcher's arrays, x0n/x1n
    (intrinsics-normalized keypoints) and, for the cv2 checkpoints, x0px/x1px
    in the reader's dtype with K0/K1 in float64 and error_th_px. Returns
    (feed, x0, x1, the normalized threshold)."""
    feed, x0, x1 = _pair_feed_np(info, bucket)
    K0, K1 = info["K1"], info["K2"]
    feed["x0n"] = _normalize_intrinsic_np(x0[:, :2], K0)
    feed["x1n"] = _normalize_intrinsic_np(x1[:, :2], K1)
    if pixels:
        feed.update(x0px=np.ascontiguousarray(x0[:, :2]), x1px=np.ascontiguousarray(x1[:, :2]),
                    K0=np.asarray(K0, np.float64), K1=np.asarray(K1, np.float64), error_th_px=float(error_th))
    return feed, x0, x1, _norm_threshold(error_th, K0, K1)


def evaluate_iterative(model, reader, error_th: float, eval_config: dict, args, group=None) -> dict:
    """The iterative eval loop (impx/eval/eval_imp.py:224-291, :389-420):
    batches of args.eval_batch pairs through BatchedIterativeMatcher.run_batch
    (the last batch padded by repeating its last pair) when eval_batch > 1
    and the checkpoints run on the device; otherwise pair by pair through
    IterativeMatcher.run. Each pair is scored on the loop's pose when it has
    one; a pair without one estimates it from its matches with
    args.pose_backend. mean_stop_iteration is the mean iteration the loop
    stopped at. group (--data_parallel): each rank runs its block of every
    batch through the loop, and rank 0 scores the gathered outputs."""
    ckpt = CHECKPOINT_BACKENDS[getattr(args, "checkpoint_backend", None) or "jax"]
    backend = pose_backend(getattr(args, "pose_backend", "cv2"))
    seed = eval_config.get("seed", 0)
    thresholds = [5, 10, 20, 50]
    pose_errors, precisions, matching_scores, stop_its = [], [], [], []
    n_pairs = len(reader) if args.max_pairs < 0 else min(args.max_pairs, len(reader))
    bucket = args.bucket if args.bucket > 0 else round_up(reader.num_kpt, 128)
    eb = max(1, getattr(args, "eval_batch", 4)) if ckpt == "device" else 1
    main_rank = group is None or torch.distributed.get_rank(group) == 0
    if group is not None and eb == 1:
        raise SystemExit("--data_parallel splits batches of pairs: it needs --eval_batch > 1 and the "
                         "device checkpoint backend")
    matcher = None
    t_start = time.time()
    t_device = 0.0
    index = 0
    while index < n_pairs:
        infos, xs, feeds, nts = [], [], [], []
        for _ in range(min(eb, n_pairs - index)):
            info = reader.run(index)
            feed, x0, x1, nt = _iterative_feed(info, bucket, error_th, ckpt == "cv2")
            infos.append(info)
            xs.append((x0, x1))
            feeds.append(feed)
            nts.append(nt)
            index += 1
        first = index - len(infos)
        if matcher is None:
            matcher = BatchedIterativeMatcher(
                model, norm_thresh=float(np.mean(nts)), match_ratio=0.1, min_kpts=25,
                num_hypotheses=getattr(args, "ransac_hypotheses", 4096),
                with_uncertainty=getattr(args, "use_uncertainty", False), checkpoint_backend=ckpt, group=group)
        t0 = time.time()
        if eb > 1:
            gens = [pair_generator(model.device, seed, first + i) for i in range(len(infos))]
            while len(feeds) < eb:  # pad the last batch
                feeds.append(feeds[-1])
                nts.append(nts[-1])
                gens.append(pair_generator(model.device, seed, first + len(gens)))
            batch = {k: np.stack([f[k] for f in feeds]) for k in feeds[0]}
            if group is None:
                out = matcher.run_batch(batch, gens, nts)
            else:
                n_ranks, r = torch.distributed.get_world_size(group), torch.distributed.get_rank(group)
                per = eb // n_ranks
                out = _gather_pairs(matcher.run_batch(_shard(batch, group), gens[r * per:(r + 1) * per],
                                                      nts[r * per:(r + 1) * per]), group)
            outs = [{k: v[i] for k, v in out.items()} for i in range(len(infos))]
        else:
            feed = {k: (v[None] if k in MATCHER_FEED else v) for k, v in feeds[0].items()}
            outs = [matcher.run(feed, pair_generator(model.device, seed, first), norm_thresh=nts[0])]
        outs = [{k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v) for k, v in o.items()} for o in outs]
        t_device += time.time() - t0
        if not main_rank:
            continue
        for i, (info, (x0, x1), o) in enumerate(zip(infos, xs, outs)):
            # a pair without the loop's pose estimates one from its matches
            generator = pair_generator(model.device, seed, first + i) if backend == "device" else None
            _score_pair(info, x0, x1, np.asarray(o["indices0"]), bucket, pose_errors, precisions,
                        matching_scores, error_th, backend=backend, device=model.device, generator=generator,
                        pred_R=np.asarray(o["R"]), pred_t=np.asarray(o["t"]), has_pose=bool(o["has_pose"]))
            stop_its.append(int(o["stopped_at"]))
        if index % 100 < eb or index >= n_pairs:
            _print_progress(index, n_pairs, thresholds, pose_errors, precisions, matching_scores, t_device)
            print(f"  mean stop iteration {np.mean(stop_its):.2f}")
    if not main_rank:
        return _share_results(None, group)
    return _share_results(_results(thresholds, pose_errors, precisions, matching_scores, stop_its, t_device,
                                   t_start), group)


def main(argv=None):
    args = parser.parse_args(argv)
    if args.data_parallel and "WORLD_SIZE" in os.environ:  # launched by torchrun
        from impx_torch.parallel.mesh import init_distributed

        init_distributed(device=resolve_device(args.device))
    feat = args.feature_type
    error_th = 3 if args.dataset == "scannet" else 1

    config_path = args.config_path
    if not config_path:
        config_path = f"configs/{args.dataset}_eval_gm{'' if feat == 'spp' else '_sift'}.yaml"
        if not osp.isfile(config_path):
            raise SystemExit(f"no config found at {config_path}; pass --config_path")
    import yaml

    with open(config_path) as f:
        config = yaml.safe_load(f)
    read_config = config["reader"]
    eval_config = config["evaluator"]

    model = build_model(args.matching_method, feat, use_sinkhorn=not args.use_dual_softmax,
                        n_layers=args.layers, compute_dtype=args.compute_dtype,
                        compaction=parse_compaction(args.compaction),
                        device=resolve_device(args.device))
    weight_file = args.weight_path or osp.join(
        args.weight_root, WEIGHT_TABLE[args.matching_method][feat][args.dataset])
    load_params(model, weight_file)

    from impx_torch.data.reader import StandardReader

    reader = StandardReader(read_config)
    try:
        results = evaluate(model, reader, error_th, eval_config, args)
    finally:
        reader.close()
    if args.data_parallel and torch.distributed.is_initialized() and torch.distributed.get_rank() != 0:
        return results  # rank 0 prints them
    print(f"Results of {args.matching_method} on {args.dataset} "
          f"(iterative={args.use_iterative}, uncertainty={args.use_uncertainty}, "
          f"checkpoints={CHECKPOINT_BACKENDS[args.checkpoint_backend]}, "
          f"pose={pose_backend(args.pose_backend)}, device={model.device}):")
    for k, v in results.items():
        print(f"  {k}: {v}")
    return results


if __name__ == "__main__":
    main()
