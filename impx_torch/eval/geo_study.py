"""Geo-supervision study: does the pose-consistency loss help?
(impx/eval/geo_study.py)

Trains two identical small DGNNS matchers on the same synthetic stream
(impx_torch/data/synthetic.py:training_sample) with
impx_torch/train/step.py:make_train_step: one with only the matching NLL
(reference nets/loss.py GraphLoss), one with the added geometry (epipolar)
term (with_geo; the training recipe behind the reference's `_geo` weight
variants, eval/eval_imp.py:275/316). Then it evaluates both through the
eval loop (impx_torch/eval/eval_imp.py:evaluate, device pose backend) on
held-out synthetic scenes, the pairs write_eval_hdf5 writes for the same
seed, held in memory (`EvalPairs`: the card's machine has no h5py), and
prints pose AUC / precision side by side. On the card that runs kernels 1
and 3 in training and 1 and 2 in the eval.

Descriptor noise is set high so appearance alone is ambiguous: geometry
supervision has something to disambiguate (the regime the IMP paper targets).

Usage: python -m impx_torch.eval.geo_study [--steps 400] [--fast] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

parser = argparse.ArgumentParser()
parser.add_argument("--steps", type=int, default=400)
parser.add_argument("--batch", type=int, default=8)
parser.add_argument("--nfeat", type=int, default=192)
parser.add_argument("--desc_dim", type=int, default=64)
parser.add_argument("--desc_noise", type=float, default=0.55)
parser.add_argument("--eval_pairs", type=int, default=32)
parser.add_argument("--geo_weight", type=float, default=50.0)
parser.add_argument("--fast", action="store_true", help="tiny CI-sized run")
parser.add_argument("--seed", type=int, default=0)
parser.add_argument("--cpu", action="store_true", help="run on the CPU (as --device cpu)")
parser.add_argument("--device", default=None, help="the matcher's device (the card unless named)")


class EvalPairs:
    """StandardReader's interface (num_kpt, __len__, run(index)) over the
    pairs that impx_torch/data/synthetic.py:write_eval_hdf5(path, num_pairs,
    seed, **pair_kwargs) writes, made in memory: run(i) gives what
    StandardReader gives for pair i of that file."""

    def __init__(self, num_pairs: int, num_kpt: int, seed: int = 0, **pair_kwargs):
        from impx_torch.data.synthetic import synthesize_pair

        rs = np.random.RandomState(seed)
        self.pairs = [synthesize_pair(rs, **pair_kwargs) for _ in range(num_pairs)]
        self.num_kpt = num_kpt

    def __len__(self):
        return len(self.pairs)

    def run(self, index: int) -> dict:
        p, k = self.pairs[index], self.num_kpt
        t = np.asarray(p["T"])
        t = t / np.sqrt((t ** 2).sum())
        return {"index": index, "K1": np.asarray(p["K1"]), "K2": np.asarray(p["K2"]), "R": np.asarray(p["R"]),
                "t": t, "x1": p["kpt1"][:k], "x2": p["kpt2"][:k], "desc1": p["desc1"][:k],
                "desc2": p["desc2"][:k], "e": p["e"], "f": p["f"], "r_gt": np.asarray(p["R"]), "t_gt": t,
                "img_size1": tuple(np.asarray(p["img_size1"]).tolist()),
                "img_size2": tuple(np.asarray(p["img_size2"]).tolist())}


def _train_batch(rs, args):
    from impx_torch.data.synthetic import training_sample

    samples = [training_sample(rs, nfeatures=args.nfeat, desc_dim=args.desc_dim, desc_noise=args.desc_noise)
               for _ in range(args.batch)]
    return {k: torch.from_numpy(np.stack([s[k] for s in samples]).astype(np.float32))
            for k in samples[0] if isinstance(samples[0][k], np.ndarray)}


def _train(model, args, seed):
    """args.steps steps of make_train_step at lr 1e-3 on fresh batches (the
    NaN guard's stats restarted each step, as impx's study passes them)."""
    from impx_torch.train.step import TrainHyperParams, init_opt_state, init_stats, make_train_step

    step = make_train_step(model, TrainHyperParams(lr=1e-3, decay_iter=10**6))
    opt = init_opt_state(model)
    rs = np.random.RandomState(seed + 1)
    last = {}
    for it in range(args.steps):
        batch = _train_batch(rs, args)
        metrics, _ = step(opt, it, batch, init_stats(model.device))
        if (it + 1) % max(args.steps // 4, 1) == 0:
            last = {k: float(metrics[k]) for k in ("loss", "matching_loss", "geo_loss", "acc_corr")}
            print(f"  step {it + 1}: {last}", flush=True)
    return last


class EvalArgs:
    use_iterative = False
    use_uncertainty = False
    pose_backend = "device"
    checkpoint_backend = "jax"
    ransac_hypotheses = 1024
    eval_batch = 8
    data_parallel = False

    def __init__(self, max_pairs: int, bucket: int):
        self.max_pairs, self.bucket = max_pairs, bucket


def _evaluate(model, args, reader):
    from impx_torch.eval.eval_imp import evaluate

    return evaluate(model, reader, 1.0, {"rescale": 640, "inlier_th": 0.005, "seed": args.seed},
                    EvalArgs(args.eval_pairs, ((args.nfeat + 127) // 128) * 128))


def main(argv=None):
    args = parser.parse_args(argv)
    from impx_torch.device import resolve_device
    from impx_torch.models import DGNNS, MatcherConfig

    device = resolve_device("cpu" if args.cpu else args.device)
    if args.fast:
        args.steps, args.eval_pairs, args.nfeat = 60, 8, 96

    base = MatcherConfig(descriptor_dim=args.desc_dim, keypoint_encoder=(16, 32),
                         n_layers=3, sinkhorn_iterations=10, norm_fn="in")
    reader = EvalPairs(args.eval_pairs, args.nfeat, seed=args.seed + 99, n_inliers=args.nfeat // 2,
                       n_outliers0=args.nfeat, n_outliers1=args.nfeat, desc_dim=args.desc_dim,
                       desc_noise=args.desc_noise)
    rows = []
    for name, cfg in (
        ("matching-only", base),
        ("with_geo", dataclasses.replace(base, with_geo=True, geo_weight=args.geo_weight)),
    ):
        print(f"training {name} ({args.steps} steps)...", flush=True)
        model = DGNNS(cfg, device=device, seed=args.seed)
        _train(model, args, seed=args.seed)
        res = _evaluate(model, args, reader)
        rows.append((name, res))
        print(f"  {name}: auc {res['auc']} prec {res['precision']:.2f} "
              f"mscore {res['matching_score']:.2f}", flush=True)

    print("\n| model | AUC@5 | AUC@10 | AUC@20 | precision |")
    print("|---|---|---|---|---|")
    for name, res in rows:
        a = res["auc"]
        print(f"| {name} | {a[5]:.1f} | {a[10]:.1f} | {a[20]:.1f} | "
              f"{res['precision']:.1f} |")
    return rows


if __name__ == "__main__":
    main()
