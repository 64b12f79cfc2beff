"""The training CLI (impx/train/train.py): `python -m impx_torch.train.train`.

impx's parser flag for flag, with its defaults, and its merge order: the
parser's defaults, then the flat JSON of --config (keys ending in '_'
skipped), then the flags given on the command line. The model is the port's
GM or DGNNS, the dataset its SyntheticMegadepth (--synthetic, or no
--base_path) or Megadepth, and the loop its Trainer. --device picks the
device: the CUDA card by default, and without one the CLI raises unless
--device cpu is given.

  python -m impx_torch.train.train --config configs/config_train_megadepth.json --synthetic
  python -m impx_torch.train.train --synthetic --device cpu --layers 2 --max_keypoints 64 \\
      --batch_size 2 --epochs 1 --its_per_epoch 2

--train_fused is route B (kernels 4 and 5, MatcherConfig.train_fused).
--attn_impl, --train_remat and --attn_block_q choose how XLA runs and stores
impx's step on the TPU; they are accepted so that impx's configs and scripts
parse, and have no counterpart in the port. --network adagmn trains EIMP
(AdaGMN.forward_train), --train_compaction 'it:bucket,...' its compacted
scan, and --norm_fn bn batch norm in train mode, each as impx trains them.

Several cards: launched by torchrun (which sets RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT), or with --multihost, the CLI joins the process
group (impx_torch/parallel/mesh.py:init_distributed; --multihost without
that environment raises, naming the variables), each rank on
cuda:LOCAL_RANK, and the Trainer trains data-parallel over every rank, or
over a (world / k, k) grid with --model_parallel k (tensor parallelism).

  torchrun --nproc_per_node=4 -m impx_torch.train.train --config configs/config_train_megadepth.json \
      --synthetic [--model_parallel 2]

  python -m impx_torch.train.train --synthetic --device cpu --network adagmn --layers 4 \
      --max_keypoints 64 --n_min_tokens 16 --train_compaction 3:48 --batch_size 2 --epochs 1 \
      --its_per_epoch 2
"""
from __future__ import annotations

import argparse
import json
import os.path as osp

parser = argparse.ArgumentParser(description="IMP training (PyTorch/CUDA)",
                                 formatter_class=argparse.ArgumentDefaultsHelpFormatter)
parser.add_argument("--config", type=str, default=None, help="flat JSON overriding defaults")
parser.add_argument("--network", type=str, default="gm", choices=["gm", "dgnns", "adagmn"])
parser.add_argument("--feature", choices=["sift", "spp"], default="spp")
parser.add_argument("--max_keypoints", type=int, default=512)
parser.add_argument("--layers", type=int, default=9)
parser.add_argument("--sinkhorn_iterations", type=int, default=20)
parser.add_argument("--match_th", type=float, default=0.2)
parser.add_argument("--with_sinkhorn", type=int, default=1)
parser.add_argument("--ac_fn", type=str, default="relu")
parser.add_argument("--norm_fn", type=str, default="in")
parser.add_argument("--n_min_tokens", type=int, default=256)
parser.add_argument("--lr", type=float, default=1e-4)
parser.add_argument("--min_lr", type=float, default=1e-6)
parser.add_argument("--decay_rate", type=float, default=0.999992)
parser.add_argument("--decay_iter", type=int, default=200_000)
parser.add_argument("--weight_decay", type=float, default=5e-4)
parser.add_argument("--optim", type=str, default="adam", choices=["adam", "adamw"])
parser.add_argument("--epochs", type=int, default=20)
parser.add_argument("--batch_size", type=int, default=16)
parser.add_argument("--its_per_epoch", type=int, default=-1)
parser.add_argument("--log_intervals", type=int, default=50)
parser.add_argument("--save_path", type=str, default="runs")
parser.add_argument("--base_path", type=str, default=None, help="MegaDepth dump root")
parser.add_argument("--scene_list_fn", type=str, default=None)
parser.add_argument("--pairs_per_scene", type=int, default=80)
parser.add_argument("--min_inliers", type=int, default=32)
parser.add_argument("--max_inliers", type=int, default=512)
parser.add_argument("--random_inliers", type=int, default=0)
parser.add_argument("--weight_path", type=str, default="None",
                    help="a reference .pth checkpoint to start from (tools/convert.py)")
parser.add_argument("--resume_path", type=str, default="None",
                    help="a checkpoint of this trainer to resume from")
parser.add_argument("--save_root", type=str, default=".")
parser.add_argument("--synthetic", action="store_true",
                    help="train on the synthetic scene generator (no dump needed)")
parser.add_argument("--synthetic_pairs", type=int, default=512)
parser.add_argument("--compute_dtype", type=str, default="float32", choices=["float32", "bfloat16"])
parser.add_argument("--with_geo", action="store_true",
                    help="add the pose-consistency (epipolar) loss term (MatcherConfig.with_geo)")
parser.add_argument("--geo_weight", type=float, default=50.0)
parser.add_argument("--geo_clamp", type=float, default=0.05)
parser.add_argument("--attn_impl", type=str, default="xla", choices=["xla", "pallas"],
                    help="impx's attention implementation on the TPU; no counterpart here")
parser.add_argument("--log_ot", action="store_true",
                    help="log-domain optimal-transport score head (kernel 7 forward)")
parser.add_argument("--train_remat", type=str, default="full",
                    choices=["full", "dots", "attn", "attn_head", "attn_dots", "none"],
                    help="impx's XLA rematerialisation policy; no counterpart here")
parser.add_argument("--train_fused", action="store_true",
                    help="route B: the attention forward saves its row log-sum-exp (kernel 4) and "
                         "the backward runs from it (kernel 5); with --network adagmn it does nothing, "
                         "as in impx, whose EIMP trainers run route A only")
parser.add_argument("--train_supervision", type=str, default="all", choices=["all", "last"],
                    help="'all' supervises every iteration (the reference objective); 'last' the "
                         "final one (DGNNS's stacked forward only)")
parser.add_argument("--train_compaction", type=str, default="",
                    help="EIMP training bucket-compaction schedule 'it:bucket,it:bucket,...' (adagmn with "
                         "norm_fn in, no log_ot: pooled keypoints are dropped during training, the sliced "
                         "semantics; '' = the masked trainer)")
parser.add_argument("--attn_block_q", type=int, default=0,
                    help="impx's Pallas q-block; no counterpart here (the kernels pick their tiles)")
parser.add_argument("--multihost", action="store_true",
                    help="join the process group from the launcher's environment (torchrun's RANK, "
                         "WORLD_SIZE, MASTER_ADDR, MASTER_PORT); raises without it")
parser.add_argument("--model_parallel", type=int, default=1,
                    help="tensor parallelism: a (world / k, k) grid of ranks; k must divide the world "
                         "and num_heads")
parser.add_argument("--device", type=str, default=None,
                    help="the training device (default: the CUDA card; 'cpu' runs the kernels' plain "
                         "PyTorch versions)")

# impx's knobs of the TPU step: (flag, its default)
TPU_ONLY = (("attn_impl", "xla"), ("train_remat", "full"), ("attn_block_q", 0))


def join_process_group(args) -> None:
    """init_distributed() from the launcher's environment under --multihost
    (which raises without it, naming the variables) or when a launcher set
    WORLD_SIZE (impx/train/train.py:161-164 calls jax.distributed.initialize);
    the backend follows the device: NCCL on a card, gloo on the CPU."""
    import os

    if args.multihost or "WORLD_SIZE" in os.environ:
        from impx_torch.device import resolve_device
        from impx_torch.parallel.mesh import init_distributed

        init_distributed(device=resolve_device(args.device))


def parse_args(argv=None) -> argparse.Namespace:
    """impx's merge: defaults < --config JSON (keys ending in '_' skipped) <
    the flags given (impx/train/train.py:165-172)."""
    args = parser.parse_args(argv)
    if args.config:
        with open(args.config) as f:
            overrides = json.load(f)
        ns = argparse.Namespace()
        ns.__dict__.update(vars(parser.parse_args([])))
        ns.__dict__.update({k: v for k, v in overrides.items() if not k.endswith("_")})
        args = parser.parse_args(argv, namespace=ns)
    return args


def build_model(args):
    """The port's GM, DGNNS or AdaGMN at the flags' MatcherConfig, random
    weights from seed 0, on args.device."""
    from impx_torch.eval.eval_imp import parse_compaction
    from impx_torch.models import AdaGMN, DGNNS, MatcherConfig
    from impx_torch.models.gm import GM

    cfg = MatcherConfig(
        descriptor_dim=256 if args.feature == "spp" else 128,
        n_layers=args.layers,
        sinkhorn_iterations=args.sinkhorn_iterations,
        match_threshold=args.match_th,
        with_sinkhorn=args.with_sinkhorn > 0,
        ac_fn=args.ac_fn,
        norm_fn=args.norm_fn,
        n_min_tokens=args.n_min_tokens,
        compute_dtype=args.compute_dtype,
        with_geo=args.with_geo,
        geo_weight=args.geo_weight,
        geo_clamp=args.geo_clamp,
        log_ot=args.log_ot,
        train_fused=args.train_fused,
        train_supervision=args.train_supervision,
        train_compaction=parse_compaction(args.train_compaction),
    )
    return {"gm": GM, "dgnns": DGNNS, "adagmn": AdaGMN}[args.network](cfg, device=args.device)


def build_dataset(args):
    from impx_torch.data.megadepth import Megadepth, SyntheticMegadepth

    if args.synthetic or args.base_path is None:
        return SyntheticMegadepth(num_pairs=args.synthetic_pairs, nfeatures=args.max_keypoints,
                                  desc_dim=256 if args.feature == "spp" else 128)
    return Megadepth(base_path=args.base_path, scene_list_fn=args.scene_list_fn,
                     pairs_per_scene=args.pairs_per_scene, nfeatures=args.max_keypoints,
                     feature_type=args.feature, train=True, min_inliers=args.min_inliers,
                     max_inliers=args.max_inliers, random_inliers=args.random_inliers > 0)


def main(argv=None):
    """Parse, join the process group when launched on several ranks, build
    the model, load --weight_path, build the dataset and the Trainer (which
    slices the weights under --model_parallel), load --resume_path, train.
    Returns the Trainer."""
    from impx_torch.train.trainer import Trainer
    from impx_torch.tools.convert import load_matcher_checkpoint

    args = parse_args(argv)
    join_process_group(args)
    tpu_only = [f"--{k} {getattr(args, k)}" for k, default in TPU_ONLY if getattr(args, k) != default]
    if tpu_only:
        print(f"{', '.join(tpu_only)}: impx's TPU-only settings, no counterpart in the port (ignored)")

    model = build_model(args)
    if args.weight_path != "None":
        model.load_state_dict(load_matcher_checkpoint(osp.join(args.save_root, args.weight_path),
                                                      model.config, model.sharing))
        print(f"Loaded pretrained weights from {args.weight_path}")
    trainer = Trainer(model, build_dataset(args), args)
    opt_state = None
    if args.resume_path != "None":
        opt_state = trainer.restore_checkpoint(osp.join(args.save_root, args.resume_path))
        print(f"Resumed from {args.resume_path} at epoch {trainer.epoch}")
    trainer.train(opt_state)
    return trainer


if __name__ == "__main__":
    main()
