"""One-command reproduction of the reference's published eval table.

Chains download -> dump -> eval at the EXACT published protocol (reference
README.md:92-154): given a mounted raw dataset and converted weights, this
reproduces the YFCC/ScanNet AUC table rows end to end.

    # YFCC, SuperPoint 2000 kpts @ 1600 px, IMP row:
    python -m impx_torch.eval.reproduce --dataset yfcc --feature spp \
        --data_root /data/yfcc --dump_root /data/dump \
        --matching_method IMP [--download]

    # ScanNet, 1000 kpts @ 480x640 (preprocessed archive mounted):
    python -m impx_torch.eval.reproduce --dataset scannet --feature spp \
        --data_root /data/scannet --dump_root /data/dump

SuperPoint (the dump) and the matcher (the eval) run on the CUDA device
unless --device names another (--device cpu runs the plain versions).

Protocol constants are hard-wired (PROTOCOL below) and asserted against the
generated configs, so a drifted config can never silently change the
measurement: YFCC = 2000 keypoints at 1600-px long side (reference
dump/configs/yfcc_sp.yaml), ScanNet = 1000 keypoints at 480x640
(dump/configs/scannet_sp.yaml), eval rescale 1600/640 with epipolar inlier
threshold 0.005, MAGSAC pixel threshold 1 px (pose) / 3 px (ScanNet, applied
as the error_th in eval_imp), matcher = 15 iterations, Sinkhorn 20.

The port of impx/eval/reproduce.py: the same protocol and chain, through the
port's dumpers and eval CLI. The chain runs end to end on synthetic scenes
in tests/test_torch_dump.py; no published weights or datasets are in the
repository.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp

YFCC_SEQS = ["buckingham_palace", "notre_dame_front_facade", "reichstag",
             "sacre_coeur"]

# The published protocol (reference README.md:92-154 + dump/configs/*.yaml +
# eval configs). `extractor_name`: 'sp' = SuperPoint, 'root' = RootSIFT.
PROTOCOL = {
    ("yfcc", "spp"): dict(
        data_name="yfcc", extractor_name="sp", num_kpt=2000, det_th=0.005,
        resize=[1600], rescale=1600, inlier_th=0.005, error_th_px=1,
        dataset_file="yfcc_sp_2000.hdf5"),
    ("yfcc", "sift"): dict(
        data_name="yfcc", extractor_name="root", num_kpt=2000, det_th=1e-5,
        resize=[1600], rescale=1600, inlier_th=0.005, error_th_px=1,
        dataset_file="yfcc_root_2000.hdf5"),
    ("scannet", "spp"): dict(
        data_name="scannet", extractor_name="sp", num_kpt=1000, det_th=0.005,
        resize=[480, 640], rescale=640, inlier_th=0.005, error_th_px=3,
        dataset_file="scannet_sp_1000.hdf5", image_size=[480, 640],
        pair_list="assets/scannet_eval_list.txt"),
    ("scannet", "sift"): dict(
        data_name="scannet", extractor_name="root", num_kpt=1000, det_th=1e-5,
        resize=[480, 640], rescale=640, inlier_th=0.005, error_th_px=3,
        dataset_file="scannet_root_1000.hdf5", image_size=[480, 640],
        pair_list="assets/scannet_eval_list.txt"),
}

# reference download_data.sh invocation from README.md:103
YFCC_ARCHIVE = ("raw_data", "raw_data_yfcc.tar.gz", 0, 8)


def build_dump_config(dataset: str, feature: str, data_root: str,
                      dump_root: str, weights_root: str = "weights",
                      seqs=None, device: str | None = None) -> dict:
    """The dump config of the protocol; `device` (SuperPoint's) is added to
    the extractor's entry when given."""
    p = PROTOCOL[(dataset, feature)]
    cfg = {
        "data_name": p["data_name"],
        "rawdata_dir": data_root,
        "feature_dump_dir": osp.join(dump_root, f"{dataset}_features"),
        "dataset_dump_dir": dump_root,
        "extractor": {
            "name": p["extractor_name"],
            "num_kpt": p["num_kpt"],
            "det_th": p["det_th"],
            "resize": list(p["resize"]),
            "num_process": 4,
            "overwrite": False,
        },
    }
    if dataset == "yfcc":
        cfg["data_seq"] = list(seqs or YFCC_SEQS)
        cfg["data_split"] = ["test"]
    else:
        cfg["image_size"] = list(p["image_size"])
        cfg["pair_list"] = p["pair_list"]
    if p["extractor_name"] == "sp":
        cfg["extractor"]["weight_path"] = osp.join(
            weights_root, "superpoint_v1.pth")
    if device is not None:
        cfg["extractor"]["device"] = device
    return cfg


def build_eval_config(dataset: str, feature: str, data_root: str,
                      dump_root: str) -> dict:
    p = PROTOCOL[(dataset, feature)]
    return {
        "reader": {
            "rawdata_dir": data_root,
            "dataset_dir": osp.join(dump_root, p["dataset_file"]),
            "num_kpt": p["num_kpt"],
        },
        "evaluator": {
            "rescale": p["rescale"],
            "inlier_th": p["inlier_th"],
        },
    }


def run_download(dataset: str, data_root: str, dry_run: bool = False):
    """YFCC raw archive via the reference's chunk protocol; ScanNet is a
    single preprocessed archive behind an interactive Drive link, so only
    instructions can be printed for it."""
    if dataset != "yfcc":
        print("ScanNet eval data is a preprocessed archive "
              "(reference README.md:127) — download it manually and extract "
              f"under {data_root}.")
        return
    from impx_torch.data.dump.download_data import main as dl_main

    name, out, lo, hi = YFCC_ARCHIVE
    os.makedirs(data_root, exist_ok=True)
    argv = [name, osp.join(data_root, out),
            "--chunk-start", str(lo), "--chunk-end", str(hi)]
    if dry_run:
        argv.append("--dry-run")
    dl_main(argv)
    if not dry_run:
        import tarfile

        with tarfile.open(osp.join(data_root, out)) as tf:
            tf.extractall(data_root)


def run_dump(dump_config: dict):
    from impx_torch.data.dump import get_dumper

    dumper = get_dumper(dump_config["data_name"], dump_config)
    dumper.initialize()
    dumper.dump_feature()
    dumper.format_dump_data()


def run_eval(dataset: str, feature: str, eval_config: dict,
             matching_method: str, extra_args=()):
    import tempfile

    import yaml

    from impx_torch.eval.eval_imp import main as eval_main

    p = PROTOCOL[(dataset, feature)]
    with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
        yaml.safe_dump(eval_config, f)
        cfg_path = f.name
    argv = ["--matching_method", matching_method, "--dataset", dataset,
            "--feature_type", feature, "--config_path", cfg_path,
            *extra_args]
    # eval_imp derives error_th from the dataset name; pin the protocol here
    assert p["error_th_px"] == (3 if dataset == "scannet" else 1)
    return eval_main(argv)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", choices=["yfcc", "scannet"], required=True)
    ap.add_argument("--feature", choices=["spp", "sift"], default="spp")
    ap.add_argument("--data_root", required=True,
                    help="raw dataset root (yfcc100m/ + pairs/ for YFCC)")
    ap.add_argument("--dump_root", required=True,
                    help="where feature dumps + the standard HDF5 go")
    ap.add_argument("--matching_method", default="IMP",
                    help="IMP | IMP_geo | EIMP | EIMP_geo (weight-table rows)")
    ap.add_argument("--weights_root", default="weights")
    ap.add_argument("--download", action="store_true",
                    help="fetch the YFCC raw archive first (chunk protocol)")
    ap.add_argument("--skip_dump", action="store_true",
                    help="reuse an existing standard HDF5")
    ap.add_argument("--device", default=None,
                    help="SuperPoint's and the matcher's device (default: the CUDA card)")
    ap.add_argument("--eval_args", nargs=argparse.REMAINDER, default=[],
                    help="extra flags forwarded verbatim to impx_torch.eval.eval_imp "
                         "(e.g. --use_iterative --compute_dtype bfloat16)")
    args = ap.parse_args(argv)

    if args.download:
        run_download(args.dataset, args.data_root)
    if not args.skip_dump:
        dump_cfg = build_dump_config(args.dataset, args.feature,
                                     args.data_root, args.dump_root,
                                     args.weights_root, device=args.device)
        run_dump(dump_cfg)
    eval_cfg = build_eval_config(args.dataset, args.feature, args.data_root,
                                 args.dump_root)
    device = () if args.device is None else ("--device", args.device)
    return run_eval(args.dataset, args.feature, eval_cfg,
                    args.matching_method,
                    ("--weight_root", args.weights_root, *device, *args.eval_args))


if __name__ == "__main__":
    main()
