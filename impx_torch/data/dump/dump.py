"""Eval-data dump CLI (impx/data/dump/dump.py; reference dump/dump.py):

  python -m impx_torch.data.dump.dump --config_path configs/dump/yfcc_sp.yaml [--device cpu]

A SuperPoint extractor ('sp') runs on the CUDA device unless --device (or the
config's extractor.device) names another.
"""
from __future__ import annotations

import argparse

parser = argparse.ArgumentParser()
parser.add_argument("--config_path", type=str, required=True)
parser.add_argument("--device", type=str, default=None,
                    help="SuperPoint's device (default: the CUDA card)")


def main(argv=None):
    import yaml

    from impx_torch.data.dump import get_dumper

    args = parser.parse_args(argv)
    with open(args.config_path) as f:
        config = yaml.safe_load(f)
    if args.device is not None:
        config["extractor"]["device"] = args.device
    dumper = get_dumper(config["data_name"], config)
    dumper.initialize()
    dumper.dump_feature()
    dumper.format_dump_data()


if __name__ == "__main__":
    main()
