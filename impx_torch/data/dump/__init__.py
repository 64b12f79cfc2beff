"""The eval-data dumpers (impx/data/dump): per-image features and the
standard per-pair HDF5 that impx_torch/data/reader.py:StandardReader reads."""
from impx_torch.data.dump.base import BaseDumper
from impx_torch.data.dump.yfcc import YFCCDumper
from impx_torch.data.dump.scannet import ScanNetDumper


def get_dumper(name: str, config: dict):
    return {"yfcc": YFCCDumper, "scannet": ScanNetDumper}[name](config)
