"""Eval-data dumper base: feature extraction over image lists + the standard
per-dataset HDF5.

A copy of impx/data/dump/base.py, which mirrors reference
dump/dumper/base_dumper.py: per-image feature HDF5s
(`keypoints`, `descriptors`), then `form_standard_dataset` collects per-pair
groups K1,K2,R,T,e,f,img_path1/2,desc1/2,kpt1/2 keyed by str(pair-id) — the
exact layout impx_torch.data.reader.StandardReader (and the reference's
standard_reader) consumes. Image sizes are additionally stored (img_size1/2)
so the reader does not need the raw images for the matcher path.

Extraction parallelism: thread pool (extractors release the GIL in OpenCV /
device code) instead of the reference's torch multiprocessing Pool. h5py is
imported inside the functions that write.
"""
from __future__ import annotations

import os
import os.path as osp
from abc import ABC, abstractmethod
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def np_skew_symmetric(v):
    zero = np.zeros_like(v[:, 0])
    return np.stack([
        zero, -v[:, 2], v[:, 1],
        v[:, 2], zero, -v[:, 0],
        -v[:, 1], v[:, 0], zero,
    ], axis=1)


def relative_pose_to_e_f(dR, dt, K1, K2):
    """Normalized GT essential/fundamental from a relative pose
    (reference dump/dumper/yfcc.py:72-78)."""
    e = np_skew_symmetric(dt.astype("float64").reshape(1, 3)).reshape(3, 3) @ dR.astype("float64")
    e = e / np.linalg.norm(e)
    f = np.linalg.inv(K2.T) @ e @ np.linalg.inv(K1)
    f = f / np.linalg.norm(f)
    return e, f


class BaseDumper(ABC):
    def __init__(self, config: dict):
        self.config = config
        self.img_seq: list[str] = []
        self.dump_seq: list[str] = []
        self.data: dict = {}

    @abstractmethod
    def get_seqs(self): ...

    @abstractmethod
    def format_dump_folder(self): ...

    @abstractmethod
    def format_dump_data(self): ...

    def initialize(self):
        from impx_torch.data.extractors import load_component

        self.extractor = load_component(
            "extractor", self.config["extractor"]["name"], self.config["extractor"])
        self.get_seqs()
        self.format_dump_folder()

    def extract(self, index: int):
        img_path, dump_path = self.img_seq[index], self.dump_seq[index]
        if not self.config["extractor"].get("overwrite", False) and osp.exists(dump_path):
            return
        kp, desc = self.extractor.run(img_path)
        self.write_feature(kp, desc, dump_path)

    def dump_feature(self):
        n = len(self.dump_seq)
        workers = self.config["extractor"].get("num_process", 4)
        print(f"Extracting features for {n} images ({workers} workers)...")
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(self.extract, range(n)))

    @staticmethod
    def write_feature(pts, desc, filename):
        import h5py

        with h5py.File(filename, "w") as f:
            f.create_dataset("keypoints", data=np.asarray(pts, np.float32))
            f.create_dataset("descriptors", data=np.asarray(desc, np.float32))

    def form_standard_dataset(self):
        import h5py

        cfg = self.config
        dataset_path = osp.join(
            cfg["dataset_dump_dir"],
            f"{cfg['data_name']}_{cfg['extractor']['name']}_{cfg['extractor']['num_kpt']}.hdf5")
        os.makedirs(cfg["dataset_dump_dir"], exist_ok=True)

        num_pairs = len(self.data["K1"])
        print(f"Writing {num_pairs} pairs -> {dataset_path}")
        with h5py.File(dataset_path, "w") as f:
            for name in ["K1", "K2", "R", "T", "e", "f"]:
                g = f.create_group(name)
                for idx in range(num_pairs):
                    g.create_dataset(str(idx), data=np.asarray(self.data[name][idx]))
            for name in ["img_path1", "img_path2"]:
                g = f.create_group(name)
                for idx in range(num_pairs):
                    g.create_dataset(str(idx), (1,), h5py.string_dtype(encoding="ascii"),
                                     data=self.data[name][idx].encode("ascii"))
            groups = {n: f.create_group(n) for n in
                      ["desc1", "desc2", "kpt1", "kpt2", "img_size1", "img_size2"]}
            for idx in range(num_pairs):
                for side in (1, 2):
                    with h5py.File(self.data[f"fea_path{side}"][idx], "r") as feat:
                        groups[f"desc{side}"].create_dataset(
                            str(idx), data=feat["descriptors"][()])
                        groups[f"kpt{side}"].create_dataset(
                            str(idx), data=feat["keypoints"][()])
                    size = self.data.get(f"img_size{side}")
                    if size is not None:
                        groups[f"img_size{side}"].create_dataset(
                            str(idx), data=np.asarray(size[idx], np.int64))
        return dataset_path
