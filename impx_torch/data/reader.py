"""Eval dataset readers (a copy of impx/data/reader.py, numpy only; the port
imports nothing of impx).

`StandardReader` mirrors reference components/readers.py:8-39
(`standard_reader`): one HDF5 per dataset with per-pair groups
K1,K2,R,T,e,f,img_path1/2,desc1/2,kpt1/2 indexed by str(pair-id); translation
L2-normalized on read; keypoints truncated to num_kpt. Images are loaded
lazily from `rawdata_dir` only when requested (the matcher path does not need
pixels — it works from dumped keypoints/descriptors).

`pad_features` turns the ragged per-pair features into fixed-size padded
arrays + validity masks for the matcher's fixed padding bucket.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np


class StandardReader:
    def __init__(self, config: dict):
        import h5py

        self.raw_dir = config.get("rawdata_dir")
        self.dataset = h5py.File(config["dataset_dir"], "r")
        self.num_kpt = config["num_kpt"]
        self.load_images = config.get("load_images", False)

    def __len__(self):
        return len(self.dataset["K1"])

    def run(self, index: int) -> dict[str, Any]:
        ds = self.dataset
        s = str(index)
        K1 = np.asarray(ds["K1"][s])
        K2 = np.asarray(ds["K2"][s])
        R = np.asarray(ds["R"][s])
        t = np.asarray(ds["T"][s])
        t = t / np.sqrt((t ** 2).sum())
        desc1 = ds["desc1"][s][()][: self.num_kpt]
        desc2 = ds["desc2"][s][()][: self.num_kpt]
        x1 = ds["kpt1"][s][()][: self.num_kpt]
        x2 = ds["kpt2"][s][()][: self.num_kpt]
        e = ds["e"][s][()]
        f = ds["f"][s][()]
        info = {
            "index": index, "K1": K1, "K2": K2, "R": R, "t": t,
            "x1": x1, "x2": x2, "desc1": desc1, "desc2": desc2,
            "e": e, "f": f, "r_gt": R, "t_gt": t,
        }
        if "img_size1" in ds:
            info["img_size1"] = tuple(np.asarray(ds["img_size1"][s]).tolist())
            info["img_size2"] = tuple(np.asarray(ds["img_size2"][s]).tolist())
        if self.load_images and self.raw_dir is not None and "img_path1" in ds:
            import cv2

            p1 = ds["img_path1"][s][()][0].decode()
            p2 = ds["img_path2"][s][()][0].decode()
            info["img1"] = cv2.imread(os.path.join(self.raw_dir, p1))
            info["img2"] = cv2.imread(os.path.join(self.raw_dir, p2))
            info["img_size1"] = info["img1"].shape[:2]
            info["img_size2"] = info["img2"].shape[:2]
        return info

    def close(self):
        self.dataset.close()


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def pad_features(x, desc, bucket: int):
    """Ragged kpts [N,3] (x, y, score) + descs [N,D] -> fixed [bucket, ...] + mask."""
    n = x.shape[0]
    assert n <= bucket, (n, bucket)
    xp = np.zeros((bucket, x.shape[1]), np.float32)
    dp = np.zeros((bucket, desc.shape[1]), np.float32)
    xp[:n] = x
    dp[:n] = desc
    valid = np.zeros((bucket,), bool)
    valid[:n] = True
    return xp, dp, valid
