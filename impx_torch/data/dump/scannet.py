"""ScanNet eval dumper (impx/data/dump/scannet.py; reference dump/dumper/scannet.py).

1500 pairs from assets/scannet_eval_list.txt; GT relative pose from
per-frame extrinsic/intrinsic txt files; normalized E/F.
"""
from __future__ import annotations

import glob
import os
import os.path as osp

import numpy as np

from impx_torch.data.dump.base import BaseDumper, relative_pose_to_e_f


class ScanNetDumper(BaseDumper):
    def get_seqs(self):
        self.pair_list = np.loadtxt(
            self.config.get("pair_list", "assets/scannet_eval_list.txt"), dtype=str)
        self.seq_list = np.unique(
            np.asarray([p.split("/")[0] for p in self.pair_list[:, 0]], dtype=str))
        for seq in self.seq_list:
            dump_dir = osp.join(self.config["feature_dump_dir"], seq)
            imgs = glob.glob(osp.join(self.config["rawdata_dir"], seq, "img", "*.jpg"))
            self.img_seq += imgs
            self.dump_seq += [self._feat_path(dump_dir, p) for p in imgs]

    def _feat_path(self, dump_dir, img_path):
        ex = self.config["extractor"]
        return osp.join(dump_dir, osp.basename(img_path)) + \
            f"_{ex['name']}_{ex['num_kpt']}.hdf5"

    def format_dump_folder(self):
        for seq in self.seq_list:
            os.makedirs(osp.join(self.config["feature_dump_dir"], seq), exist_ok=True)

    def format_dump_data(self):
        self.data = {k: [] for k in ["K1", "K2", "R", "T", "e", "f", "fea_path1",
                                     "fea_path2", "img_path1", "img_path2",
                                     "img_size1", "img_size2"]}
        raw = self.config["rawdata_dir"]
        size = self.config.get("image_size", (480, 640))
        for img_path1, img_path2 in self.pair_list:
            seq = img_path1.split("/")[0]
            i1 = int(osp.basename(img_path1)[:-4])
            i2 = int(osp.basename(img_path2)[:-4])
            ex1 = np.loadtxt(osp.join(raw, seq, "extrinsic", f"{i1}.txt"))
            ex2 = np.loadtxt(osp.join(raw, seq, "extrinsic", f"{i2}.txt"))
            K1 = np.loadtxt(osp.join(raw, seq, "intrinsic", f"{i1}.txt"))
            K2 = np.loadtxt(osp.join(raw, seq, "intrinsic", f"{i2}.txt"))

            rel = np.linalg.inv(ex2) @ ex1
            dR, dt = rel[:3, :3], rel[:3, 3]
            dt = dt / np.sqrt(np.sum(dt ** 2))
            e, f_gt = relative_pose_to_e_f(dR, dt, K1, K2)

            self.data["K1"].append(K1)
            self.data["K2"].append(K2)
            self.data["R"].append(dR)
            self.data["T"].append(dt)
            self.data["e"].append(e)
            self.data["f"].append(f_gt)
            self.data["img_size1"].append(size)
            self.data["img_size2"].append(size)
            dump_dir = osp.join(self.config["feature_dump_dir"], seq)
            self.data["img_path1"].append(img_path1)
            self.data["img_path2"].append(img_path2)
            self.data["fea_path1"].append(self._feat_path(dump_dir, img_path1))
            self.data["fea_path2"].append(self._feat_path(dump_dir, img_path2))
        return self.form_standard_dataset()
