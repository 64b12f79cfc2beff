"""YFCC100M eval dumper (impx/data/dump/yfcc.py; reference dump/dumper/yfcc.py).

4 scenes x 1000 test pairs from `pairs/{seq}-te-1000-pairs.pkl`; GT relative
pose from per-image calibration HDF5s (principal point recentered to the
image center, yfcc.py:64-66), normalized E/F.
"""
from __future__ import annotations

import glob
import os
import os.path as osp
import pickle

import numpy as np

from impx_torch.data.dump.base import BaseDumper, relative_pose_to_e_f


class YFCCDumper(BaseDumper):
    def get_seqs(self):
        data_dir = osp.join(self.config["rawdata_dir"], "yfcc100m")
        for seq in self.config["data_seq"]:
            for split in self.config["data_split"]:
                split_dir = osp.join(data_dir, seq, split)
                dump_dir = osp.join(self.config["feature_dump_dir"], seq, split)
                imgs = glob.glob(osp.join(split_dir, "images", "*.jpg"))
                self.img_seq += imgs
                self.dump_seq += [self._feat_path(dump_dir, p) for p in imgs]

    def _feat_path(self, dump_dir, img_path):
        ex = self.config["extractor"]
        return osp.join(dump_dir, osp.basename(img_path)) + \
            f"_{ex['name']}_{ex['num_kpt']}.hdf5"

    def format_dump_folder(self):
        for seq in self.config["data_seq"]:
            for split in self.config["data_split"]:
                os.makedirs(osp.join(self.config["feature_dump_dir"], seq, split),
                            exist_ok=True)

    def format_dump_data(self):
        import h5py

        pair_path = osp.join(self.config["rawdata_dir"], "pairs")
        self.data = {k: [] for k in ["K1", "K2", "R", "T", "e", "f", "fea_path1",
                                     "fea_path2", "img_path1", "img_path2",
                                     "img_size1", "img_size2"]}
        for seq in self.config["data_seq"]:
            with open(osp.join(pair_path, f"{seq}-te-1000-pairs.pkl"), "rb") as f:
                pairs = pickle.load(f)
            seq_dir = osp.join(self.config["rawdata_dir"], "yfcc100m", seq, "test")
            name_list = np.loadtxt(osp.join(seq_dir, "images.txt"), dtype=str)
            cam_list = np.loadtxt(osp.join(seq_dir, "calibration.txt"), dtype=str)

            for i1, i2 in pairs:
                cam1 = h5py.File(osp.join(seq_dir, cam_list[i1]), "r")
                cam2 = h5py.File(osp.join(seq_dir, cam_list[i2]), "r")
                K1, K2 = cam1["K"][()], cam2["K"][()]
                [w1, h1], [w2, h2] = cam1["imsize"][()][0], cam2["imsize"][()][0]
                # recenter the principal point (reference yfcc.py:64-66)
                K1[0, 2], K1[1, 2] = (w1 - 1.0) * 0.5, (h1 - 1.0) * 0.5
                K2[0, 2], K2[1, 2] = (w2 - 1.0) * 0.5, (h2 - 1.0) * 0.5
                R1, R2 = cam1["R"][()], cam2["R"][()]
                t1 = cam1["T"][()].reshape(3, 1)
                t2 = cam2["T"][()].reshape(3, 1)
                dR = R2 @ R1.T
                dt = t2 - dR @ t1
                dt = dt / np.sqrt(np.sum(dt ** 2))
                e, f_gt = relative_pose_to_e_f(dR, dt, K1, K2)

                self.data["K1"].append(K1)
                self.data["K2"].append(K2)
                self.data["R"].append(dR)
                self.data["T"].append(dt)
                self.data["e"].append(e)
                self.data["f"].append(f_gt)
                self.data["img_size1"].append((int(h1), int(w1)))
                self.data["img_size2"].append((int(h2), int(w2)))
                dump_dir = osp.join(self.config["feature_dump_dir"], seq, "test")
                self.data["img_path1"].append(osp.join("yfcc100m", seq, "test", name_list[i1]))
                self.data["img_path2"].append(osp.join("yfcc100m", seq, "test", name_list[i2]))
                self.data["fea_path1"].append(self._feat_path(dump_dir, name_list[i1]))
                self.data["fea_path2"].append(self._feat_path(dump_dir, name_list[i2]))
        return self.form_standard_dataset()
