"""Derive MegaDepth train/validation scene lists from a scene_info directory.

The reference ships fixed lists (153 train / 36 validation scenes); when you
don't have them, this produces a deterministic split over the scenes present
in your download: scenes are ordered by id and assigned to validation by a
stable hash (every 6th scene), giving roughly the same 80/20 shape.
A copy of impx/tools/make_scene_lists.py.

    python -m impx_torch.tools.make_scene_lists --scene_info_path <dir> [--out assets]
"""
from __future__ import annotations

import argparse
import glob
import os.path as osp

parser = argparse.ArgumentParser()
parser.add_argument("--scene_info_path", type=str, required=True)
parser.add_argument("--out", type=str, default="assets")
parser.add_argument("--val_every", type=int, default=6)


def main(argv=None):
    args = parser.parse_args(argv)
    scenes = sorted(
        osp.basename(f).split(".")[0]
        for f in glob.glob(osp.join(args.scene_info_path, "*.0.npz")))
    train = [s for i, s in enumerate(scenes) if i % args.val_every != 0]
    val = [s for i, s in enumerate(scenes) if i % args.val_every == 0]
    for name, lst in [("megadepth_train_scenes.txt", train),
                      ("megadepth_validation_scenes.txt", val),
                      ("megadepth_scenes_debug.txt", train[:3])]:
        with open(osp.join(args.out, name), "w") as f:
            f.write("\n".join(lst) + "\n")
        print(f"{name}: {len(lst)} scenes")


if __name__ == "__main__":
    main()
