"""The port's tools against impx's on the same inputs: the copies (image,
video, common, make_scene_lists) give impx's outputs; model_size
counts impx's leaves (the port's batch-norm statistics are parameters);
map_tensor maps torch tensors; the profiler trace is a Chrome trace that
names the annotated range and the operations inside it."""
import argparse
import json
import os

import numpy as np
import pytest
import torch

import jax

from impx.models import DGNNS as JaxDGNNS
from impx.models import MatcherConfig as JaxConfig
from impx.tools import common as jcommon
from impx.tools import image as jimage
from impx.tools import make_scene_lists as jscenes
from impx.tools import video as jvideo

from impx_torch.models import DGNNS, MatcherConfig
from impx_torch.tools import common, image, make_scene_lists, profiling, video

cv2 = pytest.importorskip("cv2")


def test_image_helpers_equal_impx(tmp_path):
    K = np.array([[500.0, 0, 320.5], [0, 510.0, 240.25], [0, 0, 1]])
    np.testing.assert_array_equal(image.scale_intrinsics(K, (2.0, 1.5)), jimage.scale_intrinsics(K, (2.0, 1.5)))
    T = np.eye(4)
    T[:3, 3] = [0.1, -0.2, 0.3]
    for rot in range(4):
        np.testing.assert_array_equal(image.rotate_intrinsics(K, (480, 640), rot),
                                      jimage.rotate_intrinsics(K, (480, 640), rot))
        np.testing.assert_array_equal(image.rotate_pose_inplane(T, rot), jimage.rotate_pose_inplane(T, rot))
    rs = np.random.RandomState(0)
    path = tmp_path / "a.png"
    cv2.imwrite(str(path), (rs.rand(61, 83) * 255).astype(np.uint8))
    for kw in (dict(), dict(resize=[40]), dict(resize=[30, 50], rotation=1), dict(resize=[50], resize_float=True),
               dict(rotation=3)):
        for a, b in zip(image.read_image(path, **kw), jimage.read_image(path, **kw)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert image.read_image(tmp_path / "missing.png") == (None, None, None)


def test_video_streamer_equals_impx(tmp_path):
    rs = np.random.RandomState(1)
    for i in range(5):
        cv2.imwrite(str(tmp_path / f"f{i}.png"), (rs.rand(40, 60, 3) * 255).astype(np.uint8))
    for kw in (dict(), dict(resize=[30], skip=2)):
        a, b = video.VideoStreamer(str(tmp_path), **kw), jvideo.VideoStreamer(str(tmp_path), **kw)
        assert a.mode == b.mode == "images"
        while True:
            (fa, oka), (fb, okb) = a.next_frame(), b.next_frame()
            assert oka == okb
            if not oka:
                break
            np.testing.assert_array_equal(fa, fb)
    with pytest.raises(ValueError, match="cannot interpret"):
        video.VideoStreamer(str(tmp_path / "nothing"))


@pytest.mark.parametrize("norm_fn", ["in", "bn"])
def test_model_size_counts_impx_leaves(norm_fn):
    cfg = dict(descriptor_dim=32, keypoint_encoder=(16, 32), n_layers=3, num_heads=4, norm_fn=norm_fn)
    params = JaxDGNNS(JaxConfig(**cfg)).init(jax.random.PRNGKey(0))
    assert common.model_size(DGNNS(MatcherConfig(**cfg), device="cpu")) == jcommon.model_size(params)


def test_map_tensor_and_args(tmp_path):
    nested = {"a": torch.ones(2), "b": [torch.zeros(3), ("s", torch.full((1,), 2.0))], "c": "text"}
    out = common.map_tensor(nested, lambda t: t * 2 if isinstance(t, torch.Tensor) else t)
    assert torch.equal(out["a"], torch.full((2,), 2.0)) and out["c"] == "text"
    assert isinstance(out["b"], list) and isinstance(out["b"][1], tuple) and out["b"][1][0] == "s"
    assert torch.equal(out["b"][1][1], torch.full((1,), 4.0))
    np_nested = {"x": [np.arange(3)], "y": "s"}
    assert str(common.map_tensor(np_nested, lambda v: v + 1)) == str(jcommon.map_tensor(np_nested, lambda v: v + 1))
    args = argparse.Namespace(lr=1e-3, name="run", steps=4)
    common.save_args(args, tmp_path / "a.json")
    jcommon.save_args(args, tmp_path / "b.json")
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()
    assert vars(common.load_args(argparse.Namespace(), tmp_path / "a.json")) == \
        vars(jcommon.load_args(argparse.Namespace(), tmp_path / "b.json"))


def test_make_scene_lists_equals_impx(tmp_path):
    info = tmp_path / "scene_info"
    info.mkdir()
    for s in ("0015", "0001", "0022", "0100", "0003", "0042", "0007", "0058"):
        np.savez(info / f"{s}.0.npz", x=np.zeros(1))
    outs = []
    for mod, name in ((make_scene_lists, "port"), (jscenes, "impx")):
        out = tmp_path / name
        out.mkdir()
        mod.main(["--scene_info_path", str(info), "--out", str(out), "--val_every", "3"])
        outs.append({f: (out / f).read_text() for f in sorted(os.listdir(out))})
    assert outs[0] == outs[1] and len(outs[0]) == 3


def test_profiler_trace_names_the_annotated_range(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as path:
        with profiling.span("impx_matmul_range"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.dirname(path) == str(tmp_path / "trace")
    events = json.loads(open(path).read())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "impx_matmul_range" in names
    assert any("mm" in str(n) for n in names)
