"""The port's feature extractors, their registry, the sift_native and viz
copies and the two-image demo against impx's, on the CPU.

Same inputs on both sides: images made with numpy from a seed, the same
SuperPoint and matcher weights written to .pth files in the reference
layout. ExtractSIFT, resize_image, sift_native and viz are copies and give
equal outputs; ExtractSuperpoint agrees with impx's by the margin rule
(impx_torch.models.superpoint.compare_extractions, margin 1e-5: the backbone's
fp32 parity bound); the two demos give equal match counts and PNG bytes.
"""
import cv2
import numpy as np
import pytest

import jax
import torch

from impx.data import extractors as jext
from impx.data import sift_native as jsift
from impx.eval import eval_imp as jax_eval_imp
from impx.models import superpoint as jsp
from impx.tools import viz as jviz
from impx.tools.convert_torch import matcher_state_dict

from impx_torch import demo
from impx_torch.data import extractors as ext
from impx_torch.data import sift_native
from impx_torch.eval import eval_imp
from impx_torch.models.superpoint import compare_extractions
from impx_torch.tools import viz

MARGIN = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def textured(rs, h, w, blur=1.5):
    """A blurred noise image: plenty of SIFT and SuperPoint responses."""
    return cv2.GaussianBlur((rs.rand(h, w) * 255).astype(np.uint8), (0, 0), blur)


@pytest.fixture(scope="module")
def sp_weights(tmp_path_factory):
    """impx's random SuperPoint weights as a superpoint_v1.pth (OIHW)."""
    params = jsp.init_params(jax.random.PRNGKey(1))
    state = {f"{n}.{leaf}": torch.from_numpy(np.array(
        np.transpose(np.asarray(p["w"]), (3, 2, 0, 1)) if leaf == "weight" else p["b"]))
        for n, p in params.items() for leaf in ("weight", "bias")}
    path = tmp_path_factory.mktemp("sp") / "superpoint_v1.pth"
    torch.save(state, path)
    return str(path)


def test_resize_image_equals_impx():
    img = textured(np.random.RandomState(0), 90, 131)
    for resize in ([64], [50, 77]):
        a, sa = ext.resize_image(img, resize)
        b, sb = jext.resize_image(img, resize)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(sa, sb)


@pytest.mark.parametrize("root,resize", [(True, [-1]), (False, [-1]), (True, [100])])
def test_extract_sift_equals_impx(root, resize):
    img = textured(np.random.RandomState(1), 120, 160)
    config = {"num_kpt": 200, "det_th": 1e-5, "resize": resize}
    (ka, da), (kb, db) = ext.ExtractSIFT(config, root).run(img), jext.ExtractSIFT(config, root).run(img)
    assert len(ka) > 50
    np.testing.assert_array_equal(ka, kb)
    np.testing.assert_array_equal(da, db)


def _as_extraction(kpt, desc):
    """A ragged (kpt [N, 3], desc [N, D]) as compare_extractions' batch of one."""
    t = lambda a: torch.from_numpy(np.asarray(a))[None]  # noqa: E731
    return {"keypoints": t(kpt[:, :2]), "scores": t(kpt[:, 2]), "descriptors": t(desc),
            "valid": torch.ones((1, len(kpt)), dtype=torch.bool)}


def test_extract_superpoint_matches_impx_at_a_resize(sp_weights):
    """A resize to 75 x 101 (no multiple of 8: the pad to 80 x 104 runs) and
    the keypoints scaled back by the resize's scale."""
    img = textured(np.random.RandomState(2), 100, 130)
    config = {"num_kpt": 150, "det_th": 0.005, "resize": [75, 101], "weight_path": sp_weights}
    ka, da = ext.ExtractSuperpoint(config, device="cpu").run(img)
    kb, db = jext.ExtractSuperpoint(config).run(img)
    assert ka.dtype == da.dtype == np.float32 and ka.shape[1] == 3 and da.shape[1] == 256
    assert len(ka) > 20 and ka[:, 0].max() > 101 * 0.9      # scaled back to the 130-px width
    cmp = compare_extractions(_as_extraction(ka, da), _as_extraction(kb, db), MARGIN)
    assert cmp["overlap"] >= 0.85 and not cmp["unexplained"], cmp
    assert cmp["min_cosine"] > 1 - 1e-5


def test_extract_superpoint_padding_rows(sp_weights):
    """padding=True fills up to num_kpt: impx's count, positions in [0, (H+W)/2)
    of the padded image, score 0, unit-norm descriptors; the explicit
    generator makes the rows reproducible."""
    img = textured(np.random.RandomState(3), 60, 75)
    config = {"num_kpt": 300, "det_th": 0.005, "padding": True, "weight_path": sp_weights}
    ka, da = ext.ExtractSuperpoint(config, device="cpu", rng=np.random.default_rng(5)).run(img)
    kb, db = jext.ExtractSuperpoint(config).run(img)
    n_real = len(ext.ExtractSuperpoint({**config, "padding": False}, device="cpu").run(img)[0])
    assert ka.shape == kb.shape == (300, 3) and da.shape == db.shape == (300, 256)
    assert 0 < n_real < 300
    pad_x, pad_d = ka[n_real:, :2], da[n_real:]
    assert pad_x.min() >= 0 and pad_x.max() < (64 + 80) / 2
    assert not ka[n_real:, 2].any()
    np.testing.assert_allclose(np.linalg.norm(pad_d, axis=1), 1.0, rtol=1e-6)
    again, _ = ext.ExtractSuperpoint(config, device="cpu", rng=np.random.default_rng(5)).run(img)
    np.testing.assert_array_equal(ka, again)


def test_load_component_routes_to_the_port(tmp_path):
    from impx_torch.data.reader import StandardReader
    from impx_torch.data.synthetic import write_eval_hdf5
    from impx_torch.eval.evaluator import AucEval, FMBenchEval
    from impx_torch.models import AdaGMN, DGNNS

    assert ext.load_component("extractor", "root", {"num_kpt": 8}).root
    assert not ext.load_component("extractor", "sift", {"num_kpt": 8}).root
    sp_ = ext.load_component("extractor", "sp", {"num_kpt": 8, "device": "cpu"})
    assert isinstance(sp_, ext.ExtractSuperpoint) and sp_.device == torch.device("cpu")
    write_eval_hdf5(str(tmp_path / "s.hdf5"), num_pairs=1, seed=0, n_inliers=8, n_outliers0=2, n_outliers1=2)
    reader = ext.load_component("reader", "standard", {"dataset_dir": str(tmp_path / "s.hdf5"), "num_kpt": 16})
    assert isinstance(reader, StandardReader) and len(reader) == 1
    reader.close()
    assert isinstance(ext.load_component("evaluator", "auc", {"rescale": 640}), AucEval)
    assert isinstance(ext.load_component("evaluator", "fm", {}), FMBenchEval)
    imp = ext.load_component("matcher", "IMP", {"feature": "sift", "device": "cpu"})
    assert isinstance(imp, DGNNS) and imp.config.descriptor_dim == 128
    assert isinstance(ext.load_component("matcher", "EIMP", {"device": "cpu"}), AdaGMN)
    for kind, name in (("extractor", "orb"), ("writer", "x")):
        with pytest.raises(ValueError, match="unknown component"):
            ext.load_component(kind, name, {})
        with pytest.raises(ValueError, match="unknown component"):
            jext.load_component(kind, name, {})


def test_sift_native_copy_equals_impx():
    img = textured(np.random.RandomState(4), 120, 160, blur=2.0)
    (ka, da), (kb, db) = sift_native.extract(img, 300), jsift.extract(img, 300)
    assert len(ka) > 20
    np.testing.assert_array_equal(ka, kb)
    np.testing.assert_array_equal(da, db)


def test_viz_copy_equals_impx(tmp_path):
    """Every drawing and statistic of the copy equals impx's, plot_matches_gt's
    kept behaviours included (margin ignored, n_gt_match 1 without a GT match)."""
    import matplotlib

    matplotlib.use("Agg")
    rs = np.random.RandomState(5)
    img0, img1 = textured(rs, 60, 80), textured(rs, 50, 70)
    k0, k1 = rs.rand(20, 2) * [80, 60], rs.rand(20, 2) * [70, 50]
    idx0 = np.where(rs.rand(20) < 0.6, rs.randint(0, 20, 20), -1)
    gt = np.where(rs.rand(20) < 0.5, idx0, rs.randint(-1, 20, 20))
    pairs = viz.matches_from_indices0(idx0)
    np.testing.assert_array_equal(pairs, jviz.matches_from_indices0(idx0))
    errors = rs.rand(len(pairs))
    color = viz.error_colormap(1 - errors)
    np.testing.assert_array_equal(color, jviz.error_colormap(1 - errors))
    for fn, args, kw in (
            ("draw_points", (img0, k0), {}),
            ("draw_matches", (img0, img1, k0, k1, pairs, rs.rand(len(pairs)) < 0.5), {}),
            ("make_matching_plot_fast", (img0, img1, k0, k1, k0[pairs[:, 0]], k1[pairs[:, 1]], color),
             {"text": ["IMP"], "small_text": ["x"], "show_keypoints": True}),
    ):
        np.testing.assert_array_equal(getattr(viz, fn)(*args, **kw), getattr(jviz, fn)(*args, **kw), err_msg=fn)
    inliers = rs.rand(20) < 0.5
    for gt_matches, margin in ((gt, 10), (np.full(20, -1), 30), (None, 10)):
        a, b = (module.plot_matches_gt(img0, img1, k0, k1, idx0, gt_matches, inliers=inliers, margin=margin)
                for module in (viz, jviz))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert viz.plot_matches_gt(img0, img1, k0, k1, idx0, np.full(20, -1))["n_gt_match"] == 1
    np.testing.assert_array_equal(viz.plot_matches_gt(img0, img1, k0, k1, idx0, gt, margin=0)["match_img"],
                                  viz.plot_matches_gt(img0, img1, k0, k1, idx0, gt, margin=40)["match_img"])
    assert viz.eval_matches(pairs, gt) == jviz.eval_matches(pairs, gt)
    paths = [tmp_path / "a.png", tmp_path / "b.png"]
    for module, path in zip((viz, jviz), paths):
        module.make_matching_plot(img0, img1, k0, k1, k0[:5], k1[:5], color[:5], text=["t"], path=str(path))
    assert paths[0].read_bytes() == paths[1].read_bytes()


N_LAYERS = 2


@pytest.fixture(scope="module")
def demo_inputs(tmp_path_factory):
    """Two PNGs (image 1 is image 0 moved 12 px to the left) and IMP's
    weights at D = 128, 2 layers, written by impx in the reference layout with
    the final projections scaled x4, under which the shifted keypoints match
    (at random weights the plan spreads below the match threshold)."""
    root = tmp_path_factory.mktemp("demo")
    big = textured(np.random.RandomState(6), 240, 360, blur=2.0)
    cv2.imwrite(str(root / "a.png"), big[:, :320])
    cv2.imwrite(str(root / "b.png"), big[:, 12:332])
    model = jax_eval_imp.build_model("IMP", "sift", n_layers=N_LAYERS)
    params = model.init(jax.random.PRNGKey(0))
    state = matcher_state_dict(params, model.config, sharing=True)
    for k in state:
        if k.startswith("final_proj") and k.endswith("weight"):
            state[k] = state[k] * 4
    torch.save({"model": state}, root / "imp.pth")
    return root


def _cut_depth(monkeypatch):
    """Both demos build their matcher at N_LAYERS layers."""
    port, jax_ = eval_imp.build_model, jax_eval_imp.build_model
    monkeypatch.setattr(demo, "build_model", lambda m, f, **kw: port(m, f, n_layers=N_LAYERS, **kw))
    monkeypatch.setattr(jax_eval_imp, "build_model", lambda m, f, **kw: jax_(m, f, n_layers=N_LAYERS, **kw))


def test_demo_equals_impx_demo(demo_inputs, monkeypatch, capsys):
    """SIFT features, one .pth: equal match counts and equal PNG bytes, the
    cv2 pose's inlier colours included (--fx)."""
    from impx import demo as jax_demo

    _cut_depth(monkeypatch)
    args = ["--image0", str(demo_inputs / "a.png"), "--image1", str(demo_inputs / "b.png"),
            "--feature", "sift", "--weights", str(demo_inputs / "imp.pth"), "--fx", "300"]
    out = demo.main([*args, "--device", "cpu", "--output", str(demo_inputs / "port.png")])
    port_log = capsys.readouterr().out
    jax_demo.main([*args, "--output", str(demo_inputs / "impx.png")])
    impx_log = capsys.readouterr().out
    counts = [int(line.split()[1]) for log in (port_log, impx_log) for line in log.splitlines()
              if line.startswith("matches:")]
    assert counts[0] == counts[1] == len(out["matches"]) >= 50, counts
    assert out["inliers"] is not None and "pose inliers" in impx_log
    assert (demo_inputs / "port.png").read_bytes() == (demo_inputs / "impx.png").read_bytes()


@pytest.mark.parametrize("feature,method", [("spp", "IMP"), ("sift", "EIMP")])
def test_demo_runs_superpoint_and_eimp(demo_inputs, sp_weights, monkeypatch, feature, method, tmp_path):
    _cut_depth(monkeypatch)
    out = demo.main(["--image0", str(demo_inputs / "a.png"), "--image1", str(demo_inputs / "b.png"),
                     "--feature", feature, "--sp_weights", sp_weights, "--matching_method", method,
                     "--num_kpt", "256", "--device", "cpu", "--fx", "300", "--output", str(tmp_path / "m.png")])
    assert (tmp_path / "m.png").stat().st_size > 0
    assert out["features"][0] > 100 and len(out["matches"]) > 0
