"""The port's eval-data pipeline against impx's, on the CPU: depth
reprojection and ground-truth labels, the misc geometry, the YFCC, ScanNet
and MegaDepth dumps on synthetic scenes, the dump CLI, the downloader's dry
run and the reproduce chain.

Tolerances: the torch geometry within rtol 1e-5 of impx's jnp (float32
both, the 4x4 inverse included) with equal match labels; the numpy copies
exactly equal; the dumps' HDF5 groups and MegaDepth's per-scene files equal
(RootSIFT features, which are copies of impx's); the reproduce chain by
the eval drivers' rules (tests/test_torch_eval.py: equal precision and
matching score on equal matches, pose errors within 1e-3 degrees, the AUC
within what the pose errors allow). impx's reference implementations run
under jax.jit.
"""
import os

import cv2
import h5py
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import yaml

from impx.data.dump import base as jax_base
from impx.data.dump import get_dumper as jax_get_dumper
from impx.data.dump import dump as jax_dump
from impx.data.dump import dump_megadepth as jax_megadepth
from impx.data.dump.download_data import main as jax_download
from impx.eval import eval_imp as jax_eval_imp
from impx.eval import reproduce as jax_reproduce
from impx.geometry import misc as jmisc
from impx.geometry import reprojection as jrep
from impx.tools.convert_torch import matcher_state_dict

from impx_torch.data.dump import base, dump, dump_megadepth, get_dumper
from impx_torch.data.dump.download_data import main as download
from impx_torch.eval import eval_imp, reproduce
from impx_torch.geometry import misc
from impx_torch.geometry import reprojection as rep
from impx_torch.models.superpoint import SuperPoint

RTOL = 1e-5
AUC_ATOL = 1e-6
POSE_DEG = 1e-3
DESC_SCALE = 16.0


def _pose(rs, scale=0.1):
    R, _ = cv2.Rodrigues(rs.randn(3) * scale)
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, rs.randn(3) * scale
    return T


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a, np.float32)) for a in arrays]


def _planted(rs, n=80, m=90, planted=30):
    """Two views with `planted` true correspondences (depths consistent for
    the cycle check) among random points."""
    K = np.array([[400.0, 0, 200], [0, 400, 150], [0, 0, 1]])
    pose1, pose2 = _pose(rs), _pose(rs)
    pos1, pos2 = rs.rand(n, 2) * 400, rs.rand(m, 2) * 400
    depth1, depth2 = rs.uniform(2, 10, n), rs.uniform(2, 10, m)
    X = np.concatenate([(pos1[:planted] + 0.5 - K[:2, 2]) * depth1[:planted, None] / K[0, 0],
                        depth1[:planted, None], np.ones((planted, 1))], axis=1)
    X2 = (pose2 @ np.linalg.inv(pose1) @ X.T).T
    pos2[:planted] = X2[:, :2] / X2[:, 2:3] * K[0, 0] + K[:2, 2] - 0.5 + rs.randn(planted, 2) * 0.5
    depth2[:planted] = X2[:, 2]
    return pos1, depth1, K, pose1, pos2, depth2, K, pose2


def test_reproject_points_matches_impx():
    rs = np.random.RandomState(0)
    pos1, depth1, K1, pose1, _, _, K2, pose2 = _planted(rs)
    bbox1, bbox2 = np.array([3.0, 5.0]), np.array([1.0, 2.0])
    for boxes in ((None, None), (bbox1, bbox2)):
        want = jax.jit(jrep.reproject_points)(*map(jnp.asarray, (pos1, depth1, K1, pose1, K2, pose2)), *(
            None if b is None else jnp.asarray(b) for b in boxes))
        got = rep.reproject_points(*_t(pos1, depth1, K1, pose1, K2, pose2), *(
            None if b is None else torch.as_tensor(b, dtype=torch.float32) for b in boxes))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("cycle_check,masks", [(True, False), (False, False), (True, True)])
def test_match_from_projection_points_equals_impx(cycle_check, masks):
    rs = np.random.RandomState(1)
    args = _planted(rs)
    kw = dict(inlier_th=3.0, outlier_th=5.0, cycle_check=cycle_check)
    if masks:
        kw_j = dict(valid1=jnp.asarray(rs.rand(80) < 0.8), valid2=jnp.asarray(rs.rand(90) < 0.8))
        kw_t = {k: torch.from_numpy(np.array(v)) for k, v in kw_j.items()}
    else:
        kw_j = kw_t = {}
    fn = jax.jit(lambda *a, **k: jrep.match_from_projection_points(*a, **kw, **k))
    m_j, out_j = fn(*map(jnp.asarray, args), **kw_j)
    m_t, out_t = rep.match_from_projection_points(*_t(*args), **kw, **kw_t)
    assert m_t.dtype == torch.int32
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    assert (m_t.numpy() >= 0).sum() >= (15 if masks else 25)


def test_misc_matches_impx():
    rs = np.random.RandomState(2)
    K = np.array([[300.0, 0, 160], [0, 310, 120], [0, 0, 1]], np.float32)
    kp = (rs.rand(2, 7, 2) * 300).astype(np.float32)
    np.testing.assert_allclose(misc.norm_kpt(K, torch.from_numpy(kp)).numpy(),
                               np.asarray(jmisc.norm_kpt(jnp.asarray(K), jnp.asarray(kp))), rtol=RTOL, atol=1e-6)
    nk = (rs.rand(7, 2) - 0.5).astype(np.float32)
    np.testing.assert_allclose(misc.unnorm_kp(K, torch.from_numpy(nk)).numpy(),
                               np.asarray(jmisc.unnorm_kp(K, jnp.asarray(nk))), rtol=RTOL)
    x = rs.randn(11, 3).astype(np.float32)
    got = misc.normalize_points_3d(torch.from_numpy(x), 1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jmisc.normalize_points_3d(jnp.asarray(x), 1.5)), rtol=RTOL)
    mx = np.abs(x).max(0)
    np.testing.assert_allclose(misc.denormalize_points_3d(got, torch.from_numpy(mx), 1.5).numpy(),
                               np.asarray(jmisc.denormalize_points_3d(jnp.asarray(got.numpy()), mx, 1.5)),
                               rtol=RTOL)
    depth = rs.uniform(0, 5, (30, 40))
    depth[depth < 0.5] = 0
    pos = rs.rand(50, 2) * [30, 40]
    for a, b in zip(misc.interpolate_depth(pos, depth), jmisc.interpolate_depth(pos, depth)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(misc.get_rnd_homography(np.random.RandomState(3), 4),
                                  jmisc.get_rnd_homography(np.random.RandomState(3), 4))
    for R in (cv2.Rodrigues(rs.randn(3))[0], np.array([[0, 0, -1.0], [0, 1, 0], [1, 0, 0]])):
        np.testing.assert_array_equal(misc.rotation_matrix_to_euler_angles(R),
                                      jmisc.rotation_matrix_to_euler_angles(R))


def test_relative_pose_helpers_equal_impx():
    rs = np.random.RandomState(4)
    v = rs.randn(5, 3)
    np.testing.assert_array_equal(base.np_skew_symmetric(v), jax_base.np_skew_symmetric(v))
    K1, K2 = np.diag([300.0, 310, 1]), np.diag([280.0, 290, 1])
    dR, dt = cv2.Rodrigues(rs.randn(3) * 0.2)[0], rs.randn(3)
    for a, b in zip(base.relative_pose_to_e_f(dR, dt, K1, K2), jax_base.relative_pose_to_e_f(dR, dt, K1, K2)):
        np.testing.assert_array_equal(a, b)


def _hdf5_items(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()]) if isinstance(obj, h5py.Dataset) else None)
    return out


def _assert_same_hdf5(a, b):
    ia, ib = _hdf5_items(a), _hdf5_items(b)
    assert ia.keys() == ib.keys()
    for k in ia:
        np.testing.assert_array_equal(ia[k], ib[k], err_msg=k)
    return ia


def _write_scannet_raw(root, rs, n_imgs=3, hw=(96, 128)):
    seq = "scene0000_00"
    for sub in ("img", "extrinsic", "intrinsic"):
        os.makedirs(root / seq / sub, exist_ok=True)
    K = np.array([[100.0, 0, 64], [0, 100, 48], [0, 0, 1]])
    for i in range(n_imgs):
        img = cv2.GaussianBlur((rs.rand(*hw) * 255).astype(np.uint8), (5, 5), 1.0)
        cv2.imwrite(str(root / seq / "img" / f"{i}.jpg"), img)
        np.savetxt(root / seq / "extrinsic" / f"{i}.txt", _pose(rs))
        np.savetxt(root / seq / "intrinsic" / f"{i}.txt", K)
    pair_fn = root / "pairs.txt"
    pair_fn.write_text("\n".join(f"{seq}/img/{i}.jpg {seq}/img/{i + 1}.jpg" for i in range(n_imgs - 1)))
    return str(pair_fn)


def _scannet_config(tmp_path, raw, pair_fn, side, extractor):
    return {"data_name": "scannet", "rawdata_dir": str(raw), "pair_list": pair_fn, "image_size": [96, 128],
            "feature_dump_dir": str(tmp_path / side / "feat"), "dataset_dump_dir": str(tmp_path / side / "ds"),
            "extractor": {"num_process": 1, "overwrite": True, "resize": [-1], **extractor}}


def test_scannet_dump_cli_equals_impx(tmp_path):
    """The dump CLI over a YAML config, RootSIFT at 100 keypoints: the port's
    standard HDF5 equals impx's group by group, and the port's reader reads it."""
    from impx_torch.data.reader import StandardReader

    raw = tmp_path / "raw"
    pair_fn = _write_scannet_raw(raw, np.random.RandomState(5))
    paths = []
    for side, main in (("port", dump.main), ("impx", jax_dump.main)):
        cfg = _scannet_config(tmp_path, raw, pair_fn, side, {"name": "root", "num_kpt": 100, "det_th": 0.0})
        (tmp_path / f"{side}.yaml").write_text(yaml.safe_dump(cfg))
        main(["--config_path", str(tmp_path / f"{side}.yaml")])
        paths.append(tmp_path / side / "ds" / "scannet_root_100.hdf5")
    items = _assert_same_hdf5(*paths)
    assert len([k for k in items if k.startswith("kpt1/")]) == 2
    reader = StandardReader({"rawdata_dir": str(raw), "dataset_dir": str(paths[0]), "num_kpt": 100})
    info = reader.run(1)
    reader.close()
    assert info["x1"].shape[1] == 3 and info["desc1"].shape[1] == 128 and info["img_size1"] == (96, 128)


def test_threaded_superpoint_dump_equals_serial(tmp_path):
    """Four extraction threads share one SuperPoint (built once, under the
    extractor's lock) and write the same files as one thread."""
    raw = tmp_path / "raw"
    pair_fn = _write_scannet_raw(raw, np.random.RandomState(6), n_imgs=5)
    weights = tmp_path / "superpoint_v1.pth"
    torch.save(SuperPoint(device="cpu", seed=2).state_dict(), weights)
    paths = []
    for workers in (4, 1):
        cfg = _scannet_config(tmp_path, raw, pair_fn, f"w{workers}", {
            "name": "sp", "num_kpt": 64, "det_th": 0.005, "weight_path": str(weights), "device": "cpu",
            "num_process": workers})
        dumper = get_dumper("scannet", cfg)
        dumper.initialize()
        dumper.dump_feature()
        dumper.format_dump_data()
        paths.append(tmp_path / f"w{workers}" / "ds" / "scannet_sp_64.hdf5")
    items = _assert_same_hdf5(*paths)
    assert items["desc1/0"].shape[1] == 256 and len(items["kpt1/0"]) > 10


def test_get_dumper_names():
    for fn in (get_dumper, jax_get_dumper):
        with pytest.raises(KeyError):
            fn("megadepth", {})


def _write_megadepth_raw(root, rs, scene="0000", n_imgs=3, h=360, w=480, shift=16, f=300.0, z=5.0):
    """A fronto-parallel plane at depth z seen by cameras moved sideways:
    image i is the crop at column shift * i of one texture, camera i sits at
    x = shift * i * z / f, so depth reprojection maps each keypoint onto its
    shifted copy. Pairs i < j overlap 0.5 and share 30 3D points."""
    big = cv2.GaussianBlur((rs.rand(h, w + shift * (n_imgs - 1)) * 255).astype(np.uint8), (0, 0), 1.5)
    os.makedirs(root / "scene_info", exist_ok=True)
    os.makedirs(root / scene / "images", exist_ok=True)
    os.makedirs(root / scene / "depths", exist_ok=True)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    images, depths, poses = [], [], []
    for i in range(n_imgs):
        images.append(f"{scene}/images/{i}.png")
        depths.append(f"{scene}/depths/{i}.h5")
        cv2.imwrite(str(root / images[-1]), big[:, shift * i: shift * i + w])
        with h5py.File(root / depths[-1], "w") as fh:
            fh["depth"] = np.full((h, w), z, np.float32)
        pose = np.eye(4)
        pose[0, 3] = -shift * i * z / f
        poses.append(pose)
    obj = lambda xs: np.array(xs + [None], dtype=object)[:-1]  # noqa: E731  (1-D object arrays)
    np.savez(root / "scene_info" / f"{scene}.0.npz", image_paths=obj(images), depth_paths=obj(depths),
             poses=np.stack(poses), intrinsics=np.stack([K] * n_imgs),
             overlap_matrix=0.5 * np.triu(np.ones((n_imgs, n_imgs)), 1),
             scale_ratio_matrix=np.ones((n_imgs, n_imgs)),
             points3D_id_to_2D=obj([{p: (0.0, 0.0) for p in range(30)} for _ in range(n_imgs)]))
    (root / "scenes.txt").write_text(scene + "\n")


def _load(path):
    return np.load(path, allow_pickle=True)


def test_megadepth_dump_equals_impx(tmp_path):
    """RootSIFT at 4096 keypoints, labels by cycle-checked reprojection
    (inlier 5 px, outlier 15 px), de-duplication, the per-scene files and the
    pair-count table: the port's files equal impx's."""
    raw = tmp_path / "raw"
    _write_megadepth_raw(raw, np.random.RandomState(7))
    common = ["--base_path", str(raw), "--scene_list_fn", str(raw / "scenes.txt"), "--feature_type", "sift"]
    dump_megadepth.MegadepthDumper(dump_megadepth.parser.parse_args(
        [*common, "--save_dir", str(tmp_path / "port"), "--device", "cpu"])).run()
    jax_megadepth.MegadepthDumper(jax_megadepth.parser.parse_args(
        [*common, "--save_dir", str(tmp_path / "impx")])).run()
    ours, theirs = _load(tmp_path / "port" / "matches_sift" / "0000.npy"), _load(
        tmp_path / "impx" / "matches_sift" / "0000.npy")
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert len(a["matched_ids1"]) > 100
        assert len(set(a["matched_ids1"])) == len(a["matched_ids1"])          # de-duplicated
        assert len(set(a["matched_ids2"])) == len(a["matched_ids2"])
    for rel in ("mega_scene_nmatches_sift.npy", "matches_sep_sift/0000/2.npy"):
        a, b = _load(tmp_path / "port" / rel).item(), _load(tmp_path / "impx" / rel).item()
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    kp = _load(tmp_path / "port" / "keypoints_sift" / "0000" / "0.png_sift.npy").item()
    kq = _load(tmp_path / "impx" / "keypoints_sift" / "0000" / "0.png_sift.npy").item()
    for k in kp:
        np.testing.assert_array_equal(kp[k], kq[k], err_msg=k)


def test_protocol_and_configs_equal_impx():
    assert reproduce.PROTOCOL == jax_reproduce.PROTOCOL
    assert reproduce.YFCC_SEQS == jax_reproduce.YFCC_SEQS
    assert reproduce.YFCC_ARCHIVE == jax_reproduce.YFCC_ARCHIVE
    for dataset in ("yfcc", "scannet"):
        for feature in ("spp", "sift"):
            args = (dataset, feature, "/data/raw", "/data/dump")
            assert reproduce.build_dump_config(*args) == jax_reproduce.build_dump_config(*args)
            assert reproduce.build_eval_config(*args) == jax_reproduce.build_eval_config(*args)
    cfg = reproduce.build_dump_config("scannet", "spp", "/r", "/d", device="cpu")
    assert cfg["extractor"]["device"] == "cpu" and cfg["extractor"]["weight_path"] == "weights/superpoint_v1.pth"


def test_download_dry_run_equals_impx(tmp_path, capsys):
    """--dry-run prints the chunk URLs and opens no socket: the port's list
    equals impx's, directly and through reproduce's --download."""
    argv = ["raw_data", str(tmp_path / "raw_data.tar"), "--chunk-start", "0", "--chunk-end", "8", "--dry-run"]
    download(argv)
    ours = capsys.readouterr().out.split()
    jax_download(argv)
    assert ours == capsys.readouterr().out.split()
    assert len(ours) == 9 and ours[-1].endswith("oanet_data/raw_data.tar.008")
    for module in (reproduce, jax_reproduce):
        module.run_download("yfcc", str(tmp_path / "yfcc"), dry_run=True)
        assert capsys.readouterr().out.split() == ours


def _write_yfcc_raw(root, seqs, rs, n_imgs=3, h=96, w=128, shift=8):
    """The YFCC download's layout (tests/test_reproduce.py builds it with
    unrelated images): per scene test/images/*.jpg, images.txt,
    calibration.txt and a calibration HDF5 an image (K, imsize, R, T), and
    pairs/<seq>-te-1000-pairs.pkl. Here image i is the crop at column
    shift * i of one texture a scene, so a pair's keypoints match."""
    import pickle

    K = np.array([[120.0, 0, (w - 1) / 2], [0, 120.0, (h - 1) / 2], [0, 0, 1.0]])
    os.makedirs(root / "pairs", exist_ok=True)
    for seq in seqs:
        sdir = root / "yfcc100m" / seq / "test"
        os.makedirs(sdir / "images", exist_ok=True)
        os.makedirs(sdir / "calibration", exist_ok=True)
        big = cv2.GaussianBlur((rs.rand(h, w + shift * n_imgs) * 255).astype(np.uint8), (5, 5), 1.0)
        names, cals = [], []
        for i in range(n_imgs):
            cv2.imwrite(str(sdir / "images" / f"{i}.jpg"), big[:, shift * i: shift * i + w])
            names.append(f"images/{i}.jpg")
            cals.append(f"calibration/cal{i}.h5")
            with h5py.File(sdir / cals[-1], "w") as f:
                f["K"], f["imsize"] = K, np.array([[w, h]])
                f["R"], f["T"] = cv2.Rodrigues(rs.randn(3) * 0.05)[0], rs.randn(3)
        np.savetxt(sdir / "images.txt", names, fmt="%s")
        np.savetxt(sdir / "calibration.txt", cals, fmt="%s")
        with open(root / "pairs" / f"{seq}-te-1000-pairs.pkl", "wb") as f:
            pickle.dump([(0, 1), (1, 2)], f)


def _recording(module, monkeypatch):
    """Record (indices0, pose error, precision, matching score) of every pair
    that module's evaluate scores."""
    log = []
    score = module._score_pair

    def wrapped(info, x0, x1, matches, bucket, pose_errors, precisions, matching_scores, *a, **k):
        out = score(info, x0, x1, matches, bucket, pose_errors, precisions, matching_scores, *a, **k)
        log.append((np.asarray(matches).copy(), pose_errors[-1], precisions[-1], matching_scores[-1]))
        return out

    monkeypatch.setattr(module, "_score_pair", wrapped)
    return log


def test_reproduce_chain_equals_impx(tmp_path, monkeypatch):
    """Raw YFCC layout -> the protocol's RootSIFT dump at 2000 keypoints ->
    the standard HDF5 -> the eval CLI at --layers 2, in both packages, on one
    .pth (impx's random 2-layer IMP weights in the reference layout, the
    final projections x4): equal HDF5 files. Then each file's descriptors are
    scaled x16, as tests/test_torch_eval.py scales its dataset (at unit norm
    the random keypoint encoder swamps them), and the two evals agree by
    that file's rules: a pair with equal matches has equal precision and
    matching score and pose errors within POSE_DEG (or cosines within 1e-6),
    the AUC moves by no more than the pose errors allow. SIFT repeats a
    keypoint at one place with another orientation, and such near-tied rows
    may match in one package only: indices0 agree on at least 0.999 of the
    rows a pair, and on every row of most pairs."""
    rs = np.random.RandomState(0)
    seqs = ["scene_a", "scene_b", "scene_c"]
    _write_yfcc_raw(tmp_path, seqs, rs)
    weights = tmp_path / "weights"
    os.makedirs(weights)
    model = jax_eval_imp.build_model("IMP", "sift", n_layers=2)
    state = matcher_state_dict(model.init(jax.random.PRNGKey(0)), model.config, sharing=True)
    state = {k: v * 4 if k.startswith("final_proj") and k.endswith("weight") else v for k, v in state.items()}
    torch.save({"model": state}, weights / "imp_sift.pth")

    sides = (("port", reproduce, eval_imp, ("--device", "cpu")), ("impx", jax_reproduce, jax_eval_imp, ()))
    for side, module, _, _ in sides:
        dump_cfg = module.build_dump_config("yfcc", "sift", str(tmp_path), str(tmp_path / side), seqs=seqs)
        dump_cfg["extractor"]["num_process"] = 1
        module.run_dump(dump_cfg)
    files = [tmp_path / side[0] / "yfcc_root_2000.hdf5" for side in sides]
    _assert_same_hdf5(*files)
    for path in files:
        with h5py.File(path, "r+") as f:
            for group in ("desc1", "desc2"):
                for ds in f[group].values():
                    ds[...] = ds[()] * DESC_SCALE

    results, logs = [], []
    flags = ("--layers", "2", "--max_pairs", "6", "--eval_batch", "1", "--weight_root", str(weights))
    for side, module, driver, extra in sides:
        logs.append(_recording(driver, monkeypatch))
        eval_cfg = module.build_eval_config("yfcc", "sift", str(tmp_path), str(tmp_path / side))
        results.append(module.run_eval("yfcc", "sift", eval_cfg, "IMP", extra_args=(*flags, *extra)))
    (ours, theirs), (log, ref_log) = results, logs
    assert len(log) == len(ref_log) == 6
    equal_pairs, shift = 0, 0.0
    for (m, err, prec, ms), (rm, rerr, rprec, rms) in zip(log, ref_log):
        assert (m == rm).mean() >= 0.999 and (m > -1).sum() > 1000
        shift += abs(err - rerr)
        if np.array_equal(m, rm):
            equal_pairs += 1
            assert (prec, ms) == (rprec, rms)
            assert abs(err - rerr) < POSE_DEG or abs(np.cos(np.deg2rad(err)) - np.cos(np.deg2rad(rerr))) < 1e-6
    assert equal_pairs >= 4
    assert set(ours["auc"]) == set(theirs["auc"]) == {5, 10, 20, 50}
    for th in ours["auc"]:
        assert abs(ours["auc"][th] - theirs["auc"][th]) < AUC_ATOL + 100 * shift / (len(log) * th), th
