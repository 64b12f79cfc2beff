"""impx's three studies in the port (impx_torch/eval/{pose_study,fm_study,
geo_study}.py) on the CPU: the synthetic scenes bit for bit against impx's
under one RandomState; pose_study's cv2 rows against impx's; each study's
--fast CLI (pose_study at 60 points and 64 hypotheses, geo_study at batch 2,
to stay within the file's minute) with the device backends recovering poses
and F; geo_study's in-memory eval pairs against StandardReader over
write_eval_hdf5's file. torch and OpenCV run on one thread: the RANSAC's
many small operations took 360 s across threads beside the other workers of
a tier-1 run, against about 25 s alone."""
import math

import numpy as np
import pytest
import torch

from impx.eval import fm_study as jfm
from impx.eval import pose_study as jpose

from impx_torch.eval import fm_study, geo_study, pose_study

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads, cv_threads = torch.get_num_threads(), cv2.getNumThreads()
    torch.set_num_threads(1)
    cv2.setNumThreads(1)
    yield
    torch.set_num_threads(threads)
    cv2.setNumThreads(cv_threads)


def test_synth_pair_and_scene_equal_impx():
    for args in ((200, 1.0, 0.2), (50, 2.0, 0.5), (30, 0.5, 0.0)):
        a = pose_study.synth_pair(np.random.RandomState(3), *args)
        b = jpose.synth_pair(np.random.RandomState(3), *args)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for args in ((250, 62, 1.0), (120, 120, 2.0)):
        a = fm_study._scene(np.random.RandomState(17), *args[:2], noise_px=args[2])
        b = jfm._scene(np.random.RandomState(17), *args[:2], noise_px=args[2])
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_pose_errors_equal_impx():
    rs = np.random.RandomState(0)
    R, t = np.eye(3), np.array([0.0, 0.0, 1.0])
    for _ in range(5):
        k0, k1, K, R_gt, t_gt = pose_study.synth_pair(rs, 10, 1.0, 0.0)
        assert pose_study.pose_err(R_gt, t_gt, R, t) == jpose.pose_err(R_gt, t_gt, R, t)
    assert pose_study.pose_err(R, t, None, None) == math.inf


def test_pose_study_cv2_rows_equal_impx():
    """The cv2 backend on the same pairs: the same findEssentialMat model,
    then the cheirality-checked decomposition in float32, the port's in
    torch and impx's in XLA, whose roundings move a pose error by up to
    4.6e-5 degrees here. Each pair's error within 1e-4 degrees, and the AUC
    rows of a small grid (percent) within 1e-3."""
    rs = np.random.RandomState(0)
    pairs = [pose_study.synth_pair(rs, 200, 1.0, frac) for frac in (0.2, 0.5) for _ in range(4)]
    np.testing.assert_allclose(pose_study.run_backend("cv2", pairs), jpose.run_backend("cv2", pairs),
                               rtol=0, atol=1e-4)
    kw = dict(trials=4, n=200, noises=(1.0,), outliers=(0.2, 0.5), backends=("cv2",))
    got, want = pose_study.study(**kw), jpose.study(**kw)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-3, err_msg=str(key))


def test_pose_study_fast(capsys):
    torch.manual_seed(0)
    res = pose_study.main(["--fast", "--n", "60", "--hypotheses", "64", "--device", "cpu"])
    assert len(res) == 3 * 2 * 3
    assert "Pose AUC@5/10/20 over 20 synthetic pairs" in capsys.readouterr().out
    for backend in ("torch8", "torch5"):   # low noise, few outliers: the device RANSAC recovers the pose
        assert res[(0.5, 0.2, backend)][2] >= 80.0, (backend, res[(0.5, 0.2, backend)])
    with pytest.raises(ValueError, match="unknown backend"):
        pose_study.run_backend("jax8", [], device="cpu")


def test_fm_study_fast():
    res = fm_study.main(["--fast", "--device", "cpu"])
    assert len(res) == 3 * 2 * 2
    inl, sgd = res[(0.5, 0.2, "device")]
    assert inl >= 95.0 and sgd < 1e-2, (inl, sgd)


def test_geo_study_eval_pairs_equal_the_hdf5_reader(tmp_path):
    pytest.importorskip("h5py")
    from impx_torch.data.reader import StandardReader
    from impx_torch.data.synthetic import write_eval_hdf5

    kw = dict(n_inliers=24, n_outliers0=40, n_outliers1=40, desc_dim=32, desc_noise=0.55)
    path = write_eval_hdf5(str(tmp_path / "geo.hdf5"), num_pairs=3, seed=99, **kw)
    want = StandardReader({"rawdata_dir": str(tmp_path), "dataset_dir": path, "num_kpt": 48})
    got = geo_study.EvalPairs(3, 48, seed=99, **kw)
    assert len(got) == len(want) == 3
    for i in range(3):
        a, b = got.run(i), want.run(i)
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_geo_study_fast(capsys):
    rows = geo_study.main(["--fast", "--batch", "2", "--device", "cpu"])
    assert [name for name, _ in rows] == ["matching-only", "with_geo"]
    for _, res in rows:
        assert set(res["auc"]) >= {5, 10, 20} and all(np.isfinite(v) for v in res["auc"].values())
        assert 0.0 <= res["precision"] <= 100.0
    out = capsys.readouterr().out
    assert "| with_geo |" in out and "step 60:" in out
