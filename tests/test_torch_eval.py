"""The port's eval loops against impx's on the CPU: evaluate (the eval CLI's
non-iterative loop), evaluate_full, the pipelined evaluate_full, main, the
reader and the checkpoint loader.

The setup of impx's own eval-loop tests: a synthetic HDF5 from
write_eval_hdf5 (48 true correspondences and 48 outliers a side, D = 64), a
3-layer matcher at D = 64 with the keypoint encoder (16, 32), bucket 128,
fp32. impx's model runs with attn_impl='pallas' (its kernels interpreted),
the port's with the same weights carried by params_from_jax. The file's
descriptors are scaled from unit norm to norm DESC_SCALE: at unit norm the
random keypoint encoder and layers swamp them and a pair keeps 1-3 matches;
at 16 about 60 of 96 rows match, and every pair has a pose.
"""
import dataclasses
import threading

import h5py
import numpy as np
import pytest

import jax
import torch

from impx.data.reader import StandardReader as JaxReader
from impx.eval.evaluator import AucEval as JaxAucEval
from impx.data.synthetic import write_eval_hdf5 as jax_write_eval_hdf5
from impx.eval import eval_imp as jax_eval_imp
from impx.eval.eval_full import evaluate_full as jax_evaluate_full
from impx.tools.convert_torch import matcher_state_dict

from impx_torch.data.reader import StandardReader
from impx_torch.data.synthetic import synthesize_pair, write_eval_hdf5
from impx_torch.eval import eval_imp
from impx_torch.eval.eval_full import evaluate_full
from impx_torch.eval.evaluator import AucEval
from impx_torch.eval.pipeline import evaluate_full_pipelined
from impx_torch.models import AdaGMN, DGNNS, MatcherConfig
from impx_torch.tools.convert import load_matcher_checkpoint, params_from_jax

N_PAIRS, NUM_KPT, BUCKET = 6, 96, 128
SMALL = dict(descriptor_dim=64, keypoint_encoder=(16, 32))
DESC_SCALE = 16.0
EVAL_CONFIG = {"rescale": 640, "inlier_th": 0.005}
# pose errors, port against impx: within POSE_DEG, or their cosines within
# POSE_COS. Both sides decompose cv2's E in float32 (impx runs without x64),
# with SVDs of other libraries, so R and t differ in the last bits (1e-7,
# tests/test_torch_ransac.py), and the metric's arccos magnifies that near 0:
# d(theta) = d(cos) / sin(theta), so 1e-7 in a cosine is 0.0057 degrees at
# 0.1 degrees. Above 5.7 degrees POSE_COS is the tighter limit.
POSE_DEG, POSE_COS = 1e-3, 1e-6
AUC_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops dominate: one thread, as tests/test_torch_logot.py runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = tmp_path_factory.mktemp("eval") / "synth.hdf5"
    write_eval_hdf5(str(path), num_pairs=N_PAIRS, seed=0, n_inliers=48, n_outliers0=48,
                    n_outliers1=48, desc_dim=64)
    with h5py.File(path, "r+") as f:
        for side in ("desc1", "desc2"):
            for ds in f[side].values():
                ds[...] = ds[()] * DESC_SCALE
    return {"rawdata_dir": str(path.parent), "dataset_dir": str(path), "num_kpt": NUM_KPT}


def _jax_model(method="IMP", compaction=()):
    model = jax_eval_imp.build_model(method, "spp", n_layers=3, attn_impl="pallas",
                                     compaction=compaction)
    model.config = dataclasses.replace(model.config, **SMALL)
    return model


@pytest.fixture(scope="module")
def params():
    return _jax_model().init(jax.random.PRNGKey(0))


def _port_model(params, method="IMP", compaction=()):
    cls = AdaGMN if method.startswith("EIMP") else DGNNS
    cfg = dataclasses.replace(MatcherConfig.eval_config("spp", 3), compaction=compaction, **SMALL)
    model = cls(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.array, params), cfg))
    return model


class Args:
    max_pairs = N_PAIRS
    bucket = BUCKET
    pose_backend = "cv2"
    use_iterative = False
    use_uncertainty = False
    data_parallel = False

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _recording(module, monkeypatch):
    """Record (indices0, pose error, precision, matching score) of every pair
    that module's evaluate scores."""
    log = []
    orig = module._score_pair

    def wrapped(info, x0, x1, matches, bucket, pose_errors, precisions, matching_scores, *a, **k):
        orig(info, x0, x1, matches, bucket, pose_errors, precisions, matching_scores, *a, **k)
        log.append((np.array(matches), pose_errors[-1], precisions[-1], matching_scores[-1]))

    monkeypatch.setattr(module, "_score_pair", wrapped)
    return log


def _assert_same_errors(errs, ref_errs):
    """Pose errors pair by pair within POSE_DEG or POSE_COS; returns their
    summed difference."""
    assert len(errs) == len(ref_errs) == N_PAIRS
    for i, (a, r) in enumerate(zip(errs, ref_errs)):
        assert a == r or abs(a - r) < POSE_DEG or \
            abs(np.cos(np.deg2rad(a)) - np.cos(np.deg2rad(r))) < POSE_COS, (i, a, r)
    assert np.isfinite(errs).sum() >= N_PAIRS - 1
    return sum(abs(a - r) for a, r in zip(errs, ref_errs) if np.isfinite(a))


def _assert_auc_close(auc, ref_auc, shift):
    """AUC within AUC_ATOL beyond what the pose errors' differences allow:
    moving one of n errors by d moves the area under the recall curve up to
    th by at most d / n, so AUC@th (in percent) by 100 d / (n th)."""
    for th in auc:
        assert abs(auc[th] - ref_auc[th]) < AUC_ATOL + 100 * shift / (N_PAIRS * th), th


def _assert_same_run(ref_log, ref, log, out):
    for i, (a, r) in enumerate(zip(log, ref_log)):
        np.testing.assert_array_equal(a[0], r[0], err_msg=f"pair {i}")
        assert a[2:] == r[2:], (i, a[2:], r[2:])
    assert sum((a[0] > -1).sum() for a in log) > 20 * N_PAIRS  # the check bites on real matches
    shift = _assert_same_errors([a[1] for a in log], [r[1] for r in ref_log])
    assert out["precision"] == ref["precision"]
    assert out["matching_score"] == ref["matching_score"]
    _assert_auc_close(out["auc"], ref["auc"], shift)


@pytest.mark.parametrize("eval_batch", [4, 1])
def test_evaluate_matches_impx(dataset, params, monkeypatch, eval_batch):
    """eval_batch 4 over 6 pairs pads the last batch; eval_batch 1 is the
    per-pair loop. cv2 backend on both sides."""
    ref_log = _recording(jax_eval_imp, monkeypatch)
    ref = jax_eval_imp.evaluate(_jax_model(), params, JaxReader(dataset), 1.0, EVAL_CONFIG,
                                Args(eval_batch=eval_batch))
    log = _recording(eval_imp, monkeypatch)
    out = eval_imp.evaluate(_port_model(params), StandardReader(dataset), 1.0, EVAL_CONFIG,
                            Args(eval_batch=eval_batch))
    _assert_same_run(ref_log, ref, log, out)
    assert out["mean_stop_iteration"] == ref["mean_stop_iteration"] == 3.0


def test_evaluate_compaction_overflow_matches_impx(dataset, params, monkeypatch):
    """An EIMP schedule whose bucket (8) is smaller than every pair's survivors
    overflows on every pair; both re-run them mask-only."""
    schedule = ((2, 8),)
    ref_log = _recording(jax_eval_imp, monkeypatch)
    ref = jax_eval_imp.evaluate(_jax_model("EIMP", schedule), params, JaxReader(dataset), 1.0,
                                EVAL_CONFIG, Args(eval_batch=4))
    log = _recording(eval_imp, monkeypatch)
    out = eval_imp.evaluate(_port_model(params, "EIMP", schedule), StandardReader(dataset), 1.0,
                            EVAL_CONFIG, Args(eval_batch=4))
    assert out["compaction_overflow_pairs"] == ref["compaction_overflow_pairs"] == N_PAIRS
    _assert_same_run(ref_log, ref, log, out)


def _opt(dataset, backend):
    return {"reader": dataset,
            "evaluator": {**EVAL_CONFIG, "ransac_th": 1.0, "pose_backend": backend}}


def _parsed_errors(cls, monkeypatch):
    """The pose errors each `cls` evaluator holds when it is parsed."""
    errs = []
    orig = cls.parse

    def parse(self):
        errs.append(list(self.err))
        return orig(self)

    monkeypatch.setattr(cls, "parse", parse)
    return errs


def test_evaluate_full_matches_impx(dataset, params, monkeypatch):
    ref_errs = _parsed_errors(JaxAucEval, monkeypatch)
    ref = jax_evaluate_full(_jax_model(), params, _opt(dataset, "cv2"), max_pairs=N_PAIRS)
    errs = _parsed_errors(AucEval, monkeypatch)
    out = evaluate_full(_port_model(params), _opt(dataset, "cv2"), max_pairs=N_PAIRS)
    assert set(out) == set(ref)
    assert out["prec"] == ref["prec"] and out["mscore"] == ref["mscore"]
    shift = _assert_same_errors(errs[0], ref_errs[0])
    _assert_auc_close({th: out[f"auc{th}"] for th in (5, 10, 15, 20)},
                      {th: ref[f"auc{th}"] for th in (5, 10, 15, 20)}, shift)


@pytest.mark.parametrize("backend", ["cv2", "device"])
def test_pipelined_equals_serial(dataset, params, backend):
    """Batch 4 over 6 pairs (a repeated-tail batch), 3 evaluator threads."""
    model = _port_model(params)
    serial = evaluate_full(model, _opt(dataset, backend), max_pairs=N_PAIRS)
    piped = evaluate_full_pipelined(model, _opt(dataset, backend), max_pairs=N_PAIRS,
                                    batch_size=4, eval_workers=3)
    assert piped == serial
    assert serial["prec"] > 0


def test_pipelined_reader_error_reaches_the_caller(dataset, params, monkeypatch):
    """A reader that raises on pair 5 (in the second batch): the exception
    reaches the caller and the reader thread is joined."""
    orig = StandardReader.run

    def run(self, index):
        if index == 5:
            raise OSError("unreadable pair 5")
        return orig(self, index)

    monkeypatch.setattr(StandardReader, "run", run)
    before = set(threading.enumerate())
    with pytest.raises(OSError, match="unreadable pair 5"):
        evaluate_full_pipelined(_port_model(params), _opt(dataset, "cv2"), max_pairs=N_PAIRS,
                                batch_size=4, prefetch=1)
    assert not [t for t in set(threading.enumerate()) - before if t.is_alive()]


def test_device_backend_is_deterministic_per_pair(dataset, params, monkeypatch):
    """The device backend seeds each pair's generator from (seed, index): the
    serial evaluate gives each pair the same pose error at eval_batch 4 and
    at eval_batch 1."""
    log = _recording(eval_imp, monkeypatch)
    for eb in (4, 1):
        eval_imp.evaluate(_port_model(params), StandardReader(dataset), 1.0, EVAL_CONFIG,
                          Args(eval_batch=eb, pose_backend="device"))
    errs = [a[1] for a in log]
    assert errs[:N_PAIRS] == errs[N_PAIRS:]
    assert np.isfinite(errs).all()


def test_main_on_a_yaml_config(tmp_path, capsys):
    """The CLI end to end on the CPU: a YAML config written here, 2 pairs at
    the published width (D = 256), random weights, 2 layers, the device pose
    backend."""
    data = write_eval_hdf5(str(tmp_path / "synth.hdf5"), num_pairs=2, seed=1, n_inliers=48,
                           n_outliers0=48, n_outliers1=48)
    cfg = tmp_path / "eval.yaml"
    cfg.write_text(f"reader:\n  rawdata_dir: {tmp_path}\n"
                   f"  dataset_dir: {data}\n  num_kpt: {NUM_KPT}\n"
                   "evaluator:\n  rescale: 640\n  inlier_th: 0.005\n")
    out = eval_imp.main(["--dataset", "yfcc", "--config_path", str(cfg), "--device", "cpu",
                         "--max_pairs", "2", "--layers", "2", "--pose_backend", "device",
                         "--weight_root", str(tmp_path)])
    assert set(out) >= {"auc", "precision", "matching_score", "pairs_per_sec_device"}
    assert np.isfinite(out["precision"])
    assert "pose=device, device=cpu" in capsys.readouterr().out


def test_load_matcher_checkpoint_matches_params_from_jax(params, tmp_path):
    """A .pth that torch.save wrote from impx's matcher_state_dict loads to the
    weights params_from_jax carries."""
    jcfg = _jax_model().config
    path = tmp_path / "imp.pth"
    torch.save({"model": matcher_state_dict(params, jcfg, sharing=True), "epoch": 3}, path)
    cfg = dataclasses.replace(MatcherConfig.eval_config("spp", 3), **SMALL)
    got = load_matcher_checkpoint(str(path), cfg, sharing=True)
    want = params_from_jax(jax.tree.map(np.array, params), cfg)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_reader_and_synthetic_copies_match_impx(dataset, tmp_path):
    """The same seed gives the same pairs, HDF5 files and reader output."""
    a = synthesize_pair(np.random.RandomState(4), n_inliers=32, n_outliers0=8, n_outliers1=9)
    from impx.data.synthetic import synthesize_pair as jax_synthesize_pair

    b = jax_synthesize_pair(np.random.RandomState(4), n_inliers=32, n_outliers0=8, n_outliers1=9)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    files = [str(tmp_path / "port.hdf5"), str(tmp_path / "impx.hdf5")]
    for write, path in zip((write_eval_hdf5, jax_write_eval_hdf5), files):
        write(path, num_pairs=N_PAIRS, seed=0, n_inliers=48, n_outliers0=48, n_outliers1=48,
              desc_dim=64)
    ours, theirs = (reader({**dataset, "dataset_dir": path})
                    for reader, path in zip((StandardReader, JaxReader), files))
    assert len(ours) == len(theirs) == N_PAIRS
    for i in range(N_PAIRS):
        x, y = ours.run(i), theirs.run(i)
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]), err_msg=f"{i} {k}")
