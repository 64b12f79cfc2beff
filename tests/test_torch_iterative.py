"""The port's layer stepping, unrolled forward and iterative match-pose loop
against impx's on the CPU (impx_torch/models/gm.py, impx_torch/models/adgm.py,
impx_torch/eval/iterative.py, the iterative branches of
impx_torch/eval/eval_imp.py).

A 6-iteration matcher at D = 32 with the keypoint encoder (16, 32), 10
Sinkhorn iterations and checkpoints at iterations (2, 3, 5), impx's params
carried by params_from_jax; synthetic pairs of 64 keypoints (32 true
correspondences) with descriptors x16, at which random weights match most
true pairs. impx's matchers are built once per module: each compiles a jit
program a layer and one for its checkpoint. The cv2 checkpoints are
deterministic, so the whole loop is held equal to impx's; the device
checkpoints draw from torch generators, so one checkpoint is held against
impx's given impx's own draws, and whole loops by what does not depend on
the draws.
"""
import dataclasses

import h5py
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from impx.data.reader import StandardReader as JaxReader
from impx.eval import eval_imp as jax_eval_imp
from impx.eval.iterative import IterativeMatcher as JaxIterativeMatcher
from impx.models import AdaGMN as JaxAdaGMN, DGNNS as JaxDGNNS, MatcherConfig as JaxConfig
from impx.ransac import ransac as jr

from impx_torch.data.reader import StandardReader, pad_features
from impx_torch.data.synthetic import synthesize_pair, write_eval_hdf5
from impx_torch.eval import eval_imp
from impx_torch.eval.evaluator import pair_generator
from impx_torch.eval.iterative import BatchedIterativeMatcher, IterativeMatcher
from impx_torch.models import AdaGMN, DGNNS, MatcherConfig
from impx_torch.tools.convert import params_from_jax

SMALL = dict(descriptor_dim=32, keypoint_encoder=(16, 32), n_layers=6, num_heads=4, sinkhorn_iterations=10,
             norm_fn="in", n_min_tokens=16)
N = 64
ITS = (2, 3, 5)
# EIMP's checkpoints, where each pool is followed by an iteration that
# recomputes attention, as after every checkpoint of impx's VALID_ITS: impx's
# XLA loop hands a shared layer after a pool the probabilities computed
# under the keep masks before it, where its fused path and the port attend
# with the carried q/k under the new masks (ROADMAP section C)
ITS_EIMP = (3, 5)
THRESH = 1 / 600
HYP = 32
HOST = ("x0px", "x1px", "K0", "K1", "error_th_px")
RTOL = ATOL = 1e-5
POSE_ATOL = 1e-5
# the device checkpoint's pose after the float32 Gauss-Newton polish, whose
# steps amplify its Jacobian's rounding (2e-7 there moves t by 5e-5 in
# tests/test_torch_ransac.py's refine case); measured up to 2.0e-5
DEVICE_POSE_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops dominate: one thread, as tests/test_torch_logot.py runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.no_grad():
        yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def params():
    return JaxDGNNS(JaxConfig(**SMALL)).init(jax.random.PRNGKey(0))


def _port(params, cls=DGNNS, **kw):
    model = cls(MatcherConfig(**SMALL, **kw), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.array, params), model.config))
    return model


def _norm(p, h, w):
    size = np.array([w, h], np.float32)
    return ((p - size / 2.0) / (size.max() * 0.7)).astype(np.float32)


def _feed(seed: int) -> dict:
    """One pair in IterativeMatcher.run's layout, with the cv2 feed."""
    p = synthesize_pair(np.random.RandomState(seed), n_inliers=N // 2, n_outliers0=N // 2,
                        n_outliers1=N // 2, desc_dim=SMALL["descriptor_dim"])
    h, w = p["img_size1"]
    k0, d0, v0 = pad_features(p["kpt1"], 16 * p["desc1"], N)
    k1, d1, v1 = pad_features(p["kpt2"], 16 * p["desc2"], N)
    K0, K1 = p["K1"], p["K2"]
    return {"descriptors0": d0[None], "descriptors1": d1[None],
            "norm_keypoints0": _norm(k0[:, :2], h, w)[None], "norm_keypoints1": _norm(k1[:, :2], h, w)[None],
            "scores0": k0[None, :, 2], "scores1": k1[None, :, 2], "valid0": v0[None], "valid1": v1[None],
            "x0n": ((k0[:, :2] - K0[:2, 2]) / np.array([K0[0, 0], K0[1, 1]])).astype(np.float32),
            "x1n": ((k1[:, :2] - K1[:2, 2]) / np.array([K1[0, 0], K1[1, 1]])).astype(np.float32),
            "x0px": np.ascontiguousarray(k0[:, :2]), "x1px": np.ascontiguousarray(k1[:, :2]),
            "K0": np.asarray(K0, np.float64), "K1": np.asarray(K1, np.float64), "error_th_px": 1.0}


def _jax_feed(feed):
    return {k: jnp.asarray(v) for k, v in feed.items() if k not in HOST}


@pytest.fixture(scope="module")
def eimp_params(params):
    """A dustbin score that sends more of the unmatched rows' plan mass to
    the dustbin, so that pooling has keypoints to drop (2-5 a checkpoint
    here; at the initial 1.0 every row keeps mass >= mscore_th)."""
    return {**params, "bin_score": jnp.asarray(4.0, jnp.float32)}


@pytest.fixture(scope="module")
def impx_cv2(params, eimp_params):
    """impx's cv2-checkpoint matchers, IMP and EIMP with uncertainty."""
    kw = dict(norm_thresh=THRESH, min_kpts=5, checkpoint_backend="cv2")
    return {"IMP": JaxIterativeMatcher(JaxDGNNS(JaxConfig(**SMALL)), params, valid_its=ITS, **kw),
            "EIMP-uncertainty": JaxIterativeMatcher(JaxAdaGMN(JaxConfig(**SMALL)), eimp_params,
                                                    valid_its=ITS_EIMP, with_uncertainty=True, **kw)}


@pytest.fixture(scope="module")
def impx_device(params):
    """impx's device-checkpoint matcher at pose_stop_deg=180: it stops at the
    second checkpoint that has a pose."""
    return JaxIterativeMatcher(JaxDGNNS(JaxConfig(**SMALL)), params, norm_thresh=THRESH, min_kpts=5,
                               valid_its=ITS, num_hypotheses=HYP, pose_stop_deg=180.0)


# ------------------------------------------------------------------ layer stepping
@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_forward_one_layer_matches_impx(params, attn_impl):
    jm = JaxDGNNS(JaxConfig(**SMALL, attn_impl=attn_impl))
    tm = _port(params)
    feed = _feed(1)

    @jax.jit
    def layers(params, data):
        desc0, desc1, v0, v1 = jm._encode_inputs(params, data)
        state, out = None, []
        for i in range(2 * SMALL["n_layers"]):
            desc0, desc1, state = jm.forward_one_layer(params, desc0, desc1, i, state, v0, v1)
            out.append((desc0, desc1))
        return out

    want = layers(params, _jax_feed(feed))
    t0, t1, tv0, tv1 = tm._encode_inputs(tm._on_device(feed))
    tstate = None
    for i, (desc0, desc1) in enumerate(want):
        t0, t1, tstate = tm.forward_one_layer(t0, t1, i, tstate, tv0, tv1)
        np.testing.assert_allclose(t0.numpy(), np.asarray(desc0), rtol=RTOL, atol=ATOL, err_msg=f"layer {i}")
        np.testing.assert_allclose(t1.numpy(), np.asarray(desc1), rtol=RTOL, atol=ATOL, err_msg=f"layer {i}")


def test_produce_matches_with_unequal_counts_matches_impx(params):
    """N0 = 48, N1 = 64: DGNNS routes to GM's unrolled forward, as impx's
    default attn_impl does; equal indices0 at fp32 after every iteration."""
    feed = _feed(2)
    for k in ("descriptors0", "norm_keypoints0", "scores0", "valid0"):
        feed[k] = feed[k][:, :48]
    feed = {k: v for k, v in feed.items() if k not in HOST + ("x0n", "x1n")}
    want = jax.jit(JaxDGNNS(JaxConfig(**SMALL)).produce_matches)(params, _jax_feed(feed))
    got = _port(params).produce_matches(feed)
    assert len(got["indices0"]) == len(want["indices0"]) == SMALL["n_layers"]
    for i, (a, b) in enumerate(zip(got["indices0"], want["indices0"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"iteration {i}")
    np.testing.assert_allclose(got["scores"][-1].numpy(), np.asarray(want["scores"][-1]), rtol=RTOL, atol=ATOL)
    assert (got["indices0"][-1] > -1).sum() > 20


# ------------------------------------------------------------------ the loop
@pytest.mark.parametrize("variant", ["IMP", "EIMP-uncertainty"])
def test_cv2_loop_matches_impx(params, eimp_params, impx_cv2, variant):
    """The reference protocol's loop is deterministic: equal stop iteration
    and indices0, R and t within 1e-5 (both decompose cv2's E in float32)."""
    eimp = variant != "IMP"
    want_m = impx_cv2[variant]
    got_m = IterativeMatcher(_port(eimp_params, AdaGMN) if eimp else _port(params), norm_thresh=THRESH,
                             min_kpts=5, valid_its=ITS_EIMP if eimp else ITS, with_uncertainty=eimp,
                             checkpoint_backend="cv2")
    stops = []
    for seed in (3, 4):
        feed = _feed(seed)
        want, got = want_m.run(feed, None), got_m.run(feed)
        assert got["stopped_at"] == want["stopped_at"] and got["converged"] == want["converged"]
        np.testing.assert_array_equal(got["indices0"], np.asarray(want["indices0"]))
        np.testing.assert_allclose(got["R"], np.asarray(want["R"]), atol=POSE_ATOL)
        np.testing.assert_allclose(got["t"], np.asarray(want["t"]), atol=POSE_ATOL)
        stops.append(got["stopped_at"])
    # IMP converges and stops early; EIMP's pairs fall back to the p = 0.2
    # matches of the last score under the keep masks of the last pool
    assert min(stops) < SMALL["n_layers"] if not eimp else stops == [SMALL["n_layers"]] * 2


def _impx_draws(key, idx0, ms0):
    """The minimal sets impx's checkpoint draws from `key`."""
    keym = jnp.where(idx0 > -1, ms0, -1.0)
    vals, _ = jax.lax.top_k(keym, min(512, idx0.shape[0]))
    valid = vals > -0.5
    return np.array(jr._sample_minimal_sets_weighted(key, jnp.where(valid, jnp.maximum(vals, 1e-4), 0.0),
                                                     valid, HYP, 5))


def test_device_checkpoints_match_impx(params, impx_device):
    """Each checkpoint of the device backend against impx's _check_impl given
    impx's draws, up to and including the one that converges."""
    feed = _feed(5)
    jm = impx_device
    desc0, desc1 = jm._encode(_jax_feed(feed))
    keep0, keep1 = jnp.asarray(feed["valid0"]), jnp.asarray(feed["valid1"])
    probs, R, t, has_pose = (None,) * 4, jnp.eye(3), jnp.zeros(3), jnp.asarray(False)
    tm = IterativeMatcher(_port(params), norm_thresh=THRESH, min_kpts=5, valid_its=ITS, num_hypotheses=HYP,
                          pose_stop_deg=180.0)
    data = tm.model._on_device({k: v for k, v in feed.items() if k not in HOST})
    desc, k0, k1 = tm._encode(data)
    qk = tm.model.init_state()
    state = {"R": torch.eye(3)[None], "t": torch.zeros(1, 3), "has_pose": torch.zeros(1, dtype=torch.bool),
             "indices0": torch.full((1, N), -1), "mscores0": torch.zeros(1, N),
             "stopped_at": torch.full((1,), SMALL["n_layers"]), "converged": torch.zeros(1, dtype=torch.bool)}
    key = jax.random.PRNGKey(1)
    for ni in range(ITS[1] + 1):
        desc0, desc1, probs = jm._steps[ni](desc0, desc1, probs, keep0, keep1)
        desc, qk, _ = tm._step(ni, desc, qk, k0, k1)
        if ni not in ITS:
            continue
        key, sub = jax.random.split(key)
        want = jm._check(jnp.asarray(ni), desc0, desc1, keep0, keep1, jnp.asarray(feed["x0n"]),
                         jnp.asarray(feed["x1n"]), R, t, has_pose, sub, jnp.asarray(THRESH, jnp.float32))
        _, idx0, ms0 = jm._match_at_j(jnp.asarray(ni), desc0, desc1, keep0, keep1)
        draws = torch.as_tensor(_impx_draws(sub, idx0[0], ms0[0]))[None]
        state, _, ratio, done = tm._check(ni, desc, k0, k1, data["x0n"][None], data["x1n"][None], state, [None],
                                          torch.tensor([THRESH]), samples=draws)
        R, t, has_pose = want["R"], want["t"], want["has_pose"]
        assert bool(done) == bool(want["converged"]) == (ni == ITS[1])
        assert bool(state["has_pose"][0]) == bool(has_pose)
        np.testing.assert_array_equal(state["indices0"][0].numpy(), np.asarray(want["indices0"][0]))
        np.testing.assert_allclose(state["R"][0].numpy(), np.asarray(R), atol=DEVICE_POSE_ATOL)
        np.testing.assert_allclose(state["t"][0].numpy(), np.asarray(t), atol=DEVICE_POSE_ATOL)
        np.testing.assert_allclose(float(ratio[0]), float(want["inlier_ratio"]), rtol=1e-6)


def test_early_exit_runs_only_the_layers_before_the_stop(params, impx_device, monkeypatch):
    """pose_stop_deg=180 stops at the second checkpoint with a pose, as impx
    does, and the layers after it never run."""
    tm = _port(params)
    layers = []
    orig = tm.forward_stacked_layer
    monkeypatch.setattr(tm, "forward_stacked_layer", lambda desc, i, *a, **k: (layers.append(i), orig(desc, i, *a, **k))[1])
    m = IterativeMatcher(tm, norm_thresh=THRESH, min_kpts=5, valid_its=ITS, num_hypotheses=HYP,
                         pose_stop_deg=180.0)
    for seed in (6, 7):
        feed = _feed(seed)
        want = impx_device.run(_jax_feed(feed), jax.random.PRNGKey(seed))
        layers.clear()
        got = m.run(feed, pair_generator(torch.device("cpu"), 0, seed))
        assert got["stopped_at"] == want["stopped_at"] == ITS[1] + 1 and got["converged"]
        assert layers == list(range(2 * got["stopped_at"]))


def test_serial_equals_batched(params):
    """Each pair's generator serves every checkpoint in order, so a pair gets
    the same samples alone and in a batch: equal stop iterations and
    indices0, equal poses up to float32 sums of another batch shape."""
    model = _port(params)
    feeds = [_feed(s) for s in (8, 9, 10)]
    kw = dict(norm_thresh=THRESH, min_kpts=5, valid_its=ITS, num_hypotheses=HYP)
    gens = lambda: [pair_generator(torch.device("cpu"), 0, i) for i in range(3)]  # noqa: E731
    batch = {k: np.concatenate([f[k] for f in feeds]) if k not in ("x0n", "x1n")
             else np.stack([f[k] for f in feeds]) for k in feeds[0] if k not in HOST}
    out = BatchedIterativeMatcher(model, **kw).run_batch(batch, gens(), [THRESH] * 3)
    serial = IterativeMatcher(model, **kw)
    for i, g in enumerate(gens()):
        one = serial.run(feeds[i], g)
        assert int(out["stopped_at"][i]) == one["stopped_at"] and bool(out["converged"][i]) == one["converged"]
        assert torch.equal(out["indices0"][i], one["indices0"])
        torch.testing.assert_close(out["R"][i], one["R"], rtol=0, atol=POSE_ATOL)
        torch.testing.assert_close(out["t"][i], one["t"], rtol=0, atol=POSE_ATOL)
    assert out["converged"].any()


def test_uncertainty_pooling_keep_masks_match_impx(eimp_params, impx_cv2):
    """EIMP's pooling after each checkpoint with the per-pair threshold
    0.2 x the inlier ratio: equal keep masks (impx on its probability
    tensors, the port on the carried q/k)."""
    jm = impx_cv2["EIMP-uncertainty"]
    tm = IterativeMatcher(_port(eimp_params, AdaGMN), norm_thresh=THRESH, min_kpts=5, valid_its=ITS_EIMP,
                          with_uncertainty=True)
    feed = _feed(11)
    desc0, desc1 = jm._encode(_jax_feed(feed))
    keep0, keep1 = jnp.asarray(feed["valid0"]), jnp.asarray(feed["valid1"])
    probs = (None,) * 4
    desc, k0, k1 = tm._encode(tm.model._on_device({k: v for k, v in feed.items() if k not in HOST}))
    qk = tm.model.init_state()
    dropped = 0
    for ni in range(SMALL["n_layers"]):
        desc0, desc1, probs = jm._steps[ni](desc0, desc1, probs, keep0, keep1)
        desc, qk, lse = tm._step(ni, desc, qk, k0, k1, with_lse=ni in ITS_EIMP)
        if ni not in ITS_EIMP:
            continue
        score, _, _ = jm._match_at_j(jnp.asarray(ni), desc0, desc1, keep0, keep1)
        tscore, _, _ = tm._match_at(ni, desc, k0, k1)
        th = 0.2 * (0.5 if ni == ITS_EIMP[0] else 0.3)
        keep0, keep1 = jm._pool(score, probs, keep0, keep1, jnp.asarray(th, jnp.float32))
        k0, k1 = tm._pool(tscore, qk, k0, k1, torch.tensor([[th]]), torch.tensor([True]), lse)
        np.testing.assert_array_equal(k0.numpy(), np.asarray(keep0), err_msg=f"iteration {ni}")
        np.testing.assert_array_equal(k1.numpy(), np.asarray(keep1), err_msg=f"iteration {ni}")
        dropped = int((~k0).sum() + (~k1).sum())
    assert dropped > 0   # pooling dropped keypoints


# ------------------------------------------------------------------ the eval CLI
N_PAIRS, NUM_KPT, BUCKET = 2, N, N
# pose errors, port against impx: both decompose cv2's E in float32 with
# other SVDs, and the error's arccos magnifies 1e-7 in R near 0
# (tests/test_torch_eval.py's POSE_DEG, POSE_COS)
POSE_DEG, POSE_COS = 1e-3, 1e-6


class Args:
    max_pairs, bucket, eval_batch, pose_backend = N_PAIRS, BUCKET, 1, "cv2"
    use_iterative, use_uncertainty, data_parallel, checkpoint_backend = True, False, False, "cv2"
    ransac_hypotheses = HYP


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path = tmp_path_factory.mktemp("iterative") / "synth.hdf5"
    write_eval_hdf5(str(path), num_pairs=N_PAIRS, seed=0, n_inliers=N // 2, n_outliers0=N // 2,
                    n_outliers1=N // 2, desc_dim=SMALL["descriptor_dim"])
    with h5py.File(path, "r+") as f:
        for side in ("desc1", "desc2"):
            for ds in f[side].values():
                ds[...] = ds[()] * 16.0
    return {"rawdata_dir": str(path.parent), "dataset_dir": str(path), "num_kpt": NUM_KPT}


def _pose_errors(module, monkeypatch):
    """The pose error of every pair that module's evaluate scores."""
    errs = []
    orig = module._score_pair

    def wrapped(info, x0, x1, matches, bucket, pose_errors, *a, **k):
        orig(info, x0, x1, matches, bucket, pose_errors, *a, **k)
        errs.append(pose_errors[-1])

    monkeypatch.setattr(module, "_score_pair", wrapped)
    return errs


def test_evaluate_iterative_cv2_matches_impx(params, dataset, impx_cv2, monkeypatch):
    """evaluate with --use_iterative under cv2 checkpoints, pair by pair:
    impx's precision, matching score and mean stop iteration; its pose
    errors within POSE_DEG or POSE_COS, and its AUCs within what those
    differences allow (tests/test_torch_eval.py:_assert_auc_close). At
    VALID_ITS (checkpoints 3 and 5 here) these pairs do not converge, so
    they take the p = 0.2 fallback and the pose estimated from it."""
    import impx.eval.iterative

    compiled = impx_cv2["IMP"]

    class Compiled(JaxIterativeMatcher):
        """impx's matcher with the module's compiled layer and match programs
        (the same model, weights and shapes): no second compile."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self._encode, self._steps, self._match_at_j = compiled._encode, compiled._steps, compiled._match_at_j

    monkeypatch.setattr(impx.eval.iterative, "IterativeMatcher", Compiled)
    config = {"rescale": 640, "inlier_th": 0.005}
    want_errs = _pose_errors(jax_eval_imp, monkeypatch)
    want = jax_eval_imp.evaluate(JaxDGNNS(JaxConfig(**SMALL)), params, JaxReader(dataset), 1.0, config, Args())
    errs = _pose_errors(eval_imp, monkeypatch)
    got = eval_imp.evaluate(_port(params), StandardReader(dataset), 1.0, config, Args())
    for k in ("precision", "matching_score", "mean_stop_iteration"):
        assert got[k] == want[k], k
    assert len(errs) == len(want_errs) == N_PAIRS and np.isfinite(errs).all()
    for a, r in zip(errs, want_errs):
        assert abs(a - r) < POSE_DEG or abs(np.cos(np.deg2rad(a)) - np.cos(np.deg2rad(r))) < POSE_COS, (a, r)
    shift = sum(abs(a - r) for a, r in zip(errs, want_errs))
    for th, auc in want["auc"].items():
        assert abs(got["auc"][th] - auc) < 1e-6 + 100 * shift / (N_PAIRS * th), th


@pytest.mark.parametrize("uncertainty", [False, True], ids=["IMP", "EIMP-uncertainty"])
def test_evaluate_iterative_batched_runs(params, dataset, uncertainty):
    """The batched device-checkpoint branch (eval_batch 2): every pair scored,
    the loop's poses used, the stop iterations within the model's depth."""
    args = Args()
    args.eval_batch, args.checkpoint_backend, args.use_uncertainty = 2, "jax", uncertainty
    model = _port(params, AdaGMN if uncertainty else DGNNS)
    out = eval_imp.evaluate(model, StandardReader(dataset), 1.0, {"rescale": 640, "inlier_th": 0.005}, args)
    assert 1 <= out["mean_stop_iteration"] <= SMALL["n_layers"]
    assert all(np.isfinite(v) for v in out["auc"].values()) and out["precision"] > 0
