"""Sequence parallelism of the port (impx_torch/parallel/tp.py:shard_batch_sp,
impx_torch/parallel/mesh.py:set_seq_group) on worlds of 2 and 4 CPU ranks over
gloo, grids (1, 2), (2, 2) and (1, 4): DGNNS's forward against impx's
single-device forward (impx's own test holds its sequence-parallel forward to
that one, tests/test_tensor_parallel.py:113-133: indices0 equal, mscores0
within 1e-5); the training step at (1, 2) and (2, 2), its loss against
impx's (rtol 1e-4) and the gradient it applied against one process of the
port (cosines, global norm); the same step with the score head's gradient
counted s times, which must miss those bounds; GM's unrolled path (batch norm)
and AdaGMN's mask-only pooling at (1, 2) against one process; the refusals.
Each world spawns once for the module.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from impx.data.megadepth import SyntheticMegadepth as JaxSyntheticMegadepth
from impx.models import DGNNS as JaxDGNNS
from impx.models import MatcherConfig as JaxConfig

import torch

from impx_torch.models import AdaGMN, DGNNS, MatcherConfig
from impx_torch.parallel.tp import _SEQ_KEYS, shard_batch_sp
from impx_torch.tools.convert import params_from_jax
from impx_torch.train.step import TrainHyperParams, init_opt_state, init_stats, make_train_step

from test_torch_kernels import _zero_grad_leaves
from test_torch_parallel_dp import one_thread
from torch_train_parity import bn_layers_zero_grad_leaves
from torch_parallel_world import run_world

SMALL = dict(descriptor_dim=32, keypoint_encoder=(16, 32), num_heads=4, sinkhorn_iterations=10, n_min_tokens=8)
N_KPT = 32
COS_MIN, GNORM_RTOL, LOSS_RTOL = 0.9999990, 1e-6, 1e-4
HP = dict(lr=1e-3, decay_iter=10_000)


def _batch(n, seed):
    """n synthetic MegaDepth pairs of N_KPT keypoints; in pair 1 the last 5
    keypoints of image 0 and in pair n - 1 the last 3 of image 1 are padding
    (invalid, unsupervised), so that key and query masks differ by rank."""
    ds = JaxSyntheticMegadepth(num_pairs=n, nfeatures=N_KPT, desc_dim=32, seed=seed)
    samples = [ds[i] for i in range(n)]
    out = {k: np.stack([s[k] for s in samples]).astype(np.float32)
           for k in samples[0] if isinstance(samples[0][k], np.ndarray)}
    out["valid0"] = np.ones((n, N_KPT), bool)
    out["valid1"] = np.ones((n, N_KPT), bool)
    out["valid0"][1, -5:] = False
    out["valid1"][n - 1, -3:] = False
    out["matching_mask"][1, N_KPT - 5:N_KPT, :] = 0
    out["matching_mask"][n - 1, :, N_KPT - 3:N_KPT] = 0
    return out


def _case(cls, fields, seed, grids, bin_score=None):
    jmodel = JaxDGNNS(JaxConfig(**SMALL, **fields))
    params = jmodel.init(jax.random.PRNGKey(seed))
    if bin_score is not None:  # pooling drops keypoints at random weights
        params = {**params, "bin_score": jnp.asarray(bin_score, jnp.float32)}
    cfg = MatcherConfig(**SMALL, **fields)
    sd = params_from_jax(jax.tree.map(np.array, params), cfg, True)
    case = {"config": dataclasses.asdict(cfg), "state_dict": sd, "batch": _batch(4, seed), "cls": cls,
            "grids": grids, "hp": HP}
    return case, jmodel, params


def _port(case):
    model = {"DGNNS": DGNNS, "AdaGMN": AdaGMN}[case["cls"]](MatcherConfig(**case["config"]), device="cpu")
    model.load_state_dict(case["state_dict"])
    return model


def _one_process(case):
    """One process of the port on one thread, as the ranks run: the forward's
    outputs and one step's loss and applied gradient."""
    with one_thread():
        out = _port(case).produce_matches(case["batch"], p=0.2, only_last=True)
        fwd = {k: out[k][-1].numpy() for k in ("indices0", "mscores0")}
        fwd.update({k: out[k].numpy() for k in ("keep0", "keep1") if k in out})
        model = _port(case)
        metrics, _ = make_train_step(model, TrainHyperParams(**HP))(init_opt_state(model), 0, case["batch"],
                                                                      init_stats("cpu"))
        grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
                 for n, p in model.named_parameters()}
    return fwd, float(metrics["loss"]), grads


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    dgnns, jmodel, params = _case("DGNNS", dict(n_layers=3, norm_fn="in"), 1, ((1, 2), (2, 2), (1, 4)))
    bn, _, _ = _case("DGNNS", dict(n_layers=2, norm_fn="bn"), 8, ((1, 2),))
    adagmn, _, _ = _case("AdaGMN", dict(n_layers=4, norm_fn="in", first_it_to_update=1), 9, ((1, 2),),
                         bin_score=5.0)
    step_in = {**dgnns, "grids": ((1, 2), (2, 2))}
    payload = {"forward": {"dgnns": dgnns, "bn": bn, "adagmn": adagmn},
               "steps": {"in": step_in, "bn": bn}}
    feed = {k: jnp.asarray(v) for k, v in dgnns["batch"].items()}
    out = jax.jit(lambda p, d: jmodel.produce_matches(p, d, p=0.2, only_last=True))(params, feed)
    impx = {k: np.asarray(out[k][-1]) for k in ("indices0", "mscores0")}
    impx["loss"] = float(jax.jit(lambda p, d: jmodel.forward_train(p, d, train=True)["loss"])(params, feed))
    refs = {name: _one_process(case) for name, case in (("dgnns", dgnns), ("bn", bn), ("adagmn", adagmn))}
    outs = {}
    for w in (2, 4):
        root = tmp_path_factory.mktemp(f"sp{w}")
        for rank in run_world(w, "sp", root, **payload):
            for grid, res in rank.items():
                outs.setdefault(grid, []).append(res)
    return payload, impx, refs, outs


def _rows(res, grid):
    """The batch rows of this rank's data block."""
    d, n = res["coords"]["data"], grid[0]
    return slice(d * 4 // n, (d + 1) * 4 // n)


@pytest.mark.parametrize("grid", [(1, 2), (2, 2), (1, 4)], ids=str)
def test_sp_forward_matches_impx_single_device(worlds, grid):
    """DGNNS at fp32: every rank returns the full outputs of its data block,
    indices0 equal to impx's single-device forward on every row and
    mscores0 within 1e-5."""
    _, impx, _, outs = worlds
    assert len(outs[grid]) == grid[0] * grid[1]
    for res in outs[grid]:
        rows = _rows(res, grid)
        assert res["dgnns"]["indices0"].shape == (4 // grid[0], N_KPT)
        np.testing.assert_array_equal(res["dgnns"]["indices0"], impx["indices0"][rows])
        np.testing.assert_allclose(res["dgnns"]["mscores0"], impx["mscores0"][rows], rtol=0, atol=1e-5)


def _grad_check(grads, want, zero):
    """(smallest cosine over the leaves whose exact gradient is not 0, the
    global norm's relative difference)."""
    cos = min(float(np.dot(g.ravel().astype(np.float64), want[n].ravel())
                    / (np.linalg.norm(g) * np.linalg.norm(want[n])))
              for n, g in grads.items() if not zero.search(n) and np.abs(want[n]).max() > 0)
    norm = lambda gs: np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in gs.values()))
    return cos, abs(norm(grads) - norm(want)) / norm(want)


@pytest.mark.parametrize("grid", [(1, 2), (2, 2)], ids=str)
def test_sp_train_step(worlds, grid):
    """The step's global loss within 1e-4 of impx's on one device, and the
    gradient it applied (summed over data and sequence ranks, the replicated
    head's counted once) against one process of the port: cosines at least
    COS_MIN, global norm within GNORM_RTOL."""
    payload, impx, refs, outs = worlds
    _, loss1, grads1 = refs["dgnns"]
    zero = _zero_grad_leaves(_port(payload["steps"]["in"]))
    for res in outs[grid]:
        got = res["step_in"]
        np.testing.assert_allclose(got["loss"], impx["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["loss"], loss1, rtol=1e-6)
        cos, norm_rel = _grad_check(got["grads"], grads1, zero)
        assert cos >= COS_MIN and norm_rel <= GNORM_RTOL, (cos, norm_rel)


@pytest.mark.parametrize("how", ["gather", "bin"])
def test_counting_the_replicated_head_s_times_fails(worlds, how):
    """The same step at (1, 2) with the score head's gradient counted on both
    ranks: the head's row gather summing its cotangent on the way back
    ('gather'), or the bin score's gradient kept on every rank ('bin').
    Either misses the global-norm bound; 'bin' doubles that leaf."""
    payload, _, refs, outs = worlds
    _, _, grads1 = refs["dgnns"]
    zero = _zero_grad_leaves(_port(payload["steps"]["in"]))
    for res in outs[(1, 2)]:
        cos, norm_rel = _grad_check(res[f"miscount_{how}"]["grads"], grads1, zero)
        assert not (cos >= COS_MIN and norm_rel <= GNORM_RTOL), (how, cos, norm_rel)
        if how == "bin":
            np.testing.assert_allclose(res["miscount_bin"]["grads"]["bin_score"], 2 * grads1["bin_score"],
                                       rtol=1e-5)


def test_sp_batch_norm_through_gm_unrolled(worlds):
    """norm_fn='bn' (GM's unrolled forward; in training the keypoint
    encoder's batch statistics over the union of the sequence blocks) at
    (1, 2) against one process: indices0 equal, mscores0 within 1e-5, the
    step's loss and gradient as above."""
    payload, _, refs, outs = worlds
    fwd1, loss1, grads1 = refs["bn"]
    zero = bn_layers_zero_grad_leaves(_port(payload["steps"]["bn"]))
    for res in outs[(1, 2)]:
        np.testing.assert_array_equal(res["bn"]["indices0"], fwd1["indices0"])
        np.testing.assert_allclose(res["bn"]["mscores0"], fwd1["mscores0"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(res["step_bn"]["loss"], loss1, rtol=1e-6)
        cos, norm_rel = _grad_check(res["step_bn"]["grads"], grads1, zero)
        assert cos >= COS_MIN and norm_rel <= GNORM_RTOL, (cos, norm_rel)


def test_sp_adagmn_mask_only_keeps(worlds):
    """AdaGMN mask-only at (1, 2): the partial key masses summed over the
    sequence group give the keep masks of one process, and pooling dropped
    keypoints."""
    _, _, refs, outs = worlds
    fwd1 = refs["adagmn"][0]
    assert (~fwd1["keep0"]).any() or (~fwd1["keep1"]).any()
    for res in outs[(1, 2)]:
        np.testing.assert_array_equal(res["adagmn"]["keep0"], fwd1["keep0"])
        np.testing.assert_array_equal(res["adagmn"]["keep1"], fwd1["keep1"])
        np.testing.assert_array_equal(res["adagmn"]["indices0"], fwd1["indices0"])


class _Grid:
    def __init__(self, n_seq):
        self.n_seq = n_seq

    def size(self, axis):
        return self.n_seq if axis == "model" else 1

    def index(self, axis):
        return self.n_seq - 1 if axis == "model" else 0


def test_shard_batch_sp_blocks_and_refusals():
    """The last of 4 sequence blocks of the keypoint arrays, the masks and
    matching_mask whole; 3 sequence ranks do not divide 32 keypoints."""
    batch = _batch(2, 3)
    mine = shard_batch_sp(_Grid(4), batch)
    for key, x in batch.items():
        if key in _SEQ_KEYS:
            np.testing.assert_array_equal(mine[key], x[:, 24:32])
        else:
            np.testing.assert_array_equal(mine[key], x)
    assert mine["matching_mask"].shape == (2, N_KPT + 1, N_KPT + 1)
    with pytest.raises(ValueError, match="do not split over a sequence size of 3"):
        shard_batch_sp(_Grid(3), batch)
