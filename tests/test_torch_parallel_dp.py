"""Data parallelism of the port on a world of 2 CPU ranks over gloo: the
data-parallel training step (impx_torch/train/step.py with the model's data
group) against impx's sharded make_train_step on a 2-device mesh, with
norm_fn 'in' and 'bn', on a batch whose two halves hold different numbers of
valid keypoints and ground-truth matches (so the loss's global counts and
the global batch-norm moments matter); the trainer's epoch at world 2
against world 1; an indivisible batch; eval --data_parallel at world 2
against world 1. The world spawns once for the module; impx runs here under
jax.jit on the conftest's virtual CPU devices.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from impx.models import DGNNS as JaxDGNNS
from impx.parallel.mesh import make_mesh, replicate, shard_batch
from impx.train import step as jax_step

from impx_torch.models import DGNNS as DGNNS_T
from impx_torch.models import MatcherConfig
from impx_torch.tools.convert import params_from_jax

from test_torch_kernels import _zero_grad_leaves
from test_torch_train_bn import BN, XLA, random_bn
from torch_parallel_world import SyntheticReader, run_eval, run_world, trainer_epoch
from torch_train_parity import bn_layers_zero_grad_leaves, pair

WORLD, B, N = 2, 4, 48
LR, STEPS = 1e-3, 3
# pairs 0, 1 on rank 0 and 2, 3 on rank 1: valid keypoints, and the share of
# image 1's valid slots that copy an image-0 keypoint (1.0: every keypoint
# matched, so rank 1 holds no pair with an unmatched keypoint, and its own
# loss would drop the dustbin term that the global batch's keeps)
N_VALID = (41, 46, 30, 48)
COPY_FRAC = (0.5, 0.3, 1.0, 1.0)


def dp_batch(rs, d=32):
    """B pairs in tests/test_torch_train.py:train_batch's layout, each with
    its own valid count and copy share."""
    d0 = rs.randn(B, N, d).astype(np.float32)
    k0 = (rs.rand(B, N, 2) - 0.5).astype(np.float32)
    s0 = rs.rand(B, N).astype(np.float32)
    valid = np.arange(N)[None] < np.array(N_VALID)[:, None]
    d1, k1, s1 = d0.copy(), k0.copy(), s0.copy()
    gt = np.zeros((B, N + 1, N + 1), np.float32)
    for i, (nv, frac) in enumerate(zip(N_VALID, COPY_FRAC)):
        perm = rs.permutation(nv)
        copy = rs.rand(nv) < frac if frac < 1 else np.ones(nv, bool)
        d1[i, :nv] = np.where(copy[:, None], d0[i, perm] + 0.05 * rs.randn(nv, d), rs.randn(nv, d))
        k1[i, :nv] = np.where(copy[:, None], k0[i, perm], rs.rand(nv, 2) - 0.5)
        s1[i, :nv] = np.where(copy, s0[i, perm], rs.rand(nv))
        gt[i, perm[copy], np.flatnonzero(copy)] = 1
        gt[i, N, np.flatnonzero(~copy)] = 1
        gt[i, np.setdiff1d(np.arange(nv), perm[copy]), N] = 1
    return {"descriptors0": d0, "descriptors1": d1.astype(np.float32), "norm_keypoints0": k0,
            "norm_keypoints1": k1.astype(np.float32), "scores0": s0, "scores1": s1.astype(np.float32),
            "valid0": valid, "valid1": valid.copy(), "matching_mask": gt}


def _models(norm_fn):
    if norm_fn == "bn":
        jmodel, params, tmodel, tcfg = pair(JaxDGNNS, DGNNS_T, XLA, **{**BN, "n_layers": 2})
        params = random_bn(params)
        tmodel.load_state_dict(params_from_jax(jax.tree.map(np.array, params), tcfg, tmodel.sharing))
    else:
        jmodel, params, tmodel, tcfg = pair(JaxDGNNS, DGNNS_T, XLA, n_layers=2, norm_fn="in")
    return jmodel, params, tmodel, tcfg


@contextlib.contextmanager
def one_thread():
    """torch on one thread, as the ranks run it: a matmul's summation order
    follows the thread count."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _impx_sharded_steps(jmodel, params, batch):
    """impx's make_train_step, STEPS steps, over a 2-device data mesh."""
    hp = jax_step.TrainHyperParams(lr=LR, decay_iter=10_000)
    step = jax_step.make_train_step(jmodel, hp, donate=False)
    opt = jax_step.make_optimizer(hp).init(params)
    mesh = make_mesh(jax.devices()[:WORLD])
    losses = []
    with mesh:
        p, o = replicate(mesh, params), replicate(mesh, opt)
        sharded = shard_batch(mesh, batch)
        stats = jax_step.init_stats()
        for it in range(STEPS):
            p, o, m, stats = step(p, o, jnp.asarray(it), sharded, stats)
            losses.append(float(m["loss"]))
    return losses, p


TRAINER = dict(config=dict(descriptor_dim=32, keypoint_encoder=(16, 32), n_layers=2, num_heads=4, norm_fn="in",
                           sinkhorn_iterations=5),
               args=dict(lr=1e-4, network="dgnns", feature="spp", batch_size=4, epochs=1, max_keypoints=32,
                         its_per_epoch=2, log_intervals=1),
               dataset=dict(num_pairs=8, nfeatures=32, desc_dim=32))
EVAL = dict(config=dict(descriptor_dim=32, keypoint_encoder=(16, 32), n_layers=4, num_heads=4, norm_fn="in",
                        sinkhorn_iterations=10),
            reader=dict(n_pairs=6, num_kpt=96, seed=3))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    torch.manual_seed(0)
    batch = dp_batch(np.random.RandomState(0))
    steps, refs = {}, {}
    for norm_fn in ("in", "bn"):
        jmodel, params, tmodel, tcfg = _models(norm_fn)
        steps[norm_fn] = {"config": dataclasses.asdict(tcfg), "state_dict": tmodel.state_dict(), "batch": batch,
                          "hp": dict(lr=LR, decay_iter=10_000), "n_steps": STEPS}
        refs[norm_fn] = (_impx_sharded_steps(jmodel, params, batch), tcfg, tmodel)
    trainer_sd = DGNNS_T(MatcherConfig(**TRAINER["config"]), device="cpu", seed=0).state_dict()
    eval_sd = DGNNS_T(MatcherConfig(**EVAL["config"]), device="cpu", seed=1).state_dict()
    workdir = tmp_path_factory.mktemp("dp")
    payload = dict(steps=steps, trainer={**TRAINER, "state_dict": trainer_sd},
                   eval={**EVAL, "state_dict": eval_sd}, root=str(workdir))
    outs = run_world(WORLD, "dp", workdir, **payload)
    return payload, refs, outs, batch


@pytest.mark.parametrize("norm_fn", ["in", "bn"])
def test_data_parallel_step_matches_impx_sharded_step(setup, norm_fn):
    """STEPS steps at lr 1e-3 against impx's sharded step (the bounds of
    tests/test_torch_train.py's step parity): the global loss within rtol
    1e-5 on both ranks, every parameter within 3e-5 (a leaf whose exact
    gradient is 0 follows rounding noise, which Adam scales up to lr a step
    on each side: within 2 x 3 lr), the ranks' parameters equal."""
    payload, refs, outs, _ = setup
    (jlosses, jparams), tcfg, tmodel = refs[norm_fn]
    want = params_from_jax(jax.tree.map(np.array, jparams), tcfg, tmodel.sharing)
    zero = (bn_layers_zero_grad_leaves(tmodel) if norm_fn == "bn" else _zero_grad_leaves(tmodel))
    for out in outs:
        got = out[norm_fn]
        np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
        assert got["count"] == STEPS
        for name, p in got["params"].items():
            atol = 2 * 3 * LR if zero.search(name) else 3e-5
            np.testing.assert_allclose(p, want[name].numpy(), rtol=0, atol=atol, err_msg=name)
    for name, p in outs[0][norm_fn]["params"].items():
        np.testing.assert_array_equal(p, outs[1][norm_fn]["params"][name], err_msg=name)


def test_naive_per_rank_mean_differs_from_the_global_loss(setup):
    """The teeth of the step test: the mean of the two halves' own losses is
    not the global batch's loss (the halves count different pairs with
    unmatched keypoints), which the shares from the global counts sum to."""
    _, refs, outs, batch = setup
    _, tcfg, tmodel = refs["in"]
    model = DGNNS_T(tcfg, device="cpu")
    model.load_state_dict(tmodel.state_dict())
    with torch.no_grad():
        whole = model.forward_train(batch)["loss"].item()
        halves = [model.forward_train({k: v[i * 2:(i + 1) * 2] for k, v in batch.items()})["loss"].item()
                  for i in range(WORLD)]
    gt = torch.from_numpy(batch["matching_mask"])
    m1 = [(gt[i * 2:(i + 1) * 2, :, -1].sum(1) > 0).sum().item() for i in range(WORLD)]
    assert m1 == [2, 0]
    assert abs(np.mean(halves) - whole) > 1e-3 * abs(whole)
    # the first step's global loss is the whole batch's
    impx_first = refs["in"][0][0][0]
    np.testing.assert_allclose(whole, impx_first, rtol=1e-5)


def test_trainer_epoch_at_world_2_equals_world_1(setup, tmp_path):
    """The Trainer at world 2 (each rank assembles its 2 rows of each global
    batch of 4) gives the one-process epoch loss (rtol 1e-5) and parameters
    after its 2 steps at lr 1e-4 (3e-6; a leaf whose exact gradient is 0
    follows rounding noise, which Adam scales up to lr a step on each side:
    within 2 x 2 lr)."""
    payload, _, outs, _ = setup
    with one_thread():
        loss1, params1 = trainer_epoch(payload, tmp_path)
    zero = _zero_grad_leaves(DGNNS_T(MatcherConfig(**TRAINER["config"]), device="cpu"))
    lr = TRAINER["args"]["lr"]
    for out in outs:
        loss2, params2 = out["trainer"]
        np.testing.assert_allclose(loss2, loss1, rtol=1e-5)
        for name, p in params1.items():
            atol = 2 * 2 * lr if zero.search(name) else 3e-6
            np.testing.assert_allclose(params2[name], p, rtol=0, atol=atol, err_msg=name)


def test_indivisible_batch_raises_system_exit(setup):
    _, _, outs, _ = setup
    for out in outs:
        assert out["indivisible"] is not None and "divisible" in out["indivisible"]


@pytest.mark.parametrize("key,kw", [("eval", {}), ("eval_iterative", {"use_iterative": True})],
                         ids=["batched", "iterative"])
def test_eval_data_parallel_returns_the_world_1_results(setup, key, kw):
    """evaluate --data_parallel at world 2, --eval_batch 4 (each rank runs its
    2 pairs of each batch through the matcher or the iterative loop, whose
    all-converged test is all-reduced; rank 0 scores the gathered outputs)
    returns, on every rank, the results dict of the world-1 run (timings
    aside). The world-1 run uses one thread, as the ranks do: the pose
    solve's float sums follow the thread count, and the AUC moves in the
    fourth digit between 1 and many threads."""
    payload, _, outs, _ = setup
    with one_thread():
        want = run_eval(payload, data_parallel=True, **kw)
    assert len(SyntheticReader(**payload["eval"]["reader"])) == 6
    for out in outs:
        assert out[key] == want
