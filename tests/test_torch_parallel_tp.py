"""Tensor parallelism of the port (impx_torch/parallel/tp.py) on worlds of 2
and 4 CPU ranks over gloo, grids (1, 2) and (2, 2), against impx (its
forward on make_2d_mesh, the conftest's virtual CPU devices), at the bounds
of tests/test_tensor_parallel.py: the shard specs; DGNNS's forward (indices0
equal, mscores0 within 1e-5); the training step with norm_fn 'in' and 'bn'
and gradient clipping on: the first step's gradient (the global one, clipped
by the norm over the model group) against jax.grad of impx's loss, then
STEPS steps at lr 1e-3 (losses rtol 1e-4, parameters atol 2.1e-4 and each
update within 1e-2 of its norm); AdaGMN's forward (indices0 and the keep
masks equal; against impx's single-device forward, since impx's TP specs
take no shared layer and EIMP pools on shared iterations only);
--model_parallel 3 with 4 heads; the trainer's epoch at model parallelism 2
against 1, and its checkpoint in the single-device layout. Each world spawns
once for the module.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from impx.data.megadepth import SyntheticMegadepth as JaxSyntheticMegadepth
from impx.models import AdaGMN as JaxAdaGMN
from impx.models import DGNNS as JaxDGNNS
from impx.models import MatcherConfig as JaxConfig
from impx.parallel.mesh import shard_batch
from impx.parallel.tp import make_2d_mesh, shard_params_tp as jax_shard_params_tp
from impx.train import step as jax_step

import torch

from impx_torch.models import DGNNS, MatcherConfig
from impx_torch.parallel.tp import matcher_param_specs, shard_params_tp
from impx_torch.tools.convert import params_from_jax

from test_torch_kernels import _zero_grad_leaves
from test_torch_parallel_dp import one_thread
from test_torch_train_bn import random_bn
from torch_train_parity import bn_layers_zero_grad_leaves
from torch_parallel_world import run_world, trainer_epoch

SMALL = dict(descriptor_dim=32, keypoint_encoder=(16, 32), num_heads=4, sinkhorn_iterations=10, n_min_tokens=8)
GRIDS = {2: (1, 2), 4: (2, 2)}


def _batch(n, seed):
    ds = JaxSyntheticMegadepth(num_pairs=n, nfeatures=32, desc_dim=32, seed=seed)
    samples = [ds[i] for i in range(n)]
    return {k: np.stack([s[k] for s in samples]).astype(np.float32)
            for k in samples[0] if isinstance(samples[0][k], np.ndarray)}


def _pair(jax_cls, fields, seed, bn_random=False):
    jmodel = jax_cls(JaxConfig(**SMALL, **fields))
    params = jmodel.init(jax.random.PRNGKey(seed))
    if bn_random:
        params = random_bn(params)
    cfg = MatcherConfig(**SMALL, **fields)
    sd = params_from_jax(jax.tree.map(np.array, params), cfg, True)
    return jmodel, params, cfg, sd


def _impx_forward(jmodel, params, batch, grid):
    """impx's forward on make_2d_mesh(*grid), or on one device (grid None)."""
    fwd = jax.jit(lambda p, d: jmodel.produce_matches(p, d, p=0.2, only_last=True))
    if grid is None:
        out = fwd(params, {k: jnp.asarray(v) for k, v in batch.items()})
    else:
        mesh = make_2d_mesh(*grid)
        with mesh:
            out = fwd(jax_shard_params_tp(mesh, params), shard_batch(mesh, batch))
    return {k: np.asarray(out[k][-1] if isinstance(out[k], (list, tuple)) else out[k])
            for k in ("indices0", "mscores0")}


LR, STEPS = 1e-3, 3
GRAD_REL = 1e-4   # a gradient's distance from impx's, relative to its norm
# parameters after the steps, by their update from the start: the model
# group sums the merge's and the MLP's partial products in another order than
# impx, and Adam divides each element by its own gradient's size, so an
# element of small gradient carries its rounding noise into its update (up
# to 1.1e-4 at lr 1e-3 here). Each tensor's update is held to UPDATE_REL of
# its norm (1.6e-3 at most here), where a wrong gradient moves it by O(1),
# and each element to tests/test_tensor_parallel.py's 2.1e-4, a tenth of
# what a sign flip moves it by at lr 1e-3.
UPDATE_REL, PARAM_ATOL = 1e-2, 2.1e-4


def assert_updates_close(got: dict, want: dict, start: dict, zero, bound: float) -> None:
    """Each parameter within PARAM_ATOL of the reference, and its update from
    `start` within UPDATE_REL of the reference update's norm; a leaf whose
    exact gradient is 0, or whose reference does not move, within `bound`
    (2 x steps x lr: rounding noise, which Adam scales up to lr a step on
    each side)."""
    for name, p in got.items():
        w, p0 = np.asarray(want[name], np.float64), np.asarray(start[name], np.float64)
        ref = np.linalg.norm(w - p0)
        if zero.search(name) or ref == 0:
            np.testing.assert_allclose(p, w, rtol=0, atol=bound, err_msg=name)
        else:
            np.testing.assert_allclose(p, w, rtol=0, atol=PARAM_ATOL, err_msg=name)
            dist = np.linalg.norm((p - p0) - (w - p0))
            assert dist <= UPDATE_REL * ref, (name, dist / ref)


def _impx_grad(jmodel, params, batch):
    """jax.grad of impx's training loss on one device, and its global norm."""
    grads = jax.jit(jax.grad(lambda p, d: jmodel.forward_train(p, d, train=True)["loss"]))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return grads, float(jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree.leaves(grads))))


def _impx_steps(jmodel, params, batch, clip):
    """STEPS steps of impx's make_train_step on one device, clipping at
    `clip`: (losses, parameters). impx's own tests hold its tensor-parallel
    step to this one (tests/test_tensor_parallel.py)."""
    hp = jax_step.TrainHyperParams(lr=LR, decay_iter=10_000, grad_clip=clip)
    step = jax_step.make_train_step(jmodel, hp, donate=False)
    p, data = params, {k: jnp.asarray(v) for k, v in batch.items()}
    o, stats, losses = jax_step.make_optimizer(hp).init(p), jax_step.init_stats(), []
    for it in range(STEPS):
        p, o, m, stats = step(p, o, jnp.asarray(it), data, stats)
        losses.append(float(m["loss"]))
    return losses, p


TRAINER = dict(config=dict(descriptor_dim=32, keypoint_encoder=(16, 32), n_layers=2, num_heads=4, norm_fn="in",
                           sinkhorn_iterations=5),
               args=dict(lr=1e-3, network="dgnns", feature="spp", batch_size=4, epochs=1, max_keypoints=32,
                         its_per_epoch=2, log_intervals=1),
               dataset=dict(num_pairs=8, nfeatures=32, desc_dim=32))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    forward, steps, refs = {}, {}, {}
    for name, cls, fields, seed in (("dgnns", JaxDGNNS, dict(n_layers=3, norm_fn="in"), 1),
                                    ("adagmn", JaxAdaGMN, dict(n_layers=4, norm_fn="in", first_it_to_update=1), 9)):
        jmodel, params, cfg, sd = _pair(cls, fields, seed)
        if name == "adagmn":  # a larger dustbin score, so that pooling drops keypoints at random weights
            params = {**params, "bin_score": jnp.asarray(5.0, jnp.float32)}
            sd["bin_score"] = torch.tensor(5.0)
        batch = _batch(4, seed)
        forward[name] = {"config": dataclasses.asdict(cfg), "state_dict": sd, "batch": batch,
                         "cls": "AdaGMN" if name == "adagmn" else "DGNNS"}
        # impx's tensor-parallel specs take no shared layer (impx/parallel/tp.py:94 reads
        # layer['attn']), and EIMP pools on shared iterations only: AdaGMN's reference is
        # impx's single-device forward, which impx's TP forward equals where it runs
        refs[name] = {w: _impx_forward(jmodel, params, batch, None if name == "adagmn" else grid)
                      for w, grid in GRIDS.items()}
    for norm_fn, seed in (("in", 2), ("bn", 8)):
        jmodel, params, cfg, sd = _pair(JaxDGNNS, dict(n_layers=2, norm_fn=norm_fn), seed, norm_fn == "bn")
        batch = _batch(8, seed)
        # the clipping bound at half the gradient's norm, so that every step clips
        grads, norm = _impx_grad(jmodel, params, batch)
        clip = 0.5 * norm
        refs[norm_fn] = (_impx_steps(jmodel, params, batch, clip), cfg,
                         jax.tree.map(lambda g: np.asarray(g) * (clip / norm), grads))
        steps[norm_fn] = {"config": dataclasses.asdict(cfg), "state_dict": sd, "batch": batch, "n_steps": STEPS,
                          "hp": dict(lr=LR, decay_iter=10_000, grad_clip=clip)}
    trainer_sd = DGNNS(MatcherConfig(**TRAINER["config"]), device="cpu", seed=0).state_dict()
    outs = {}
    for w in GRIDS:
        root = tmp_path_factory.mktemp(f"tp{w}")
        payload = dict(forward=forward, steps=steps, trainer={**TRAINER, "state_dict": trainer_sd}, root=str(root))
        outs[w] = run_world(w, "tp", root, **payload)
    return payload, refs, outs


def test_param_specs_shard_attention_and_mlps_and_replicate_the_head():
    """Every attention weight and MLP hidden layer is sharded (q, k, v and
    proj by heads on their output channels, merge on its input channels),
    bin_score and final_proj replicated, as impx's matcher_param_specs."""
    model = DGNNS(MatcherConfig(**SMALL, n_layers=4), device="cpu")  # layers 6 and 7 share
    specs = matcher_param_specs(model)
    assert specs.keys() == model.state_dict().keys()
    for key, spec in specs.items():
        if key.endswith("weight") and (".attn." in key or ".proj." in key or ".merge." in key):
            assert spec is not None and spec[1] == "heads", key
        if ".mlp.blocks.0.weight" in key:
            assert spec == (1, "blocks"), key
        if ".mlp.blocks.1.weight" in key:
            assert spec == (0, "blocks"), key
        if key.startswith(("final_proj", "bin_score")):
            assert spec is None, key
    assert specs["gnn.0.attn.q.weight"] == (1, "heads") and specs["gnn.0.attn.merge.weight"] == (0, "heads")
    assert specs["gnn.6.proj.weight"] == (1, "heads")  # a shared layer's value projection


class _Mesh:
    def size(self, axis):
        return 3

    def index(self, axis):
        return 0

    def group(self, axis):
        raise AssertionError("no group is reached before the check")


def test_model_parallel_that_does_not_divide_the_heads_raises():
    model = DGNNS(MatcherConfig(**SMALL, n_layers=2), device="cpu")
    with pytest.raises(SystemExit, match="does not divide num_heads=4"):
        shard_params_tp(model, _Mesh())


@pytest.mark.parametrize("world", sorted(GRIDS))
@pytest.mark.parametrize("name", ["dgnns", "adagmn"])
def test_tp_forward_matches_impx(worlds, world, name):
    """indices0 equal (and mscores0 within 1e-5) on every rank, each of its
    data block; each rank ran 2 of the 4 heads."""
    _, refs, outs = worlds
    want = refs[name][world]
    n_data = GRIDS[world][0]
    for out in outs[world]:
        d = out["coords"]["data"]
        rows = slice(d * 4 // n_data, (d + 1) * 4 // n_data)
        np.testing.assert_array_equal(out[name]["indices0"], want["indices0"][rows])
        np.testing.assert_allclose(out[name]["mscores0"], want["mscores0"][rows], atol=1e-5)
        assert out["heads"] == 2
    if name == "adagmn":  # pooling dropped keypoints: the psum-med masses mattered
        assert any((~out["adagmn"]["keep0"].astype(bool)).any() for out in outs[world])


def _zero_leaves(cfg, norm_fn):
    model = DGNNS(cfg, device="cpu")
    return bn_layers_zero_grad_leaves(model) if norm_fn == "bn" else _zero_grad_leaves(model)


@pytest.mark.parametrize("world", sorted(GRIDS))
@pytest.mark.parametrize("norm_fn", ["in", "bn"])
def test_tp_train_step_gradient_matches_impx(worlds, world, norm_fn):
    """The gradient the first step applied (each parameter's .grad after it,
    gathered to the single-device layout): jax.grad of impx's loss, clipped
    to half its global norm, within GRAD_REL of each tensor's norm; a leaf
    whose exact gradient is 0 within GRAD_REL of the whole gradient's norm."""
    _, refs, outs = worlds
    _, cfg, jgrads = refs[norm_fn]
    want = params_from_jax(jgrads, cfg, True)
    zero = _zero_leaves(cfg, norm_fn)
    total = np.sqrt(sum(float((w.numpy().astype(np.float64) ** 2).sum()) for w in want.values()))
    for out in outs[world]:
        grads = out[norm_fn]["grads"]
        assert grads.keys() == {n for n, _ in DGNNS(cfg, device="cpu").named_parameters()}
        for name, g in grads.items():
            w = want[name].numpy().astype(np.float64)
            scale = total if zero.search(name) else np.linalg.norm(w)
            assert np.linalg.norm(g - w) <= GRAD_REL * scale, (name, np.linalg.norm(g - w), scale)


@pytest.mark.parametrize("world", sorted(GRIDS))
@pytest.mark.parametrize("norm_fn", ["in", "bn"])
def test_tp_train_step_matches_impx(worlds, world, norm_fn):
    """STEPS steps at lr 1e-3 with clipping against impx's: the losses
    within rtol 1e-4, every parameter (gathered to the single-device
    layout) by assert_updates_close; the ranks held half of q's output
    channels."""
    payload, refs, outs = worlds
    (jlosses, jparams), cfg, _ = refs[norm_fn]
    want = {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.array, jparams), cfg, True).items()}
    start = {k: v.numpy() for k, v in payload["steps"][norm_fn]["state_dict"].items()}
    zero = _zero_leaves(cfg, norm_fn)
    for out in outs[world]:
        got = out[norm_fn]
        np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-4)
        assert_updates_close(got["params"], want, start, zero, 2 * STEPS * LR)
        assert got["shapes"]["gnn.0.attn.q.weight"] == (32, 16)


def test_trainer_epoch_at_model_parallel_2_equals_1(worlds, tmp_path):
    """Trainer(model_parallel=2) at world 2: the epoch loss of the
    one-process trainer (rtol 1e-4, impx's bound), the same parameters after
    the epoch's 2 steps at lr 1e-3 (assert_updates_close), and a checkpoint
    in the single-device layout that a one-process model loads."""
    payload, _, outs = worlds
    with one_thread():
        loss1, params1 = trainer_epoch(payload, tmp_path)
    model = DGNNS(MatcherConfig(**TRAINER["config"]), device="cpu")
    start = {k: v.numpy() for k, v in payload["trainer"]["state_dict"].items()}
    for out in outs[2]:
        t = out["trainer"]
        assert t["shape"] == (32, 16)
        np.testing.assert_allclose(t["loss"], loss1, rtol=1e-4)
        assert_updates_close(t["params"], params1, start, _zero_grad_leaves(model), 2 * 2 * TRAINER["args"]["lr"])
    ckpt = torch.load(outs[2][0]["trainer"]["checkpoint"], weights_only=True)
    model.load_state_dict(ckpt["params"])
    for name, p in model.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), outs[2][0]["trainer"]["params"][name], err_msg=name)
    assert ckpt["opt_state"]["mu"]["gnn.0.attn.q.weight"].shape == (32, 32)
