"""Batch norm in train mode against impx on the CPU: batch_norm_train and
the MLP on batch statistics, GM's, DGNNS's and SuperGlue's training forward
under norm_fn='bn' (the keypoint encoder on each image's batch statistics,
the layers on the running statistics, which then take their gradient), three
make_train_step steps that move the running statistics by Adam as impx's
optax does, and the layout of those statistics as parameters.

Small config: D = 32, keypoint_encoder (16, 32), 4 heads, 4 layers (DGNNS's
iteration 3 shares attention; 2 for GM, SuperGlue and the steps, whose jit
programs impx compiles a layer at a time), 10 Sinkhorn iterations, B = 2, N = 48 with 7 and 2 padded keypoints, random
running statistics. impx runs under jax.jit on attn_impl='xla' (its GM,
DGNNS and SuperGlue train through GM's unrolled forward under 'bn'). Torch
runs on one thread.

Tolerances, fp32: batch_norm_train's y, mean and var rtol 1e-5 atol 1e-6;
loss, its terms and the accuracy counters rtol 1e-5; matches0 exact; each
gradient leaf rtol 2e-3 atol 1e-5, the leaves whose exact gradient is 0
within 1e-5 of the largest leaf's norm (tests/torch_train_parity.py); the
steps as tests/test_torch_train.py holds them, a leaf whose exact gradient
is 0 within 2 x 3 lr.
"""
import argparse

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from impx.models import DGNNS as JaxDGNNS
from impx.models import GM as JaxGM
from impx.models import MatcherConfig as JaxConfig
from impx.models.superglue import SuperGlue as JaxSuperGlue
from impx.ops import norms as jax_norms
from impx.ops.mlp import mlp_apply as jax_mlp_apply
from impx.ops.mlp import mlp_init
from impx.train import step as jax_step

from impx_torch.data.megadepth import SyntheticMegadepth
from impx_torch.models import DGNNS, MatcherConfig, SuperGlue
from impx_torch.models.gm import GM
from impx_torch.models.gnn import MLP
from impx_torch.ops import norms
from impx_torch.ops.mlp import mlp_apply
from impx_torch.tools.convert import load_reference_state_dict, params_from_jax
from impx_torch.train.step import TrainHyperParams, init_opt_state, init_stats, make_train_step
from impx_torch.train.trainer import Trainer

from test_torch_train import train_batch
from torch_train_parity import SMALL, bn_layers_zero_grad_leaves, check_train, pair

BN = dict(n_layers=4, norm_fn="bn")
XLA = dict(attn_impl="xla")
BN_STATS = ("bn_scale", "bn_bias", "bn_mean", "bn_var")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops dominate: one thread, as tests/test_torch_logot.py runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def batch():
    return train_batch(np.random.RandomState(0))


def random_bn(params, seed: int = 0):
    """impx params with every batch-norm block's scale, bias and running
    statistics drawn at random (a trained model's are not 1, 0, 0, 1)."""
    rs = np.random.RandomState(seed)

    def blocks(mlp):
        out = []
        for blk in mlp:
            if "bn_mean" in blk:
                c = blk["bn_mean"].shape[0]
                blk = {**blk, "bn_scale": rs.uniform(0.5, 1.5, c), "bn_bias": rs.uniform(-0.3, 0.3, c),
                       "bn_mean": rs.randn(c) * 0.3, "bn_var": rs.uniform(0.3, 2.0, c)}
            out.append({k: jnp.asarray(v, jnp.float32) for k, v in blk.items()})
        return out

    return {**params, "kenc": blocks(params["kenc"]),
            "gnn": [{**layer, "mlp": blocks(layer["mlp"])} for layer in params["gnn"]]}


def bn_pair(jax_cls, torch_cls, **fields):
    """`pair` with random batch-norm statistics loaded into both models."""
    jmodel, params, tmodel, tcfg = pair(jax_cls, torch_cls, XLA, **{**BN, **fields})
    params = random_bn(params)
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.array, params), tcfg, tmodel.sharing))
    return jmodel, params, tmodel, tcfg


# ------------------------------------------------------------------ the norm
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_batch_norm_train_matches_impx(masked):
    """y, the batch mean and the batch variance (E[x^2] - E[x]^2, as impx)
    over (B, N) per channel, under the token mask or not."""
    rs = np.random.RandomState(2)
    x = (rs.randn(3, 40, 16) * 2 + 0.5).astype(np.float32)
    scale, bias = rs.randn(16).astype(np.float32), rs.randn(16).astype(np.float32)
    mask = (np.arange(40)[None] < np.array([40, 31, 7])[:, None]) if masked else None
    ref = jax_norms.batch_norm_train(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                     None if mask is None else jnp.asarray(mask))
    out = norms.batch_norm_train(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
                                 None if mask is None else torch.from_numpy(mask))
    for name, a, r in zip(("y", "mean", "var"), out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6, err_msg=name)


def test_mlp_on_batch_statistics_matches_impx():
    """mlp_apply(batch_stats=True) and the MLP module against impx's
    mlp_apply(norm_fn='bn', train=True) under a token mask, and the module
    from running statistics in either nn.Module mode against train=False:
    each call names its statistics."""
    rs = np.random.RandomState(1)
    channels = [3, 32, 64, 64]
    blocks = random_bn({"kenc": mlp_init(jax.random.PRNGKey(0), channels, norm_fn="bn"), "gnn": []})["kenc"]
    blocks = [{k: np.array(v) for k, v in blk.items()} for blk in blocks]
    x = rs.randn(2, 50, 3).astype(np.float32)
    mask = np.arange(50)[None] < np.array([50, 41])[:, None]
    module = MLP(channels, norm_fn="bn")
    with torch.no_grad():
        for i, blk in enumerate(blocks):
            module.blocks[i].weight.copy_(torch.from_numpy(blk["w"]))
            module.blocks[i].bias.copy_(torch.from_numpy(blk["b"]))
            for k in BN_STATS if i < len(blocks) - 1 else ():
                getattr(module.norms[i], k).copy_(torch.from_numpy(blk[k]))
    for train in (True, False):
        ref, _ = jax_mlp_apply([{k: jnp.asarray(v) for k, v in blk.items()} for blk in blocks], jnp.asarray(x),
                               norm_fn="bn", ac_fn="relu", mask=jnp.asarray(mask), train=train)
        bns = [tuple(torch.from_numpy(blk[k]) for k in BN_STATS) for blk in blocks[:-1]]
        out = mlp_apply([(torch.from_numpy(b["w"]), torch.from_numpy(b["b"])) for b in blocks], torch.from_numpy(x),
                        ac_fn="relu", mask=torch.from_numpy(mask), batch_norms=bns, batch_stats=train)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        for mode in (module.train(), module.eval()):
            got = mode(torch.from_numpy(x), ac_fn="relu", mask=torch.from_numpy(mask), batch_stats=train)
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ the training forwards
@pytest.mark.parametrize("network", ["gm", "dgnns"])
def test_forward_train_under_batch_norm_matches_impx(batch, network):
    """GM's and DGNNS's training forward under norm_fn='bn' against impx's
    (GM.forward_train for both): loss, its terms, matches0, accuracy and
    every gradient leaf, bn_mean and bn_var included. The encoder's running
    statistics take no gradient (it normalises from the batch), the layers'
    do (they normalise from them)."""
    classes = {"gm": (JaxGM, GM), "dgnns": (JaxDGNNS, DGNNS)}[network]
    jmodel, params, tmodel, tcfg = bn_pair(*classes, n_layers=4 if network == "dgnns" else 2)
    check_train(jmodel, params, tmodel, tcfg, batch, bn_layers_zero_grad_leaves(tmodel))
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    assert grads["kenc.norms.0.bn_var"] is None and grads["kenc.norms.0.bn_mean"] is None
    assert grads["gnn.0.mlp.norms.0.bn_var"].abs().sum() > 0
    assert grads["gnn.0.mlp.norms.0.bn_mean"].abs().sum() > 0


def test_superglue_training_matches_impx(batch):
    """SuperGlue's training forward (GM's, with the shared final projection
    and the log-domain head: LogOTFused, kernel 7's plain version here)
    against impx's SuperGlue.forward_train, loss and every gradient leaf."""
    jmodel, params, tmodel, tcfg = bn_pair(JaxSuperGlue, SuperGlue, n_layers=2)
    assert len(tmodel.final_proj) == 1
    out, _ = check_train(jmodel, params, tmodel, tcfg, batch, bn_layers_zero_grad_leaves(tmodel))
    assert (out["matches0"] >= 0).sum() > 0


@pytest.mark.parametrize("optim", ["adam", "adamw"])
def test_three_steps_move_the_running_statistics_as_impx(batch, optim):
    """Three make_train_step steps of DGNNS under norm_fn='bn' against
    impx's at lr 1e-3: the losses within rtol 1e-5, every parameter within
    3e-5 (bn_mean and bn_var included: Adam moves them by their gradient,
    and adamw decays them too), both moments within 1e-4 relative L2 a leaf. The encoder's
    running statistics move only under adamw's decay. A leaf whose exact
    gradient is 0 follows rounding noise, which Adam scales up to lr a step
    on each side, in either direction: within 2 x 3 lr."""
    lr = 1e-3
    kw = dict(lr=lr, decay_iter=10_000, optim=optim)
    jmodel, params, tmodel, tcfg = bn_pair(JaxDGNNS, DGNNS, n_layers=2)
    jstep = jax_step.make_train_step(jmodel, jax_step.TrainHyperParams(**kw), donate=False)
    jopt = jax_step.make_optimizer(jax_step.TrainHyperParams(**kw)).init(params)
    step = make_train_step(tmodel, TrainHyperParams(**kw))
    opt = init_opt_state(tmodel)
    assert {"gnn.0.mlp.norms.0.bn_mean", "gnn.0.mlp.norms.0.bn_var"} <= opt["mu"].keys()
    start = {k: v.clone() for k, v in tmodel.state_dict().items()}
    jdata = {k: jnp.asarray(v) for k, v in batch.items()}
    stats, jstats = init_stats("cpu"), jax_step.init_stats()
    for it in range(3):
        params, jopt, jm, jstats = jstep(params, jopt, jnp.asarray(it), jdata, jstats)
        m, stats = step(opt, it, batch, stats)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.array, params), tcfg)
    zero = bn_layers_zero_grad_leaves(tmodel)
    for name, p in tmodel.state_dict().items():
        atol = 2 * 3 * lr if zero.search(name) else 3e-5
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=atol, err_msg=name)
    moved = lambda name: not torch.equal(tmodel.state_dict()[name], start[name])  # noqa: E731
    assert moved("gnn.0.mlp.norms.0.bn_mean") and moved("gnn.0.mlp.norms.0.bn_var")
    assert moved("kenc.norms.0.bn_var") == (optim == "adamw")
    adam = next(s for s in jopt if hasattr(s, "mu"))
    for key, tree in (("mu", adam.mu), ("nu", adam.nu)):
        ref = params_from_jax(jax.tree.map(np.array, tree), tcfg)
        for name, x in opt[key].items():
            if not zero.search(name):
                r = ref[name].numpy()
                assert np.linalg.norm(x.numpy() - r) <= 1e-4 * np.linalg.norm(r) + 1e-12, (key, name)


# ------------------------------------------------------------------ the layout
def _reference_layout(sd: dict, cfg) -> dict:
    """The port's state_dict in the reference PyTorch layout (Conv1d weights
    [out, in, 1]; a BatchNorm1d one index after its conv), for
    load_reference_state_dict."""
    out = {"bin_score": sd["bin_score"]}

    def mlp(dst, src, n_convs):
        for i in range(n_convs):
            out[f"{dst}.{3 * i}.weight"] = sd[f"{src}.blocks.{i}.weight"].T[:, :, None]
            out[f"{dst}.{3 * i}.bias"] = sd[f"{src}.blocks.{i}.bias"]
            for leaf, ref in zip(BN_STATS, ("weight", "bias", "running_mean", "running_var")):
                if i < n_convs - 1:
                    out[f"{dst}.{3 * i + 1}.{ref}"] = sd[f"{src}.norms.{i}.{leaf}"]

    def conv(dst, src):
        out[f"{dst}.weight"] = sd[f"{src}.weight"].T[:, :, None]
        out[f"{dst}.bias"] = sd[f"{src}.bias"]

    mlp("kenc.encoder", "kenc", len(cfg.keypoint_encoder) + 1)
    for i, shared in enumerate(cfg.sharing_layers(True)):
        mlp(f"gnn.layers.{i}.mlp", f"gnn.{i}.mlp", 2)
        if shared:
            conv(f"gnn.layers.{i}.proj", f"gnn.{i}.proj")
            conv(f"gnn.layers.{i}.merge", f"gnn.{i}.merge")
        else:
            for j, name in enumerate(("q", "k", "v")):
                conv(f"gnn.layers.{i}.attn.proj.{j}", f"gnn.{i}.attn.{name}")
            conv(f"gnn.layers.{i}.attn.merge", f"gnn.{i}.attn.merge")
    for i in range(cfg.n_layers):
        conv(f"final_proj.{i}", f"final_proj.{i}")
    return out


def test_running_statistics_are_parameters_in_the_same_layout(tmp_path):
    """bn_mean and bn_var are parameters (Adam's state holds them) under the
    state_dict keys of the converter's layout; impx's params, the reference
    layout and a Trainer checkpoint each round-trip them."""
    cfg = MatcherConfig(**SMALL, **BN)
    model = DGNNS(cfg, device="cpu", seed=2)
    names = dict(model.named_parameters())
    assert "kenc.norms.0.bn_mean" in names and "gnn.3.mlp.norms.0.bn_var" in names
    assert not dict(model.named_buffers())
    params = random_bn(JaxDGNNS(JaxConfig(**SMALL, **BN)).init(jax.random.PRNGKey(0)))
    sd = params_from_jax(jax.tree.map(np.array, params), cfg)
    assert sd.keys() == model.state_dict().keys()
    model.load_state_dict(sd)
    for name, t in model.state_dict().items():
        assert torch.equal(t, sd[name]), name
    again = load_reference_state_dict(_reference_layout(model.state_dict(), cfg), cfg)
    for name, t in model.state_dict().items():
        assert torch.equal(again[name], t), name

    args = argparse.Namespace(lr=1e-4, network="dgnns", feature="spp", batch_size=2, epochs=1,
                              save_path=str(tmp_path), max_keypoints=32, its_per_epoch=1, log_intervals=1)
    trainer = Trainer(model, SyntheticMegadepth(num_pairs=2, nfeatures=32, desc_dim=32), args)
    opt = trainer.train()
    path = trainer.save_checkpoint(opt, name="roundtrip")
    other = DGNNS(cfg, device="cpu", seed=5)
    opt2 = Trainer(other, SyntheticMegadepth(num_pairs=2, nfeatures=32, desc_dim=32), args).restore_checkpoint(path)
    for name, t in model.state_dict().items():
        assert torch.equal(other.state_dict()[name], t), name
    for key in ("mu", "nu"):
        assert torch.equal(opt2[key]["gnn.0.mlp.norms.0.bn_var"], opt[key]["gnn.0.mlp.norms.0.bn_var"])
