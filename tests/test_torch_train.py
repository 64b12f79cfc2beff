"""The port's training path against impx's on the CPU: the plain versions of
the attention backward kernels, the autograd Functions around them, the
Sinkhorn head's custom backward, the loss, DGNNS.forward_train and its
gradients, the training step and the trainer.

Small config: D = 32, keypoint_encoder (16, 32), 4 heads, 4 layers (the
sharing pattern first shares at iteration 3), N = 48, B = 2 with padded
valid0/valid1. impx runs with attn_impl='pallas', its kernels interpreted on
the CPU. Inputs and weights come from numpy seeds and go to both packages;
weights and gradients cross with params_from_jax.
"""
import argparse
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from impx.data.megadepth import SyntheticMegadepth
from impx.models import DGNNS as JaxDGNNS
from impx.models import MatcherConfig as JaxConfig
from impx.models.loss import graph_loss as jax_graph_loss
from impx.models.loss import matching_accuracy as jax_matching_accuracy
from impx.ops.pallas.attention import _mha_bwd_call
from impx.ops.pallas.attention import mha_bwd_from_lse as jax_mha_bwd_from_lse
from impx.ops.pallas.attention import mha_fused_lse as jax_mha_fused_lse
from impx.ops.sinkhorn import sink_algorithm as jax_sink_algorithm
from impx.train import step as jax_step

from impx_torch.models import DGNNS, MatcherConfig
from impx_torch.models.loss import graph_loss, matching_accuracy
from impx_torch.ops.kernels.attention import (
    MhaFunction, MhaLseFunction, mha_bwd, mha_bwd_from_lse, mha_fused, mha_fused_lse,
    mha_reference)
from impx_torch.ops.sinkhorn import _padded_masks, _pad_with_dustbin, marginals, sink_algorithm
from impx_torch.tools.convert import params_from_jax
from impx_torch.train.step import (
    TrainHyperParams, init_opt_state, init_stats, lr_at, make_train_step)
from impx_torch.train.trainer import Trainer

from test_torch_kernels import _zero_grad_leaves, attention_inputs, sinkhorn_case

B, N, D = 2, 48, 32
SMALL = dict(descriptor_dim=D, keypoint_encoder=(16, 32), n_layers=4, num_heads=4, norm_fn="in")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def train_batch(rs, b=B, n=N, d=D):
    """Pairs with 2 and 7 padded keypoints; in image 1, about half of the
    valid slots hold a permuted, noised copy of an image-0 keypoint and the
    rest fresh keypoints. matching_mask [B, N+1, N+1] marks the copies, and
    every other valid keypoint in the dustbin; padded rows and columns stay 0."""
    d0 = rs.randn(b, n, d).astype(np.float32)
    k0 = (rs.rand(b, n, 2) - 0.5).astype(np.float32)
    s0 = rs.rand(b, n).astype(np.float32)
    n_valid = np.array([n - 7, n - 2])[:b]
    valid = np.arange(n)[None] < n_valid[:, None]
    d1, k1, s1 = d0.copy(), k0.copy(), s0.copy()
    gt = np.zeros((b, n + 1, n + 1), np.float32)
    for i, nv in enumerate(n_valid):
        perm = rs.permutation(nv)
        copy = rs.rand(nv) < 0.5
        d1[i, :nv] = np.where(copy[:, None], d0[i, perm] + 0.05 * rs.randn(nv, d), rs.randn(nv, d))
        k1[i, :nv] = np.where(copy[:, None], k0[i, perm], rs.rand(nv, 2) - 0.5)
        s1[i, :nv] = np.where(copy, s0[i, perm], rs.rand(nv))
        gt[i, perm[copy], np.flatnonzero(copy)] = 1
        gt[i, n, np.flatnonzero(~copy)] = 1
        gt[i, np.setdiff1d(np.arange(nv), perm[copy]), n] = 1
    return {"descriptors0": d0, "descriptors1": d1.astype(np.float32), "norm_keypoints0": k0,
            "norm_keypoints1": k1.astype(np.float32), "scores0": s0, "scores1": s1.astype(np.float32),
            "valid0": valid, "valid1": valid.copy(), "matching_mask": gt}


# ------------------------------------------------------------------ kernels 3-5
@pytest.mark.parametrize("dtype,tol", [
    ("float32", 1e-5),
    # bf16 outputs: both sides round the fp32 sums to bf16 once, and kernel 5
    # rounds p and ds to bf16 before their products; an fp32 difference can
    # flip a rounding, so one bf16 ulp (2^-8 relative) plus noise
    ("bfloat16", 1e-2),
])
def test_attention_backward_plain_versions_match_pallas(dtype, tol):
    """Kernels 3, 4 and 5's plain versions against impx's Pallas kernels
    (interpret mode) on padded keys (batch 0), random masks (batch 1) and a
    batch whose keys are all masked (batch 2); Nq = 96 != Nk = 192. Every
    query row has a cotangent: padded queries are not masked in attention."""
    q, k, v, mask = attention_inputs(seed=3, nq=96)
    do = np.random.RandomState(4).randn(*q.shape).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jdt) for x in (q, k, v, do))
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    jmask, tmask = jnp.asarray(mask), torch.from_numpy(mask)
    b, _, _, _ = q.shape
    nk = k.shape[2]

    # kernel 3 (three q-blocks, so the Pallas kernel accumulates dk, dv across them)
    ref3 = _mha_bwd_call(jq, jk, jv, jmask.astype(jnp.float32).reshape(b, 1, nk), jdo, 32, True)
    out3 = mha_bwd(tq, tk, tv, tmask, tdo)
    for name, a, r in zip(("dq", "dk", "dv"), out3, ref3):
        assert a.dtype == tdt
        np.testing.assert_allclose(_np(a), _np(r), rtol=tol, atol=tol, err_msg=f"kernel 3 {name}")
    # kernel 4
    ro, rlse = jax_mha_fused_lse(jq, jk, jv, jmask, block_q=32, interpret=True)
    to, tlse = mha_fused_lse(tq, tk, tv, tmask)
    assert tlse.dtype == torch.float32 and tlse.shape == q.shape[:3]
    np.testing.assert_allclose(_np(to), _np(ro), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(tlse), _np(rlse)[..., 0], rtol=1e-6, atol=1e-5)
    assert (tlse[2] == -1e30).all()  # fully masked: m = -1e30 absorbs log(Nk)
    # kernel 5, from the port's own o and lse
    ref5 = jax_mha_bwd_from_lse(jq, jk, jv, jmask, jnp.asarray(_np(tlse))[..., None],
                                jnp.asarray(_np(to)).astype(jdt), jdo, block_q=32, interpret=True)
    out5 = mha_bwd_from_lse(tq, tk, tv, tmask, tlse, to, tdo)
    # bf16: kernel 5 also rounds each ds to bf16 from fp32 values whose last
    # bits differ (sums in another order); a flipped rounding moves dq and dk
    # by one ulp of that ds times k or q, so twice the tolerance
    tol5 = tol if dtype == "float32" else 2 * tol
    for name, a, r in zip(("dq", "dk", "dv"), out5, ref5):
        assert a.dtype == tdt
        np.testing.assert_allclose(_np(a), _np(r), rtol=tol5, atol=tol5, err_msg=f"kernel 5 {name}")

    # the fully masked batch: kernel 3 spreads p = 1/Nk over the keys, kernel 5
    # has p = exp(-1e30 - lse) = 1 (the reference's own quirk), so its dv is
    # Nk times larger there; both as impx
    col = _np(tdo)[2].sum(axis=1, keepdims=True)  # [H, 1, dh]: sum of do over queries
    np.testing.assert_allclose(_np(out3[2])[2], np.broadcast_to(col / nk, (4, nk, 64)), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(out5[2])[2], np.broadcast_to(col, (4, nk, 64)), rtol=tol, atol=tol * 10)


@pytest.mark.parametrize("route", ["A", "B"])
def test_autograd_functions_match_autograd_of_the_plain_forward(route):
    """Both Functions on CPU tensors (their plain bodies) against
    torch.autograd.grad through mha_reference, fp32, rtol 1e-5 atol 1e-6.
    No fully masked batch: kernel 5's p = 1 there is not the forward's
    gradient (see the test above)."""
    q, k, v, mask = (torch.from_numpy(x) for x in attention_inputs(seed=5, nq=80, nk=96, dh=32))
    mask[2, :40] = True
    w = torch.from_numpy(np.random.RandomState(6).randn(*q.shape).astype(np.float32))
    grads = []
    for fn in ("plain", "function"):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        if fn == "plain":
            out = mha_reference(*leaves, mask)
        elif route == "A":
            out = mha_fused(*leaves, mask)  # MhaFunction when an input requires grad
            assert out.grad_fn.name() == "MhaFunctionBackward"
        else:
            out = MhaLseFunction.apply(*leaves, mask, False)
        grads.append(torch.autograd.grad((out * w).sum(), leaves))
    for name, a, r in zip(("dq", "dk", "dv"), *grads):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
    with torch.no_grad():  # inference keeps calling kernel 1 directly
        assert mha_fused(*(x.requires_grad_() for x in (q, k, v)), mask).grad_fn is None
    assert MhaFunction.apply(q, k, v, mask, True).shape == q.shape


# ------------------------------------------------------------------ Sinkhorn
@pytest.mark.parametrize("plan", [None, "bfloat16"])
def test_sinkhorn_custom_backward(plan):
    """SinkhornUV's restructured reverse pass against plain autograd through
    the u/v loop and against jax.grad of impx's sink_algorithm (its custom
    VJP), with the plan in fp32 and in bf16 inside the loop: the gradients of
    dist and of the dustbin score within rtol 1e-4 atol 1e-6 (fp32 sums in
    another order). With the bf16 plan, autograd through the loop differs by
    design: the restructured reverse pass, in impx as here, rounds its
    vectors to the plan dtype before each product (relative L2 under 0.03)."""
    dist, bin_, valid0, valid1 = sinkhorn_case(2, 40, 36, [33, 40], [36, 29], seed=7)
    w = np.random.RandomState(8).randn(2, 41, 37).astype(np.float32)
    pd_t = None if plan is None else torch.bfloat16
    pd_j = None if plan is None else jnp.bfloat16

    def jax_loss(d, bs):
        return jnp.sum(jax_sink_algorithm(d, bs, 20, jnp.asarray(valid0), jnp.asarray(valid1),
                                          plan_dtype=pd_j) * w)

    jg = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(dist), jnp.asarray(bin_))
    v0, v1 = torch.from_numpy(valid0), torch.from_numpy(valid1)

    def torch_grads(custom: bool):
        d = torch.from_numpy(dist).requires_grad_()
        bs = torch.tensor(bin_).requires_grad_()
        if custom:
            plan_t = sink_algorithm(d, bs, 20, v0, v1, plan_dtype=pd_t)
            assert plan_t.grad_fn.name() == "SinkhornUVBackward"
        else:  # autograd through the loop, the same forward written out
            f0, f1, v0p, v1p = _padded_masks(2, 40, 36, v0, v1, d.dtype, d.device)
            r, c = marginals(f0, f1)
            s = torch.where(v0p[:, :, None] & v1p[:, None, :], _pad_with_dustbin(d, bs), -1e30)
            p = torch.softmax(s, dim=-1)
            pdt = pd_t or p.dtype
            p_loop = p.to(pdt).float()
            u, vv = torch.ones_like(r), torch.ones_like(c)
            for _ in range(20):
                u = r / (torch.matmul(p_loop, vv.to(pdt).float()[:, :, None])[:, :, 0] + 1e-8)
                vv = c / (torch.matmul(u.to(pdt).float()[:, None, :], p_loop)[:, 0, :] + 1e-8)
            plan_t = p * u[:, :, None] * vv[:, None, :]
        return torch.autograd.grad((plan_t * torch.from_numpy(w)).sum(), (d, bs))

    custom, plain = torch_grads(True), torch_grads(False)
    for a, p_, j, name in zip(custom, plain, jg, ("dist", "bin_score")):
        np.testing.assert_allclose(a.numpy(), _np(j), rtol=1e-4, atol=1e-6, err_msg=f"{name} vs impx")
        if plan is None:
            np.testing.assert_allclose(a.numpy(), p_.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name} vs autograd")
        else:  # the reverse pass rounds its vectors to bf16 too, autograd's does not
            rel = np.linalg.norm(a.numpy() - p_.numpy()) / np.linalg.norm(p_.numpy())
            assert rel < 0.03, (name, rel)


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("hard_negative", [False, True])
def test_graph_loss_and_accuracy_match_impx(hard_negative):
    data = train_batch(np.random.RandomState(9))
    dist, bin_, valid0, valid1 = sinkhorn_case(2, N, N, [N - 7, N - 2], [N - 7, N - 2], seed=9)
    plan = sink_algorithm(torch.from_numpy(dist), torch.tensor(bin_), 20,
                          torch.from_numpy(valid0), torch.from_numpy(valid1))
    gt = data["matching_mask"]
    ref = jax_graph_loss(jnp.asarray(_np(plan)), jnp.asarray(gt), with_hard_negative=hard_negative)
    out = graph_loss(plan, torch.from_numpy(gt), with_hard_negative=hard_negative)
    for key in ("corr", "incorr", "neg"):
        np.testing.assert_allclose(float(out[key]), float(ref[key]), rtol=1e-6, atol=1e-7, err_msg=key)
    idx = np.random.RandomState(10).randint(-1, N, size=(2, N))
    idx[0, :20] = np.argmax(gt[0, :20, :], axis=-1)  # some right, some dustbin
    ref_acc = jax_matching_accuracy(jnp.asarray(idx), jnp.asarray(gt))
    acc = matching_accuracy(torch.from_numpy(idx), torch.from_numpy(gt))
    for key, val in ref_acc.items():
        assert float(acc[key]) == float(val), key


# ------------------------------------------------------------------ forward_train
def _models(compute_dtype, fused, supervision):
    extra = dict(compute_dtype=compute_dtype, train_fused=fused, train_supervision=supervision)
    jmodel = JaxDGNNS(JaxConfig(**SMALL, attn_impl="pallas", **extra))
    params = jmodel.init(jax.random.PRNGKey(0))
    tcfg = MatcherConfig(**SMALL, **extra)
    tmodel = DGNNS(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.array, params), tcfg))
    return jmodel, params, tmodel, tcfg


def _torch_grads(tmodel):
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
            for n, p in tmodel.named_parameters()}


@pytest.fixture(scope="module")
def batch():
    return train_batch(np.random.RandomState(0))


@pytest.mark.parametrize("supervision", ["all", "last"])
@pytest.mark.parametrize("route", ["A", "B"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_forward_train_matches_impx(batch, compute_dtype, route, supervision):
    """Loss, its terms, matches0 and every gradient leaf against impx's
    DGNNS.forward_train (attn_impl='pallas'). fp32: loss rtol 1e-5,
    matches0 equal, gradients rtol 2e-3 atol 1e-5 (impx's own bounds between
    its paths, tests/test_fast_train.py:40-41, 203-205). bf16 rounds at other
    places in XLA and PyTorch: loss rtol 1e-3, matches0 equal here, and each
    leaf's relative L2 error under 0.15 (measured: at most 0.075, median
    0.025-0.037 over the four cases), the leaves whose exact gradient is 0
    (_zero_grad_leaves) within 0.02 of the largest leaf's norm (measured 0.0013)."""
    jmodel, params, tmodel, tcfg = _models(compute_dtype, route == "B", supervision)
    jdata = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, ref), jgrads = jax.value_and_grad(
        lambda p: (lambda o: (o["loss"], o))(jmodel.forward_train(p, jdata)), has_aux=True)(params)
    out = tmodel.forward_train(batch)
    out["loss"].backward()
    out = {k: v.detach() for k, v in out.items()}

    fp32 = compute_dtype == "float32"
    np.testing.assert_allclose(float(out["loss"]), float(loss), rtol=1e-5 if fp32 else 1e-3)
    for key in ("matching_loss_corr", "matching_loss_incorr", "matching_loss_neg", "geo_loss"):
        np.testing.assert_allclose(float(out[key]), float(ref[key]), rtol=1e-5 if fp32 else 2e-3,
                                   atol=1e-7, err_msg=key)
    idx = out["matches0"].numpy()
    np.testing.assert_array_equal(idx, np.asarray(ref["matches0"]))
    assert (idx >= 0).sum() >= 10  # a real match set, not all -1
    for key in ("acc_corr", "acc_incorr", "total_acc_corr", "total_acc_incorr"):
        assert float(out[key]) == float(ref[key]), key

    want = params_from_jax(jax.tree.map(np.array, jgrads), tcfg)
    got = _torch_grads(tmodel)
    assert got.keys() == want.keys()
    biggest = max(np.linalg.norm(g.numpy()) for g in want.values())
    zero = _zero_grad_leaves(tmodel)
    for name, g in got.items():
        r = want[name].numpy()
        if fp32:
            np.testing.assert_allclose(g, r, rtol=2e-3, atol=1e-5, err_msg=name)
        elif zero.search(name):
            assert np.linalg.norm(g - r) <= 0.02 * biggest, name
        elif not r.any():  # 'last': final_proj[:-1] get no gradient
            assert not g.any(), name
        else:
            rel = np.linalg.norm(g - r) / np.linalg.norm(r)
            assert rel < 0.15, (name, rel)


def test_routes_agree_in_the_port(batch):
    """Route A against route B in the port at fp32, as impx holds its own
    (tests/test_fast_train.py:196-205): loss rtol 1e-6, matches0 equal,
    gradients rtol 2e-3 atol 1e-6."""
    outs = []
    for fused in (False, True):
        cfg = MatcherConfig(**SMALL, train_fused=fused)
        model = DGNNS(cfg, device="cpu", seed=3)
        out = model.forward_train(batch)
        out["loss"].backward()
        outs.append((out, _torch_grads(model)))
    (a, ga), (b, gb) = outs
    np.testing.assert_allclose(b["loss"].item(), a["loss"].item(), rtol=1e-6)
    assert torch.equal(a["matches0"], b["matches0"])
    for name in ga:
        np.testing.assert_allclose(gb[name], ga[name], rtol=2e-3, atol=1e-6, err_msg=name)


# ------------------------------------------------------------------ the step
def test_lr_schedule_matches_impx():
    hp = TrainHyperParams()
    jhp = jax_step.TrainHyperParams()
    for it in (0, 100, 200_000, 250_000, 2_000_000):
        np.testing.assert_allclose(lr_at(hp, it), float(jax_step.lr_at(jhp, it)), rtol=1e-5)


@pytest.mark.parametrize("optim,clip", [("adam", 0.0), ("adamw", 0.0), ("adam", 0.05)])
def test_three_train_steps_match_impx(batch, optim, clip):
    """Three steps of make_train_step against impx's on the same batch, at
    lr 1e-3: the losses within rtol 1e-5, both moments within 1e-4 relative
    L2 a leaf, the parameters within 3e-5 (measured at most 1e-5: Adam's
    step is lr times mu / (sqrt(nu) + 1e-8), which moves by up to lr where a
    gradient is near 1e-8). Leaves whose exact gradient is 0
    (_zero_grad_leaves) are driven by rounding noise, which Adam scales up to
    lr a step: within 3 lr. Then a NaN batch leaves the parameters, both
    moments and the step count as they were."""
    lr = 1e-3
    kw = dict(lr=lr, decay_iter=10_000, optim=optim, grad_clip=clip)
    jmodel, params, tmodel, tcfg = _models("float32", False, "all")
    jstep = jax_step.make_train_step(jmodel, jax_step.TrainHyperParams(**kw), donate=False)
    jopt = jax_step.make_optimizer(jax_step.TrainHyperParams(**kw)).init(params)
    step = make_train_step(tmodel, TrainHyperParams(**kw))
    opt = init_opt_state(tmodel)
    jdata = {k: jnp.asarray(v) for k, v in batch.items()}
    stats, jstats = init_stats("cpu"), jax_step.init_stats()
    for it in range(3):
        params, jopt, jm, jstats = jstep(params, jopt, jnp.asarray(it), jdata, jstats)
        m, stats = step(opt, it, batch, stats)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    want = params_from_jax(jax.tree.map(np.array, params), tcfg)
    zero = _zero_grad_leaves(tmodel)
    for name, p in tmodel.state_dict().items():
        atol = 3 * lr if zero.search(name) else 3e-5
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0, atol=atol, err_msg=name)
    adam = next(s for s in jopt if hasattr(s, "mu"))
    assert int(opt["count"]) == int(adam.count) == 3
    for key, tree in (("mu", adam.mu), ("nu", adam.nu)):
        ref = params_from_jax(jax.tree.map(np.array, tree), tcfg)
        for name, x in opt[key].items():
            if not zero.search(name):
                r = ref[name].numpy()
                assert np.linalg.norm(x.numpy() - r) <= 1e-4 * np.linalg.norm(r), (key, name)
    assert float(stats["n_good"]) == 3.0 and float(stats["consec_bad"]) == 0.0

    before = ({k: v.clone() for k, v in tmodel.state_dict().items()},
              {k: {n: t.clone() for n, t in opt[k].items()} for k in ("mu", "nu")}, int(opt["count"]))
    poisoned = dict(batch, descriptors0=batch["descriptors0"] * np.nan)
    m, stats = step(opt, 3, poisoned, stats)
    assert int(m["bad_loss"]) == 1 and float(stats["consec_bad"]) == 1.0
    for k, v in tmodel.state_dict().items():
        assert torch.equal(v, before[0][k]), k
    for key in ("mu", "nu"):
        for n, t in opt[key].items():
            assert torch.equal(t, before[1][key][n]), (key, n)
    assert int(opt["count"]) == before[2]


# ------------------------------------------------------------------ the trainer
def _args(tmp_path, **kw):
    base = dict(lr=1e-4, network="dgnns", feature="spp", batch_size=2, epochs=2,
                save_path=str(tmp_path), max_keypoints=32, its_per_epoch=2, log_intervals=1)
    return argparse.Namespace(**{**base, **kw})


def _tiny_model(seed=0):
    return DGNNS(MatcherConfig(descriptor_dim=32, keypoint_encoder=(16, 32), n_layers=2,
                               num_heads=4, norm_fn="in", sinkhorn_iterations=5),
                 device="cpu", seed=seed)


def test_trainer_epochs_and_checkpoint_round_trip(tmp_path):
    """Two short epochs over impx's SyntheticMegadepth; then a torch.save
    checkpoint restores identical parameters and optimizer state."""
    model = _tiny_model()
    ds = SyntheticMegadepth(num_pairs=4, nfeatures=32, desc_dim=32)
    trainer = Trainer(model, ds, _args(tmp_path))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    opt = trainer.train()
    assert trainer.epoch == 2 and trainer.iteration == 4 and int(opt["count"]) == 4
    assert any(not torch.equal(v, start[k]) for k, v in model.state_dict().items())
    assert np.isfinite(trainer.best_value)
    path = trainer.save_checkpoint(opt, name="roundtrip")

    other = _tiny_model(seed=5)
    trainer2 = Trainer(other, ds, _args(tmp_path))
    opt2 = trainer2.restore_checkpoint(path)
    assert trainer2.epoch == 3 and trainer2.iteration == 4
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    assert torch.equal(opt2["count"], opt["count"])
    for key in ("mu", "nu"):
        for n, t in opt[key].items():
            assert torch.equal(opt2[key][n], t), (key, n)


def test_trainer_nan_abort_spans_log_intervals(tmp_path):
    """Every batch poisoned, log_intervals=3: the 10-in-a-row abort fires at
    a log boundary although no interval holds 10 steps."""

    class Poisoned(SyntheticMegadepth):
        def __getitem__(self, idx):
            s = super().__getitem__(idx)
            s["descriptors0"] = s["descriptors0"] * np.nan
            return s

    model = _tiny_model()
    start = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(model, Poisoned(num_pairs=40, nfeatures=16, desc_dim=32),
                      _args(tmp_path, its_per_epoch=20, log_intervals=3))
    opt, loss = trainer.process_epoch(init_opt_state(model))
    assert loss is None and trainer.iteration == 12  # aborted at the 4th boundary
    assert "Abort epoch" in open(f"{trainer.save_dir}/log.txt").read()
    assert int(opt["count"]) == 0
    for k, v in model.state_dict().items():
        assert torch.equal(v, start[k]), k


def test_trainer_reraises_a_prefetch_exception(tmp_path):
    class Exploding(SyntheticMegadepth):
        def __getitem__(self, idx):
            raise RuntimeError("boom in the data pipeline")

    model = _tiny_model()
    trainer = Trainer(model, Exploding(num_pairs=8, nfeatures=16, desc_dim=32), _args(tmp_path))
    with pytest.raises(RuntimeError, match="boom"):
        trainer.process_epoch(init_opt_state(model))
    # tensor parallelism outside a process group: 2 does not divide the one process
    with pytest.raises(SystemExit, match="--model_parallel 2 does not divide the 1 processes"):
        Trainer(model, Exploding(), _args(tmp_path, model_parallel=2))
