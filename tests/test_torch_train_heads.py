"""Training under the log-OT head, the dual softmax and with_geo, and GM's
unrolled training forward, against impx on the CPU.

LogUV (the log-domain head's restructured backward) and the differentiable
log_optimal_transport_fused against jax.grad of impx's; the log-plan loss,
the geometric loss and its epipolar matrix; DGNNS's stacked training forward
under each head and GM's unrolled one at N0 = N1 and N0 != N1, loss and
every gradient leaf. Small config: D = 32, keypoint_encoder (16, 32), 4
heads, 2 layers, B = 2, N <= 24, padded keypoints in both images. impx runs
under jax.jit on its XLA attention (attn_impl='xla': its DGNNS trains
through GM's unrolled forward there), which compiles faster than its
interpreted Pallas kernels and computes the same function.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from impx.models import DGNNS as JaxDGNNS
from impx.models import GM as JaxGM
from impx.models import MatcherConfig as JaxConfig
from impx.models import loss as jax_loss
from impx.ops.pallas.log_sinkhorn import log_optimal_transport_fused as jax_lot_fused
from impx.ops.sinkhorn import log_optimal_transport as jax_log_ot

from impx_torch.models import DGNNS, MatcherConfig
from impx_torch.models.gm import GM
from impx_torch.models.loss import epipolar_loss, geo_loss, graph_loss, maybe_epipolar_matrix
from impx_torch.ops.kernels.log_sinkhorn import log_optimal_transport_fused
from impx_torch.ops.sinkhorn import (
    _padded_masks, log_marginals, log_optimal_transport, masked_scores)
from impx_torch.tools.convert import params_from_jax

from test_torch_kernels import _zero_grad_leaves, sinkhorn_case

D = 32
SMALL = dict(descriptor_dim=D, keypoint_encoder=(16, 32), n_layers=2, num_heads=4, norm_fn="in")
HEADS = {"sinkhorn": {}, "log_ot": dict(log_ot=True), "dual_softmax": dict(with_sinkhorn=False),
         "geo": dict(with_geo=True), "log_ot_geo": dict(log_ot=True, with_geo=True)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops dominate: one thread, as tests/test_torch_logot.py runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def pair_batch(rs, n0=16, n1=16, b=2, d=D):
    """Pairs with 3 padded keypoints in image 0 of pair 0 and 2 in image 1 of
    pair 1; about half of the valid keypoints of the smaller side have a
    noised copy in the other image (matching_mask marks them, every other
    valid keypoint sits in a dustbin, padded rows and columns stay 0). Pixel
    keypoints, intrinsics and the essential matrix of a random relative pose
    for with_geo."""
    nv0, nv1 = np.array([n0 - 3, n0]), np.array([n1, n1 - 2])
    d0, d1 = rs.randn(b, n0, d).astype(np.float32), rs.randn(b, n1, d).astype(np.float32)
    k0, k1 = (rs.rand(b, n0, 2) - 0.5).astype(np.float32), (rs.rand(b, n1, 2) - 0.5).astype(np.float32)
    s0, s1 = rs.rand(b, n0).astype(np.float32), rs.rand(b, n1).astype(np.float32)
    gt = np.zeros((b, n0 + 1, n1 + 1), np.float32)
    for i in range(b):
        m = min(nv0[i], nv1[i]) // 2
        src, dst = rs.permutation(nv0[i])[:m], rs.permutation(nv1[i])[:m]
        d1[i, dst] = d0[i, src] + 0.05 * rs.randn(m, d)
        k1[i, dst], s1[i, dst] = k0[i, src], s0[i, src]
        gt[i, src, dst] = 1
        gt[i, np.setdiff1d(np.arange(nv0[i]), src), n1] = 1
        gt[i, n0, np.setdiff1d(np.arange(nv1[i]), dst)] = 1
    K = np.array([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]], np.float32)
    E = []
    for _ in range(b):
        w = rs.randn(3) * 0.2
        wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        R = np.eye(3) + np.sin(np.linalg.norm(w)) * wx / np.linalg.norm(w) + \
            (1 - np.cos(np.linalg.norm(w))) * wx @ wx / np.linalg.norm(w) ** 2
        t = rs.randn(3)
        t /= np.linalg.norm(t)
        E.append(np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]]) @ R)
    pix = lambda k: (k * 224 + np.array([160, 120])).astype(np.float32)  # noqa: E731
    return {"descriptors0": d0, "descriptors1": d1, "norm_keypoints0": k0, "norm_keypoints1": k1,
            "scores0": s0, "scores1": s1,
            "valid0": np.arange(n0)[None] < nv0[:, None], "valid1": np.arange(n1)[None] < nv1[:, None],
            "matching_mask": gt, "keypoints0": pix(k0), "keypoints1": pix(k1),
            "intrinsics0": np.stack([K] * b), "intrinsics1": np.stack([K] * b),
            "gt_E": np.stack(E).astype(np.float32)}


# ------------------------------------------------------------------ the log-domain head
def _valid_loss_weights(b, n, m, valid0, valid1, seed):
    """Random weights on the valid cells only (the dustbin row and column
    included), 0 elsewhere: every loss of the port masks the padded cells,
    whose plain-autograd gradient is an artefact of the -1e30 fill."""
    _, _, v0p, v1p = _padded_masks(b, n, m, torch.from_numpy(valid0), torch.from_numpy(valid1),
                                   torch.float32, "cpu")
    ok = (v0p[:, :, None] & v1p[:, None, :]).numpy()
    return (np.random.RandomState(seed).randn(b, n + 1, m + 1) * ok).astype(np.float32)


def _log_ot_autograd(dist, dustbin, iterations, valid0, valid1):
    """log_optimal_transport's forward written out, for plain autograd
    through every sweep."""
    b, n, m = dist.shape
    f0, f1, _, _ = _padded_masks(b, n, m, valid0, valid1, dist.dtype, dist.device)
    log_mu, log_nu, norm = log_marginals(f0, f1)
    z = masked_scores(dist, dustbin, valid0, valid1)
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(iterations):
        u = log_mu - torch.logsumexp(z + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(z + u[:, :, None], dim=1)
    return z + u[:, :, None] + v[:, None, :] - norm[:, :, None]


def test_log_uv_gradients_match_impx_and_autograd():
    """log_optimal_transport's gradient (LogUV's restructured reverse pass)
    for dist and the dustbin against jax.grad of impx's (its custom VJP) and
    against plain autograd through the 20 sweeps, with padded rows and
    columns and N = 20 != M = 14: rtol 1e-4, atol 1e-6 of the largest
    gradient. The forward is unchanged: equal to the written-out loop bit
    for bit. LogUV keeps one u and one v a sweep, not a plan."""
    dist, bin_, valid0, valid1 = sinkhorn_case(2, 20, 14, [17, 20], [14, 11], seed=3)
    w = _valid_loss_weights(2, 20, 14, valid0, valid1, seed=4)
    jg = jax.jit(jax.grad(lambda d, bs: jnp.sum(jax_log_ot(d, bs, 20, jnp.asarray(valid0), jnp.asarray(valid1))
                                                * w), argnums=(0, 1)))(jnp.asarray(dist), jnp.asarray(bin_))
    v0, v1 = torch.from_numpy(valid0), torch.from_numpy(valid1)
    grads, outs = [], []
    for fn in (log_optimal_transport, _log_ot_autograd):
        d = torch.from_numpy(dist).requires_grad_()
        bs = torch.tensor(bin_).requires_grad_()
        out = fn(d, bs, 20, v0, v1)
        if fn is log_optimal_transport:
            saved = out.grad_fn.next_functions[0][0]
            assert saved.name() == "LogUVBackward"
            # the history is [T, B, N+1] / [T, B, M+1]: vectors, no plan a sweep
            assert [tuple(t.shape) for t in saved.saved_tensors[3:]] == [(20, 2, 21), (20, 2, 15)]
        outs.append(out.detach())
        grads.append(torch.autograd.grad((out * torch.from_numpy(w)).sum(), (d, bs)))
    assert torch.equal(outs[0], outs[1])
    for name, ours, plain, ref in zip(("dist", "dustbin"), *grads, jg):
        scale = np.abs(_np(ref)).max()
        np.testing.assert_allclose(_np(ours), _np(ref), rtol=1e-4, atol=1e-6 * scale, err_msg=f"{name} vs impx")
        np.testing.assert_allclose(_np(ours), _np(plain), rtol=1e-4, atol=1e-6 * scale,
                                   err_msg=f"{name} vs autograd")


def test_log_ot_fused_vjp_matches_impx():
    """log_optimal_transport_fused(plain=True): the forward from kernel 7's
    plain version, the backward the plain fp32 head's; its VJP for dist and
    the dustbin (a learned parameter) against impx's fused head's custom VJP
    (its Pallas kernel interpreted), rtol 1e-4, atol 1e-6 of the largest
    gradient; the forward within rtol 1e-5 of impx's at the valid cells."""
    dist, bin_, valid0, valid1 = sinkhorn_case(2, 16, 12, [16, 13], [10, 12], seed=5)
    w = _valid_loss_weights(2, 16, 12, valid0, valid1, seed=6)
    j0, j1 = jnp.asarray(valid0), jnp.asarray(valid1)
    jout, jvjp = jax.vjp(lambda d, bs: jax_lot_fused(d, bs, 20, j0, j1, 8, True),
                         jnp.asarray(dist), jnp.asarray(bin_))
    jg = jvjp(jnp.asarray(w))
    d = torch.from_numpy(dist).requires_grad_()
    bs = torch.tensor(bin_).requires_grad_()
    out = log_optimal_transport_fused(d, bs, 20, torch.from_numpy(valid0), torch.from_numpy(valid1), plain=True)
    assert out.grad_fn.name() == "LogOTFusedBackward"
    ok = w != 0
    np.testing.assert_allclose(_np(out)[ok], _np(jout)[ok], rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(out, (d, bs), torch.from_numpy(w))
    for name, ours, ref in zip(("dist", "dustbin"), grads, jg):
        np.testing.assert_allclose(_np(ours), _np(ref), rtol=1e-4, atol=1e-6 * np.abs(_np(ref)).max(),
                                   err_msg=name)


# ------------------------------------------------------------------ the losses
@pytest.mark.parametrize("hard_negative", [False, True])
def test_log_plan_loss_and_geo_loss_match_impx(hard_negative):
    """graph_loss of a log plan (scores_are_log=True), geo_loss and
    epipolar_loss of its probabilities and maybe_epipolar_matrix against
    impx's, rtol 1e-5; a batch without the geometric keys gives no matrix."""
    data = pair_batch(np.random.RandomState(7), 16, 12)
    dist, bin_, _, _ = sinkhorn_case(2, 16, 12, [16, 13], [12, 10], seed=8)
    v0, v1 = data["valid0"], data["valid1"]
    plan = log_optimal_transport(torch.from_numpy(dist), torch.tensor(bin_), 20,
                                 torch.from_numpy(v0), torch.from_numpy(v1))
    gt = data["matching_mask"]
    ref = jax_loss.graph_loss(jnp.asarray(_np(plan)), jnp.asarray(gt), with_hard_negative=hard_negative,
                              scores_are_log=True)
    out = graph_loss(plan, torch.from_numpy(gt), with_hard_negative=hard_negative, scores_are_log=True)
    for key in ("corr", "incorr", "neg"):
        np.testing.assert_allclose(float(out[key]), float(ref[key]), rtol=1e-5, atol=1e-7, err_msg=key)

    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    epi = maybe_epipolar_matrix(tdata, 0.05)
    jepi = jax_loss.maybe_epipolar_matrix({k: jnp.asarray(v) for k, v in data.items()}, 0.05)
    assert epi.shape == (2, 16, 12) and float(epi.max()) == pytest.approx(0.05) and float(epi.min()) < 0.01
    np.testing.assert_allclose(_np(epi), _np(jepi), rtol=1e-5, atol=1e-7)
    prob = torch.exp(plan)
    geo = geo_loss(prob, epi, tdata["valid0"], tdata["valid1"])
    jgeo = jax_loss.geo_loss(jnp.asarray(_np(prob)), jepi, jnp.asarray(v0), jnp.asarray(v1))
    np.testing.assert_allclose(float(geo), float(jgeo), rtol=1e-5)
    np.testing.assert_allclose(float(geo_loss(prob, epi)), float(jax_loss.geo_loss(jnp.asarray(_np(prob)), jepi)),
                               rtol=1e-5)
    inner = prob[:, :-1, :-1]
    np.testing.assert_allclose(float(epipolar_loss(inner, epi)),
                               float(jax_loss.epipolar_loss(jnp.asarray(_np(inner)), jepi)), rtol=1e-5)
    without = {k: v for k, v in tdata.items() if k != "gt_E"}
    assert maybe_epipolar_matrix(without, 0.05) is None


# ------------------------------------------------------------------ the training forwards
def _pair(jax_cls, torch_cls, n_layers=2, **extra):
    """impx's model and its params, and the port's with the same weights."""
    jcfg = JaxConfig(**{**SMALL, "n_layers": n_layers}, **extra)
    jmodel = jax_cls(jcfg)
    params = jmodel.init(jax.random.PRNGKey(1))
    tcfg = MatcherConfig(**{**SMALL, "n_layers": n_layers}, **extra)
    tmodel = torch_cls(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.array, params), tcfg, tmodel.sharing))
    return jmodel, params, tmodel, tcfg


def _check_train(jmodel, params, tmodel, tcfg, data):
    """Loss, its terms, matches0 and every gradient leaf of the port's
    forward_train against impx's under jax.jit, fp32: loss and terms rtol
    1e-5 (atol 1e-6), matches0 equal, gradients rtol 2e-3 atol 1e-5 (the
    bounds of tests/test_torch_train.py); leaves whose exact gradient is 0
    within 1e-5 of the largest leaf's norm."""
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    step = jax.jit(jax.value_and_grad(lambda p, d: (lambda o: (o["loss"], o))(jmodel.forward_train(p, d)),
                                      has_aux=True))
    (loss, ref), jgrads = step(params, jdata)
    out = tmodel.forward_train(data)
    out["loss"].backward()
    np.testing.assert_allclose(out["loss"].item(), float(loss), rtol=1e-5)
    for key in ("matching_loss", "matching_loss_corr", "matching_loss_incorr", "matching_loss_neg", "geo_loss"):
        np.testing.assert_allclose(float(out[key]), float(ref[key]), rtol=1e-5, atol=1e-6, err_msg=key)
    if tcfg.with_geo:
        assert float(out["geo_loss"]) > 0
    np.testing.assert_array_equal(out["matches0"].numpy(), np.asarray(ref["matches0"]))
    for key in ("acc_corr", "acc_incorr", "total_acc_corr", "total_acc_incorr"):
        assert float(out[key]) == pytest.approx(float(ref[key]), abs=1e-6), key
    want = params_from_jax(jax.tree.map(np.array, jgrads), tcfg, tmodel.sharing)
    got = {n: (torch.zeros_like(p) if p.grad is None else p.grad).numpy() for n, p in tmodel.named_parameters()}
    assert got.keys() == want.keys()
    biggest = max(np.linalg.norm(g.numpy()) for g in want.values())
    zero = _zero_grad_leaves(tmodel)
    assert np.abs(got["bin_score"]).max() > 0
    for name, g in got.items():
        if zero.search(name):
            assert np.linalg.norm(g - want[name].numpy()) <= 1e-5 * biggest, name
        else:
            np.testing.assert_allclose(g, want[name].numpy(), rtol=2e-3, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("head", ["log_ot", "dual_softmax", "geo", "log_ot_geo"])
def test_dgnns_stacked_training_heads_match_impx(head):
    """DGNNS's stacked training forward (fast.py:forward_train_scan) under the
    log-OT head, the dual softmax and with_geo against impx's
    DGNNS.forward_train, N0 = N1 = 24."""
    data = pair_batch(np.random.RandomState(11), 24, 24)
    _check_train(*_pair(JaxDGNNS, DGNNS, **HEADS[head]), data)


@pytest.mark.parametrize("shape", [(16, 16), (16, 12)], ids=["16-16", "16-12"])
@pytest.mark.parametrize("head", ["sinkhorn", "log_ot", "dual_softmax", "geo"])
def test_gm_unrolled_training_matches_impx(head, shape):
    """GM.forward_train (the unrolled forward: stacked launches at N0 = N1,
    one an image at N0 != N1) against impx's GM.forward_train, each head."""
    data = pair_batch(np.random.RandomState(12), *shape)
    _check_train(*_pair(JaxGM, GM, **HEADS[head]), data)


@pytest.mark.parametrize("head", ["sinkhorn", "log_ot_geo"])
def test_dgnns_training_at_unequal_counts_matches_impx(head):
    """DGNNS at 16 / 12 keypoints trains through GM's unrolled forward, as
    its produce_matches routes, and matches impx's DGNNS.forward_train
    there (its unrolled forward under attn_impl='xla'); 4 layers, so that
    iteration 3's layers share attention."""
    data = pair_batch(np.random.RandomState(13), 16, 12)
    _check_train(*_pair(JaxDGNNS, DGNNS, n_layers=4, **HEADS[head]), data)


def test_gm_last_supervision_raises():
    """GM's unrolled forward supervises every iteration: 'last' raises
    ValueError, as impx's does, for GM and for DGNNS at N0 != N1."""
    data = pair_batch(np.random.RandomState(14), 16, 12)
    cfg = MatcherConfig(**SMALL, train_supervision="last")
    for model in (GM(cfg, device="cpu"), DGNNS(cfg, device="cpu")):
        with pytest.raises(ValueError, match="train_supervision"):
            model.forward_train(data)
    jcfg = JaxConfig(**SMALL, train_supervision="last")
    with pytest.raises(ValueError, match="train_supervision"):
        JaxGM(jcfg).forward_train(JaxGM(jcfg).init(jax.random.PRNGKey(0)),
                                  {k: jnp.asarray(v) for k, v in data.items()})
    # the stacked forward takes 'last' at N0 = N1
    out = DGNNS(cfg, device="cpu").forward_train(pair_batch(np.random.RandomState(15), 16, 16))
    assert torch.isfinite(out["loss"])
