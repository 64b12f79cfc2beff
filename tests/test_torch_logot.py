"""The port's log-domain OT head and SuperGlue against impx on the CPU.

Inputs come from numpy with a seed; impx's Pallas kernels run interpreted.
  * plain `log_optimal_transport` against impx's: rtol 1e-4, atol 1e-5 at
    valid cells and the dustbin (fp32 throughout, summation order only);
  * `log_sinkhorn_stats_reference` against impx's `log_sinkhorn_fused_stats`
    (interpret=True), under the fp32 Z rule and the bf16 one: indices exact
    on valid rows and columns; u, v and max0 rtol 1e-4, atol 1e-5; u and v
    at invalid entries atol 1e23 (one fp32 ulp at 1e30 is 7.6e22, and under
    the bf16 rule they hold 1e30 - bf16(1e30) = 2.56e26);
  * eval-mode batch norm and the `bn` MLP against impx/ops/mlp.py, with
    random running statistics: atol 1e-5;
  * DGNNS under log_ot against impx's DGNNS(attn_impl='pallas', log_ot=True),
    and SuperGlue against impx's SuperGlue on both attn_impl paths: at fp32
    indices0 exact, mscores0 atol 1e-5 and the log plan rtol 1e-4 at valid
    cells; at bf16 at least 97% of indices0 equal (bf16 rounds at other places
    in XLA and PyTorch, as tests/test_torch_matcher.py states);
  * SuperGlue's two weight layouts give identical modules.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from impx.models import DGNNS as JaxDGNNS
from impx.models import MatcherConfig as JaxConfig
from impx.models.superglue import SuperGlue as JaxSuperGlue
from impx.models.superglue import convert_superglue_matcher
from impx.ops import norms as jax_norms
from impx.ops.mlp import mlp_apply as jax_mlp_apply, mlp_init
from impx.ops.pallas.log_sinkhorn import log_plan_from_uv as jax_log_plan_from_uv
from impx.ops.pallas.log_sinkhorn import log_sinkhorn_fused_stats as jax_log_stats
from impx.ops.sinkhorn import log_optimal_transport as jax_log_ot
from impx.tools.convert_torch import matcher_state_dict

from impx_torch.models import DGNNS, MatcherConfig, SuperGlue
from impx_torch.models.gnn import MLP
from impx_torch.ops import norms
from impx_torch.ops.kernels.log_sinkhorn import (
    log_optimal_transport_fused, log_plan_from_uv, log_sinkhorn_stats_reference)
from impx_torch.ops.kernels.sinkhorn import plan_dtype
from impx_torch.ops.mlp import mlp_apply
from impx_torch.ops.sinkhorn import log_optimal_transport
from impx_torch.tools.convert import load_superglue_state_dict, params_from_jax
from test_torch_matcher import permuted_pairs

INVALID_ATOL = 1e23


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The heads' small per-iteration ops cost more in thread hand-offs than
    in arithmetic on a shared host: run this module on one thread."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def log_case(b, n, m, n0, n1, seed=0):
    """dist [B, N, M] and prefix validity with n0/n1 valid keypoints a pair."""
    rs = np.random.RandomState(seed)
    dist = (rs.randn(b, n, m) * 2).astype(np.float32)
    valid0 = np.arange(n)[None] < np.asarray(n0)[:, None]
    valid1 = np.arange(m)[None] < np.asarray(n1)[:, None]
    return dist, np.float32(0.7), valid0, valid1


def padded_ok(valid0, valid1):
    """Valid cells of the [B, N+1, M+1] plan, the dustbin row and column
    included."""
    ok = valid0[:, :, None] & valid1[:, None, :]
    return np.pad(ok, ((0, 0), (0, 1), (0, 1)), constant_values=True)


# (b, n, m, n0, n1, iterations): masked + full, rectangular, heavily masked
# (tests/test_log_sinkhorn_fused.py:23-27), all under the fp32 Z rule
FP32_RULE = [
    (2, 256, 256, [200, 256], [180, 256], 20),
    (2, 256, 128, [256, 100], [128, 90], 20),
    (2, 512, 512, [30, 512], [25, 512], 50),
]
# the bf16 Z rule at a small size: 32 * 49,280 * 4 bytes > 6 MiB. Pair 0 has
# every row valid and padded columns, pair 1 padded rows and every column valid
BF16_RULE = (2, 16, 49152, [16, 11], [40000, 49152], 20)


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("b,n,m,n0,n1,iters", FP32_RULE)
def test_log_optimal_transport_matches_impx(b, n, m, n0, n1, iters):
    dist, bin_, valid0, valid1 = log_case(b, n, m, n0, n1)
    ref = np.asarray(jax_log_ot(jnp.asarray(dist), jnp.asarray(bin_), iters,
                                jnp.asarray(valid0), jnp.asarray(valid1)))
    out = log_optimal_transport(*_torch(dist, bin_), iters, *_torch(valid0, valid1)).numpy()
    ok = padded_ok(valid0, valid1)
    np.testing.assert_allclose(out[ok], ref[ok], rtol=1e-4, atol=1e-5)
    assert (out[~ok] < -0.99e30).all()


def _stats_both(case):
    b, n, m, n0, n1, iters = case
    dist, bin_, valid0, valid1 = log_case(b, n, m, n0, n1)
    ref = jax_log_stats(jnp.asarray(dist), jnp.asarray(bin_), iters, jnp.asarray(valid0),
                        jnp.asarray(valid1), interpret=True)
    out = log_sinkhorn_stats_reference(*_torch(dist, bin_), iters, *_torch(valid0, valid1))
    return (dist, bin_, valid0, valid1), {k: np.asarray(x) for k, x in ref.items()}, \
        {k: x.numpy() for k, x in out.items()}


def _assert_stats_equal(valid0, valid1, ref, out):
    ok0 = np.pad(valid0, ((0, 0), (0, 1)), constant_values=True)   # the dustbin is valid
    ok1 = np.pad(valid1, ((0, 0), (0, 1)), constant_values=True)
    for key, ok in (("u", ok0), ("v", ok1)):
        np.testing.assert_allclose(out[key][ok], ref[key][ok], rtol=1e-4, atol=1e-5, err_msg=key)
        np.testing.assert_allclose(out[key][~ok], ref[key][~ok], rtol=0, atol=INVALID_ATOL,
                                   err_msg=f"{key} at invalid entries")
    np.testing.assert_allclose(out["max0"], ref["max0"], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(out["idx0"][valid0], ref["idx0"][valid0])
    np.testing.assert_array_equal(out["idx1"][valid1], ref["idx1"][valid1])
    assert (out["idx0"][~valid0] == 0).all() and (out["idx1"][~valid1] == 0).all()


@pytest.mark.parametrize("case", FP32_RULE + [BF16_RULE], ids=["masked", "rectangular", "heavily-masked",
                                                             "bf16-Z"])
def test_log_stats_reference_matches_impx_kernel(case):
    (dist, _, valid0, valid1), ref, out = _stats_both(case)
    rule = plan_dtype(*dist.shape[1:])
    assert rule == (torch.bfloat16 if case is BF16_RULE else torch.float32)
    _assert_stats_equal(valid0, valid1, ref, out)
    if case is BF16_RULE:
        # 1e30 - bf16(1e30) at invalid rows, 0 at invalid columns
        np.testing.assert_allclose(out["u"][1, 11:16], 2.555367e26, rtol=1e-6)
        assert (out["v"][0, 40000:49152] == 0).all()


def test_bf16_rule_without_alignment_rows_stays_finite():
    """impx's kernel under the bf16 Z rule, with N+1 a multiple of 16 (no
    alignment rows) and no padded row in a pair, starts an invalid column's
    log-sum-exp at -1e30 with weight 0 and turns that pair's u and v to NaN
    (ROADMAP.md §C). The port stays finite and equals impx on the same pair
    with one padded row added (which changes no valid entry)."""
    b, n, m = 1, 31, 49152
    dist, bin_, valid0, valid1 = log_case(b, n + 1, m, [n], [40000], seed=5)
    assert plan_dtype(n, m) == plan_dtype(n + 1, m) == torch.bfloat16
    args = (jnp.asarray(bin_), 20)
    faulty = jax_log_stats(jnp.asarray(dist[:, :n]), *args, jnp.asarray(valid0[:, :n]),
                           jnp.asarray(valid1), interpret=True)
    assert np.isnan(np.asarray(faulty["u"])).any()
    ref = jax_log_stats(jnp.asarray(dist), *args, jnp.asarray(valid0), jnp.asarray(valid1),
                        interpret=True)
    out = log_sinkhorn_stats_reference(*_torch(dist[:, :n], bin_), 20, *_torch(valid0[:, :n], valid1))
    out = {k: x.numpy() for k, x in out.items()}
    ref = {k: np.asarray(x) for k, x in ref.items()}
    ref["u"] = np.concatenate([ref["u"][:, :n], ref["u"][:, n + 1:]], axis=1)   # drop the added row
    ref["max0"], ref["idx0"] = ref["max0"][:, :n], ref["idx0"][:, :n]
    assert all(np.isfinite(x).all() for x in out.values())
    _assert_stats_equal(valid0[:, :n], valid1, ref, out)


def test_log_plan_from_uv_matches_impx():
    dist, bin_, valid0, valid1 = log_case(2, 64, 48, [50, 64], [48, 30], seed=2)
    rs = np.random.RandomState(3)
    u, v = rs.randn(2, 65).astype(np.float32), rs.randn(2, 49).astype(np.float32)
    ref = np.asarray(jax_log_plan_from_uv(*(jnp.asarray(x) for x in (dist, bin_, u, v, valid0, valid1))))
    out = log_plan_from_uv(*_torch(dist, bin_, u, v, valid0, valid1)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_log_optimal_transport_fused_matches_plain_head():
    """The drop-in (reference statistics on the CPU, then the plan) equals the
    plain head at valid cells, as impx's does (test_log_sinkhorn_fused.py:28)."""
    dist, bin_, valid0, valid1 = log_case(2, 256, 256, [200, 256], [180, 256], seed=4)
    args = (*_torch(dist, bin_), 20, *_torch(valid0, valid1))
    fused, plain = log_optimal_transport_fused(*args).numpy(), log_optimal_transport(*args).numpy()
    ok = padded_ok(valid0, valid1)
    np.testing.assert_allclose(fused[ok], plain[ok], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- batch norm
def _random_bn(rs, blocks):
    """Random scale, bias and running statistics on every bn block (at their
    initial 1, 0, 0, 1 eval-mode batch norm is the identity up to eps)."""
    out = []
    for blk in blocks:
        blk = dict(blk)
        if "bn_scale" in blk:
            c = blk["bn_scale"].shape[0]
            blk.update(bn_scale=rs.uniform(0.5, 1.5, c), bn_bias=rs.uniform(-0.3, 0.3, c),
                       bn_mean=rs.randn(c) * 0.3, bn_var=rs.uniform(0.3, 2.0, c))
        out.append({k: np.array(x, np.float32) for k, x in blk.items()})
    return out


def test_batch_norm_eval_matches_impx():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 40, 16).astype(np.float32)
    scale, bias, mean = (rs.randn(16).astype(np.float32) for _ in range(3))
    var = rs.uniform(0.1, 2.0, 16).astype(np.float32)
    ref = np.asarray(jax_norms.batch_norm_eval(*(jnp.asarray(a) for a in (x, scale, bias, mean, var))))
    out = norms.batch_norm_eval(*_torch(x, scale, bias, mean, var)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_bn_mlp_matches_impx():
    """mlp_apply and the MLP module with batch norm from running statistics
    against impx's mlp_apply(norm_fn='bn', train=False), the module in
    training mode as in eval mode: each call names its statistics (batch
    statistics: tests/test_torch_train_bn.py)."""
    rs = np.random.RandomState(1)
    channels = [3, 32, 64, 64]
    blocks = _random_bn(rs, jax.tree.map(np.asarray, mlp_init(jax.random.PRNGKey(0), channels,
                                                               norm_fn="bn")))
    x = rs.randn(2, 50, 3).astype(np.float32)
    ref, _ = jax_mlp_apply([{k: jnp.asarray(v) for k, v in blk.items()} for blk in blocks], jnp.asarray(x),
                           norm_fn="bn", ac_fn="relu", train=False)
    bns = [tuple(torch.from_numpy(blk[k]) for k in ("bn_scale", "bn_bias", "bn_mean", "bn_var"))
           for blk in blocks[:-1]]
    out = mlp_apply([(torch.from_numpy(blk["w"]), torch.from_numpy(blk["b"])) for blk in blocks],
                    torch.from_numpy(x), ac_fn="relu", batch_norms=bns)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)

    module = MLP(channels, norm_fn="bn")
    with torch.no_grad():
        for i, blk in enumerate(blocks):
            module.blocks[i].weight.copy_(torch.from_numpy(blk["w"]))
            module.blocks[i].bias.copy_(torch.from_numpy(blk["b"]))
            if i < len(blocks) - 1:
                for k in ("bn_scale", "bn_bias", "bn_mean", "bn_var"):
                    getattr(module.norms[i], k).copy_(torch.from_numpy(blk[k]))
    np.testing.assert_allclose(module.train()(torch.from_numpy(x), ac_fn="relu").detach().numpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(module.eval()(torch.from_numpy(x), ac_fn="relu").detach().numpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- DGNNS log_ot
B, N, D = 2, 128, 64
SMALL = dict(descriptor_dim=D, keypoint_encoder=(32, 64), n_layers=4, num_heads=4)


def _dgnns(compute_dtype):
    jcfg = JaxConfig(**SMALL, norm_fn="in", log_ot=True, attn_impl="pallas", compute_dtype=compute_dtype)
    jmodel = JaxDGNNS(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tcfg = MatcherConfig(**SMALL, norm_fn="in", log_ot=True, compute_dtype=compute_dtype)
    tmodel = DGNNS(tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.array, params), tcfg))
    return jmodel, params, tmodel


def _assert_matches_equal(data, ref, out):
    valid0, valid1 = data["valid0"], data["valid1"]
    assert len(out["indices0"]) == len(ref["indices0"])
    for it, (a, r) in enumerate(zip(out["indices0"], ref["indices0"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r), err_msg=f"iteration {it}")
    for a, r in zip(out["mscores0"], ref["mscores0"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5)
    idx = out["indices0"][-1].numpy()
    assert ((idx >= 0).sum(axis=1) >= valid0.sum(axis=1) / 4).all()   # a real match set
    ok = padded_ok(valid0, valid1)
    for a, r in zip(out["scores"], ref["scores"]):
        if r is None:
            assert a is None
            continue
        np.testing.assert_allclose(a.numpy()[ok], np.asarray(r)[ok], rtol=1e-4, atol=1e-5)
        assert (a.numpy()[~ok] < -0.99e30).all()   # log plans, masked cells near -1e30


@pytest.mark.parametrize("only_last,with_scores", [(True, True), (True, False), (False, True),
                                                   (False, False)])
def test_dgnns_log_ot_matches_impx_fp32(only_last, with_scores):
    jmodel, params, tmodel = _dgnns("float32")
    data = permuted_pairs(np.random.RandomState(0))
    kw = dict(only_last=only_last, with_scores=with_scores)
    ref = jmodel.produce_matches(params, {k: jnp.asarray(v) for k, v in data.items()}, **kw)
    out = tmodel.produce_matches(data, **kw)
    assert len(out["indices0"]) == (1 if only_last else SMALL["n_layers"])
    _assert_matches_equal(data, ref, out)


def test_dgnns_log_ot_matches_impx_bf16():
    jmodel, params, tmodel = _dgnns("bfloat16")
    data = permuted_pairs(np.random.RandomState(0))
    ref = jmodel.produce_matches(params, {k: jnp.asarray(v) for k, v in data.items()},
                                 only_last=True, with_scores=False)
    out = tmodel.produce_matches(data, only_last=True, with_scores=False)
    idx, ridx = out["indices0"][-1].numpy(), np.asarray(ref["indices0"][-1])
    assert (idx == ridx).mean() >= 0.97, (idx == ridx).mean()
    assert ((idx >= 0).sum(axis=1) >= data["valid0"].sum(axis=1) / 4).all()


# ---------------------------------------------------------------- SuperGlue
SG = dict(descriptor_dim=D, keypoint_encoder=(32, 64), n_layers=3, num_heads=4,
          sinkhorn_iterations=50, match_threshold=0.2, norm_fn="bn")


def superglue_pairs(rs):
    """permuted_pairs with descriptors twice as large: at unit scale random
    SuperGlue weights leave most true matches under the 0.2 threshold."""
    data = permuted_pairs(rs)
    for k in ("descriptors0", "descriptors1"):
        data[k] = 2 * data[k]
    return data


def _superglue_params(seed=0):
    """impx SuperGlue params with random batch-norm leaves."""
    jcfg = JaxConfig(**SG)
    params = jax.tree.map(np.array, JaxSuperGlue(jcfg).init(jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed + 10)
    params["kenc"] = _random_bn(rs, params["kenc"])
    for layer in params["gnn"]:
        layer["mlp"] = _random_bn(rs, layer["mlp"])
    return jcfg, params


def _superglue_pair(attn_impl, compute_dtype):
    jcfg, params = _superglue_params()
    jmodel = JaxSuperGlue(dataclasses.replace(jcfg, attn_impl=attn_impl, compute_dtype=compute_dtype))
    tcfg = MatcherConfig(**SG, compute_dtype=compute_dtype)
    tmodel = SuperGlue(tcfg, device="cpu", seed=1)
    tmodel.load_state_dict(params_from_jax(params, tcfg, sharing=False))
    return jmodel, jax.tree.map(jnp.asarray, params), tmodel


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_superglue_matches_impx_fp32(attn_impl):
    jmodel, params, tmodel = _superglue_pair(attn_impl, "float32")
    data = superglue_pairs(np.random.RandomState(1))
    ref = jmodel.produce_matches(params, {k: jnp.asarray(v) for k, v in data.items()})
    out = tmodel.produce_matches(data)
    assert len(out["indices0"]) == SG["n_layers"]
    _assert_matches_equal(data, ref, out)


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_superglue_matches_impx_bf16(attn_impl):
    jmodel, params, tmodel = _superglue_pair(attn_impl, "bfloat16")
    data = superglue_pairs(np.random.RandomState(1))
    ref = jmodel.produce_matches(params, {k: jnp.asarray(v) for k, v in data.items()}, only_last=True)
    out = tmodel.produce_matches(data, only_last=True)
    idx, ridx = out["indices0"][-1].numpy(), np.asarray(ref["indices0"][-1])
    assert (idx == ridx).mean() >= 0.97, (idx == ridx).mean()
    assert ((idx >= 0).sum(axis=1) >= data["valid0"].sum(axis=1) / 4).all()


def test_superglue_run_api_matches_impx():
    jmodel, params, tmodel = _superglue_pair("pallas", "float32")
    data = superglue_pairs(np.random.RandomState(2))
    feed = {"desc1": data["descriptors0"], "desc2": data["descriptors1"],
            "x1": np.concatenate([data["norm_keypoints0"], data["scores0"][..., None]], -1),
            "x2": np.concatenate([data["norm_keypoints1"], data["scores1"][..., None]], -1),
            "valid0": data["valid0"], "valid1": data["valid1"]}
    ref = jmodel.run(params, {k: jnp.asarray(v) for k, v in feed.items()})
    out = tmodel.run(feed)
    np.testing.assert_array_equal(out["indices0"][-1].numpy(), np.asarray(ref["indices0"][-1]))
    ok = padded_ok(data["valid0"], data["valid1"])
    np.testing.assert_allclose(out["p"].numpy()[ok], np.asarray(ref["p"])[ok], rtol=1e-4, atol=1e-5)


def test_superglue_weight_layouts_give_the_same_module():
    """params_from_jax and load_superglue_state_dict, fed the reference
    layout (impx's writer with the single final_proj renamed, which impx's
    own reader takes back to the same params), load identical modules, batch
    norm buffers included."""
    jcfg, params = _superglue_params(seed=3)
    state = matcher_state_dict(params, jcfg, sharing=False)
    for leaf in ("weight", "bias"):
        state[f"final_proj.{leaf}"] = state.pop(f"final_proj.0.{leaf}")
    back = jax.tree.map(np.asarray, convert_superglue_matcher(state, jcfg))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, r in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, r)

    tcfg = MatcherConfig(**SG)
    a, b = SuperGlue(tcfg, device="cpu", seed=1), SuperGlue(tcfg, device="cpu", seed=2)
    a.load_state_dict(params_from_jax(params, tcfg, sharing=False))
    b.load_state_dict(load_superglue_state_dict(state, tcfg))
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert len(a.final_proj) == 1 and sum(k.endswith("bn_var") for k in sa) == (
        len(SG["keypoint_encoder"]) + 2 * SG["n_layers"])
