"""The port's remaining inference routes against impx's on the CPU: the
dual-softmax head (`with_sinkhorn=False`) on the stacked paths, DGNNS with
batch norm, AdaGMN's masked loop `_iterate` (batch norm, log_ot, N0 != N1),
AdaGMN.pool and pool_masks from probability tensors, SuperGlue at N0 != N1,
GM's other entry points, and the eval CLI with --use_dual_softmax.

A 6-iteration matcher at D = 32 (keypoint encoder (16, 32), 4 heads, 10
Sinkhorn iterations; EIMP pools at iterations 3 and 5), B = 2 pairs that
overlap in part (tests/test_torch_kernels.py:overlap_pairs) at N = 48, or
with image 0 cut to 40 keypoints for N0 != N1. impx's params are carried
across by params_from_jax, with random batch-norm statistics
(tests/test_torch_logot.py:_random_bn); EIMP's dustbin score is raised so
that pooling drops keypoints. impx runs under jax.jit with attn_impl='xla'
(its default, the unrolled paths) or 'pallas' (the stacked scans, its
kernels interpreted). At fp32 indices0 and the keep masks are equal, plans
within 1e-5 and log plans within 1e-4 absolute on valid entries.

The one intended difference: under log_ot the port's `_iterate` pools on
the plan, exp of the log plan, where impx's pools on the log plan and so
never pools (ROADMAP section C; test_log_ot_pools_on_the_plan_not_the_log_plan).
"""
import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from impx.eval import eval_imp as jax_eval_imp
from impx.models import AdaGMN as JaxAdaGMN
from impx.models import DGNNS as JaxDGNNS
from impx.models import MatcherConfig as JaxConfig
from impx.models.superglue import SuperGlue as JaxSuperGlue
from impx.ops.sinkhorn import dual_softmax as jax_dual_softmax
from impx.tools.convert_torch import matcher_state_dict

from impx_torch.data.reader import StandardReader
from impx_torch.eval import eval_imp
from impx_torch.models import AdaGMN, DGNNS, MatcherConfig, SuperGlue
from impx_torch.ops.sinkhorn import dual_softmax
from impx_torch.tools.convert import load_reference_state_dict, params_from_jax

from impx.data.reader import StandardReader as JaxReader
from test_torch_eval import Args, EVAL_CONFIG, _assert_same_run, _recording, dataset  # noqa: F401
from test_torch_eval import SMALL as EVAL_SMALL
from test_torch_guards import tiny_eval_config  # noqa: F401
from test_torch_kernels import overlap_pairs
from test_torch_logot import _random_bn, padded_ok

B, N, N0, D = 2, 48, 40, 32
SMALL = dict(descriptor_dim=D, keypoint_encoder=(16, 32), n_layers=6, num_heads=4, sinkhorn_iterations=10,
             n_min_tokens=8, first_it_to_update=2)
BIN_SCORE = 4.0
PLAN_ATOL, LOG_PLAN_ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops dominate: one thread, as tests/test_torch_logot.py runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.no_grad():
        yield
    torch.set_num_threads(old)


def pairs(seed, n0=N):
    """overlap_pairs at N keypoints, image 0 cut to its first n0."""
    data = overlap_pairs(np.random.RandomState(seed), B, N, D, valid_share=0.7)
    data = {k: (v[:, :n0] if k.endswith("0") else v) for k, v in data.items()}
    for k in ("descriptors0", "descriptors1"):
        data[k] = 2 * data[k]
    return data


def _params(cls, norm_fn, bin_score=None, seed=0):
    """impx params of `cls` (numpy leaves), random batch-norm statistics."""
    params = jax.tree.map(np.array, cls(JaxConfig(**SMALL, norm_fn=norm_fn)).init(jax.random.PRNGKey(seed)))
    if norm_fn == "bn":
        rs = np.random.RandomState(seed + 10)
        params["kenc"] = _random_bn(rs, params["kenc"])
        for layer in params["gnn"]:
            layer["mlp"] = _random_bn(rs, layer["mlp"])
    if bin_score is not None:
        params["bin_score"] = np.float32(bin_score)
    return params


@pytest.fixture(scope="module")
def in_params():
    return _params(JaxDGNNS, "in")


@pytest.fixture(scope="module")
def bn_params():
    return _params(JaxDGNNS, "bn", seed=1)


@pytest.fixture(scope="module")
def eimp_in_params():
    return _params(JaxAdaGMN, "in", BIN_SCORE, seed=2)


@pytest.fixture(scope="module")
def eimp_bn_params():
    return _params(JaxAdaGMN, "bn", BIN_SCORE, seed=3)


def run_impx(cls, params, data, **cfg):
    """impx's produce_matches under jax.jit, every iteration collected."""
    model = cls(JaxConfig(**{**SMALL, **cfg}))
    fn = jax.jit(functools.partial(model.produce_matches, only_last=False))
    return fn(jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in data.items()})


def port(cls, params, sharing=True, **cfg):
    tcfg = MatcherConfig(**{**SMALL, **cfg})
    model = cls(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(params, tcfg, sharing=sharing))
    return model


def assert_same(ref, out, log=False):
    """Every iteration's indices0 equal and mscores0 within 1e-5; the last
    plan within PLAN_ATOL at every cell (invalid cells are 0 in both), or the
    last log plan within LOG_PLAN_ATOL where impx's is valid and below -1e29
    where it is not; the final keep masks equal."""
    assert len(out["indices0"]) == len(ref["indices0"])
    for it, (a, r) in enumerate(zip(out["indices0"], ref["indices0"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r), err_msg=f"iteration {it}")
    for it, (a, r) in enumerate(zip(out["mscores0"], ref["mscores0"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5, err_msg=f"iteration {it}")
    score, rscore = out["scores"][-1].numpy(), np.asarray(ref["scores"][-1])
    if log:
        ok = rscore > -1e29
        np.testing.assert_allclose(score[ok], rscore[ok], rtol=0, atol=LOG_PLAN_ATOL)
        assert (score[~ok] < -1e29).all() and (~ok).any()
    else:
        np.testing.assert_allclose(score, rscore, rtol=0, atol=PLAN_ATOL)
        assert (score == 0).any()
    if "keep0" in ref:
        for key in ("keep0", "keep1"):
            np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)
    assert ((out["indices0"][-1].numpy() >= 0).sum(axis=1) >= 4).all()   # real match sets


def dropped(out, data):
    """Keypoints pooled away per image, over the batch."""
    return [int(data[f"valid{i}"].sum() - out[f"keep{i}"].numpy().sum()) for i in (0, 1)]


# ------------------------------------------------------------------ dual softmax
def test_dual_softmax_matches_impx():
    rs = np.random.RandomState(0)
    dist = (rs.randn(2, 30, 22) * 2).astype(np.float32)
    valid0, valid1 = np.arange(30)[None] < np.array([[24], [30]]), np.arange(22)[None] < np.array([[22], [15]])
    ref = np.asarray(jax.jit(jax_dual_softmax)(*(jnp.asarray(x) for x in (dist, 0.7, valid0, valid1))))
    out = dual_softmax(*(torch.as_tensor(x) for x in (dist, np.float32(0.7), valid0, valid1))).numpy()
    ok = padded_ok(valid0, valid1)
    np.testing.assert_allclose(out[ok], ref[ok], rtol=0, atol=PLAN_ATOL)
    assert (out[~ok] == 0).all() and (ref[~ok] == 0).all()
    # each cell is its row softmax times its column softmax: rows and columns sum to at most 1
    assert (out.sum(axis=2) <= 1 + 1e-6).all() and (out.sum(axis=1) <= 1 + 1e-6).all()


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"], ids=["impx-scan", "impx-unrolled"])
def test_dgnns_dual_softmax_stacked_matches_impx(in_params, attn_impl):
    """The port's stacked forward with the dual-softmax head against impx's
    scan (its kernels interpreted) and its unrolled GM forward."""
    data = pairs(1)
    ref = run_impx(JaxDGNNS, in_params, data, norm_fn="in", with_sinkhorn=False, attn_impl=attn_impl)
    model = port(DGNNS, in_params, norm_fn="in", with_sinkhorn=False)
    assert_same(ref, model.produce_matches(data))
    last = model.produce_matches(data, only_last=True, with_scores=True)
    np.testing.assert_array_equal(last["indices0"][0].numpy(), np.asarray(ref["indices0"][-1]))
    np.testing.assert_allclose(last["scores"][0].numpy(), np.asarray(ref["scores"][-1]), rtol=0, atol=PLAN_ATOL)


@pytest.mark.parametrize("compaction", [(), ((4, 40),)], ids=["mask-only", "compacted"])
def test_eimp_dual_softmax_matches_impx(eimp_in_params, compaction):
    data = pairs(2)
    ref = run_impx(JaxAdaGMN, eimp_in_params, data, norm_fn="in", with_sinkhorn=False, attn_impl="pallas",
                   compaction=compaction)
    out = port(AdaGMN, eimp_in_params, norm_fn="in", with_sinkhorn=False,
               compaction=compaction).produce_matches(data)
    if compaction:
        assert out["scores"] == [None] and not out["overflow0"].any()
        for i, (a, r) in enumerate(zip(out["indices0"], ref["indices0"])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(r), err_msg=f"iteration {i}")
        for key in ("keep0", "keep1"):
            np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)
    else:
        assert_same(ref, out)
    assert min(dropped(out, data)) > 0


# ------------------------------------------------------------------ batch norm
@pytest.mark.parametrize("n0", [N, N0], ids=["N0=N1", "N0!=N1"])
def test_dgnns_batch_norm_matches_impx(bn_params, n0):
    """impx sends DGNNS with norm_fn='bn' to GM's unrolled forward; so does the
    port, stacked when N0 == N1."""
    data = pairs(3, n0)
    ref = run_impx(JaxDGNNS, bn_params, data, norm_fn="bn")
    model = port(DGNNS, bn_params, norm_fn="bn")
    assert not model.training
    assert_same(ref, model.produce_matches(data))


def test_batch_norm_weights_of_a_sharing_model_carry_through_the_reference_layout(bn_params):
    """load_reference_state_dict of impx's writer's layout and params_from_jax
    give the same module, the running statistics of the keypoint encoder and
    of every layer's MLP (shared layers too) included."""
    jcfg = JaxConfig(**SMALL, norm_fn="bn")
    state = matcher_state_dict(jax.tree.map(jnp.asarray, bn_params), jcfg, sharing=True)
    a = port(DGNNS, bn_params, norm_fn="bn")
    b = DGNNS(MatcherConfig(**SMALL, norm_fn="bn"), device="cpu", seed=5)
    b.load_state_dict(load_reference_state_dict(state, b.config, sharing=True))
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    stats = [k for k in sa if k.endswith("bn_mean")]
    assert len(stats) == len(SMALL["keypoint_encoder"]) + 2 * SMALL["n_layers"]
    assert any(a.gnn[int(k.split(".")[1])].shared for k in stats if k.startswith("gnn."))


# ------------------------------------------------------------------ AdaGMN._iterate
@pytest.mark.parametrize("norm_fn,n0", [("in", N0), ("bn", N)], ids=["in-N0!=N1", "bn-N0=N1"])
def test_eimp_masked_loop_matches_impx(eimp_in_params, eimp_bn_params, norm_fn, n0):
    """impx's default attn_impl runs EIMP through `_iterate`; the port routes
    batch norm and N0 != N1 there too. Pooling drops keypoints in both."""
    params = eimp_in_params if norm_fn == "in" else eimp_bn_params
    data = pairs(4, n0)
    ref = run_impx(JaxAdaGMN, params, data, norm_fn=norm_fn)
    out = port(AdaGMN, params, norm_fn=norm_fn).produce_matches(data)
    assert_same(ref, out)
    assert min(dropped(out, data)) > 0


def test_eimp_masked_loop_under_log_ot_matches_impx_without_pooling(eimp_in_params):
    """n_min_tokens above N: neither package pools, so the loops agree."""
    data = pairs(5)
    cfg = dict(norm_fn="in", log_ot=True, n_min_tokens=N)
    ref = run_impx(JaxAdaGMN, eimp_in_params, data, **cfg)
    out = port(AdaGMN, eimp_in_params, **cfg).produce_matches(data)
    assert_same(ref, out, log=True)
    assert dropped(out, data) == [0, 0]


def test_log_ot_pools_on_the_plan_not_the_log_plan(eimp_in_params, monkeypatch):
    """impx's `_iterate` hands the log plan to its pooling rule, whose row and
    column sums are then <= 0 and never reach mscore_th: it keeps every valid
    keypoint. The port pools on exp of the log plan: its keep masks after
    the first pool equal impx's own pool_masks handed jnp.exp of the same log
    plan and the same (q, k) states."""
    data = pairs(6)
    cfg = dict(norm_fn="in", log_ot=True)
    ref = run_impx(JaxAdaGMN, eimp_in_params, data, **cfg)
    for i in (0, 1):
        np.testing.assert_array_equal(np.asarray(ref[f"keep{i}"]), data[f"valid{i}"])

    model = port(AdaGMN, eimp_in_params, **cfg)
    seen = {}

    def score_recorded(*a, _orig=model.compute_score):
        seen["score"] = _orig(*a)
        return seen["score"]

    def masses_recorded(qk_self, qk_cross, keep0, keep1, *rest, _orig=model._key_masses):
        seen.setdefault("pool", (seen["score"], qk_self, qk_cross, keep0, keep1))
        return _orig(qk_self, qk_cross, keep0, keep1, *rest)

    def pool_recorded(*a, _orig=model._pool_from_masses):
        out = _orig(*a)
        seen.setdefault("keeps", out)
        return out

    monkeypatch.setattr(model, "compute_score", score_recorded)
    monkeypatch.setattr(model, "_key_masses", masses_recorded)
    monkeypatch.setattr(model, "_pool_from_masses", pool_recorded)
    out = model.produce_matches(data)
    assert min(dropped(out, data)) > 0

    log_plan, (qs, ks), (qc, kc), keep0, keep1 = seen["pool"]
    J = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    state = lambda q, k, rows: {"q": J(q[rows]), "k": J(k[rows])}  # noqa: E731
    first, second = slice(0, B), slice(B, 2 * B)
    want = JaxAdaGMN(JaxConfig(**SMALL, **cfg)).pool_masks(
        jnp.exp(J(log_plan)), state(qs, ks, first), state(qc, kc, second), state(qs, ks, second),
        state(qc, kc, first), J(keep0), J(keep1), qmask0=jnp.asarray(data["valid0"]),
        qmask1=jnp.asarray(data["valid1"]))
    for got, w in zip(seen["keeps"], want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    assert sum(k.sum() for k in seen["keeps"]) < keep0.sum() + keep1.sum()     # the first pool drops some


# ------------------------------------------------------------------ pooling API
def _probs(rs, b, nq, nk, h=4):
    p = rs.rand(b, h, nq, nk).astype(np.float32) ** 4
    return p / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("n1", [48, 44], ids=["N0=N1", "N0!=N1"])
def test_pool_and_pool_masks_from_probabilities_match_impx(n1):
    rs = np.random.RandomState(7)
    n0 = 48
    plan = (rs.rand(B, n0 + 1, n1 + 1) * 0.2 / np.sqrt(n0 * n1)).astype(np.float32)
    probs = [_probs(rs, B, nq, nk) for nq, nk in ((n0, n0), (n1, n0), (n1, n1), (n0, n1))]
    keep0, keep1 = rs.rand(B, n0) > 0.2, rs.rand(B, n1) > 0.2
    qmask0, qmask1 = keep0 | (rs.rand(B, n0) > 0.5), keep1 | (rs.rand(B, n1) > 0.5)
    jm, tm = JaxAdaGMN(JaxConfig(**SMALL)), AdaGMN(MatcherConfig(**SMALL), device="cpu")
    J, T = (lambda x: jnp.asarray(x)), torch.from_numpy
    kw = dict(mscore_th=0.1, uncertainty_ratio=1.0, n_min_tokens=4)
    ref = jm.pool_masks(J(plan), *map(J, probs), J(keep0), J(keep1), **kw, qmask0=J(qmask0), qmask1=J(qmask1))
    out = tm.pool_masks(T(plan), *map(T, probs), T(keep0), T(keep1), **kw, qmask0=T(qmask0), qmask1=T(qmask1))
    for o, r, keep in zip(out, ref, (keep0, keep1)):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        assert 0 < o.numpy().sum() < keep.sum()
    for keeps in ({}, dict(keep0=keep0, keep1=keep1)):
        ref = jm.pool(J(plan), *map(J, probs), **{k: J(v) for k, v in keeps.items()}, n_min_tokens=4)
        out = tm.pool(T(plan), *map(T, probs), **{k: T(v) for k, v in keeps.items()}, n_min_tokens=4)
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    assert DGNNS(MatcherConfig(**SMALL), device="cpu").pool(T(plan), *map(T, probs)) == (None, None)


# ------------------------------------------------------------------ SuperGlue
@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_superglue_with_unequal_counts_matches_impx(attn_impl):
    params = _params(JaxSuperGlue, "bn", seed=8)
    data = pairs(9, N0)
    ref = run_impx(JaxSuperGlue, params, data, norm_fn="bn", attn_impl=attn_impl)
    out = port(SuperGlue, params, sharing=False, norm_fn="bn").produce_matches(data)
    assert_same(ref, out, log=True)


# ------------------------------------------------------------------ entry points
def test_produce_matches_test_and_call_match_impx(in_params):
    """produce_matches_test (the reference's alias) and the module's call in
    mode 0 (produce_matches) and mode 1 (run) against impx's; training=True
    goes to forward_train."""
    data = pairs(10)
    jm = JaxDGNNS(JaxConfig(**SMALL, norm_fn="in"))
    jp = jax.tree.map(jnp.asarray, in_params)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    model = port(DGNNS, in_params, norm_fn="in")
    ref = jax.jit(lambda p, d: jm(p, d, mode=0))(jp, jdata)
    for out in (model(data), model(data, mode=0), model.produce_matches_test(data)):
        assert_same(ref, out)
    out = model.produce_matches_test(data, only_last=True)
    np.testing.assert_array_equal(out["indices0"][0].numpy(), np.asarray(ref["indices0"][-1]))
    feed = {"desc1": data["descriptors0"], "desc2": data["descriptors1"],
            "x1": np.concatenate([data["norm_keypoints0"], data["scores0"][..., None]], -1),
            "x2": np.concatenate([data["norm_keypoints1"], data["scores1"][..., None]], -1),
            "valid0": data["valid0"], "valid1": data["valid1"]}
    ref = jax.jit(lambda p, d: jm(p, d, mode=1))(jp, {k: jnp.asarray(v) for k, v in feed.items()})
    out = model(feed, mode=1)
    np.testing.assert_array_equal(out["indices0"].numpy(), np.asarray(ref["indices0"]))
    np.testing.assert_allclose(out["mscores0"].numpy(), np.asarray(ref["mscores0"]), atol=1e-5)
    gt = np.zeros((B, N + 1, N + 1), np.float32)
    gt[:, :-1, -1] = gt[:, -1, :-1] = 1                  # every keypoint unmatched
    with torch.enable_grad():
        train = model({**data, "matching_mask": gt}, training=True)
    assert set(train) >= {"loss", "matches0"} and bool(torch.isfinite(train["loss"]))


# ------------------------------------------------------------------ the eval CLI
def _eval_models(params_seed=0):
    jm = jax_eval_imp.build_model("IMP", "spp", use_sinkhorn=False, n_layers=3, attn_impl="pallas")
    jm.config = dataclasses.replace(jm.config, **EVAL_SMALL)
    params = jm.init(jax.random.PRNGKey(params_seed))
    tm = eval_imp.build_model("IMP", "spp", use_sinkhorn=False, n_layers=3, device="cpu")
    assert not tm.config.with_sinkhorn
    tm = DGNNS(dataclasses.replace(tm.config, **EVAL_SMALL), device="cpu")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.array, params), tm.config))
    return jm, params, tm


def test_evaluate_with_dual_softmax_matches_impx(dataset, monkeypatch):  # noqa: F811
    """evaluate with the model of --use_dual_softmax: equal matches,
    precision and matching score, pose errors as tests/test_torch_eval.py
    holds them (cv2 backend on both sides)."""
    jm, params, tm = _eval_models()
    ref_log = _recording(jax_eval_imp, monkeypatch)
    ref = jax_eval_imp.evaluate(jm, params, JaxReader(dataset), 1.0, EVAL_CONFIG, Args(eval_batch=4))
    log = _recording(eval_imp, monkeypatch)
    out = eval_imp.evaluate(tm, StandardReader(dataset), 1.0, EVAL_CONFIG, Args(eval_batch=4))
    _assert_same_run(ref_log, ref, log, out)


def test_dual_softmax_flag_runs_the_cli(tiny_eval_config, monkeypatch):  # noqa: F811
    """main with --use_dual_softmax, non-iterative and --use_iterative: the
    model it builds has the dual-softmax head, and every pair is scored."""
    built = []
    orig = eval_imp.build_model

    def recording(*a, **k):
        built.append(orig(*a, **k))
        return built[-1]

    monkeypatch.setattr(eval_imp, "build_model", recording)
    for flags in ([], ["--use_iterative", "--ransac_hypotheses", "32"]):
        res = eval_imp.main(["--device", "cpu", "--config_path", tiny_eval_config, "--layers", "4", "--bucket",
                             "64", "--use_dual_softmax", *flags])
        assert not built[-1].config.with_sinkhorn
        assert res["precision"] >= 0 and 1 <= res["mean_stop_iteration"] <= 4
