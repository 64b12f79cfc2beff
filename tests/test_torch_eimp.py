"""The port's AdaGMN (EIMP) against impx's on the CPU, with the same weights
carried across by params_from_jax.

Small config: D = 64, keypoint_encoder (32, 64), 6 layers (pooling at the
shared iterations 3 and 5), N = 256, B = 2, n_min_tokens = 16. impx runs with
attn_impl='pallas', its kernels interpreted on the CPU.

The pairs overlap in part (tests/test_torch_kernels.py:overlap_pairs). About a
third of the keypoints are valid, scattered, and the two images differ. So
some keypoints match, the rest can be pooled away, and every survivor fits a
128 bucket.
"""
import collections

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from impx.models import AdaGMN as JaxAdaGMN
from impx.models import MatcherConfig as JaxConfig
from impx.models.adgm import masked_median as jax_masked_median
from impx.ops.pallas.attention import attention_key_mass as jax_key_mass
from impx.tools.convert_torch import matcher_state_dict

from impx_torch.models import AdaGMN, MatcherConfig
from impx_torch.models.adgm import masked_median
from impx_torch.ops.kernels import attention as kernels_attention
from impx_torch.ops.kernels.attention import attention_key_mass
from impx_torch.tools.convert import load_reference_state_dict, params_from_jax

from test_torch_kernels import overlap_pairs

B, N, D = 2, 256, 64
SMALL = dict(descriptor_dim=D, keypoint_encoder=(32, 64), n_layers=6, num_heads=4, norm_fn="in",
             n_min_tokens=16, first_it_to_update=2)
BIN_SCORE = 6.0
# compaction points at iterations whose layers recompute q/k (not shared)
FRESH_SCHEDULES = [((4, 128),), ((2, 128), (4, 64))]


@pytest.fixture(scope="module")
def weights():
    """Random weights with the dustbin score raised from its initial 1.0 to
    BIN_SCORE: at 1.0 every row's plan mass stays above mscore_th and pooling
    has nothing to drop."""
    params = JaxAdaGMN(JaxConfig(**SMALL)).init(jax.random.PRNGKey(0))
    params = {**params, "bin_score": jnp.full_like(params["bin_score"], BIN_SCORE)}
    return params, params_from_jax(jax.tree.map(np.array, params), MatcherConfig(**SMALL))


@pytest.fixture(scope="module")
def data():
    return overlap_pairs(np.random.RandomState(0), B, N, D, valid_share=0.35)


def _impx(params, data, compute_dtype="float32", compaction=(), **kw):
    model = JaxAdaGMN(JaxConfig(**SMALL, attn_impl="pallas", compute_dtype=compute_dtype,
                                compaction=compaction))
    return model.produce_matches(params, {k: jnp.asarray(v) for k, v in data.items()},
                                 only_last=False, **kw)


def _port(state_dict, data, compute_dtype="float32", compaction=(), **kw):
    model = AdaGMN(MatcherConfig(**SMALL, compute_dtype=compute_dtype, compaction=compaction),
                   device="cpu")
    model.load_state_dict(state_dict)
    return model.produce_matches(data, only_last=False, **kw)


def _assert_same(ref, out, rows=None):
    """Every iteration's indices0 equal, mscores0 within 1e-5 (fp32
    summation order) on `rows` (default all), final keep masks equal."""
    assert len(out["indices0"]) == len(ref["indices0"]) == SMALL["n_layers"]
    for it, (a, r) in enumerate(zip(out["indices0"], ref["indices0"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r), err_msg=f"iteration {it}")
    rows = np.s_[:] if rows is None else rows
    for it, (a, r) in enumerate(zip(out["mscores0"], ref["mscores0"])):
        np.testing.assert_allclose(a.numpy()[rows], np.asarray(r)[rows], atol=1e-5,
                                   err_msg=f"iteration {it}")
    for key in ("keep0", "keep1"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)


@pytest.fixture(scope="module")
def mask_only_fp32(weights, data):
    params, sd = weights
    return _impx(params, data, with_scores=True), _port(sd, data, with_scores=True)


# --------------------------------------------------------------- the kernel
@pytest.mark.parametrize("dtype,masked", [("float32", True), ("bfloat16", True), ("float32", False)])
def test_attention_key_mass_matches_impx(dtype, masked):
    """A padded, a random and a fully masked key mask (batch 2: every query
    spreads 1/Nk over all keys); a query mask with zeros; Nq != Nk."""
    rs = np.random.RandomState(1)
    b, h, nq, nk, dh = 3, 4, 64, 40, 32
    q, k = rs.randn(b, h, nq, dh).astype(np.float32), rs.randn(b, h, nk, dh).astype(np.float32)
    key_mask = np.zeros((b, nk), bool)
    key_mask[0, :30] = True
    key_mask[1] = rs.rand(nk) > 0.4
    query_mask = rs.rand(b, nq) > 0.3
    masks = (key_mask, query_mask) if masked else (None, None)
    ref = jax_key_mass(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
                       *(None if m is None else jnp.asarray(m) for m in masks), interpret=True)
    tdtype = getattr(torch, dtype)
    out = attention_key_mass(torch.from_numpy(q).to(tdtype), torch.from_numpy(k).to(tdtype),
                             *(None if m is None else torch.from_numpy(m) for m in masks))
    assert out.dtype == torch.float32 and out.shape == (b, nk)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    if masked:
        np.testing.assert_allclose(out[2].numpy(), query_mask[2].sum() * h / nk, rtol=1e-5)


def test_masked_median_equals_impx():
    rs = np.random.RandomState(2)
    values = rs.randint(0, 6, size=(5, 9)).astype(np.float32)  # ties
    mask = rs.rand(5, 9) > 0.5
    mask[0] = False                                            # empty: +inf
    mask[1] = np.arange(9) == 4                                # one element
    mask[2] = True                                             # odd count
    mask[3] = np.arange(9) < 6                                 # even count: the lower one
    out = masked_median(torch.from_numpy(values), torch.from_numpy(mask)).numpy()
    ref = np.asarray(jax_masked_median(jnp.asarray(values), jnp.asarray(mask)))
    np.testing.assert_array_equal(out, ref)
    assert out[0] == np.inf and out[1] == values[1, 4]


def _pool_masks_equal_impx(n0, n1):
    """One pooling step from a plan and the four (q, k) states: about half
    the rows and columns fall under mscore_th, and the attention masses
    decide which of them stay."""
    rs = np.random.RandomState(3)
    b, h, dh = 2, 4, 16
    plan = (rs.rand(b, n0 + 1, n1 + 1) * 0.2 / np.sqrt(n0 * n1)).astype(np.float32)
    states = [(rs.randn(b, h, nq, dh).astype(np.float32), rs.randn(b, h, nk, dh).astype(np.float32))
              for nq, nk in ((n0, n0), (n1, n0), (n1, n1), (n0, n1))]   # s00, s01, s11, s10
    keep0, keep1 = rs.rand(b, n0) > 0.2, rs.rand(b, n1) > 0.2
    qmask0, qmask1 = keep0 | (rs.rand(b, n0) > 0.5), keep1 | (rs.rand(b, n1) > 0.5)
    kw = dict(mscore_th=0.1, uncertainty_ratio=1.0, n_min_tokens=4)
    ref = JaxAdaGMN(JaxConfig(**SMALL)).pool_masks(
        jnp.asarray(plan), *({"q": jnp.asarray(q), "k": jnp.asarray(k)} for q, k in states),
        *(jnp.asarray(m) for m in (keep0, keep1)), **kw,
        qmask0=jnp.asarray(qmask0), qmask1=jnp.asarray(qmask1))
    model = AdaGMN(MatcherConfig(**SMALL), device="cpu")
    out = model.pool_masks(torch.from_numpy(plan), *(tuple(map(torch.from_numpy, s)) for s in states),
                           torch.from_numpy(keep0), torch.from_numpy(keep1), **kw,
                           qmask0=torch.from_numpy(qmask0), qmask1=torch.from_numpy(qmask1))
    for o, r, keep in zip(out, ref, (keep0, keep1)):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        assert 0 < o.numpy().sum() < keep.sum()


def test_pool_masks_from_qk_states_equals_impx():
    _pool_masks_equal_impx(48, 48)


def test_pool_masks_with_unequal_keypoint_counts_equals_impx():
    """N0 != N1: the states do not stack, and each direction takes its own
    launch, as impx's _masses_from_qk does."""
    _pool_masks_equal_impx(48, 44)


# -------------------------------------------------------------- the matcher
def test_mask_only_fp32_equals_impx(mask_only_fp32, data):
    ref, out = mask_only_fp32
    _assert_same(ref, out)
    np.testing.assert_allclose(out["scores"][-1].numpy(), np.asarray(ref["scores"][-1]),
                               rtol=1e-4, atol=1e-5)
    # not trivial: pooling removed keypoints, and keypoints match
    removed = [data[f"valid{i}"].sum(axis=1) - out[f"keep{i}"].numpy().sum(axis=1) for i in (0, 1)]
    assert min(removed[0].min(), removed[1].min()) > 0, removed
    assert ((out["indices0"][-1].numpy() >= 0).sum(axis=1) >= 5).all()


def test_pooling_takes_the_row_lse_of_its_layers(weights, data, monkeypatch):
    """The kernel path's route, through the wrappers' plain bodies on the
    CPU: per call, the two layers of each pooling iteration (3 and 5) run the
    lse forward (kernel 4's plain version) and the four key masses take its
    lse (the plain mass from lse, never the two-pass one); the other eight
    layers run kernel 1's plain version."""
    calls = collections.Counter()
    for name in ("mha_reference", "mha_lse_reference", "attention_key_mass_from_lse_reference",
                 "attention_key_mass_reference"):
        def counted(*args, _name=name, _fn=getattr(kernels_attention, name)):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(kernels_attention, name, counted)
    model = AdaGMN(MatcherConfig(**SMALL), device="cpu")
    model.load_state_dict(weights[1])
    model.produce_matches(data, only_last=True, with_scores=False)
    assert calls == {"mha_reference": 8, "mha_lse_reference": 4, "attention_key_mass_from_lse_reference": 4}


def test_run_api_matches_impx(weights, data, mask_only_fp32):
    """AdaGMN.run (inherited from DGNNS: p = match_threshold, the last
    iteration) gives impx's last-iteration matches."""
    model = AdaGMN(MatcherConfig(**SMALL), device="cpu")
    model.load_state_dict(weights[1])
    feed = {"desc1": data["descriptors0"], "desc2": data["descriptors1"],
            "x1": np.concatenate([data["norm_keypoints0"], data["scores0"][..., None]], -1),
            "x2": np.concatenate([data["norm_keypoints1"], data["scores1"][..., None]], -1),
            "valid0": data["valid0"], "valid1": data["valid1"]}
    out = model.run(feed)
    np.testing.assert_array_equal(out["indices0"].numpy(), np.asarray(mask_only_fp32[0]["indices0"][-1]))


@pytest.mark.parametrize("schedule", FRESH_SCHEDULES, ids=str)
def test_compact_fp32_equals_impx_compact(weights, data, schedule):
    """At compaction points where the layers recompute q/k, the port's
    compacted path equals impx's, overflow counts included."""
    share = MatcherConfig(**SMALL).sharing_layers(True)
    assert not any(share[2 * it] or share[2 * it + 1] for it, _ in schedule)
    params, sd = weights
    ref, out = _impx(params, data, compaction=schedule), _port(sd, data, compaction=schedule)
    _assert_same(ref, out)
    assert out["scores"] == [None]
    for key in ("overflow0", "overflow1"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)


def test_compact_at_a_shared_iteration_equals_mask_only(weights, data, mask_only_fp32):
    """Compaction before iteration 3, which shares attention: the gathered
    carried q/k must be the right images' (impx/models/fast.py:875-877
    promises equality with the mask-only path while nothing has been
    discarded before a gather; impx's own gather breaks it here)."""
    share = MatcherConfig(**SMALL).sharing_layers(True)
    assert share[6] and share[7]                      # iteration 3 shares
    assert max(data["valid0"].sum(axis=1).max(), data["valid1"].sum(axis=1).max()) <= 128
    ref = mask_only_fp32[0]
    out = _port(weights[1], data, compaction=((3, 128),))
    # mscores0 on valid rows: at the invalid rows left out of the gather the
    # compacted path reports 0 where the mask-only path may report the -1 fill
    _assert_same(ref, out, rows=data["valid0"])
    assert not out["overflow0"].any() and not out["overflow1"].any()


@pytest.mark.parametrize("seed,n_valid,want0,want1", [
    (5, [256, 256], [192, 192], [192, 192]), (6, [100, 40], [36, 0], None)])
def test_compact_overflow_counts(weights, seed, n_valid, want0, want1):
    """The counts of tests/test_eimp_compact.py:72-87: before iteration 1
    nothing is pooled yet, so a 64 bucket drops every valid keypoint past 64."""
    rs = np.random.RandomState(seed)
    valid = np.arange(N)[None] < np.asarray(n_valid)[:, None]
    data = {"descriptors0": rs.randn(B, N, D), "descriptors1": rs.randn(B, N, D),
            "norm_keypoints0": rs.rand(B, N, 2) - 0.5, "norm_keypoints1": rs.rand(B, N, 2) - 0.5,
            "scores0": rs.rand(B, N), "scores1": rs.rand(B, N), "valid0": valid, "valid1": valid}
    out = _port(weights[1], data, compaction=((1, 64),))
    np.testing.assert_array_equal(out["overflow0"].numpy(), want0)
    if want1 is not None:
        np.testing.assert_array_equal(out["overflow1"].numpy(), want1)
    assert out["indices0"][-1].shape == (B, N)


def test_mask_only_bf16_within_tolerance(weights, data):
    """bf16 rounds at other places in XLA and PyTorch, and a pooling decision
    near a median or the threshold can flip: we require 97% of the last
    indices0 and 98% of the valid keypoints' keep masks equal."""
    params, sd = weights
    ref = _impx(params, data, compute_dtype="bfloat16", with_scores=False)
    out = _port(sd, data, compute_dtype="bfloat16", with_scores=False)
    idx, ridx = out["indices0"][-1].numpy(), np.asarray(ref["indices0"][-1])
    assert (idx == ridx).mean() >= 0.97, (idx == ridx).mean()
    for i in (0, 1):
        valid = data[f"valid{i}"]
        same = out[f"keep{i}"].numpy()[valid] == np.asarray(ref[f"keep{i}"])[valid]
        assert same.mean() >= 0.98, (i, same.mean())
    assert out["scores"] == [None]


def test_weight_layouts_give_the_same_adagmn():
    """params_from_jax of impx's AdaGMN and load_reference_state_dict of its
    reference layout load identical weights (EIMP's are DGNNS's)."""
    jcfg = JaxConfig(**SMALL)
    params = JaxAdaGMN(jcfg).init(jax.random.PRNGKey(3))
    tcfg = MatcherConfig(**SMALL)
    a, b = AdaGMN(tcfg, device="cpu", seed=1), AdaGMN(tcfg, device="cpu", seed=2)
    a.load_state_dict(params_from_jax(jax.tree.map(np.array, params), tcfg))
    b.load_state_dict(load_reference_state_dict(matcher_state_dict(params, jcfg, sharing=True), tcfg))
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
