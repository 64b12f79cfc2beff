"""The port's SuperPoint (impx_torch/models/superpoint.py) and its weight
converters against impx's, on the CPU.

impx's functions run under jax.jit on the same numpy inputs and the same
random weights (impx's init_params, carried to OIHW by
superpoint_params_from_jax). Tolerances: the backbone at fp32 within rtol
1e-4 / atol 1e-5 (the reference's own parity bound, tests/test_superpoint.py);
simple_nms and the top-K selection given equal dense maps exactly equal
(every one of the K slots, its keypoint and its valid bit, the tie order
included), the sampled descriptors within 1e-5; the whole extraction by
impx's margin rule (compare_extractions); the port's bf16 against its fp32
by impx's own bf16 test.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from impx.models import superpoint as jsp

from impx_torch.models import superpoint as sp
from impx_torch.models.superpoint import SuperPoint, compare_extractions
from impx_torch.tools.convert import (
    load_superpoint_checkpoint, load_superpoint_state_dict, superpoint_params_from_jax)

RTOL, ATOL = 1e-4, 1e-5
DESC_ATOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    """impx's random SuperPoint weights and the same weights in the port's layout."""
    params = jsp.init_params(jax.random.PRNGKey(0))
    return params, superpoint_params_from_jax(jax.tree.map(np.asarray, params))


@functools.lru_cache(maxsize=None)
def _jax_backbone():
    return jax.jit(jsp.backbone)


@pytest.mark.parametrize("h,w", [(64, 48), (61, 45)], ids=["64x48", "61x45"])
def test_backbone_matches_impx(weights, h, w):
    params, sd = weights
    img = np.random.RandomState(0).rand(1, h, w).astype(np.float32)
    js, jd = _jax_backbone()(params, jnp.asarray(img)[..., None])
    ts, td = sp.backbone(sd, torch.from_numpy(img)[:, None])
    assert ts.shape == js.shape == (1, -(-h // 8) * 8, -(-w // 8) * 8)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd).transpose(0, 3, 1, 2), rtol=RTOL, atol=ATOL)


def _tied_scores(rs, shape, levels=6):
    """Scores with many exact ties: a few levels, most cells 0."""
    s = rs.randint(0, levels, shape).astype(np.float32) / 100
    s[rs.rand(*shape) < 0.6] = 0
    return s


@pytest.mark.parametrize("kind", ["random", "tied"])
def test_simple_nms_equals_impx(kind):
    rs = np.random.RandomState(1)
    scores = rs.rand(2, 40, 37).astype(np.float32) if kind == "random" else _tied_scores(rs, (2, 40, 37))
    want = np.asarray(jax.jit(jsp.simple_nms, static_argnums=1)(jnp.asarray(scores), 4))
    got = sp.simple_nms(torch.from_numpy(scores), 4).numpy()
    np.testing.assert_array_equal(got, want)


def test_top_k_equals_lax_top_k_with_ties():
    rs = np.random.RandomState(2)
    flat = _tied_scores(rs, (3, 500))
    flat[1] = 0.0                                     # a row of ties only
    for k in (7, 200, 500):
        jv, ji = jax.lax.top_k(jnp.asarray(flat), k)
        tv, ti = sp.top_k(torch.from_numpy(flat), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_selection_given_equal_dense_maps_equals_impx(monkeypatch):
    """Both extract_keypoints on one dense score map and descriptor grid (the
    backbones replaced): every one of the K slots gives the same keypoint and
    valid bit, the zero-score slots in lax.top_k's tie order; the scores are
    equal and the sampled descriptors within 1e-5, keypoints within 8 px of
    the border included."""
    rs = np.random.RandomState(3)
    h, w, d, k = 56, 72, 32, 400
    scores = _tied_scores(rs, (2, h, w), levels=40) * 0.1
    desc = rs.randn(2, h // 8, w // 8, d).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    monkeypatch.setattr(jsp, "backbone", lambda params, image, compute_dtype=None: (
        jnp.asarray(scores), jnp.asarray(desc)))
    monkeypatch.setattr(sp, "backbone", lambda params, image, compute_dtype=None: (
        torch.from_numpy(scores), torch.from_numpy(desc.transpose(0, 3, 1, 2).copy())))
    image = np.zeros((2, h, w, 1), np.float32)
    select = jax.jit(functools.partial(jsp.extract_keypoints.__wrapped__, max_keypoints=k))
    want = select(None, jnp.asarray(image))
    got = sp.extract_keypoints(None, torch.from_numpy(image.transpose(0, 3, 1, 2)), max_keypoints=k)
    for name in ("keypoints", "valid", "scores"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    np.testing.assert_allclose(got["descriptors"].numpy(), np.asarray(want["descriptors"]), rtol=0,
                               atol=DESC_ATOL)
    valid, kp = got["valid"].numpy(), got["keypoints"].numpy()
    assert 0 < valid.sum() < valid.size                          # valid slots and zero-score slots
    near = (kp < 8) | (kp >= np.array([w, h]) - 8)
    assert (near.any(-1) & valid).sum() >= 5                      # keypoints within 8 px of the border


def test_sample_descriptors_near_the_border_matches_impx():
    """Keypoints on every edge and corner, where clipping replicates the edge
    cell (F.grid_sample's zero padding would differ there)."""
    rs = np.random.RandomState(4)
    hc, wc, d = 6, 9, 16
    grid = rs.randn(hc, wc, d).astype(np.float32)
    kp = np.concatenate([rs.rand(40, 2) * [wc * 8, hc * 8],
                         [[0, 0], [wc * 8 - 1, hc * 8 - 1], [0, hc * 8 - 1], [3.5, 20], [70, 2]]]).astype(np.float32)
    want = np.asarray(jax.jit(jsp.sample_descriptors)(jnp.asarray(kp), jnp.asarray(grid)))
    got = sp.sample_descriptors(torch.from_numpy(kp)[None], torch.from_numpy(grid.transpose(2, 0, 1))[None])
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=DESC_ATOL)


def test_extract_keypoints_matches_impx_by_the_margin_rule(weights):
    params, sd = weights
    img = np.random.RandomState(5).rand(1, 61, 45).astype(np.float32)
    want = jsp.extract_keypoints(params, jnp.asarray(img)[..., None], max_keypoints=128)
    got = sp.extract_keypoints(sd, torch.from_numpy(img)[:, None], max_keypoints=128)
    js, _ = _jax_backbone()(params, jnp.asarray(img)[..., None])
    ts, _ = sp.backbone(sd, torch.from_numpy(img)[:, None])
    margin = float(np.abs(ts.numpy() - np.asarray(js)).max())
    cmp = compare_extractions(got, {k: torch.from_numpy(np.array(v)) for k, v in want.items()}, margin)
    assert cmp["n"][0] > 10
    assert cmp["overlap"] >= 0.85 and not cmp["unexplained"], cmp
    assert cmp["min_cosine"] > 1 - 1e-5


def test_bf16_extraction_agrees_with_fp32():
    """impx's test_bf16_extraction_agrees_with_fp32 on the port: dense score
    drift under 0.15 of the span, keypoint overlap of at least 0.85, every
    disagreement at the other set's cutoff or an NMS neighbour, descriptor
    cosines above 0.995 at shared keypoints."""
    model = SuperPoint(device="cpu", seed=3)
    img = torch.from_numpy(np.random.RandomState(4).rand(1, 120, 160).astype(np.float32))
    s32, _ = model.backbone(img)
    s16, _ = model.backbone(img, compute_dtype=torch.bfloat16)
    span = float(s32.max() - s32.min()) + 1e-12
    margin = float((s32 - s16).abs().max())
    assert margin < 0.15 * span, (margin, span)
    out32 = model(img, max_keypoints=128)
    out16 = model(img, compute_dtype=torch.bfloat16, max_keypoints=128)
    cmp = compare_extractions(out32, out16, margin)
    assert cmp["n"][0] > 10
    assert cmp["overlap"] >= 0.85 and not cmp["unexplained"], cmp
    assert cmp["min_cosine"] > 0.995, cmp


def test_superpoint_module_init_follows_impx_plan():
    """The seeded init: impx's channel plan (OIHW here) and He-normal scale,
    zero biases; the same seed gives the same weights."""
    jax_shapes = {k: v["w"].shape for k, v in jsp.init_params(jax.random.PRNGKey(0)).items()}
    a, b = SuperPoint(device="cpu", seed=7), SuperPoint(device="cpu", seed=7)
    for name, (kh, kw, cin, cout) in jax_shapes.items():
        wt = getattr(a, name).weight
        assert wt.shape == (cout, cin, kh, kw), name
        assert torch.equal(wt, getattr(b, name).weight)
        assert not getattr(a, name).bias.any()
        assert abs(float(wt.detach().std()) / (2.0 / (kh * kw * cin)) ** 0.5 - 1) < 0.2, name


def test_weight_layouts_give_the_same_module(weights, tmp_path):
    """impx's pytree through superpoint_params_from_jax, and a .pth in the
    reference superpoint_v1.pth layout through load_superpoint_checkpoint,
    give one module: equal state_dicts and equal extractions."""
    params, sd = weights
    reference = {f"{n}.{leaf}": torch.from_numpy(np.array(
        np.transpose(np.asarray(params[n]["w"]), (3, 2, 0, 1)) if leaf == "weight" else params[n]["b"]))
        for n in params for leaf in ("weight", "bias")}
    path = tmp_path / "superpoint_v1.pth"
    torch.save(reference, path)
    loaded = load_superpoint_checkpoint(str(path))
    assert loaded.keys() == sd.keys()
    for k in sd:
        assert torch.equal(loaded[k], sd[k]), k
    a, b = SuperPoint(device="cpu", seed=1), SuperPoint(device="cpu", seed=2)
    a.load_state_dict(sd)
    b.load_state_dict(loaded)
    img = np.random.RandomState(6).rand(1, 48, 64).astype(np.float32)
    oa, ob = a(img, max_keypoints=32), b(img, max_keypoints=32)
    for k in oa:
        assert torch.equal(oa[k], ob[k]), k
    with pytest.raises(KeyError, match="conv1a.weight"):
        load_superpoint_state_dict({k: v for k, v in reference.items() if k != "conv1a.weight"})


def test_superpoint_phases_variants_agree_with_the_model():
    """impx_torch/tools/superpoint_phases.py's variants compute the model's
    backbone: the one-pass epilogue gives the two-pass one's bits, and the
    model's bf16 path is the channels-last variant, its fp32 path the NCHW one."""
    from impx_torch.tools import superpoint_phases as phases

    model = SuperPoint(device="cpu", seed=4)
    img = torch.from_numpy(np.random.RandomState(8).rand(2, 1, 40, 56).astype(np.float32))
    v = phases.VARIANTS
    for dtype, names in ((torch.bfloat16, ["channels-last, one-pass epilogue"]),
                         (torch.float32, ["NCHW, one-pass epilogue", "NCHW, two-pass epilogue"])):
        want = model.backbone(img, compute_dtype=dtype)
        for name in names:
            got = v[name](model.params(), img, dtype)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (name, dtype)
    two, one = (v[n](model.params(), img, torch.bfloat16) for n in ("NCHW, two-pass epilogue", "NCHW, one-pass epilogue"))
    assert all(torch.equal(a, b) for a, b in zip(two, one))
