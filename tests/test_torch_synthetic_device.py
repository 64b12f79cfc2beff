"""The port's device-side scene generator (impx_torch/data/synthetic_device.py)
against impx's (impx/data/synthetic_device.py) on the CPU: the construction
given impx's own draws, and the properties of tests/test_synthetic_device.py
on the port's draws."""
import numpy as np
import pytest

import jax
import torch

from impx.data.synthetic_device import synthesize_feed_device as jax_synthesize

from impx_torch.data.synthetic_device import DRAW_KEYS, draw_scene, feed_from_draws, synthesize_feed_device
from impx_torch.geometry.epipolar import sampson_distance, skew_symmetric

CPU = torch.device("cpu")
B, N, D = 4, 512, 64
TOL = 1e-5


def _impx_draws(key, batch, n_kpts, dim, inlier_frac, image_size=(480, 640)):
    """The arrays impx's generator draws from its twelve split keys
    (impx/data/synthetic_device.py:61-91), in DRAW_KEYS order."""
    h, w = image_size
    n_in = int(n_kpts * inlier_frac)
    n_out = n_kpts - n_in
    ks = jax.random.split(key, 12)
    k_axis, k_angle = jax.random.split(ks[0])
    dk = jax.random.split(ks[10], 4)
    sk = jax.random.split(ks[11], 2)
    normal, uniform = jax.random.normal, jax.random.uniform
    arrays = (normal(k_axis, (batch, 3)), uniform(k_angle, (batch,), minval=5.0, maxval=60.0),
              normal(ks[1], (batch, 3)), uniform(ks[2], (batch, n_in), minval=4.0, maxval=12.0),
              uniform(ks[3], (batch, n_in), minval=0.2 * w, maxval=0.8 * w),
              uniform(ks[4], (batch, n_in), minval=0.2 * h, maxval=0.8 * h),
              normal(ks[5], (batch, n_in, 2)), normal(ks[6], (batch, n_in, 2)),
              uniform(ks[7], (batch, n_out, 2)), uniform(ks[8], (batch, n_out, 2)),
              normal(ks[9], (batch, n_in, dim)), normal(dk[0], (batch, n_in, dim)), normal(dk[1], (batch, n_in, dim)),
              normal(dk[2], (batch, n_out, dim)), normal(dk[3], (batch, n_out, dim)),
              uniform(sk[0], (batch, n_kpts), minval=0.1, maxval=1.0),
              uniform(sk[1], (batch, n_kpts), minval=0.1, maxval=1.0))
    return {k: torch.as_tensor(np.array(a)) for k, a in zip(DRAW_KEYS, arrays)}


@pytest.fixture(scope="module")
def gen():
    return synthesize_feed_device(torch.Generator().manual_seed(0), B, N, D, device=CPU)


@pytest.mark.parametrize("inlier_frac", [0.25, 0.0])
def test_construction_equals_impx_given_its_draws(inlier_frac):
    key = jax.random.PRNGKey(3)
    feed, R, t = jax.jit(lambda k: jax_synthesize(k, 2, 96, 16, inlier_frac=inlier_frac))(key)
    got, gR, gt = feed_from_draws(_impx_draws(key, 2, 96, 16, inlier_frac))
    np.testing.assert_allclose(gR.numpy(), np.asarray(R), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(t), rtol=TOL, atol=TOL)
    assert sorted(got) == sorted(feed)
    for k, v in feed.items():
        assert got[k].dtype == (torch.bool if k.startswith("valid") else torch.float32), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=TOL, atol=TOL, err_msg=k)


def test_shapes_and_dtypes(gen):
    feed, R, t = gen
    assert feed["descriptors0"].shape == (B, N, D)
    assert feed["norm_keypoints0"].shape == feed["x1n"].shape == (B, N, 2)
    assert feed["scores1"].shape == (B, N) and feed["scores1"].dtype == torch.float32
    assert feed["valid0"].dtype == torch.bool and bool(feed["valid0"].all() and feed["valid1"].all())
    assert R.shape == (B, 3, 3) and t.shape == (B, 3)
    torch.testing.assert_close(R @ R.mT, torch.eye(3).expand(B, 3, 3), rtol=0, atol=1e-5)
    assert (torch.linalg.det(R) > 0.99).all()
    torch.testing.assert_close(torch.linalg.norm(t, dim=-1), torch.ones(B), rtol=0, atol=1e-5)


def test_epipolar_consistency(gen):
    """The inliers satisfy x1^T E x0 = 0 to pixel-noise level (E = [t]x R);
    the outliers do not."""
    feed, R, t = gen
    n_in = N // 4
    E = skew_symmetric(t) @ R
    for b in range(B):
        d_in = torch.sqrt(sampson_distance(feed["x0n"][b, :n_in], feed["x1n"][b, :n_in], E[b]))
        d_out = torch.sqrt(sampson_distance(feed["x0n"][b, n_in:], feed["x1n"][b, n_in:], E[b]))
        assert d_in.median() < 3e-3, d_in.median()
        assert d_out.median() > 30 * d_in.median()


def test_descriptor_correlation(gen):
    """True correspondences share descriptors (cosine about 0.99 at noise
    0.15); outliers are independent."""
    feed, _, _ = gen
    cos = (feed["descriptors0"] * feed["descriptors1"]).sum(-1)
    assert cos[:, :N // 4].mean() > 0.9
    assert abs(cos[:, N // 4:].mean()) < 0.1


def test_deterministic_for_a_generator_and_distinct_across_seeds():
    one = lambda seed: synthesize_feed_device(torch.Generator().manual_seed(seed), 1, 64, 16, device=CPU)  # noqa: E731
    a, b, c = one(1), one(1), one(2)
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    assert not torch.allclose(a[0]["descriptors0"], c[0]["descriptors0"])


def test_no_inliers_gives_a_valid_feed():
    """inlier_frac 0: no true correspondence, every array finite (impx's NaN
    baseline of the empty mean is never read)."""
    feed, R, t = synthesize_feed_device(torch.Generator().manual_seed(4), 2, 128, 32, inlier_frac=0.0, device=CPU)
    for k, v in feed.items():
        assert v.shape[:2] == (2, 128), k
        assert bool(torch.isfinite(v.float()).all()), k
    torch.testing.assert_close(torch.linalg.norm(feed["descriptors0"], dim=-1), torch.ones(2, 128))
    assert bool(torch.isfinite(R).all() and torch.isfinite(t).all())
    draws = draw_scene(torch.Generator().manual_seed(4), 2, 128, 32, inlier_frac=0.0, device=CPU)
    assert draws["z"].shape == (2, 0) and draws["out0"].shape == (2, 128, 2)
