"""The port's fundamental-matrix RANSAC (impx_torch/ransac/fundamental.py)
and FMBenchEval's device backend against impx on the CPU.

Pixel correspondences from impx_torch.data.synthetic.synthesize_pair (640 x
480, its true F): its true correspondences, plus random pairings of its
outlier keypoints for 30% outliers. impx's functions run under jax.jit.
  * Hartley normalisation, the eight-point F and the symmetric epipolar
    distance: within 1e-5;
  * the cubic's roots, and the 7-point candidate sets up to sign, within
    1e-4 (the candidates: plus the null space's float32 conditioning bound)
    on the well-conditioned samples, those where impx's float32 solve lies
    within 2e-5 of a float64 one (the null space and the cubic are
    ill-conditioned on some samples in both packages, as the five-point
    chain is, tests/test_torch_five_point.py); every valid port candidate
    meets its epipolar residual and has rank 2 on every sample;
  * `fundamental_ransac_from_samples` on impx's draws: F up to sign within
    1e-4 and the same inlier mask as impx's estimate_fundamental_ransac, but
    at points within float32's uncertainty of the 1 px threshold;
  * `estimate_fundamental_ransac` recovers F on synthetic pairs with 30%
    outliers, and FMBenchEval's device backend runs beside its cv2 one on
    the same pairs.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from impx.ransac import fundamental as jf
from impx.ransac import ransac as jr

from impx_torch.data.synthetic import synthesize_pair
from impx_torch.eval.evaluator import FMBenchEval
from impx_torch.ransac import fundamental as tf
from impx_torch.ransac.eight_point import _design_matrix

from test_torch_five_point import _set_distance

T = torch.as_tensor
J = jnp.asarray
CAND_ATOL = 1e-4
WELL_CONDITIONED = 2e-5
OUTLIER_SHARE = 0.3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops dominate: one thread, as tests/test_torch_logot.py runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def pixel_pair(seed, n_inliers=200, pixel_noise=0.5):
    """(x0, x1 [n, 2] float32 pixels, the true F, the pair, n_true): true
    correspondences first, then OUTLIER_SHARE of the set as random pairings
    of outlier keypoints. The first pair drawn from `seed` whose views share
    at least half of n_inliers points (a random rotation can leave the two
    views without overlap)."""
    rs = np.random.RandomState(seed)
    while True:
        p = synthesize_pair(rs, n_inliers=n_inliers, n_outliers0=n_inliers, n_outliers1=n_inliers, desc_dim=8,
                            pixel_noise=pixel_noise)
        if len(p["gt_matches"]) >= n_inliers // 2:
            break
    gt = p["gt_matches"]
    n_out = int(round(len(gt) * OUTLIER_SHARE / (1 - OUTLIER_SHARE)))
    out0 = np.setdiff1d(np.arange(len(p["kpt1"])), gt[:, 0])
    out1 = np.setdiff1d(np.arange(len(p["kpt2"])), gt[:, 1])
    i0 = np.concatenate([gt[:, 0], rs.choice(out0, n_out, replace=False)])
    i1 = np.concatenate([gt[:, 1], rs.choice(out1, n_out, replace=False)])
    return p["kpt1"][i0, :2].copy(), p["kpt2"][i1, :2].copy(), p["f"], p, len(gt)


def same_up_to_sign(F, Fr, atol):
    F, Fr = np.asarray(F), np.asarray(Fr)
    assert min(np.abs(F - Fr).max(), np.abs(F + Fr).max()) < atol


def test_normalisation_eight_point_and_distance_match_impx():
    x0, x1, F_true, _, _ = pixel_pair(0)
    valid = np.ones(len(x0), bool)
    valid[-7:] = False
    for want, got in zip(jax.jit(jf._hartley_normalize)(J(x0), J(valid)),
                         tf._hartley_normalize(T(x0), T(valid))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    x0n, _ = tf._hartley_normalize(T(x0), T(valid))
    x1n, _ = tf._hartley_normalize(T(x1), T(valid))
    w = np.random.RandomState(1).rand(len(x0)).astype(np.float32)
    for weights in (None, w):
        want = jax.jit(jf.fundamental_from_points)(J(x0n.numpy()), J(x1n.numpy()),
                                                   None if weights is None else J(weights))
        got = tf.fundamental_from_points(x0n, x1n, None if weights is None else T(weights))
        same_up_to_sign(got.numpy(), want, 1e-5)
    F = (F_true / np.linalg.norm(F_true)).astype(np.float32)
    want = np.sqrt(np.asarray(jax.jit(jf._sym_epi_dist2)(J(x0), J(x1), J(F))))
    got = np.sqrt(tf._sym_epi_dist2(T(x0), T(x1), T(F)).numpy())
    np.testing.assert_array_less(np.abs(got - want), distance_atol(x0, x1, F))
    assert np.median(got[:len(x0) * 7 // 10]) < 2.0      # the true pairs sit near their lines


def distance_atol(x0, x1, F):
    """Per point limit for the symmetric distance in pixels, port against
    impx: the residual x1h^T F x0h sums terms of size |x1h_i F_ij x0h_j|
    (pixels squared times F) to a value near 0, in another order in XLA and
    torch, so it differs by a few float32 roundings of their sum of
    magnitudes (8 eps here), divided by the epipolar line's norm; 1e-5 at
    least (a relative error of 6e-4 near 0.5 px on these pairs)."""
    h = lambda x: np.concatenate([x, np.ones_like(x[:, :1])], -1).astype(np.float64)  # noqa: E731
    x0h, x1h, Fa = h(x0), h(x1), np.abs(F.astype(np.float64))
    mag = np.einsum("ni,ij,nj->n", np.abs(x1h), Fa, np.abs(x0h))
    l1, l0 = x0h @ F.T.astype(np.float64), x1h @ F.astype(np.float64)
    den = np.minimum(np.hypot(l1[:, 0], l1[:, 1]), np.hypot(l0[:, 0], l0[:, 1]))
    return 1e-5 + 8 * np.finfo(np.float32).eps * mag / den


def test_cubic_roots_match_impx():
    """Equal flags; the roots within 1e-4 where impx's float32 root lies within
    2e-5 of the float64 one. Elsewhere the float32 closed form is off in both
    packages (a near-double root, or a small c3 that makes b = c2 / c3 huge),
    which impx accepts: every candidate F is scored."""
    rs = np.random.RandomState(2)
    c = rs.randn(4, 256).astype(np.float32)               # c3, c2, c1, c0
    c[0, :16] *= 1e-14                                     # the quadratic fallback
    want = [np.asarray(a) for a in jax.jit(jf._cubic_roots)(*(J(x) for x in c))]
    got = [a.numpy() for a in tf._cubic_roots(*(T(x) for x in c))]
    r64 = tf._cubic_roots(*(T(x).double() for x in c))[0].numpy()
    np.testing.assert_array_equal(got[1], want[1])
    ok = want[1]
    good = ok & (np.abs(want[0] - r64) < WELL_CONDITIONED * np.maximum(1.0, np.abs(r64)))
    assert good.sum() > 0.9 * ok.sum() and good[:16].any(), (good.sum(), ok.sum())
    np.testing.assert_allclose(got[0][good], want[0][good], rtol=CAND_ATOL, atol=CAND_ATOL)


def test_seven_point_candidates_match_impx():
    x0, x1, _, _, n_true = pixel_pair(3, pixel_noise=0.0)
    x0n, _ = tf._hartley_normalize(T(x0[:n_true]), torch.ones(n_true, dtype=torch.bool))
    x1n, _ = tf._hartley_normalize(T(x1[:n_true]), torch.ones(n_true, dtype=torch.bool))
    idx = np.stack([np.random.RandomState(4 + h).choice(n_true, 7, replace=False) for h in range(96)])
    s0, s1 = x0n.numpy()[idx], x1n.numpy()[idx]
    Fj, vj = (np.asarray(a) for a in jax.jit(jf.solve_fundamental_7pt)(J(s0), J(s1)))
    Ft, vt = (a.numpy() for a in tf.solve_fundamental_7pt(T(s0), T(s1)))
    F64, v64 = (a.numpy() for a in tf.solve_fundamental_7pt(T(s0).double(), T(s1).double()))
    good = [b for b in range(len(idx)) if _set_distance(Fj[b], vj[b], F64[b], v64[b]) < WELL_CONDITIONED]
    assert len(good) >= 16, len(good)
    # AᵀA's float32 sums run in other orders in XLA and torch, and a
    # perturbation of its rounding size, eps·λmax, moves its two-dimensional
    # null space by up to about eps·λmax / λ3 (Davis-Kahan; λ3 the smallest
    # eigenvalue outside it): 3e-4 at λmax / λ3 = 2,800. One implementation
    # can land closer to the float64 solve than that by chance.
    A = _design_matrix(T(s0).double(), T(s1).double())
    ev = torch.linalg.eigvalsh(A.mT @ A).numpy()
    atol = CAND_ATOL + np.finfo(np.float32).eps * ev[:, -1] / ev[:, 2]
    for b in good:
        assert _set_distance(Ft[b], vt[b], Fj[b], vj[b]) < atol[b], (b, atol[b])
    # every valid candidate of the port solves its own sample and has rank 2
    h = lambda x: np.concatenate([x, np.ones_like(x[..., :1])], -1).astype(np.float64)  # noqa: E731
    resid = np.abs(np.einsum("bni,brij,bnj->brn", h(s1), Ft.astype(np.float64), h(s0))).max(-1)
    assert vt.sum() >= len(idx) and resid[vt].max() < 1e-3
    assert np.abs(np.linalg.det(Ft[vt].astype(np.float64))).max() < 1e-3


@pytest.mark.parametrize("sample_size", [7, 8])
def test_ransac_given_impx_samples_matches_impx(sample_size):
    x0, x1, _, _, _ = pixel_pair(5)
    valid = np.ones(len(x0), bool)
    key = jax.random.PRNGKey(6)
    idx = jr._sample_minimal_sets(key, J(valid), 128, sample_size)
    want = jf.estimate_fundamental_ransac(key, J(x0), J(x1), J(valid), 1.0, num_hypotheses=128,
                                          sample_size=sample_size)
    got = tf.fundamental_ransac_from_samples(T(np.array(idx)), T(x0), T(x1), T(valid), 1.0)
    same_up_to_sign(got["F"].numpy(), want["F"], CAND_ATOL)
    # equal inlier masks but at points whose distance under impx's F lies
    # within the float32 uncertainty of the 1 px threshold: the distance's
    # conditioning bound plus what the two F's difference moves it by
    Fw, Fg = np.asarray(want["F"], np.float64), got["F"].numpy().astype(np.float64)
    Fg = Fg if np.abs(Fg - Fw).max() < np.abs(Fg + Fw).max() else -Fg
    d = lambda F: np.sqrt(tf._sym_epi_dist2(T(x0).double(), T(x1).double(), T(F)).numpy())  # noqa: E731
    margin = distance_atol(x0, x1, np.asarray(want["F"])) + np.abs(d(Fg) - d(Fw))
    sure = np.abs(d(Fw) - 1.0) > margin
    assert (~sure).sum() <= 2, (~sure).sum()
    np.testing.assert_array_equal(got["inliers"].numpy()[sure], np.asarray(want["inliers"])[sure])
    assert abs(int(got["num_inliers"]) - int(want["num_inliers"])) <= (~sure).sum()
    assert int(want["num_inliers"]) > 0.4 * len(x0)


def _recovery(x0, x1, F_true, n_true, out):
    """(share of the true pairs marked inliers, share of the outliers, the
    median symmetric distance of the true pairs under the estimate in px)."""
    inl = out["inliers"].numpy()
    d = np.sqrt(tf._sym_epi_dist2(T(x0[:n_true]), T(x1[:n_true]), out["F"]).numpy())
    return inl[:n_true].mean(), inl[n_true:].mean(), np.median(d)


@pytest.mark.parametrize("seed", [7, 8])
def test_estimate_fundamental_ransac_recovers_f(seed):
    x0, x1, F_true, _, n_true = pixel_pair(seed)
    out = tf.estimate_fundamental_ransac(torch.Generator().manual_seed(seed), T(x0), T(x1),
                                         torch.ones(len(x0), dtype=torch.bool))
    recall, admitted, med = _recovery(x0, x1, F_true, n_true, out)
    # true pairs carry 0.5 px of noise a coordinate, so some fall beyond 1 px
    assert recall > 0.6 and admitted < 0.05 and med < 1.0, (recall, admitted, med)
    true_d = np.sqrt(tf._sym_epi_dist2(T(x0[:n_true]), T(x1[:n_true]),
                                       T((F_true / np.linalg.norm(F_true)).astype(np.float32))).numpy())
    assert med < 1.5 * np.median(true_d) + 0.1


def test_fmbench_device_backend_runs_beside_cv2():
    """Both backends on the same 4 pairs: the device backend's precision after
    RANSAC at least cv2's less 0.05 on each pair, and its symmetric geometric
    distance to the true F as small as the recovery allows."""
    pairs = [pixel_pair(10 + i) for i in range(4)]
    runs = {}
    for backend in ("device", "jax", "cv2"):
        ev = FMBenchEval({"f_backend": backend, "inlier_th": 1.0}, device="cpu")
        runs[backend] = []
        for x0, x1, F, p, _ in pairs:
            res = ev.run({"corr1": x0, "corr2": x1, "f": F, "img_size1": p["img_size1"],
                          "img_size2": p["img_size2"]})
            ev.res_inqueue(res)
            runs[backend].append(res)
    assert runs["device"] == runs["jax"]                   # impx's name for the same backend
    for dev, cv in zip(runs["device"], runs["cv2"]):
        assert dev["pre"] == cv["pre"] and dev["num_corr"] == cv["num_corr"]
        assert dev["pre_post"] >= cv["pre_post"] - 0.05, (dev, cv)
        assert dev["sgd"] < 1e-3 and dev["num_corr_post"] > 0.5 * dev["num_corr"], dev
