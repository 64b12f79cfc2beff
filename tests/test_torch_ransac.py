"""The port's RANSAC and pose solvers against impx's on the CPU
(impx_torch/ransac/{eight_point,ransac,pose_solver}.py).

JAX's threefry stream has no torch counterpart, so whole RANSAC runs are held
against impx given the same samples: `essential_ransac_from_samples` takes
the minimal sets that impx's own `_sample_minimal_sets(key, ...)` draws, and
is compared with impx's `estimate_essential_ransac(key, ...)`. The device
backend with its own generator is held to tests/test_ransac.py's recovery
and padding limits.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from impx.geometry.epipolar import skew_symmetric as jax_skew
from impx.geometry.triangulation import decompose_essential_mat as jax_decompose
from impx.ransac import eight_point as j8
from impx.ransac import pose_solver as jps
from impx.ransac import ransac as jr

from impx_torch.geometry.pose import angle_error_mat, angle_error_vec
from impx_torch.geometry import triangulation as tri
from impx_torch.geometry.triangulation import decompose_essential_mat
from impx_torch.ransac import eight_point as t8
from impx_torch.ransac import pose_solver as tps
from impx_torch.ransac import ransac as tr

from test_torch_eval_geometry import ref, scene

T = torch.as_tensor
J = jnp.asarray
THRESH = 3e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops dominate: one thread, as tests/test_torch_logot.py runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def same(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def same_up_to_sign(E, Er, atol):
    E, Er = np.asarray(E), np.asarray(Er)
    assert min(np.abs(E - Er).max(), np.abs(E + Er).max()) < atol


def with_outliers(seed, n_in, n_out, noise=1e-3):
    """(R, t, x0, x1, n_in): true correspondences first, then random pairings
    of another scene's points."""
    R, t, x0, x1 = scene(seed, n=n_in, noise=noise)
    _, _, o0, o1 = scene(seed + 100, n=n_out)
    return R, t, np.vstack([x0, o0]), np.vstack([x1, np.roll(o1, 7, axis=0)])


def eigvec_atol(x0, x1, w=None):
    """Per-sample limit for the eight-point solutions, port against impx:
    AᵀWA's float32 sums run in other orders in XLA and torch, and a
    perturbation of M of its rounding size, eps·λmax, moves M's smallest
    eigenvector by up to about eps·λmax / (λ2 − λ1) (Davis-Kahan). Measured
    differences stay under a tenth of it; noise-free 40-point sets give
    1e-4 to 4e-4, above a fixed 1e-5."""
    A = np.asarray(ref(j8._design_matrix, x0, x1)).astype(np.float64)
    if w is not None:
        A = A * w[..., None]
    ev = np.linalg.eigvalsh(np.swapaxes(A, -1, -2) @ A)
    return 1e-6 + np.finfo(np.float32).eps * ev[..., -1] / (ev[..., 1] - ev[..., 0])


def assert_close_up_to_sign(got, want, atol):
    """Each sample [b, ...] equal up to sign within its atol[b]."""
    got, want = np.asarray(got).reshape(len(atol), -1), np.asarray(want).reshape(len(atol), -1)
    diff = np.minimum(np.abs(got - want).max(1), np.abs(got + want).max(1))
    assert (diff < atol).all(), (diff, atol)


@pytest.mark.parametrize("project", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("noise", [0.0, 1e-3])
def test_essential_from_points_matches_impx(noise, weighted, project):
    _, _, x0, x1 = scene(0, n=40, noise=noise, batch=(6,))
    w = np.random.RandomState(1).rand(6, 40).astype(np.float32) if weighted else None
    got = t8.essential_from_points(T(x0), T(x1), None if w is None else T(w), project)
    arrays = {} if w is None else {"weights": w}
    want = ref(j8.essential_from_points, x0, x1, static=(("project", project),), **arrays)
    assert_close_up_to_sign(got, want, (2 if project else 1) * eigvec_atol(x0, x1, w))


def test_design_matrix_and_projection_match_impx():
    _, _, x0, x1 = scene(0, n=40, batch=(6,))
    same(t8._design_matrix(T(x0), T(x1)), ref(j8._design_matrix, x0, x1))
    E = np.random.RandomState(2).randn(6, 3, 3).astype(np.float32)
    same(t8.project_essential(T(E)), ref(j8.project_essential, E), atol=1e-5)


def test_smallest_eigvec_matches_impx_including_a_degenerate_sample():
    """Minimal samples, the same float32 M on both sides: three regular ones
    (within eigvec_atol); a rank-1 one (eight copies of a point: its smallest
    eigenvalue has eight dimensions, so each side returns its own vector in
    that null space); an all-zero one; and a non-finite one, whose Cholesky
    factor both replace by I (JAX returns NaN, torch reports it in `info`)."""
    _, _, x0, x1 = scene(2, n=8, noise=1e-3, batch=(6,))
    x0[3], x1[3] = x0[3, :1], x1[3, :1]
    A = np.asarray(ref(j8._design_matrix, x0, x1))
    M = np.einsum("bni,bnj->bij", A, A).astype(np.float32)
    M[4] = 0.0
    M[5, 2, 2] = np.nan
    got, want = t8._smallest_eigvec(T(M)).numpy(), np.asarray(ref(j8._smallest_eigvec, M))
    assert_close_up_to_sign(got[:3], want[:3], eigvec_atol(x0, x1)[:3])
    for v in (got[3], want[3]):
        assert np.linalg.norm(M[3].astype(np.float64) @ v) < 1e-4 * np.linalg.norm(M[3])
    np.testing.assert_allclose(got[4:], want[4:], rtol=1e-6)
    np.testing.assert_allclose(got[5], np.arange(1, 10) / np.linalg.norm(np.arange(1, 10)), rtol=1e-6)


def test_score_matches_impx():
    R, t, x0, x1 = with_outliers(3, 60, 40)
    valid = np.arange(100) % 9 != 0
    Es = np.asarray(ref(jps.skew_symmetric, t) @ R)[None] + 1e-3 * np.random.RandomState(4).randn(5, 3, 3)
    Es = Es.astype(np.float32)
    for sigmas in ((1.0,), (1.0, 2.0)):
        got = tr._score(T(Es), T(x0), T(x1), T(valid), THRESH, sigmas)
        want = jax.jit(jax.vmap(lambda E: jr._score(E, J(x0), J(x1), J(valid), THRESH, sigmas)))(J(Es))
        same(got[0], want[0], rtol=1e-4)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        same(got[2], want[2], rtol=1e-4)


@pytest.mark.parametrize("case", ["uniform", "padded", "weighted", "prior"])
def test_ransac_given_impx_samples_matches_impx(case):
    """E equal up to sign at 1e-4 and the inlier masks equal, with impx's
    samples: uniform, with invalid (padded) points, weighted (Gumbel
    top-k), and with a warm-start model."""
    R, t, x0, x1 = with_outliers(5, 150, 100)
    n = len(x0)
    valid = np.ones(n, bool) if case != "padded" else np.arange(n) < n - 30
    key = jax.random.PRNGKey(7)
    kw, tkw = {}, {}
    if case == "weighted":
        w = np.random.RandomState(6).rand(n).astype(np.float32)
        idx = jr._sample_minimal_sets_weighted(key, J(w), J(valid), 512, 8)
        kw = {"weights": J(w)}
    else:
        idx = jr._sample_minimal_sets(key, J(valid), 512, 8)
    if case == "prior":
        E0 = np.array(ref(jps.prior_essential, R, t, static=(("has_pose", True),)))
        kw, tkw = {"E_init": J(E0)}, {"E_init": T(E0)}
    want = jr.estimate_essential_ransac(key, J(x0), J(x1), J(valid), THRESH, num_hypotheses=512, **kw)
    out = tr.essential_ransac_from_samples(T(np.array(idx)), T(x0), T(x1), T(valid), THRESH, **tkw)
    same_up_to_sign(out["E"], want["E"], 1e-4)
    np.testing.assert_array_equal(out["inliers"].numpy(), np.asarray(want["inliers"]))
    assert 0.5 < out["inliers"][:150].float().mean() and not out["inliers"][~T(valid)].any()


def test_pose_helpers_match_impx():
    R, t, _, _ = scene(14)
    for has_pose in (True, False):
        same(tps.prior_essential(T(R), T(t), torch.tensor(has_pose)),
             ref(jps.prior_essential, R, t, has_pose=np.bool_(has_pose)))
    K = np.array([[500.0, 0, 320], [0, 510, 240], [0, 0, 1]])
    px = np.random.RandomState(15).rand(20, 2) * 600
    np.testing.assert_array_equal(tps.normalize_pts(px, K), jps.normalize_pts(px, K))
    assert tps._norm_threshold(1.0, K, K) == jps._norm_threshold(1.0, K, K)


def test_samplers_draw_valid_indices():
    valid = T(np.arange(50) % 4 != 0)
    g = torch.Generator().manual_seed(0)
    idx = tr._sample_minimal_sets(g, valid, 2000, 8)
    assert idx.shape == (2000, 8) and valid[idx].all()
    counts = torch.bincount(idx.flatten(), minlength=50)[valid]
    assert counts.min() > 0.7 * counts.float().mean()   # about uniform over the 37 valid
    w = torch.rand(50, generator=g)
    idx = tr._sample_minimal_sets_weighted(g, w, valid, 500, 8)
    assert valid[idx].all()
    assert all(len(set(row.tolist())) == 8 for row in idx)   # without replacement


@pytest.mark.parametrize("fast", [True, False])
def test_decompose_essential_mat_matches_impx(fast):
    """Inputs with a unique best hypothesis (the other three count fewer
    cheirality inliers), from E of float32 RANSAC-like noise."""
    R, t, x0, x1 = scene(8, n=80, noise=1e-3)
    E = (np.asarray(ref(jax_skew, t)) @ R + 1e-4 * np.random.RandomState(9).randn(3, 3)).astype(np.float32)
    valid = np.arange(80) % 5 != 0
    got = decompose_essential_mat(T(E), T(x0), T(x1), valid=T(valid), fast=fast)
    want = ref(jax_decompose, E, x0, x1, valid=valid, static=(("fast", fast),))
    same(got[0], want[0], atol=1e-5)
    same(got[1], want[1], atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[3]) == int(want[3]) > 0.9 * valid.sum()
    # the best hypothesis is unique: every other counts fewer inliers
    R1, R2, tt = tri.decompose_E(T(E))
    Rs, ts = torch.stack([R1, R2, R1, R2]), torch.stack([tt, tt, -tt, -tt])
    if fast:
        counts = tri.cheirality_mask_fast(Rs, ts, T(x0), T(x1), valid=T(valid)).sum(-1)
    else:
        P0 = tri.projection(torch.eye(3), torch.zeros(3))
        P = tri.projection(Rs, ts)
        counts = tri.cheirality_mask(tri.triangulate_points(P0, P, T(x0), T(x1)), P, valid=T(valid)).sum(-1)
    assert sorted(counts.tolist())[-2] < int(got[3]) == counts.max()


def _gn_inputs(seed=10):
    R, t, x0, x1 = with_outliers(seed, 90, 30, noise=2e-3)
    rs = np.random.RandomState(seed)
    # start away from the truth, the outliers weighted 0
    R0 = (np.asarray(ref(jps._expm_so3, rs.randn(3).astype(np.float32) * 0.02)) @ R).astype(np.float32)
    t0 = t + 0.05 * rs.randn(3)
    t0 = (t0 / np.linalg.norm(t0)).astype(np.float32)
    w = np.where(np.arange(120) < 90, rs.uniform(0.5, 1.0, 120), 0.0).astype(np.float32)
    return R, t, R0, t0, x0, x1, w


def test_gauss_newton_jacobian_at_zero_matches_jax_jacfwd():
    R, t, R0, t0, x0, x1, w = _gn_inputs()
    sw = np.sqrt(w)
    B = ref(jps._tangent_basis, t0)

    def res(p):  # impx's refine_pose_gn residual (impx/ransac/pose_solver.py:98)
        Rn = jps._expm_so3(p[:3]) @ R0
        tn = t0 + B @ p[3:5]
        tn = tn / (jnp.linalg.norm(tn) + 1e-18)
        return jps._sampson_residual(jps.skew_symmetric(tn) @ Rn, J(x0), J(x1)) * sw

    r, Jt, Bt = tps._gn_system(T(R0), T(t0), T(x0), T(x1), T(sw))
    same(Bt, B)
    same(r, jax.jit(res)(jnp.zeros(5)), atol=1e-6)
    same(Jt, jax.jit(jax.jacfwd(res))(jnp.zeros(5)), atol=2e-6)


def test_refine_pose_gn_matches_impx():
    R, t, R0, t0, x0, x1, w = _gn_inputs()
    Rg, tg = tps.refine_pose_gn(T(R0), T(t0), T(x0), T(x1), T(w))
    Rj, tj = ref(jps.refine_pose_gn, R0, t0, x0, x1, w)
    same(Rg, Rj, atol=1e-5)
    same(tg, tj, atol=1e-5)
    assert float(angle_error_mat(Rg, T(R).float())) < float(angle_error_mat(T(R0), T(R).float()))


def test_device_pose_recovers_the_pose_under_outliers():
    """tests/test_ransac.py:25-45's limits: 300 inliers, 200 outliers (40%)."""
    R, t, x0, x1 = with_outliers(11, 300, 200)
    out = tps.estimate_pose_device(torch.Generator().manual_seed(0), T(x0), T(x1),
                                   torch.ones(500, dtype=torch.bool), THRESH)
    assert float(angle_error_mat(T(R), out["R"])) < 1.5
    assert float(angle_error_vec(T(t), out["t"])) < 1.5
    inl = out["inliers"].numpy()
    assert inl[:300].mean() > 0.8 and inl[300:].mean() < 0.1


def test_device_pose_ignores_masked_padding():
    """tests/test_ransac.py:48-63's limits: padded, masked points leave the
    estimate within 0.5 degrees and are never inliers."""
    R, t, x0, x1 = scene(12, n=100, noise=1e-3)
    valid = torch.ones(100, dtype=torch.bool)
    out1 = tps.estimate_pose_device(torch.Generator().manual_seed(3), T(x0), T(x1), valid, THRESH,
                                    num_hypotheses=512)
    x0p = np.vstack([x0, np.full((28, 2), 123.0, np.float32)])
    x1p = np.vstack([x1, np.full((28, 2), -77.0, np.float32)])
    validp = torch.cat([valid, torch.zeros(28, dtype=torch.bool)])
    out2 = tps.estimate_pose_device(torch.Generator().manual_seed(3), T(x0p), T(x1p), validp, THRESH,
                                    num_hypotheses=512)
    assert float(angle_error_mat(out1["R"], out2["R"])) < 0.5
    assert not out2["inliers"][100:].any()


def test_cv2_backend_matches_impx():
    """The same float32 matched pixels: cv2's E bit for bit, R and t (the
    float32 decomposition, another SVD) to 1e-5, the same mask."""
    pytest.importorskip("cv2")
    from impx_torch.data.synthetic import synthesize_pair

    rs = np.random.RandomState(13)
    for _ in range(2):
        pair = synthesize_pair(rs, n_inliers=80, n_outliers0=30, n_outliers1=30, desc_dim=8)
        gt = pair["gt_matches"]
        i0 = np.concatenate([gt[:, 0], rs.randint(0, len(pair["kpt1"]), 25)])
        i1 = np.concatenate([gt[:, 1], rs.randint(0, len(pair["kpt2"]), 25)])
        k0, k1 = pair["kpt1"][i0, :2], pair["kpt2"][i1, :2]
        assert k0.dtype == np.float32
        got = tps.estimate_pose_cv2(k0, k1, pair["K1"], pair["K2"], 1.0)
        want = jps.estimate_pose_cv2(k0, k1, pair["K1"], pair["K2"], 1.0)
        np.testing.assert_array_equal(got[0], want[0])
        same(got[1], want[1], atol=1e-5)
        same(got[2], want[2], atol=1e-5)
        np.testing.assert_array_equal(got[3], want[3])
        assert tps.estimate_pose(k0, k1, pair["K1"], pair["K2"], 1.0)[0].tobytes() == got[0].tobytes()
