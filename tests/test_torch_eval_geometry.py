"""The port's geometry and pose metrics against impx's on the CPU
(impx_torch/geometry/{epipolar,pose,triangulation}.py): the torch functions
at rtol 1e-5 (fp32, on the same seeded inputs), the numpy twins and the AUCs
exactly. impx's functions run under jax.jit (op by op, each first call
would compile on its own, five times slower here)."""
import functools

import jax
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from impx.geometry import epipolar as jep
from impx.geometry import keypoints as jkp
from impx.geometry import pose as jpose
from impx.geometry import triangulation as jtri

from impx_torch import geometry as G
from impx_torch.geometry import epipolar as tep
from impx_torch.geometry import keypoints as tkp
from impx_torch.geometry import pose as tpose
from impx_torch.geometry import triangulation as ttri

RTOL, ATOL = 1e-5, 1e-6


def rotation(rs, max_deg=30.0):
    axis = rs.randn(3)
    axis /= np.linalg.norm(axis)
    a = np.deg2rad(rs.uniform(2.0, max_deg))
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * (K @ K)


def scene(seed, n=64, noise=1e-3, batch=()):
    """(R, t, x0, x1) float32: points 6 +- 1 (one sigma) deep, in front of
    both cameras, normalized coordinates with noise; `batch` leading
    dimensions. (A point near the camera plane gives coordinates so large
    that the eight-point system's float32 rounding drowns its null vector.)"""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(int(np.prod(batch, dtype=int))):
        R = rotation(rs)
        t = rs.randn(3)
        t /= np.linalg.norm(t)
        X = rs.randn(n, 3) * np.array([2.0, 2.0, 1.0]) + np.array([0, 0, 6.0])
        X1 = X @ R.T + t
        x0 = X[:, :2] / X[:, 2:3] + rs.randn(n, 2) * noise
        x1 = X1[:, :2] / X1[:, 2:3] + rs.randn(n, 2) * noise
        out.append((R, t, x0, x1))
    return [np.stack(a).reshape(*batch, *a[0].shape).astype(np.float32) for a in zip(*out)]


def same(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


T = torch.as_tensor
J = jnp.asarray


@functools.lru_cache(maxsize=None)
def _jitted(fn, static):
    return jax.jit(functools.partial(fn, **dict(static)))


def ref(fn, *args, static=(), **arrays):
    """impx's fn, jitted, on numpy arrays (positional or keyword); `static`:
    (name, value) pairs bound before jitting."""
    return _jitted(fn, tuple(static))(*(J(a) for a in args), **{k: J(v) for k, v in arrays.items()})


def test_epipolar_functions_match_impx():
    R, t, x0, x1 = scene(0, batch=(3,))
    rs = np.random.RandomState(1)
    K = np.stack([np.array([[f, 0, 320], [0, f, 240], [0, 0, 1]]) for f in rs.uniform(400, 900, 3)]
                 ).astype(np.float32)
    same(tep.skew_symmetric(T(t)), ref(jep.skew_symmetric, t))
    E = tep.essential_from_pose(T(R), T(t))
    same(E, ref(jep.essential_from_pose, R, t))
    E = E.numpy()
    same(tep.fundamental_from_essential(T(E), T(K), T(K[::-1].copy())),
         ref(jep.fundamental_from_essential, E, K, K[::-1]))
    for fn in ("epipolar_distance", "sampson_distance", "pairwise_epipolar_distance"):
        same(getattr(tep, fn)(T(x0), T(x1), T(E)), ref(getattr(jep, fn), x0, x1, E))
    mask, err = tep.compute_epi_inlier(T(x0), T(x1), T(E), 2e-3, return_error=True)
    rmask, rerr = ref(jep.compute_epi_inlier, x0, x1, E, static=(("inlier_th", 2e-3), ("return_error", True)))
    same(err, rerr)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))
    assert 0 < mask.float().mean() < 1
    px = x0 * 500 + 300
    same(tep.normalize_by_intrinsics(T(px), T(K)), ref(jep.normalize_by_intrinsics, px, K))
    for b in range(3):
        got = tep.compute_epi_inlier_np(x0[b], x1[b], E[b], 2e-3, return_error=True)
        want = jep.compute_epi_inlier_np(x0[b], x1[b], E[b], 2e-3, return_error=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_keypoint_normalizations_match_impx():
    rs = np.random.RandomState(2)
    x = (rs.rand(40, 2) * 600).astype(np.float32)
    K = np.array([[500.0, 0, 320], [0, 510, 240], [0, 0, 1]], np.float32)
    same(tkp.normalize_keypoints(T(x), 480, 640),
         ref(jkp.normalize_keypoints, x, static=(("height", 480), ("width", 640))))
    same(tkp.normalize_size(T(x), (640, 480)), ref(jkp.normalize_size, x, static=(("size", (640, 480)),)))
    same(tkp.normalize_size_spg(T(x), (640, 480)), ref(jkp.normalize_size_spg, x, static=(("size", (640, 480)),)))
    same(tkp.normalize_intrinsic(T(x), K), ref(jkp.normalize_intrinsic, x, K))


def test_pose_functions_match_impx():
    rs = np.random.RandomState(3)
    Rs = np.stack([rotation(rs, 170.0) for _ in range(8)]).astype(np.float32)
    q, qr = tpose.quaternion_from_matrix(T(Rs)).numpy(), np.asarray(ref(jpose.quaternion_from_matrix, Rs))
    # the sign of a quaternion is free
    same(np.abs(np.sum(q * qr, -1)), np.ones(8))
    for i in range(7):
        R, Rg = Rs[i], Rs[i + 1]
        t, tg = rs.randn(3).astype(np.float32), rs.randn(3).astype(np.float32)
        same(tpose.evaluate_R_t(T(Rg), T(tg), T(R), T(t)), ref(jpose.evaluate_R_t, Rg, tg, R, t))
        same(tpose.angle_error_mat(T(R), T(Rg)), ref(jpose.angle_error_mat, R, Rg))
        same(tpose.angle_error_vec(T(t), T(tg)), ref(jpose.angle_error_vec, t, tg))
        Tm = np.hstack([Rg, tg[:, None]])
        same(tpose.compute_pose_error(T(Tm), T(R), T(t)), ref(jpose.compute_pose_error, Tm, R, t))
        np.testing.assert_array_equal(tpose.quaternion_from_matrix_np(R), jpose.quaternion_from_matrix_np(R))
        assert tpose.evaluate_R_t_np(Rg, tg, R, t) == jpose.evaluate_R_t_np(Rg, tg, R, t)
        assert tpose.compute_pose_error_np(Tm, R, t) == jpose.compute_pose_error_np(Tm, R, t)


@pytest.mark.parametrize("n", [1, 7, 50])
def test_pose_auc_matches_impx_exactly(n):
    errors = np.random.RandomState(n).exponential(8.0, n)
    errors[::5] = np.inf
    assert G.pose_auc(errors, [5, 10, 20]) == jpose.pose_auc(errors, [5, 10, 20])
    ths = np.arange(7) * 5
    assert G.approx_pose_auc(errors, ths) == jpose.approx_pose_auc(errors, ths)


def test_triangulation_and_cheirality_match_impx():
    R, t, x0, x1 = scene(4, n=48)
    z = np.stack([a.numpy() for a in ttri.two_ray_depths(T(R), T(t), T(x0), T(x1))])
    zr = np.stack([np.asarray(a) for a in ref(jtri.two_ray_depths, R, t, x0, x1)])
    # Cramer's rule cancels in its determinant uv² − uu·vv: the relative
    # rounding grows by cond = uu·vv / |det| (about 10-100 at these baselines)
    u = np.hstack([x0, np.ones((48, 1))]) @ R.T
    v = np.hstack([x1, np.ones((48, 1))])
    uu, vv, uv = (u * u).sum(1), (v * v).sum(1), (u * v).sum(1)
    cond = uu * vv / np.abs(uv * uv - uu * vv)
    assert (np.abs(z - zr) <= (RTOL + 4 * np.finfo(np.float32).eps * cond) * np.abs(zr)).all()
    # a third of the points moved behind a camera (near-parallel rays among
    # them, whose depths are ill-conditioned): the masks have both values
    x1[::3] *= -1
    valid = np.arange(48) % 7 != 0
    fast = ttri.cheirality_mask_fast(T(R), T(t), T(x0), T(x1), valid=T(valid))
    np.testing.assert_array_equal(fast.numpy(), np.asarray(
        ref(jtri.cheirality_mask_fast, R, t, x0, x1, valid=valid)))
    assert 0 < fast.float().mean() < 1
    P0 = np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32)
    P1 = np.hstack([R, t[:, None]]).astype(np.float32)
    X = ttri.triangulate_points(T(P0), T(P1), T(x0), T(x1)).numpy()
    Xr = np.array(ref(jtri.triangulate_points, P0, P1, x0, x1))
    same(X, Xr)
    mask = ttri.cheirality_mask(T(Xr), T(P1), valid=T(valid))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref(jtri.cheirality_mask, Xr, P1, valid=valid)))


def test_decompose_E_gives_impx_hypotheses():
    """The four hypotheses (R1, R2) x (t, -t) are the same set: SVD sign
    conventions may swap R1 and R2 and negate t."""
    R, t, _, _ = scene(5)
    E = np.array(ref(jep.essential_from_pose, R, t))
    R1, R2, tt = (a.numpy() for a in ttri.decompose_E(T(E)))
    Q1, Q2, tr = (np.asarray(a) for a in ref(jtri.decompose_E, E))
    swapped = np.abs(R1 - Q1).max() > 1e-3
    same(R1, Q2 if swapped else Q1, atol=1e-5)
    same(R2, Q1 if swapped else Q2, atol=1e-5)
    same(np.abs(tt), np.abs(tr), atol=1e-5)
    for Rc in (R1, R2):
        same(Rc @ Rc.T, np.eye(3), atol=1e-5)
        assert abs(np.linalg.det(Rc) - 1) < 1e-5
