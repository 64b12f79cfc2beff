"""The port's five-point solver and the iterative loop's checkpoint pose
solver against impx's on the CPU (impx_torch/ransac/five_point.py, the
sample_size=5 branch of impx_torch/ransac/ransac.py and
impx_torch/ransac/pose_solver.py:estimate_pose_from_matches).

The degree-10 root chain runs in float32 in both packages, and its
conditioning varies from sample to sample: on noise-free minimal sets impx's
own candidates sit a median 1e-4 from the ground truth. So the candidate sets
are held equal (up to sign, 1e-4) on the well-conditioned samples, those
where impx's float32 candidates lie within WELL_CONDITIONED of a float64
solve, and every valid candidate of the port on every sample is held to the
1e-2 epipolar residual it promises. Whole solves are held against impx given
impx's own draws, as tests/test_torch_ransac.py does.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from impx.ransac import five_point as j5
from impx.ransac import pose_solver as jps
from impx.ransac import ransac as jr

from impx_torch.ransac import five_point as t5
from impx_torch.ransac import pose_solver as tps
from impx_torch.ransac import ransac as tr

from test_torch_eval_geometry import ref, scene
from test_torch_ransac import eigvec_atol, same_up_to_sign, with_outliers

T = torch.as_tensor
J = jnp.asarray
THRESH = 3e-3
CAND_ATOL = 1e-4
WELL_CONDITIONED = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops dominate: one thread, as tests/test_torch_logot.py runs."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _set_distance(E, v, Er, vr):
    """Largest distance (up to sign) from a valid candidate of one set to the
    nearest of the other, both ways; inf when the counts differ."""
    a, b = E[v], Er[vr]
    if len(a) != len(b):
        return np.inf
    if not len(a):
        return 0.0
    d = np.minimum(np.abs(a[:, None] - b[None]).max((-1, -2)), np.abs(a[:, None] + b[None]).max((-1, -2)))
    return max(d.min(1).max(), d.min(0).max())


def test_five_point_candidates_match_impx():
    _, _, x0, x1 = scene(40, n=5, noise=0.0, batch=(128,))
    Ej, vj = (np.asarray(a) for a in jax.jit(j5.solve_essential_5pt)(J(x0), J(x1)))
    Et, vt = (a.numpy() for a in t5.solve_essential_5pt(T(x0), T(x1)))
    E64, v64 = (a.numpy() for a in t5.solve_essential_5pt(T(x0), T(x1), dtype=torch.float64))
    good = [b for b in range(len(x0)) if _set_distance(Ej[b], vj[b], E64[b], v64[b]) < WELL_CONDITIONED]
    assert len(good) >= 8, len(good)
    worst = max(_set_distance(Et[b], vt[b], Ej[b], vj[b]) for b in good)
    assert worst < CAND_ATOL, worst
    # every valid candidate of the port solves its own sample
    h = lambda x: np.concatenate([x, np.ones_like(x[..., :1])], -1).astype(np.float64)  # noqa: E731
    resid = np.abs(np.einsum("bni,brij,bnj->brn", h(x1), Et.astype(np.float64), h(x0))).max(-1)
    assert vt.sum() >= len(x0) and resid[vt].max() < 1e-2


def test_five_point_takes_any_leading_shape():
    _, _, x0, x1 = scene(41, n=5, noise=1e-3, batch=(3, 4))
    E, v = t5.solve_essential_5pt(T(x0), T(x1))
    Ef, vf = t5.solve_essential_5pt(T(x0).flatten(0, 1), T(x1).flatten(0, 1))
    assert E.shape == (3, 4, t5.MAX_ROOTS, 3, 3) and v.shape == (3, 4, t5.MAX_ROOTS)
    assert torch.equal(v.flatten(0, 1), vf)
    torch.testing.assert_close(E.flatten(0, 1), Ef, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["uniform", "prior"])
def test_five_point_ransac_given_impx_samples_matches_impx(case):
    R, t, x0, x1 = with_outliers(42, 60, 20)
    n = len(x0)
    valid = np.ones(n, bool)
    key = jax.random.PRNGKey(3)
    idx = jr._sample_minimal_sets(key, J(valid), 48, 5)
    kw, tkw = {}, {}
    if case == "prior":
        E0 = np.array(ref(jps.prior_essential, R, t, static=(("has_pose", True),)))
        kw, tkw = {"E_init": J(E0)}, {"E_init": T(E0)}
    want = jr.estimate_essential_ransac(key, J(x0), J(x1), J(valid), THRESH, num_hypotheses=48,
                                        sample_size=5, **kw)
    out = tr.essential_ransac_from_samples(T(np.array(idx)), T(x0), T(x1), T(valid), THRESH, **tkw)
    # the winner is an eight-point refit on its support: within that system's
    # float32 conditioning bound (tests/test_torch_ransac.py:eigvec_atol)
    inl = np.asarray(want["inliers"])
    same_up_to_sign(out["E"], want["E"], max(CAND_ATOL, float(eigvec_atol(x0[inl], x1[inl]))))
    np.testing.assert_array_equal(out["inliers"].numpy(), inl)


def _matched_pair(seed, n=96, n_true=48, n_false=16):
    """One image pair as a matcher hands it over: x0n [n, 2], x1n [n, 2] (image
    1 a permutation of its points), indices0 [n] (n_true true matches, then
    n_false wrong ones, the rest -1) and distinct mscores0."""
    R, t, x0, x1 = with_outliers(seed, n_true + n_false, n - n_true - n_false)
    rs = np.random.RandomState(seed)
    perm = rs.permutation(n)
    x1n = np.empty_like(x1)
    x1n[perm] = x1
    idx = np.where(np.arange(n) < n_true + n_false, perm, -1)
    idx[n_true:n_true + n_false] = np.roll(perm[n_true:n_true + n_false], 3)
    ms = np.where(idx > -1, rs.uniform(0.2, 1.0, n), 0.0).astype(np.float32)
    return R, t, x0, x1n, idx.astype(np.int64), ms


def _impx_draws(key, idx0, ms0, hypotheses, bucket=512):
    """The minimal sets impx's estimate_pose_from_matches draws from `key`."""
    keym = jnp.where(J(idx0) > -1, J(ms0), -1.0)
    vals, _ = jax.lax.top_k(keym, min(bucket, len(idx0)))
    valid = vals > -0.5
    return np.array(jr._sample_minimal_sets_weighted(key, jnp.where(valid, jnp.maximum(vals, 1e-4), 0.0),
                                                     valid, hypotheses, 5))


@pytest.mark.parametrize("case", ["fresh", "prior"])
def test_pose_from_matches_given_impx_draws_matches_impx(case):
    R, t, x0, x1, idx0, ms0 = _matched_pair(43)
    key = jax.random.PRNGKey(5)
    kw, tkw = {}, {}
    if case == "prior":
        E0 = np.array(ref(jps.prior_essential, R, t, static=(("has_pose", True),)))
        kw, tkw = {"E_init": J(E0)}, {"E_init": T(E0)}
    want = jps.estimate_pose_from_matches(key, J(x0), J(x1), J(idx0), J(ms0), THRESH, num_hypotheses=48,
                                          **kw)
    out = tps.estimate_pose_from_matches(None, T(x0), T(x1), T(idx0), T(ms0), THRESH,
                                         samples=T(_impx_draws(key, idx0, ms0, 48)), **tkw)
    same_up_to_sign(out["E"], want["E"], CAND_ATOL)
    np.testing.assert_array_equal(out["inliers"].numpy(), np.asarray(want["inliers"]))
    assert int(out["num_inliers"]) == int(want["num_inliers"]) >= 40


def test_pose_from_matches_batched_equals_per_pair():
    """One batched solve over three pairs gives each pair what a call of its
    own gives it, from the same generator seed."""
    pairs = [_matched_pair(44 + i) for i in range(3)]
    stack = lambda k: T(np.stack([p[k] for p in pairs]))  # noqa: E731
    gens = lambda: [torch.Generator().manual_seed(10 + i) for i in range(3)]  # noqa: E731
    E_init = tps.prior_essential(stack(0).float(), stack(1).float(), torch.tensor([True, False, True]))
    thr = torch.tensor([THRESH, 2 * THRESH, THRESH])
    out = tps.estimate_pose_from_matches(gens(), stack(2), stack(3), stack(4), stack(5), thr,
                                         num_hypotheses=32, E_init=E_init)
    for i, g in enumerate(gens()):
        one = tps.estimate_pose_from_matches(g, *(T(pairs[i][k]) for k in range(2, 6)), float(thr[i]),
                                             num_hypotheses=32, E_init=E_init[i])
        # float32 sums of another batch shape (matmul folding): 1.5e-6 measured
        for k in ("E", "R", "t"):
            torch.testing.assert_close(out[k][i], one[k], rtol=0, atol=1e-5)
        assert torch.equal(out["inliers"][i], one["inliers"])
    assert (out["num_inliers"] >= 40).all()
