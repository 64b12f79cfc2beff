"""The port's collectives (impx_torch/parallel/collectives.py) on a world of 4
CPU ranks over gloo against impx's on a 4-device mesh (impx.parallel.
collectives.under, the conftest's virtual CPU devices): every collective
exactly at fp32; batch_norm_train(group=) against impx's axis_name at
tests/test_collectives.py's tolerances, and with global_batch against one
process's norm of the whole batch; the gradients of f, g and all_gather
against their closed forms. The world spawns once for the module.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from impx.ops.norms import batch_norm_train as jax_batch_norm_train
from impx.parallel import collectives as jcol
from impx.parallel.mesh import make_mesh

import torch

from impx_torch.ops.norms import batch_norm_train

from torch_parallel_world import run_world

WORLD = 4


def _inputs():
    rs = np.random.RandomState(7)
    mask = np.ones((WORLD * 2, 16), bool)
    mask[0, 10:] = False      # rank 0 holds fewer valid tokens
    mask[5, 3:] = False
    return {"x": np.arange(WORLD * 4, dtype=np.float32) * 0.5 - 3.0,
            "rs": rs.rand(WORLD, WORLD * 2).astype(np.float32),
            "bn_x": rs.randn(WORLD * 2, 16, 32).astype(np.float32),
            "bn_scale": (rs.rand(32) + 0.5).astype(np.float32),
            "bn_bias": rs.randn(32).astype(np.float32),
            "bn_mask": mask,
            "bn_w": rs.randn(WORLD * 2, 16, 32).astype(np.float32)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inputs = _inputs()
    return inputs, run_world(WORLD, "collectives", tmp_path_factory.mktemp("collectives"), **inputs)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jax.devices()[:WORLD])


def _ranks(outs, key):
    return [o[key] for o in outs]


def test_psum_pmean_pmax_match_impx(world, mesh):
    inputs, outs = world
    x = jnp.asarray(inputs["x"])
    for name, fn in (("psum", lambda s: jcol.psum(jnp.sum(s))), ("pmean", lambda s: jcol.pmean(jnp.sum(s))),
                     ("pmax", lambda s: jcol.pmax(jnp.max(s)))):
        want = float(jcol.under(mesh, fn, x))
        for got in _ranks(outs, name):
            assert float(got) == want, name


def test_all_gather_tiled_and_stacked_match_impx(world, mesh):
    inputs, outs = world
    x = jnp.asarray(inputs["x"])
    tiled = np.asarray(jcol.under(mesh, lambda s: jcol.all_gather(s), x))
    stacked = np.asarray(jcol.under(mesh, lambda s: jcol.all_gather(s, tiled=False), x))
    for got, got_s in zip(_ranks(outs, "all_gather"), _ranks(outs, "all_gather_stacked")):
        np.testing.assert_array_equal(got, tiled)
        np.testing.assert_array_equal(got_s, stacked)


def test_reduce_scatter_matches_impx(world, mesh):
    inputs, outs = world
    want = np.asarray(jcol.under(mesh, lambda s: jcol.reduce_scatter(s[0]), jnp.asarray(inputs["rs"]),
                                 out_specs=P("data")))
    np.testing.assert_array_equal(np.concatenate(_ranks(outs, "reduce_scatter")), want)


def test_ring_shift_and_ppermute_match_impx(world, mesh):
    """ppermute's (0 -> 1, 1 -> 2): ranks 0 and 3 receive zeros, as in impx."""
    inputs, outs = world
    x = jnp.asarray(inputs["x"])
    ring = np.asarray(jcol.under(mesh, lambda s: jcol.ring_shift(s, shift=1), x, out_specs=P("data")))
    perm = np.asarray(jcol.under(mesh, lambda s: jcol.ppermute(s, [(0, 1), (1, 2)]), x, out_specs=P("data")))
    np.testing.assert_array_equal(np.concatenate(_ranks(outs, "ring_shift")), ring)
    np.testing.assert_array_equal(np.concatenate(_ranks(outs, "ppermute")), perm)
    assert not perm[:4].any() and not perm[-4:].any()


def test_axis_index_size_and_under_match_impx(world, mesh):
    inputs, outs = world
    idx = np.asarray(jcol.under(mesh, lambda s: s * 0 + jcol.axis_index(), jnp.asarray(inputs["x"]),
                                out_specs=P("data")))
    assert _ranks(outs, "axis_index") == list(idx.reshape(WORLD, -1)[:, 0].astype(int))
    assert _ranks(outs, "axis_size") == [WORLD] * WORLD
    want = float(jcol.under(mesh, lambda s: jcol.psum(jnp.sum(s)), jnp.asarray(inputs["x"])))
    assert [float(v) for v in _ranks(outs, "under")] == [want] * WORLD


@pytest.mark.parametrize("key,masked", [("bn", False), ("bn_masked_pmean", True)])
def test_batch_norm_group_matches_axis_name(world, mesh, key, masked):
    """group= is impx's axis_name: each rank's moments pmean-ed
    (tests/test_collectives.py:60-85's tolerances: y 1e-5, mean 1e-6, var 1e-5)."""
    inputs, outs = world
    x, scale, bias = (jnp.asarray(inputs[k]) for k in ("bn_x", "bn_scale", "bn_bias"))
    mask = jnp.asarray(inputs["bn_mask"])

    def shard_fn(xs, ms):
        return jax_batch_norm_train(xs, scale, bias, mask=ms if masked else None, axis_name="data")

    y, m, v = jcol.under(mesh, shard_fn, x, mask, out_specs=(P("data"), P(), P()))
    got = _ranks(outs, key)
    np.testing.assert_allclose(np.concatenate([g[0] for g in got]), np.asarray(y), atol=1e-5)
    for _, gm, gv in got:
        np.testing.assert_allclose(gm, np.asarray(m), atol=1e-6)
        np.testing.assert_allclose(gv, np.asarray(v), atol=1e-5)


def test_batch_norm_global_batch_is_the_whole_batch_norm(world):
    """global_batch: the moments of the union batch (sums and counts
    all-reduced) equal one process's masked norm of the whole batch, which
    the pmean of per-rank moments does not when the counts differ; the
    gradient through the all-reduce equals the whole batch's."""
    inputs, outs = world
    x = torch.from_numpy(inputs["bn_x"]).requires_grad_(True)
    mask = torch.from_numpy(inputs["bn_mask"])
    scale, bias = torch.from_numpy(inputs["bn_scale"]), torch.from_numpy(inputs["bn_bias"])
    y, m, v = batch_norm_train(x, scale, bias, mask=mask)
    (y * torch.from_numpy(inputs["bn_w"])).sum().backward()
    got = _ranks(outs, "bn_masked_global")
    np.testing.assert_allclose(np.concatenate([g[0] for g in got]), y.detach().numpy(), rtol=1e-5, atol=1e-5)
    for _, gm, gv in got:
        np.testing.assert_allclose(gm, m.detach().numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gv, v.detach().numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.concatenate(_ranks(outs, "bn_global_grad")), x.grad.numpy(),
                               rtol=1e-4, atol=1e-5)
    pmeaned = _ranks(outs, "bn_masked_pmean")[0][1]
    assert not np.allclose(pmeaned, m.detach().numpy(), atol=1e-4)


def test_f_g_and_all_gather_gradients_match_closed_forms(world):
    """f (copy_to_group): the all-reduce of the cotangents, sum(r + 1) on
    every rank; g (reduce_from_group): the sum forward and this rank's own
    cotangent r + 1 backward; all_gather: the reduce-scatter of the
    cotangents, sum over ranks of (r + 1) * the rank's slice of arange."""
    inputs, outs = world
    total = sum(r + 1 for r in range(WORLD))
    x = inputs["x"].reshape(WORLD, 4)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["f_grad"], np.full(4, float(total), np.float32))
        np.testing.assert_array_equal(o["g_grad"], np.full(4, float(r + 1), np.float32))
        np.testing.assert_array_equal(o["g_out"], x.sum(axis=0))
        np.testing.assert_array_equal(o["all_gather_grad"],
                                      total * np.arange(r * 4, (r + 1) * 4, dtype=np.float32))


def test_replicate_broadcasts_rank_0s_values(world):
    """replicate(mesh, module or tensors): every rank holds rank 0's values,
    as impx's replicate places one array everywhere."""
    _, outs = world
    for out in outs:
        np.testing.assert_array_equal(out["replicate_module"], np.ones((2, 3), np.float32))
        np.testing.assert_array_equal(out["replicate_list"], np.zeros(3, np.float32))
