"""The port's GPipe forward (impx_torch/parallel/pp.py) on a world of 4 CPU
ranks over gloo against impx.parallel.pp.pipeline_forward_scan on the
conftest's virtual CPU devices, for impx's four (stages, microbatches)
cases at tests/test_pipeline_parallel.py:51-59's tolerances (indices0
equal, mscores0 rtol 1e-5 atol 1e-6, the plan rtol 1e-4 atol 1e-6), on
every stage rank; a 2-stage pipeline runs on ranks 0 and 1 of the world.
Then impx's bad-shape ValueErrors. The world spawns once for the module.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from impx.models import DGNNS as JaxDGNNS
from impx.models import MatcherConfig as JaxConfig
from impx.models.fast import stack_params
from impx.parallel.pp import make_stage_mesh as jax_make_stage_mesh
from impx.parallel.pp import pipeline_forward_scan as jax_pipeline_forward_scan

from impx_torch.models import DGNNS, MatcherConfig
from impx_torch.parallel.pp import pipeline_forward_scan
from impx_torch.tools.convert import params_from_jax, stage_layers, stage_state_dict

from torch_parallel_world import run_world

WORLD = 4
CASES = [(2, 2), (2, 1), (4, 2), (2, 4)]
FIELDS = dict(descriptor_dim=32, keypoint_encoder=(16, 32), n_layers=4, sinkhorn_iterations=10, norm_fn="in",
              n_min_tokens=8)


def _data(batch=4, n=24, dim=32, seed=0):
    """tests/test_pipeline_parallel.py:_setup's inputs."""
    rs = np.random.RandomState(seed)
    valid0 = np.ones((batch, n), bool)
    valid0[:, n - 3:] = False
    return {"descriptors0": rs.randn(batch, n, dim).astype(np.float32),
            "descriptors1": rs.randn(batch, n, dim).astype(np.float32),
            "norm_keypoints0": (rs.rand(batch, n, 2) - 0.5).astype(np.float32),
            "norm_keypoints1": (rs.rand(batch, n, 2) - 0.5).astype(np.float32),
            "scores0": rs.rand(batch, n).astype(np.float32), "scores1": rs.rand(batch, n).astype(np.float32),
            "valid0": valid0, "valid1": np.ones((batch, n), bool)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jmodel = JaxDGNNS(JaxConfig(**FIELDS))
    params = jmodel.init(jax.random.PRNGKey(0))
    stacked = stack_params(params, jmodel.config)
    data = _data()
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    refs = {}
    for n_stages, n_mb in CASES:
        out = jax_pipeline_forward_scan(jmodel, stacked, jdata, jax_make_stage_mesh(n_stages),
                                        n_microbatches=n_mb, p=0.2)
        refs[(n_stages, n_mb)] = {k: np.asarray(out[k][0]) for k in ("indices0", "mscores0", "scores")}
    cfg = MatcherConfig(**FIELDS)
    sd = params_from_jax(jax.tree.map(np.array, params), cfg)
    root = tmp_path_factory.mktemp("pp")
    outs = run_world(WORLD, "pp", root, config=dataclasses.asdict(cfg), state_dict=sd, data=data, cases=CASES)
    return refs, outs, cfg, sd


@pytest.mark.parametrize("n_stages,n_microbatches", CASES)
def test_pipeline_matches_impx(world, n_stages, n_microbatches):
    refs, outs, _, _ = world
    want = refs[(n_stages, n_microbatches)]
    for rank, out in enumerate(outs):
        got = out[(n_stages, n_microbatches)]
        if rank >= n_stages:
            assert got is None
            continue
        np.testing.assert_array_equal(got["indices0"], want["indices0"])
        np.testing.assert_allclose(got["mscores0"], want["mscores0"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-4, atol=1e-6)


class _Mesh:
    def __init__(self, n):
        self.n = n

    def size(self, axis):
        return self.n

    def group(self, axis):
        raise AssertionError("the shapes are checked before any communication")


def test_pipeline_rejects_bad_shapes():
    """impx's ValueErrors: 3 layers over 2 stages, a batch of 3 over 2
    microbatches; its norm_fn == 'in' assertion."""
    model = DGNNS(MatcherConfig(**{**FIELDS, "n_layers": 3}), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_forward_scan(model, _data(), _Mesh(2), n_microbatches=2)
    model4 = DGNNS(MatcherConfig(**FIELDS), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_forward_scan(model4, _data(batch=3), _Mesh(2), n_microbatches=2)
    bn = DGNNS(MatcherConfig(**{**FIELDS, "norm_fn": "bn"}), device="cpu")
    with pytest.raises(AssertionError, match="norm_fn='in'"):
        pipeline_forward_scan(bn, _data(), _Mesh(2))


def test_stage_state_dict_holds_the_stage_layers(world):
    """A stage's slice of the weights: its contiguous iterations' layers, the
    keypoint encoder, the final projections and bin_score."""
    _, _, cfg, sd = world
    assert list(stage_layers(cfg, 1, 2)) == [2, 3]
    part = stage_state_dict(sd, cfg, 1, 2)
    layers = {int(k.split(".")[1]) for k in part if k.startswith("gnn.")}
    assert layers == {4, 5, 6, 7}
    assert {k for k in sd if not k.startswith("gnn.")} <= part.keys()
