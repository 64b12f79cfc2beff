"""The port's lockstep loop (impx_torch/eval/iterative_fused.py) against
impx's iterative_fused_batched on the CPU, given impx's draws: pair b at
iteration it draws from split(keys[it], B)[b]. Setup in
tests/torch_loop_parity.py; impx runs under jax.jit."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from impx.eval.iterative_fused import iterative_fused_batched as jax_fused
from impx.models import AdaGMN as JaxAdaGMN, DGNNS as JaxDGNNS, MatcherConfig as JaxConfig
from impx.models.fast import stack_params as jax_stack_params

from impx_torch.eval.iterative_fused import iterative_fused_batched, run_iterative_fused
from impx_torch.models import AdaGMN
from torch_loop_parity import (GRIDS, LOOP_KW, REFUSED, SMALL, THRESH, assert_equal_to_impx, impx_draws,
                               jax_params, port, queue, refused_model)

KEY = jax.random.PRNGKey(7)
N_LAYERS = SMALL["n_layers"]
# a batch with a pair that never converges runs every layer; one whose pairs
# all converge stops early (impx's identity branch)
CASES = {"B3-carry-qk": ((11, (12, 13), 14), GRIDS["carry-qk"]),
         "B2-no-carry-early-exit": ((15, 17), GRIDS["no-carry"])}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def params():
    return jax_params()


def _impx(model, params, batch, grid, **kw):
    data = {k: jnp.asarray(v) for k, v in batch.items() if k != "norm_threshs"}
    return jax_fused(model, jax_stack_params(params, model.config), data, jax.random.split(KEY, N_LAYERS),
                     jnp.asarray(batch["norm_threshs"]), valid_its=grid, **LOOP_KW, **kw)


def _hook(b: int):
    """impx's key of pair i at iteration it (the port's seed `it`)."""
    keys = jax.random.split(KEY, N_LAYERS)
    return impx_draws(lambda it, i: jax.random.split(keys[it], b)[i])


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_equals_impx_given_its_draws(params, case):
    seeds, grid = CASES[case]
    batch = queue(seeds)
    b = len(seeds)
    want = _impx(JaxDGNNS(JaxConfig(**SMALL)), params, batch, grid)
    got = iterative_fused_batched(port(params), batch, list(range(N_LAYERS)), batch["norm_threshs"],
                                  valid_its=grid, **LOOP_KW, samples=_hook(b))
    assert_equal_to_impx(got, want)
    stops = got["stopped_at"].tolist()
    assert min(stops) < N_LAYERS, stops
    if got["converged"].all():
        # the loop stops after the checkpoint at which every pair converged
        assert got["n_steps"] == max(stops) < N_LAYERS
    else:
        assert got["n_steps"] == N_LAYERS and max(stops) == N_LAYERS
    assert got["checkpoints"] == got["host_reads"] == sum(i in grid for i in range(got["n_steps"]))


def test_uncertainty_pooling_keep_masks_equal_impx(params):
    """EIMP's pooling after each checkpoint (kernel 2's masses and kernel
    6's over the carried q/k, the threshold mscore_base x the inlier ratio
    a pair): each pool's new keep masks equal impx's, and so do the loop's
    outputs."""
    pools = {"impx": [], "port": []}

    class Recording(JaxAdaGMN):
        def _pool_from_masses(self, *args):
            new = super()._pool_from_masses(*args)
            jax.debug.callback(lambda a, b: pools["impx"].append((np.asarray(a), np.asarray(b))), *new)
            return new

    eimp_params = {**params, "bin_score": jnp.asarray(4.0, jnp.float32)}
    batch = queue((21, (22, 23), 24))
    grid = GRIDS["carry-qk"]
    want = _impx(Recording(JaxConfig(**SMALL)), eimp_params, batch, grid, with_uncertainty=True)
    model = port(eimp_params, AdaGMN)
    pool = model._pool_from_masses

    def recording(*args):
        new = pool(*args)
        pools["port"].append(tuple(x.numpy() for x in new))
        return new

    model._pool_from_masses = recording
    got = iterative_fused_batched(model, batch, list(range(N_LAYERS)), batch["norm_threshs"], valid_its=grid,
                                  with_uncertainty=True, **LOOP_KW, samples=_hook(3))
    assert len(pools["port"]) == len(pools["impx"]) == len(grid)
    for i, ((a0, a1), (b0, b1)) in enumerate(zip(pools["port"], pools["impx"])):
        np.testing.assert_array_equal(a0, b0, err_msg=f"pool {i}")
        np.testing.assert_array_equal(a1, b1, err_msg=f"pool {i}")
    assert_equal_to_impx(got, want)
    assert int((~got["keep0"]).sum() + (~got["keep1"]).sum()) > 0   # pooling dropped keypoints


def test_one_seed_for_every_layer_reuses_the_draws(params):
    """run_iterative_fused derives a seed a layer; passing one seed for every
    layer (the bench's reused key) gives every checkpoint of a pair the same
    generator, and the loop stays deterministic."""
    batch = queue((25, (26, 27)))
    model = port(params)
    seen = []
    real = impx_draws(lambda seed, i: jax.random.fold_in(KEY, 1000 * seed + i))

    def hook(keys, idx0, ms0):
        seen.append(list(keys))
        return real(keys, idx0, ms0)

    iterative_fused_batched(model, batch, [5] * N_LAYERS, batch["norm_threshs"], valid_its=GRIDS["no-carry"],
                            **LOOP_KW, samples=hook)
    assert seen and all(keys == [(5, 0), (5, 1)] for keys in seen)
    a = run_iterative_fused(model, batch, 2, THRESH, valid_its=GRIDS["no-carry"], **LOOP_KW)
    b = run_iterative_fused(model, batch, 2, THRESH, valid_its=GRIDS["no-carry"], **LOOP_KW)
    for k in ("indices0", "R", "t", "stopped_at"):
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_fused_refuses_what_impx_does_not_serve(name):
    batch = queue((1,))
    with pytest.raises(ValueError):
        run_iterative_fused(refused_model(name), batch, 0, THRESH)


def test_uncertainty_needs_an_eimp_model(params):
    batch = queue((1,))
    with pytest.raises(ValueError, match="AdaGMN"):
        run_iterative_fused(port(params), batch, 0, THRESH, with_uncertainty=True)
