"""The port's staged-cohort loop (impx_torch/eval/iterative_staged.py)
against impx's iterative_staged_queue on the CPU, given impx's draws: a
pair's key is fold_in(key, pair_id), reused at each of its checkpoints.
Setup in tests/torch_loop_parity.py; impx runs under jax.jit."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from impx.eval.iterative_staged import iterative_staged_queue as jax_staged
from impx.models import DGNNS as JaxDGNNS, MatcherConfig as JaxConfig
from impx.models.fast import stack_params as jax_stack_params

from impx_torch.eval.iterative_refill import run_iterative_refill
from impx_torch.eval.iterative_staged import _segments, iterative_staged_queue, run_iterative_staged
from torch_loop_parity import (GRIDS, LOOP_KW, REFUSED, SMALL, assert_equal_to_impx, impx_draws, jax_params,
                               port, queue, refused_model)

KEY = jax.random.PRNGKey(7)
BATCH = 3
# Q = 5 is not a multiple of the cohort size; Q = 2 makes the cohort smaller
# than `batch`; (1, 3) leaves layers 4 and 5 as a trailing segment with no
# checkpoint
CASES = {"Q5-carry-qk": ((11, (12, 13), 14, (15, 16), 17), GRIDS["carry-qk"]),
         "Q2-no-carry": ((18, (19, 20)), GRIDS["no-carry"]),
         "Q5-trailing": ((21, (22, 23), 24, (25, 26), 27), (1, 3))}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def params():
    return jax_params()


@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_equals_impx_given_its_draws(params, case):
    seeds, grid = CASES[case]
    q = queue(seeds)
    want = jax_staged(JaxDGNNS(JaxConfig(**SMALL)), jax_stack_params(params, JaxConfig(**SMALL)),
                      {k: jnp.asarray(v) for k, v in q.items()}, KEY, batch=BATCH, valid_its=grid, **LOOP_KW)
    got = iterative_staged_queue(port(params), q, 0, batch=BATCH, valid_its=grid, **LOOP_KW,
                                 samples=impx_draws(lambda seed, pid: jax.random.fold_in(KEY, pid)))
    assert_equal_to_impx(got, want, counters=("n_steps", "completed"))
    assert got["completed"] == len(seeds)
    stops = got["stopped_at"].tolist()
    assert min(stops) < SMALL["n_layers"] and max(stops) == SMALL["n_layers"], stops
    assert got["host_reads"] == got["n_steps"] + 1


def test_segments_and_carry_rule():
    """The segments of impx's `_segments`, and when q/k cross a boundary:
    a later segment starting on a shared iteration (3 or 5 here)."""
    assert _segments(6, (1, 3, 5)) == [((0, 1), 1), ((2, 3), 3), ((4, 5), 5)]
    assert _segments(6, (1, 3)) == [((0, 1), 1), ((2, 3), 3), ((4, 5), None)]
    assert _segments(15, (3, 5, 7, 9, 11, 13, 14))[-1] == ((14,), 14)
    sharing = [i >= 3 and i % 2 == 1 for i in range(6)]   # DGNNS's iterations that share, at 6 layers
    for grid, carry in ((GRIDS["carry-qk"], True), (GRIDS["no-carry"], False), ((1, 3), False)):
        assert any(sharing[layers[0]] for layers, _ in _segments(6, grid)[1:]) == carry, grid


def test_staged_is_bitwise_invariant_to_queue_order_and_agrees_with_refill(params):
    """Permuting the queue permutes every output exactly; the refill loop,
    under the same pair-identity seeds, gives each pair the same stop,
    matches and pose."""
    q = queue((31, (32, 33), 34, 35, (36, 37)))
    model = port(params)
    kw = dict(valid_its=GRIDS["carry-qk"], **LOOP_KW)
    a = run_iterative_staged(model, q, 3, batch=BATCH, **kw)
    perm = np.array([2, 4, 0, 1, 3])
    qp = {k: v[perm] for k, v in q.items()}
    qp["pair_ids"] = perm
    b = run_iterative_staged(model, qp, 3, batch=BATCH, **kw)
    inv = np.argsort(perm)
    for k in ("indices0", "mscores0", "R", "t", "has_pose", "converged", "stopped_at"):
        assert torch.equal(a[k], b[k][inv]), k
    assert a["completed"] == b["completed"] == 5
    assert not a["converged"].all() and a["converged"].any()
    r = run_iterative_refill(model, q, 3, slots=BATCH, **kw)
    for k in ("indices0", "converged", "stopped_at", "has_pose"):
        assert torch.equal(a[k], r[k]), k
    torch.testing.assert_close(r["R"], a["R"], rtol=0, atol=1e-5)
    torch.testing.assert_close(r["t"], a["t"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_staged_refuses_what_impx_does_not_serve(name):
    with pytest.raises(ValueError):
        run_iterative_staged(refused_model(name), queue((1,)), 0, batch=BATCH)
