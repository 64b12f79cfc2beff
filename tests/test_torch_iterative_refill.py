"""The port's slot-refill loop (impx_torch/eval/iterative_refill.py) against
impx's iterative_refill_queue on the CPU, given impx's draws: a pair's key
is fold_in(key, pair_id), reused at each of its checkpoints. Setup in
tests/torch_loop_parity.py; impx runs under jax.jit (its loop is one
program)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from impx.eval.iterative_refill import iterative_refill_queue as jax_refill
from impx.models import DGNNS as JaxDGNNS, MatcherConfig as JaxConfig
from impx.models.fast import stack_params as jax_stack_params

from impx_torch.eval.iterative_refill import iterative_refill_queue, run_iterative_refill
from impx_torch.models.fast import stack_params
from torch_loop_parity import (GRIDS, LOOP_KW, REFUSED, SMALL, assert_equal_to_impx, impx_draws, jax_params,
                               port, queue, refused_model)

KEY = jax.random.PRNGKey(7)
SLOTS = 3
# Q = 5 is not a multiple of the slots (the queue wraps, exhausted slots
# idle); Q = 2 leaves a slot empty from the start (the sink row)
CASES = {"Q5-carry-qk": ((11, (12, 13), 14, (15, 16), 17), GRIDS["carry-qk"]),
         "Q2-no-carry": ((18, (19, 20)), GRIDS["no-carry"])}


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
def test_refill_equals_impx_given_its_draws(params, case):
    seeds, grid = CASES[case]
    q = queue(seeds)
    want = jax_refill(JaxDGNNS(JaxConfig(**SMALL)), jax_stack_params(params, JaxConfig(**SMALL)),
                      {k: jnp.asarray(v) for k, v in q.items()}, KEY, slots=SLOTS, valid_its=grid, **LOOP_KW)
    got = iterative_refill_queue(port(params), q, 0, slots=SLOTS, valid_its=grid, **LOOP_KW,
                                 samples=impx_draws(lambda seed, pid: jax.random.fold_in(KEY, pid)))
    assert_equal_to_impx(got, want, counters=("n_steps", "completed"))
    assert got["completed"] == len(seeds)
    stops = got["stopped_at"].tolist()
    assert min(stops) < SMALL["n_layers"] and max(stops) == SMALL["n_layers"], stops
    # one host read a step, and one before the first
    assert got["host_reads"] == got["n_steps"] + 1


def test_refill_is_bitwise_invariant_to_queue_order(params):
    """Permuting the queue (pair_ids carrying each pair's identity) permutes
    every output exactly, as impx's test_refill_scheduling_invariance pins."""
    q = queue((21, (22, 23), 24, 25, (26, 27)))
    model = port(params)
    kw = dict(slots=SLOTS, valid_its=GRIDS["carry-qk"], **LOOP_KW)
    a = run_iterative_refill(model, q, 3, **kw)
    perm = np.array([4, 0, 3, 1, 2])
    qp = {k: v[perm] for k, v in q.items()}
    qp["pair_ids"] = perm
    b = run_iterative_refill(model, qp, 3, **kw)
    inv = np.argsort(perm)
    for k in ("indices0", "mscores0", "R", "t", "has_pose", "converged", "stopped_at"):
        assert torch.equal(a[k], b[k][inv]), k
    assert a["completed"] == b["completed"] == 5
    assert not a["converged"].all() and a["converged"].any()


def test_stack_params_matches_impx(params):
    """The stacked view of the port's weights equals impx's stack_params,
    shared layers with zero q/k and the shared flag."""
    model = port(params)
    want = jax_stack_params(params, JaxConfig(**SMALL))
    got = stack_params(model)
    for kind in ("self", "cross"):
        np.testing.assert_array_equal(got[kind]["shared"].numpy(), np.asarray(want[kind]["shared"]) > 0.5)
        for name in ("q", "k", "v", "merge", "mlp0", "mlp1"):
            for leaf in ("w", "b"):
                np.testing.assert_array_equal(got[kind][name][leaf].numpy(), np.asarray(want[kind][name][leaf]),
                                              err_msg=f"{kind} {name} {leaf}")
    np.testing.assert_array_equal(got["final_w"].numpy(), np.asarray(want["final_w"]))
    np.testing.assert_array_equal(got["final_b"].numpy(), np.asarray(want["final_b"]))
    assert got["self"]["shared"].any()
    bf16 = stack_params(port(params, compute_dtype="bfloat16"))
    assert bf16["self"]["q"]["w"].dtype == torch.bfloat16 and bf16["final_w"].dtype == torch.float32


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refill_refuses_what_impx_does_not_serve(name):
    with pytest.raises(ValueError):
        run_iterative_refill(refused_model(name), queue((1,)), 0, slots=SLOTS)
