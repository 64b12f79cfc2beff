"""The work counts (benchlib/work.py) against a brute count of the products
that the plain reference computes at tiny shapes, and the arithmetic of the
p95 and of the idle share."""
from __future__ import annotations

import statistics

import pytest
import torch

from conftest import small_cell


class CountingPlain:
    """A reference precision that counts 2 flops a multiply-add of every
    product, and those of the attention's two products apart."""

    def __init__(self):
        self.flops = 0.0
        self.attention = 0.0

    def mm(self, a, b):
        out = torch.matmul(a, b)
        flops = 2.0 * out.numel() * a.shape[-1]
        self.flops += flops
        if a.dim() == 4 and b.dim() == 4:
            self.attention += flops
        return out


@pytest.mark.parametrize("n", [24, 40])
def test_forward_flops_count_the_reference_products(n):
    from benchlib import core, weights, work
    from reference import matcher as ref

    cell = small_cell("imp_match_yfcc", layers=3, slots=n, pairs=1)
    m = cell.config["matcher"]
    gen = torch.Generator().manual_seed(0)
    W = weights.make_weights(cell.config, gen, torch.device("cpu"))
    pool = core.generator_module(cell.traffic).make_pool(
        {**cell.traffic, "valid": [n, n]}, m["descriptor_dim"], gen, torch.device("cpu"))
    P = CountingPlain()
    with torch.no_grad():
        ref.imp_matches(P, W, m, pool[0])
    cells = (n + 1) * (n + 1)
    # everything but the Sinkhorn head's 7 non-product flops a cell is a product
    assert P.flops == work.forward_flops(m, n, n, False) - 7 * cells
    assert P.attention == work.attention_forward_work(m, n, n)[0]


def test_tokens_follow_the_compaction_buckets():
    from benchlib import work

    m = {"n_layers": 15, "compaction": [[4, 1024], [8, 512], [12, 256]]}
    its = work.tokens_per_iteration(m, 1900, 700)
    assert its[:4] == [(1900, 700)] * 4
    assert its[4:8] == [(1024, 700)] * 4 and its[8:12] == [(512, 512)] * 4 and its[12:] == [(256, 256)] * 3


def test_sinkhorn_work_counts_every_head_for_eimp():
    from benchlib import work

    m = {"n_layers": 3, "compaction": [], "sinkhorn_iterations": 20}
    one, _ = work.sinkhorn_work(m, 10, 20, False)
    three, _ = work.sinkhorn_work(m, 10, 20, True)
    assert one == 11 * 21 * 87 and three == 3 * one


def test_p95_is_over_every_call():
    from benchlib import core

    lat = [float(x) for x in range(1, 201)]       # 200 calls, 10 beyond the 95th percentile
    assert core.p95(lat) == statistics.quantiles(lat, n=20)[18]
    assert 190 < core.p95(lat) < 191
    lat[-1] = 1e6                                  # one stall among the last ten moves nothing below them
    assert core.p95(lat) == statistics.quantiles(lat, n=20)[18]


def test_busy_union_and_idle_share_of_synthetic_intervals():
    from benchlib import core, trace

    ops = [("a", 0.0, 10.0), ("b", 5.0, 15.0), ("c", 20.0, 30.0), ("d", 40.0, 60.0)]
    assert trace.busy_union([(s, e) for _, s, e in ops], 0.0, 50.0) == 15 + 10 + 10
    assert trace.gaps([(s, e) for _, s, e in ops], 0.0, 50.0) == [(15.0, 20.0), (30.0, 40.0)]
    host = [("bench.call", 0.0, 50.0), ("aten::nonzero", 14.0, 22.0), ("aten::item", 29.0, 45.0),
            ("aten::mm", 16.0, 19.0), ("cudaLaunchKernel", 17.0, 18.0)]
    t = trace.Trace(ops, 50e-6, 35e-6, 2, trace.idle_gaps(ops, host, 0.0, 50.0))
    reader = core.load_module(core.BENCH / "metrics" / "idle_share.match.py", "idle_reader")
    view = core.View(t, {}, [], 50e-6, [([1], [1])] * 2)   # the untraced window: 2 calls in 50 us
    assert reader.read(view) == pytest.approx(100.0 * (1 - 35 / 50))
    slow = core.View(t, {}, [], 100e-6, [([1], [1])] * 2)  # untraced calls twice as long
    assert reader.read(slow) == pytest.approx(100.0 * (1 - 35 / 100))
    assert dict(t.gaps) == pytest.approx({"aten::mm": 5e-6, "aten::item": 10e-6})
    assert t.breakdown()["device_ops"][0] == ["d", pytest.approx(20e-6)]
