"""benchmark/spans.py's reduction on hand-built spans and device operations:
the innermost span by thread and time, the device time and idle time by
span, and the dense work against a brute count of the layers' products."""
from __future__ import annotations

import json

import spans as S
from conftest import BENCH

# (name, start, end, parent, thread): a call on thread 1 whose backward
# span runs on thread 2 inside it
SPANS = [("impx.match", 0, 100, None, 1), ("impx.layer", 10, 40, 0, 1), ("impx.attn", 20, 30, 1, 1),
         ("impx.head", 50, 90, 0, 1), ("impx.head.backward", 60, 80, 3, 2)]


def test_the_innermost_span_by_thread_and_time():
    points = [(5, 1), (15, 1), (25, 1), (25, None), (45, 1), (65, 1), (65, None), (65, 2), (95, 2), (120, None)]
    # thread 2 at 95 has no span open: the latest open on any thread, impx.match
    assert S.sweep(SPANS, points) == [0, 1, 2, 2, 0, 3, 4, 4, 0, None]
    assert S.chain(SPANS, 2) == ["impx.attn", "impx.layer", "impx.match"]


def test_device_time_by_the_launching_span():
    ops = [("k1", 30, 35, 7), ("k2", 41, 50, 8), ("k3", 70, 75, 9), ("k4", 80, 85, 10)]
    # k4's launch was not recorded; the profiler numbers the threads 11, 12
    launches = {7: (12, 11, "cudaLaunchKernel"), 8: (25, 11, "cudaLaunchKernel"), 9: (66, 12, "cudaLaunchKernel")}
    owners, lost = S.launch_owners(SPANS, ops, launches, {11: 1, 12: 2})
    assert owners == [1, 2, 4, None] and lost == 1
    # on thread 1 at 66 the innermost is impx.head; on no mapped thread, and on
    # thread 2 with none of its spans open, the latest open on any thread
    assert S.launch_owners(SPANS, ops[2:3], {9: (66, 11, "c")}, {11: 1})[0] == [3]
    assert S.launch_owners(SPANS, ops[2:3], {9: (66, 13, "c")}, {11: 1})[0] == [4]
    assert S.launch_owners(SPANS, ops[2:3], {9: (85, 12, "c")}, {12: 2})[0] == [3]
    inclusive, own = S.by_name(SPANS, owners, [e - s for _, s, e, _ in ops])
    assert inclusive == {"impx.match": 19, "impx.layer": 14, "impx.attn": 9, "impx.head": 5,
                         "impx.head.backward": 5}
    assert own == {"impx.layer": 5, "impx.attn": 9, "impx.head.backward": 5, None: 5}


def test_idle_time_by_the_innermost_open_span():
    ops = [(0, 22), (28, 62), (78, 100)]
    inclusive, own = S.idle_by_span(SPANS, ops, 0, 100)
    # idle 22-28 (attn), 62-78 (head.backward 62-78 on thread 2)
    assert own == {"impx.attn": 6, "impx.head.backward": 16}
    assert inclusive == {"impx.attn": 6, "impx.layer": 6, "impx.match": 22, "impx.head.backward": 16,
                         "impx.head": 16}


def test_dense_work_equals_a_brute_count():
    """Every product of every layer counted one by one at the cell's widths,
    for a call of two pairs: the projections (v alone where the layer
    shares), merge and MLP, each product's operands read once and its output
    written once, its weights once a call."""
    from benchlib.work import tokens_per_iteration
    from reference.matcher import sharing_layers

    cfg = json.loads((BENCH / "configs" / "eimp.json").read_text())["matcher"]
    d, n0, n1 = cfg["descriptor_dim"], [1800, 2000], [1700, 1200]
    flops = nbytes = 0
    for layer, share in enumerate(sharing_layers(cfg["n_layers"])):
        tokens = sum(sum(tokens_per_iteration(cfg, a, b)[layer // 2]) for a, b in zip(n0, n1))
        products = [(d, d)] * (1 if share else 3) + [(d, d), (2 * d, 2 * d), (2 * d, d)]
        for n_in, n_out in products:
            flops += 2 * tokens * n_in * n_out
            nbytes += 4 * (tokens * (n_in + n_out) + n_in * n_out)
    assert S.dense_work(cfg, n0, n1) == (flops, nbytes)


def test_spans_meet_their_ranges_and_the_clock_offset():
    """Each span finds the range of its name nearest to it, also when the
    profiler lost one; the markers' launches bound the clocks' offset."""
    ranges = [("impx.match", 3, 11), ("impx.layer", 12, 11), ("impx.head", 52, 11), ("impx.head.backward", 61, 12)]
    near = S.nearest_ranges(SPANS, ranges)
    assert near == [(3, 11), (12, 11), None, (52, 11), (61, 12)]
    assert S.clock_gaps_us(SPANS, near) == [-0.003, -0.002, -0.001]
    launches = {1: (5, 11, "cudaLaunchKernel"), 2: (130, 11, "cudaLaunchKernel"), 3: (150, 11, "cudaLaunchKernel"),
                4: (160, 11, "cudaDeviceSynchronize")}
    assert S.offset([(120, 128), (145, 152)], launches) == (2, 5)
