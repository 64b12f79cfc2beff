"""The program's spans and counters (impx_torch/tools/profiling.py) over one
cell, on the card: the cost of tracing on, the spans' coverage of the
device's time, the device's busy and idle time by span, and the key counter.

    python3 benchmark/spans.py --workload <cell> --seed <n> [--seconds 20]

After the cell's set-up (its driver's, as benchmark/run.py makes it):
1. windows of --seconds, closed loop as the driver's, with tracing off and
   on (no profiler) in turns (TURNS), so that a drift of the host over the
   run falls on both;
2. one turn of the pool under device activity alone with tracing off, then
   one with tracing on: their device operations a call, which tracing must
   not change; the device's idle time by the innermost span open on the host
   at that moment (any thread), a step or call; the key counter;
3. GAP_CALLS calls under host and device activity with tracing on: each
   device operation is put down to the span open on the thread that launched
   it, at the launch (the CUDA runtime call that shares the operation's
   correlation id): the coverage of the spans, the device time by span, and
   the dense part of the layers (under impx.layer, not under impx.attn)
   against its least time. The profiler's thread ids are mapped to the
   spans' through the spans' own ranges.

Times are the Unix clock in ns, for the spans (`time.time_ns()`) as for the
profiler's events on the card (torch 2.11, CUDA 12.8); two checks read how
far apart the clocks are: each span's start against its profiler range's,
and MARKERS kernel launches after each session's calls, each between two
reads of the host's clock. Prints one JSON line. The benchmark's own runs
never run this."""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchlib import core, peaks, work  # noqa: E402
from reference.matcher import sharing_layers  # noqa: E402

GAP_CALLS = 2
TURNS = (False, True, True, False, True, False, False, True)   # tracing off / on a window, in turns


# ---------------------------------------------------------------- the sweep
def sweep(spans: list, points: list) -> list:
    """For each time in `points` ((t_ns, thread or None), sorted by time),
    the index of the innermost span open then: on that thread, or, with None
    or on a thread with no span open (autograd's between two of its spans),
    on any thread (the open span that started last). spans: (name,
    start_ns, end_ns, parent, thread) by index; a thread's spans nest."""
    bounds = sorted([(s[1], 1, i) for i, s in enumerate(spans)] + [(s[2], 0, i) for i, s in enumerate(spans)])
    stacks: dict[int, list] = {}
    out, b = [], 0
    for t, thread in points:
        while b < len(bounds) and bounds[b][0] <= t:
            _, opening, i = bounds[b]
            stack = stacks.setdefault(spans[i][4], [])
            if opening:
                stack.append(i)
            elif i in stack:
                stack.remove(i)
            b += 1
        st = stacks.get(thread)
        if st:
            out.append(st[-1])
        else:
            tops = [st[-1] for st in stacks.values() if st]
            out.append(max(tops, key=lambda i: spans[i][1]) if tops else None)
    return out


def chain(spans: list, i) -> list:
    """The names of span i and of every span that encloses it."""
    names = []
    while i is not None:
        names.append(spans[i][0])
        i = spans[i][3]
    return names


def by_name(spans: list, owners: list, amounts: list) -> tuple[dict, dict]:
    """(inclusive, self) sums of `amounts` by span name: inclusive counts an
    amount under every span of its owner's chain, self under the owner
    alone (None: under no span)."""
    inclusive, own = {}, {}
    for i, x in zip(owners, amounts):
        if not x:
            continue
        name = None if i is None else spans[i][0]
        own[name] = own.get(name, 0) + x
        for n in set(chain(spans, i)):
            inclusive[n] = inclusive.get(n, 0) + x
    return inclusive, own


def idle_by_span(spans: list, ops: list, lo: int, hi: int) -> tuple[dict, dict]:
    """The device's idle time in [lo, hi] (covered by no operation of `ops`,
    (start_ns, end_ns)), by the innermost span open on the host then:
    (inclusive, self) in ns. Between two span boundaries the innermost span
    stays the same, so each stretch between boundaries takes its overlap
    with the idle gaps."""
    from benchlib.trace import gaps

    idle = gaps(ops, lo, hi)
    cuts = sorted({lo, hi} | {t for s in spans for t in (s[1], s[2]) if lo < t < hi})
    owners = sweep(spans, [((a + b) / 2, None) for a, b in zip(cuts, cuts[1:])])
    amounts, g = [], 0
    for a, b in zip(cuts, cuts[1:]):
        while g < len(idle) and idle[g][1] <= a:
            g += 1
        x, k = 0, g
        while k < len(idle) and idle[k][0] < b:
            x += max(0, min(b, idle[k][1]) - max(a, idle[k][0]))
            k += 1
        amounts.append(x)
    return by_name(spans, owners, amounts)


# ---------------------------------------------------------------- the events
def kineto_events(prof) -> tuple[list, list, list]:
    """(device operations (name, start_ns, end_ns, correlation), runtime
    calls {correlation: (start_ns, thread, name)}, host ranges (name,
    start_ns, thread)) of a finished session; user annotations are no device
    operation."""
    from torch.autograd import DeviceType

    ops, launches, ranges = [], {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append((e.name(), e.start_ns(), e.end_ns(), e.correlation_id()))
        elif e.is_user_annotation():
            ranges.append((e.name(), e.start_ns(), e.start_thread_id()))
        elif e.name().startswith("cu"):
            launches[e.correlation_id()] = (e.start_ns(), e.start_thread_id(), e.name())
    ops.sort(key=lambda o: o[1])
    return ops, launches, ranges


def span_rows(rec) -> list:
    return [(s.name, s.start_ns, s.end_ns, s.parent, s.thread) for s in rec.spans if s.end_ns is not None]


def nearest_ranges(spans: list, ranges: list) -> list:
    """For each span, the profiler range of its name that starts nearest to
    it: (start_ns, thread), or None."""
    import bisect

    by_name = {}
    for name, start, thread in sorted(ranges, key=lambda r: r[1]):
        by_name.setdefault(name, []).append((start, thread))
    out = []
    for name, start, *_ in spans:
        v = by_name.get(name)
        if not v:
            out.append(None)
            continue
        k = bisect.bisect_left(v, (start,))
        out.append(min(v[max(k - 1, 0):k + 1], key=lambda r: abs(r[0] - start)))
    return out


def clock_gaps_us(spans: list, near: list) -> list | None:
    """(least, median, largest) of each span's start less its nearest
    range's, in us."""
    gaps = sorted((s[1] - r[0]) / 1e3 for s, r in zip(spans, near) if r is not None)
    return [gaps[0], gaps[len(gaps) // 2], gaps[-1]] if gaps else None


def launch_owners(spans: list, ops: list, launches: dict, threads: dict) -> tuple[list, int]:
    """Each device operation's span: the innermost open on the launching
    thread at its launch (`threads` maps the profiler's thread ids to the
    spans'; on any thread where it maps none); (owners, operations whose
    launch was not recorded, which belong to no span)."""
    found = sorted((launches[op[3]][0], launches[op[3]][1], k) for k, op in enumerate(ops) if op[3] in launches)
    owners = [None] * len(ops)
    for (_, _, k), i in zip(found, sweep(spans, [(t, threads.get(th)) for t, th, _ in found])):
        owners[k] = i
    return owners, len(ops) - len(found)


# ------------------------------------------------------------- the dense work
def dense_work(matcher: dict, n0: list, n1: list) -> tuple[float, float]:
    """(flops, bytes) of the layers' dense part for one call of pairs with
    n0[i], n1[i] valid keypoints: the projections (q, k, v; v alone in a
    layer that shares), the merge and the MLP (2d -> 2d -> d), each
    product's input read once and its output written once (fp32 or bf16 by
    the compute dtype), its weights read once a call."""
    d = matcher["descriptor_dim"]
    size = 2 if matcher["compute_dtype"] == "bfloat16" else 4
    its = [work.tokens_per_iteration(matcher, a, b) for a, b in zip(n0, n1)]
    flops = nbytes = 0.0
    for layer, share in enumerate(sharing_layers(matcher["n_layers"])):
        tokens = sum(sum(pair[layer // 2]) for pair in its)
        proj = 1 if share else 3
        flops += 2.0 * ((2 if share else 4) * d * d + 6 * d * d) * tokens
        words = proj * 2 * d + 2 * d + 4 * d + 3 * d   # (input + output) words a token of each product
        nbytes += size * (words * tokens + (proj + 1) * d * d + 6 * d * d)
    return flops, nbytes


# ------------------------------------------------------------------- the run
MARKERS = 8   # launches after a session's calls, whose host times bound the clocks' offset


def offset(marks: list, launches: dict) -> tuple[int, int]:
    """The bounds (lo, hi) of the profiler's clock less the host's, in ns:
    each marker's launch (the session's last kernel launches), as the
    profiler stamps it, lies between the two host reads around it."""
    times = sorted(t for t, _, name in launches.values() if name.startswith("cudaLaunchKernel"))[-len(marks):]
    lo = max(t - b for (_, b), t in zip(marks, times))
    hi = min(t - a for (a, _), t in zip(marks, times))
    return lo, hi


def profiled(call, first: int, count: int, activities, rec_on: bool, device):
    """count calls under a profiler session, then MARKERS launches of one
    kernel each between two reads of the host's clock; (the calls' device
    operations, runtime calls, host ranges, recording or None, offset
    bounds), the device synchronised before the calls and after them."""
    import torch
    from torch.profiler import profile

    from impx_torch.tools import profiling

    x = torch.zeros(1, device=device)
    torch.cuda.synchronize()
    prof = profile(activities=activities)
    prof.start()
    torch.cuda.synchronize()
    rec = None
    if rec_on:
        with profiling.recording() as rec:
            for k in range(count):
                call(first + k)
    else:
        for k in range(count):
            call(first + k)
    torch.cuda.synchronize()
    marks = []
    for _ in range(MARKERS):
        a = time.time_ns()
        x.add_(1)
        marks.append((a, time.time_ns()))
    torch.cuda.synchronize()
    prof.stop()
    ops, launches, ranges = kineto_events(prof)
    return [op for op in ops if op[1] < marks[0][0]], launches, ranges, rec, offset(marks, launches)


class GcTime:
    """The garbage collector's time and passes, as a gc callback."""

    def __init__(self):
        self.ns = self.passes = self._t = 0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t = time.perf_counter_ns()
        else:
            self.ns += time.perf_counter_ns() - self._t
            self.passes += 1


def measure(cell, seed: int, seconds: float, device) -> dict:
    import torch
    from torch.profiler import ProfilerActivity

    from benchlib.trace import Tracer, busy_union
    from impx_torch.tools import profiling

    run = core.driver_module(cell).Run(cell, seed, device)
    run.setup()
    train = cell.workload["driver"] == "train_loop"
    rate = "train_pairs_per_s" if train else "pairs_per_s"
    out = {"workload": cell.name, "seed": seed, "device": torch.cuda.get_device_name(device)}

    # 1. tracing off and on, no profiler, in turns
    windows = []
    for on in TURNS:
        collector = GcTime()
        gc.callbacks.append(collector)
        if on:
            with profiling.recording():
                w = run.window(seconds)
        else:
            w = run.window(seconds)
        gc.callbacks.remove(collector)
        windows.append({"on": on, rate: w["metrics"][rate], "calls": w["attempted"], "seconds": w["seconds"],
                        "gc_ms": collector.ns / 1e6, "gc_passes": collector.passes})
    out["windows"] = windows
    off = [w[rate] for w in windows if not w["on"]]
    on = [w[rate] for w in windows if w["on"]]
    out["tracing_cost_pct"] = 100.0 * (1.0 - statistics.mean(on) / statistics.mean(off))
    mean_call_ns = 1e9 * statistics.mean(w["seconds"] / w["calls"] for w in windows if not w["on"])

    # 2. a pool turn under device activity alone, tracing off, then on (the
    # profiler's first start, which slows the host's launches from then on,
    # after the windows)
    Tracer.warm_up()
    calls = len(run.pool)
    first = run.next + 10 ** 6
    turns = {}
    for rec_on in (False, True):
        turns[rec_on] = profiled(run.call, first, calls, [ProfilerActivity.CUDA], rec_on, device)
        first += calls
    out["device_ops_per_call"] = {"off": len(turns[False][0]) / calls, "on": len(turns[True][0]) / calls}
    ops, launches, _, rec, offsets = turns[True]
    spans = span_rows(rec)
    lo, hi = ops[0][1], max(e for _, _, e, _ in ops)
    busy = busy_union([(s, e) for _, s, e, _ in ops], lo, hi)
    inclusive, own = idle_by_span(spans, [(s, e) for _, s, e, _ in ops], lo, hi)
    out["device_only"] = {
        "calls": calls, "busy_ms_a_call": busy / calls / 1e6, "untraced_ms_a_call": mean_call_ns / 1e6,
        "runtime_calls_recorded": len(launches), "offset_us": [x / 1e3 for x in offsets],
        "offset_off_us": [x / 1e3 for x in turns[False][4]],
        "idle_ms_a_call_inclusive": {str(k): v / calls / 1e6 for k, v in sorted(inclusive.items(), key=str)},
        "idle_ms_a_call_self": {str(k): v / calls / 1e6 for k, v in sorted(own.items(), key=str)},
        "idle_share_pct": {str(k): 100.0 * v / calls / mean_call_ns for k, v in inclusive.items()}}
    idle = hi - lo - busy
    untraced_idle = max(0.0, 1.0 - busy / calls / mean_call_ns)
    out["device_only"]["idle_ms_a_call"] = idle / calls / 1e6
    out["device_only"]["untraced_idle_share_pct"] = 100.0 * untraced_idle
    # the traced turn's idle by span, in shares of the untraced idle: the
    # profiler's record of each launch lengthens the host's work, and so the
    # idle, under the spans that launch most
    out["device_only"]["idle_apportioned_pct"] = {str(k): 100.0 * untraced_idle * v / idle
                                                  for k, v in inclusive.items()}
    if train:
        out["head_backward_idle_pct"] = 100.0 * inclusive.get("impx.head.backward", 0) / calls / mean_call_ns
        out["optimizer_idle_pct"] = 100.0 * inclusive.get("impx.train.optimizer", 0) / calls / mean_call_ns
    kept, walked = profiling.key_use(rec)
    if walked:
        out["key_use_pct"] = 100.0 * kept / walked

    # 3. host-traced calls, tracing on
    ops, launches, ranges, rec, offsets = profiled(run.call, first, GAP_CALLS,
                                                   [ProfilerActivity.CPU, ProfilerActivity.CUDA], True, device)
    spans = span_rows(rec)
    near = nearest_ranges(spans, ranges)
    threads = {r[1]: s[4] for s, r in zip(spans, near) if r is not None}   # the profiler's thread -> the spans'
    owners, lost = launch_owners(spans, ops, launches, threads)
    durations = [e - s for _, s, e, _ in ops]
    inclusive, own = by_name(spans, owners, durations)
    total = sum(durations)
    host = {"calls": GAP_CALLS, "device_ops": len(ops), "launch_not_found": lost,
            "offset_us": [x / 1e3 for x in offsets], "threads": {str(k): v for k, v in threads.items()},
            "launches_on_a_span_thread": sum(th in threads for _, th, _ in launches.values()),
            "runtime_calls": len(launches), "range_gap_us": clock_gaps_us(spans, near),
            "device_ms_a_call_inclusive": {str(k): v / GAP_CALLS / 1e6 for k, v in inclusive.items()},
            "device_ms_a_call_self": {str(k): v / GAP_CALLS / 1e6 for k, v in own.items()}}
    if train:
        phases = sum(inclusive.get(f"impx.train.{p}", 0) for p in ("forward", "backward", "optimizer"))
        host["coverage_step_phases_pct"] = 100.0 * phases / total
    else:
        match = inclusive.get("impx.match", 0)
        host["coverage_match_pct"] = 100.0 * match / total
        host["coverage_children_of_match_pct"] = 100.0 * (match - own.get("impx.match", 0)) / match if match else None
        dense_s = (inclusive.get("impx.layer", 0) - inclusive.get("impx.attn", 0)) / 1e9
        m = cell.config["matcher"]
        least = 0.0
        for c in range(GAP_CALLS):
            least += peaks.least_seconds(*dense_work(m, *run.counts[(first + c) % len(run.pool)]),
                                         m["compute_dtype"])
        host["dense_ms_a_call"] = 1e3 * dense_s / GAP_CALLS
        host["dense_least_ms_a_call"] = 1e3 * least / GAP_CALLS
        out["dense_roofline_pct"] = 100.0 * least / dense_s if dense_s > 0 else None
    out["host_traced"] = host
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("spans: needs a CUDA card", file=sys.stderr)
        return 2
    out = measure(core.load_cell(args.workload), args.seed, args.seconds, torch.device("cuda", 0))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
