"""torch.profiler over calls of the measured window, and its reduction.

A `Tracer` traces calls that follow the measured window, in two sessions,
one after the other, so that the profiler's cost touches no call of the
window. The first, over `count` calls (one turn of the cell's pool),
records device activity alone: its window is marked on the host clock with
the device synchronised at either end, and the device's busy time in it is
the union of the device operations' intervals. The per-layer metrics read
it, each against the untraced window's rate where it needs a wall time:
CUPTI's record of every launch still lengthens a traced call (PERF.md gives
by how much). The second, over the next GAP_CALLS calls, each inside a
`bench.call` span of the benchmark's own, records host and device activity,
to name the host's work in each idle gap of the device (the innermost host
operation under way at the gap's middle); only the breakdown's idle gaps
read it. `Trace` holds what the per-layer metrics read; its breakdown gives
the device operations that took most time and those idle gaps.

The arithmetic of busy time and idle share is that of chip_smoke.py's
`profile_calls` (the union of kernel intervals), measured on the card."""
from __future__ import annotations

import dataclasses
import time

import torch

SPAN = "bench.call"
GAP_CALLS = 2      # calls under the host-and-device session, for the idle gaps' attribution


@dataclasses.dataclass
class Trace:
    device_ops: list            # (name, start_us, end_us) inside the traced window, sorted by start
    window_s: float
    busy_s: float
    calls: int
    gaps: list                  # [name, seconds]: idle device time by host operation over GAP_CALLS calls, most first

    def device_seconds(self, match) -> float:
        """Device seconds of the operations whose name `match` accepts."""
        return sum(e - s for name, s, e in self.device_ops if match(name)) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict[str, float] = {}
        for name, s, e in self.device_ops:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:200], t] for n, t in ops], "idle_gaps": self.gaps[:top]}


def busy_union(intervals: list, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    busy, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy


def gaps(intervals: list, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, end = [], lo
    for s, e in sorted(intervals):
        if s > end:
            out.append((end, min(s, hi)))
        end = max(end, e)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]


def idle_gaps(device_ops: list, host_ops: list, lo: float, hi: float) -> list:
    """Idle device seconds in [lo, hi] by the innermost host operation under
    way at each gap's middle ("host (no operation)" where none was), most
    first."""
    spans = [(s, e) for _, s, e in device_ops]
    # CUDA runtime calls are left out: the operation that issued them names the host's work
    host = sorted((s, e, n) for n, s, e in host_ops if n != SPAN and not n.startswith("cu"))
    by_op: dict[str, float] = {}
    active, at = [], 0
    for a, b in gaps(spans, lo, hi):     # in order, so one sweep over the host operations
        mid = (a + b) / 2
        while at < len(host) and host[at][0] <= mid:
            active.append(host[at])
            at += 1
        active = [op for op in active if op[1] >= mid]
        name = min((e - s, n) for s, e, n in active)[1] if active else "host (no operation)"
        by_op[name] = by_op.get(name, 0.0) + (b - a) / 1e6
    return [[n[:200], t] for n, t in sorted(by_op.items(), key=lambda kv: -kv[1])]


def events(prof) -> tuple[list, list]:
    """(device operations, host operations) of a finished session, each as
    (name, start_us, end_us); the spans' own marks on the device's timeline
    are no operation."""
    from torch.autograd import DeviceType

    device_ops, host_ops = [], []
    for e in prof.events():
        rng = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if e.name != SPAN:
                device_ops.append(rng)
        else:
            host_ops.append(rng)
    return sorted(device_ops, key=lambda op: op[1]), host_ops


class Tracer:
    """Makes `count` calls under device activity alone, then GAP_CALLS calls
    under host and device activity. Without a card there is no device
    session and no Trace."""

    def __init__(self, count: int):
        self.count = count
        self.cuda = torch.cuda.is_available()
        self.device_prof = self.host_prof = None
        self.t0 = self.t1 = 0.0

    @staticmethod
    def warm_up() -> None:
        """One short session of each kind, so that the traced sessions do
        not pay the profiler's first start."""
        from torch.profiler import ProfilerActivity, profile

        for activities in ([ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            with profile(activities=activities):
                torch.zeros(1, device="cuda").add_(1)
                torch.cuda.synchronize()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def run(self, call, first: int) -> list:
        """The traced calls call(first), call(first + 1), ...; their results."""
        from torch.profiler import ProfilerActivity, profile, record_function

        out = []
        if self.cuda:
            self.sync()
            self.device_prof = profile(activities=[ProfilerActivity.CUDA])
            self.device_prof.start()
            self.sync()
            self.t0 = time.perf_counter()
        for k in range(self.count):
            out.append(call(first + k))
        if self.cuda:
            self.sync()
            self.t1 = time.perf_counter()
            self.device_prof.stop()
        self.host_prof = profile(activities=[ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * self.cuda)
        self.host_prof.start()
        for k in range(self.count, self.count + GAP_CALLS):
            with record_function(SPAN):
                out.append(call(first + k))
        self.sync()
        self.host_prof.stop()
        return out

    def result(self) -> Trace | None:
        """The Trace, or None when the device session recorded no device
        operation (or there was none)."""
        if self.device_prof is None:
            return None
        device_ops, _ = events(self.device_prof)
        if not device_ops:
            return None
        busy = busy_union([(s, e) for _, s, e in device_ops], device_ops[0][1], max(e for _, _, e in device_ops))
        gap_ops, host_ops = events(self.host_prof)
        spans = [(s, e) for n, s, e in host_ops if n == SPAN]
        found = idle_gaps(gap_ops, host_ops, min(s for s, _ in spans), max(e for _, e in spans)) if spans else []
        return Trace(device_ops, self.t1 - self.t0, busy / 1e6, self.count, found)
