"""Section timing for host-side pipeline stages (a copy of impx/tools/timer.py).

Serves the role of the reference's wall-clock section timer
(tools/utils.py:64-103): named sections, exponentially smoothed durations,
one-line throughput report. Original implementation — sections are context
managers (or explicit mark() calls), the smoothed estimate tracks a running
(ema, n) pair per section, and the report is built as a string so callers
can route it to logging instead of stdout. Device-side profiling should use
torch.profiler traces (impx_torch/tools/profiling.py) instead.
"""
from __future__ import annotations

import contextlib
import time


class _Section:
    __slots__ = ("ema", "n", "fresh")

    def __init__(self):
        self.ema = 0.0
        self.n = 0
        self.fresh = False

    def add(self, dt: float, alpha: float):
        self.ema = dt if self.n == 0 else alpha * dt + (1.0 - alpha) * self.ema
        self.n += 1
        self.fresh = True


class AverageTimer:
    """Exponentially-smoothed per-section wall clock.

    Usage (either style)::

        t = AverageTimer()
        with t.section("read"):
            ...
        t.mark("match")          # time since the previous mark/section end
        print(t.report("loop"))  # or t.print("loop")
    """

    def __init__(self, smoothing: float = 0.3, newline: bool = False):
        self.alpha = float(smoothing)
        self.newline = newline
        self._sections: dict[str, _Section] = {}
        self._t0 = time.perf_counter()

    def reset(self):
        self._t0 = time.perf_counter()
        for s in self._sections.values():
            s.fresh = False

    @contextlib.contextmanager
    def section(self, name: str):
        begin = time.perf_counter()
        try:
            yield
        finally:
            end = time.perf_counter()
            self._record(name, end - begin)
            self._t0 = end

    def mark(self, name: str = "default"):
        now = time.perf_counter()
        self._record(name, now - self._t0)
        self._t0 = now

    # reference-compatible spelling
    update = mark

    def _record(self, name: str, dt: float):
        sec = self._sections.get(name)
        if sec is None:
            sec = self._sections[name] = _Section()
        sec.add(dt, self.alpha)

    def report(self, label: str = "Timer") -> str:
        parts = [f"[{label}]"]
        total = 0.0
        for name, sec in self._sections.items():
            if not sec.fresh:
                continue
            parts.append(f"{name}={sec.ema:.3f}")
            total += sec.ema
        fps = 1.0 / total if total > 0 else float("inf")
        parts.append(f"total={total:.3f} sec {fps:.1f} FPS")
        return " ".join(parts)

    def print(self, text: str = "Timer"):
        print(self.report(text), end="\n" if self.newline else "\r",
              flush=True)
        self.reset()
