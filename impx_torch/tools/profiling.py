"""The program's spans and counters, and device profiling over torch.profiler
(impx/tools/profiling.py's jax.profiler traces).

`span(name)` marks a layer of the program (`impx.match`, `impx.layer`,
`impx.train.backward`, ...) and `count(name, *values)` records a count at
the same boundary. Both are off unless a `recording()` is open; off, `span`
returns one shared no-op context and `count` returns at once, so the
program pays one branch a site. While a recording is open:

- each span is kept in memory as a `Span` (name, start and end, parent,
  thread, and the outermost span of its call or step, which every span of
  that call shares), read from `Recording.spans` when the recording ends;
- each count keeps its values by reference (tensors the program computed
  anyway; nothing is reduced or copied while the program runs);
- under a torch.profiler session each span is also a profiler range (a
  user annotation), so the profiler ties every operation launched inside it
  to it by correlation id. A session that records device activity alone
  records no host range: its device timeline is the same as with tracing
  off.

Times are `time.time_ns()`, the Unix clock, which is the clock of the
profiler's events (kineto's `start_ns()`; on an H100 with torch 2.11 a
span starts 2-66 us before its range): `Recording.on_profiler_clock(prof)`
gives each span in the microseconds of the session's `FunctionEvent`s
(`time_range`).

`trace(log_dir)` records a Chrome trace (Perfetto, TensorBoard) with the
program's spans as named ranges beside the kernels."""
from __future__ import annotations

import array
import contextlib
import os
import threading
import time
from typing import NamedTuple

import torch

_NOOP = contextlib.nullcontext()
# The open recording. The spans sit deep inside the model and its autograd
# Functions, which no caller can hand an object to, so it is the process's.
_recording: Recording | None = None


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int | None      # None while the span is open
    parent: int | None      # index in Recording.spans of the enclosing span
    thread: int             # threading.get_native_id() of the thread it ran on
    root: int               # index of the outermost span of its call or step


class Recording:
    """What one `recording()` kept: `spans` in the order they opened (a span's
    index is its id) and `counts`, name -> list of value tuples. The spans are
    kept in flat arrays, which the garbage collector never walks."""

    def __init__(self):
        self._names: list[str] = []
        self._cols = {k: array.array("q") for k in ("start", "end", "parent", "thread", "root")}
        self.counts: dict[str, list[tuple]] = {}
        self._local = threading.local()
        self._root_stack: list[int] | None = None   # the open stack that holds the outermost span

    @property
    def spans(self) -> list[Span]:
        c = self._cols
        return [Span(n, s, e or None, None if p < 0 else p, t, r)
                for n, s, e, p, t, r in zip(self._names, c["start"], c["end"], c["parent"], c["thread"], c["root"])]

    def open(self, name: str) -> int:
        local = self._local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
            local.thread = threading.get_native_id()
        index = len(self._names)
        c = self._cols
        if stack:
            parent = stack[-1]
            root = c["root"][parent]
        elif self._root_stack:
            # a span on another thread (autograd's) inside an open call or
            # step: the innermost span open on the thread that holds it
            parent = self._root_stack[-1]
            root = c["root"][parent]
        else:
            parent, root = -1, index
            self._root_stack = stack
        self._names.append(name)
        c["parent"].append(parent)
        c["thread"].append(local.thread)
        c["root"].append(root)
        c["end"].append(0)
        stack.append(index)
        c["start"].append(time.time_ns())
        return index

    def close(self, index: int) -> None:
        self._cols["end"][index] = time.time_ns()
        stack = self._local.stack
        stack.pop()
        if not stack and self._root_stack is stack:
            self._root_stack = None

    def on_profiler_clock(self, prof) -> list[tuple]:
        """Each closed span as (name, start_us, end_us, parent, thread, root),
        in the microseconds of torch.profiler session `prof`'s events
        (`FunctionEvent.time_range`, from the session's trace start)."""
        t0 = prof.profiler.kineto_results.trace_start_ns()
        return [(s.name, (s.start_ns - t0) / 1e3, (s.end_ns - t0) / 1e3, s.parent, s.thread, s.root)
                for s in self.spans if s.end_ns is not None]


class _Open:
    """An open span: its record, and its profiler range when a profiler runs."""
    __slots__ = ("rec", "name", "index", "handle")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.index = self.rec.open(self.name)
        self.handle = None
        if torch.autograd.profiler._is_profiler_enabled:
            # the C entry point of record_function's range (a user annotation),
            # which stamps its start a microsecond or two after the span's own
            self.handle = torch._C._autograd._record_function_with_args_enter(self.name)
        return self

    def __exit__(self, *exc):
        if self.handle is not None:
            torch._C._autograd._record_function_with_args_exit(self.handle)
        self.rec.close(self.index)
        return False


def span(name: str):
    """A context that marks one layer of the program as span `name`."""
    rec = _recording
    return _NOOP if rec is None else _Open(rec, name)


def count(name: str, *values) -> None:
    """Record `values` under counter `name` (by reference)."""
    rec = _recording
    if rec is not None:
        rec.counts.setdefault(name, []).append(values)


@contextlib.contextmanager
def recording():
    """Turn the spans and counters on for the body; yields the `Recording`.
    One at a time."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a recording is already open")
    rec = _recording = Recording()
    try:
        yield rec
    finally:
        _recording = None


KEYS = "impx.attn.keys"   # a counter: (key mask or None, query rows, key length) an attention call


def key_use(rec: Recording) -> tuple[int, int]:
    """(kept keys, key slots walked) over every attention call of counter
    KEYS: each query row walks the whole key length; of those slots, the
    ones its batch entry's key mask keeps. Synchronises with the device."""
    kept = walked = 0
    for mask, rows, length in rec.counts.get(KEYS, ()):
        walked += rows * length
        kept += rows * length if mask is None else rows // mask.shape[0] * int((mask > 0).sum())
    return kept, walked


NORMS = "impx.norm"   # a counter: (took the kernel,) a norm of an MLP block (ops/mlp.py:mlp_apply)


def norm_use(rec: Recording) -> tuple[int, int]:
    """(norms that took the fused kernel impx::norm_act, norms) over counter
    NORMS."""
    taken = [took for (took,) in rec.counts.get(NORMS, ())]
    return sum(taken), len(taken)


@contextlib.contextmanager
def trace(log_dir: str = "impx_trace"):
    """Capture a torch.profiler trace of the CPU and, where there is a card,
    CUDA activity, with the program's spans on; on exit it is written as a
    Chrome trace (JSON) to the path the context yields, under log_dir:

        with trace("runs/trace") as path:
            run_steps()
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile(activities=activities) as prof, recording():
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
