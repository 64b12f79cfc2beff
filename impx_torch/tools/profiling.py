"""Device profiling helpers over torch.profiler (impx/tools/profiling.py's
jax.profiler traces): a trace of the host's and the card's activity that
Perfetto (ui.perfetto.dev) or TensorBoard opens, and named host ranges.
"""
from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(log_dir: str = "impx_trace"):
    """Capture a torch.profiler trace of the CPU and, where there is a card,
    CUDA activity; on exit it is written as a Chrome trace (JSON) to the
    path the context yields, under log_dir:

        with trace("runs/trace") as path:
            run_steps()
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def annotate(name: str):
    """A named range on the host's timeline (torch.profiler.record_function)."""
    import torch

    return torch.profiler.record_function(name)
