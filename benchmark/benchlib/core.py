"""One run of one cell: find everything by name, set up, measure, trace,
check, and make the result line.

Everything a cell needs is found by its name in BENCHMARK.json:
  benchmark/workloads/<cell>.json   the driver, its kernels, the check
  <configs[].file>                  the model configuration
  benchmark/traffic/<traffic>.json  the traffic mix, read by the generator it
                                    names (benchmark/traffic/<generator>.py)
  benchmark/drivers/<driver>.py     the loop that drives the program
  benchmark/metrics/<metric>.py     one reader a per-layer metric
So a later cell, configuration, traffic mix or metric is new files and new
entries only."""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "impx")   # top-level module names, compared whole


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import a file of the benchmark by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def seed_for(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of the run (weights, traffic, sample),
    so that the streams of one --seed never share draws."""
    return int(hashlib.sha256(f"{seed}:{tag}".encode()).hexdigest()[:15], 16)


def spread_counts(generator, low: int, high: int, n: int, device):
    """n counts evenly spread over [low, high], in an order drawn from the
    generator: every seed of a traffic mix gets the same set of sizes."""
    import torch

    counts = torch.linspace(low, high, n, device=device).round().long()
    return counts[torch.randperm(n, generator=generator, device=device)]


def p95(values: list[float]) -> float:
    """The 95th percentile of every value (statistics.quantiles, exclusive)."""
    return statistics.quantiles(values, n=20)[18]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class View:
    """What a per-layer metric's reader gets of a traced run."""
    trace: object          # benchlib.trace.Trace
    config: dict           # the configuration's file
    valid_counts: list     # per traced call: (n0 list, n1 list), each pair's valid keypoints
    window_s: float        # the measured (untraced) window's length, host clock
    window_counts: list    # per call of that window, as valid_counts


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict          # the workload's entry in BENCHMARK.json
    workload: dict       # benchmark/workloads/<name>.json
    config: dict         # the configuration's file
    traffic: dict        # benchmark/traffic/<traffic>.json
    spec: dict           # BENCHMARK.json

    def metrics(self, kind: str) -> list[dict]:
        """The end-to-end ('end_to_end') or per-layer ('per_layer') metrics
        this cell reports: those that list it, or, without a list, those
        whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.spec["end_to_end"]
               if self.name in m.get("workloads", [self.name])}
        out = []
        for m in self.spec[kind]:
            if "workloads" in m:
                if self.name in m["workloads"]:
                    out.append(m)
            elif kind == "end_to_end" or m["moves"] in e2e:
                out.append(m)
        return out


def load_cell(name: str) -> Cell:
    spec = load_json(ROOT / "BENCHMARK.json")
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in spec["configs"]}
    return Cell(name, entry, load_json(BENCH / "workloads" / f"{name}.json"),
                load_json(ROOT / configs[entry["config"]]["file"]),
                load_json(BENCH / "traffic" / f"{entry['traffic']}.json"), spec)


def generator_module(traffic: dict):
    return load_module(BENCH / "traffic" / f"{traffic['generator']}.py", f"bench_traffic_{traffic['generator']}")


def driver_module(cell: Cell):
    name = cell.workload["driver"]
    return load_module(BENCH / "drivers" / f"{name}.py", f"bench_driver_{name}")


def read_per_layer(cell: Cell, view) -> dict:
    """Each per-layer metric of the cell from its reader
    (benchmark/metrics/<name>.py, `read(view)`); a reader that finds nothing
    returns None and the metric is left out."""
    out = {}
    for m in cell.metrics("per_layer"):
        reader = load_module(BENCH / "metrics" / f"{m['name']}.py", f"bench_metric_{m['name']}")
        value = reader.read(view)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def log(*parts) -> None:
    print(*parts, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             driver=None) -> tuple[int, dict | None, list]:
    """Set up, measure, (trace), check. Returns (exit code, result line or
    None, the numbers compared as (name, value, limit)). `driver`: the
    driver module (the cell's by default; tests pass one with a fault)."""
    import torch

    driver = driver or driver_module(cell)
    run = driver.Run(cell, seed, device)
    run.setup()
    tracer = None
    if trace:
        from benchlib.trace import Tracer

        if device.type == "cuda":
            Tracer.warm_up()
        tracer = Tracer(len(run.pool))
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"setup_s {setup_s:.4f} (kernel build {run.build_s:.4f} s of it)")
    window = run.window(seconds, tracer)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    per_layer = {}
    breakdown = None
    busy_s = window_s = None
    if trace:
        t = tracer.result()
        if t is None:
            log("trace: the profiler recorded no device operation in the traced calls")
        else:
            per_layer = read_per_layer(cell, View(t, cell.config, run.traced, window["seconds"], window["counts"]))
            breakdown = t.breakdown()
            busy_s, window_s = t.busy_s, t.window_s
            log(f"trace: {t.calls} calls after the window under device activity alone, window "
                f"{t.window_s:.6f} s ({1e3 * t.window_s / t.calls:.4f} ms a call; untraced "
                f"{1e3 * window['seconds'] / len(window['counts']):.4f}), busy {t.busy_s:.6f} s, "
                f"{len(t.device_ops)} device operations; idle gaps of the host-traced calls {t.gaps[:5]}")
    run.release()
    correct, numbers = run.check()
    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded in this process: {found}", file=sys.stderr, flush=True)
        return 3, None, numbers
    for name, value, limit in numbers:
        log(f"check {name} {value!r} limit {limit!r}")
    metrics = {}
    if trace:
        metrics = per_layer
    else:
        for m in cell.metrics("end_to_end"):
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] in window["metrics"]:
                metrics[m["name"]] = {"value": window["metrics"][m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.entry["chips"], "memory_peak_bytes": int(memory_peak)}
    if trace and busy_s is not None:
        dev["busy_s"], dev["window_s"] = busy_s, window_s
    line = {"correct": bool(correct), "attempted": window["attempted"], "failed": window["failed"],
            "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in numbers}
    return 0, line, numbers
