"""The readings that the check's limits are set from: for each seed, the
numbers compared between the program and the plain reference (sound runs:
the lower reading), and between each control and the reference (the upper
reading). The controls are the reference itself with every product's
operands rounded to TF32 (the precision under the configuration's fp32 with
TF32 off) and the program's own bf16 path (compute_dtype bfloat16). The
faults are planted in the program at the cell's own size: `altered`, each
match's index moved by one where it is produced (match cells); `half`, half
of the batch left out (match cells: the first half's answers given for
both halves; training: each step on the first half of its batch). A step
that returns its state unchanged reads 1 by the training check's measure
and needs no run.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 3] [--controls tf32,bf16,altered,half]

One process reads every seed, so the kernels build once. Prints one JSON
line a seed and side, then the largest sound reading and the smallest
control reading of each number. The benchmark's own runs never run this."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from benchlib import core  # noqa: E402
from benchlib.program import build_model  # noqa: E402


def altered(run, batch: dict) -> dict:
    out = run.forward(batch)
    idx = out["indices0"][-1]
    out["indices0"][-1] = torch.where(idx >= 0, (idx + 1) % idx.shape[1], idx)
    return out


def half(run, batch: dict) -> dict:
    b = batch["valid0"].shape[0]
    out = run.forward({k: v[: b // 2] for k, v in batch.items()})
    twice = lambda x: None if x is None else torch.cat([x, x[: b - b // 2]])  # noqa: E731
    return {k: [twice(x) for x in v] if isinstance(v, list) else twice(v) for k, v in out.items()}


MATCH_FAULTS = {"altered": altered, "half": half}


def match_readings(run, controls) -> dict:
    sample = run.sample()
    batches = [run.pool[i % len(run.pool)] for i, _ in sample]
    sides = {"program": [out for _, out in sample]}
    for name, fault in MATCH_FAULTS.items():
        if name in controls:
            sides[name] = [run.to_host(fault(run, batch)) for batch in batches]
    if "bf16" in controls:
        run.model = build_model(run.cell.config, run.weights, run.device, compute_dtype="bfloat16")
        sides["bf16"] = [run.to_host(run.forward(batch)) for batch in batches]
    run.release()
    want = [run.reference(b) for b in batches]
    if "tf32" in controls:
        sides["tf32"] = [run.reference(b, bits=10) for b in batches]
    return {side: run.compare(list(zip(batches, outs, want))) for side, outs in sides.items()}


def train_steps(run, batches: list, **changes) -> tuple:
    """A fresh step from the run's weights through `batches`: each loss, the
    first gradient as Adam holds it, and the parameters after the last."""
    from impx_torch.train.step import TrainHyperParams, init_opt_state, init_stats, make_train_step
    from reference.matcher import ADAM_B1

    model = build_model(run.cell.config, run.weights, run.device, **changes)
    opt, stats = init_opt_state(model), init_stats(run.device)
    step = make_train_step(model, TrainHyperParams(lr=run.lr, optim=run.cell.config["train"]["optim"]))
    losses, first = [], None
    for i, batch in enumerate(batches):
        metrics, stats = step(opt, i, batch, stats)
        losses.append(metrics["loss"].item())
        if i == 0:
            first = {n: (m / (1 - ADAM_B1)).float().clone() for n, m in opt["mu"].items()}
    out = (losses, first, {n: p.detach().float().clone() for n, p in model.named_parameters()})
    del model, opt, step
    torch.cuda.empty_cache()
    return out


def train_readings(run, controls) -> dict:
    sides = {"program": (run.losses, run.first_grad, run.after)}
    run.release()
    if "half" in controls:
        sides["half"] = train_steps(run, [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in run.pool])
    if "bf16" in controls:
        sides["bf16"] = train_steps(run, run.pool, compute_dtype="bfloat16")
    want = run.reference()
    out = {side: run.compare(*prog, want) for side, prog in sides.items()}
    if "tf32" in controls:
        t = run.reference(bits=10)
        out["tf32"] = run.compare(t["losses"], t["first_grad"], t["params"], want)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--controls", default="tf32,bf16,altered,half")
    ap.add_argument("--control_seeds", type=int, default=4, help="the controls run on the first this many seeds")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = core.load_cell(args.workload)
    controls = [c for c in args.controls.split(",") if c]
    driver = core.driver_module(cell)
    dev = torch.device("cuda", 0)
    worst, least = {}, {}
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = driver.Run(cell, seed, dev)
        run.setup()
        run.window(args.seconds, None)
        readings = (train_readings if cell.workload["driver"] == "train_loop" else match_readings)(
            run, controls if n < args.control_seeds else [])
        for side, numbers in readings.items():
            print(json.dumps({"cell": cell.name, "seed": seed, "side": side, **numbers}), flush=True)
            for k, v in numbers.items():
                if side == "program":
                    worst[k] = max(worst.get(k, 0.0), v)
                else:
                    least.setdefault(side, {})[k] = min(least.get(side, {}).get(k, float("inf")), v)
        del run
        torch.cuda.empty_cache()
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"cell": cell.name, "lower_reading": worst, "control_least": least}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
