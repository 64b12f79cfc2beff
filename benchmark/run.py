"""Run one cell of the benchmark of impx_torch once, on the CUDA cards of
this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program (impx_torch/) beside
BENCHMARK.json and benchmark/. The last line of standard output is the
result as one JSON object; the numbers compared with the plain reference
end standard error, each beside its limit. With --trace 0 the metrics are
the cell's end-to-end ones; with --trace 1 its per-layer ones, read from
torch.profiler over a span of the window. Exits non-zero, with no result,
without enough CUDA cards, without the program, or when jax, jaxlib, flax
or impx were loaded."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# the program's kernel caches, at fixed paths inside the checkout (impx_torch
# builds its CUDA sources into impx_torch/_build/ of the checkout itself)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(BENCH / ".cache" / sub)
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "impx_torch").is_dir():
        print(f"benchmark: no program (impx_torch/) beside {BENCH}", file=sys.stderr)
        return 2
    from benchlib import core

    cell = core.load_cell(args.workload)
    import torch

    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    code, line, numbers = core.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                        torch.device("cuda", 0), T_START)
    if line is None:
        return code or 3
    sys.stdout.flush()
    for name, value, limit in numbers:
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
