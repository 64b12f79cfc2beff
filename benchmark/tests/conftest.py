"""The benchmark's own tests (python -m pytest benchmark/tests -q): the
benchmark directory and the repository root on the path, and small cells
that the CPU runs through the program's plain paths."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def small_cell(name: str, layers: int | None = None, slots: int = 64, pairs: int = 2):
    """The cell `name` cut to CPU size: IMP at 2 layers, EIMP at 6 with one
    compaction into half the slots, `pairs` pairs of `slots` slots, a pool of
    4 batches, 2 calls checked."""
    from benchlib import core

    cell = core.load_cell(name)
    m = cell.config["matcher"]
    if cell.config["model"] == "AdaGMN":
        m["n_layers"] = layers or 6
        m["compaction"] = [[4, slots * 3 // 4]]
        m["n_min_tokens"] = slots // 4
    else:
        m["n_layers"] = layers or 2
    t = cell.traffic
    t["pairs"], t["pool"], t["slots"] = pairs, 4, slots
    if t["generator"] == "scene_pairs":
        t["valid"] = [slots * 5 // 8, slots]
    else:
        t["padded"] = [0, slots // 8]
    cell.workload["check"]["calls"] = 2
    return cell


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")
