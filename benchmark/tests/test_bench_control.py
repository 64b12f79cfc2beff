"""The control comes out not correct: the plain reference put in the
program's place with every product's operands rounded to TF32 (the
precision under the configurations' fp32 with TF32 off), compared with the
fp32 reference under each cell's own limits, at the published depth and a
size the CPU can hold. On the card, at the cells' own sizes,
benchmark/calibrate.py reads the same control (PERF.md gives its
readings)."""
from __future__ import annotations

import pytest
import torch

from conftest import small_cell

TF32_BITS = 10


def cpu_run(name: str, slots: int, pairs: int, seed: int):
    from benchlib import core

    cell = small_cell(name, layers=15, slots=slots, pairs=pairs)
    m = cell.config["matcher"]
    if cell.config["model"] == "AdaGMN":
        m["compaction"] = [[4, slots // 2], [8, slots // 4], [12, slots // 8]]
        m["n_min_tokens"] = slots // 8
    cell.workload["check"]["calls"] = 2
    run = core.driver_module(cell).Run(cell, seed, torch.device("cpu"))
    run.setup()
    return cell, run


@pytest.mark.parametrize("name, slots", [("imp_match_yfcc", 512), ("eimp_match_compact", 1024),
                                         ("imp_match_4096", 512)])
def test_the_tf32_control_fails_a_match_cell(name, slots):
    torch.set_num_threads(4)
    cell, run = cpu_run(name, slots=slots, pairs=2, seed=21)
    batches = run.pool[:2]
    pairs = [(b, run.reference(b, bits=TF32_BITS), run.reference(b)) for b in batches]
    correct, numbers = run.check(pairs)
    assert not correct, numbers
    sound = [(b, run.reference(b), run.reference(b)) for b in batches]
    assert run.check(sound)[0]


def test_the_tf32_control_fails_the_training_cell():
    torch.set_num_threads(4)
    cell, run = cpu_run("imp_train_megadepth", slots=128, pairs=2, seed=22)
    run.release()
    want = run.reference()
    control = run.reference(bits=TF32_BITS)
    correct, numbers = run.check((control["losses"], control["first_grad"], control["params"]), want)
    assert not correct, numbers
