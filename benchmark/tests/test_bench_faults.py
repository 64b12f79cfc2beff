"""A run with the timed path broken underneath comes out not correct: the rest
of a run (set-up, window, check against the plain reference, under the
cell's own limits) on the CPU at a small size, past the look for a card.
The faults a cell can have (the match cells' as benchmark/calibrate.py plants
them at the cells' own sizes): an answer altered where it is produced, half
of the batch left out, and in training a step that returns its state
unchanged. (Every cell runs on one chip: there is no exchange between
chips to leave out.)"""
from __future__ import annotations

import time
import types

import pytest
import torch

import calibrate
from conftest import small_cell


def run(cell, driver, seed: int = 11):
    from benchlib import core

    code, line, numbers = core.run_cell(cell, seed, 0.2, False, torch.device("cpu"), time.perf_counter(),
                                        driver=driver)
    assert code == 0 and line is not None
    return line


def faulty(cell, make):
    """The cell's driver module with its Run replaced by make(Run)."""
    from benchlib import core

    module = core.driver_module(cell)
    return types.SimpleNamespace(Run=make(module.Run))


MATCH_CELLS = ["imp_match_yfcc", "eimp_match_compact", "imp_match_4096"]


@pytest.mark.parametrize("name", MATCH_CELLS)
def test_a_sound_run_is_correct(name):
    assert run(small_cell(name), None)["correct"] is True


@pytest.mark.parametrize("name", MATCH_CELLS)
def test_an_answer_altered_where_it_is_produced(name):
    def make(Run):
        class Altered(Run):
            def forward(self, batch):
                return calibrate.altered(super(), batch)
        return Altered

    assert run(small_cell(name), faulty(small_cell(name), make))["correct"] is False


@pytest.mark.parametrize("name", MATCH_CELLS)
def test_scores_shifted_in_a_third_of_the_pairs(name):
    """mscores0 moved by 1e-3 in the last third of each batch's pairs, no
    index or keep flipped: a fault in the later batch rows. In EIMP the
    median pair stays sound; the share of pairs off catches it."""
    def make(Run):
        class Shifted(Run):
            def forward(self, batch):
                out = super().forward(batch)
                s = out["mscores0"][-1]
                later = torch.arange(s.shape[0]).view(-1, 1) >= s.shape[0] * 2 // 3
                out["mscores0"][-1] = torch.where(later & (s > 0), s + 1e-3, s)
                return out
        return Shifted

    cell = small_cell(name, pairs=6)
    line = run(cell, faulty(cell, make))
    assert line["correct"] is False
    checks = line["checks"]
    if "pairs_off_share" in checks:
        assert checks["mscore_rms_median_pair"]["value"] <= checks["mscore_rms_median_pair"]["limit"]
        assert checks["pairs_off_share"]["value"] > checks["pairs_off_share"]["limit"]


@pytest.mark.parametrize("name", MATCH_CELLS)
def test_half_of_the_batch_left_out(name):
    def make(Run):
        class Half(Run):
            def forward(self, batch):
                return calibrate.half(super(), batch)
        return Half

    cell = small_cell(name, pairs=2)
    assert run(cell, faulty(cell, make))["correct"] is False


def test_a_training_step_that_returns_its_state_unchanged(monkeypatch):
    import impx_torch.train.step as step_module

    real = step_module.make_train_step

    def unchanged(model, hp):
        step = real(model, hp)

        def same(opt, iteration, batch, stats):
            saved = [p.detach().clone() for p in model.parameters()]
            moments = {k: {n: t.clone() for n, t in opt[k].items()} for k in ("mu", "nu")}
            count = opt["count"].clone()
            out = step(opt, iteration, batch, stats)
            with torch.no_grad():
                for p, s in zip(model.parameters(), saved):
                    p.copy_(s)
                for k in ("mu", "nu"):
                    for n, t in opt[k].items():
                        t.copy_(moments[k][n])
                opt["count"].copy_(count)
            return out
        return same

    monkeypatch.setattr(step_module, "make_train_step", unchanged)
    cell = small_cell("imp_train_megadepth")
    assert run(cell, None)["correct"] is False


def test_a_training_step_with_half_of_the_batch_left_out():
    cell = small_cell("imp_train_megadepth", pairs=4)

    def make(Run):
        class Half(Run):
            def call(self, i):
                batch = self.pool[i % len(self.pool)]
                b = batch["valid0"].shape[0]
                self.pool[i % len(self.pool)] = {k: v[: b // 2] for k, v in batch.items()}
                try:
                    return super().call(i)
                finally:
                    self.pool[i % len(self.pool)] = batch
        return Half

    assert run(cell, faulty(cell, make))["correct"] is False


def test_a_traced_run_on_the_cpu_reports_no_device_metric():
    """Without a card the profiler records no device operation: the traced
    run still checks its outputs, and reports no per-layer metric rather
    than a CPU number under a device metric's name."""
    from benchlib import core

    cell = small_cell("imp_match_yfcc")
    code, line, _ = core.run_cell(cell, 4, 0.2, True, torch.device("cpu"), time.perf_counter())
    assert code == 0 and line["correct"] is True
    assert line["metrics"] == {} and "busy_s" not in line["device"]
