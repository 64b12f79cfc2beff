"""On a card: one short run of a cell through the command, whose last line is
the result under the contract, correct. Skips without a card (decided inside
the test)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "imp_match_yfcc", "--seed",
                          "2147483999", "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"pairs_per_s", "match_ms_p95", "setup_s"}


def test_the_command_refuses_to_run_without_enough_cards():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "imp_match_yfcc", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_command_refuses_to_run_without_the_program(tmp_path):
    import shutil

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "imp_match_yfcc", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
