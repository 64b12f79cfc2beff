"""BENCHMARK.json against the benchmark's contract: names, units and lengths;
every file it names is found; every per-layer metric's cells report the
end-to-end metric it moves; the limits of the run's length."""
from __future__ import annotations

import json
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(spec["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in spec["paths"])
    assert 1 <= len(spec["command"]) <= 32 and all(line(w) for w in spec["command"])
    for word in spec["command"]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in spec["paths"]), word
            assert (ROOT / word).is_file()
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) <= 64 * 1024


def test_run_length_fits_a_full_check(spec):
    cells = 24
    assert (2 + 14 * cells) * (spec["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_configs(spec):
    names = [c["name"] for c in spec["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    files = [c["file"] for c in spec["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in spec["workloads"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in spec["paths"]) and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["name"] in used
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]


def test_workloads_and_their_files(spec):
    names = [w["name"] for w in spec["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(1, len(names) // 4)
    configs = {c["name"] for c in spec["configs"]}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and line(w["why"])
        cell = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert (BENCH / "drivers" / f"{cell['driver']}.py").is_file()
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "traffic" / f"{mix['generator']}.py").is_file()
        assert cell["check"]["limits"], "every cell compares its outputs"


def test_metrics(spec):
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e and 1 <= len(spec["per_layer"]) <= 128
    names = list(e2e) + [m["name"] for m in spec["per_layer"]]
    assert len(set(names)) == len(names)
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    reports = {c: {n for n, m in e2e.items() if c in m.get("workloads", cells)} for c in cells}
    for c, got in reports.items():
        assert "setup_s" in got and len(got) >= 2, c
    layers = set()
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and line(m["layer"]) and m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        for c in m.get("workloads", [c for c in cells if m["moves"] in reports[c]]):
            assert m["moves"] in reports[c], (m["name"], c)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.add(m["layer"])
    for c in cells:
        assert any(c in m.get("workloads", [c]) for m in spec["per_layer"]), c


def test_every_file_under_paths_is_named_from_name_characters(spec):
    for p in spec["paths"]:
        for f in (ROOT / p).rglob("*"):
            if f.is_file() and "__pycache__" not in f.parts and ".cache" not in f.parts:
                rel = f.relative_to(ROOT).as_posix()
                assert PATH.match(rel), rel
