"""A cell, a configuration, a traffic mix and a per-layer metric are new files
and new entries only: in a temporary copy of the benchmark, a dummy of each
is found by its name, the new cell runs on the CPU through the existing
driver, and the new metric is read."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap

from conftest import BENCH, ROOT


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    os.symlink(ROOT / "impx_torch", tmp_path / "impx_torch")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((BENCH / "configs" / "imp.json").read_text())
    config["matcher"]["n_layers"] = 2
    config["reduced"] = ["matcher"]
    (tmp_path / "benchmark" / "configs" / "imp_tiny.json").write_text(json.dumps(config))
    (tmp_path / "benchmark" / "traffic" / "tiny_b2.json").write_text(json.dumps(
        {"generator": "scene_pairs", "pairs": 2, "slots": 48, "valid": [32, 48], "inlier_frac": 0.25,
         "desc_scale": 16.0, "desc_noise": 0.15, "pixel_noise": 0.5, "image_size": [480, 640], "pool": 3}))
    (tmp_path / "benchmark" / "workloads" / "imp_tiny_match.json").write_text(json.dumps(
        {"driver": "match_loop", "kernels": ["attention", "sinkhorn"],
         "check": {"calls": 2, "limits": {"idx_mismatch": 0.0}}}))
    (tmp_path / "benchmark" / "metrics" / "dummy_calls.match.py").write_text(
        "def read(view):\n    return float(view.trace.calls)\n")
    spec["configs"].append({"name": "imp_tiny", "source": "https://github.com/feixue94/imp-release",
                            "file": "benchmark/configs/imp_tiny.json", "reduced": ["matcher"], "why": "a test"})
    spec["workloads"].append({"name": "imp_tiny_match", "config": "imp_tiny", "traffic": "tiny_b2", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "imp_match_yfcc" in m["workloads"]:
            m["workloads"].append("imp_tiny_match")
    spec["per_layer"].append({"name": "dummy_calls.match", "unit": "calls", "better": "higher",
                              "source": "device_trace", "layer": "entry", "moves": "pairs_per_s",
                              "workloads": ["imp_tiny_match"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = textwrap.dedent(f"""
        import json, sys, time
        sys.path[:0] = [{str(tmp_path / "benchmark")!r}, {str(tmp_path)!r}]
        import torch
        from benchlib import core, trace
        cell = core.load_cell("imp_tiny_match")
        code, line, numbers = core.run_cell(cell, 3, 0.2, False, torch.device("cpu"), time.perf_counter())
        t = trace.Trace([("k", 0.0, 1.0)], 1e-6, 1e-6, 2, [])
        per_layer = core.read_per_layer(cell, type("V", (), {{"trace": t}})())
        print(json.dumps({{"line": line, "names": [m["name"] for m in cell.metrics("per_layer")],
                           "dummy": per_layer.get("dummy_calls.match")}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["names"] == ["dummy_calls.match"]
    assert got["dummy"] == {"value": 2.0, "unit": "calls"}
    line = got["line"]
    assert line["correct"] is True and line["attempted"] >= 1
    assert set(line["metrics"]) == {"pairs_per_s", "match_ms_p95", "setup_s"}
