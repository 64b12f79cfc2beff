"""Nothing the benchmark runs imports jax, jaxlib, flax or impx (top-level
module names compared whole: impx_torch is not impx), and the plain
reference imports nothing of impx_torch either."""
from __future__ import annotations

import ast
import subprocess
import sys
import textwrap

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "impx"}


def imported_tops(path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def test_no_file_of_the_benchmark_imports_jax_or_impx():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not imported_tops(f) & FORBIDDEN, f


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert not imported_tops(f) & (FORBIDDEN | {"impx_torch"}), f


def test_the_modules_loaded_hold_no_jax_or_impx():
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]
        import reference.matcher
        assert "impx_torch" not in sys.modules, "the reference loaded the program"
        from benchlib import core
        for w in ("imp_match_yfcc", "imp_train_megadepth"):
            core.driver_module(core.load_cell(w))
        import impx_torch.models.dgnns, impx_torch.models.adgm, impx_torch.train.step
        import impx_torch.ops.kernels
        for f in (core.BENCH / "metrics").glob("*.py"):
            core.load_module(f, "m_" + f.stem.replace(".", "_"))
        print(sorted({{m.split(".")[0] for m in sys.modules}} & set({sorted(FORBIDDEN)!r})))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
