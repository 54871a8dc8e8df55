"""Nothing the benchmark runs may load the JAX side, and its reference may
use nothing of the program it judges."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from conftest import BENCH, ROOT

from portbench.lib.guard import FORBIDDEN, forbidden_in, top_level


def _sources(under: Path):
    return sorted(p for p in under.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path: Path):
    """Every module a file imports, absolute, by its full dotted name (a
    relative import is resolved against the file's package)."""
    tree = ast.parse(path.read_text(), str(path))
    pkg = ".".join(path.relative_to(ROOT).with_suffix("").parts[:-1])
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg.split(".")[: len(pkg.split(".")) - node.level + 1]
                out.append(".".join(base + ([node.module] if node.module else [])))
            else:
                out.append(node.module)
    return out


def test_top_level_names_are_compared_whole():
    assert top_level("stdd_torch.runtime.server") == "stdd_torch"
    assert forbidden_in(["stdd_torch", "stdd_torch.models.i3d", "jaxtyping"]) == []
    assert forbidden_in(["stdd_tpu.models", "jax.numpy", "flax"]) == ["flax", "jax", "stdd_tpu"]
    assert "stdd_tpu" in FORBIDDEN and "stdd_torch" not in FORBIDDEN


def test_no_module_of_the_benchmark_imports_the_jax_side():
    bad = {str(p.relative_to(ROOT)): forbidden_in(_imports(p)) for p in _sources(BENCH)}
    assert not {k: v for k, v in bad.items() if v}


def test_the_benchmark_reads_neither_old_bench_script():
    for p in _sources(BENCH):
        if p.parent.name == "tests":
            continue
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert not node.value.endswith(("bench.py", "chip_smoke.py")), p
        assert not {top_level(m) for m in _imports(p)} & {"bench", "chip_smoke"}, p


def test_the_reference_imports_nothing_of_the_program():
    for p in _sources(BENCH / "reference"):
        mods = _imports(p)
        assert "stdd_torch" not in {top_level(m) for m in mods}, p
        # within the benchmark it uses only the reference itself
        assert all(not m.startswith("portbench.") or m.startswith("portbench.reference")
                   for m in mods), (p, mods)


def test_a_run_loads_no_jax_module(tiny_bench):
    """A whole tiny run in its own process, then the guard over sys.modules."""
    code = f"""
import sys, time, torch
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from portbench.lib.registry import Cell
from portbench.lib.harness import run_cell
from portbench.lib.guard import loaded_forbidden
torch.set_num_threads(2)
out, _ = run_cell(Cell("tiny.dense", Path({str(tiny_bench)!r})), 2**33 + 1, 0.2, False,
                  torch.device("cpu"), time.perf_counter())
assert out["attempted"] > 0, out
print("FORBIDDEN", loaded_forbidden())
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FORBIDDEN []" in res.stdout, res.stdout[-2000:]
