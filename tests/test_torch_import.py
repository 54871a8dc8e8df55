"""The port stands alone: ``stdd_torch`` and ``chip_smoke.py`` import no
JAX, no flax or optax, nothing of ``stdd_tpu``, and none of cv2, msgpack or
scikit-learn (the machine with the card has none of them)."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "stdd_tpu", "cv2", "msgpack", "sklearn")
SOURCES = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "stdd_torch").rglob("*.py")) + [
    "chip_smoke.py"]


def test_every_module_imports_without_jax_cv2_or_stdd_tpu():
    script = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        FORBIDDEN = {FORBIDDEN!r}

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in FORBIDDEN:
                    raise ImportError("blocked: " + name)
                return None

        for name in FORBIDDEN:
            sys.modules.pop(name, None)
        sys.modules["jax"] = sys.modules["flax"] = sys.modules["cv2"] = None
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(ROOT)!r})
        import stdd_torch
        names = [m.name for m in pkgutil.walk_packages(stdd_torch.__path__, "stdd_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        loaded = sorted(m for m, v in sys.modules.items()
                        if v is not None and m.split(".")[0] in FORBIDDEN)
        assert not loaded, loaded
        print(len(names))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=str(ROOT), env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert int(res.stdout.split()[-1]) >= 37      # every module of the slices so far was walked


@pytest.mark.parametrize("path", SOURCES)
def test_source_names_no_forbidden_import(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if a.name.split(".")[0] in FORBIDDEN]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if node.module.split(".")[0] in FORBIDDEN:
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_chip_smoke_fails_without_a_card():
    """Run here (no CUDA), the script exits non-zero and prints no result."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, cwd=str(ROOT), env=env, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
