"""The port stands alone: ``stdd_torch`` and ``chip_smoke.py`` import no
JAX, no flax or optax, nothing of ``stdd_tpu``, and none of cv2, msgpack or
scikit-learn (the machine with the card has none of them); importing them
loads neither PIL nor PyYAML."""

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
    # PIL and PyYAML too, while importing: ``config.load_yaml`` imports yaml
    # inside the call
    script = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        FORBIDDEN = {FORBIDDEN + ("PIL", "yaml")!r}

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
    assert int(res.stdout.split()[-1]) >= 96      # every module of the slices so far was walked


def test_registry_builds_every_model_without_jax():
    """``build_model`` for every registered name (the zoo's builders import
    their modules only when called) and the zoo's detectors, converters and
    landmarker, on a host where jax, flax, cv2 and ``stdd_tpu`` cannot be
    imported: narrow widths on the meta device, nothing computed."""
    script = textwrap.dedent(f"""
        import sys
        FORBIDDEN = {FORBIDDEN!r}

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in FORBIDDEN:
                    raise ImportError("blocked: " + name)
                return None

        for name in FORBIDDEN:
            sys.modules.pop(name, None)
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(ROOT)!r})
        import torch
        from stdd_torch.config import I3DConfig
        from stdd_torch.models import MODEL_REGISTRY, build_model
        from stdd_torch.models.landmark_net import MobileNetGDConv, gdconv_reference_to_flax
        from stdd_torch.models.retinaface import RetinaFace
        from stdd_torch.models.scrfd import SCRFDDetector
        from stdd_torch.utils import torch_convert
        cfg = I3DConfig(depth=18, width_per_group=8, num_frames=8, crop_size=32)
        vit = dict(image_size=32, patch_size=8, num_frames=8)
        with torch.device("meta"):
            for name in sorted(MODEL_REGISTRY):
                if name in ("videoit", "st_transformer"):
                    build_model(name, **vit)
                elif name == "resnet2d":
                    build_model(name, variant="resnet18")
                else:
                    build_model(name, cfg)
            RetinaFace(), MobileNetGDConv()
        print(len(MODEL_REGISTRY))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=str(ROOT), env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert int(res.stdout.split()[-1]) == 13


def test_run_dual_help_runs_without_jax():
    """``python -m stdd_torch.train.run_dual --help`` on a host where jax,
    flax, optax, scikit-learn and ``stdd_tpu`` cannot be imported."""
    script = textwrap.dedent(f"""
        import runpy, sys
        FORBIDDEN = {FORBIDDEN!r}

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in FORBIDDEN:
                    raise ImportError("blocked: " + name)
                return None

        for name in FORBIDDEN:
            sys.modules.pop(name, None)
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(ROOT)!r})
        sys.argv = ["run_dual", "--help"]
        runpy.run_module("stdd_torch.train.run_dual", run_name="__main__")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=str(ROOT), env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "--device" in res.stdout and "--epoch_samples" in res.stdout


@pytest.mark.parametrize("module,flag", [("stdd_torch.eval.harness", "--video_list"),
                                         ("stdd_torch.eval.demo", "--max_frame"),
                                         ("stdd_torch.runtime.app", "--ckpt"),
                                         ("stdd_torch.eval.synth_e2e", "--require_tpu"),
                                         ("stdd_torch.data.libreface_align", "--au_ckpt")])
def test_eval_cli_help_runs_without_jax(module, flag):
    """The evaluation CLIs' ``--help`` (the synthetic capstone's and the
    LibreFace alignment's too) on a host where jax, flax, optax, cv2, scikit-learn and ``stdd_tpu`` cannot
    be imported."""
    script = textwrap.dedent(f"""
        import runpy, sys
        FORBIDDEN = {FORBIDDEN!r}

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in FORBIDDEN:
                    raise ImportError("blocked: " + name)
                return None

        for name in FORBIDDEN:
            sys.modules.pop(name, None)
        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(ROOT)!r})
        sys.argv = ["cli", "--help"]
        runpy.run_module({module!r}, run_name="__main__")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=str(ROOT), env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "--device" in res.stdout and flag in res.stdout


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
