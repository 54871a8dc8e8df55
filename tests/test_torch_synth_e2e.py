"""The port's synthetic capstone (``stdd_torch/eval/synth_e2e.py``) against
the contract of the JAX script's tests (``tests/test_measure_scripts.py::
test_run_synth_e2e_*``, which need YuNet's ONNX file and fail without it).

Two CPU runs of the twin at JAX's toy settings (``--smoke``, one pair, 32
frames, one epoch): the whole workflow with ``--dual``, and the same with a
garbage dense landmarker, which the sentinel flags on every track so that
phase 5 fails alone (``dual_error``) while phases 1-4 finish. Torch runs on
one thread here, as six test processes share the host's cores; each run
takes 15-30 s.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from stdd_torch.eval import harness, synth_e2e

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "run_synth_e2e.py"
TOY = ["--smoke", "--dual", "--train_pairs", "1", "--eval_pairs", "1", "--frames", "32",
       "--epochs", "1", "--fresh", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_twin(argv, capsys) -> dict:
    res = synth_e2e.main(argv)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(res))          # the printed line is the result
    return line


def test_smoke_dual_run_keeps_the_jax_contract(tmp_path, capsys):
    """Render → preprocess → run_i3d → harness → run_dual on the CPU: the
    fields both JAX contract tests assert, plus ``detections_real`` false
    and the device; the harness's CSVs hold both eval videos."""
    out = run_twin(TOY + ["--out", str(tmp_path / "synth")], capsys)
    assert out["metric"] == "synth_e2e"
    assert out["smoke_cpu"] is True
    assert out["eval_videos"] == 2                       # one real/fake pair, both scored
    assert 0.0 <= out["video_auc"] <= 1.0
    assert out["train_ckpt_epoch"] == 1
    assert set(out["phase_wall_s"]) == {"render", "preprocess", "train", "eval", "dual"}
    assert "dual_error" not in out, out.get("dual_error")
    assert 0.0 <= out["dual_video_auc"] <= 1.0
    assert 0.0 <= out["dual_clip_auc"] <= 1.0
    assert out["phase_wall_s"]["dual"] > 0
    assert out["lm_clips"] > 0
    assert 0.0 <= out["lm_flag_rate"] <= 1.0
    assert out["lm5_agreement_mean"] >= 0.0
    assert out["detections_real"] is False and out["device"] == "cpu"
    assert out["config"] == {"frames": 32, "train_pairs": 1, "eval_pairs": 1, "crop": 112,
                             "clip_size": 8, "epochs": 1}
    root = tmp_path / "synth"
    assert sorted(p.relative_to(root).as_posix() for p in root.glob("videos_*/*/*")) == [
        "videos_eval/fake/vid_100.y4m", "videos_eval/real/vid_100.y4m",
        "videos_train/fake/vid_000.y4m", "videos_train/real/vid_000.y4m"]
    with open(root / "results" / "per_video.csv") as f:
        rows = f.read().splitlines()
    assert rows[0].split(",") == harness.PER_VIDEO_HEADER and len(rows) == 3
    assert json.load(open(root / "dual_split.json")).keys() == {"train", "val", "test"}
    assert all(out["disk_bytes"][k] > 0 for k in ("videos_train", "clips_i3d", "clips_eval"))


def test_degraded_landmarker_gates_out(tmp_path, capsys, monkeypatch):
    """A dense landmarker that puts every point on the box's corner: the
    sentinel flags every track, phases 1-4 still finish, and phase 5,
    left without landmark features, fails alone as ``dual_error``."""
    from stdd_torch.models.facemesh import DenseLandmarker

    def garbage_landmarker(frame_rgb, tlbr, *a, **k):
        x1, y1 = float(tlbr[0]), float(tlbr[1])
        return np.tile(np.array([[x1, y1]], np.float32), (478, 1))

    monkeypatch.setattr(DenseLandmarker, "pretrained",
                        classmethod(lambda cls, **kw: garbage_landmarker))
    out = run_twin(TOY + ["--out", str(tmp_path / "degraded")], capsys)
    assert out["metric"] == "synth_e2e"
    assert 0.0 <= out["video_auc"] <= 1.0
    assert out["lm_clips"] > 0
    assert out["lm_flag_rate"] == 1.0
    assert "no usable clips" in out["dual_error"]          # the flagged tracks' features


def test_stops_without_a_card_before_rendering(tmp_path, monkeypatch):
    """No card and no ``--device cpu``: a non-zero exit naming the card and
    the flag, before ``--out`` is touched (the JAX script would fall back
    to ``--smoke`` on the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as err:
        synth_e2e.main(["--out", str(tmp_path / "synth"), "--dual", "--require_tpu"])
    assert "card" in str(err.value.code) and "--device cpu" in str(err.value.code)
    assert not (tmp_path / "synth").exists()


def test_fake_order_matches_jax(tmp_path, monkeypatch):
    """The fake videos' talking-loop order is the JAX script's for every
    pair seed of both configs' train and eval ranges: its
    ``render_benchmark`` runs with the scene and the video writer replaced
    by recorders."""
    import stdd_tpu.eval.bench_scene as jax_scene

    spec = importlib.util.spec_from_file_location("run_synth_e2e", SCRIPT)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    orders = {}

    class Recorder:
        def __init__(self, frame_hw, n_faces, seed, face_px, loop, expr_order=None):
            if expr_order is not None:
                orders[seed] = np.asarray(expr_order)

    monkeypatch.setattr(jax_scene, "BenchScene", Recorder)
    monkeypatch.setattr(script, "_write_video", lambda path, scene, n: None)
    seeds = list(range(8)) + list(range(100, 106))
    script.render_benchmark(str(tmp_path), seeds, 1, (8, 8), 4)
    assert sorted(orders) == seeds
    for s in seeds:
        np.testing.assert_array_equal(synth_e2e.fake_order(s), orders[s])
