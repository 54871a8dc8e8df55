"""The port's streaming-evaluation harness (``stdd_torch/eval/harness.py``)
against the JAX package's ``stdd_tpu/eval/harness.py``.

- Path helpers, ``collect_videos`` (the same order for a seed) and
  ``collect_from_list``: exact.
- ``run_video``: a small float32 I3D (clip 8, crop 64) with the same weights
  on both sides, the fixed fake detector of ``tests/test_harness.py:62``,
  and the same decoded frames: the JAX harness decodes with
  ``cv2.VideoCapture``, whose ``.y4m`` decode lies up to 3 grey levels from
  the port's (bit-equal to ``cvtColor(COLOR_YUV2BGR_I420)``), so JAX's
  ``iter_video_frames`` is patched to the port's reader; the decoders are
  not compared. ``pred_label``, ``num_tracks`` and ``frames_processed``
  equal, ``video_score`` within 1e-4.
- ``summarize`` against JAX's (scikit-learn) within 1e-12, with tied scores
  and a single-class set; ``write_csvs`` byte-equal on the same rows, and
  equal but for the timing columns on each side's own ``run_video`` rows.
- ``build_engine``: ``--clip_size`` sets the model's frames over a
  sidecar's clip_size (ADVICE.md r5 #2); the JAX harness lets the sidecar
  win, the one mismatch the parity test skips.
"""

import argparse
import csv
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stdd_tpu.config import I3DConfig as JaxI3DConfig
from stdd_tpu.config import PipelineConfig as JaxPipelineConfig
from stdd_tpu.eval import harness as jax_harness
from stdd_tpu.runtime.classifier import ClipScorer as JaxClipScorer
from stdd_tpu.runtime.engine import StreamingEngine as JaxStreamingEngine
from stdd_torch.config import I3DConfig, PipelineConfig
from stdd_torch.eval import harness
from stdd_torch.ops.align import STD_POINTS_256
from stdd_torch.runtime.classifier import ClipScorer
from stdd_torch.runtime.engine import StreamingEngine
from stdd_torch.utils.checkpoint import save_checkpoint
from stdd_torch.utils.onnx_writer import write_onnx, yunet_shaped_graph
from stdd_torch.utils.torch_convert import i3d_torch_to_reference
from stdd_torch.utils.video_io import write_y4m
from stdd_torch.utils.weights import i3d_torch_to_flax

from torch_port_helpers import port_i3d_variables

CFG = dict(num_frames=8, crop_size=64)
PIPE = dict(clip_size=8, stride=4, detect_every=2, batch_clips=2, min_face_side=5,
            pool_method="mean")
ENGINE_KW = dict(crop_buffer=128, q_lap_hard=0.0, q_weighting=False)
P_TOL = 1e-4
TIMING = {"elapsed_s", "fps", "latency_ms_clip_mean", "mean_fps", "mean_latency_ms_clip"}

PATHS = [
    "/data/celebdf_v2/celeb-real/a.mp4", "/data/ffpp/manipulated_sequences/deepfakes/c23/x.mp4",
    "/data/original_sequences/youtube/c23/y.mp4", "/data/unknown/thing.mp4",
    "C:\\FaceForensics++\\test\\source\\v.avi", "/x/FFIW/val/target/q.mkv",
    "/d/Celeb-synthesis/z.mov", "/d/neuraltextures/c40", "relative/train/real/r.y4m",
]


def test_path_helpers_match_jax():
    for p in PATHS:
        assert harness.classify_path(p) == jax_harness.classify_path(p), p
        assert harness.dataset_of(p) == jax_harness.dataset_of(p), p
        assert harness.subset_of(p) == jax_harness.subset_of(p), p
    for name in ("REAL_TOK", "FAKE_TOK", "DATASETS_HINT", "SUBSETS_HINT",
                 "PER_VIDEO_HEADER", "SUMMARY_HEADER"):
        assert getattr(harness, name) == getattr(jax_harness, name)
    assert harness.VIDEO_EXTS == (".y4m",) + jax_harness.VIDEO_EXTS


def _touch(root, rel):
    p = os.path.join(root, rel)
    os.makedirs(os.path.dirname(p), exist_ok=True)
    open(p, "w").close()


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_collect_videos_matches_jax(tmp_path, seed):
    rng = np.random.RandomState(seed)
    for i in range(int(rng.randint(4, 12))):
        _touch(tmp_path, f"ffpp/test/real/r{i}.mp4")
    for i in range(int(rng.randint(4, 12))):
        tech = ("deepfakes", "face2face", "fake")[i % 3]
        _touch(tmp_path, f"ffpp/c23/{tech}/f{i}.avi")
    _touch(tmp_path, "unlabelled/u.mp4")
    _touch(tmp_path, "real/notes.txt")
    for per_class in (3, 500):
        assert harness.collect_videos(str(tmp_path), per_class, seed) == \
            jax_harness.collect_videos(str(tmp_path), per_class, seed)


def test_collect_videos_takes_y4m(tmp_path):
    _touch(tmp_path, "real/a.y4m")
    _touch(tmp_path, "fake/b.Y4M")
    assert sorted(v[1] for v in harness.collect_videos(str(tmp_path))) == [0, 1]


def test_collect_from_list_matches_jax(tmp_path):
    lp = tmp_path / "list.txt"
    lp.write_text("/x/real/a.mp4\n/y/fake/b.mp4,1\n# comment\n\n/z/unknown.mp4\n"
                  "/w/unknown.y4m,0\n  /v/celeb-real/c.mp4  \n")
    got = harness.collect_from_list(str(lp))
    assert got == jax_harness.collect_from_list(str(lp))
    assert [(v[0], v[1]) for v in got][:2] == [("/x/real/a.mp4", 0), ("/y/fake/b.mp4", 1)]


def test_other_containers_raise_naming_the_missing_decoder():
    with pytest.raises(ValueError, match="ROADMAP.md §1 item 2"):
        harness.iter_video_frames("/data/real/a.mp4")


def test_main_checks_every_container_before_scoring(tmp_path, monkeypatch):
    """A list that mixes ``.y4m`` and other containers fails before the
    engine is built, naming every file it cannot decode."""
    lst = tmp_path / "videos.txt"
    lst.write_text("/v/real/a.y4m\n/v/fake/b.mp4\n/v/real/c.y4m\n/v/fake/d.avi\n")
    built = []
    monkeypatch.setattr(harness, "build_engine", lambda args: built.append(args))
    with pytest.raises(ValueError, match="ROADMAP.md §1 item 2") as err:
        harness.main(["--video_list", str(lst), "--device", "cpu",
                      "--out_dir", str(tmp_path / "out")])
    assert "/v/fake/b.mp4" in str(err.value) and "/v/fake/d.avi" in str(err.value)
    assert ".y4m" not in str(err.value).split(": ", 1)[1]
    assert built == [] and not os.path.exists(tmp_path / "out")


# -- run_video: both engines on the same frames and weights -------------------


def _write_video(path, seed, n_frames=24, size=(120, 160)):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 255, size + (3,), np.uint8)
    frames = [np.clip(base.astype(np.int16) + rng.randint(-20, 21, base.shape), 0, 255)
              .astype(np.uint8) for _ in range(n_frames)]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_y4m(path, frames)
    return path


def fixed_detector(frame_bgr):
    """The fake detector of ``tests/test_harness.py:62``: one face, fixed."""
    lm = (STD_POINTS_256 * (50 / 256.0) + np.array([30, 25])).reshape(-1)
    return np.asarray([[30, 25, 50.0, 55.0, *lm, 0.95]], np.float32)


@pytest.fixture(scope="module")
def variables():
    return port_i3d_variables(I3DConfig(**CFG), seed=0)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("vids")
    return [(_write_video(str(root / "real" / "a.y4m"), 1), 0),
            (_write_video(str(root / "fake" / "b.y4m"), 2), 1)]


@pytest.fixture(scope="module")
def engines(variables):
    """One engine a side over the same weights; the JAX harness reads the
    port's decoded frames."""
    js = JaxClipScorer(variables, cfg=JaxI3DConfig(**CFG), dtype=jnp.float32,
                       use_pallas_warp=False)
    ts = ClipScorer.from_flax_variables(variables, cfg=I3DConfig(**CFG), dtype=torch.float32,
                                        device="cpu")
    out = {"jax": JaxStreamingEngine(js, fixed_detector, cfg=JaxPipelineConfig(**PIPE),
                                     **ENGINE_KW),
           "torch": StreamingEngine(ts, fixed_detector, cfg=PipelineConfig(**PIPE), **ENGINE_KW)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_harness, "iter_video_frames", harness.iter_video_frames)
        yield out
    for eng in out.values():
        eng.close()


@pytest.fixture(scope="module")
def runs(engines, videos):
    """Each side's ``run_video`` rows over a real and a fake video."""
    out = {}
    for side, mod in (("jax", jax_harness), ("torch", harness)):
        rows = []
        for path, gt in videos:
            r = mod.run_video(engines[side], path, threshold=0.5)
            r.update(gt_label=gt, dataset="test", subset="test",
                     device_mem_peak_mb=0.0, model_size=123)
            rows.append(r)
        out[side] = rows
    return out


def test_run_video_matches_jax(runs):
    for got, want in zip(runs["torch"], runs["jax"]):
        assert got["frames_processed"] == want["frames_processed"] == 24
        assert got["num_tracks"] == want["num_tracks"] == 1
        assert got["pred_label"] == want["pred_label"]
        assert 0.0 < got["video_score"] < 1.0
        assert abs(got["video_score"] - want["video_score"]) <= P_TOL
        assert got["per_person_labels"] == want["per_person_labels"]
        assert got["low_quality"] == want["low_quality"]
        assert got["id_switch_rate"] == want["id_switch_rate"]
        assert math.isfinite(got["latency_ms_clip_mean"])


def test_write_csvs_of_run_video_rows_match_jax_but_for_timing(runs, tmp_path):
    for side, mod in (("torch", harness), ("jax", jax_harness)):
        rows = runs[side]
        mod.write_csvs(rows, mod.summarize(rows, 123), str(tmp_path / side), threshold=0.5)
    for name in ("per_video.csv", "summary.csv"):
        got, want = (list(csv.DictReader(open(tmp_path / s / name))) for s in ("torch", "jax"))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for k in g:
                if k in ("video_score", "auc_roc", "pr_auc"):
                    assert abs(float(g[k]) - float(w[k])) <= P_TOL + 1e-6, k
                elif k not in TIMING:
                    assert g[k] == w[k], (name, k)


def test_run_sweep_matches_jax(engines, videos, tmp_path):
    """The pool sweep (``eval/sweep.py::run_sweep``) over both sides'
    engines: every pool method's accuracy equal, AUCs within 1e-4."""
    from stdd_tpu.eval.sweep import run_sweep as jax_run_sweep
    from stdd_torch.eval.sweep import run_sweep

    vids = [(p, gt, "test", "test") for p, gt in videos]
    got = run_sweep(engines["torch"], vids, threshold=0.5, out_dir=str(tmp_path))
    want = jax_run_sweep(engines["jax"], vids, threshold=0.5)
    assert [r["pool_method"] for r in got] == [r["pool_method"] for r in want]
    for g, w in zip(got, want):
        assert g["videos"] == w["videos"] == 2 and g["accuracy"] == w["accuracy"]
        for k in ("auc_roc", "pr_auc"):
            assert abs(g[k] - w[k]) <= P_TOL, k
    assert (tmp_path / "summary_all.csv").exists()


# -- summarize and write_csvs on the same rows --------------------------------


def _rows(y, s, pred, seed=0):
    rng = np.random.RandomState(seed)
    return [dict(video_path=f"/v/{i}.y4m", dataset="ffpp", subset="test", gt_label=int(t),
                 pred_label=int(p), video_score=float(v), frames_processed=int(rng.randint(1, 99)),
                 elapsed_s=float(rng.uniform(0.1, 3)), fps=float(rng.uniform(5, 90)),
                 latency_ms_clip_mean=float("nan") if i == 1 else float(rng.uniform(1, 50)),
                 num_tracks=int(rng.randint(0, 3)), id_switch_rate=float(rng.uniform(0, 2)),
                 device_mem_peak_mb=float(rng.uniform(0, 900)), model_size=4242,
                 cold_start=i == 0)
            for i, (t, v, p) in enumerate(zip(y, s, pred))]


ROW_SETS = {
    # tied scores across and within the classes
    "ties": _rows([0, 1, 1, 0, 1, 0, 1, 1], [0.3, 0.3, 0.9, 0.1, 0.5, 0.5, 0.5, 0.2],
                  [0, 0, 1, 0, 1, 1, 1, 0]),
    "single_class": _rows([1, 1, 1], [0.2, 0.8, 0.8], [0, 1, 1]),
    "all_real_none_flagged": _rows([0, 0], [0.1, 0.2], [0, 0]),
    "random": _rows(np.random.RandomState(3).randint(0, 2, 40),
                    np.round(np.random.RandomState(4).rand(40), 2),
                    np.random.RandomState(5).randint(0, 2, 40)),
    "empty": [],
}


@pytest.mark.parametrize("name", sorted(ROW_SETS))
def test_summarize_matches_jax(name):
    rows = ROW_SETS[name]
    got, want = harness.summarize(rows, 4242), jax_harness.summarize(rows, 4242)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float) and math.isnan(w):
            assert isinstance(g, float) and math.isnan(g), k
        elif isinstance(w, (float, np.floating)):
            assert abs(g - w) <= 1e-12, (k, g, w)
        else:
            assert g == w and type(g) is type(w), (k, g, w)


@pytest.mark.parametrize("name", ["ties", "single_class", "empty"])
def test_write_csvs_match_jax(name, tmp_path):
    rows = ROW_SETS[name]
    for side, mod in (("torch", harness), ("jax", jax_harness)):
        mod.write_csvs(rows, mod.summarize(rows, 4242), str(tmp_path / side), threshold=0.4)
    for f in ("per_video.csv", "summary.csv"):
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


def test_device_mem_peak_is_not_a_cpu_number():
    assert math.isnan(harness.device_mem_peak_mb("cpu"))


# -- build_engine and the CLI -------------------------------------------------


def _args(tmp_path, **kw):
    ns = dict(clip_size=8, stride=4, detect_every=2, batch_clips=2, threshold=0.4,
              pool_method="mean", min_det_side=5, crop_scale=0.5, crop_buffer=128,
              det_conf=0.6, det_size=320, det_topk=64, upload_format="rgb", int8=False,
              warmup=True, quality=True, track_thresh=None, ckpt=None, jax_ckpt=None,
              model_crop=None, device="cpu",
              yunet_model=write_onnx(yunet_shaped_graph(0), str(tmp_path / "yunet.onnx")))
    ns.update(kw)
    return argparse.Namespace(**ns)


@pytest.fixture(scope="module")
def sidecar_ckpt(variables, tmp_path_factory):
    """A trainer checkpoint whose sidecar says 16 frames at crop 64."""
    return save_checkpoint(str(tmp_path_factory.mktemp("ckpt")), "i3d", 1, variables,
                           metadata={"clip_size": 16, "crop_size": 64, "temporal_only": False})


def test_build_engine_takes_clip_size_over_the_sidecar(tmp_path, sidecar_ckpt, variables):
    """ADVICE.md r5 #2: the JAX harness takes num_frames from the sidecar
    and windows at --clip_size; the port takes crop_size from the sidecar
    and num_frames from --clip_size. That mismatch is the only one skipped:
    the crop size, the pipeline and the weights agree."""
    engine, warmed = harness.build_engine(_args(tmp_path, jax_ckpt=sidecar_ckpt))
    jax_engine, jax_warmed = jax_harness.build_engine(_args(tmp_path, jax_ckpt=sidecar_ckpt))
    try:
        cfg, jcfg = engine.scorer.cfg, jax_engine.scorer.cfg
        assert (cfg.num_frames, cfg.crop_size) == (8, 64)
        assert (jcfg.num_frames, jcfg.crop_size) == (16, 64)      # ADVICE.md r5 #2, not copied
        assert cfg.temporal_only == jcfg.temporal_only is False
        assert engine.cfg.clip_size == jax_engine.cfg.clip_size == 8
        for f in ("stride", "detect_every", "batch_clips", "threshold", "pool_method",
                  "min_face_side", "crop_scale"):
            assert getattr(engine.cfg, f) == getattr(jax_engine.cfg, f), f
        assert engine.crop_buffer == jax_engine.crop_buffer == 128
        assert not warmed and not jax_warmed
        got = i3d_torch_to_flax(engine.scorer.model.state_dict())
        np.testing.assert_array_equal(got["params"]["s1"]["pathway0_stem"]["conv"]["kernel"],
                                      variables["params"]["s1"]["pathway0_stem"]["conv"]["kernel"])
    finally:
        engine.close()
        jax_engine.close()
    engine, _ = harness.build_engine(_args(tmp_path, jax_ckpt=sidecar_ckpt, model_crop=96))
    assert (engine.scorer.cfg.num_frames, engine.scorer.cfg.crop_size) == (8, 96)
    engine.close()


def test_build_engine_refuses_two_checkpoints_and_a_missing_card(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="mutually exclusive"):
        harness.build_engine(_args(tmp_path, ckpt="a.pth", jax_ckpt="b.msgpack"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        harness.build_engine(_args(tmp_path, device="cuda"))


def test_main_refuses_int8():
    with pytest.raises(SystemExit, match="ROADMAP.md §1 item 9"):
        harness.main(["--video_root", ".", "--int8", "--device", "cpu"])


def test_main_runs_a_reference_ckpt_on_the_cpu(tmp_path, variables, capsys):
    """The CLI end to end on the CPU over a list file: ``--ckpt`` in the
    reference's format, YuNet on a graph of its layout with random weights.
    ``--det_conf`` above every score keeps the detector from starting
    tracks, so no full-width clip is scored on the CPU (``run_video``'s
    scoring is held to JAX above)."""
    from stdd_torch.utils.weights import i3d_flax_to_torch

    ref = str(tmp_path / "ref.pth")
    torch.save({"classifier": i3d_torch_to_reference(i3d_flax_to_torch(variables))}, ref)
    lst = tmp_path / "videos.txt"
    lst.write_text("\n".join([_write_video(str(tmp_path / "v" / "real" / "a.y4m"), 1, 10),
                              _write_video(str(tmp_path / "v" / "fake" / "b.y4m"), 2, 10) + ",1"]))
    out = tmp_path / "out"
    harness.main(["--video_list", str(lst), "--out_dir", str(out), "--device", "cpu",
                  "--ckpt", ref, "--clip_size", "8", "--max_frames", "6", "--det_conf", "1.01",
                  "--yunet_model", write_onnx(yunet_shaped_graph(0), str(tmp_path / "y.onnx"))])
    rows = list(csv.DictReader(open(out / "per_video.csv")))
    assert [r["gt_label"] for r in rows] == ["0", "1"]
    assert all(r["frames_processed"] == "6" for r in rows)
    assert all(int(r["model_size"]) == os.path.getsize(ref) for r in rows)
    assert all(r["device_mem_peak_mb"] == "nan" for r in rows)
    summary = list(csv.DictReader(open(out / "summary.csv")))
    assert summary[0]["videos"] == "2"
    assert json.loads(summary[0]["confusion_matrix"]) == [[1, 0], [1, 0]]
    assert "Summary:" in capsys.readouterr().out
