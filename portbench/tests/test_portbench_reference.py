"""The plain reference against the port's scorer at a tiny width on the CPU,
and the output check against faults planted under the timed path."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from conftest import BENCH, TINY_MODEL

from portbench.lib.check import FAULTS, signed_gaps
from portbench.lib.harness import run_cell
from portbench.lib.program import build_scorer
from portbench.lib.registry import Cell, load_module
from portbench.reference import align, i3d
from portbench.reference.scorer import logits_and_features


def _tiny_config(name: str) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg["model"].update(TINY_MODEL)
    cfg["serving"].update(crop_buffer=40, dtype="float32")
    return cfg


@pytest.mark.parametrize("name", ["i3d_r50"])
def test_reference_matches_the_scorer_in_float32(name):
    """Every stage the check covers (I420 decode, the similarity solve, the
    warp, the normalisation, the trunk, the head), both at float32: the
    gap is rounding alone."""
    torch.manual_seed(0)
    cfg = _tiny_config(name)
    scorer, params, spec = build_scorer(cfg, 2**35 + 9, torch.device("cpu"))
    dense = load_module(BENCH / "traffic" / "dense.py", "portbench_test_dense")
    mix = json.loads((BENCH / "traffic" / "dense_ffpp.json").read_text())
    mix.update(face_px=[14, 18])
    rng = np.random.default_rng(3)
    gen = torch.Generator().manual_seed(3)
    frames, boxes, lm5 = dense.make_track(gen, rng, 19, 40, mix, "cpu")
    starts = np.arange(0, 12, 3)
    probs = scorer.score_dense(frames, boxes, lm5, starts, batch=4)
    T = spec.frames
    windows = [(frames[s:s + T], boxes[s:s + T], lm5[s:s + T]) for s in starts]
    ref_logits, ref_feats = logits_and_features(params, spec, windows, 1e-5, "cpu")
    gaps = np.abs(signed_gaps(probs, ref_logits[:, 0], ref_feats,
                              params["head.projection.weight"]))
    assert gaps.max() < 2e-5, gaps


def test_live_packing_matches_the_ring():
    """The reference's crop → area downscale → I420 against the program's
    packer, on a 1080p scene frame: within one grey level."""
    from stdd_torch.runtime.engine import get_crop_box
    from stdd_torch.runtime.packing import _encode_slot_yuv420

    from portbench.lib.scene import Scene

    scene = Scene((1080, 1920), n_faces=4, seed=11)
    frame = scene.frame(5)
    for row in scene.detect(5):
        bb = get_crop_box((1080, 1920), np.array([row[0], row[1], row[0] + row[2],
                                                  row[1] + row[3]]), 0.5)
        slot, s = align.pack_crop(frame, bb, 256)
        crop = np.ascontiguousarray(frame[bb[1]:bb[3], bb[0]:bb[2], ::-1])
        want = np.zeros((384, 256), np.uint8)
        _encode_slot_yuv420(dict(crop=crop, big_box=bb, lm5=np.zeros((5, 2))),
                            np.zeros((256, 256, 3), np.uint8), s, want)
        diff = np.abs(want.astype(int) - slot.numpy().astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.05


def test_every_seed_crops_the_same_sizes():
    """The live mix's grid: whatever the seed (its faces and its mirror of
    the motion), each frame's crop sizes are the same set and no two faces
    overlap, so the host's work does not hang on the seed."""
    from stdd_torch.runtime.engine import get_crop_box

    live = load_module(BENCH / "traffic" / "live.py", "portbench_test_live")
    mix = json.loads((BENCH / "traffic" / "grid_calls.json").read_text())
    hw = tuple(mix["frame_hw"])
    seen = []
    for seed, flip in ((3, (1, 1)), (4, (-1, 1)), (5, (1, -1)), (6, (-1, -1))):
        sc = live.grid_scene(hw, mix["faces"], seed, mix["motion"], flip)
        sizes = []
        for i in range(0, 400, 7):
            rows = sc.detect(i)
            boxes = np.stack([rows[:, 0], rows[:, 1], rows[:, 0] + rows[:, 2],
                              rows[:, 1] + rows[:, 3]], 1)
            for p in range(len(boxes)):
                for q in range(p + 1, len(boxes)):
                    assert (boxes[p, 2] <= boxes[q, 0] or boxes[q, 2] <= boxes[p, 0]
                            or boxes[p, 3] <= boxes[q, 1] or boxes[q, 3] <= boxes[p, 1])
            crops = [get_crop_box(hw, b, 0.5) for b in boxes]
            sizes.append(sorted((c[2] - c[0]) * (c[3] - c[1]) for c in crops))
        seen.append(np.asarray(sizes, np.float64))
    for other in seen[1:]:
        assert np.allclose(other, seen[0], rtol=0.01), np.abs(other - seen[0]).max()


def test_similarity_takes_the_reference_choice():
    """Template landmarks moved by a known similarity fit back to it; a
    mirrored set picks the reflective candidate as the reference's quirk
    does, never a NaN."""
    tpl = align.TEMPLATE_256 * (224 / 256)
    ang, sc, t = 0.2, 1.7, np.array([31.0, -12.0])
    R = sc * np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    src = (tpl - t) @ np.linalg.inv(R).T
    M = align.similarity_2x3(src, tpl)
    assert np.allclose(src @ M[:, :2].T + M[:, 2], tpl, atol=1e-9)
    assert np.isfinite(align.similarity_2x3(src * [-1, 1], tpl)).all()


@pytest.mark.parametrize("cell", ["tiny.dense", "tiny.live"])
def test_the_check_passes_a_sound_run_and_fails_every_fault(tiny_bench, cell):
    """A whole run of a tiny cell on the CPU, the chip's look skipped: the
    sound program is correct, and each fault the cell can have, planted
    under the timed path, makes ``correct`` false."""
    torch.set_num_threads(2)
    c = Cell(cell, tiny_bench)
    out, checks = run_cell(c, 2**33 + 17, 0.6, False, torch.device("cpu"), time.perf_counter())
    assert out["correct"], checks
    assert out["attempted"] > 0
    # a failure is a window never scored or scored to no finite probability;
    # a late one is not
    assert out["failed"] == 0
    for fault in getattr(c.kind(), "FAULTS", FAULTS):
        out, checks = run_cell(c, 2**33 + 17, 0.6, False, torch.device("cpu"),
                               time.perf_counter(), fault=fault)
        assert not out["correct"], (fault, checks)
