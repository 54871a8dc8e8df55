"""The port's YuNet, NMS and IoU matrices against the JAX package.

The real YuNet ONNX is not in the repository, so the detector is held to
``stdd_tpu.models.yunet.YuNetTPU`` on the YuNet-shaped graph of
``stdd_torch/utils/onnx_writer.py`` (random weights from a seed, the head
biases set so that tens of anchors clear the 0.6 score): both packages read
the same ONNX file through their own readers.

Tolerances: rows within 1e-3 px and scores within 1e-5 (float32 convs in
another order of sums), the decode within 1e-5 relative, the resize within
1 grey level of ``cv2.resize(INTER_LINEAR)`` (cv2 weighs uint8 pixels in
11-bit fixed point; at integer ratios the two are equal), and NMS indices
and masks identical. cv2 appears only here, never in the port.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stdd_tpu.models import yunet as jax_yunet
from stdd_tpu.models.yunet import YuNetTPU, detect_scaled as jax_detect_scaled
from stdd_tpu.ops import nms as jax_nms
from stdd_torch.config import DetectorConfig
from stdd_torch.eval.scene import Scene
from stdd_torch.models import yunet
from stdd_torch.models.yunet import YuNet, detect_scaled, resize_linear_u8
from stdd_torch.ops import nms
from stdd_torch.utils.onnx_writer import write_onnx, yunet_shaped_graph

PX_TOL = 1e-3
SCORE_TOL = 1e-5


@pytest.fixture(scope="module")
def detectors(tmp_path_factory):
    path = write_onnx(yunet_shaped_graph(seed=0),
                      str(tmp_path_factory.mktemp("yunet") / "yunet_shaped.onnx"))
    return YuNetTPU(path), YuNet(path, device="cpu")


@pytest.fixture(scope="module")
def jax_detections(detectors):
    """The JAX detector on ``_frames()``, computed once (one compile)."""
    return tuple(np.asarray(a) for a in detectors[0].detect(_frames()))


def _frames():
    """Two 320² frames: a scene (smooth, one face) and uniform noise."""
    scene = Scene((1080, 1920), n_faces=1, seed=0).frame(5)
    small = cv2.resize(scene, (320, 320))
    noise = np.random.RandomState(0).randint(0, 256, (320, 320, 3), np.uint8)
    return np.stack([small, noise])


def _assert_same_rows(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got[:, :14] - want[:, :14]).max(initial=0.0) <= PX_TOL
    assert np.abs(got[:, 14] - want[:, 14]).max(initial=0.0) <= SCORE_TOL


def test_detect_matches_jax(detectors, jax_detections):
    jd, td = detectors
    frames = _frames()
    jdets, jmask = jax_detections
    tdets, tmask = td.detect(frames)
    assert tdets.shape == (2, 128, 15) and tmask.shape == (2, 128)
    assert tdets.dtype == np.float32 and tmask.dtype == bool
    np.testing.assert_array_equal(tmask, jmask)
    assert 5 <= tmask[0].sum() and tmask[1].sum() > tmask[0].sum()
    for b in range(2):
        _assert_same_rows(tdets[b][tmask[b]], jdets[b][jmask[b]])
    assert not tdets[~tmask].any()                        # padding rows are zero
    # the head outputs themselves
    blob = frames[:1].astype(np.float32).transpose(0, 3, 1, 2)
    jo, to = jd.module(blob), td.module(torch.from_numpy(blob))
    assert sorted(to) == sorted(f"{h}_{s}" for h in ("cls", "obj", "bbox", "kps")
                                 for s in (8, 16, 32))
    for k, v in to.items():
        assert v.shape == jo[k].shape
        np.testing.assert_allclose(v.numpy(), np.asarray(jo[k]), rtol=0, atol=1e-4)
    # tens of anchors clear the 0.6 score: the NMS parity is not vacuous
    _, scores, _ = td._decode_one(to, 320, 320)
    assert 10 <= int((scores > 0.6).sum()) <= 200


def test_detect_np_and_a_single_frame(detectors, jax_detections):
    """One frame, as an array or a tensor, gives the rows it gets in a batch."""
    _, td = detectors
    jdets, jmask = jax_detections
    frame = _frames()[1]
    _assert_same_rows(td.detect_np(frame), jdets[1][jmask[1]])
    _assert_same_rows(td.detect_np(torch.from_numpy(frame)), jdets[1][jmask[1]])


def test_decode_matches_jax(detectors):
    jd, td = detectors
    rng = np.random.RandomState(1)
    outs = {}
    for s in (8, 16, 32):
        n = (320 // s) ** 2
        outs.update({f"cls_{s}": rng.uniform(-0.2, 1.2, (1, n, 1)),
                     f"obj_{s}": rng.uniform(-0.2, 1.2, (1, n, 1)),
                     f"bbox_{s}": rng.randn(1, n, 4), f"kps_{s}": rng.randn(1, n, 10)})
    outs = {k: v.astype(np.float32) for k, v in outs.items()}
    want = jax.jit(lambda o: jd._decode_one(o, 320, 320))(outs)
    got = td._decode_one({k: torch.from_numpy(v) for k, v in outs.items()}, 320, 320)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-5 * max(1.0, np.abs(w).max())


@pytest.mark.parametrize("hw", [(640, 640), (960, 1280)])
def test_detect_scaled_matches_jax(detectors, hw):
    """At integer ratios the port's resize equals cv2's, so the scaled rows
    of the two packages agree to the detector's tolerance."""
    jd, td = detectors
    frame = cv2.resize(Scene((1080, 1920), n_faces=1, seed=1).frame(0), hw[::-1])
    got, want = detect_scaled(td, frame, 320), jax_detect_scaled(jd, frame, 320)
    assert len(got) >= 5
    _assert_same_rows(got, want)
    with pytest.raises(ValueError, match="multiple of 32"):
        detect_scaled(td, frame, 300)


@pytest.mark.parametrize("hw,out", [((1080, 1920), 320), ((200, 150), 320), ((640, 640), 320),
                                    ((321, 333), 96)])
def test_resize_within_one_grey_level_of_cv2(hw, out):
    src = np.random.RandomState(2).randint(0, 256, hw + (3,), np.uint8)
    want = cv2.resize(src, (out, out), interpolation=cv2.INTER_LINEAR).astype(int)
    got = resize_linear_u8(torch.from_numpy(src), out, out).numpy()
    assert got.dtype == np.uint8 and got.shape == (out, out, 3)
    assert np.abs(got.astype(int) - want).max() <= 1
    if hw == (640, 640):
        np.testing.assert_array_equal(got, want)


def _nms_boxes(rng, n):
    xy = rng.uniform(0, 300, (n, 2))
    wh = rng.uniform(5, 60, (n, 2))
    # clusters of near-duplicates so suppression has work to do
    xy[n // 2:] = xy[: n - n // 2] + rng.normal(0, 3, (n - n // 2, 2))
    return np.concatenate([xy, wh], 1).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "plus1", "ties", "all_below", "capacity"])
def test_nms_matches_jax(case):
    rng = np.random.RandomState({"random": 0, "plus1": 1, "ties": 2, "all_below": 3,
                                 "capacity": 4}[case])
    boxes = _nms_boxes(rng, 300)
    scores = rng.uniform(0, 1, 300).astype(np.float32)
    if case == "ties":
        scores = np.round(scores * 4) / 4            # many exact ties
    if case == "all_below":
        scores *= 0.5
    max_out = 8 if case == "capacity" else 64
    kw = dict(plus1=case == "plus1")
    jk, jm = jax_nms.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), 0.3, 0.6, max_out, **kw)
    tk, tm = nms.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores), 0.3, 0.6,
                           max_out, **kw)
    assert tk.dtype == torch.int32 and tm.dtype == torch.bool and tk.shape == (max_out,)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    n = int(tm.sum())
    assert (n == 0) if case == "all_below" else (n == max_out if case == "capacity" else n > 5)


def test_nms_refuses_device_tensors():
    """The loop runs on the host only; a device tensor is refused, not
    copied behind the caller's back (``meta`` stands in for the card)."""
    boxes = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError, match="runs on the host"):
        nms.nms_fixed(boxes, torch.zeros((4,), device="meta"), 0.3, 0.6, 2)


def test_yunet_takes_its_settings_from_detector_config(detectors, tmp_path):
    """``DetectorConfig`` is the detector's one source of settings: the
    input size ``detect_scaled`` resizes to by default, ``top_k``, and the
    thresholds."""
    _, td = detectors
    frame = Scene((1080, 1920), n_faces=1, seed=1).frame(0)
    assert td.input_size == (320, 320)
    np.testing.assert_array_equal(detect_scaled(td, frame), detect_scaled(td, frame, 320))
    path = write_onnx(yunet_shaped_graph(seed=0), str(tmp_path / "yunet_shaped.onnx"))
    small = YuNet(path, DetectorConfig(input_w=160, input_h=160, top_k=4), device="cpu")
    want = detect_scaled(td, frame, 160)
    assert len(want) > 4
    np.testing.assert_array_equal(detect_scaled(small, frame), want[:4])
    strict = YuNet(path, DetectorConfig(conf_threshold=0.9), device="cpu")
    dets, mask = strict.detect(_frames())
    full, full_mask = td.detect(_frames())
    assert (dets[mask][:, 14] > 0.9).all() and (full[full_mask][:, 14] <= 0.9).any()


def test_iou_matrices_match_jax():
    rng = np.random.RandomState(5)
    a, b = _nms_boxes(rng, 40), _nms_boxes(rng, 30)
    a[0, 2] = -3.0                                     # a degenerate box
    for fn in ("iou_matrix_xywh", "iou_matrix_xyxy"):
        aa, bb = (a, b) if fn.endswith("xywh") else (
            np.concatenate([a[:, :2], a[:, :2] + a[:, 2:]], 1),
            np.concatenate([b[:, :2], b[:, :2] + b[:, 2:]], 1))
        got = getattr(nms, fn)(torch.from_numpy(aa), torch.from_numpy(bb)).numpy()
        want = np.asarray(getattr(jax_nms, fn)(jnp.asarray(aa), jnp.asarray(bb)))
        assert got.shape == (40, 30)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_real_yunet_weights_match_jax():
    """The reference's own weights through both packages. The file is not in
    the repository yet (``models/yunet.py`` DEFAULT_MODEL, and the JAX
    package's DEFAULT_MODEL under the absent reference checkout)."""
    path = next((p for p in (yunet.DEFAULT_MODEL, jax_yunet.DEFAULT_MODEL)
                 if os.path.exists(p)), None)
    if path is None:
        pytest.skip("face_detection_yunet_2023mar.onnx is not in the repository")
    jd, td = YuNetTPU(path), YuNet(path, device="cpu")
    frames = _frames()
    jdets, jmask = (np.asarray(a) for a in jd.detect(frames))
    tdets, tmask = td.detect(frames)
    np.testing.assert_array_equal(tmask, jmask)
    for b in range(2):
        _assert_same_rows(tdets[b][tmask[b]], jdets[b][jmask[b]])
