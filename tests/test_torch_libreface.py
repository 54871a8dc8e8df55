"""The port's LibreFace alignment against the JAX package's
(``stdd_torch/data/libreface_align.py`` vs ``stdd_tpu/data/libreface_align.py``),
with the face of ``tests/test_libreface_align.py:23`` (a rendered face,
rendered here by the port's renderer, pasted into a 360² frame, optionally
rolled 25°).

Tolerances:
- ``perspective_transform`` and ``cv2.getPerspectiveTransform``: equal
  (the same float64 operations in the same order);
- ``warp_perspective_u8`` and ``cv2.warpPerspective`` on random pixels:
  ≤ 1 grey level on ≤ 5e-4 of the values (cv2 5.0's fused multiply-adds
  put some values on the other side of .5);
- ``image_align`` and JAX's at 128, 256 and 512: the same bound;
- ``get_aligned_image`` and ``main``: the same landmarker (the port's
  packaged one on the CPU) and a stub detector returning the pasted face's
  box, patched into both packages (this test only, as YuNet's ONNX is not
  in the repository): landmarks equal, crops within the ``image_align``
  bound, the PNG the port writes equal to its crop.
"""

import os

import cv2
import numpy as np
import pytest
import torch

import stdd_tpu.data.libreface_align as J
import stdd_tpu.models.facemesh as JF
import stdd_tpu.models.yunet as JY
import stdd_torch.data.libreface_align as P
import stdd_torch.models.facemesh as PF
import stdd_torch.models.yunet as PY
from stdd_torch.ops.align import perspective_transform, warp_perspective_u8
from stdd_torch.utils import image_io

FRAC = 5e-4          # values that may lie one grey level from cv2's warp


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    # six test processes share the host's cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _face_frame(angle_deg=0.0, size=360):
    """The rendered face of ``tests/test_libreface_align.py:23`` and its
    true landmarks, with the port's renderer."""
    z = torch.zeros
    img = PF.render_faces(z(1, 4), z(1, 6), z(1, 8), size=128)[0].numpy()
    face = (img * 255).astype(np.uint8)
    frame = np.full((size, size, 3), 110, np.uint8)
    fs, off = 200, 80
    frame[off:off + fs, off:off + fs] = cv2.resize(face, (fs, fs))
    pts = PF.canonical_mesh() * fs + off
    if angle_deg:
        M = cv2.getRotationMatrix2D((size / 2, size / 2), angle_deg, 1.0)
        frame = cv2.warpAffine(frame, M, (size, size), borderValue=(110, 110, 110))
        pts = pts @ M[:, :2].T + M[:, 2]
    return frame, pts.astype(np.float32)


def _lm72(dense):
    return np.concatenate([dense[P.RIGHT_EYE_IDX], dense[P.LEFT_EYE_IDX], dense[P.LIPS_IDX]])


def _close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(int) - want)
    assert d.max() <= 1 and (d > 0).mean() <= FRAC, (d.max(), (d > 0).mean())


def test_index_tables_are_jax():
    assert (P.RIGHT_EYE_IDX, P.LEFT_EYE_IDX, P.LIPS_IDX) == (J.RIGHT_EYE_IDX, J.LEFT_EYE_IDX,
                                                           J.LIPS_IDX)


def test_perspective_transform_and_warp_match_cv2():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (180, 200, 3)).astype(np.uint8)
    dst = np.float32([[0, 0], [0, 256], [256, 256], [256, 0]])
    for _ in range(4):
        c, a, s = rng.uniform(60, 140, 2), rng.uniform(-0.6, 0.6), rng.uniform(30, 70)
        x = np.array([np.cos(a), np.sin(a)]) * s
        y = np.flipud(x) * [-1, 1] * rng.uniform(0.8, 1.2)
        quad = (np.stack([c - x - y, c - x + y, c + x + y, c + x - y])
                + rng.uniform(-4, 4, (4, 2))).astype(np.float32)
        M = perspective_transform(quad, dst)
        np.testing.assert_array_equal(M, cv2.getPerspectiveTransform(quad, dst))
        _close(warp_perspective_u8(img, M, (256, 256)),
               cv2.warpPerspective(img, M, (256, 256), flags=cv2.INTER_LINEAR,
                                   borderMode=cv2.BORDER_CONSTANT))
    with pytest.raises(ValueError, match="degenerate"):
        perspective_transform(np.zeros((4, 2), np.float32), dst)


@pytest.mark.parametrize("angle", [0.0, 25.0])
@pytest.mark.parametrize("out", [128, 256, 512])
def test_image_align_matches_jax(angle, out):
    frame, pts = _face_frame(angle)
    _close(P.image_align(frame, _lm72(pts), output_size=out),
           J.image_align(frame, _lm72(pts), output_size=out))


def test_image_align_rotation_invariant():
    """The check of ``tests/test_libreface_align.py``: an upright face and
    the same face rolled 25° give nearly the same crop."""
    f0, p0 = _face_frame(0.0)
    f1, p1 = _face_frame(25.0)
    a0 = P.image_align(f0, _lm72(p0), output_size=128).astype(np.float32)
    a1 = P.image_align(f1, _lm72(p1), output_size=128).astype(np.float32)
    c0, c1 = a0[24:104, 24:104], a1[24:104, 24:104]
    assert np.corrcoef(c0.ravel(), c1.ravel())[0, 1] > 0.95
    assert np.abs(c0 - c1).mean() < 12.0


@pytest.fixture
def stubs(monkeypatch):
    """One landmarker (the port's packaged one, on the CPU) and a detector
    row at the pasted face's box, for both packages' defaults."""
    lm = PF.DenseLandmarker.pretrained(device="cpu")
    row = np.array([[80, 80, 200, 200] + [0.0] * 10 + [0.9]], np.float32)
    calls = []

    def detect_scaled(det, frame_bgr, *a, **kw):
        calls.append(frame_bgr.shape)
        return row.copy()

    for mod in (JY, PY):
        monkeypatch.setattr(mod, "detect_scaled", detect_scaled)
    monkeypatch.setattr(JY, "YuNetTPU", lambda **kw: "stub")
    monkeypatch.setattr(PY, "YuNet", lambda *a, **kw: "stub")
    for mod in (JF, PF):
        monkeypatch.setattr(mod.DenseLandmarker, "pretrained", classmethod(lambda cls, **kw: lm))
    return calls


def test_get_aligned_image_and_main_match_jax(tmp_path, stubs, capsys):
    frame, _ = _face_frame(0.0)
    path = str(tmp_path / "face.png")
    image_io.imwrite(path, frame[:, :, ::-1])
    for out in (256, 128):
        got = P.get_aligned_image(path, out_size=out, device="cpu")
        want = J.get_aligned_image(path, out_size=out)
        _close(got[0], want[0])
        assert sorted(got[1]) == sorted(want[1])
        for k in want[1]:
            np.testing.assert_array_equal(got[1][k], want[1][k])
    assert got[0].shape == (128, 128, 3) and got[1]["lips"].shape == (40, 2)
    assert stubs == [(360, 360, 3)] * 4

    assert P.main(["--image", path, "--out_dir", str(tmp_path / "port"), "--device", "cpu",
                   "--au_ckpt", "random"]) == 0
    assert "AUs:" in capsys.readouterr().out
    assert J.main(["--image", path, "--out_dir", str(tmp_path / "jax")]) == 0
    port_png = image_io.imread(str(tmp_path / "port" / "face_aligned.png"))
    _close(port_png, cv2.imread(str(tmp_path / "jax" / "face_aligned.png")))
    np.testing.assert_array_equal(port_png[:, :, ::-1], P.get_aligned_image(
        path, device="cpu")[0])
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "face_landmark.npy"),
                                  np.load(tmp_path / "jax" / "face_landmark.npy"))
    assert os.path.exists(tmp_path / "port" / "face_landmark.npy")


def test_main_without_a_face_returns_1(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(PY, "detect_scaled", lambda *a, **kw: np.zeros((0, 15), np.float32))
    monkeypatch.setattr(PY, "YuNet", lambda *a, **kw: "stub")
    monkeypatch.setattr(PF.DenseLandmarker, "pretrained", classmethod(lambda cls, **kw: None))
    path = str(tmp_path / "blank.png")
    image_io.imwrite(path, np.zeros((64, 64, 3), np.uint8))
    assert P.main(["--image", path, "--out_dir", str(tmp_path / "o"), "--device", "cpu"]) == 1
    assert "no face detected" in capsys.readouterr().out
