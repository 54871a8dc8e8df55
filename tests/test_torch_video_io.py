"""The port's YUV4MPEG2 reader and writer (``stdd_torch/utils/video_io.py``).

Tolerances: the decode of a frame's planes is bit-equal to
``cv2.cvtColor(COLOR_YUV2BGR_I420)``, and the written planes to
``cv2.cvtColor(COLOR_RGB2YUV_I420)`` of the frame. Through
``cv2.VideoCapture`` (ffmpeg's own YUV→BGR) a frame may differ by at most 3
grey levels; on random frames about 1.0 on average (measured 1.01-1.04).
"""

import os

import numpy as np
import pytest

from stdd_torch.utils.video_io import parse_header, read_y4m, write_y4m

cv2 = pytest.importorskip("cv2", reason="cv2 is the reference decoder these tests compare with")


def _frames(n=5, hw=(48, 80), seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, hw + (3,)).astype(np.uint8) for _ in range(n)]


def test_round_trip_matches_cv2_colour_conversions(tmp_path):
    frames = _frames()
    path = str(tmp_path / "a.y4m")
    assert write_y4m(path, frames, fps=25) == len(frames)
    raw = open(path, "rb").read()
    header = raw[:raw.index(b"\n") + 1]
    assert header == b"YUV4MPEG2 W80 H48 F25:1 Ip A1:1 C420jpeg\n"
    got = list(read_y4m(path))
    assert len(got) == len(frames)
    size = 80 * 48 * 3 // 2
    for i, (g, f) in enumerate(zip(got, frames)):
        start = len(header) + i * (6 + size) + 6
        planes = np.frombuffer(raw[start:start + size], np.uint8).reshape(72, 80)
        np.testing.assert_array_equal(planes, cv2.cvtColor(f[..., ::-1].copy(),
                                                           cv2.COLOR_RGB2YUV_I420))
        np.testing.assert_array_equal(g, cv2.cvtColor(planes, cv2.COLOR_YUV2BGR_I420))
    assert len(list(read_y4m(path, max_frames=2))) == 2


def test_reader_against_cv2_videocapture(tmp_path):
    path = str(tmp_path / "b.y4m")
    write_y4m(path, _frames(seed=1))
    cap = cv2.VideoCapture(path)
    ref = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        ref.append(f)
    cap.release()
    got = list(read_y4m(path))
    assert len(ref) == len(got) == 5
    d = np.abs(np.stack(got).astype(int) - np.stack(ref))
    assert d.max() <= 3, d.max()
    assert d.mean() <= 1.5, d.mean()


@pytest.mark.parametrize("header,word", [
    (b"YUV4MPEG2 W64 H48 F30:1 It A1:1 C420jpeg\n", "interlaced"),
    (b"YUV4MPEG2 W64 H48 F30:1 Ip A1:1 C444\n", "C444"),
    (b"YUV4MPEG2 W63 H48 F30:1 Ip\n", "63x48"),
    (b"YUV4MPEG2 H48 F30:1 Ip\n", "without W"),
    (b"RIFF....AVI LIST\n", "not a YUV4MPEG2"),
], ids=["interlaced", "chroma_444", "odd_width", "no_width", "other_magic"])
def test_bad_header_is_refused_by_name(tmp_path, header, word):
    path = str(tmp_path / "bad.y4m")
    with open(path, "wb") as f:
        f.write(header + b"FRAME\n" + bytes(64 * 48 * 3))
    with pytest.raises(ValueError, match=word) as e:
        list(read_y4m(path))
    assert "bad.y4m" in str(e.value)


def test_header_defaults_and_truncated_last_frame(tmp_path):
    tags = parse_header(b"YUV4MPEG2 W4 H2\n")
    assert (tags["W"], tags["H"]) == ("4", "2")
    path = str(tmp_path / "t.y4m")
    write_y4m(path, _frames(n=3, hw=(4, 6)))
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:-5])
    assert len(list(read_y4m(path))) == 2
    with pytest.raises(ValueError, match="not 6x4"):
        write_y4m(str(tmp_path / "m.y4m"), [np.zeros((4, 6, 3), np.uint8),
                                            np.zeros((6, 4, 3), np.uint8)])
    assert os.path.getsize(path) > 0


# -- the helpers of stdd_tpu/utils/video_io.py ----------------------------------
# JAX's helpers decode through cv2.VideoCapture, which is patched (this test
# only) to the port's reader; so the helpers' selection of frames, and not
# the two decoders, is compared: every frame and row must be equal.

from stdd_tpu.utils import video_io as jax_vio  # noqa: E402
from stdd_torch.utils import video_io as vio  # noqa: E402

from torch_port_helpers import install_y4m_capture  # noqa: E402


@pytest.fixture
def video(tmp_path):
    path = str(tmp_path / "v.y4m")
    write_y4m(path, _frames(n=20, hw=(48, 64), seed=2))
    return path


def _same_frames(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_grab_all_frames_and_clips_match_jax(video, monkeypatch):
    install_y4m_capture(monkeypatch)
    for max_size, cvt in ((10, False), (7, True), (0, False), (50, True)):
        _same_frames(vio.grab_all_frames(video, max_size, cvt),
                     jax_vio.grab_all_frames(video, max_size, cvt))
    for count, clip in ((3, 5), (1, 20), (40, 4), (2, 21), (5, 1)):
        got = vio.get_clips_uniform(video, count, clip)
        want = jax_vio.get_clips_uniform(video, count, clip)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_frames(g, w)


def test_frame_count_from_the_size_or_a_scan(tmp_path, video):
    """A bare ``FRAME`` header: the count comes from the file's size; frame
    parameters or a truncated last frame: from a scan of the headers."""
    assert vio.count_y4m_frames(video) == 20
    raw = open(video, "rb").read()
    with_params = raw.replace(b"FRAME\n", b"FRAME Ixyz\n")
    p = str(tmp_path / "params.y4m")
    open(p, "wb").write(with_params)
    assert vio.count_y4m_frames(p) == 20
    _same_frames(list(read_y4m(p)), list(read_y4m(video)))
    open(p, "wb").write(raw[:-100])
    assert vio.count_y4m_frames(p) == 19
    clips = vio.get_clips_uniform(p, 2, 19)
    assert len(clips) == 1 and len(clips[0]) == 19


def test_detection_helpers_match_jax():
    faces = [[(np.array([1, 2, 10, 12]), np.ones((5, 2)) * 5, 0.9),
              (np.array([12, 2, 10, 12]), np.ones((5, 2)) * 5, 0.8)],
             [], [(np.array([1, 2, 19, 19]), np.full((5, 2), 19.5), 0.7)]]
    assert vio.sample_chunks(list(range(10)), 4, 3) == jax_vio.sample_chunks(
        list(range(10)), 4, 3)
    assert vio.sample_chunks(list(range(9)), 3) == jax_vio.sample_chunks(list(range(9)), 3)
    for res in (faces, faces[:1], [[], []]):
        assert vio.weak_check(res) == jax_vio.weak_check(res)
    for w, h, scale in ((20, 20, 1.0), (15, 15, 2.0), (40, 40, 2.0), (19, 19, 1.0)):
        got = vio.get_valid_faces(faces, w=w, h=h, scale=scale)
        want = jax_vio.get_valid_faces(faces, w=w, h=h, scale=scale)
        assert [len(f) for f in got] == [len(f) for f in want]
        for g, wnt in zip(got, want):
            for (b, lm, s), (b2, lm2, s2) in zip(g, wnt):
                np.testing.assert_array_equal(b, b2)
                np.testing.assert_array_equal(lm, lm2)
                assert s == s2


@pytest.mark.parametrize("hw,max_res", [((2400, 3840), 1920), ((97, 131), 1920),
                                        ((301, 403), 200)], ids=["4k", "small", "capped_odd"])
def test_scale_detect_matches_jax(hw, max_res):
    """The frames the detector sees (cv2.resize INTER_LINEAR, bit-equal)
    and the rescaled rows."""
    seen = {}

    def detector(tag):
        def det(frames_small):
            seen.setdefault(tag, []).extend(frames_small)
            h, w = frames_small[0].shape[:2]
            return [[(np.array([1.0, 1.0, w / 2, h / 2]), np.ones((5, 2)) * 2, 0.9),
                     (np.array([0.0, 0.0, w + 1.0, h]), np.ones((5, 2)), 0.5)]
                    for _ in frames_small]
        return det

    images = [np.random.RandomState(i).randint(0, 256, hw + (3,)).astype(np.uint8)
              for i in range(2)]
    got = vio.scale_detect(detector("port"), images, max_res)
    want = jax_vio.scale_detect(detector("jax"), images, max_res)
    _same_frames(seen["port"], seen["jax"])
    assert [len(f) for f in got] == [len(f) for f in want] == [1, 1]
    np.testing.assert_array_equal(got[0][0][0], want[0][0][0])
