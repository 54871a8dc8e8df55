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
