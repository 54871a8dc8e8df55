"""The port's IoU-greedy tracker (``stdd_torch/track/greedy.py``) against the
JAX package's on random detection sequences: faces that enter, leave,
cross, drop out for a frame and score below the 0.8 seed bar. The same face
tuples go to both, so the tracks must hold the same objects in the same
order (exact)."""

import numpy as np
import pytest

from stdd_tpu.track import greedy as jax_greedy
from stdd_torch.track import greedy

SEEDS = range(12)


def random_detections(seed: int):
    """Per frame, a list of ``(box, lm5, score)`` faces: 1-4 faces, each on
    a straight path that may cross another's, present from a random first
    frame to a random last one, sometimes missing for a frame."""
    rng = np.random.RandomState(seed)
    n_frames = int(rng.randint(6, 30))
    faces = []
    for _ in range(int(rng.randint(1, 5))):
        start = int(rng.randint(0, 3)) if rng.rand() < 0.8 else int(rng.randint(0, n_frames))
        end = n_frames if rng.rand() < 0.6 else int(rng.randint(start + 1, n_frames + 1))
        p0 = rng.uniform(0, 300, 2)
        vel = rng.uniform(-12, 12, 2)
        size = rng.uniform(40, 90)
        faces.append((start, end, p0, vel, size, rng.uniform(0.6, 1.0)))
    dets = []
    for f in range(n_frames):
        frame = []
        for start, end, p0, vel, size, score in faces:
            if not start <= f < end or rng.rand() < 0.05:
                continue
            xy = p0 + vel * f + rng.normal(0, 1.0, 2)
            box = np.array([xy[0], xy[1], xy[0] + size, xy[1] + size * 1.1])
            lm5 = np.tile(box[:2], (5, 1)) + 10
            frame.append((box, lm5, float(score)))
        rng.shuffle(frame)
        dets.append(frame)
    return dets


def ids(tracks):
    return None if tracks is None else [id(f) for f in tracks]


@pytest.mark.parametrize("seed", SEEDS)
def test_tracking_matches_jax(seed):
    dets = random_detections(seed)
    for index in range(len(dets[0]) + 1):
        for thres in (0.3, 0.5):
            assert ids(greedy.simple_tracking(dets, index, thres)) == \
                ids(jax_greedy.simple_tracking(dets, index, thres))
    got, want = greedy.multiple_tracking(dets), jax_greedy.multiple_tracking(dets)
    assert [ids(t) for t in got] == [ids(t) for t in want]
    try:
        want = jax_greedy.find_longest(dets)
    except NotImplementedError:
        with pytest.raises(NotImplementedError):
            greedy.find_longest(dets)
        return
    tuples, tracks = greedy.find_longest(dets)
    assert tuples == want[0]
    assert [ids(t) for t in tracks] == [ids(t) for t in want[1]]


def test_random_sequences_reach_every_branch():
    """The seeds above exercise what they claim: some sequences track
    whole, some only in segments, some break a seed's chain."""
    whole = segmented = broken = 0
    for seed in SEEDS:
        dets = random_detections(seed)
        tracks = greedy.multiple_tracking(dets)
        whole += bool(tracks)
        broken += len(dets[0]) > len(tracks)
        try:
            segmented += len(greedy.find_longest(dets)[0]) > 1
        except NotImplementedError:
            pass
    assert whole and segmented and broken


def test_face_iou():
    a = (np.array([0.0, 0.0, 10.0, 10.0]), None, 0.9)
    b = (np.array([5.0, 0.0, 15.0, 10.0]), None, 0.9)
    assert greedy.face_iou(a, b) == jax_greedy.face_iou(a, b) == pytest.approx(1 / 3)
    assert greedy._iou([0, 0, 0, 0], [0, 0, 0, 0]) == 0.0
