"""IoU-greedy legacy tracking (the reference demo.py path).

Port of ``test_tools/ct/operations.py``: ``simple_tracking`` (:13) follows one
seed face by best-IoU frame to frame, ``multiple_tracking`` (:38) seeds every
face of frame 0, ``find_longest`` (:47) segments a video into maximal ranges
where the number of co-trackable faces stays constant. Faces are
``(box[4], lm5, [lm68,] score)`` tuples with score last — only box (index 0)
and score (index −1) are used here.

The code of the JAX package's ``stdd_tpu/track/greedy.py``: it is pure
Python.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def _iou(b1, b2) -> float:
    x1 = max(b1[0], b2[0])
    y1 = max(b1[1], b2[1])
    x2 = min(b1[2], b2[2])
    y2 = min(b1[3], b2[3])
    iw = max(x2 - x1, 0.0)
    ih = max(y2 - y1, 0.0)
    inter = iw * ih
    a1 = (b1[2] - b1[0]) * (b1[3] - b1[1])
    a2 = (b2[2] - b2[0]) * (b2[3] - b2[1])
    union = a1 + a2 - inter
    return inter / union if union > 0 else 0.0


def face_iou(f1, f2) -> float:
    return _iou(f1[0], f2[0])


def simple_tracking(detections: Sequence[Sequence], index: int = 0, thres: float = 0.5):
    """Follow the ``index``-th face of frame 0 through all frames; None if the
    chain breaks (operations.py:13)."""
    track = []
    for i, faces in enumerate(detections):
        if i == 0:
            if len(faces) <= index or faces[index][-1] < 0.8:
                return None
            # reject seeds overlapping an earlier seed
            for idx in range(index):
                if face_iou(faces[idx], faces[index]) > thres:
                    return None
            track.append(faces[index])
        else:
            if len(faces) == 0:
                return None
            last = track[i - 1]
            best = max(faces, key=lambda f: face_iou(f, last))
            if face_iou(best, last) < thres:
                return None
            track.append(best)
    return track


def multiple_tracking(detections: Sequence[Sequence]) -> List[List]:
    tracks = []
    if not detections or not detections[0]:
        return tracks
    for i in range(len(detections[0])):
        t = simple_tracking(detections, index=i)
        if t is not None:
            tracks.append(t)
    return tracks


def find_longest(detections: Sequence[Sequence]):
    """Segment into maximal co-trackable ranges (operations.py:47). Returns
    (list of (start, end) with end exclusive, list of first-track per range)."""
    fc = len(detections)
    tuples: List[Tuple[int, int]] = []
    all_tracks: List[List] = []
    start = 0
    end = 0
    previous_count = -1
    while start < fc - 1:
        for end in range(start + 2, fc + 1):
            tracks = multiple_tracking(detections[start:end])
            if (len(tracks) != previous_count and previous_count != -1) or len(tracks) == 0:
                break
            previous_count = len(tracks)
        if end - start > 2:
            un_reach_end = end - 1 if end != fc else end
            sub = multiple_tracking(detections[start:un_reach_end])
            if end == fc and len(sub) == 0:
                un_reach_end = end - 1
                sub = multiple_tracking(detections[start:un_reach_end])
            if len(sub) > 0:
                tuples.append((start, un_reach_end))
                all_tracks.append(sub[0])
            else:
                raise NotImplementedError("untrackable segment")
            previous_count = -1
            end = un_reach_end
        start = end
    return tuples, all_tracks
