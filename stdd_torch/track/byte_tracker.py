"""ByteTrack multi-face tracker — host-plane state machine.

Fresh implementation of the two-stage ByteTrack association used by the
reference (``preprocessing/ByteTrack/byte_tracker.py:181`` BYTETracker,
``:49`` STrack, state machine in ``basetrack.py:10``), with the same
semantics:

- stage 1: confirmed+lost tracks vs high-score detections
  (IoU cost, confidence-fused, Hungarian with ``match_thresh``)
- stage 2: still-tracked leftovers vs low-score detections (0.1 < s < thr),
  plain IoU at 0.5
- unconfirmed (single-frame) tracks matched at 0.7 against leftover
  high-score detections, else removed
- new tracks started from unmatched detections with
  ``score > track_thresh + 0.1``; tracks born on frame 1 activate instantly
- lost tracks expire after ``track_buffer`` frames; duplicate tracked/lost
  pairs (IoU > 0.85) resolved by age

Unlike the reference, the track-id counter is **per tracker instance**
(the reference's class-global ``BaseTrack._count`` must be reset manually per
video — TEST2.py:309-313 — a shared-mutable hazard noted in SURVEY §5).
All Kalman math is the batched module :mod:`stdd_torch.track.kalman`.
"""

from __future__ import annotations

from enum import IntEnum
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import kalman
from .matching import fuse_score, iou_cost, linear_assignment


class TrackState(IntEnum):
    New = 0
    Tracked = 1
    Lost = 2
    Removed = 3


class Track:
    """One tracked face. Boxes are tlwh internally; ``tlbr`` for matching."""

    __slots__ = (
        "track_id", "state", "is_activated", "score", "mean", "cov",
        "_tlwh", "frame_id", "start_frame", "tracklet_len",
    )

    def __init__(self, tlwh: np.ndarray, score: float):
        self._tlwh = np.asarray(tlwh, dtype=float)
        self.score = float(score)
        self.track_id = 0
        self.state = TrackState.New
        self.is_activated = False
        self.mean: Optional[np.ndarray] = None
        self.cov: Optional[np.ndarray] = None
        self.frame_id = 0
        self.start_frame = 0
        self.tracklet_len = 0

    # -- geometry -------------------------------------------------------

    @property
    def tlwh(self) -> np.ndarray:
        if self.mean is None:
            return self._tlwh.copy()
        return kalman.xyah_to_tlwh(self.mean[:4])

    @property
    def tlbr(self) -> np.ndarray:
        t = self.tlwh
        return np.concatenate([t[:2], t[:2] + t[2:]])

    @property
    def end_frame(self) -> int:
        return self.frame_id

    # -- lifecycle ------------------------------------------------------

    def start(self, track_id: int, frame_id: int) -> None:
        self.track_id = track_id
        self.mean, self.cov = kalman.initiate(kalman.tlwh_to_xyah(self._tlwh))
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = frame_id == 1
        self.frame_id = frame_id
        self.start_frame = frame_id

    def reactivate(self, det: "Track", frame_id: int) -> None:
        self.mean, self.cov = _update_one(self.mean, self.cov, det.tlwh)
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = True
        self.frame_id = frame_id
        self.score = det.score

    def observe(self, det: "Track", frame_id: int) -> None:
        self.frame_id = frame_id
        self.tracklet_len += 1
        self.mean, self.cov = _update_one(self.mean, self.cov, det.tlwh)
        self.state = TrackState.Tracked
        self.is_activated = True
        self.score = det.score

    def __repr__(self):
        return f"Track({self.track_id}, {self.state.name}, {self.start_frame}-{self.frame_id})"


def _update_one(mean, cov, tlwh):
    m, c = kalman.update(
        mean[None], cov[None], kalman.tlwh_to_xyah(tlwh)[None]
    )
    return m[0], c[0]


def _predict_pool(tracks: List[Track]) -> None:
    if not tracks:
        return
    means = np.stack([t.mean for t in tracks])
    covs = np.stack([t.cov for t in tracks])
    # non-tracked states freeze their height velocity (byte_tracker.py:72-75)
    for i, t in enumerate(tracks):
        if t.state != TrackState.Tracked:
            means[i][7] = 0
    means, covs = kalman.predict(means, covs)
    for t, m, c in zip(tracks, means, covs):
        t.mean, t.cov = m, c


def _merge(a: List[Track], b: List[Track]) -> List[Track]:
    seen = {t.track_id for t in a}
    return a + [t for t in b if t.track_id not in seen]


def _subtract(a: List[Track], b: List[Track]) -> List[Track]:
    drop = {t.track_id for t in b}
    return [t for t in a if t.track_id not in drop]


def _dedup(tracked: List[Track], lost: List[Track]) -> Tuple[List[Track], List[Track]]:
    if not tracked or not lost:
        return tracked, lost
    cost = iou_cost([t.tlbr for t in tracked], [t.tlbr for t in lost])
    pairs = np.where(cost < 0.15)
    dup_a, dup_b = set(), set()
    for p, q in zip(*pairs):
        age_p = tracked[p].frame_id - tracked[p].start_frame
        age_q = lost[q].frame_id - lost[q].start_frame
        if age_p > age_q:
            dup_b.add(q)
        else:
            dup_a.add(p)
    return (
        [t for i, t in enumerate(tracked) if i not in dup_a],
        [t for i, t in enumerate(lost) if i not in dup_b],
    )


class ByteTracker:
    """Two-stage IoU tracker over per-frame detections.

    ``update(dets)`` takes ``[N, 5]`` rows ``(x1, y1, x2, y2, score)`` in
    frame coordinates and returns the list of live, confirmed tracks.
    """

    def __init__(
        self,
        track_thresh: float = 0.6,
        match_thresh: float = 0.6,
        track_buffer: int = 30,
        frame_rate: float = 30.0,
        mot20: bool = False,
        split_low_scores: bool = True,
    ):
        self.track_thresh = track_thresh
        self.match_thresh = match_thresh
        self.det_thresh = track_thresh + 0.1
        self.max_time_lost = int(frame_rate / 30.0 * track_buffer)
        self.mot20 = mot20
        # The reference's production call sites (TEST2.py:538, af_realtime.py:388,
        # preprocessing_parallel.py:265) pass pre-built STrack lists, which its
        # update() routes past the high/low score split — the ByteTrack second
        # stage is effectively OFF in the reference pipeline. split_low_scores
        # False reproduces that; True is proper ByteTrack.
        self.split_low_scores = split_low_scores
        self.frame_id = 0
        self._next_id = 0
        self.tracked: List[Track] = []
        self.lost: List[Track] = []
        self.removed: List[Track] = []          # last frame's removals
        # cumulative removed track_ids: reproduces the reference's
        # sub_stracks(lost, removed_stracks) over its ever-growing object
        # list (byte_tracker.py:362) — including the quirk that a removed-
        # then-refound track is dropped from lost the moment it is lost
        # again — while retaining only ints, not Track objects
        self._removed_ids: set = set()

    def _new_id(self) -> int:
        self._next_id += 1
        return self._next_id

    def _empty_frame(self) -> List[Track]:
        """Zero-detection frame: every tracked track goes lost, no KF predict
        (mirrors byte_tracker.py:194 _no_detections_update)."""
        removed: List[Track] = []
        for t in self.tracked:
            if t.state == TrackState.Tracked:
                t.state = TrackState.Lost
                self.lost.append(t)
        for t in self.lost:
            if self.frame_id - t.end_frame > self.max_time_lost:
                t.state = TrackState.Removed
                removed.append(t)
        self.tracked = [t for t in self.tracked if t.state == TrackState.Tracked]
        self.lost = _subtract(self.lost, removed)
        self.removed = removed
        self._removed_ids.update(t.track_id for t in removed)
        self.tracked, self.lost = _dedup(self.tracked, self.lost)
        return []

    def update(self, dets: np.ndarray) -> List[Track]:
        self.frame_id += 1
        dets = np.asarray(dets, dtype=float).reshape(-1, 5)
        if dets.shape[0] == 0:
            return self._empty_frame()

        scores = dets[:, 4]
        if self.split_low_scores:
            hi = scores > self.track_thresh
            lo = (scores > 0.1) & (scores < self.track_thresh)
        else:
            hi = np.ones_like(scores, dtype=bool)
            lo = np.zeros_like(scores, dtype=bool)
        # tlbr → tlwh inline (w = x2-x1, h = y2-y1)
        det_hi = [Track(d[:4] - [0, 0, d[0], d[1]], d[4]) for d in dets[hi]]
        det_lo = [Track(d[:4] - [0, 0, d[0], d[1]], d[4]) for d in dets[lo]]

        activated: List[Track] = []
        refound: List[Track] = []
        newly_lost: List[Track] = []
        removed: List[Track] = []

        unconfirmed = [t for t in self.tracked if not t.is_activated]
        confirmed = [t for t in self.tracked if t.is_activated]

        # stage 1: confirmed + lost vs high-score dets
        pool = _merge(confirmed, self.lost)
        _predict_pool(pool)
        cost = iou_cost([t.tlbr for t in pool], [d.tlbr for d in det_hi])
        if not self.mot20:
            cost = fuse_score(cost, np.asarray([d.score for d in det_hi]))
        matches, u_pool, u_det = linear_assignment(cost, self.match_thresh)
        for ti, di in matches:
            t, d = pool[ti], det_hi[di]
            if t.state == TrackState.Tracked:
                t.observe(d, self.frame_id)
                activated.append(t)
            else:
                t.reactivate(d, self.frame_id)
                refound.append(t)

        # stage 2: leftover tracked vs low-score dets
        remain = [pool[i] for i in u_pool if pool[i].state == TrackState.Tracked]
        cost = iou_cost([t.tlbr for t in remain], [d.tlbr for d in det_lo])
        matches, u_remain, _ = linear_assignment(cost, 0.5)
        for ti, di in matches:
            t, d = remain[ti], det_lo[di]
            if t.state == TrackState.Tracked:
                t.observe(d, self.frame_id)
                activated.append(t)
            else:
                t.reactivate(d, self.frame_id)
                refound.append(t)
        for i in u_remain:
            t = remain[i]
            if t.state != TrackState.Lost:
                t.state = TrackState.Lost
                newly_lost.append(t)

        # unconfirmed tracks vs leftover high-score dets
        leftover = [det_hi[i] for i in u_det]
        cost = iou_cost([t.tlbr for t in unconfirmed], [d.tlbr for d in leftover])
        if not self.mot20:
            cost = fuse_score(cost, np.asarray([d.score for d in leftover]))
        matches, u_unconf, u_det2 = linear_assignment(cost, 0.7)
        for ti, di in matches:
            unconfirmed[ti].observe(leftover[di], self.frame_id)
            activated.append(unconfirmed[ti])
        for i in u_unconf:
            t = unconfirmed[i]
            t.state = TrackState.Removed
            removed.append(t)

        # births
        for i in u_det2:
            d = leftover[i]
            if d.score < self.det_thresh:
                continue
            d.start(self._new_id(), self.frame_id)
            activated.append(d)

        # expire lost
        for t in self.lost:
            if self.frame_id - t.end_frame > self.max_time_lost:
                t.state = TrackState.Removed
                removed.append(t)

        self.tracked = [t for t in self.tracked if t.state == TrackState.Tracked]
        self.tracked = _merge(self.tracked, activated)
        self.tracked = _merge(self.tracked, refound)
        self.lost = _subtract(self.lost, self.tracked)
        self.lost.extend(newly_lost)
        self.lost = [t for t in self.lost if t.track_id not in self._removed_ids]
        self.removed = removed
        self._removed_ids.update(t.track_id for t in removed)
        self.tracked, self.lost = _dedup(self.tracked, self.lost)
        return [t for t in self.tracked if t.is_activated]
