"""Streaming detection engine: the live-call scoring loop.

Port of ``stdd_tpu/runtime/engine.py`` (the reference's ``RealtimeAF.step``,
test/af_realtime.py:196, and ``VideoRunner.run``, TEST2.py:259):

host plane (per frame, numpy):   detect-cadence → ByteTrack → landmark cache
                                 → crop-box/quality gating → per-track ring
                                 buffers → stride-gated clip windows
device plane (per batch, CUDA):  batched align (K1) + normalize + I3D + sigmoid
                                 (:class:`~stdd_torch.runtime.classifier.ClipScorer`)

The device-side pipeline (pending pool, dispatch lanes, FIFO harvest, ring
kernels) lives in :class:`~stdd_torch.runtime.dispatch.DispatchGroup`, which
several engines may share (``share_dispatch_from``, the multi-call server);
this module keeps the PER-STREAM state machine: tracking, landmark caching,
quality gating, per-track rings/buffers, and verdict accumulation.

Each stage of :meth:`StreamingEngine.step` runs inside its span
(``stdd.engine.step`` around ``stdd.engine.detect``, ``.track``,
``.crop_gate``, ``stdd.ring.pack``/``.upload``, ``stdd.engine.emit`` and
``stdd.dispatch.tick``; ``utils/spans.py``) and counts into
``ENGINE_COUNTERS`` (``stats()``).

Clips are padded to ``[capacity, clip_size, crop_buffer, crop_buffer, 3]``
with power-of-two capacities; oversized crops are rescaled host-side by a
uniform factor (a similarity fit absorbs a uniform scale exactly, so
alignment semantics are unchanged). Nothing here needs cv2: the BGR→RGB
crop is a numpy channel flip.

Landmarks: the reference runs MediaPipe FaceMesh per track
(af_realtime.py:175). MediaPipe is host-C++ and unavailable here; the YuNet
detector already emits the same 5 landmark points per detection
(yunet.py:87 — eyes, nose, mouth corners), so the engine caches det-frame
lm5 as box-relative offsets and translates them with the track between
detections — the same caching cadence the reference uses for its mesh
(mesh_every, TEST2.py:577-588). The detector is any ``frame -> [N,15]``
callable of YuNet rows: ``models/yunet.py`` through ``detect_scaled``, or
the scene oracle of ``eval/scene.py``.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from ..config import PipelineConfig
from ..ops.quality import crop_quality
from ..track.byte_tracker import ByteTracker
from ..utils.spans import span
from .classifier import ClipScorer
from .dispatch import DispatchGroup, _PendingClip
from .scoring import HysteresisState, VideoVerdict, aggregate_video


# the engine's counters (``StreamingEngine.stats()``), all per call stream:
ENGINE_COUNTERS = (
    "frames",                 # frames stepped
    "detect_frames",          # of them, frames the detector ran on
    "faces_tracked",          # live tracks summed over frames
    "dropped_no_landmarks",   # a tracked face's frame dropped: no landmarks cached yet
    "dropped_quality",        # … dropped by the quality gate (or a degenerate crop box)
    "windows_full",           # full windows enqueued
    "windows_early",          # provisional (early) windows enqueued
    "windows_host_packed",    # of them, windows that carry pixels (no device ring)
    "ring_failures",          # a ring push or window gather raised; the track restarts
    "ring_evictions",         # rings dropped for a new track over ``max_rings``
)


def get_crop_box(shape_hw: Tuple[int, int], box: np.ndarray, scale: float = 0.5) -> np.ndarray:
    """Scale-expand a tlbr box and clip to the frame
    (reference test_tools/utils.py:13)."""
    height, width = shape_hw
    box = np.rint(np.asarray(box)).astype(int).reshape(2, 2)
    size = box[1] - box[0]
    diff = scale * size
    diff = diff[None, :] * np.array([-1, 1])[:, None]
    new_box = box + diff
    new_box[:, 0] = np.clip(new_box[:, 0], 0, width - 1)
    new_box[:, 1] = np.clip(new_box[:, 1], 0, height - 1)
    return np.rint(new_box).astype(int).reshape(-1)


@dataclass
class _FrameEntry:
    # NOTE: the soft quality weight wq is NOT stored — it gates frame
    # admission only (wq <= 0 drops the frame). The reference buffers a
    # per-frame weight list alongside (TEST2.py:313 cur_w) but never
    # consumes it in scoring either; we reproduce the behavior, not the
    # dead state.
    crop: np.ndarray          # RGB uint8 big-box crop (native resolution)
    big_box: np.ndarray       # absolute (x1, y1, x2, y2) int
    lm5: np.ndarray           # crop-local [5, 2] float32
    frame_idx: int = -1       # the engine's index of the frame (0 = first stepped)


class AsyncDetector:
    """Double-buffered detection wrapper: hides the device round-trip by
    dispatching this frame's detection on a worker thread and returning the
    PREVIOUS detect-cycle's result (one detect_every interval of box lag,
    which the Kalman tracker absorbs — boxes are already held constant
    between detect frames, TEST2.py:331).

    Wrap any ``frame -> [N,15] rows`` callable; the first call blocks for a
    seed result so the stream never starts blind."""

    def __init__(self, detect_fn):
        import concurrent.futures

        self.detect_fn = detect_fn
        self._exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="detect"
        )
        self._fut = None

    def __call__(self, frame_bgr):
        prev = self._fut.result() if self._fut is not None else None
        self._fut = self._exec.submit(self.detect_fn, frame_bgr)
        if prev is None:           # first call: block for a seed result
            prev = self._fut.result()
        return prev

    def close(self):
        self._exec.shutdown(wait=False)


class StreamingEngine:
    """Feed frames with :meth:`step`; clip scores stream back as
    ``(track_id, prob)`` tuples. :meth:`finish` flushes and aggregates."""

    def __init__(
        self,
        scorer: ClipScorer,
        detect_fn: Callable[[np.ndarray], np.ndarray],
        cfg: Optional[PipelineConfig] = None,
        crop_buffer: int = 256,
        start_conf: float = 0.6,
        drop_after: int = 60,
        q_min_size_hard: float = 32,
        q_min_size_soft: float = 64,
        q_lap_hard: float = 10.0,
        q_lap_soft: float = 60.0,
        q_weighting: bool = True,
        track_kwargs: Optional[dict] = None,
        max_batch_wait_frames="stride",
        min_det_area: float = 0.0,
        exclude_bottom_frac: float = 0.0,
        share_dispatch_from: Optional["StreamingEngine"] = None,
        device_resident: Optional[bool] = None,
        max_rings: int = 32,
        stagger_windows: bool = False,
        early_window_frac: float = 0.0,
    ):
        # stagger_windows: de-synchronize steady-state window emissions
        # across co-tracked faces — without it every face that appeared in
        # the same frame dispatches its window on the SAME stride tick, so
        # an n-face call pays an n-deep scoring queue each tick (the p50
        # window latency scales with n). Each track's post-first-window
        # phase is offset by a low-discrepancy (golden-ratio) fraction of
        # the stride. Off by default: the offline TEST2-parity harness pins
        # reference-exact window positions.
        #
        # early_window_frac: sub-stride provisional first window — when a
        # NEW track's buffer first reaches ceil(clip_size * frac) frames,
        # a provisional window padded with the newest frame is dispatched
        # (the reference's own short-window padding, TEST2.py:358-363) so
        # the first verdict lands in ~frac·clip_size frames instead of a
        # full clip. The provisional score enters the track's score list
        # and hysteresis like any clip score (af_realtime.py:351 semantics
        # preserved: median of last 5). 0.0 disables (default).
        self.cfg = cfg or PipelineConfig()
        self.scorer = scorer
        self.detect_fn = detect_fn
        self.crop_buffer = crop_buffer
        # fail fast on misconfiguration: yuv420 (I420) packing needs an even
        # chroma plane, i.e. crop_buffer % 4 == 0 — otherwise the error would
        # only fire on the dispatch worker, dropping a batch at a later step
        from .packing import upload_format_of

        if upload_format_of(scorer) == "yuv420" and crop_buffer % 4:
            raise ValueError(
                f"upload_format='yuv420' requires crop_buffer divisible by 4 "
                f"(got {crop_buffer})"
            )
        # device-resident streaming: per-track crop rings on the card — each
        # frame uploads once on arrival and a stride-tick window dispatch
        # moves only geometry. On when the scorer runs on CUDA; the
        # host-packed path serves a CPU scorer and explicit opt-outs.
        if device_resident is None:
            device_resident = getattr(scorer, "device", None) is not None and \
                scorer.device.type == "cuda"
        self.device_resident = bool(device_resident)
        # fail fast: ring windows dispatch through scorer.score_windows —
        # a facade without it (e.g. FeatureCaptureScorer) would otherwise
        # die on the dispatch worker at the first emitted window
        if self.device_resident and not hasattr(scorer, "score_windows"):
            raise ValueError(
                "device_resident=True requires a scorer with score_windows() "
                f"(got {type(scorer).__name__}); pass device_resident=False "
                "for scorer facades that only implement score_async"
            )
        self.max_rings = max_rings
        self.stagger_windows = bool(stagger_windows)
        if not 0.0 <= early_window_frac < 1.0:
            raise ValueError(
                f"early_window_frac must be in [0, 1), got {early_window_frac}"
            )
        self.early_window_frames = (
            max(2, int(round(self.cfg.clip_size * early_window_frac)))
            if early_window_frac > 0.0 else 0
        )
        self.start_conf = start_conf
        self.drop_after = drop_after
        self.q = dict(
            min_size_hard=q_min_size_hard,
            min_size_soft=q_min_size_soft,
            lap_hard=q_lap_hard,
            lap_soft=q_lap_soft,
            weighting=q_weighting,
        )
        self._track_kwargs = track_kwargs or dict(
            track_thresh=0.6, match_thresh=0.6, track_buffer=2000,
            split_low_scores=False,  # reference-production behavior
        )
        # latency mode: dispatch a partially-filled batch after this many
        # frames rather than waiting for batch_clips windows (at the realtime
        # stride a full batch can take minutes to fill on a 1-face call).
        # Default "stride" = one stride's worth of steps, so even a bare
        # 1-face engine has bounded latency out of the box; pass None
        # explicitly for throughput mode (wait for a full batch). In
        # device-ring mode the default is 0 (ship partials immediately):
        # a window dispatch moves only kilobytes of geometry, so batching
        # buys nothing — and co-tracked faces emit their windows in the SAME
        # step, which still batches them before the end-of-step dispatch.
        if max_batch_wait_frames == "stride":
            max_batch_wait_frames = 0 if self.device_resident else self.cfg.stride
            self._explicit_wait = False
        else:
            self._explicit_wait = True
        # extra detection filters (TEST2.py:516-529)
        self.min_det_area = min_det_area
        self.exclude_bottom_frac = exclude_bottom_frac
        # cross-stream batching: engines serving concurrent calls can share
        # ONE dispatch group (pending pool + dispatch lanes + in-flight set)
        # so device batches fill across streams; each clip routes its result
        # back to the engine that produced it (see MultiStreamServer)
        if share_dispatch_from is None:
            self._group = DispatchGroup(
                scorer, self.cfg, crop_buffer, self.device_resident,
                max_batch_wait_frames, default_owner=self,
            )
            self._is_group_root = True
        else:
            root = share_dispatch_from
            if not getattr(root, "_is_group_root", False):
                raise ValueError("share_dispatch_from must be a group-root engine")
            if root.scorer is not self.scorer:
                raise ValueError("shared-dispatch engines must share one scorer")
            if (root.cfg.clip_size, root.crop_buffer) != (
                self.cfg.clip_size, self.crop_buffer
            ):
                raise ValueError(
                    "shared-dispatch engines must agree on clip_size and "
                    "crop_buffer (batches are packed with the root's shapes)"
                )
            if root.device_resident != self.device_resident:
                raise ValueError(
                    "device_resident is group-level; batches can't mix "
                    "ring windows with host-packed clips"
                )
            # batching cadence is a GROUP property: the root's value governs
            # (the "stride" default means "inherit from the root")
            if (
                self._explicit_wait
                and max_batch_wait_frames != root._group.max_batch_wait_frames
            ):
                raise ValueError(
                    "max_batch_wait_frames is group-level; set it on the "
                    f"root engine (root has {root._group.max_batch_wait_frames!r})"
                )
            self._group = root._group
            self._is_group_root = False
        # guards _ready against a peer thread's or a dispatch lane's harvest
        # racing _take_ready's swap
        self._ready_lock = threading.Lock()
        # plain integer counters over the engine's life (``stats()``); only
        # the stepping thread writes them
        self.counts: Dict[str, int] = dict.fromkeys(ENGINE_COUNTERS, 0)
        # the server's id of this engine's call (None outside a server)
        self.stream_id: Optional[int] = None
        self.reset()

    # group-level pipeline state lives on the DispatchGroup; engines delegate
    # reads so these names work on every stream of a shared group
    # (_worker_error is deliberately PER-engine: a failed batch's error is
    # routed to the streams that owned its clips, not to whoever harvests)
    _GROUP_ATTRS = frozenset(
        ("pending", "inflight", "clip_latencies", "max_batch_wait_frames",
         "_tick", "_next_seq", "_next_harvest_seq",
         "_lock", "_state_lock", "_harvest_lock", "_dispatch_q", "_workers")
    )

    def __getattr__(self, name):
        if name in StreamingEngine._GROUP_ATTRS:
            group = self.__dict__.get("_group")
            if group is not None:
                return getattr(group, name)
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}"
        )

    def reset(self) -> None:
        if self._is_group_root:
            # drain queued/in-flight work from the previous stream FIRST so
            # late arrivals can't leak scores into the new stream
            self._group.reset()
        else:
            # a secondary engine's reset: drop its queued-but-undispatched
            # clips, and bump its generation so its clips in flight are
            # discarded at harvest; peers are undisturbed either way
            self._group.drop_owner(self)
        self._gen = getattr(self, "_gen", 0) + 1
        # set when a batch holding this stream's clips fails; raised at step()
        self._worker_error: Optional[BaseException] = None
        self.tracker = ByteTracker(**self._track_kwargs)
        self.frame_idx = 0
        self.buffers: Dict[int, Deque[_FrameEntry]] = {}
        self.rings: Dict[int, Any] = {}       # tid → DeviceRing (ring mode)
        self.lm5_offsets: Dict[int, np.ndarray] = {}
        self.since_emit: Dict[int, int] = collections.defaultdict(lambda: 10 ** 9)
        self.last_seen: Dict[int, int] = {}
        self.track_clip_scores: Dict[int, List[float]] = collections.defaultdict(list)
        self.track_frames: Dict[int, int] = collections.defaultdict(int)
        self.hysteresis = HysteresisState(self.cfg.t_high, self.cfg.t_low)
        self.qstats: Dict[int, List[Tuple[float, float]]] = collections.defaultdict(list)
        self.id_switches = 0
        self._prev_boxes: Optional[np.ndarray] = None
        self._prev_ids: Optional[List[int]] = None
        self._ready: List[Tuple[int, float]] = []
        self._n_staggered = 0                 # tracks assigned a phase so far
        self._stagger_assigned: set = set()   # tids already phase-offset
        self._early_emitted: set = set()      # tids with a provisional window

    def stats(self) -> Dict[str, int]:
        """This engine's counters (``ENGINE_COUNTERS``) over its life, then
        its dispatch group's (``dispatch.GROUP_COUNTERS``; group-wide: every
        stream of a server shares them)."""
        return {**self.counts, **self._group.stats()}

    def warmup(self) -> None:
        """Run the scorer for every batch capacity this engine's dispatch
        group can ship, so no clip pays a first-call cost.
        Call once at serving startup."""
        self._group.warmup()

    def close(self) -> None:
        """Release background resources: per-track rings, the detector's
        worker (when it has a ``close``) and, if this engine owns its
        dispatch group, the group's lanes. Safe to call more than once; the
        engine must not be stepped after."""
        self.rings.clear()
        if hasattr(self.detect_fn, "close"):
            try:
                self.detect_fn.close()
            except Exception:
                pass
        if self._is_group_root:
            self._group.close()

    # -- per-frame host path -------------------------------------------------

    def step(self, frame_bgr: np.ndarray) -> List[Tuple[int, float]]:
        with span("stdd.engine.step"):
            return self._step(frame_bgr)

    def _step(self, frame_bgr: np.ndarray) -> List[Tuple[int, float]]:
        H, W = frame_bgr.shape[:2]
        fi = self.frame_idx
        need_det = fi % max(1, self.cfg.detect_every) == 0
        self.frame_idx += 1
        counts = self.counts
        counts["frames"] += 1

        dets = None
        if need_det:
            counts["detect_frames"] += 1
            with span("stdd.engine.detect"):
                dets = np.asarray(self.detect_fn(frame_bgr))  # [N, 15] YuNet rows
        with span("stdd.engine.track"):
            live, dets = self._track(dets, H)
        counts["faces_tracked"] += len(live)

        # ring eviction must never touch a face that is live in THIS frame
        # (evicting one live track to ring another would cascade every frame
        # in a crowd and no face would ever accumulate a full window)
        self._live_now = {tr.track_id for tr in live}

        for tr in live:
            tid = tr.track_id
            box = tr.tlbr
            self.last_seen[tid] = self.frame_idx
            self.track_frames[tid] += 1

            with span("stdd.engine.crop_gate"):
                got = self._crop_and_gate(tid, box, dets, frame_bgr, H, W)
            if got is None:
                continue
            crop, big_box, lm5_local = got
            buf = self.buffers.setdefault(
                tid, collections.deque(maxlen=self.cfg.clip_size)
            )
            ring = None
            if self.device_resident:
                ring = self.rings.get(tid)
                if ring is None:
                    # may return None when every ring slot belongs to a face
                    # live this frame (crowd > max_rings): this track then
                    # runs the host-packed path instead of thrash-evicting
                    ring = self._new_ring()
                    if ring is not None:
                        self.rings[tid] = ring
                        # windowing restarts aligned with the fresh ring so
                        # len(buf) >= clip_size implies ring.count >= clip_size
                        buf.clear()
            if ring is not None:
                # crop lands on the card now (async); entries keep only the
                # geometry so windows never re-upload pixels. A failed push
                # leaves the ring a frame short: drop it and restart this
                # track's windowing clean (the next frame builds a new ring)
                # instead of ending the whole stream
                try:
                    ring.push(crop, big_box, lm5_local)
                except RuntimeError:
                    self._ring_failed(tid, buf)
                    continue
                buf.append(_FrameEntry(None, big_box, lm5_local, fi))
            else:
                buf.append(_FrameEntry(crop, big_box, lm5_local, fi))
            self.since_emit[tid] += 1

            full = len(buf) >= self.cfg.clip_size
            if full and self.since_emit[tid] >= self.cfg.stride:
                with span("stdd.engine.emit"):
                    emitted = self._emit(tid, buf, early=False)
                if not emitted:
                    continue
                self.since_emit[tid] = 0
                if self.stagger_windows and tid not in self._stagger_assigned:
                    # offset this track's subsequent stride ticks by a
                    # golden-ratio fraction of the stride: co-appearing faces
                    # spread across the stride interval instead of all
                    # dispatching on the same tick (first window timing is
                    # untouched — only the steady-state phase shifts, once)
                    self._stagger_assigned.add(tid)
                    k = self._n_staggered
                    self._n_staggered += 1
                    phase = int(self.cfg.stride * ((k * 0.61803398875) % 1.0))
                    self.since_emit[tid] = -phase
            elif (
                not full
                and self.early_window_frames
                and tid not in self._early_emitted
                and len(buf) >= self.early_window_frames
            ):
                # sub-stride provisional first window (padded with the newest
                # frame, TEST2.py:358-363 semantics) — the first verdict for
                # a newly-confirmed track lands in ~early_window_frames
                # frames instead of a full clip_size. since_emit is NOT
                # reset: the first full window keeps its regular schedule.
                self._early_emitted.add(tid)
                with span("stdd.engine.emit"):
                    self._emit(tid, buf, early=True)

        self._gc_tracks()

        with span("stdd.dispatch.tick"):
            group = self._group
            group.tick_and_dispatch()
            group.harvest(block=False)
            self._raise_worker_error()
            return self._take_ready()

    def _track(self, dets: Optional[np.ndarray], H: int):
        """Filter a detect frame's rows, update the tracker (or read its live
        tracks between detections) and count id switches → (live tracks,
        the kept rows or None)."""
        if dets is not None and dets.size:
            keep = (dets[:, 14] >= self.start_conf) & (
                np.maximum(dets[:, 2], dets[:, 3]) >= self.cfg.min_face_side
            )
            if self.min_det_area > 0:
                keep &= dets[:, 2] * dets[:, 3] >= self.min_det_area
            if self.exclude_bottom_frac > 0:
                cy = dets[:, 1] + 0.5 * dets[:, 3]
                keep &= cy < H * (1.0 - self.exclude_bottom_frac)
            dets = dets[keep]

        if dets is not None:
            tlbr = (
                np.stack(
                    [dets[:, 0], dets[:, 1], dets[:, 0] + dets[:, 2],
                     dets[:, 1] + dets[:, 3], dets[:, 14]], axis=1,
                )
                if dets.size
                else np.empty((0, 5))
            )
            live = self.tracker.update(tlbr)
        else:
            live = [t for t in self.tracker.tracked if t.is_activated]

        # id-switch accounting (TEST2.py:542-556): an id change on a
        # high-IoU box pair between consecutive frames counts as a switch
        cur_boxes = [t.tlbr.astype(np.float32) for t in live]
        cur_ids = [t.track_id for t in live]
        if cur_boxes:
            cb = np.stack(cur_boxes)
            if self._prev_boxes is not None:
                from ..track.matching import bbox_ious_plus1

                ious = bbox_ious_plus1(self._prev_boxes, cb)
                for i_prev in range(len(self._prev_boxes)):
                    j = int(np.argmax(ious[i_prev]))
                    if ious[i_prev, j] >= 0.5 and self._prev_ids[i_prev] != cur_ids[j]:
                        self.id_switches += 1
            self._prev_boxes, self._prev_ids = cb, cur_ids
        else:
            # consecutive-frame metric: an empty frame breaks the chain, so
            # a later face at a similar position is not a "switch"
            self._prev_boxes = self._prev_ids = None
        return live, dets

    def _crop_and_gate(self, tid: int, box: np.ndarray, dets: Optional[np.ndarray],
                       frame_bgr: np.ndarray, H: int, W: int):
        """One tracked face's landmarks, crop box, RGB crop and quality gate
        → (crop, big_box, crop-local lm5), or None when the frame is dropped
        (no landmarks yet, a degenerate box, or the gate)."""
        lm5 = self._landmarks_for(tid, box, dets)
        if lm5 is None:
            self.counts["dropped_no_landmarks"] += 1
            return None

        big_box = get_crop_box((H, W), box, self.cfg.crop_scale)
        x1, y1, x2, y2 = big_box
        if x2 <= x1 + 1 or y2 <= y1 + 1:
            self.counts["dropped_quality"] += 1
            return None
        # crop + BGR→RGB as one contiguous copy of the flipped view
        crop = np.ascontiguousarray(frame_bgr[y1:y2, x1:x2, ::-1])
        # the Laplacian blur metric only matters for soft weighting, the
        # hard blur gate, or the QA stats (first 50 samples per track);
        # once none apply, the exact same gating needs only min_side
        if (
            self.q["weighting"]
            or self.q["lap_hard"] > 0
            or len(self.qstats[tid]) < 50
        ):
            wq, q_side, q_lap = crop_quality(crop, **self.q)
            if len(self.qstats[tid]) < 50:
                self.qstats[tid].append((q_side, q_lap))
        else:
            wq = 0.0 if min(crop.shape[:2]) < self.q["min_size_hard"] else 1.0
        if wq <= 0.0:
            self.counts["dropped_quality"] += 1
            return None
        return crop, big_box, (lm5 - np.array([x1, y1], np.float32)).astype(np.float32)

    def _emit(self, tid: int, buf, early: bool) -> bool:
        """Gather the track's window (full, or the provisional padded one)
        and enqueue it; False when the ring failed and the track restarts."""
        # a track without a ring (crowd overflow) carries pixels in its
        # buffer entries and ships through the host-packed path
        emit_ring = self.rings.get(tid) if self.device_resident else None
        window = None
        if emit_ring is not None:
            try:
                window = (emit_ring.window_padded(self.cfg.clip_size) if early
                          else emit_ring.window(self.cfg.clip_size))
            except RuntimeError:
                # a push or the gather failed: self-heal as a failed push does
                self._ring_failed(tid, buf)
                return False
        else:
            self.counts["windows_host_packed"] += 1
        self.counts["windows_early" if early else "windows_full"] += 1
        self._group.enqueue(
            _PendingClip(tid, list(buf), owner=self, owner_gen=self._gen,
                         t_enq=time.perf_counter(), window=window, early=early)
        )
        return True

    def _ring_failed(self, tid: int, buf) -> None:
        self.counts["ring_failures"] += 1
        self._drop_ring(tid)
        buf.clear()

    def _take_ready(self) -> List[Tuple[int, float]]:
        with self._ready_lock:
            out, self._ready = self._ready, []
        return out

    def flush(self) -> List[Tuple[int, float]]:
        """Score everything queued and drain in-flight work (end of stream
        or low-latency mode). In a shared dispatch group this drains the
        GROUP's queue up to the point of the call; peers' results are routed
        to them, only this stream's scores are returned."""
        group = self._group
        target = group.drain_snapshot()
        group.harvest_until(target)
        self._raise_worker_error()
        return self._take_ready()

    def finish(self, threshold: Optional[float] = None, **agg_kwargs) -> VideoVerdict:
        """Flush and produce the end-of-video verdict (TEST2 semantics,
        including the QA low-quality override)."""
        self.flush()
        qa_sides = [s for v in self.qstats.values() for s, _ in v]
        qa_laps = [l for v in self.qstats.values() for _, l in v]
        qa_min_side = agg_kwargs.pop("qa_min_side", 48)
        qa_min_lap = agg_kwargs.pop("qa_min_lap", 20.0)
        low_q = False
        if qa_sides:
            low_q = (float(np.median(qa_sides)) < qa_min_side) or (
                float(np.median(qa_laps)) < qa_min_lap
            )
        return aggregate_video(
            dict(self.track_clip_scores),
            threshold=threshold if threshold is not None else self.cfg.threshold,
            pool_method=self.cfg.pool_method,
            low_quality=low_q,
            **agg_kwargs,
        )

    # -- internals ------------------------------------------------------------

    def _raise_worker_error(self) -> None:
        if self._worker_error is not None:
            exc, self._worker_error = self._worker_error, None
            raise RuntimeError(
                "scoring worker failed; the batch was dropped"
            ) from exc

    def _landmarks_for(
        self, tid: int, box: np.ndarray, dets: Optional[np.ndarray]
    ) -> Optional[np.ndarray]:
        """Absolute lm5 for a track: refresh offsets on detection frames by
        IoU-matching the track box to a detection; otherwise translate cached
        offsets with the box (the reference's mesh_every caching)."""
        if dets is not None and dets.size:
            det_tlbr = np.stack(
                [dets[:, 0], dets[:, 1], dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]],
                axis=1,
            )
            ious = _iou_one_to_many(box, det_tlbr)
            j = int(np.argmax(ious))
            if ious[j] > 0.3:
                lm5 = dets[j, 4:14].reshape(5, 2).astype(np.float32)
                self.lm5_offsets[tid] = lm5 - box[:2][None, :].astype(np.float32)
        off = self.lm5_offsets.get(tid)
        if off is None:
            return None
        return off + box[:2][None, :].astype(np.float32)

    def _new_ring(self):
        """Create a DeviceRing on the group's kernels + uploader,
        evicting the least-recently-seen ring when over the device-memory
        budget (max_rings × ~3-6 MB per ring)."""
        from .ring import DeviceRing

        group = self._group
        if len(self.rings) >= self.max_rings:
            # evict the least-recently-seen ring — but never one whose face
            # is live in this frame (that would cascade: each evicted live
            # track re-rings next iteration, evicting another live track,
            # and no face ever accumulates a full window). With max_rings
            # simultaneous live faces, the newcomer gets no ring and falls
            # back to host-packed buffering instead.
            live_now = getattr(self, "_live_now", frozenset())
            candidates = [t for t in self.rings if t not in live_now]
            if not candidates:
                return None
            lru = min(candidates, key=lambda t: self.last_seen.get(t, -1))
            self._drop_ring(lru)
            self.counts["ring_evictions"] += 1
            self.buffers.pop(lru, None)   # its window continuity is gone
            self.since_emit.pop(lru, None)
        return DeviceRing(group.ring_kernels(), uploader=group.ring_uploader())

    def _drop_ring(self, tid: int) -> None:
        self.rings.pop(tid, None)

    def _gc_tracks(self) -> None:
        dead = [
            tid
            for tid, seen in self.last_seen.items()
            if self.frame_idx - seen > self.drop_after
        ]
        for tid in dead:
            self.buffers.pop(tid, None)
            self._drop_ring(tid)
            self.lm5_offsets.pop(tid, None)
            self.since_emit.pop(tid, None)
            self.last_seen.pop(tid, None)
            self.hysteresis.drop(tid)
            self._early_emitted.discard(tid)
            self._stagger_assigned.discard(tid)


def _iou_one_to_many(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    a = (box[2] - box[0]) * (box[3] - box[1])
    b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    union = a + b - inter
    return np.where(union > 0, inter / union, 0)

