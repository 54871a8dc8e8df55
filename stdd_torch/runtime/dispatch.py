"""Dispatch group: the device-side pipeline behind one StreamingEngine.

Port of ``stdd_tpu/runtime/dispatch.py``. This module owns:

- the pending-clip pool and its batching cadence (``max_batch_wait_frames``),
- the two background dispatch lanes (packing + host→device copy + scoring
  launch off the stepping thread, overlapping decode/track with scoring),
- the strict-FIFO harvest cursor that routes each clip's score to the engine
  that produced it,
- the ring kernels/uploader shared by every device-resident track ring,
- the group's counters (``GROUP_COUNTERS``) and the log of routed windows
  (``WindowRecord``: frame indices, geometry, score, batch, and the
  enqueue, dispatch and routed stamps); each lane's launch, wait and route
  run in ``stdd.lane.*`` spans (``utils/spans.py``).

Per-stream state (tracker, buffers, rings, verdict accumulation) stays in
:class:`~stdd_torch.runtime.engine.StreamingEngine`. Several engines can
share one group (``StreamingEngine(share_dispatch_from=...)``, as
:class:`~stdd_torch.runtime.server.MultiStreamServer` does), so device
batches fill across call streams: each clip carries the engine that
produced it (``clip.owner``) and that engine's reset generation, its score
is routed back there, and a failed batch's error goes only to the streams
whose clips it held (``owner._worker_error``, raised at their next
``step()``/``flush()``).

Reference analogue: the batch_clips+AMP flush loop of ``TEST2.py:393`` —
an async pipelined dispatcher, because a CUDA launch is asynchronous and
the host must keep feeding frames while a batch scores. K1 serves every
clip, so the JAX group's per-clip drift router (``clip_fit_drift``) has no
counterpart: every batch takes one path. The dispatch lanes run under
``torch.inference_mode()``, which is per thread.
"""

from __future__ import annotations

import collections
import queue
import threading
from dataclasses import dataclass
from typing import Any, Deque, List, Optional, Tuple

import numpy as np
import torch

from ..utils.spans import span

# queue sentinel: tells a dispatch lane to exit (DispatchGroup.close)
_CLOSE = object()

# the group's counters (``DispatchGroup.stats()``), over every stream it
# serves. After a flush, every window an engine enqueued is routed, stale or
# failed: windows_full + windows_early (the engines') = windows_routed +
# windows_stale + windows_failed
GROUP_COUNTERS = (
    "batches",            # batches handed to a dispatch lane
    "windows_shipped",    # windows in them
    "padded_slots",       # padding slots shipped to fill a batch capacity
    "windows_routed",     # scores routed to their stream
    "windows_stale",      # dropped for their stream's reset (owner generation, or never shipped)
    "windows_failed",     # in a batch whose launch, fetch or routing raised
    "batches_failed",     # such batches
)

# routed windows the group's log keeps (``DispatchGroup.windows()``)
WINDOW_LOG_LEN = 4096


@dataclass
class _PendingClip:
    tid: int
    entries: List[Any]
    owner: Any = None             # engine whose stream produced this clip
    owner_gen: int = 0            # owner's reset generation at enqueue time
    tick: int = 0                 # group step counter at enqueue (batch-wait age)
    t_enq: float = 0.0            # perf_counter at enqueue (TEST2.py:316 latency)
    # device-ring mode: (dev_window [T,...] u8 on the card, boxes [T,4],
    # lm5 [T,5,2], scale [T]) — entries stay metadata-only
    window: Optional[tuple] = None
    early: bool = False           # a provisional (padded) first window
    t_dispatch: float = 0.0       # perf_counter when handed to a dispatch lane
    t_routed: float = 0.0         # perf_counter when its score was routed


@dataclass
class WindowRecord:
    """One routed window, as the group's log keeps it. Geometry is the
    window's own (held, not copied), unscaled; ``scale`` is each frame's
    pack scale. Stamps are ``time.perf_counter()``."""
    stream: Optional[int]         # the server's stream id of the call (None outside one)
    tid: int                      # track id
    kind: str                     # "full" or "early"
    frames: np.ndarray            # [T] int64 the engine's frame indices, oldest
                                  # first (an early window repeats its newest)
    boxes: np.ndarray             # [T, 4] absolute big boxes
    lm5: np.ndarray               # [T, 5, 2] crop-local landmarks
    scale: np.ndarray             # [T] float32
    prob: float                   # the score routed
    batch_seq: int                # the batch's dispatch sequence number
    batch_size: int               # windows in the batch (padding not counted)
    t_enq: float
    t_dispatch: float
    t_routed: float


def _record(clip: _PendingClip, T: int, S: int, prob: float, seq: int, n: int) -> WindowRecord:
    entries = clip.entries
    frames = [e.frame_idx for e in entries]
    frames += frames[-1:] * (T - len(frames))
    if clip.window is not None:
        _, boxes, lm5, scale = clip.window
    else:
        # a host-packed clip: the geometry ``pack_clip_batch`` packs, unscaled
        padded = list(entries) + entries[-1:] * (T - len(entries))
        boxes = np.stack([np.asarray(e.big_box, np.float32) for e in padded])
        lm5 = np.stack([np.asarray(e.lm5, np.float32) for e in padded])
        s = min(1.0, S / float(max(max(e.crop.shape[:2]) for e in padded)))
        scale = np.full((T,), s, np.float32)
    return WindowRecord(
        stream=getattr(clip.owner, "stream_id", None), tid=clip.tid,
        kind="early" if clip.early else "full", frames=np.asarray(frames, np.int64),
        boxes=boxes, lm5=lm5, scale=scale, prob=prob, batch_seq=seq, batch_size=n,
        t_enq=clip.t_enq, t_dispatch=clip.t_dispatch, t_routed=clip.t_routed)


class DispatchGroup:
    """Pack → upload → score → harvest pipeline shared by one or more
    engines. Engines enqueue clips and call :meth:`tick_and_dispatch` /
    :meth:`harvest`; results land in each clip owner's ``_ready`` list."""

    def __init__(self, scorer, cfg, crop_buffer: int, device_resident: bool,
                 max_batch_wait_frames, default_owner):
        self.scorer = scorer
        self.cfg = cfg
        self.crop_buffer = crop_buffer
        self.device_resident = device_resident
        self.max_batch_wait_frames = max_batch_wait_frames
        # errors of ownerless batches route here (engine.step always stamps
        # owners; this is a guard rail)
        self.default_owner = default_owner

        self.pending: List[_PendingClip] = []
        self._tick = 0
        # bounded: a never-reset serving root must not grow forever
        self.clip_latencies: Deque[float] = collections.deque(maxlen=10000)
        # counters over the group's life and the log of routed windows; the
        # stepping threads and both lanes write them, under _count_lock
        self.counts = dict.fromkeys(GROUP_COUNTERS, 0)
        self.window_log: Deque[WindowRecord] = collections.deque(maxlen=WINDOW_LOG_LEN)
        self._count_lock = threading.Lock()
        # in-flight async device batches: (seq, clips, device_probs,
        # t_dispatch); harvested strictly in dispatch order (seq) so
        # per-track score sequences are deterministic even when the two
        # upload lanes finish out of order
        self.inflight: List[Tuple[int, List[_PendingClip], Any, float]] = []
        self._next_seq = 0
        self._next_harvest_seq = 0

        self._lock = threading.Lock()          # guards .inflight
        # guards pending / seq / tick when streams of a shared group step
        # from different threads (RLock: _dispatch runs under it)
        self._state_lock = threading.RLock()
        self._harvest_lock = threading.Lock()  # serializes _harvest
        self._zero_lock = threading.Lock()     # one-time _zero_window build
        # one-time ring kernels/uploader build: the stepping thread's first
        # _new_ring() and a lane's first zero window can race
        self._lazy_lock = threading.Lock()
        self._dispatch_q = queue.Queue()
        # two dispatch lanes: one packs/launches while the other waits on
        # its batch's result
        self._workers = [
            threading.Thread(target=self._dispatch_worker, daemon=True)
            for _ in range(2)
        ]
        for w in self._workers:
            w.start()

    # -- shared ring plumbing (device-resident mode) ------------------------

    def ring_kernels(self):
        from .packing import upload_format_of
        from .ring import RingKernels

        if not hasattr(self, "_ring_kernels"):
            with self._lazy_lock:
                if not hasattr(self, "_ring_kernels"):
                    self._ring_kernels = RingKernels(
                        R=self.cfg.clip_size, S=self.crop_buffer,
                        yuv420=upload_format_of(self.scorer) == "yuv420",
                        device=self.scorer.device,
                    )
        return self._ring_kernels

    def ring_uploader(self):
        from .ring import RingUploader

        if not hasattr(self, "_ring_uploader"):
            with self._lazy_lock:
                if not hasattr(self, "_ring_uploader"):
                    self._ring_uploader = RingUploader(self.scorer.device)
        return self._ring_uploader

    def _zero_window_dev(self):
        # both dispatch lanes can race the first partial window batch
        if not hasattr(self, "_zero_window"):
            with self._zero_lock:
                if not hasattr(self, "_zero_window"):
                    self._zero_window = torch.zeros(
                        (self.cfg.clip_size,) + self.ring_kernels().slot_shape,
                        dtype=torch.uint8, device=self.scorer.device,
                    )
        return self._zero_window

    def warmup(self) -> None:
        """Run the scorer once for every batch capacity this group can
        ship, so no clip pays a first-call cost (K1 build, cuDNN algorithm
        choice) in the hot path."""
        from .packing import pow2_capacities

        if self.device_resident:
            self.ring_kernels().warmup(self.cfg.clip_size)
            self._zero_window_dev()
        self.scorer.warmup(
            self.crop_buffer, pow2_capacities(self.cfg.batch_clips),
            self.cfg.clip_size, windows=self.device_resident,
        )

    # -- lifecycle ----------------------------------------------------------

    def reset(self) -> None:
        """Drain queued/in-flight work from the previous stream FIRST so
        late arrivals can't leak scores into the new one."""
        self._dispatch_q.join()
        with self._lock:
            dropped = sum(len(e[1]) for e in self.inflight)
            self.inflight = []
        with self._state_lock:
            dropped += len(self.pending)
            self.pending = []
            self._tick = 0
        self._count(windows_stale=dropped)
        self.clip_latencies = collections.deque(maxlen=10000)
        with self._count_lock:
            self.window_log.clear()
        self._next_seq = 0
        self._next_harvest_seq = 0

    def drop_owner(self, engine) -> None:
        """A secondary engine's reset: drop its queued-but-undispatched
        clips; peers are undisturbed. Its clips already in flight are
        discarded at harvest by the owner-generation check."""
        with self._state_lock:
            kept = [c for c in self.pending if c.owner is not engine]
            self._count(windows_stale=len(self.pending) - len(kept))
            self.pending = kept

    def _count(self, **deltas: int) -> None:
        with self._count_lock:
            for k, v in deltas.items():
                self.counts[k] += v

    def stats(self) -> dict:
        """The group's counters (``GROUP_COUNTERS``) over its life."""
        with self._count_lock:
            return dict(self.counts)

    def windows(self) -> List[WindowRecord]:
        """The log of routed windows, oldest first (the last ``WINDOW_LOG_LEN``)."""
        with self._count_lock:
            return list(self.window_log)

    def close(self) -> None:
        """Shut down the two dispatch lanes (a parked daemon lane pins the
        whole group→engine→scorer graph alive). Idempotent — call from the
        engine when the group is done."""
        workers, self._workers = self._workers, []
        for _ in workers:
            self._dispatch_q.put(_CLOSE)   # drains queued batches first
        for w in workers:
            w.join(timeout=30)

    # -- enqueue / dispatch --------------------------------------------------

    def enqueue(self, clip: _PendingClip) -> None:
        with self._state_lock:
            clip.tick = self._tick
            self.pending.append(clip)

    def tick_and_dispatch(self) -> None:
        """Advance the group step counter and ship every due batch: full
        batches always; in latency mode also a partial batch once its OLDEST
        clip has waited ``max_batch_wait_frames`` group steps (each clip
        carries its enqueue tick, so leftovers keep their age across partial
        dispatches)."""
        with self._state_lock:
            self._tick += 1
            wait = self.max_batch_wait_frames
            while len(self.pending) >= self.cfg.batch_clips or (
                self.pending
                and wait is not None
                and self._tick - self.pending[0].tick >= wait
            ):
                self._dispatch()

    def drain_snapshot(self) -> int:
        """Dispatch everything queued and return the sequence fence: batches
        with seq < fence cover every clip enqueued before this call."""
        with self._state_lock:
            while self.pending:
                self._dispatch()
            return self._next_seq

    def _dispatch(self) -> None:
        """Hand the next batch to a dispatch lane WITHOUT blocking, so
        tracking/decode of subsequent frames overlaps with alignment and
        scoring of this batch (the reference's batch_clips+AMP flush,
        TEST2.py:393)."""
        import time

        with self._state_lock:
            batch = self.pending[: self.cfg.batch_clips]
            self.pending = self.pending[self.cfg.batch_clips:]
            if not batch:
                return
            # packing (downscale + zero-pad of B*T crops) happens on the
            # worker thread too, so the stepping thread only enqueues
            seq = self._next_seq
            self._next_seq += 1
        t = time.perf_counter()
        for clip in batch:
            clip.t_dispatch = t
        self._count(batches=1, windows_shipped=len(batch))
        self._dispatch_q.put((seq, batch, t))

    def _cap_for(self, n: int) -> int:
        """Next power-of-2 dispatch capacity ≥ n (bounded by batch_clips)."""
        from .packing import pow2_capacities

        return next(
            (c for c in pow2_capacities(self.cfg.batch_clips) if c >= n),
            self.cfg.batch_clips,
        )

    def _pack_and_score(self, batch: List[_PendingClip]):
        """Pack a (sub-)batch to the next power-of-2 capacity and dispatch it
        asynchronously (a padded batch uploads its full fixed-shape buffer,
        so small flushes ship small buffers; the capacities are the shapes
        ``warmup`` runs). → probs handle."""
        from .packing import pack_clip_batch, upload_format_of

        cap = self._cap_for(len(batch))
        self._count(padded_slots=cap - len(batch))
        crops, boxes, lm5, valid = pack_clip_batch(
            [c.entries for c in batch], cap,
            self.cfg.clip_size, self.crop_buffer,
            yuv420=upload_format_of(self.scorer) == "yuv420",
        )
        return self.scorer.score_async(crops, boxes, lm5, valid)

    def _ship_windows(self, sub: List[_PendingClip]):
        """Dispatch device-ring windows: pixels are already on the card, so
        only geometry (KBs) is uploaded. Pads to the next pow2 capacity."""
        T = self.cfg.clip_size
        cap = self._cap_for(len(sub))
        self._count(padded_slots=cap - len(sub))
        boxes = np.ones((cap, T, 4), np.float32)
        lm5 = np.ones((cap, T, 5, 2), np.float32)
        scale = np.ones((cap, T), np.float32)
        valid = np.zeros((cap,), bool)
        ws = []
        for k, clip in enumerate(sub):
            dev_w, b, l, s = clip.window
            ws.append(dev_w)
            boxes[k], lm5[k], scale[k] = b, l, s
            valid[k] = True
        if len(ws) < cap:
            ws.extend([self._zero_window_dev()] * (cap - len(ws)))
        return self.scorer.score_windows(ws, boxes, lm5, scale, valid)

    def _score_batch(self, batch: List[_PendingClip]):
        """Route one dispatch batch to the device: window clips (device
        ring) and host-packed clips ship through different entry points (a
        crowd-overflow track has no ring, so a ring-mode batch CAN mix
        both). → one probs handle covering the whole batch in order, or
        ``[(indices, handle), ...]`` pieces for the harvester."""
        idx_w = [i for i, c in enumerate(batch) if c.window is not None]
        idx_h = [i for i, c in enumerate(batch) if c.window is None]
        pieces = []
        if idx_w:
            pieces.append((idx_w, self._ship_windows([batch[i] for i in idx_w])))
        if idx_h:
            pieces.append((idx_h, self._pack_and_score([batch[i] for i in idx_h])))
        if len(pieces) == 1:
            return pieces[0][1]
        return pieces

    def _dispatch_worker(self) -> None:
        with torch.inference_mode():
            self._dispatch_loop()

    def _dispatch_loop(self) -> None:
        while True:
            item = self._dispatch_q.get()
            if item is _CLOSE:
                self._dispatch_q.task_done()
                return
            batch: List[_PendingClip] = []
            try:
                seq, batch, t0 = item
                with span("stdd.lane.launch"):
                    dev = self._score_batch(batch)
                # Ring mode: materialize the probs HERE, on the lane
                # thread, and route immediately: harvesting only from the
                # stepping thread quantizes window latency to the step
                # cadence. A window batch is kilobytes, so blocking this
                # lane for the device compute costs nothing at streaming
                # clip rates and the second lane keeps dispatching. A
                # packed (or mixed) batch stays async, so its lane never
                # serializes a large upload behind a fetch.
                eager = (self.device_resident
                         and all(c.window is not None for c in batch))
                if eager:
                    parts = (dev if isinstance(dev, list)
                             else [(range(len(batch)), dev)])
                    with span("stdd.lane.wait"):
                        dev = [(idx, np.asarray(d)) for idx, d in parts]
                with self._lock:
                    self.inflight.append((seq, batch, dev, t0))
                if eager:
                    # route now if this batch is the FIFO head (strict seq
                    # order is still enforced inside harvest); the owner
                    # sees the score at its next step() without an extra
                    # tick. Own try: the batch is already in `inflight`, so
                    # the outer handler's seq sentinel must NOT fire for a
                    # routing failure — a duplicate seq entry behind the
                    # advanced cursor would wedge the FIFO head check.
                    # A batch's fetch or routing failure is caught inside
                    # _harvest_locked and goes to that batch's streams (the
                    # FIFO head may belong to another stream than the batch
                    # this lane shipped); what escapes here is
                    # infrastructure, so it goes to the default stream.
                    try:
                        with span("stdd.lane.route"):
                            self.harvest(block=False)
                    except Exception as exc:
                        import traceback

                        traceback.print_exc()
                        self.default_owner._worker_error = exc
            except Exception as exc:
                # a dead worker would deadlock every later _dispatch_q.join();
                # keep the thread alive, drop the batch (a None sentinel so
                # the FIFO harvest cursor still advances), and surface the
                # error ONLY to the streams whose clips were in the failed
                # batch: a peer call's step() must not raise for it
                import traceback

                traceback.print_exc()
                self._route_error(batch, exc)
                self._count(batches_failed=1, windows_failed=len(batch))
                with self._lock:
                    self.inflight.append((item[0], [], None, item[2]))
            finally:
                self._dispatch_q.task_done()

    # -- harvest ------------------------------------------------------------

    def _route_error(self, batch: List[_PendingClip], exc: BaseException) -> None:
        """Hand a failed batch's error to every stream that owned one of its
        clips (the default stream when it held none)."""
        for owner in {c.owner or self.default_owner for c in batch} or {self.default_owner}:
            owner._worker_error = exc

    def harvest(self, block: bool) -> None:
        """Collect finished device batches and route each clip's score to
        the engine that produced it (``clip.owner``); with ``block=False``
        only batches whose results are already materialized are taken (plus
        forced takes when the pipeline depth exceeds 2, to bound memory).
        Each engine reads its results from ``engine._take_ready``."""
        if not self._harvest_lock.acquire(blocking=block):
            # another thread (the stepping thread or a dispatch lane) is
            # already harvesting; its pass routes these results too
            return
        try:
            self._harvest_locked(block)
        finally:
            self._harvest_lock.release()

    def harvest_until(self, target_seq: int) -> None:
        """Blocking harvest of every batch dispatched before ``target_seq``
        (exclusive). The target check happens under ``_harvest_lock``: the
        cursor only advances after a batch's scores are fully routed, so
        once the target is observed every score up to it has landed in its
        owner's _ready/track_clip_scores; batches peers dispatch meanwhile
        do not extend the wait."""
        import time

        while True:
            with self._harvest_lock:
                self._harvest_locked(block=True, until_seq=target_seq)
                done = self._next_harvest_seq >= target_seq
            if done:
                return
            time.sleep(0.002)   # head batch is still packing on a worker

    def _harvest_locked(self, block: bool, until_seq: Optional[int] = None) -> None:
        import time

        while True:
            if until_seq is not None and self._next_harvest_seq >= until_seq:
                # a flushing stream's snapshotted target: batches peers
                # dispatched after the snapshot are not its to wait for
                break
            with self._lock:
                entries = sorted(self.inflight, key=lambda e: e[0])
            if not entries:
                break
            # strict FIFO: only ever take the oldest in-flight batch, so
            # score order == dispatch order regardless of which upload lane
            # finishes first. When the pipeline is deeper than 2 batches the
            # head is force-taken (blocking) to bound device memory.
            entry = entries[0]
            seq, batch, dev, t0 = entry
            if seq != self._next_harvest_seq:
                # the true head batch is still being packed on a worker
                break
            if dev is None:           # failed batch (worker exception) — the
                with self._lock:      # error already surfaced above; advance
                    self.inflight.remove(entry)
                self._next_harvest_seq += 1
                continue
            # a mixed batch carries a list of (indices, dev) sub-batches
            # (ring windows / host-packed); normalize to a list
            parts = dev if isinstance(dev, list) else [(range(len(batch)), dev)]
            if not block and len(entries) <= 2:
                # eagerly materialized parts are numpy arrays: always ready
                if not all(d.is_ready() for _, d in parts if hasattr(d, "is_ready")):
                    break
            try:
                probs = np.zeros((len(batch),), np.float32)
                for idx, d in parts:
                    sub = np.asarray(d)
                    for k, bi in enumerate(idx):
                        probs[bi] = sub[k]
            except Exception as exc:
                # a device-side failure must not wedge the FIFO: drop the
                # batch, advance the cursor, and surface the error at the
                # engine's next step()/flush()
                with self._lock:
                    if entry in self.inflight:
                        self.inflight.remove(entry)
                self._route_error(batch, exc)
                self._count(batches_failed=1, windows_failed=len(batch))
                self._next_harvest_seq += 1
                continue
            now = time.perf_counter()
            with self._lock:
                try:
                    self.inflight.remove(entry)
                except ValueError:
                    continue
            T, S = self.cfg.clip_size, self.crop_buffer
            routed, stale, records = 0, 0, []
            try:
                for bi, clip in enumerate(batch):
                    # per-clip enqueue→scored latency, the reference's
                    # clip_enqueue_t/clip_infer_t accounting (TEST2.py:316,440)
                    self.clip_latencies.append(now - (clip.t_enq or t0))
                    clip.t_routed = now
                    owner = clip.owner or self.default_owner
                    if owner._gen != clip.owner_gen:
                        stale += 1
                        continue  # the owner's stream was reset: stale score
                    p = float(probs[bi])
                    owner.track_clip_scores[clip.tid].append(p)
                    owner.hysteresis.update(clip.tid, p)
                    with owner._ready_lock:
                        owner._ready.append((clip.tid, p))
                    routed += 1
                    records.append(_record(clip, T, S, p, seq, len(batch)))
            except Exception as exc:
                # a routing failure belongs to THIS batch's streams (the
                # caller may be a lane that shipped another batch): surface
                # it to them and keep the cursor advancing exactly like the
                # fetch-failure path
                self._route_error(batch, exc)
                self._count(batches_failed=1,
                            windows_failed=len(batch) - routed - stale)
            with self._count_lock:
                self.counts["windows_routed"] += routed
                self.counts["windows_stale"] += stale
                self.window_log.extend(records)
            # advance the cursor only AFTER routing: _harvest_until's target
            # check (under _harvest_lock) must imply the scores have landed
            self._next_harvest_seq += 1
