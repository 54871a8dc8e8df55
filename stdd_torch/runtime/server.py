"""Multi-call serving: many live streams sharing one card's scorer.

Port of ``stdd_tpu/runtime/server.py``. The reference serves exactly one
call (one captured window, ``test/app_realtime.py``). One card scores far
more clips per second than one call produces (a call emits about one
window a second per face), so this server multiplexes N concurrent calls
onto one :class:`~stdd_torch.runtime.classifier.ClipScorer`:

- **One model** — every stream's engine shares the scorer and its weights.
- **Cross-stream batching** — all engines share one dispatch group
  (``StreamingEngine(share_dispatch_from=...)``): device batches fill with
  clips from whichever calls have windows ready, so sparse per-call clip
  rates still produce full batches (bounded latency via
  ``max_batch_wait_frames``).
- **Per-stream isolation** — results route back to the producing stream;
  ending or resetting one stream never drops a peer's in-flight scores
  (owner-generation check in ``DispatchGroup._harvest_locked``).

Typical use::

    server = MultiStreamServer(scorer, cfg=pipe)
    a = server.add_stream(detect_fn_a)
    b = server.add_stream(detect_fn_b)
    scores_a = server.step(a, frame_a)     # [(track_id, prob), ...]
    scores_b = server.step(b, frame_b)
    verdict_a = server.finish(a)           # VideoVerdict; stream removed
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..config import PipelineConfig
from .dispatch import WindowRecord
from .engine import ENGINE_COUNTERS, StreamingEngine
from .scoring import VideoVerdict


class MultiStreamServer:
    """N concurrent call streams multiplexed onto one scorer with
    cross-stream clip batching."""

    def __init__(
        self,
        scorer,
        cfg: Optional[PipelineConfig] = None,
        max_batch_wait_frames: Optional[int] = None,
        **engine_kwargs,
    ):
        self.scorer = scorer
        self.cfg = cfg or PipelineConfig()
        self._engine_kwargs = engine_kwargs
        if max_batch_wait_frames is None:
            # inherit the engine's latency default: 0 in device-ring mode
            # (window dispatches move only kilobytes of geometry, so holding
            # a partial batch for peers buys nothing and costs up to a
            # stride of p50 window latency), else one stride's worth of
            # group steps so a sparse call's clip never waits for a full
            # batch
            max_batch_wait_frames = "stride"
        # the group root anchors the shared dispatch plumbing (queue, upload
        # lanes, in-flight set). It never receives frames and is never reset,
        # so no stream's lifecycle can drain a peer's in-flight work.
        self._root = StreamingEngine(
            scorer,
            lambda frame: np.empty((0, 15), np.float32),
            cfg=self.cfg,
            max_batch_wait_frames=max_batch_wait_frames,
            **engine_kwargs,
        )
        self.streams: Dict[int, StreamingEngine] = {}
        self._next_id = 0
        # the counters of finished streams, so that stats() keeps balancing
        self._finished_counts: Dict[str, int] = dict.fromkeys(ENGINE_COUNTERS, 0)

    def warmup(self) -> None:
        """Run every batch capacity the dispatch group can ship once (K1
        builds, cuDNN picks its algorithms) so no call pays that. Call once
        at serving startup."""
        self._root.warmup()

    def add_stream(self, detect_fn: Callable[[np.ndarray], np.ndarray]) -> int:
        """Register a new call; returns its stream id."""
        eng = StreamingEngine(
            self.scorer,
            detect_fn,
            cfg=self.cfg,
            share_dispatch_from=self._root,
            **self._engine_kwargs,
        )
        sid = self._next_id
        self._next_id += 1
        eng.stream_id = sid
        self.streams[sid] = eng
        return sid

    def step(self, stream_id: int, frame_bgr: np.ndarray) -> List[Tuple[int, float]]:
        """Feed one frame of one call; returns that call's newly scored
        clips as ``(track_id, prob)``."""
        return self.streams[stream_id].step(frame_bgr)

    def flush(self, stream_id: int) -> List[Tuple[int, float]]:
        """Force-score everything queued GROUP-wide; returns this call's
        newly scored clips (peers' results stay routed to them)."""
        return self.streams[stream_id].flush()

    def finish(self, stream_id: int, **agg_kwargs) -> VideoVerdict:
        """End a call: flush, aggregate its verdict, remove the stream.
        The stream is only removed on success — if a worker error for one
        of this stream's own batches surfaces during the flush (errors are
        routed to the owning stream), the stream and its accumulated scores
        survive and ``finish`` can be retried."""
        eng = self.streams[stream_id]
        verdict = eng.finish(**agg_kwargs)
        del self.streams[stream_id]
        for k, v in eng.counts.items():
            self._finished_counts[k] += v
        return verdict

    def engine(self, stream_id: int) -> StreamingEngine:
        return self.streams[stream_id]

    def close(self) -> None:
        """Shut down every stream and the shared dispatch group's dispatch
        lanes. The server must not be stepped after."""
        for eng in self.streams.values():
            eng.close()
        self.streams.clear()
        self._root.close()

    @property
    def clip_latencies(self) -> List[float]:
        return self._root.clip_latencies

    def stats(self) -> Dict[str, int]:
        """Every stream's counters summed (``engine.ENGINE_COUNTERS``,
        finished streams included), then the shared dispatch group's
        (``dispatch.GROUP_COUNTERS``). After a flush, windows_full +
        windows_early = windows_routed + windows_stale + windows_failed."""
        out = dict(self._finished_counts)
        for eng in list(self.streams.values()):
            for k, v in eng.counts.items():
                out[k] += v
        out.update(self._root._group.stats())
        return out

    def windows(self) -> List[WindowRecord]:
        """The routed windows of every stream, oldest first
        (``dispatch.WindowRecord``: stream, track, kind, frame indices,
        geometry, score, batch, and the enqueue, dispatch and routed stamps),
        the last ``dispatch.WINDOW_LOG_LEN`` of them."""
        return self._root._group.windows()
