"""Per-clip I3D feature dumping for RGB fusion (reference altfreezing/feature.py).

Port of ``stdd_tpu/eval/features.py``. The reference wraps the classifier
with a forward hook capturing penultimate features (``AFModel`` at
feature.py:92) and saves per-video ``npz`` files with features, logits and
scores (``process_video`` :157) that feed ``DualEncoderRGB(from_features=
True)``. Here the same flow rides the streaming engine with a
feature-capturing scorer facade.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class _CapturedBatch:
    """Probs handle of one scored batch that carries the batch's logits and
    features. The engine materialises each batch's handle once, in dispatch
    order, and emits the batch's scores right after, so the rows recorded
    here at materialisation follow the emitted scores clip for clip."""

    def __init__(self, sink: "FeatureCaptureScorer", probs, logits, feats, n: int):
        self._sink = sink
        self._probs = probs
        self._rows = (feats[:n], logits[:n])

    def is_ready(self) -> bool:
        return True

    def __array__(self, dtype=None, copy=None):
        sink, self._sink = self._sink, None
        if sink is not None:
            sink._record(*self._rows)
        return np.asarray(self._probs, dtype)


class FeatureCaptureScorer:
    """ClipScorer facade: scores clips AND records each scored clip's logits
    and penultimate features in the order the engine emits their scores
    (synchronous — feature dumping is an offline job).

    The engine's two dispatch lanes call :meth:`score_async` concurrently and
    finish in either order, so the rows are recorded when the engine
    materialises a batch's handle, not when the batch was scored (the JAX
    facade records call order, which can pair a clip's score with another
    clip's features)."""

    def __init__(self, scorer):
        self.scorer = scorer
        # the engine packs what the wrapped scorer expects (packing.upload_format_of)
        self.upload_format = getattr(scorer, "upload_format", "rgb")
        self.features: List[np.ndarray] = []
        self.logits: List[np.ndarray] = []
        self._lock = threading.Lock()

    def score_async(self, crops, boxes, lm5, valid, path: str = "auto") -> _CapturedBatch:
        # `path` is accepted for the ClipScorer contract and ignored
        del path
        probs, logits, feats = self.scorer.score_with_features(crops, boxes, lm5, valid)
        return _CapturedBatch(self, probs, logits, feats, int(np.sum(valid)))

    def _record(self, feats: np.ndarray, logits: np.ndarray) -> None:
        with self._lock:
            self.features.append(feats)
            self.logits.append(logits)


def dump_video_features(scorer, frames_bgr: Sequence[np.ndarray], detect_fn: Callable,
                        cfg=None, out_path: Optional[str] = None,
                        **engine_kwargs) -> Dict[str, np.ndarray]:
    """Stream one video, capturing (tid, score, logit, feature) per clip.

    Returns (and with ``out_path`` saves) an npz-shaped dict with ``feats
    [N, 2048]``, ``logits [N, C]``, ``scores [N]``, ``tids [N]``
    (feature.py:157 process_video)."""
    from ..runtime.engine import StreamingEngine

    capture = FeatureCaptureScorer(scorer)
    # the facade has no score_windows (device-ring) entry point, and an
    # offline job gains nothing from rings: the host-packed path, as the
    # JAX module pins it
    engine_kwargs.setdefault("device_resident", False)
    engine = StreamingEngine(capture, detect_fn, cfg=cfg, **engine_kwargs)
    order: List[Tuple[int, float]] = []
    try:
        for frame in frames_bgr:
            order.extend(engine.step(frame))
        order.extend(engine.flush())
    finally:
        engine.close()

    feats = np.concatenate(capture.features) if capture.features else np.zeros((0, 2048), np.float32)
    logits = np.concatenate(capture.logits) if capture.logits else np.zeros((0, 1), np.float32)
    if len(feats) != len(order):
        raise RuntimeError(f"{len(order)} scores emitted but {len(feats)} clips' features captured")
    out = {
        "feats": feats,
        "logits": logits,
        "scores": np.asarray([p for _, p in order], np.float32),
        "tids": np.asarray([t for t, _ in order], np.int64),
    }
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        np.savez(out_path, **out)
    return out
