"""Live calls: ``MultiStreamServer`` over an open loop of concurrent calls.

Traffic (the mix file's parameters):

- ``calls``: concurrent calls, each ``frame_hw`` at ``fps``, showing a grid
  of ``faces`` faces (``lib/scene.py``, one scene seed per call drawn from
  ``--seed``: background and faces); frame i of call k falls due at (i + k / calls) / fps after
  the window opens, whether or not the server kept up. A server that falls
  behind takes the next frame at once; when ``--seconds`` have passed, the
  frames not yet taken up never are;
- ``motion``: each face stays in its own tile of the grid, ``tile_margin_px``
  from its edges, and drifts at its tile's entry of ``velocities_px`` (x, y
  pixels a frame, bouncing at the margins). The seed mirrors a call's whole
  motion left-right and/or top-bottom, so every seed crops the same sizes
  and the faces never overlap: the host's work does not hang on the seed;
- ``render_frames``: frames pre-rendered per call in set-up and replayed
  forward, then backward, so the motion stays continuous;
- ``preroll_frames``: frames each call is stepped through in set-up, so the
  window opens on calls in their steady state (rings full, windows due);
- ``pipeline``: the ``PipelineConfig`` fields the calls set (clip,
  stride, detect cadence, batch);
- ``check_pairs``: how many pairs of a track's consecutive windows the
  output check recomputes.

``frames_per_s`` is the frames taken up over the window's whole time (the
flush of the windows in flight included): above the server's knee it is
the rate the server sustains, the end-to-end number; there the backlog
grows all through the window, so the frame lag and the window latency's
tails swing and are read as per-layer metrics. For the same reason a late
frame or window is not a failure: the share that would meet a deadline
swings with the smallest change of rate. ``attempted`` counts the frames
the server took up and the windows it enqueued in the window; ``failed``
the windows enqueued and never scored, and those scored to no finite
probability (both also make the run not correct).

Detection: every ``detect_every``-th frame of a call runs the port's
``detect_scaled`` on a YuNet-shaped graph with random weights (one detector,
on its own stream, per call; YuNet's weights are not in the repository),
through ``AsyncDetector`` as the app runs it, for its device cost; the
scene's oracle rows of that frame are what the tracker gets.

The check follows the program's own state for the stage it cannot redo:
which frames and which tracked geometry each window took (the tracker,
the landmark cache and the windowing) are recorded as the program makes
them. That stage is checked by itself against the scene's truth (the
window's landmarks against the oracle's, ``landmark_err``). From the raw
frames and that geometry the reference redoes the rest (the crop, its
area downscale and I420 pack, the decode, the similarity, the warp, the
network) and the program's score is held to it as in the dense cells.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.lib import check as check_lib
from portbench.lib.check import plant_fault, signed_gaps, stratified_pick
from portbench.lib.program import build_scorer
from portbench.lib.scene import Scene
from portbench.lib.trace import Window
from portbench.reference.align import pack_crop
from portbench.reference.scorer import logits_and_features


SALT_SCENES = 0x5EED_0101
SALT_CHECK = 0x5EED_0102

# the faults this kind's check is tested against: the scorer's, and the
# tracked landmarks moved by a face's width where the tracker makes them
FAULTS = check_lib.FAULTS + ("moved_landmarks",)


def grid_scene(frame_hw, faces: int, seed: int, motion: dict, flip) -> Scene:
    """A call's grid of ``faces`` faces: ``Scene``'s background and faces
    from ``seed``, each face kept inside its tile and started at its centre,
    moving at the velocity of its tile in ``motion``; ``flip`` (x, y, each
    ±1) mirrors the whole motion."""
    sc = Scene(tuple(frame_hw), n_faces=faces, seed=seed)
    H, W = frame_hw
    cols = int(np.ceil(np.sqrt(faces)))
    rows = faces // cols
    if rows * cols != faces:
        raise ValueError(f"{faces} faces do not fill a grid")
    v = np.asarray(motion["velocities_px"], np.float64)
    if v.shape != (faces, 2):
        raise ValueError(f"velocities_px needs one (x, y) a face, got {v.shape}")
    m, px = motion["tile_margin_px"], sc.face_px
    th, tw = H / rows, W / cols
    lo, hi, vel = (np.empty((faces, 2), np.float64) for _ in range(3))
    for f in range(faces):
        c, r = f % cols, f // cols
        lo[f] = (c * tw + m, r * th + m)
        hi[f] = ((c + 1) * tw - px - m, (r + 1) * th - px - m)
        c2 = cols - 1 - c if flip[0] < 0 else c
        r2 = rows - 1 - r if flip[1] < 0 else r
        vel[r2 * cols + c2] = v[f] * np.asarray(flip, np.float64)
    if (hi <= lo).any():
        raise ValueError("a face does not fit its tile inside the margin")
    sc.lo, sc.hi, sc.vel, sc.pos0 = lo, hi, vel, (lo + hi) / 2
    return sc


def pingpong(g: int, n: int) -> int:
    """The rendered frame shown at global frame ``g``: 0..n-1, then back."""
    m = g % (2 * n - 2)
    return m if m < n else 2 * n - 2 - m


class Run:
    def __init__(self, cell, seed: int, device, variant=None, fault=None):
        from stdd_torch.config import DetectorConfig, PipelineConfig
        from stdd_torch.models.yunet import YuNet, detect_scaled
        from stdd_torch.runtime import ring as ring_mod
        from stdd_torch.runtime.engine import AsyncDetector, StreamingEngine
        from stdd_torch.runtime.server import MultiStreamServer
        from stdd_torch.utils.onnx_writer import write_onnx, yunet_shaped_graph

        self.cell, self.seed, self.device = cell, seed, device
        mix = self.mix = cell.mix
        torch.backends.cudnn.allow_tf32 = False          # as the app sets it
        self.scorer, self.params, self.spec = build_scorer(cell.config, seed, device, variant)
        restore = []
        if fault == "moved_landmarks":
            orig_lm = StreamingEngine._landmarks_for

            def moved(engine, tid, box, dets):
                lm5 = orig_lm(engine, tid, box, dets)
                return None if lm5 is None else lm5 + np.float32([box[2] - box[0], 0.0])

            StreamingEngine._landmarks_for = moved
            restore.append(lambda: setattr(StreamingEngine, "_landmarks_for", orig_lm))
        elif fault is not None:
            plant_fault(self.scorer, fault)
        self.S = cell.config["serving"]["crop_buffer"]
        self.pipe = PipelineConfig(**mix["pipeline"])
        self.T = self.pipe.clip_size
        C, L = mix["calls"], mix["render_frames"]
        rng = np.random.default_rng([seed & 0xFFFF_FFFF_FFFF_FFFF, SALT_SCENES])
        scene_seeds = rng.integers(0, 2 ** 31 - 1, C)
        flips = 2 * rng.integers(0, 2, (C, 2)) - 1
        self.scenes = [grid_scene(mix["frame_hw"], mix["faces"], int(s), mix["motion"], fl)
                       for s, fl in zip(scene_seeds, flips)]
        self.frames = [[sc.frame(i) for i in range(L)] for sc in self.scenes]
        self.index = [{id(f): i for i, f in enumerate(fr)} for fr in self.frames]
        with tempfile.TemporaryDirectory() as tmp:    # under the run's TMPDIR
            path = write_onnx(yunet_shaped_graph(int(rng.integers(0, 2 ** 31 - 1))),
                              os.path.join(tmp, "yunet_shaped.onnx"))
            self.dets = [YuNet(path, DetectorConfig(), device=device) for _ in range(C)]
        for det, fr in zip(self.dets, self.frames):
            detect_scaled(det, fr[0])
        self.detections = 0
        self._det_lock = threading.Lock()

        # the program's own state, recorded as it makes it: the frames each
        # ring took and the window each enqueue shipped. These rest on the
        # program's private names (``DeviceRing.push``, the dispatch group's
        # ``enqueue``, ``clip.window``); the frame a push took is the one the
        # stepping thread is on, and a push from any other thread is
        # recorded as unknown, which the check fails
        self.current = (0, 0)
        self._stepper = threading.get_ident()
        self.windows: List[dict] = []
        self.phase = "preroll"
        orig_push = ring_mod.DeviceRing.push
        run = self

        def push(ring, crop, big_box, lm5):
            on = run.current if threading.get_ident() == run._stepper else None
            ring.__dict__.setdefault("_portbench_frames", []).append(on)
            return orig_push(ring, crop, big_box, lm5)

        ring_mod.DeviceRing.push = push
        restore.append(lambda: setattr(ring_mod.DeviceRing, "push", orig_push))
        self._restore = lambda: [r() for r in restore]

        # device rings: the server's own choice on a card, stated so that a
        # run on the CPU (the tests) takes the same path
        self.server = MultiStreamServer(self.scorer, cfg=self.pipe, crop_buffer=self.S,
                                        device_resident=True)
        group = self.server._root._group
        orig_enqueue = group.enqueue

        def enqueue(clip):
            ring = clip.owner.rings.get(clip.tid)
            _, boxes, lm5, scale = clip.window
            run.windows.append(dict(
                call=run.sid_call[id(clip.owner)], tid=clip.tid, phase=run.phase,
                frames=list(ring.__dict__["_portbench_frames"][-run.T:]),
                boxes=boxes.copy(), lm5=lm5.copy(), scale=scale.copy()))
            orig_enqueue(clip)

        group.enqueue = enqueue
        self.server.warmup()
        self.sids, self.sid_call = [], {}
        for k in range(C):
            sid = self.server.add_stream(AsyncDetector(self._detect_fn(k, detect_scaled)))
            self.sids.append(sid)
            self.sid_call[id(self.server.engine(sid))] = k
        self.scores: Dict[Tuple[int, int], List[float]] = {}
        self.nonfinite = 0
        self.g = [0] * C
        for _ in range(mix["preroll_frames"]):
            for k in range(C):
                self._step(k)
        for k in range(C):
            self._take(k, self.server.flush(self.sids[k]))
        self.server.clip_latencies.clear()

    def _detect_fn(self, k: int, detect_scaled):
        det, scene, index = self.dets[k], self.scenes[k], self.index[k]
        run = self

        def detect(frame):
            detect_scaled(det, frame)
            with run._det_lock:
                run.detections += 1
            return scene.detect(index[id(frame)])

        return detect

    def _detector_streams(self) -> List[int]:
        """The trace's ids of the detectors' streams: one detection each,
        profiled alone before a traced window (every operation of
        ``detect_scaled`` runs on its detector's own stream)."""
        from stdd_torch.models.yunet import detect_scaled
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for det, fr in zip(self.dets, self.frames):
                detect_scaled(det, fr[0])
            torch.cuda.synchronize()
        return sorted({e.device_resource_id() for e in prof.profiler.kineto_results.events()
                       if e.device_type() == torch.autograd.DeviceType.CUDA})

    def _take(self, k: int, scored) -> None:
        for tid, p in scored:
            self.scores.setdefault((k, tid), []).append(p)
            if self.phase == "window" and not np.isfinite(p):
                self.nonfinite += 1

    def _step(self, k: int):
        g = self.g[k]
        self.g[k] += 1
        self.current = (k, g)
        frame = self.frames[k][pingpong(g, len(self.frames[k]))]
        self._take(k, self.server.step(self.sids[k], frame))

    def window(self, seconds: float, trace: bool) -> dict:
        from stdd_torch.ops import warp

        mix = self.mix
        C, fps = mix["calls"], float(mix["fps"])
        n = int(round(seconds * fps))
        due = [(i + k / C) / fps for i in range(n) for k in range(C)]
        lag, step_s = [], []
        self.phase = "window"
        self.nonfinite = 0
        first_window = len(self.windows)
        k1_before = warp.warp_affine.launches
        det_before = self.detections
        streams = self._detector_streams() if trace and self.device.type == "cuda" else []
        with Window(trace, self.device) as w:
            t0 = w.t0
            for j, d in enumerate(due):
                k = j % C
                now = time.perf_counter() - t0
                if now >= seconds:
                    break                 # the frames left were never taken up
                if now < d:
                    time.sleep(d - now)
                ts = time.perf_counter()
                with torch.profiler.record_function("portbench.step"):
                    self._step(k)
                te = time.perf_counter()
                lag.append(ts - t0 - d)
                step_s.append(te - ts)
            with torch.profiler.record_function("portbench.flush"):
                for k in range(C):
                    self._take(k, self.server.flush(self.sids[k]))
        self.phase = "after"
        lat_ms = 1000.0 * np.asarray(list(self.server.clip_latencies), np.float64)
        n_windows = len(self.windows) - first_window
        scored_n = lat_ms.size
        lag_ms = 1000.0 * np.asarray(lag)
        missing = max(0, n_windows - scored_n) + self.nonfinite
        return {
            "kind": "live", "t0": t0, "window_s": w.seconds,
            "attempted": n_windows + len(lag), "failed": missing, "missing": missing,
            "windows": n_windows, "windows_scored": int(scored_n),
            "k1_launches": warp.warp_affine.launches - k1_before,
            "detections": self.detections - det_before, "detector_streams": streams,
            "step_ms": 1000.0 * np.asarray(step_s), "frame_lag_ms": lag_ms,
            "latency_ms": lat_ms, "trace": w.trace,
            "e2e": {"frames_per_s": {"value": len(lag) / w.seconds, "unit": "frames/s"}},
        }

    def close(self) -> None:
        self.server.close()
        self._restore()

    def check(self) -> List[Tuple[str, float, float]]:
        """Free the program, recompute a sample of the window's scored
        windows with the reference, and hold the tracked geometry to the
        scene's truth."""
        self.close()
        del self.server, self.scorer
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        # the j-th score of a (call, track) is its j-th enqueued window; a
        # window is checked with the track's window before it
        seen: Dict[Tuple[int, int], int] = {}
        last: Dict[Tuple[int, int], tuple] = {}
        pairs, off_thread = [], False
        for w in self.windows:
            key = (w["call"], w["tid"])
            j = seen.get(key, 0)
            seen[key] = j + 1
            got = self.scores.get(key, [])
            if any(f is None for f in w["frames"]):
                off_thread = True             # a frame pushed off the stepping thread
                last.pop(key, None)
                continue
            if j >= len(got):
                continue
            if w["phase"] == "window" and key in last:
                pairs.append((last[key], (w, got[j])))
            last[key] = (w, got[j])
        rng = np.random.default_rng([self.seed & 0xFFFF_FFFF_FFFF_FFFF, SALT_CHECK])
        pick = [x for pair in stratified_pick(pairs, self.mix["check_pairs"], rng) for x in pair]
        windows, probs, lm_err = [], [], np.inf if off_thread else 0.0
        for w, p in pick:
            k = w["call"]
            scene, frames = self.scenes[k], self.frames[k]
            slots = []
            for t, (_, g) in enumerate(w["frames"]):
                i = pingpong(g, len(frames))
                slot, s = pack_crop(frames[i], w["boxes"][t], self.S, self.device)
                if abs(s - float(w["scale"][t])) > 1e-6:
                    lm_err = np.inf           # the window's scale is not its crop's
                slots.append(slot)
                truth = scene.detect(i)[:, 4:14].reshape(-1, 5, 2)
                pts = w["lm5"][t] + w["boxes"][t][None, :2]
                err = np.linalg.norm(truth - pts[None], axis=2).mean(1).min() / scene.face_px
                lm_err = max(lm_err, float(err))
            windows.append((torch.stack(slots), w["boxes"], w["lm5"], w["scale"]))
            probs.append(p)
        eps = self.cell.config["model"]["bn_eps"]
        ref_logits, ref_feats = logits_and_features(self.params, self.spec, windows, eps,
                                                    self.device)
        d = signed_gaps(np.asarray(probs), ref_logits[:, 0], ref_feats,
                        self.params["head.projection.weight"])
        self.gaps, self.steps = np.abs(d), np.abs(d[1::2] - d[0::2])
        lim = self.cell.limits
        if not pick:
            return [(name, np.inf, lim[name]) for name in ("logit_gap", "step_gap", "landmark_err")]
        return [("logit_gap", float(self.gaps.max()), lim["logit_gap"]),
                ("step_gap", float(self.steps.max()), lim["step_gap"]),
                ("landmark_err", lm_err, lim["landmark_err"])]

