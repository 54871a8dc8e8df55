"""Device-resident per-track crop rings for the live streaming path.

Port of ``stdd_tpu/runtime/ring.py``. Each frame's crop is uploaded ONCE on
arrival into a per-track ring in device memory, and a window dispatch moves
only kilobytes of geometry: the 32-frame pixel window is an on-device
``index_select`` over the ring. Geometry stays host-side and UNSCALED; each
frame records its own pack scale ``s_t = min(1, S/max_dim)`` and the scorer
folds it into the warp.

Ordering across CUDA streams. A JAX device runs its stream FIFO, so the JAX
ring needed no fences (``stdd_tpu/runtime/ring.py:18-21``); CUDA streams do
not order against each other, so the port restores that contract by hand:

- every operation on a ring's memory — the zero fill, each push (pinned host
  staging → device, then ``index_copy_``) and each window gather — is
  enqueued on the uploader's one side stream, in program order, so a gather
  sees every earlier push and no later push can overwrite a slot before the
  gather has read it;
- each push group and each gather records an event; the consuming stream
  (the one the scorer runs on) waits on the gather's event — which follows
  the ring's latest push — before it touches the window;
- each pinned staging copy is kept alive until its push event completes (the
  host staging array is reused for the next frame, so every group ships
  from a fresh pinned copy);
- a window tensor, allocated on the side stream and read on the consumer
  stream, is marked as used there, so the caching allocator never hands its
  memory to new work while the scorer may still read it.
"""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch


class RingUploader:
    """Host→device pusher shared by every ring of a dispatch group: ships
    each staged group from pinned memory on one side CUDA stream (a single
    stream keeps a ring's pushes in arrival order) and returns without
    waiting. On a CPU device the push is a plain copy."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def submit(self, ring: "DeviceRing", staged: np.ndarray, i0: int, k: int) -> None:
        """Push ``staged[:k]`` into ring positions i0..i0+k-1 (mod R)."""
        if self.stream is None:
            ring.k.push_many(ring.ring, torch.from_numpy(staged[:k].copy()), i0, k)
            return
        host = torch.empty((k,) + ring.k.slot_shape, dtype=torch.uint8, pin_memory=True)
        host.numpy()[:] = staged[:k]
        with torch.cuda.stream(self.stream):
            dev = host.to(self.device, non_blocking=True)
            ring.k.push_many(ring.ring, dev, i0, k)
            event = torch.cuda.Event()
            event.record(self.stream)
        ring._pushed(event, host)


class RingKernels:
    """Push/gather operations shared by every ring of one shape family.
    Pushes are batched: ``push_many`` writes ``k`` consecutive (mod R)
    slots with one ``index_copy_``. Indices are computed on the device, so
    no operation here waits for the host or the host for it."""

    def __init__(self, R: int, S: int, yuv420: bool, device="cuda", batch_k: int = 4):
        self.R, self.S, self.yuv420 = R, S, yuv420
        self.batch_k = batch_k
        self.device = torch.device(device)
        self.slot_shape = (S * 3 // 2, S) if yuv420 else (S, S, 3)
        self._arange = torch.arange(max(R, batch_k), device=self.device)
        if self.device.type == "cuda":
            # the push stream reads it: finish the fill before any push
            torch.cuda.current_stream(self.device).synchronize()

    def push_many(self, ring: torch.Tensor, slots: torch.Tensor, i0: int, k: int) -> None:
        """Write ``slots[:k]`` into positions ``i0 .. i0+k-1 (mod R)``, in place."""
        idx = (self._arange[:k] + i0) % self.R
        ring.index_copy_(0, idx, slots[:k].to(ring.device))

    def window(self, ring: torch.Tensor, head: int, T: int) -> torch.Tensor:
        """The last ``T`` slots ending at ``head``, oldest first."""
        idx = (self._arange[:T] + (head - T + 1)) % self.R
        return ring.index_select(0, idx)

    def window_padded(self, ring: torch.Tensor, head: int, k: int, T: int) -> torch.Tensor:
        """The last ``k`` slots (oldest first), then the newest repeated to
        length ``T`` — the reference's short-window padding (TEST2.py:358-363)."""
        idx = (self._arange[:T].clamp(max=k - 1) + (head - (k - 1))) % self.R
        return ring.index_select(0, idx)

    def empty(self) -> torch.Tensor:
        return torch.zeros((self.R,) + self.slot_shape, dtype=torch.uint8, device=self.device)

    def warmup(self, T: int) -> None:
        ring = self.empty()
        for k in range(1, self.batch_k + 1):
            self.push_many(ring, torch.zeros((k,) + self.slot_shape, dtype=torch.uint8,
                                             device=self.device), 0, k)
        self.window(ring, 0, T)
        self.window_padded(ring, 0, 1, T)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class DeviceRing:
    """One track's device crop ring + host-side geometry rings."""

    def __init__(self, kernels: RingKernels, uploader: Optional[RingUploader] = None):
        self.k = kernels
        self.uploader = uploader
        R = kernels.R
        stream = uploader.stream if uploader is not None else None
        if stream is not None:
            # allocated (and zero-filled) on the push stream: every push is
            # ordered after the fill, and the gather's wait covers it too
            with torch.cuda.stream(stream):
                self.ring = kernels.empty()
        else:
            self.ring = kernels.empty()
        self.boxes = np.zeros((R, 4), np.float32)
        self.lm5 = np.zeros((R, 5, 2), np.float32)
        self.scale = np.ones((R,), np.float32)
        self.head = -1
        self.count = 0
        # host staging: frames pack here and ship as ONE push per batch_k group
        self._staged = np.zeros((kernels.batch_k,) + kernels.slot_shape, np.uint8)
        self._n_staged = 0
        self._rgb_slot = (
            np.zeros((kernels.S, kernels.S, 3), np.uint8) if kernels.yuv420 else None
        )
        # (push event, pinned host copy) until the copy has left the host
        self._inflight: collections.deque = collections.deque()

    def _pushed(self, event, host: torch.Tensor) -> None:
        self._inflight.append((event, host))
        while self._inflight and self._inflight[0][0].query():
            self._inflight.popleft()

    def push(self, crop: np.ndarray, big_box: np.ndarray, lm5: np.ndarray) -> None:
        """Stage one frame's crop (scaled into the S-slot) and record its
        unscaled geometry; ``lm5`` is crop-local, ``big_box`` absolute.
        Every ``batch_k`` frames the staged group ships as one push."""
        from .packing import _encode_slot_yuv420, _pack_entry

        S = self.k.S
        s = min(1.0, S / float(max(crop.shape[0], crop.shape[1])))
        e = dict(crop=crop, big_box=big_box, lm5=lm5)
        slot = self._staged[self._n_staged]
        if self.k.yuv420:
            _encode_slot_yuv420(e, self._rgb_slot, s, slot)
        else:
            slot[:] = 0
            _pack_entry(e, slot, s)
        self._n_staged += 1
        self.head = (self.head + 1) % self.k.R
        self.count += 1
        self.boxes[self.head] = np.asarray(big_box, np.float32)
        self.lm5[self.head] = np.asarray(lm5, np.float32)
        self.scale[self.head] = s
        if self._n_staged == self.k.batch_k:
            self.flush_staged()

    def flush_staged(self) -> None:
        """Ship the staged group."""
        k = self._n_staged
        if not k:
            return
        self._n_staged = 0
        i0 = (self.head - k + 1) % self.k.R
        if self.uploader is not None:
            self.uploader.submit(self, self._staged, i0, k)
        else:
            self.k.push_many(self.ring, torch.from_numpy(self._staged[:k].copy()), i0, k)

    def _gather(self, fn, *args) -> torch.Tensor:
        """Run a window gather behind this ring's pushes and make the
        caller's stream wait for it."""
        stream = self.uploader.stream if self.uploader is not None else None
        if stream is None:
            return fn(self.ring, *args)
        with torch.cuda.stream(stream):
            dev = fn(self.ring, *args)
            event = torch.cuda.Event()
            event.record(stream)
        consumer = torch.cuda.current_stream(self.ring.device)
        consumer.wait_event(event)
        dev.record_stream(consumer)
        return dev

    def window(self, T: int):
        """Snapshot the last ``T`` frames as an on-device gather + host
        geometry, oldest first. Requires ``count >= T``."""
        if self.count < T:
            raise ValueError(f"ring holds {self.count} < {T} frames")
        self.flush_staged()
        dev = self._gather(self.k.window, self.head, T)
        idx = (self.head - T + 1 + np.arange(T)) % self.k.R
        return dev, self.boxes[idx].copy(), self.lm5[idx].copy(), self.scale[idx].copy()

    def window_padded(self, T: int):
        """Provisional sub-stride window for a young track: the last
        ``min(count, T)`` frames padded at the end by repeating the newest
        frame. Requires ``count >= 1``."""
        if self.count < 1:
            raise ValueError("ring is empty")
        k = min(self.count, T)
        self.flush_staged()
        dev = self._gather(self.k.window_padded, self.head, k, T)
        idx = (self.head - (k - 1) + np.minimum(np.arange(T), k - 1)) % self.k.R
        return dev, self.boxes[idx].copy(), self.lm5[idx].copy(), self.scale[idx].copy()
