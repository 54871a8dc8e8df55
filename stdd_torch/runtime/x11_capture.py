"""Linux screen / window capture over the raw X11 wire protocol.

The reference's capture layer is Windows-only: ``test/win_capture.py:18``
(``_capture_hwnd`` — PrintWindow/BitBlt window grabs), ``:42``
(``iter_window_frames`` — paced window capture), ``:121``
(``iter_teams_frames`` — find-by-title → largest visible window → grab,
re-finding the window when it dies), plus ``test/capture_tile.py:147``
(mss full-screen grabs feeding the largest-tile picker). This module is the
Linux analogue with the same capture semantics — title-substring match,
largest viewable window wins, paced iteration with periodic re-find — built
as a zero-dependency X11 client speaking the wire protocol directly over the
display socket (no libX11 / python-xlib / mss needed).

Only the tiny request subset capture needs is implemented: connection
handshake (with MIT-MAGIC-COOKIE-1 from ``~/.Xauthority``), GetGeometry,
GetImage(ZPixmap), QueryTree, InternAtom, GetProperty and
GetWindowAttributes. Pixel decode honours the server's image-byte-order,
pixmap-format bits-per-pixel/scanline-pad and the root visual's RGB masks,
so BGR frames come out correct on non-standard servers too.

Frames are BGR uint8 ``[H, W, 3]`` — the same contract as every other
source in :mod:`stdd_torch.runtime.sources`. The port's own copy of
``stdd_tpu/runtime/x11_capture.py``, unchanged but for this sentence.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

# -- X11 request opcodes (X Window System Protocol, ch. 9) --
_OP_GET_WINDOW_ATTRIBUTES = 3
_OP_GET_GEOMETRY = 14
_OP_QUERY_TREE = 15
_OP_INTERN_ATOM = 16
_OP_GET_PROPERTY = 20
_OP_GET_IMAGE = 73

_ZPIXMAP = 2
_MAP_STATE_VIEWABLE = 2
_ANY_PROPERTY_TYPE = 0


def _pad4(n: int) -> int:
    return (4 - (n % 4)) % 4


def parse_display(display: Optional[str] = None) -> Tuple[Optional[str], int, int]:
    """``[host]:display[.screen]`` → (host-or-None-for-unix, display, screen)."""
    d = display if display is not None else os.environ.get("DISPLAY", "")
    if not d or ":" not in d:
        raise ValueError(f"invalid DISPLAY {d!r}")
    host, _, rest = d.rpartition(":")
    num_s, _, screen_s = rest.partition(".")
    num = int(num_s) if num_s else 0
    screen = int(screen_s) if screen_s else 0
    if host in ("", "unix"):
        return None, num, screen
    return host, num, screen


def _read_xauthority(display_num: int) -> bytes:
    """MIT-MAGIC-COOKIE-1 for this display from $XAUTHORITY / ~/.Xauthority
    (big-endian length-prefixed records). Empty bytes if none found."""
    path = os.environ.get("XAUTHORITY") or os.path.expanduser("~/.Xauthority")
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return b""
    pos, want = 0, str(display_num).encode()

    def field() -> bytes:
        nonlocal pos
        (n,) = struct.unpack_from(">H", raw, pos)
        pos += 2
        v = raw[pos : pos + n]
        pos += n
        return v

    while pos + 2 <= len(raw):
        try:
            pos += 2  # family
            field()  # address
            number = field()
            name = field()
            data = field()
        except struct.error:
            break
        if name == b"MIT-MAGIC-COOKIE-1" and number in (b"", want):
            return data
    return b""


class X11Error(RuntimeError):
    pass


class _Visual:
    __slots__ = ("visual_id", "red_mask", "green_mask", "blue_mask")

    def __init__(self, visual_id: int, red: int, green: int, blue: int):
        self.visual_id = visual_id
        self.red_mask, self.green_mask, self.blue_mask = red, green, blue


class X11Connection:
    """Synchronous single-user X11 client connection.

    ``sock`` may be injected (tests run against an in-process mock server);
    otherwise the display string decides unix-socket vs TCP transport.
    """

    def __init__(self, display: Optional[str] = None, sock: Optional[socket.socket] = None):
        host, num, screen_idx = (None, 0, 0) if sock is not None else parse_display(display)
        if sock is None:
            if host is None:
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                sock.connect(f"/tmp/.X11-unix/X{num}")
            else:
                sock = socket.create_connection((host, 6000 + num))
        self._sock = sock
        self._seq = 0
        self._atoms: dict = {}
        self._handshake(_read_xauthority(num), screen_idx)

    # -- transport --

    def _send(self, data: bytes) -> None:
        self._sock.sendall(data)

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise X11Error("X server closed the connection")
            buf += chunk
        return buf

    def _handshake(self, cookie: bytes, screen_idx: int) -> None:
        name = b"MIT-MAGIC-COOKIE-1" if cookie else b""
        req = struct.pack("<BxHHHHxx", ord("l"), 11, 0, len(name), len(cookie))
        req += name + b"\0" * _pad4(len(name)) + cookie + b"\0" * _pad4(len(cookie))
        self._send(req)
        head = self._recv_exact(8)
        status = head[0]
        (extra,) = struct.unpack_from("<H", head, 6)
        body = self._recv_exact(extra * 4)
        if status != 1:
            reason = body[: head[1]].decode("latin-1", "replace") if status == 0 else "authenticate"
            raise X11Error(f"X11 connection refused: {reason}")
        self._parse_setup(body, screen_idx)

    def _parse_setup(self, b: bytes, screen_idx: int) -> None:
        self.resource_id_base, self.resource_id_mask = struct.unpack_from("<II", b, 4)
        self._next_rid = 0
        (vendor_len,) = struct.unpack_from("<H", b, 16)
        n_formats = b[21]
        self.image_byte_order = b[22]  # 0 = LSB-first, 1 = MSB-first
        pos = 32 + vendor_len + _pad4(vendor_len)
        self._formats = {}  # depth -> (bits_per_pixel, scanline_pad)
        for _ in range(n_formats):
            depth, bpp, pad = struct.unpack_from("<BBB", b, pos)
            self._formats[depth] = (bpp, pad)
            pos += 8
        n_screens = b[20]
        if screen_idx >= n_screens:
            raise X11Error(f"screen {screen_idx} out of range ({n_screens} screens)")
        self._visuals = {}
        for s in range(n_screens):
            root, _cmap, _white, _black, _masks, w, h = struct.unpack_from("<IIIIIHH", b, pos)
            root_visual = struct.unpack_from("<I", b, pos + 32)[0]
            root_depth = b[pos + 38]
            n_depths = b[pos + 39]
            pos += 40
            for _ in range(n_depths):
                (nv,) = struct.unpack_from("<H", b, pos + 2)
                pos += 8
                for _ in range(nv):
                    vid, _cls, _bits, _ents, rm, gm, bm = struct.unpack_from("<IBBHIII", b, pos)
                    self._visuals[vid] = _Visual(vid, rm, gm, bm)
                    pos += 24
            if s == screen_idx:
                self.root = root
                self.root_visual = root_visual
                self.root_depth = root_depth
                self.screen_size = (w, h)

    def alloc_resource_id(self) -> int:
        """Next client resource id (XID) from the setup-assigned range.

        Capture itself never creates server resources; this exists so
        integration tests can create/draw real windows through the same
        connection (tests/test_x11_xvfb.py against a live Xvfb)."""
        shift = (self.resource_id_mask & -self.resource_id_mask).bit_length() - 1
        rid = self.resource_id_base | ((self._next_rid << shift) & self.resource_id_mask)
        self._next_rid += 1
        return rid

    # -- request/reply plumbing --

    def _request(self, opcode: int, data_byte: int, body: bytes) -> int:
        total = 4 + len(body)
        assert total % 4 == 0
        self._send(struct.pack("<BBH", opcode, data_byte, total // 4) + body)
        self._seq = (self._seq + 1) & 0xFFFF
        return self._seq

    def _reply(self, seq: int) -> bytes:
        """Wait for the reply to `seq`; raise on X errors, skip events."""
        while True:
            head = self._recv_exact(32)
            kind = head[0]
            (got_seq,) = struct.unpack_from("<H", head, 2)
            if kind == 0:
                raise X11Error(f"X error code={head[1]} seq={got_seq} major={head[10]}")
            if kind == 1:
                (extra,) = struct.unpack_from("<I", head, 4)
                tail = self._recv_exact(extra * 4) if extra else b""
                if got_seq == seq & 0xFFFF:
                    return head + tail
                continue  # stale reply (we are strictly synchronous; drop)
            # else: event — irrelevant to capture, drop it

    # -- protocol calls --

    def get_geometry(self, drawable: int) -> Tuple[int, int, int, int, int]:
        """(x, y, width, height, depth)."""
        r = self._reply(self._request(_OP_GET_GEOMETRY, 0, struct.pack("<I", drawable)))
        x, y, w, h = struct.unpack_from("<hhHH", r, 12)
        return x, y, w, h, r[1]

    def get_window_attributes_map_state(self, window: int) -> int:
        r = self._reply(self._request(_OP_GET_WINDOW_ATTRIBUTES, 0, struct.pack("<I", window)))
        return r[26]

    def query_tree(self, window: int) -> List[int]:
        r = self._reply(self._request(_OP_QUERY_TREE, 0, struct.pack("<I", window)))
        (n,) = struct.unpack_from("<H", r, 16)
        return list(struct.unpack_from(f"<{n}I", r, 32))

    def intern_atom(self, name: str) -> int:
        if name in self._atoms:
            return self._atoms[name]
        nb = name.encode()
        body = struct.pack("<H2x", len(nb)) + nb + b"\0" * _pad4(len(nb))
        r = self._reply(self._request(_OP_INTERN_ATOM, 1, body))  # only_if_exists
        (atom,) = struct.unpack_from("<I", r, 8)
        self._atoms[name] = atom
        return atom

    def get_property(self, window: int, prop: int, max_words: int = 1 << 16) -> Tuple[int, bytes]:
        """(format, raw value bytes); format 0 means property absent."""
        if prop == 0:
            return 0, b""
        body = struct.pack("<IIIII", window, prop, _ANY_PROPERTY_TYPE, 0, max_words)
        r = self._reply(self._request(_OP_GET_PROPERTY, 0, body))
        fmt = r[1]
        (n_items,) = struct.unpack_from("<I", r, 16)
        nbytes = n_items * (fmt // 8)
        return fmt, r[32 : 32 + nbytes]

    def window_title(self, window: int) -> str:
        """_NET_WM_NAME (UTF-8) falling back to WM_NAME, like the reference's
        GetWindowText (win_capture.py:81)."""
        for atom_name in ("_NET_WM_NAME", "WM_NAME"):
            try:
                fmt, val = self.get_property(window, self.intern_atom(atom_name))
            except X11Error:
                continue
            if fmt == 8 and val:
                return val.decode("utf-8", "replace")
        return ""

    def get_image(self, drawable: int, x: int, y: int, w: int, h: int) -> np.ndarray:
        """Grab a rectangle as BGR uint8 [h, w, 3] (ZPixmap GetImage)."""
        if w <= 0 or h <= 0:
            raise X11Error(f"empty capture rect {w}x{h}")
        body = struct.pack("<IhhHHI", drawable, x, y, w, h, 0xFFFFFFFF)
        r = self._reply(self._request(_OP_GET_IMAGE, _ZPIXMAP, body))
        depth = r[1]
        (visual_id,) = struct.unpack_from("<I", r, 8)
        return self._decode_zpixmap(r[32:], w, h, depth, visual_id or self.root_visual)

    def _decode_zpixmap(self, data: bytes, w: int, h: int, depth: int, visual_id: int) -> np.ndarray:
        bpp, scan_pad = self._formats.get(depth, (32, 32))
        stride = ((w * bpp + scan_pad - 1) // scan_pad) * scan_pad // 8
        rows = np.frombuffer(data[: stride * h], np.uint8).reshape(h, stride)
        px_bytes = bpp // 8
        if bpp not in (24, 32):
            raise X11Error(f"unsupported bits-per-pixel {bpp}")
        raw = rows[:, : w * px_bytes].reshape(h, w, px_bytes)
        if px_bytes == 3:
            raw = np.concatenate([raw, np.zeros((h, w, 1), np.uint8)], axis=-1)
        order = "<u4" if self.image_byte_order == 0 else ">u4"
        if self.image_byte_order != 0 and px_bytes == 3:
            raw = raw[:, :, [3, 0, 1, 2]]  # re-align 24bpp MSB pixels into 32-bit words
        pix = np.ascontiguousarray(raw).view(order).reshape(h, w).astype(np.uint32)
        vis = self._visuals.get(visual_id) or _Visual(0, 0xFF0000, 0xFF00, 0xFF)

        def chan(mask: int) -> np.ndarray:
            if mask == 0:
                return np.zeros((h, w), np.uint8)
            shift = (mask & -mask).bit_length() - 1
            width = (mask >> shift).bit_length()
            v = (pix & np.uint32(mask)) >> np.uint32(shift)
            if width < 8:  # scale up narrow channels (e.g. 5/6-bit)
                v = (v * 255) // ((1 << width) - 1)
            return v.astype(np.uint8)

        return np.stack([chan(vis.blue_mask), chan(vis.green_mask), chan(vis.red_mask)], axis=-1)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "X11Connection":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def list_windows(conn: X11Connection) -> List[Tuple[int, str, Tuple[int, int, int, int]]]:
    """All viewable windows (one QueryTree level deep — where WMs parent
    client windows) as (id, title, (x, y, w, h))."""
    out = []
    stack = [(conn.root, 0)]
    while stack:
        wid, lvl = stack.pop()
        for child in conn.query_tree(wid):
            try:
                if conn.get_window_attributes_map_state(child) != _MAP_STATE_VIEWABLE:
                    continue
                title = conn.window_title(child)
                x, y, w, h, _ = conn.get_geometry(child)
            except X11Error:
                continue
            out.append((child, title, (x, y, w, h)))
            if lvl == 0:
                stack.append((child, 1))
    return out


def find_window_by_title(conn: X11Connection, substrings: Sequence[str],
                         min_area: int = 200 * 200) -> int:
    """Largest viewable window whose title contains any substring — the
    reference's Teams-window heuristic (win_capture.py:121 _find_teams_hwnd:
    visible, title match, area > 200², largest wins)."""
    best, best_area = None, 0
    for wid, title, (_, _, w, h) in list_windows(conn):
        if title and any(s in title for s in substrings):
            area = w * h
            if area > min_area and area > best_area:
                best, best_area = wid, area
    if best is None:
        raise X11Error(f"no viewable window matching {list(substrings)!r}")
    return best


def iter_screen_frames(
    display: Optional[str] = None,
    window_title: Optional[Sequence[str]] = None,
    region: Optional[Tuple[int, int, int, int]] = None,
    target_hz: float = 8.0,
    refresh_every: int = 120,
    max_frames: Optional[int] = None,
    min_area: int = 200 * 200,
    conn_factory: Optional[Callable[[], X11Connection]] = None,
) -> Iterator[np.ndarray]:
    """Paced BGR frames from an X11 screen region or a window found by title.

    Mirrors the reference's pacing + lifecycle (win_capture.py:42
    iter_window_frames: absolute-clock pacing against drift; :121
    iter_teams_frames: re-find the window on grab failure and every
    ``refresh_every`` frames).
    """
    conn = conn_factory() if conn_factory is not None else X11Connection(display)
    titles = list(window_title) if window_title else None
    try:
        wid = find_window_by_title(conn, titles, min_area=min_area) if titles else conn.root
        if region is not None:
            rx, ry, rw, rh = region
        dt = 1.0 / max(0.1, float(target_hz))
        t0 = time.perf_counter()
        k = 0
        grab_failures = 0
        while max_frames is None or k < max_frames:
            try:
                if region is not None and not titles:
                    frame = conn.get_image(wid, rx, ry, rw, rh)
                else:
                    _, _, w, h, _ = conn.get_geometry(wid)
                    frame = conn.get_image(wid, 0, 0, w, h)
                    if region is not None:  # region within the found window
                        frame = frame[ry : ry + rh, rx : rx + rw]
            except X11Error:
                # re-find once and retry; a second consecutive failure
                # propagates (win_capture.py:126-130) — a persistently
                # failing grab (e.g. BadMatch on an off-screen window) must
                # not become a silent 100%-CPU retry spin
                if not titles or grab_failures:
                    raise
                grab_failures += 1
                wid = find_window_by_title(conn, titles, min_area=min_area)
                continue
            grab_failures = 0
            yield frame
            k += 1
            if titles and refresh_every and k % refresh_every == 0:
                try:
                    wid = find_window_by_title(conn, titles, min_area=min_area)
                except X11Error:
                    pass  # keep the old id until it actually fails
            sleep = dt * k - (time.perf_counter() - t0)
            if sleep > 0:
                time.sleep(sleep)
    finally:
        conn.close()
