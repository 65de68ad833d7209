"""Event sources for streaming inference (counterpart of
``stereospike_tpu/sources.py``; this package's own copy, since the port
imports nothing of the JAX package).

A *source* is any iterable yielding per-window event dicts
``{eye: [N, 4] float32}`` with XYTP rows and **window-relative** timestamps
(seconds since the window start — exactly what
:meth:`stereospike_tpu_torch.streaming.StreamingEvaluator.push` consumes).
Four implementations:

* :class:`SyntheticSource` — random windows (smoke tests, latency probes),
  the JAX package's draws.
* :class:`ReplayDirSource` — replays a DENSE-format ``events/data/*.npy``
  directory (reference ``dense_dataset.py`` layout), optionally paced to
  wall-clock real time.
* :class:`AedatFileSource` — replays AEDAT 3.1 recordings (the iniVation
  DAVIS/DVS on-disk format), mono or one-file-per-eye stereo.
* :class:`SocketSource` — a live TCP feed. Event-camera drivers publish
  length-prefixed binary packets (see :data:`PACKET_HEADER`); the source
  assembles them into fixed-duration windows by timestamp, per eye. Run
  the driver-side :func:`send_events` on the machine with the camera and
  point ``stereospike_tpu_torch.cli stream --listen`` at it.

Wire format (little-endian), one packet per ``send_events`` call::

    u32 magic = 0x53504B45 ("SPKE")   u16 version = 1
    u16 eye index (into the source's ``eyes`` tuple)
    u32 n_rows
    f64 t_base — absolute seconds (epoch or camera clock) of the packet
    n_rows × 4 float32 (x, y, dt, p) — dt = t − t_base, monotone per eye

Timestamps reach the assembler as float64 ``t_base + dt``, and stay
float64 until they are window-relative: a float32 *absolute* epoch stamp
has ~128 s resolution (see ``data/voxelizer.py::relativize_events``),
while a float32 offset within a packet or a window is exact to well under
a microsecond. ``send_events`` does the split; only monotonicity matters,
not the epoch.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

PACKET_MAGIC = 0x53504B45  # "SPKE"
PACKET_VERSION = 1
# magic, version, eye, n_rows, t_base (float64 absolute seconds)
PACKET_HEADER = struct.Struct("<IHHId")
# depth reply (server → producer): magic, version, n_streams, h, w, then
# n_streams·h·w float32 row-major depth values
DEPTH_MAGIC = 0x53504B44  # "SPKD"
DEPTH_HEADER = struct.Struct("<IHHII")

Window = Dict[str, np.ndarray]


def send_events(sock: socket.socket, eye: int, events: np.ndarray) -> None:
    """Driver-side helper: publish one packet of [N, 4] XYTP rows.

    Timestamps may be float64 epoch seconds: the packet carries the first
    event's stamp as a float64 base and float32 offsets, so no absolute
    precision is lost on the wire."""
    ev = np.asarray(events, np.float64)
    if ev.ndim != 2 or ev.shape[1] != 4:
        raise ValueError(f"events must be [N, 4] XYTP, got {ev.shape}")
    t_base = float(ev[0, 2]) if ev.shape[0] else 0.0
    wire = ev.astype(np.float32)
    wire[:, 2] = (ev[:, 2] - t_base).astype(np.float32)
    sock.sendall(PACKET_HEADER.pack(PACKET_MAGIC, PACKET_VERSION, eye,
                                    ev.shape[0], t_base)
                 + np.ascontiguousarray(wire).tobytes())


def recv_depth(sock: socket.socket) -> Optional[np.ndarray]:
    """Producer-side helper: read one depth reply → [S, H, W] float32.

    None on end of stream — including a server that died mid-reply (the
    partial packet is unusable; a camera driver's reader loop should just
    stop, not crash)."""
    try:
        hdr = _recv_exact(sock, DEPTH_HEADER.size)
        if hdr is None:
            return None
        magic, version, s, h, w = DEPTH_HEADER.unpack(hdr)
        if magic != DEPTH_MAGIC or version != PACKET_VERSION:
            raise ValueError(f"bad depth header (magic={magic:#x})")
        body = _recv_exact(sock, s * h * w * 4)
    except _Truncated:
        return None
    if body is None:
        return None
    return np.frombuffer(body, np.float32).reshape(s, h, w)


class _Truncated(ConnectionError):
    """Peer closed mid-packet (partial header/body)."""


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly n bytes; None on CLEAN EOF (zero bytes), raises
    :class:`_Truncated` on a partial read — a connection that dies (or was
    never speaking SPKE and sent fewer bytes than a header) must be
    distinguishable from a producer that finished."""
    chunks = []
    want = n
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            if n == want:
                return None
            raise _Truncated(f"peer closed {want - n} bytes into a "
                             f"{want}-byte read")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


class _WindowAssembler:
    """Slice per-eye absolute-timestamp event packets into fixed windows.

    Maintains one pending buffer per eye; a window [t0, t0 + w) is emitted
    (timestamps relativized to t0) once every eye has seen an event at or
    past the window end — or unconditionally on ``flush``. Events that
    arrive with timestamps BEFORE the current window start (late packets,
    e.g. reordered driver threads) are counted in ``late_dropped`` rather
    than silently binned wrong.
    """

    def __init__(self, eyes: Sequence[str], window_s: float):
        self.eyes = tuple(eyes)
        self.window_s = float(window_s)
        self._pending: Dict[str, list] = {e: [] for e in self.eyes}
        self._t0: Optional[float] = None
        self.late_dropped = 0

    def add(self, eye: str, events: np.ndarray) -> None:
        if events.shape[0] == 0:
            return
        ev = np.asarray(events, np.float64)
        if self._t0 is None:
            self._t0 = float(ev[0, 2])
        if ev[-1, 2] < self._t0:
            self.late_dropped += ev.shape[0]
            return
        late = ev[:, 2] < self._t0
        if late.any():
            self.late_dropped += int(late.sum())
            ev = ev[~late]
        self._pending[eye].append(ev)

    def _eye_max_t(self, eye: str) -> float:
        p = self._pending[eye]
        return float(p[-1][-1, 2]) if p else -np.inf

    def ready(self) -> bool:
        """A full window is available on every eye."""
        if self._t0 is None:
            return False
        end = self._t0 + self.window_s
        return all(self._eye_max_t(e) >= end for e in self.eyes)

    def emit(self) -> Window:
        """Pop the oldest window (relativized timestamps); advances t0."""
        assert self._t0 is not None
        end = self._t0 + self.window_s
        out: Window = {}
        for e in self.eyes:
            if self._pending[e]:
                ev = np.concatenate(self._pending[e])
                take = ev[:, 2] < end
                w = ev[take]
                w[:, 2] -= self._t0
                out[e] = w.astype(np.float32)
                rest = ev[~take]
                self._pending[e] = [rest] if rest.shape[0] else []
            else:
                out[e] = np.zeros((0, 4), np.float32)
        self._t0 = end
        return out

    def flush(self) -> Optional[Window]:
        """Emit whatever remains as a final (possibly partial) window."""
        if self._t0 is None or not any(p for p in self._pending.values()):
            return None
        return self.emit()


class SyntheticSource:
    """Random event windows at a fixed rate (smoke tests, latency probes).

    Window i is drawn from ``numpy.random.default_rng(seed + i)`` by the JAX
    package's recipe, so both packages serve the same events."""

    def __init__(self, *, hw: Tuple[int, int], eyes: Sequence[str],
                 n_windows: int, events_per_window: int = 20000,
                 window_s: float = 0.05, seed: int = 0):
        self.hw, self.eyes = hw, tuple(eyes)
        self.n_windows = n_windows
        self.events_per_window = events_per_window
        self.window_s = window_s
        self.seed = seed

    def __iter__(self) -> Iterator[Window]:
        h, w = self.hw
        for i in range(self.n_windows):
            r = np.random.default_rng(self.seed + i)
            n = self.events_per_window
            yield {eye: np.stack([
                r.integers(0, w, n).astype(np.float32),
                r.integers(0, h, n).astype(np.float32),
                np.sort(r.uniform(0, self.window_s, n)).astype(np.float32),
                r.choice([0.0, 1.0], n).astype(np.float32)], axis=1)
                for eye in self.eyes}


class ReplayDirSource:
    """Replay a DENSE-format ``events/data/*.npy`` directory (monocular,
    reference ``dense_dataset.py:60-78`` layout), one file per window.

    ``realtime=True`` paces emission to each window's recorded span — a
    live-camera stand-in for end-to-end latency rehearsal.
    ``window_s`` (derived from the max file span unless given) is exposed
    so the evaluator's bin grid can match the recording cadence.
    """

    def __init__(self, events_dir: str, *, aer_format: str = "TXYP",
                 n_windows: Optional[int] = None, realtime: bool = False,
                 window_s: Optional[float] = None):
        from stereospike_tpu_torch.data.dense import aer_to_xytp

        self._to_xytp = aer_to_xytp
        self.events_dir = events_dir
        self.aer_format = aer_format
        self.realtime = realtime
        files = sorted(f for f in os.listdir(events_dir)
                       if f.endswith(".npy"))
        if not files:
            raise FileNotFoundError(f"no .npy event files in {events_dir}")
        self.files = files[:n_windows] if n_windows else files
        if window_s is None:
            # span needs only the raw time column: memory-map instead of
            # loading+converting every file twice (once here, once on
            # iteration). Column index by AER layout: TXYP → 0, XYTP → 2.
            t_col = 0 if aer_format.upper().startswith("T") else 2
            spans = []
            for f in self.files:
                raw = np.load(os.path.join(events_dir, f), mmap_mode="r")
                spans.append(float(raw[-1, t_col]) - float(raw[0, t_col]))
            # headroom keeps the last event inside the final bin under
            # floor(t/dt) binning (see train/loop.py stream_loop)
            window_s = max(max(spans), 1e-6) * (1 + 1e-6)
        self.window_s = float(window_s)
        self.eyes = ("left",)

    def _load(self, fname: str) -> np.ndarray:
        raw = np.load(os.path.join(self.events_dir, fname))
        return self._to_xytp(raw, self.aer_format).astype(np.float64)

    def __iter__(self) -> Iterator[Window]:
        for f in self.files:
            ev = self._load(f)
            span = float(ev[-1, 2]) - float(ev[0, 2])
            ev[:, 2] -= ev[0, 2]
            if self.realtime:
                time.sleep(span)
            yield {"left": ev.astype(np.float32)}


class SocketSource:
    """Live TCP event feed → fixed-duration windows.

    Listens on ``(host, port)``, accepts ONE producer connection, decodes
    :data:`PACKET_HEADER` packets and yields windows as they complete.
    Ends (StopIteration) when the producer disconnects, after flushing the
    partial tail window. ``late_dropped`` counts events that arrived after
    their window was already emitted (driver reordering) — surfaced instead
    of binned into the wrong window.

    The accept/recv runs in the consumer's thread (one camera, one
    connection — recv is idle-blocking, not compute); a multi-camera
    deployment runs one source per camera and batches via the evaluator's
    ``n_streams``.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 7007, *,
                 eyes: Sequence[str] = ("left", "right"),
                 window_s: float = 0.05, timeout: Optional[float] = 30.0,
                 reconnect: bool = False,
                 _listen_sock: Optional[socket.socket] = None):
        self.eyes = tuple(eyes)
        self.window_s = float(window_s)
        self.timeout = timeout
        # serve-forever mode: when the producer disconnects, flush its tail
        # window, then accept the NEXT producer (fresh clock epoch → fresh
        # assembler) instead of ending iteration. A timed-out re-accept
        # ends iteration cleanly.
        self.reconnect = bool(reconnect)
        if _listen_sock is not None:
            self._srv = _listen_sock
        else:
            self._srv = socket.create_server((host, port))
        self._srv.settimeout(timeout)
        self.late_dropped = 0
        self.bad_packets = 0
        self._conn: Optional[socket.socket] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self._srv.getsockname()[:2]

    def reply(self, depth: np.ndarray) -> None:
        """Send a depth map back to the connected producer over the same
        connection (``[H, W]``, ``[H, W, 1]`` or ``[S, H, W, 1]``); the
        driver side reads it with :func:`recv_depth`. With evaluator
        pipelining the replies lag the event feed by the pipeline depth."""
        if self._conn is None:
            raise RuntimeError("no producer connected")
        d = np.asarray(depth, np.float32)
        if d.ndim == 2:
            d = d[None]
        elif d.ndim == 3 and d.shape[-1] == 1:
            d = d[None, ..., 0]
        elif d.ndim == 4 and d.shape[-1] == 1:
            d = d[..., 0]
        else:
            raise ValueError(f"unexpected depth shape {d.shape}")
        s, h, w = d.shape
        self._conn.sendall(
            DEPTH_HEADER.pack(DEPTH_MAGIC, PACKET_VERSION, s, h, w)
            + np.ascontiguousarray(d).tobytes())

    def _serve_connection(self, conn) -> Iterator[Window]:
        asm = _WindowAssembler(self.eyes, self.window_s)
        late0 = self.late_dropped
        while True:
            try:
                hdr = _recv_exact(conn, PACKET_HEADER.size)
                if hdr is None:
                    break
                magic, version, eye, n_rows, t_base = PACKET_HEADER.unpack(hdr)
                if magic != PACKET_MAGIC or version != PACKET_VERSION:
                    raise ValueError(
                        f"bad packet header (magic={magic:#x}, "
                        f"version={version}) — not a SPKE v1 stream")
                body = _recv_exact(conn, n_rows * 16)
            except _Truncated:
                self.bad_packets += 1
                break  # died mid-packet (or sent < one header of garbage)
            except (socket.timeout, TimeoutError):
                # gone-silent producer: treat like EOF so the tail drain
                # below still emits every fully-buffered window (a stalled
                # eye can leave several) instead of unwinding past it
                self.bad_packets += 1
                break
            if body is None:
                self.bad_packets += 1
                break  # clean EOF where a body belonged
            if eye >= len(self.eyes):
                self.bad_packets += 1
                continue
            ev = np.frombuffer(body, np.float32).reshape(n_rows, 4)
            ev = ev.astype(np.float64)
            ev[:, 2] += t_base  # exact absolute stamps (float64)
            asm.add(self.eyes[eye], ev)
            while asm.ready():
                self.late_dropped = late0 + asm.late_dropped
                yield asm.emit()
        # a stalled eye can leave SEVERAL windows buffered (ready() waits
        # for every eye): drain them all, not just the first
        while True:
            tail = asm.flush()
            self.late_dropped = late0 + asm.late_dropped
            if tail is None:
                break
            yield tail

    def __iter__(self) -> Iterator[Window]:
        first = True
        try:
            while True:
                try:
                    conn, _ = self._srv.accept()
                except (socket.timeout, TimeoutError):
                    if first:
                        raise  # no producer ever showed up: misconfig
                    return     # reconnect mode: served everyone, done
                first = False
                conn.settimeout(self.timeout)
                self._conn = conn
                try:
                    yield from self._serve_connection(conn)
                except (ValueError, socket.timeout, TimeoutError,
                        ConnectionError, OSError):
                    # serve-forever must survive stray connections (port
                    # scanners, health checks) and producers that stall
                    # mid-packet: count, drop the connection, re-accept.
                    # Single-shot mode keeps the loud failure.
                    if not self.reconnect:
                        raise
                    self.bad_packets += 1
                finally:
                    self._conn = None
                    conn.close()
                if not self.reconnect:
                    return
        finally:
            self._srv.close()


# ---------------------------------------------------------------------------
# AEDAT 3.1 — the standard on-disk format of iniVation DAVIS/DVS cameras
# (jAER / cAER / dv recordings). Replaying one closes the last gap between
# the DENSE-dir replay source and a real camera: record with the vendor
# tooling, serve with ``cli stream --aedat``. Format: an ASCII header
# ("#!AER-DAT3.1\r\n" ... "#!END-HEADER\r\n") followed by little-endian
# event packets, each a 28-byte header + eventNumber fixed-size events.
# Polarity events (type 1) are 8 bytes: u32 data word (bit 0 valid, bit 1
# polarity, bits 2-16 y, bits 17-31 x) + i32 timestamp in µs; the packet
# header's eventTSOverflow field carries bits 31+ of the µs clock.
# ---------------------------------------------------------------------------

AEDAT31_MAGIC = b"#!AER-DAT3.1\r\n"
AEDAT31_END_HEADER = b"#!END-HEADER\r\n"
# eventType, eventSource, eventSize, eventTSOffset, eventTSOverflow,
# eventCapacity, eventNumber, eventValid
AEDAT31_PACKET_HEADER = struct.Struct("<hhiiiiii")
AEDAT31_POLARITY_TYPE = 1
_AEDAT31_POLARITY_DTYPE = np.dtype([("data", "<u4"), ("ts", "<i4")])


def aedat31_packets(path: str) -> Iterator[np.ndarray]:
    """Yield one [N, 4] float64 XYTP array (absolute seconds, valid polarity
    events only) per AEDAT 3.1 packet in file order. Non-polarity packets
    (IMU, frames, special events) are skipped; a truncated final packet
    raises — a half-written recording should fail loudly, not serve a
    silently shortened stream."""
    with open(path, "rb") as f:
        first = f.readline()
        if not first.startswith(b"#!AER-DAT3.1"):
            raise ValueError(f"{path} is not an AEDAT 3.1 file "
                             f"(header {first[:20]!r})")
        line = first
        while not line.startswith(b"#!END-HEADER"):
            if not line.startswith(b"#"):
                # a header line that is neither a comment nor the
                # terminator means the file is corrupt — parsing binary
                # packets from here would read from a wrong offset
                raise ValueError(f"{path}: malformed header line "
                                 f"{line[:40]!r} before #!END-HEADER")
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: header never terminated "
                                 "(#!END-HEADER missing)")
        while True:
            hdr = f.read(AEDAT31_PACKET_HEADER.size)
            if not hdr:
                return
            if len(hdr) < AEDAT31_PACKET_HEADER.size:
                raise ValueError(f"{path}: truncated packet header "
                                 f"({len(hdr)} bytes)")
            (etype, _src, esize, _tsoff, tsoverflow,
             _cap, enum_, _evalid) = AEDAT31_PACKET_HEADER.unpack(hdr)
            body = f.read(esize * enum_)
            if len(body) < esize * enum_:
                raise ValueError(f"{path}: truncated packet body "
                                 f"({len(body)}/{esize * enum_} bytes)")
            if etype != AEDAT31_POLARITY_TYPE or enum_ == 0:
                continue
            if esize != _AEDAT31_POLARITY_DTYPE.itemsize:
                raise ValueError(f"{path}: polarity packet with eventSize="
                                 f"{esize}, expected 8")
            ev = np.frombuffer(body, _AEDAT31_POLARITY_DTYPE)
            data = ev["data"]
            keep = (data & 1).astype(bool)  # bit 0: valid
            if not keep.any():
                continue
            data = data[keep]
            # 31-bit µs timestamp + packet-level overflow counter
            t_us = (np.int64(tsoverflow) << 31) | ev["ts"][keep].astype(
                np.int64)
            yield np.stack([
                ((data >> 17) & 0x7FFF).astype(np.float64),   # x
                ((data >> 2) & 0x7FFF).astype(np.float64),    # y
                t_us.astype(np.float64) * 1e-6,               # t (s)
                ((data >> 1) & 1).astype(np.float64),         # polarity
            ], axis=1)


class AedatFileSource:
    """Replay AEDAT 3.1 recordings as fixed-duration windows.

    ``paths``: one file (monocular, served as eye ``"left"``) or an
    ``{eye: path}`` dict for a stereo rig recorded as one file per camera.
    Packets are merged across eyes in timestamp order and sliced into
    ``window_s`` windows by the same :class:`_WindowAssembler` the live TCP
    source uses, so late/reordered driver packets are counted in
    ``late_dropped`` rather than mis-binned. ``realtime=True`` paces
    emission to the recording cadence. The tail partial window is flushed
    at end of file like :class:`SocketSource` does at disconnect.
    """

    def __init__(self, paths, *, window_s: float = 0.05,
                 n_windows: Optional[int] = None, realtime: bool = False):
        if isinstance(paths, (str, os.PathLike)):
            paths = {"left": os.fspath(paths)}
        self.paths: Dict[str, str] = {e: os.fspath(p)
                                      for e, p in paths.items()}
        self.eyes = tuple(self.paths)
        self.window_s = float(window_s)
        self.n_windows = n_windows
        self.realtime = realtime
        self.late_dropped = 0
        for p in self.paths.values():
            if not os.path.exists(p):
                raise FileNotFoundError(p)

    def __iter__(self) -> Iterator[Window]:
        asm = _WindowAssembler(self.eyes, self.window_s)
        streams = {e: aedat31_packets(p) for e, p in self.paths.items()}
        heads: Dict[str, Optional[np.ndarray]] = {}
        for e, it in streams.items():
            heads[e] = next(it, None)
        emitted = 0

        def _drain():
            nonlocal emitted
            while asm.ready():
                self.late_dropped = asm.late_dropped
                if self.realtime:
                    time.sleep(self.window_s)
                yield asm.emit()
                emitted += 1
                if self.n_windows and emitted >= self.n_windows:
                    return

        # merge packets across eyes by start timestamp so the shared
        # window clock (t0 = first event seen) is well-defined for stereo
        while any(h is not None for h in heads.values()):
            eye = min((e for e, h in heads.items() if h is not None),
                      key=lambda e: heads[e][0, 2])
            asm.add(eye, heads[eye])
            heads[eye] = next(streams[eye], None)
            yield from _drain()
            if self.n_windows and emitted >= self.n_windows:
                return
        # a shorter eye can leave SEVERAL buffered windows (ready() waits
        # for every eye): drain them all, like SocketSource at disconnect
        while not (self.n_windows and emitted >= self.n_windows):
            tail = asm.flush()
            self.late_dropped = asm.late_dropped
            if tail is None:
                break
            if self.realtime:  # tail windows pace like the main loop's
                time.sleep(self.window_s)
            yield tail
            emitted += 1


def write_aedat31(path: str, events_xytp: np.ndarray, *,
                  events_per_packet: int = 4096,
                  header_comment: str = "stereospike_tpu writer") -> None:
    """Write [N, 4] XYTP rows (t in float seconds, p in {0,1}) as a valid
    AEDAT 3.1 polarity-event file — the inverse of
    :func:`aedat31_packets`, used to build test fixtures and to export
    synthetic streams for vendor tooling. Timestamps past 2³¹ µs spill
    into the packet header's eventTSOverflow field exactly as cAER does."""
    ev = np.asarray(events_xytp, np.float64)
    if ev.ndim != 2 or ev.shape[1] != 4:
        raise ValueError(f"events must be [N, 4] XYTP, got {ev.shape}")
    t_us = np.round(ev[:, 2] * 1e6).astype(np.int64)
    if ev.size and t_us[0] < 0:
        raise ValueError("timestamps must be non-negative")
    if (np.diff(t_us) < 0).any():
        raise ValueError("timestamps must be monotone non-decreasing")
    # the polarity word carries 15 bits per coordinate: masking would
    # silently corrupt out-of-range (or negative, via the uint cast)
    # coordinates — fail loudly like the timestamp checks above
    for axis, name in ((0, "x"), (1, "y")):
        col = ev[:, axis]
        if col.size and ((col < 0).any() or (col >= 2 ** 15).any()):
            raise ValueError(
                f"{name} coordinates must be in [0, 2^15); got range "
                f"[{col.min():g}, {col.max():g}]")
    data = (np.uint32(1)                                  # valid bit
            | ((ev[:, 3] != 0).astype(np.uint32) << 1)    # polarity
            | ((ev[:, 1].astype(np.uint32) & 0x7FFF) << 2)    # y
            | ((ev[:, 0].astype(np.uint32) & 0x7FFF) << 17))  # x
    with open(path, "wb") as f:
        f.write(AEDAT31_MAGIC)
        # the customary header fields vendor tooling (dv / jAER) expects
        f.write(b"#Format: RAW\r\n")
        f.write(b"#Source 0: " + header_comment.encode() + b"\r\n")
        f.write(b"#" + header_comment.encode() + b"\r\n")
        f.write(AEDAT31_END_HEADER)
        for lo in range(0, ev.shape[0], events_per_packet):
            sl = slice(lo, lo + events_per_packet)
            chunk_t = t_us[sl]
            # one packet may not span an overflow boundary (the header
            # carries a single tsoverflow): split at the wrap if needed
            start = 0
            while start < chunk_t.size:
                over = int(chunk_t[start] >> 31)
                same = np.nonzero((chunk_t[start:] >> 31) != over)[0]
                end = start + (int(same[0]) if same.size else
                               chunk_t.size - start)
                n = end - start
                rec = np.empty(n, _AEDAT31_POLARITY_DTYPE)
                rec["data"] = data[sl][start:end]
                rec["ts"] = (chunk_t[start:end] & 0x7FFFFFFF).astype(
                    np.int32)
                f.write(AEDAT31_PACKET_HEADER.pack(
                    AEDAT31_POLARITY_TYPE, 0,
                    _AEDAT31_POLARITY_DTYPE.itemsize, 4, over, n, n, n))
                f.write(rec.tobytes())
                start = end
