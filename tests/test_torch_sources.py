"""The port's event sources (``stereospike_tpu_torch/sources.py``) against
the JAX package's ``sources.py``, on the CPU: the window assembler, the SPKE
wire format over loopback sockets, the depth replies, AEDAT 3.1 files and
DENSE replay. Windows must be identical array for array.

Every socket here times out within a few seconds and every producer thread
is joined with a timeout, so that a broken server cannot hold a worker.
"""

import socket
import threading

import numpy as np
import pytest

from stereospike_tpu import sources as jax_src
from stereospike_tpu.data.fixtures import make_dense_fixture
from stereospike_tpu_torch import sources as src

TIMEOUT = 5.0
HW = (32, 44)


def _packets(seed, n_packets=40, eyes=2, late=True):
    """Per-eye packets of float64 XYTP rows on an epoch clock, monotone per
    eye, with some eyes lagging (and, if ``late``, some packets reordered
    behind a window already emitted)."""
    rng = np.random.default_rng(seed)
    t = {e: 1.7e9 + rng.uniform(0, 0.01) for e in range(eyes)}
    out = []
    for _ in range(n_packets):
        eye = int(rng.integers(0, eyes))
        n = int(rng.integers(0, 60))
        ts = t[eye] + np.sort(rng.uniform(0, 0.03, n))
        if n:
            t[eye] = float(ts[-1])
        if late and rng.random() < 0.1 and n:
            ts = ts - 0.2  # a reordered driver thread: behind the window clock
        out.append((eye, np.stack([rng.integers(0, HW[1], n), rng.integers(0, HW[0], n), ts,
                                   rng.integers(0, 2, n)], axis=1).astype(np.float64)))
    return out


def _assert_windows_equal(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for wo, wt in zip(ours, theirs):
        assert wo.keys() == wt.keys()
        for eye in wo:
            assert wo[eye].dtype == wt[eye].dtype == np.float32
            np.testing.assert_array_equal(wo[eye], wt[eye])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_assembler_matches_jax(seed):
    eyes = ("left", "right")
    ours, theirs = src._WindowAssembler(eyes, 0.05), jax_src._WindowAssembler(eyes, 0.05)
    got, want = [], []
    for eye, ev in _packets(seed):
        ours.add(eyes[eye], ev)
        theirs.add(eyes[eye], ev)
        while ours.ready():
            got.append(ours.emit())
        while theirs.ready():
            want.append(theirs.emit())
    for asm, out in ((ours, got), (theirs, want)):
        while (tail := asm.flush()) is not None:
            out.append(tail)
    _assert_windows_equal(got, want)
    assert ours.late_dropped == theirs.late_dropped
    assert seed != 0 or ours.late_dropped > 0


def test_spke_packet_and_depth_reply_bytes_match_jax():
    """``send_events``'s header and body, and the depth reply's, byte for byte."""
    ev = _packets(3, n_packets=1, eyes=1, late=False)[0][1]
    wire = []
    for send in (src.send_events, jax_src.send_events):
        a, b = socket.socketpair()
        with a, b:
            b.settimeout(TIMEOUT)
            send(a, 1, ev)
            wire.append(b.recv(1 << 20))
    assert wire[0] == wire[1] and len(wire[0]) == src.PACKET_HEADER.size + 16 * ev.shape[0]
    assert src.PACKET_HEADER.format == jax_src.PACKET_HEADER.format
    assert src.DEPTH_HEADER.format == jax_src.DEPTH_HEADER.format
    assert (src.PACKET_MAGIC, src.DEPTH_MAGIC) == (jax_src.PACKET_MAGIC, jax_src.DEPTH_MAGIC)
    with pytest.raises(ValueError, match="XYTP"):
        src.send_events(None, 0, np.zeros((3, 3)))


def _serve(source_mod, packets, eyes, *, reply=False):
    """One producer thread sends ``packets`` to a fresh ``SocketSource`` of
    ``source_mod`` and, with ``reply``, reads one depth reply per window;
    returns (windows, late_dropped, replies)."""
    srv = source_mod.SocketSource("127.0.0.1", 0, eyes=eyes, window_s=0.05, timeout=TIMEOUT)
    host, port = srv.address
    replies, errors = [], []

    def produce():
        try:
            with socket.create_connection((host, port), timeout=TIMEOUT) as sock:
                for eye, ev in packets:
                    source_mod.send_events(sock, eye, ev)
                if reply:
                    sock.shutdown(socket.SHUT_WR)
                    while (d := source_mod.recv_depth(sock)) is not None:
                        replies.append(d)
        except Exception as e:  # surfaced by the caller
            errors.append(e)

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    windows = []
    for w in srv:
        windows.append(w)
        if reply:
            srv.reply(np.full((2, 3, 1), len(windows), np.float32))
    thread.join(TIMEOUT)
    assert not thread.is_alive() and not errors, errors
    return windows, srv.late_dropped, replies


@pytest.mark.parametrize("eyes", [("left",), ("left", "right")])
def test_socket_source_loopback_matches_jax(eyes):
    """Windows and late counts through the wire, and the depth replies'
    round trip through ``reply`` and ``recv_depth``."""
    packets = _packets(4, eyes=len(eyes))
    got, late, replies = _serve(src, packets, eyes, reply=True)
    want, jax_late, _ = _serve(jax_src, packets, eyes)
    _assert_windows_equal(got, want)
    assert late == jax_late
    assert len(replies) == len(got)
    for i, d in enumerate(replies, start=1):
        assert d.dtype == np.float32 and d.shape == (1, 2, 3) and (d == i).all()


def test_socket_source_refuses_garbage_and_times_out():
    srv = src.SocketSource("127.0.0.1", 0, eyes=("left",), timeout=TIMEOUT)
    with socket.create_connection(srv.address, timeout=TIMEOUT) as sock:
        sock.sendall(b"\xff" * src.PACKET_HEADER.size)
        with pytest.raises(ValueError, match="SPKE"):
            list(srv)
    lonely = src.SocketSource("127.0.0.1", 0, eyes=("left",), timeout=0.2)
    with pytest.raises((socket.timeout, TimeoutError)):
        list(lonely)
    with pytest.raises(RuntimeError, match="no producer"):
        lonely.reply(np.zeros((2, 2, 1), np.float32))


def _events(seed, n=3000, t0=0.0, span=0.32):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, 346, n), rng.integers(0, 260, n),
                     t0 + np.sort(rng.uniform(0, span, n)), rng.integers(0, 2, n)],
                    axis=1).astype(np.float64)


@pytest.mark.parametrize("t0", [0.0, 2147.48])  # the second crosses the 2^31 us wrap
def test_write_aedat31_and_packets_match_jax(tmp_path, t0):
    ev = _events(5, t0=t0)
    ours, theirs = tmp_path / "ours.aedat", tmp_path / "theirs.aedat"
    src.write_aedat31(str(ours), ev, events_per_packet=700)
    jax_src.write_aedat31(str(theirs), ev, events_per_packet=700)
    assert ours.read_bytes() == theirs.read_bytes()
    got = list(src.aedat31_packets(str(ours)))
    want = list(jax_src.aedat31_packets(str(ours)))
    assert len(got) == len(want) >= 5
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(np.concatenate(got)[:, 2], ev[:, 2], atol=5e-7)


@pytest.mark.parametrize("n_windows", [None, 3])
def test_aedat_file_source_matches_jax(tmp_path, n_windows):
    """Stereo, one file per eye, the right eye shorter: merged on one clock,
    the buffered tail drained."""
    paths = {"left": str(tmp_path / "l.aedat"), "right": str(tmp_path / "r.aedat")}
    src.write_aedat31(paths["left"], _events(6, t0=10.0))
    src.write_aedat31(paths["right"], _events(7, t0=10.01, span=0.2))
    ours = src.AedatFileSource(paths, window_s=0.05, n_windows=n_windows)
    theirs = jax_src.AedatFileSource(paths, window_s=0.05, n_windows=n_windows)
    _assert_windows_equal(list(ours), list(theirs))
    assert ours.late_dropped == theirs.late_dropped == 0
    assert ours.eyes == theirs.eyes == ("left", "right")


def test_aedat_refusals_match_jax(tmp_path):
    """Wrong magic, a truncated packet, an unterminated header, a bad
    header line, a missing file; and the writer's own checks."""
    good = tmp_path / "good.aedat"
    src.write_aedat31(str(good), _events(8, n=20))
    raw = good.read_bytes()
    cases = {
        "magic": b"#!AER-DAT2.0\r\n" + b"\0" * 64,
        "truncated": raw[:-5],
        "unterminated": b"#!AER-DAT3.1\r\n#Format: RAW\r\n",
        "header line": b"#!AER-DAT3.1\r\nnot a comment\r\n#!END-HEADER\r\n",
        "short packet header": raw[:raw.index(b"#!END-HEADER\r\n") + 14 + 10],
    }
    for name, data in cases.items():
        path = tmp_path / f"{name.replace(' ', '_')}.aedat"
        path.write_bytes(data)
        errors = []
        for mod in (src, jax_src):
            with pytest.raises(ValueError) as info:
                list(mod.AedatFileSource(str(path)))
            errors.append(str(info.value))
        assert errors[0] == errors[1], name
    with pytest.raises(FileNotFoundError):
        src.AedatFileSource(str(tmp_path / "missing.aedat"))
    for bad in (np.zeros((3, 3)), np.array([[0, 0, 1.0, 1], [0, 0, 0.5, 1]]),
                np.array([[-1.0, 0, 0, 1]]), np.array([[0, 0, -1.0, 1]])):
        with pytest.raises(ValueError):
            src.write_aedat31(str(tmp_path / "bad.aedat"), bad)


@pytest.mark.parametrize("aer_format", ["TXYP", "XYTP"])
def test_replay_dir_source_matches_jax(tmp_path, aer_format):
    make_dense_fixture(str(tmp_path), hw=HW, n_maps=5, seed=1)
    events_dir = tmp_path / "events" / "data"
    if aer_format == "XYTP":  # the same events in the other column order
        for f in events_dir.iterdir():
            a = np.load(f)
            np.save(f, a[:, [1, 2, 0, 3]])
    ours = src.ReplayDirSource(str(events_dir), aer_format=aer_format, n_windows=4)
    theirs = jax_src.ReplayDirSource(str(events_dir), aer_format=aer_format, n_windows=4)
    assert ours.window_s == theirs.window_s and ours.eyes == theirs.eyes == ("left",)
    _assert_windows_equal(list(ours), list(theirs))
    fixed = src.ReplayDirSource(str(events_dir), aer_format=aer_format, window_s=0.04)
    assert fixed.window_s == 0.04 and len(list(fixed)) == 5
    with pytest.raises(FileNotFoundError):
        src.ReplayDirSource(str(tmp_path))
