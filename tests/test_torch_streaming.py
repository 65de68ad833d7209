"""The port's serving path (voxelizer, sources, ``StreamingEvaluator``,
``stream_loop``, CLI) against the JAX package's, on the CPU.

The evaluators are compared at float64 (``compute_dtype``), where the two
frameworks' different summation orders cannot flip a spike, so the depth
maps agree to rtol 1e-9 window after window with the state carried.
"""

import dataclasses
import functools
import json
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereospike_tpu.data import voxelizer as jax_vox
from stereospike_tpu.models import factory as jax_factory
from stereospike_tpu.models.stereospike import init_params as jax_init_params
from stereospike_tpu.sources import SyntheticSource as JaxSyntheticSource
from stereospike_tpu.streaming import EventRingBuffer as JaxRingBuffer
from stereospike_tpu.streaming import StreamingEvaluator as JaxEvaluator
from stereospike_tpu.train.config import TrainConfig as JaxTrainConfig
from stereospike_tpu.train.loop import stream_loop as jax_stream_loop
from stereospike_tpu_torch import cli
from stereospike_tpu_torch.data import voxelizer
from stereospike_tpu_torch.interop import params_from_jax
from stereospike_tpu_torch.models import factory
from stereospike_tpu_torch.sources import SyntheticSource
from stereospike_tpu_torch.streaming import EventRingBuffer, StreamingEvaluator
from stereospike_tpu_torch.train.config import TrainConfig
from stereospike_tpu_torch.train.loop import stream_loop

HW = (32, 44)


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _events(n, seed, t_hi=0.05, hw=HW):
    rng = np.random.default_rng(seed)
    return np.stack([
        rng.integers(-2, hw[1] + 2, n).astype(np.float32),
        rng.integers(-2, hw[0] + 2, n).astype(np.float32),
        np.sort(rng.uniform(-0.01, t_hi, n)).astype(np.float32),
        rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32)], axis=1)


def test_ring_buffer_matches_jax():
    ours, theirs = EventRingBuffer(capacity=8), JaxRingBuffer(capacity=8)
    rng = np.random.default_rng(0)
    for n in (6, 4, 0, 12, 3, 7):
        ev = rng.standard_normal((n, 4)).astype(np.float32)
        ours.push(ev)
        theirs.push(ev)
        assert len(ours) == len(theirs) and ours.dropped == theirs.dropped
        if n % 2:
            np.testing.assert_array_equal(ours.pop(), theirs.pop())


def test_synthetic_source_matches_jax():
    kw = dict(hw=HW, eyes=("left", "right"), n_windows=3, events_per_window=500, seed=7)
    for ours, theirs in zip(SyntheticSource(**kw), JaxSyntheticSource(**kw), strict=True):
        assert ours.keys() == theirs.keys()
        for eye in ours:
            np.testing.assert_array_equal(ours[eye], theirs[eye])


@pytest.mark.parametrize("encoding", ["binary", "signed"])
@pytest.mark.parametrize("n_frames", [1, 3])
def test_events_to_frames_matches_jax(encoding, n_frames):
    """Counts with out-of-view coordinates, timestamps outside the window,
    masked rows and both polarity encodings."""
    ev = _events(3000, seed=1)
    valid = np.random.default_rng(2).random(3000) < 0.9
    dt = 0.05 / n_frames
    ours = voxelizer.events_to_frames(torch.from_numpy(ev), torch.from_numpy(valid), 0.0, dt,
                                      n_frames=n_frames, height=HW[0], width=HW[1],
                                      polarity_encoding=encoding)
    theirs = jax_vox.events_to_frames(jnp.asarray(ev), jnp.asarray(valid), jnp.float32(0.0),
                                      jnp.float32(dt), n_frames=n_frames, height=HW[0],
                                      width=HW[1], polarity_encoding=encoding)
    assert ours.dtype == torch.float32 and ours.shape == (n_frames, *HW, 2)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert 0 < float(ours.sum()) < valid.sum()


def test_rectify_events_matches_jax():
    rng = np.random.default_rng(3)
    ev = _events(2000, seed=4)
    x_map = (np.arange(HW[1])[None, :] + rng.normal(0, 2, HW)).astype(np.float32)
    y_map = (np.arange(HW[0])[:, None] + rng.normal(0, 2, HW)).astype(np.float32)
    valid = rng.random(2000) < 0.95
    r, ok = voxelizer.rectify_events(torch.from_numpy(ev), torch.from_numpy(x_map),
                                     torch.from_numpy(y_map), torch.from_numpy(valid),
                                     width=HW[1], height=HW[0])
    jr, jok = jax_vox.rectify_events(jnp.asarray(ev), jnp.asarray(x_map), jnp.asarray(y_map),
                                     jnp.asarray(valid), width=HW[1], height=HW[0])
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))


@pytest.mark.parametrize("name,pipeline,with_maps", [
    ("stereospike", 0, False), ("stereospike_tempo", 1, True)])
def test_streaming_evaluator_matches_jax(name, pipeline, with_maps, x64):
    """Stateful windows (membranes carried), pipelining, rectification and
    the deferred count of events the voxelizer rejected."""
    kw = dict(in_hw=HW, base_channels=8)
    jcfg, tcfg = getattr(jax_factory, name)(**kw), getattr(factory, name)(**kw)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    maps = None
    if with_maps:
        rng = np.random.default_rng(5)
        maps = {e: ((np.arange(HW[1])[None, :] + rng.normal(0, 1.5, HW)).astype(np.float32),
                    (np.arange(HW[0])[:, None] + rng.normal(0, 1.5, HW)).astype(np.float32))
                for e in ("left", "right")}
    common = dict(maps=maps, block=2048, reset_each_window=False, pipeline=pipeline)
    theirs = JaxEvaluator(jparams, jcfg, compute_dtype=jnp.float64, **common)
    ours = StreamingEvaluator(params, tcfg, compute_dtype=torch.float64, device="cpu",
                              **common)
    windows = [{"left": _events(1500, seed=10 + i), "right": _events(1500, seed=20 + i)}
               for i in range(3)]
    got, want = [], []
    for w in windows:
        got.append(ours.push(w))
        want.append(theirs.push(w))
    got.append(ours.flush())
    want.append(theirs.flush())
    assert ours.flush() is None
    got, want = [d for d in got if d is not None], [d for d in want if d is not None]
    assert len(got) == len(want) == 3
    for d, jd in zip(got, want):
        assert d.shape == (*HW, 1) and d.dtype == np.float32
        np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-9, atol=1e-12)
    assert ours.binning_dropped == theirs.binning_dropped > 0
    ours.reset()  # fresh membranes: window 0 gives window 0's depth again
    first = ours.push(windows[0])
    if pipeline:
        first = ours.flush()
    np.testing.assert_array_equal(first, got[0])


def test_binning_dropped_counts_fetched_windows_as_jax():
    """``binning_dropped`` counts a window's rejected events when its depth
    is fetched, as the JAX evaluator does: 0 while the window is in flight
    (``pipeline=2``), 0 after a ``reset()`` that drops the windows in
    flight, and equal once the pipeline is flushed. Counts are integers:
    compared exactly."""
    kw = dict(in_hw=HW, base_channels=8)
    jcfg, tcfg = jax_factory.stereospike(**kw), factory.stereospike(**kw)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    common = dict(block=2048, reset_each_window=False, pipeline=2)
    theirs = JaxEvaluator(jparams, jcfg, **common)
    ours = StreamingEvaluator(params, tcfg, device="cpu", **common)
    window = {"left": _events(1500, seed=30), "right": _events(1500, seed=31)}
    reads = []
    for ev in (ours, theirs):
        ev.push(window)
        mid = ev.binning_dropped
        ev.push(window)
        ev.reset()
        after_reset = ev.binning_dropped
        for _ in range(3):
            ev.push(window)
        while ev.flush() is not None:
            pass
        reads.append((mid, after_reset, ev.binning_dropped))
    assert reads[0] == reads[1]
    assert reads[0][:2] == (0, 0) and reads[0][2] > 0


def test_stream_loop_and_cli(tmp_path, capsys):
    """The port's serving loop returns the JAX loop's result keys, serves
    every window, and the CLI prints that dict."""
    kw = dict(in_hw=HW, checkpoint_dir=str(tmp_path / "jax"))
    want = jax_stream_loop(JaxTrainConfig(tensorboard=False, **kw), synthetic=True,
                           n_windows=2, pipeline=1, events_per_window=300)
    depths = []
    got = stream_loop(TrainConfig(in_hw=HW, checkpoint_dir=str(tmp_path / "torch")),
                      synthetic=True, n_windows=3, pipeline=1, events_per_window=300,
                      device="cpu", depths=depths)
    assert set(got) == set(want)
    assert got["n_windows"] == 3 and len(depths) == 3
    assert all(d.shape == (*HW, 1) and np.isfinite(d).all() for d in depths)
    assert (tmp_path / "torch" / "stream_metrics.jsonl").exists()
    assert cli.main(["stream", "--synthetic", "--n-windows", "2", "--in-hw", "32,44",
                     "--events-per-window", "200", "--device", "cpu",
                     "--checkpoint-dir", str(tmp_path / "cli")]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["n_windows"] == 2 and set(printed) == set(want)


# ---------------------------------------------------------------- n_streams
def _maps(seed):
    rng = np.random.default_rng(seed)
    return {e: ((np.arange(HW[1])[None, :] + rng.normal(0, 1.5, HW)).astype(np.float32),
                (np.arange(HW[0])[:, None] + rng.normal(0, 1.5, HW)).astype(np.float32))
            for e in ("left", "right")}


def test_batched_voxelizer_equals_per_stream():
    """One ``index_add_`` over [S, N, 4] with per-stream bin offsets equals
    the single-stream functions stream by stream."""
    ev = np.stack([_events(1200, seed=30 + s) for s in range(3)])
    valid = np.random.default_rng(33).random((3, 1200)) < 0.9
    x_map, y_map = (torch.from_numpy(m) for m in _maps(34)["left"])
    r, ok = voxelizer.rectify_events(torch.from_numpy(ev), x_map, y_map,
                                     torch.from_numpy(valid), width=HW[1], height=HW[0])
    fr = voxelizer.events_to_frames_batched(r, ok, 0.0, 0.025, n_frames=2, height=HW[0],
                                            width=HW[1])
    assert fr.shape == (3, 2, *HW, 2)
    for s in range(3):
        rs, oks = voxelizer.rectify_events(torch.from_numpy(ev[s]), x_map, y_map,
                                           torch.from_numpy(valid[s]), width=HW[1],
                                           height=HW[0])
        np.testing.assert_array_equal(r[s].numpy(), rs.numpy())
        np.testing.assert_array_equal(ok[s].numpy(), oks.numpy())
        single = voxelizer.events_to_frames(rs, oks, 0.0, 0.025, n_frames=2, height=HW[0],
                                            width=HW[1])
        np.testing.assert_array_equal(fr[s].numpy(), single.numpy())


def test_multi_stream_evaluator_matches_jax(x64):
    """Three cameras in one batched step with maps, pipelining and carried
    membranes, at float64, against the JAX evaluator's vmapped step; one
    stream overflows the block (truncation counted per stream)."""
    kw = dict(in_hw=HW, base_channels=8)
    jcfg, tcfg = jax_factory.stereospike(**kw), factory.stereospike(**kw)
    jparams = jax_init_params(jax.random.PRNGKey(1), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    common = dict(maps=_maps(35), block=1024, reset_each_window=False, pipeline=1,
                  n_streams=3)
    theirs = JaxEvaluator(jparams, jcfg, compute_dtype=jnp.float64, **common)
    ours = StreamingEvaluator(params, tcfg, compute_dtype=torch.float64, device="cpu",
                              **common)
    got, want = [], []
    for i in range(3):
        streams = [{"left": _events(1300 if s == 2 else 900, seed=40 + 10 * i + s),
                    "right": _events(900, seed=70 + 10 * i + s)} for s in range(3)]
        got.append(ours.push(streams))
        want.append(theirs.push(streams))
    got.append(ours.flush())
    want.append(theirs.flush())
    got, want = [d for d in got if d is not None], [d for d in want if d is not None]
    assert len(got) == len(want) == 3
    for d, jd in zip(got, want):
        assert d.shape == (3, *HW, 1) and d.dtype == np.float32
        np.testing.assert_allclose(d, np.asarray(jd), rtol=1e-9, atol=1e-12)
    assert ours.binning_dropped == theirs.binning_dropped > 0
    assert [b.dropped for sb in ours.stream_buffers for b in sb.values()] == \
        [b.dropped for sb in theirs.stream_buffers for b in sb.values()]
    assert ours.stream_buffers[2]["left"].dropped == 3 * 276
    assert ours.buffers is ours.stream_buffers[0]
    assert all(v.shape[0] == 3 and v.dtype == torch.float64 for v in ours._state.values())


def test_multi_stream_shapes_arity_and_per_stream_equality():
    """A list returns [S, H, W, 1] even at S = 1, a dict [H, W, 1]; the JAX
    package's arity errors; stream s of a 2-stream evaluator equals a
    1-stream evaluator fed stream s's windows (float64)."""
    cfg = factory.stereospike(in_hw=HW, base_channels=8)
    params = factory_init(cfg)
    one = StreamingEvaluator(params, cfg, block=1024, device="cpu")
    win = {"left": _events(500, seed=90), "right": _events(500, seed=91)}
    assert one.push([win]).shape == (1, *HW, 1)
    assert one.push(win).shape == (*HW, 1)
    with pytest.raises(ValueError, match=r"got 2 streams, evaluator serves 1"):
        one.push([win, win])
    kw = dict(block=1024, reset_each_window=False, compute_dtype=torch.float64, device="cpu")
    two = StreamingEvaluator(params, cfg, n_streams=2, **kw)
    with pytest.raises(ValueError, match=r"evaluator serves 2 streams; push a list of "
                                         r"per-stream event dicts"):
        two.push(win)
    singles = [StreamingEvaluator(params, cfg, **kw) for _ in range(2)]
    for i in range(2):
        streams = [{"left": _events(600, seed=100 + 4 * i + 2 * s),
                    "right": _events(600, seed=101 + 4 * i + 2 * s)} for s in range(2)]
        both = two.push(streams)
        for s in range(2):
            np.testing.assert_allclose(both[s], singles[s].push(streams[s]), rtol=1e-9,
                                       atol=1e-12)


def factory_init(cfg, seed=0):
    from stereospike_tpu_torch.models.stereospike import init_params

    return init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")


# ------------------------------------------------------ stream_loop sources
TIMEOUT = 5.0
PRODUCER_TIMEOUT = 120.0  # the JAX server compiles its step before the first reply


def _cfg(**kw):
    return TrainConfig(tensorboard=False, in_hw=HW, **kw)


@pytest.fixture()
def narrow(monkeypatch):
    """Both packages' loops build the flagship at base_channels=8 (their
    TrainConfig has no width field)."""
    import stereospike_tpu.train.loop as jax_loop
    import stereospike_tpu_torch.train.loop as loop

    for mod in (loop, jax_loop):
        build = mod.build_model_config
        monkeypatch.setattr(mod, "build_model_config",
                            lambda cfg, build=build: dataclasses.replace(build(cfg),
                                                                         base_channels=8))


@pytest.fixture(scope="module")
def jax_pth(tmp_path_factory):
    """A reference ``.pth`` written by the JAX package's
    ``params_to_torch_state_dict`` from JAX-initialised flagship weights at
    base_channels=8."""
    from stereospike_tpu.interop import params_to_torch_state_dict
    from stereospike_tpu.train.loop import build_model_config as jax_build

    jcfg = dataclasses.replace(jax_build(JaxTrainConfig(in_hw=HW)), base_channels=8)
    sd = params_to_torch_state_dict(jax_init_params(jax.random.PRNGKey(2), jcfg))
    path = tmp_path_factory.mktemp("pth") / "jax.pth"
    torch.save({k: torch.as_tensor(np.array(v)) for k, v in sd.items()}, path)
    return str(path)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stereo_packets(seed, n_windows=6, per_window=1500):
    """Interleaved per-eye packets of float64 rows on an epoch clock."""
    rng = np.random.default_rng(seed)
    out = []
    for eye in (0, 1):
        n = n_windows * per_window
        t = 1.7e9 + np.sort(rng.uniform(0, 0.05 * n_windows, n))
        ev = np.stack([rng.integers(0, HW[1], n), rng.integers(0, HW[0], n), t,
                       rng.integers(0, 2, n)], axis=1).astype(np.float64)
        out.append([(eye, chunk) for chunk in np.array_split(ev, 4 * n_windows)])
    return [p for pair in zip(*out) for p in pair]


def _through_wire(ev):
    """What a ``SocketSource`` rebuilds from ``send_events``' packet."""
    t_base = float(ev[0, 2])
    out = ev.astype(np.float32).astype(np.float64)
    out[:, 2] = (ev[:, 2] - t_base).astype(np.float32).astype(np.float64) + t_base
    return out


def _serve_listen(loop_mod, src_mod, cfg, packets, n_windows, **kw):
    """``stream_loop(listen=..., reply=True)`` in this thread, a producer
    thread sending ``packets`` and reading ``n_windows`` replies."""
    port = _free_port()
    replies, errors = [], []

    def produce():
        try:
            deadline = time.time() + PRODUCER_TIMEOUT
            while True:
                try:
                    sock = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
                    break
                except OSError:
                    if time.time() > deadline:
                        raise
                    time.sleep(0.05)
            with sock:
                sock.settimeout(PRODUCER_TIMEOUT)
                for eye, ev in packets:
                    src_mod.send_events(sock, eye, ev)
                for _ in range(n_windows):
                    replies.append(src_mod.recv_depth(sock))
        except Exception as e:  # surfaced below
            errors.append(e)

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    out = loop_mod.stream_loop(cfg, listen=f"127.0.0.1:{port}", reply=True,
                               n_windows=n_windows, pipeline=1, **kw)
    thread.join(PRODUCER_TIMEOUT)
    assert not thread.is_alive() and not errors, errors
    return out, replies


def test_stream_loop_listen_reply_import_pth_matches_jax(tmp_path, monkeypatch, narrow,
                                                         jax_pth, x64):
    """``--listen --reply --import-pth``: the flagship from a ``.pth`` the
    JAX package wrote serves a loopback SPKE feed; the replies equal the JAX
    loop's (both at float64, where no spike can flip) and a direct
    evaluator's depths on the windows the wire assembles."""
    import stereospike_tpu.sources as jax_sources
    import stereospike_tpu.train.loop as jax_loop
    import stereospike_tpu_torch.sources as sources
    import stereospike_tpu_torch.train.loop as loop

    for mod in (sources, jax_sources):
        monkeypatch.setattr(mod, "SocketSource",
                            functools.partial(mod.SocketSource, timeout=TIMEOUT))
    monkeypatch.setattr(loop, "_compute_dtype", lambda cfg: torch.float64)
    monkeypatch.setattr(jax_loop, "_compute_dtype", lambda cfg: jnp.float64)
    # the windows the wire assembles; the producer stops at the packet that
    # completes window n, so the server reads all it is sent and closes cleanly
    n, windows, packets = 4, [], []
    asm = sources._WindowAssembler(("left", "right"), 0.05)
    for eye, ev in _stereo_packets(3):
        if len(windows) == n:
            break
        packets.append((eye, ev))
        asm.add(("left", "right")[eye], _through_wire(ev))
        while asm.ready():
            windows.append(asm.emit())
    got, replies = _serve_listen(loop, sources, _cfg(
        import_pth=jax_pth, checkpoint_dir=str(tmp_path / "t")), packets, n, device="cpu")
    want, jax_replies = _serve_listen(jax_loop, jax_sources, JaxTrainConfig(
        in_hw=HW, import_pth=jax_pth, tensorboard=False, checkpoint_dir=str(tmp_path / "j")),
        packets, n)
    assert set(got) == set(want)
    for k in ("n_windows", "dropped_events", "binned_out_events", "late_events", "pipeline"):
        assert got[k] == want[k], k
    assert got["n_windows"] == n and len(replies) == n
    # the JAX loop closes the connection at the window bound, before its
    # pipelined tail is replied; the port replies every window served
    jax_replies = [d for d in jax_replies if d is not None]
    assert len(jax_replies) == n - 1
    for d in replies:
        assert d is not None and d.shape == (1, *HW) and np.isfinite(d).all()
    for d, jd in zip(replies, jax_replies):
        np.testing.assert_allclose(d, jd, rtol=1e-6, atol=1e-9)

    pcfg = _cfg(import_pth=jax_pth)
    mcfg = loop.build_model_config(pcfg)
    direct = StreamingEvaluator(loop._load_params(pcfg, mcfg, "best.pt", "cpu"), mcfg,
                                reset_each_window=False, compute_dtype=torch.float64,
                                device="cpu")
    for d, win in zip(replies, windows):
        np.testing.assert_array_equal(d, direct.push(win)[None, ..., 0])


def test_stream_loop_aedat_matches_jax(tmp_path, narrow, jax_pth):
    """``--aedat left,right``: every window of a stereo recording served, the
    JAX loop's result keys and counts, depths equal to a direct evaluator's
    on the source's windows; one path for two eyes is refused."""
    from stereospike_tpu_torch import sources

    rng = np.random.default_rng(9)
    paths = []
    for eye in ("l", "r"):
        n = 6000
        ev = np.stack([rng.integers(0, HW[1], n), rng.integers(0, HW[0], n),
                       3.0 + np.sort(rng.uniform(0, 0.23, n)), rng.integers(0, 2, n)], axis=1)
        paths.append(str(tmp_path / f"{eye}.aedat"))
        sources.write_aedat31(paths[-1], ev.astype(np.float64))
    aedat = ",".join(paths)
    depths = []
    got = stream_loop(_cfg(import_pth=jax_pth,
                                  checkpoint_dir=str(tmp_path / "t")),
                      aedat=aedat, n_windows=0, pipeline=1, device="cpu", depths=depths)
    want = jax_stream_loop(JaxTrainConfig(in_hw=HW, import_pth=jax_pth, tensorboard=False,
                                          checkpoint_dir=str(tmp_path / "j")),
                           aedat=aedat, n_windows=0, pipeline=1)
    assert set(got) == set(want)
    for k in ("n_windows", "dropped_events", "binned_out_events", "late_events"):
        assert got[k] == want[k], k
    assert got["n_windows"] == len(depths) == 5 and got["late_events"] == 0
    from stereospike_tpu_torch.train.loop import _load_params, build_model_config

    cfg = _cfg(import_pth=jax_pth)
    direct = StreamingEvaluator(_load_params(cfg, build_model_config(cfg), "best.pt", "cpu"),
                                build_model_config(cfg), reset_each_window=False,
                                device="cpu")
    windows = list(sources.AedatFileSource(dict(zip(("left", "right"), paths))))
    for d, win in zip(depths, windows, strict=True):
        np.testing.assert_array_equal(d, direct.push(win))
    with pytest.raises(ValueError, match="one AEDAT 3.1 file per eye"):
        stream_loop(_cfg(), aedat=paths[0], device="cpu")


def test_stream_loop_checkpoint_pth_and_refusals(tmp_path, narrow):
    """``--which best.pt`` from a port checkpoint and ``--import-pth`` of the
    same parameters serve the same depths, other than a fresh init's;
    DENSE replay serves the monocular model; the refusals."""
    from stereospike_tpu_torch.data.fixtures import make_dense_fixture
    from stereospike_tpu_torch.train.checkpoint import save_checkpoint
    from stereospike_tpu_torch.train.loop import build_model_config
    from stereospike_tpu_torch.train.state import create_train_state, make_optimizer

    cfg = _cfg(checkpoint_dir=str(tmp_path / "ckpt"))
    params = factory_init(build_model_config(cfg), seed=5)
    save_checkpoint(cfg.checkpoint_dir, create_train_state(params, make_optimizer(1e-4),
                                                       torch.Generator()),
                    best=True)
    torch.save(params, tmp_path / "same.pth")
    runs = {}
    for name, kw in (("which", dict(which="best.pt")),
                     ("pth", dict(which="none.pt")),
                     ("fresh", dict(which="none.pt"))):
        run_cfg = cfg if name != "pth" else _cfg(
            checkpoint_dir=cfg.checkpoint_dir, import_pth=str(tmp_path / "same.pth"))
        runs[name] = []
        stream_loop(run_cfg, synthetic=True, n_windows=2, events_per_window=300,
                    device="cpu", depths=runs[name], **kw)
    for a, b in zip(runs["which"], runs["pth"], strict=True):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(runs["which"][0], runs["fresh"][0])

    make_dense_fixture(str(tmp_path / "dense"), hw=HW, n_maps=3, seed=0)
    out = stream_loop(_cfg(model="stereospike_monocular",
                                  checkpoint_dir=str(tmp_path / "m")),
                      events_dir=str(tmp_path / "dense" / "events" / "data"), device="cpu")
    assert out["n_windows"] == 3 and out["binned_out_events"] == 0
    with pytest.raises(ValueError, match="monocular"):
        stream_loop(_cfg(), events_dir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="--reply needs a --listen"):
        stream_loop(_cfg(), synthetic=True, reply=True, device="cpu")
    with pytest.raises(NotImplementedError, match="cv2"):
        stream_loop(_cfg(), synthetic=True, save_video="x.mp4", device="cpu")
    with pytest.raises(ValueError, match="stateful SNN"):
        stream_loop(_cfg(model="ann"), synthetic=True,
                    device="cpu")
