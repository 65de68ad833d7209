"""The port's serving path (voxelizer, sources, ``StreamingEvaluator``,
``stream_loop``, CLI) against the JAX package's, on the CPU.

The evaluators are compared at float64 (``compute_dtype``), where the two
frameworks' different summation orders cannot flip a spike, so the depth
maps agree to rtol 1e-9 window after window with the state carried.
"""

import json

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
