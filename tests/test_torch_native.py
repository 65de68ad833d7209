"""The port's native host library (``stereospike_tpu_torch/native/``)
against the JAX package's and against its own numpy plain versions, on
the CPU.

- ``area_closing``: the port's C++ build against the JAX package's C++
  build and against the port's Python union-find, on images with holes,
  plateaus and NaN-free random levels, at several thresholds: exact.
- ``rectify_bin_events``: binary and signed polarity, with and without
  rectification maps, float64 events at ROS-epoch magnitude (relativized
  at full precision) and float32 events, and the ``out=`` accumulation of
  row blocks against one call over all rows: exact.
- A build without its compiler, or whose compiler fails, raises: there is
  no silent fallback.
"""

import numpy as np
import pytest

from stereospike_tpu.native import area_closing as jax_area_closing
from stereospike_tpu.native import rectify_bin_events as jax_rectify_bin_events
from stereospike_tpu_torch import native

H, W = 30, 44


def _image(seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(1.0, 6.0, (H, W)).astype(np.float32)
    img[rng.random((H, W)) < 0.15] = 0.0                        # holes
    img[5:9, 10:16] = 0.0                                        # one large hole
    img[20:23, 30:33] = 2.5                                      # a plateau
    return img


@pytest.mark.parametrize("threshold", [1, 4, 24, 200])
@pytest.mark.parametrize("seed", [0, 1])
def test_area_closing_matches_jax_and_plain_version(seed, threshold):
    img = _image(seed)
    ours = native.area_closing(img, threshold)
    np.testing.assert_array_equal(ours, jax_area_closing(img, threshold))
    np.testing.assert_array_equal(ours, native._area_closing_py(img, threshold))
    if threshold > 1:
        assert not np.array_equal(ours, img)  # some hole was filled


def _events(n, seed, signed, absolute):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.0, 0.2, n)) + (1.5061e9 if absolute else 0.0)
    pol = rng.choice([-1.0, 1.0, 0.0] if signed else [0.0, 1.0], n)
    ev = np.stack([rng.uniform(-2, W + 2, n), rng.uniform(-2, H + 2, n), t, pol], axis=1)
    return ev if absolute else ev.astype(np.float32)


def _maps(seed):
    rng = np.random.default_rng(seed)
    x_map = np.tile(np.arange(W, dtype=np.float64), (H, 1)) + rng.normal(0, 0.7, (H, W))
    y_map = np.tile(np.arange(H, dtype=np.float64)[:, None], (1, W)) + rng.normal(0, 0.7, (H, W))
    return x_map, y_map


@pytest.mark.parametrize("absolute", [True, False], ids=["float64-epoch", "float32"])
@pytest.mark.parametrize("maps", [True, False], ids=["rectified", "raw"])
@pytest.mark.parametrize("polarity", ["binary", "signed"])
def test_rectify_bin_events_matches_jax_and_plain_version(polarity, maps, absolute):
    ev = _events(5000, 3, polarity == "signed", absolute)
    x_map, y_map = _maps(4) if maps else (None, None)
    t0 = float(ev[0, 2]) if absolute else 0.0
    kw = dict(x_map=x_map, y_map=y_map, height=H, width=W, polarity_mode=polarity)
    ours = native.rectify_bin_events(ev, 8, t0, 0.025, **kw)
    assert ours.shape == (8, H, W, 2) and ours.sum() > 1000
    np.testing.assert_array_equal(ours, jax_rectify_bin_events(ev, 8, t0, 0.025, **kw))
    np.testing.assert_array_equal(ours, native._rectify_bin_events_py(ev, 8, t0, 0.025, **kw))
    # out=: row blocks added into one buffer give the one-call frames
    for binner in (native.rectify_bin_events, native._rectify_bin_events_py):
        out = np.zeros((8, H, W, 2), np.float32)
        for s in range(0, ev.shape[0], 777):
            binner(ev[s:s + 777], 8, t0, 0.025, out=out, **kw)
        np.testing.assert_array_equal(out, ours)
    with pytest.raises(ValueError):
        native.rectify_bin_events(ev, 8, t0, 0.025, out=np.zeros((8, H, W, 2)), **kw)


def test_build_that_cannot_find_its_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "no-such-c++-compiler")
    native._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="not found"):
            native.build()
        with pytest.raises(RuntimeError, match="not found"):
            native.area_closing(_image(0))
        # a compiler that fails raises too, and leaves no library behind
        monkeypatch.setenv("CXX", "false")
        with pytest.raises(RuntimeError, match="build failed"):
            native.build()
        assert not list(tmp_path.iterdir())
    finally:
        native._library.cache_clear()


def test_library_is_built_from_the_ports_own_source():
    lib = native.build()
    assert native.SOURCE.parent.name == "native"
    assert native.SOURCE.parent.parent.name == "stereospike_tpu_torch"
    assert lib.parent == native.BUILD_DIR and lib.exists()
