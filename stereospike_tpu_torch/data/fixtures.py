"""Synthetic on-disk dataset fixtures in the MVSEC and DENSE layouts
(counterpart of ``stereospike_tpu/data/fixtures.py``).

:func:`make_mvsec_fixture` writes the MVSEC tree as ``.npy`` files at the
HDF5 dataset paths (``<seq>_gt/davis/left/depth_image_rect.npy``, ...),
which ``data/mvsec.py`` reads without h5py. Its draws are the JAX
fixture's, in the same order from the same ``np.random.default_rng(seed)``,
so its arrays equal, bit for bit, those the JAX fixture writes into its
``.hdf5`` files. :func:`make_dense_fixture` writes the DENSE tree, which is
``.npy`` already.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np


def _smooth_depth_walk(rng, n_depth: int, hw: Tuple[int, int],
                       cell: int = 32) -> np.ndarray:
    """[n_depth, h, w] float32: a slowly-evolving smooth depth field in
    [1.5, 5.5] m — a low-res AR(1) random walk bilinearly upsampled, so
    consecutive frames are correlated (like a flying camera) and the field
    has large-scale structure a conv net can regress."""
    h, w = hw
    gh, gw = h // cell + 2, w // cell + 2
    grid = rng.normal(0, 1, (gh, gw))
    ys = np.linspace(0, gh - 1, h)
    xs = np.linspace(0, gw - 1, w)
    y0 = np.clip(ys.astype(np.int64), 0, gh - 2)
    x0 = np.clip(xs.astype(np.int64), 0, gw - 2)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    out = np.empty((n_depth, h, w), np.float32)
    for k in range(n_depth):
        g00 = grid[y0][:, x0]
        g01 = grid[y0][:, x0 + 1]
        g10 = grid[y0 + 1][:, x0]
        g11 = grid[y0 + 1][:, x0 + 1]
        f = (g00 * (1 - fy) * (1 - fx) + g01 * (1 - fy) * fx
             + g10 * fy * (1 - fx) + g11 * fy * fx)
        lo, hi = f.min(), f.max()
        out[k] = 1.5 + 4.0 * (f - lo) / max(hi - lo, 1e-6)
        grid = 0.92 * grid + 0.39 * rng.normal(0, 1, (gh, gw))
    return out


def _save_tree(stem: str, arrays: Dict[str, np.ndarray]) -> None:
    """``arrays`` keyed by HDF5 dataset path → ``<stem>/<path>.npy``."""
    for key, a in arrays.items():
        path = os.path.join(stem, *key.split("/")) + ".npy"
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, a)


def make_mvsec_fixture(
    root: str,
    *,
    scenario: str = "indoor_flying",
    sequences: Tuple[str, ...] = ("1", "2", "3"),
    n_depth: int = 24,
    n_events: int = 20000,
    hw: Tuple[int, int] = (260, 346),
    seed: int = 0,
    rect_jitter: float = 0.5,
    t_offset: float = 1.5061e9,
    warmup_chunks: int = 1,
    train_chunks: int = 1,
    learnable: bool = False,
) -> Dict:
    """Write ``<root>/<scenario>/...`` (``.npy`` trees and the calibration
    maps); return mini split tables (the loader's ``tables=`` override).

    With ``learnable=True`` the scene is self-consistent instead of noise:
    depth is a smooth, temporally correlated field, per-frame event density
    scales with inverse depth, and the right camera sees the left's events
    shifted by a disparity ∝ 1/depth, so the count frames carry the depth
    signal and training can drive the MDE below the predict-the-mean floor.
    Timestamps sit at ROS-epoch magnitude (``t_offset`` ≈ 1.5e9 s), as real
    MVSEC stamps do, so the loaders' float64 offset removal is exercised."""
    h, w = hw
    rng = np.random.default_rng(seed)
    scen_dir = os.path.join(root, scenario)
    calib_dir = os.path.join(scen_dir, f"{scenario}_calib")
    os.makedirs(calib_dir, exist_ok=True)

    for side in ("left", "right"):
        x_map = np.tile(np.arange(w, dtype=np.float64), (h, 1)) + \
            rng.normal(0, rect_jitter, (h, w))
        y_map = np.tile(np.arange(h, dtype=np.float64)[:, None], (1, w)) + \
            rng.normal(0, rect_jitter, (h, w))
        np.savetxt(os.path.join(calib_dir, f"{scenario}_{side}_x_map.txt"), x_map)
        np.savetxt(os.path.join(calib_dir, f"{scenario}_{side}_y_map.txt"), y_map)

    for seq in sequences:
        name = f"{scenario}{seq}"
        ts = t_offset + np.arange(n_depth) / 20.0
        if learnable:
            depth = _smooth_depth_walk(rng, n_depth, (h, w))
        else:
            depth = rng.uniform(1.0, 6.0, (n_depth, h, w)).astype(np.float32)
        clean_depth = depth.copy()
        # small holes (zeros) and some NaNs, as in the real GT
        holes = rng.random((n_depth, h, w)) < 0.02
        depth[holes] = 0.0
        depth[rng.random((n_depth, h, w)) < 0.01] = np.nan
        _save_tree(os.path.join(scen_dir, f"{name}_gt"),
                   {"davis/left/depth_image_rect": depth,
                    "davis/left/depth_image_rect_ts": ts})

        if learnable:
            # event density ∝ 1/depth² per 50 ms window; the right camera is
            # the left shifted by a disparity ∝ 1/depth
            m = max(n_events // n_depth, 16)
            lx, ly, lt, rx = [], [], [], []
            for k in range(n_depth):
                inv2 = (1.0 / clean_depth[k].reshape(-1)) ** 2
                idx = rng.choice(h * w, size=m, p=inv2 / inv2.sum())
                yy, xx = idx // w, idx % w
                lx.append(xx.astype(np.float64))
                ly.append(yy.astype(np.float64))
                lt.append(np.sort(rng.uniform(ts[k] - 0.05, ts[k], m)))
                disp = 30.0 / clean_depth[k].reshape(-1)[idx]
                rx.append(np.clip(xx - disp, 0, w - 1))
            lx, ly, lt, rx = map(np.concatenate, (lx, ly, lt, rx))
            pol = rng.choice([0.0, 1.0], lx.size)
            side_ev = {"left": np.stack([lx, ly, lt, pol], axis=1),
                       "right": np.stack([rx, ly, lt, pol], axis=1)}

        events = {}
        for side in ("left", "right"):
            if learnable:
                ev = side_ev[side]
            else:
                ev_t = np.sort(rng.uniform(ts[0] - 0.3, ts[-1] + 0.1, n_events))
                ev = np.stack([
                    rng.integers(0, w, n_events).astype(np.float64),
                    rng.integers(0, h, n_events).astype(np.float64),
                    ev_t,
                    rng.choice([0.0, 1.0], n_events),
                ], axis=1)
            events[f"davis/{side}/events"] = ev
        _save_tree(os.path.join(scen_dir, f"{name}_data"), events)

    n_samples = n_depth - (warmup_chunks + train_chunks)
    tables = {
        "frame_ranges": {scenario: {
            f"split{s}": {f"{scenario}{q}": [0, n_depth] for q in sequences}
            for s in ("1", "2", "3")
        }},
        "splits": {
            "1": {"train_sequences": ["2", "3"], "valtest_sequence": "1",
                  "valid_indices": list(range(0, n_samples, 3)),
                  "test_indices": list(range(1, n_samples, 3))},
        },
    }
    with open(os.path.join(root, "mini_splits.json"), "w") as f:
        json.dump(tables, f)
    return tables


def make_dense_fixture(
    root: str,
    *,
    n_maps: int = 6,
    n_events: int = 3000,
    hw: Tuple[int, int] = (260, 346),
    fps: int = 30,
    seed: int = 0,
) -> None:
    """Write a DENSE-format tree: per-window .npy AER (TXYP, signed
    polarity) + per-window depth .npy (dense_dataset.py:100-131)."""
    h, w = hw
    rng = np.random.default_rng(seed)
    ev_dir = os.path.join(root, "events", "data")
    d_dir = os.path.join(root, "depth", "data")
    os.makedirs(ev_dir, exist_ok=True)
    os.makedirs(d_dir, exist_ok=True)
    for i in range(n_maps):
        t0 = i / fps
        t = np.sort(rng.uniform(t0, t0 + 1.0 / fps, n_events))
        aer = np.stack([
            t,
            rng.integers(0, w, n_events).astype(np.float64),
            rng.integers(0, h, n_events).astype(np.float64),
            rng.choice([-1.0, 1.0], n_events),
        ], axis=1)
        np.save(os.path.join(ev_dir, f"events_{i:06d}.npy"), aer)
        np.save(os.path.join(d_dir, f"depth_{i:06d}.npy"),
                rng.uniform(1.0, 9.0, (h, w)).astype(np.float32))
