"""ctypes bindings for the native host library (counterpart of
``stereospike_tpu/native/__init__.py``).

- :func:`area_closing`: grayscale area closing, the GT hole filling of the
  MVSEC pipeline (the reference uses skimage's, ``mvsec_dataset.py:139-141``);
- :func:`rectify_bin_events`: fused host-side event rectification and
  frame binning, with ``out=`` accumulation for a block-streamed build.

The library is the port's own ``host_ops.cpp``, compiled with ``g++`` (or
``$CXX``) at first use into ``build/stereospike_tpu_torch/`` beside the
package, under a name that hashes the source and the flags. A build that
fails raises: there is no silent fallback. The numpy versions
(:func:`_area_closing_py`, :func:`_rectify_bin_events_py`) are the plain
versions the tests hold the library against.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_PACKAGE = Path(__file__).resolve().parents[1]
SOURCE = _PACKAGE / "native" / "host_ops.cpp"
BUILD_DIR = _PACKAGE.parent / "build" / "stereospike_tpu_torch"
# the JAX package's Makefile flags
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")


def _compiler() -> str:
    cxx = os.environ.get("CXX", "g++")
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found (set CXX or put g++ on PATH); "
                           f"the host ops are built from {SOURCE}")
    return found


def library_path() -> Path:
    """Where the library lives; the file name hashes the source and flags."""
    tag = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libhost_ops_{tag[:12]}.so"


def build() -> Path:
    """Compile ``host_ops.cpp`` unless this source was built already.
    Raises on a missing compiler or a failed build."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host_ops build failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    f32 = ctypes.POINTER(ctypes.c_float)
    lib.area_closing_f32.argtypes = [f32, f32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    lib.area_closing_f32.restype = None
    lib.rectify_bin_events_f32.argtypes = [
        f32, ctypes.c_int64, f32, f32, f32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_int32]
    lib.rectify_bin_events_f32.restype = None
    return lib


def _fptr(a: Optional[np.ndarray]):
    return None if a is None else a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def area_closing(img: np.ndarray, area_threshold: int = 24) -> np.ndarray:
    """Fill dark structures with area < ``area_threshold`` (4-connectivity)."""
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim != 2:
        raise ValueError(f"area_closing takes one 2-D image, got shape {img.shape}")
    out = np.empty_like(img)
    _library().area_closing_f32(_fptr(img), _fptr(out), img.shape[0], img.shape[1],
                                area_threshold)
    return out


def _area_closing_py(img: np.ndarray, area_threshold: int) -> np.ndarray:
    """Plain version of :func:`area_closing`: the same Meijster–Wilkinson
    union-find in Python (slow; for the tests)."""
    img = np.ascontiguousarray(img, np.float32)
    h, w = img.shape
    n = h * w
    g = -img.reshape(-1)
    order = np.argsort(-g, kind="stable")
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    # roots hold -area in parent; processedness is read from rank (a -k
    # sentinel would collide with an area-k root)
    parent = np.full(n, -1, np.int64)

    def find_root(p):
        r = p
        while parent[r] >= 0:
            r = parent[r]
        while parent[p] >= 0:
            parent[p], p = r, parent[p]
        return r

    lam = area_threshold
    for i, p in enumerate(order):
        parent[p] = -1
        y, x = divmod(int(p), w)
        for q in (p - w if y > 0 else -1, p + w if y + 1 < h else -1,
                  p - 1 if x > 0 else -1, p + 1 if x + 1 < w else -1):
            if q < 0 or rank[q] > i:
                continue
            r = find_root(q)
            if r == p:
                continue
            if g[r] == g[p] or -parent[r] < lam:
                parent[p] += parent[r]
                parent[r] = p
            else:
                parent[p] = -lam
    out = np.empty(n, np.float32)
    flat = img.reshape(-1)
    for p in order[::-1]:
        out[p] = out[parent[p]] if parent[p] >= 0 else flat[p]
    return out.reshape(h, w)


def _relativized(events: np.ndarray, t0: float):
    """float32 events with t0 removed, and the new t0. float64 input holds
    raw absolute stamps (ROS epoch seconds, where float32 resolves ~128 s):
    the offset is removed at full precision before narrowing."""
    events = np.asarray(events)
    if events.dtype != np.float32:
        ev32 = np.empty(events.shape, np.float32)
        ev32[:, 0] = events[:, 0]
        ev32[:, 1] = events[:, 1]
        ev32[:, 2] = (events[:, 2].astype(np.float64) - float(t0)).astype(np.float32)
        ev32[:, 3] = events[:, 3]
        events, t0 = ev32, 0.0
    return np.ascontiguousarray(events, np.float32), t0


def _frames_buffer(out: Optional[np.ndarray], n_frames: int, height: int,
                   width: int) -> np.ndarray:
    shape = (n_frames, height, width, 2)
    if out is None:
        return np.zeros(shape, np.float32)
    if out.shape != shape or out.dtype != np.float32 or not out.flags["C_CONTIGUOUS"]:
        raise ValueError(f"out must be C-contiguous float32 {shape}")
    return out


def rectify_bin_events(events: np.ndarray, n_frames: int, t0: float, dt: float, *,
                       x_map: Optional[np.ndarray] = None,
                       y_map: Optional[np.ndarray] = None, height: int = 260,
                       width: int = 346, polarity_mode: str = "binary",
                       out: Optional[np.ndarray] = None) -> np.ndarray:
    """Fused rectify+bin of ``events`` [N, 4] (x, y, t, p) → [n_frames, H, W,
    2] float32 counts; frame f covers [t0 + f·dt, t0 + (f+1)·dt).

    ``out``: add into a caller-owned frames buffer instead of a fresh zeroed
    one, the block-streaming primitive (binning is a pure scatter-add, so
    per-block accumulation is exact). ``polarity_mode``: 'binary' (ON p == 1,
    OFF otherwise) or 'signed' (ON p == 1, OFF p == -1, else dropped)."""
    events, t0 = _relativized(events, t0)
    frames = _frames_buffer(out, n_frames, height, width)
    mode = {"binary": 0, "signed": 1}[polarity_mode]
    xm = None if x_map is None else np.ascontiguousarray(x_map, np.float32)
    ym = None if y_map is None else np.ascontiguousarray(y_map, np.float32)
    _library().rectify_bin_events_f32(_fptr(events), events.shape[0], _fptr(xm), _fptr(ym),
                                      _fptr(frames), n_frames, height, width, float(t0),
                                      float(dt), mode)
    return frames


def _rectify_bin_events_py(events: np.ndarray, n_frames: int, t0: float, dt: float, *,
                           x_map: Optional[np.ndarray] = None,
                           y_map: Optional[np.ndarray] = None, height: int = 260,
                           width: int = 346, polarity_mode: str = "binary",
                           out: Optional[np.ndarray] = None) -> np.ndarray:
    """Plain version of :func:`rectify_bin_events` in numpy (for the tests)."""
    events, t0 = _relativized(events, t0)
    frames = _frames_buffer(out, n_frames, height, width)
    x, y, t, p = events[:, 0], events[:, 1], events[:, 2], events[:, 3]
    xi, yi = x.astype(np.int64), y.astype(np.int64)
    ok = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
    if x_map is not None:
        xm = np.asarray(x_map, np.float32)
        ym = np.asarray(y_map, np.float32)
        yc, xc = np.clip(yi, 0, height - 1), np.clip(xi, 0, width - 1)
        xr = np.where(ok, xm[yc, xc], -1)
        yr = np.where(ok, ym[yc, xc], -1)
        ok &= (xr >= 0) & (xr < width) & (yr >= 0) & (yr < height)
        xi, yi = xr.astype(np.int64), yr.astype(np.int64)
    f = np.floor((t.astype(np.float64) - t0) / dt).astype(np.int64)
    ok &= (f >= 0) & (f < n_frames)
    if polarity_mode == "signed":
        ok &= (p == 1) | (p == -1)
    pol = np.where(p == 1, 0, 1)
    idx = ((f * height + yi) * width + xi) * 2 + pol
    np.add.at(frames.reshape(-1), idx[ok], 1.0)
    return frames
