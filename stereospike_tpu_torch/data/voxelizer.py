"""Device-side event voxelizer (counterpart of ``stereospike_tpu/data/voxelizer.py``):
rectification gather + scatter-add binning.

Events are fixed-size padded ``[N, 4]`` float32 rows (x, y, t, p) with a
validity mask; masked rows scatter into a dump bin that is sliced off, so
nothing depends on the data's size and nothing waits for the host. Frames
are ``[n_frames, H, W, 2]``, channel 0 = ON, channel 1 = OFF. Frame f covers
``[f·dt, (f+1)·dt)`` after the offset ``t0``: the frame index is a floor.

:func:`voxelize_sequence` bins a whole recorded stream on the device (the
MVSEC loader's ``device_voxelize`` build); :func:`relativize_events`
removes the absolute time offset in float64 before anything narrows.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

FRAME_H = 260
FRAME_W = 346


def rectify_events(events: torch.Tensor, x_map: torch.Tensor, y_map: torch.Tensor,
                   valid: Optional[torch.Tensor] = None, *, width: int = FRAME_W,
                   height: int = FRAME_H) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rectify event coordinates through per-camera maps ``[H, W]``.

    ``events`` is ``[N, 4]``, or ``[S, N, 4]`` for S streams of one camera
    (the batched form of the JAX package's vmap over streams). Returns
    (rectified events of the same shape, valid mask ``[..., N]``); events
    that map outside the H×W field of view (strict ``<``) are masked out."""
    x = events[..., 0].to(torch.int32)
    y = events[..., 1].to(torch.int32)
    in_raw = (x >= 0) & (x < width) & (y >= 0) & (y < height)
    xc = x.clamp(0, width - 1).long()
    yc = y.clamp(0, height - 1).long()
    x_rect = x_map[yc, xc]
    y_rect = y_map[yc, xc]
    ok = in_raw & (x_rect >= 0) & (x_rect < width) & (y_rect >= 0) & (y_rect < height)
    if valid is not None:
        ok = ok & valid
    rect = torch.stack([x_rect.to(events.dtype), y_rect.to(events.dtype),
                        events[..., 2], events[..., 3]], dim=-1)
    return rect, ok


def events_to_frames_batched(events: torch.Tensor, valid: torch.Tensor,
                             t0: Union[float, torch.Tensor], dt: Union[float, torch.Tensor], *,
                             n_frames: int, height: int = FRAME_H, width: int = FRAME_W,
                             polarity_encoding: str = "binary") -> torch.Tensor:
    """:func:`events_to_frames` for S streams at once: ``events`` ``[S, N,
    4]`` and ``valid`` ``[S, N]`` → ``[S, n_frames, height, width, 2]``.
    Stream s scatters into its own block of bins (an offset of s times a
    stream's bins), so one ``index_add_`` bins every stream."""
    x = torch.floor(events[..., 0]).long()
    y = torch.floor(events[..., 1]).long()
    t = events[..., 2]
    p = events[..., 3]
    f = torch.floor((t - t0) / dt).long()
    pol = (p != 1).long()
    if polarity_encoding == "binary":
        ok = valid
    elif polarity_encoding == "signed":
        ok = valid & ((p == 1) | (p == -1))
    else:
        raise ValueError(polarity_encoding)
    ok = (ok & (f >= 0) & (f < n_frames) & (x >= 0) & (x < width)
          & (y >= 0) & (y < height))
    streams = events.shape[0]
    n_bins = n_frames * height * width * 2
    offset = torch.arange(streams, device=events.device)[:, None] * n_bins
    flat = ((f * height + y) * width + x) * 2 + pol + offset
    flat = torch.where(ok, flat, torch.full_like(flat, streams * n_bins))  # dump bin
    counts = torch.zeros(streams * n_bins + 1, dtype=torch.float32, device=events.device)
    counts.index_add_(0, flat.reshape(-1), torch.ones_like(t, dtype=torch.float32).reshape(-1))
    return counts[:-1].view(streams, n_frames, height, width, 2)


def events_to_frames(events: torch.Tensor, valid: torch.Tensor,
                     t0: Union[float, torch.Tensor], dt: Union[float, torch.Tensor], *,
                     n_frames: int, height: int = FRAME_H, width: int = FRAME_W,
                     polarity_encoding: str = "binary") -> torch.Tensor:
    """Scatter events ``[N, 4]`` into ``[n_frames, height, width, 2]``
    float32 counts.

    Frame index = floor((t - t0)/dt), computed in float32. ``polarity_encoding``:
    'binary' (ON p == 1, OFF otherwise) or 'signed' (ON p == +1, OFF p == -1,
    p == 0 ignored)."""
    return events_to_frames_batched(events[None], valid[None], t0, dt, n_frames=n_frames,
                                    height=height, width=width,
                                    polarity_encoding=polarity_encoding)[0]


LIDAR_FPS = 20.0  # ground-truth depth maps at 20 Hz (utils.py:9)


def relativize_events(events: np.ndarray,
                      t0: Optional[float] = None) -> Tuple[np.ndarray, float]:
    """Remove the time offset at full precision, then narrow to float32.

    Raw MVSEC timestamps are ROS epoch seconds (~1.5e9), where float32
    resolution is ~128 s: a float32 cast before the offset removal collapses
    a whole sequence into one or two distinct times. Returns (float32
    events with relative times, the new t0 = 0.0)."""
    events = np.asarray(events)
    t0 = float(events[0, 2]) if t0 is None else float(t0)
    out = np.empty(events.shape, np.float32)
    out[:, 0] = events[:, 0]
    out[:, 1] = events[:, 1]
    out[:, 2] = (events[:, 2].astype(np.float64) - t0).astype(np.float32)
    out[:, 3] = events[:, 3]
    return out, 0.0


def voxelize_sequence(events: np.ndarray, n_chunks: int, nfpdm: int = 1, *,
                      x_map: Optional[np.ndarray] = None, y_map: Optional[np.ndarray] = None,
                      height: int = FRAME_H, width: int = FRAME_W, block: int = 1 << 22,
                      polarity_encoding: str = "binary", t0: Optional[float] = None,
                      device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """A whole event stream → ``[n_chunks, nfpdm, H, W, 2]`` count frames,
    binned on ``device``: blocks of ``block`` rows are rectified through
    ``x_map``/``y_map`` (when given) and scatter-added into one buffer on
    the device. ``t0`` defaults to the first event's time; float64 events
    are relativized at full precision first (:func:`relativize_events`)."""
    events = np.asarray(events)
    t0 = float(events[0, 2]) if t0 is None else float(t0)
    if events.dtype != np.float32:
        events, t0 = relativize_events(events, t0)
    n_frames = n_chunks * nfpdm
    # float32 operands, as the JAX package forms the frame index
    t0_d = torch.tensor(t0, dtype=torch.float32, device=device)
    dt_d = torch.tensor(1.0 / (LIDAR_FPS * nfpdm), dtype=torch.float32, device=device)
    maps = None
    if x_map is not None:
        maps = (torch.as_tensor(np.asarray(x_map, np.float32), device=device),
                torch.as_tensor(np.asarray(y_map, np.float32), device=device))
    acc = torch.zeros(n_frames, height, width, 2, dtype=torch.float32, device=device)
    for start in range(0, events.shape[0], block):
        ev = torch.as_tensor(np.ascontiguousarray(events[start:start + block]), device=device)
        valid = torch.ones(ev.shape[0], dtype=torch.bool, device=device)
        if maps is not None:
            ev, valid = rectify_events(ev, maps[0], maps[1], valid, width=width, height=height)
        acc += events_to_frames(ev, valid, t0_d, dt_d, n_frames=n_frames, height=height,
                                width=width, polarity_encoding=polarity_encoding)
    return acc.cpu().numpy().reshape(n_chunks, nfpdm, height, width, 2)
