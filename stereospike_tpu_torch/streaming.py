"""Streaming inference: stateful depth from live event streams
(counterpart of ``stereospike_tpu/streaming.py``).

Raw AER events are pushed into fixed-capacity host ring buffers as they
arrive. Every window (50 ms, the ground-truth cadence) the buffered events
are padded to a fixed block with a valid mask, uploaded, voxelized on the
device and fed through one step of the StereoSpike forward, which carries
the membrane state across windows when ``reset_each_window=False``. That
per-window computation is one function of tensors, :class:`ServingStep`
``(state, events, valids) -> (depth, new_state, rejected)``, which
``push`` calls and ``deploy.export_serving_artifact`` exports. The device
work of a window is queued without waiting for the host; with
``pipeline=N`` the depth map comes back N windows later, so its copy to
the host overlaps the next windows' compute.

``n_streams=S`` serves S cameras in one batched step: per-stream ring
buffers and membranes, one voxelizer pass over ``[S, block, 4]`` per eye,
the forward at B = S.

Typical use::

    ev = StreamingEvaluator(params, model_cfg)            # device="cuda"
    for window in camera:                 # dict eye -> [N, 4] (x, y, t, p)
        depth = ev.push(window)           # [H, W, 1] depth map
"""

from __future__ import annotations

import collections
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from stereospike_tpu_torch.data.voxelizer import events_to_frames_batched, rectify_events
from stereospike_tpu_torch.models.stereospike import (
    FireFn,
    StereoSpikeConfig,
    State,
    forward,
    init_state,
)
from stereospike_tpu_torch.snn.cuda_kernels import multistep_fire


def serving_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a ``torch.device``; raises for CUDA without a card,
    since serving never falls back to the CPU by itself."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"serving on {device} needs a CUDA device; "
                           "pass device='cpu' to serve on the CPU")
    return device


class EventRingBuffer:
    """Fixed-capacity host ring buffer for one AER stream ([N, 4] rows).

    Overwrites the oldest events when full (a live camera must never block
    the producer); ``pop()`` drains the current contents in arrival order.
    """

    def __init__(self, capacity: int = 1 << 20):
        self._buf = np.zeros((capacity, 4), np.float32)
        self._capacity = capacity
        self._head = 0          # next write position
        self._size = 0
        self.dropped = 0        # total overwritten rows (observability)

    def __len__(self) -> int:
        return self._size

    def push(self, events: np.ndarray) -> None:
        events = np.asarray(events, np.float32)
        n = events.shape[0]
        if n == 0:
            return
        if n >= self._capacity:  # keep only the newest capacity rows
            self.dropped += self._size + n - self._capacity
            self._buf[:] = events[-self._capacity:]
            self._head, self._size = 0, self._capacity
            return
        end = self._head + n
        if end <= self._capacity:
            self._buf[self._head:end] = events
        else:
            k = self._capacity - self._head
            self._buf[self._head:] = events[:k]
            self._buf[:end - self._capacity] = events[k:]
        self.dropped += max(0, self._size + n - self._capacity)
        self._size = min(self._size + n, self._capacity)
        self._head = end % self._capacity

    def pop(self) -> np.ndarray:
        """Drain all buffered events in arrival order."""
        start = (self._head - self._size) % self._capacity
        end = start + self._size
        if end <= self._capacity:
            out = self._buf[start:end].copy()
        else:
            out = np.concatenate([self._buf[start:], self._buf[:end - self._capacity]])
        self._size = 0
        return out


class ServingStep(torch.nn.Module):
    """One window's device work as a function of tensors, the JAX
    evaluator's jitted step: ``(state, events, valids) -> (depth [S, H, W,
    1] float32, new_state, rejected)``.

    ``events`` is ``{eye: float32 [S, block, 4]}`` (x, y, window-relative
    t, p; zero-padded), ``valids`` ``{eye: bool [S, block]}``; ``state``
    the membranes at B = S in the compute dtype. Each eye is rectified
    (when it has maps) and binned for all S streams at once; ``rejected``
    counts the valid rows that no bin took (timestamp outside [0, window),
    out of view before or after rectification), as a float32 scalar. The
    weights and maps are plain tensor attributes, so ``torch.export`` bakes
    them into the program as constants."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: StereoSpikeConfig, *,
                 eyes: Tuple[str, ...], nfpdm: int, window: float,
                 maps: Dict[str, Optional[Tuple[torch.Tensor, torch.Tensor]]],
                 compute_dtype: torch.dtype, fire_fn: FireFn = multistep_fire):
        super().__init__()
        self.params = params
        self.cfg = cfg
        self.eyes = eyes
        self.nfpdm = nfpdm
        self.dt = window / nfpdm
        self.maps = maps
        self.compute_dtype = compute_dtype
        self.fire_fn = fire_fn

    def forward(self, state: State, events: Dict[str, torch.Tensor],
                valids: Dict[str, torch.Tensor]):
        h, w = self.cfg.in_hw
        frames = []
        rejected = None
        for e in self.eyes:
            ev, ok = events[e], valids[e]
            if self.maps[e] is not None:
                ev, ok = rectify_events(ev, *self.maps[e], ok, width=w, height=h)
            fr = events_to_frames_batched(ev, ok, 0.0, self.dt, n_frames=self.nfpdm,
                                          height=h, width=w)
            # every binned event adds one count, so the gap to the valid input
            # rows (before rectification: out-of-view rejects must count) is
            # what the window silently rejected
            dropped = valids[e].sum() - fr.sum()
            rejected = dropped if rejected is None else rejected + dropped
            # [S, nfpdm, H, W, 2] -> [S, H, W, nfpdm*2] (frame, polarity) stacking
            frames.append(fr.permute(0, 2, 3, 1, 4).reshape(fr.shape[0], h, w, -1))
        frame = torch.cat(frames, dim=-1).to(self.compute_dtype)  # [S, H, W, C]
        depths, _, new_state = forward(self.params, frame, self.cfg, state,
                                       fire_fn=self.fire_fn)
        return depths[0].float(), new_state, rejected


class _Pending:
    """A window's depth [S, H, W, 1] on its way to the host."""

    def __init__(self, depth: torch.Tensor, stacked: bool, rejected: torch.Tensor):
        self.rejected = rejected  # the window's voxelizer-rejected count, on the device
        if depth.is_cuda:
            self.host = torch.empty(depth.shape, dtype=depth.dtype, pin_memory=True)
            self.host.copy_(depth, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record()
        else:
            self.host, self.done = depth, None
        self.stacked = stacked

    def result(self) -> np.ndarray:
        """[S, H, W, 1] for a list input (even at S = 1), [H, W, 1] for a dict."""
        if self.done is not None:
            self.done.synchronize()
        return self.host.numpy() if self.stacked else self.host[0].numpy()


class StreamingEvaluator:
    """Stateful serving evaluator: events in, depth maps out.

    ``maps``: optional per-eye rectification maps ``{eye: (x_map, y_map)}``.
    ``eyes`` orders the input channel blocks (left then right, the training
    layout). Event timestamps must be window-relative (seconds since the
    window start).

    ``n_streams > 1`` serves that many independent cameras in one batched
    device step (per-stream ring buffers ``stream_buffers[s][eye]`` and
    membranes; ``buffers`` is stream 0's). ``push`` then takes a list of
    per-stream event dicts and returns ``[n_streams, H, W, 1]``.

    The window runs in ``compute_dtype`` (float32 when None): the parameters
    are cast once, here, and the membrane state lives in that dtype. Depths
    come back as float32 either way.
    ``device`` defaults to ``cuda`` and raises if there is no card: serving
    never falls back to the CPU by itself. ``fire_fn`` replaces the fused
    fire kernel (its plain version, for a comparison run).
    :meth:`from_artifact` serves an exported ``.ssx`` artifact instead.
    """

    def __init__(self, params: Dict[str, torch.Tensor], cfg: StereoSpikeConfig, *,
                 maps: Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]] = None,
                 eyes: Tuple[str, ...] = ("left", "right"), nfpdm: int = 1,
                 window: float = 0.05, block: int = 1 << 16,
                 reset_each_window: bool = True, buffer_capacity: int = 1 << 20,
                 pipeline: int = 0, n_streams: int = 1,
                 compute_dtype: Optional[torch.dtype] = None,
                 device: Union[str, torch.device] = "cuda",
                 fire_fn: FireFn = multistep_fire):
        if len(eyes) * nfpdm * 2 != cfg.in_channels:
            raise ValueError(
                f"{len(eyes)} eyes x nfpdm={nfpdm} gives {len(eyes) * nfpdm * 2} "
                f"channels; model expects {cfg.in_channels}")
        self.device = serving_device(device)
        self.artifact = None
        self.cfg = cfg.for_inference()
        self.compute_dtype = compute_dtype or torch.float32
        self.params = {k: (v.to(self.device, self.compute_dtype) if v.is_floating_point()
                           else v.to(self.device)) for k, v in params.items()}
        self._maps = {e: tuple(torch.as_tensor(np.asarray(m), dtype=torch.float32,
                                               device=self.device) for m in maps[e])
                      if maps and e in maps else None for e in eyes}
        self.step = ServingStep(self.params, self.cfg, eyes=tuple(eyes), nfpdm=nfpdm,
                                window=window, maps=self._maps,
                                compute_dtype=self.compute_dtype, fire_fn=fire_fn)
        self._serve(eyes, nfpdm, window, block, reset_each_window, buffer_capacity, pipeline,
                    n_streams)

    def _serve(self, eyes: Sequence[str], nfpdm: int, window: float, block: int,
               reset_each_window: bool, buffer_capacity: int, pipeline: int,
               n_streams: int) -> None:
        """The runtime plumbing around ``self.step``, shared with
        :meth:`from_artifact`."""
        self.eyes = tuple(eyes)
        self.nfpdm = int(nfpdm)
        self.window = float(window)
        self.block = int(block)
        self.reset_each_window = reset_each_window
        self.pipeline = int(pipeline)
        self.n_streams = int(n_streams)
        # events the voxelizer rejected (timestamp outside [0, window), or
        # out of view after rectification), summed on the device and read
        # only when ``binning_dropped`` is: a read per window would wait for
        # the device on the latency-critical path
        self._host_binning_dropped = 0
        self._drop_acc: Optional[torch.Tensor] = None
        self._pending: Deque[_Pending] = collections.deque()
        self.stream_buffers = [{e: EventRingBuffer(buffer_capacity) for e in self.eyes}
                               for _ in range(self.n_streams)]
        self.buffers = self.stream_buffers[0]  # the single-stream alias
        self._state = self.init_state()

    @classmethod
    def from_artifact(cls, path: str, *, buffer_capacity: int = 1 << 20, pipeline: int = 0,
                      reset_each_window: bool = True) -> "StreamingEvaluator":
        """Serve from an exported ``.ssx`` artifact (:mod:`deploy`) instead of
        live params: the whole window step (rectification, voxelizer,
        stateful forward, weights) is the artifact's exported program, and
        its geometry (eyes, window, block, streams) comes from the
        manifest; this class supplies the ring buffers, padding, uploads,
        pipelining and drop accounting."""
        from stereospike_tpu_torch.deploy import load_serving_artifact

        art = load_serving_artifact(path)
        m = art.meta
        self = cls.__new__(cls)
        self.artifact = art
        self.cfg = self.params = None  # geometry comes from the manifest
        self.device = art.device
        self.compute_dtype = art.compute_dtype
        self.step = art.step
        self._serve(m["eyes"], m["nfpdm"], m["window_s"], m["block"], reset_each_window,
                    buffer_capacity, pipeline, m["n_streams"])
        return self

    def init_state(self) -> State:
        """Zero membranes for ``n_streams`` streams."""
        if self.artifact is not None:
            return self.artifact.init_state()
        return init_state(self.cfg, self.n_streams, self.compute_dtype, device=self.device)

    def reset(self) -> None:
        """Zero the membranes and drop the windows in flight, their depths
        and their rejected counts with them."""
        self._state = self.init_state()
        self._pending.clear()

    def _upload(self, raws: List[np.ndarray]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each stream's rows padded/truncated to ``block`` (keeping the
        newest) with its valid mask, as ``[S, block, 4]`` and ``[S, block]``,
        copied to the device without waiting for queued work."""
        pin = self.device.type == "cuda"
        host = torch.zeros(len(raws), self.block, 4, dtype=torch.float32, pin_memory=pin)
        valid = torch.zeros(len(raws), self.block, dtype=torch.bool, pin_memory=pin)
        for s, raw in enumerate(raws):
            n = min(raw.shape[0], self.block)
            if n:
                host[s, :n] = torch.from_numpy(raw[-n:])
                valid[s, :n] = True
        return (host.to(self.device, non_blocking=True),
                valid.to(self.device, non_blocking=True))

    @property
    def binning_dropped(self) -> int:
        """Total voxelizer-rejected events so far (one deferred device read)."""
        if self._drop_acc is not None:
            self._host_binning_dropped += int(round(float(self._drop_acc)))
            self._drop_acc = None
        return self._host_binning_dropped

    @torch.no_grad()
    def push(self, window_events: Union[Dict[str, np.ndarray], Sequence[Dict[str, np.ndarray]]]
             ) -> Optional[np.ndarray]:
        """Feed one window's events per eye; returns a depth map.

        A dict input returns ``[H, W, 1]`` (one stream only); a list of
        ``n_streams`` per-stream dicts returns ``[n_streams, H, W, 1]``, even
        at one stream. Each eye's events are padded/truncated to ``block``
        rows (truncation keeps the newest and is counted in
        ``stream_buffers[s][eye].dropped``). With ``pipeline=0`` the
        returned depth is this window's. With ``pipeline=N >= 1`` up to N
        windows stay in flight and the oldest finished depth is returned
        once the pipeline is full (``None`` for the first N pushes;
        :meth:`flush` drains the tail).
        """
        single = isinstance(window_events, dict)
        streams = [window_events] if single else list(window_events)
        if single and self.n_streams != 1:
            raise ValueError(f"evaluator serves {self.n_streams} streams; push a list of "
                             "per-stream event dicts")
        if len(streams) != self.n_streams:
            raise ValueError(f"got {len(streams)} streams, evaluator serves {self.n_streams}")
        events, valids = {}, {}
        for e in self.eyes:
            raws = []
            for s, win in enumerate(streams):
                buf = self.stream_buffers[s][e]
                buf.push(win.get(e, np.zeros((0, 4), np.float32)))
                raw = buf.pop()
                if raw.shape[0] > self.block:
                    buf.dropped += raw.shape[0] - self.block
                raws.append(raw)
            events[e], valids[e] = self._upload(raws)
        state = self.init_state() if self.reset_each_window else self._state
        depth, self._state, rejected = self.step(state, events, valids)
        pending = _Pending(depth, not single, rejected)
        if not self.pipeline:
            return self._fetch(pending)
        self._pending.append(pending)
        if len(self._pending) > self.pipeline:
            return self._fetch(self._pending.popleft())
        return None

    def _fetch(self, pending: _Pending) -> np.ndarray:
        """A window's depth on the host; its rejected events count from
        here on, as in the JAX evaluator: a window still in flight, or
        dropped by :meth:`reset`, has not been counted."""
        self._drop_acc = (pending.rejected if self._drop_acc is None
                          else self._drop_acc + pending.rejected)
        return pending.result()

    def flush(self) -> Optional[np.ndarray]:
        """Pipelined mode: the oldest in-flight depth (shaped as its push's
        input asked), or ``None`` when drained."""
        if not self._pending:
            return None
        return self._fetch(self._pending.popleft())
