"""Drivers (counterpart of ``stereospike_tpu/train/loop.py``): the
streaming-serving loop, and the model, parameter and loss set-up that it
and the train step need.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from stereospike_tpu_torch.models import factory as model_factory
from stereospike_tpu_torch.models.stereospike import StereoSpikeConfig, init_params
from stereospike_tpu_torch.objectives.losses import TotalLossConfig
from stereospike_tpu_torch.sources import SyntheticSource
from stereospike_tpu_torch.streaming import StreamingEvaluator, serving_device
from stereospike_tpu_torch.train.config import TrainConfig
from stereospike_tpu_torch.utils.logging import MetricsLogger

Device = Union[str, torch.device]


def _in_channels(cfg: TrainConfig) -> int:
    """Per-step channel count: eyes · (n_inference / n_timesteps) · nfpdm · 2."""
    eyes = 1 if cfg.model == "stereospike_monocular" else 2
    if cfg.n_inference % cfg.n_timesteps:
        raise ValueError(f"n_timesteps={cfg.n_timesteps} must divide "
                         f"n_inference={cfg.n_inference}")
    return eyes * (cfg.n_inference // cfg.n_timesteps) * cfg.nfpdm * 2


def build_model_config(cfg: TrainConfig) -> StereoSpikeConfig:
    """Resolve the model factory and the input channel count."""
    fac = getattr(model_factory, cfg.model)
    kwargs = dict(in_hw=tuple(cfg.in_hw), in_channels=_in_channels(cfg))
    if cfg.multiply_factor is not None:
        kwargs["multiply_factor"] = cfg.multiply_factor
    if cfg.heads is not None:
        if 1 not in cfg.heads or not set(cfg.heads) <= {1, 2, 3, 4}:
            raise ValueError(f"heads={cfg.heads} must be a subset of "
                             "{1,2,3,4} containing 1")
        kwargs["heads"] = tuple(sorted(cfg.heads))
    if cfg.model != "stereospike":
        kwargs.update(tau=cfg.tau, use_plif=cfg.use_plif)
    return fac(**kwargs)


def _loss_config(cfg: TrainConfig) -> TotalLossConfig:
    return TotalLossConfig(alpha=cfg.loss_alpha, scale_weights=tuple(cfg.scale_weights),
                           penalize_spikes=cfg.penalize_spikes, beta=cfg.loss_beta)


def _compute_dtype(cfg: TrainConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _load_params(cfg: TrainConfig, model_cfg: StereoSpikeConfig,
                 device: Device) -> Dict[str, torch.Tensor]:
    """Parameters for an inference loop: fresh init from ``cfg.seed``
    (checkpoint loading is not ported yet)."""
    return init_params(torch.Generator().manual_seed(cfg.seed), model_cfg, device=device)


def stream_loop(cfg: TrainConfig, *, synthetic: bool = False, n_windows: int = 20,
                pipeline: int = 1, events_per_window: int = 20000,
                device: Device = "cuda", depths: Optional[List[np.ndarray]] = None) -> Dict:
    """Streaming-serving driver: feed event windows through the
    :class:`~stereospike_tpu_torch.streaming.StreamingEvaluator`, carrying
    the membrane state across windows, and log per-window latencies.

    Only the ``synthetic`` source is ported. Served depth maps are appended
    to ``depths`` when a list is given. Returns the JAX package's result keys.
    """
    if not synthetic:
        raise ValueError("this port serves --synthetic windows only")
    device = serving_device(device)
    model_cfg = build_model_config(cfg)
    binocular = cfg.model != "stereospike_monocular"
    eyes = ("left", "right") if binocular else ("left",)
    params = _load_params(cfg, model_cfg, device)
    window_s = 0.05  # the MVSEC 20 Hz depth cadence
    source = SyntheticSource(hw=tuple(cfg.in_hw), eyes=eyes, n_windows=n_windows,
                             events_per_window=events_per_window, window_s=window_s,
                             seed=cfg.seed)
    evaluator = StreamingEvaluator(params, model_cfg, eyes=eyes, nfpdm=cfg.nfpdm,
                                   window=window_s, reset_each_window=False,
                                   pipeline=pipeline, compute_dtype=_compute_dtype(cfg),
                                   device=device)

    def served(d: Optional[np.ndarray]) -> int:
        if d is None:
            return 0
        if depths is not None:
            depths.append(d)
        return 1

    lat = []
    n_served = 0
    t_start = time.time()
    for win in source:
        t0 = time.time()
        d = evaluator.push(win)
        lat.append(time.time() - t0)
        n_served += served(d)
    while served(evaluator.flush()):
        n_served += 1
    lat_ms = np.asarray(lat[1:] or lat) * 1e3  # drop the first (warm-up) window

    results = {
        "n_windows": n_served,
        "interval_ms_mean": round(float(lat_ms.mean()), 3) if len(lat_ms) else None,
        "interval_ms_p99": (round(float(np.percentile(lat_ms, 99)), 3)
                            if len(lat_ms) else None),
        "pipeline": pipeline,
        "dropped_events": int(sum(b.dropped for b in evaluator.buffers.values())),
        # events the voxelizer rejected (out-of-window timestamps / view)
        "binned_out_events": int(evaluator.binning_dropped),
        "late_events": 0,    # a socket source's late arrivals; none here
        "video": None,       # video output is not ported
        "total_time_s": round(time.time() - t_start, 3),
    }
    logger = MetricsLogger(cfg.checkpoint_dir, name="stream")
    logger.log(results)
    logger.close()
    return results
