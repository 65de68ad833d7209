"""Depth metrics and label-space conversions (counterpart of
``stereospike_tpu/objectives/metrics.py``).

Ground truth travels as a ``(values, valid_mask)`` pair with static shapes
(the reference encodes invalid pixels as NaN); every reduction is a masked
sum divided by the valid count.

Constants: DISPARITY_MULTIPLIER = 7.0, FOCAL_LENGTH_X_BASELINE
['indoor_flying'] = 19.941772; log depth with Dmax = 10, alpha = 6.
"""

from __future__ import annotations

from typing import Tuple

import torch

from stereospike_tpu_torch.parallel.collectives import psum

DISPARITY_MULTIPLIER = 7.0
FOCAL_LENGTH_X_BASELINE = {"indoor_flying": 19.941772}


def valid_mask_from_nan(groundtruth: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split NaN-encoded GT (the reference's convention) into (values with
    0 at invalid pixels, boolean valid mask)."""
    mask = ~torch.isnan(groundtruth)
    return torch.where(mask, groundtruth, torch.zeros_like(groundtruth)), mask


def mask_invalid(predicted: torch.Tensor, groundtruth: torch.Tensor,
                 mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero both maps at invalid pixels (the reference's ``mask_dead_pixels``)."""
    return (torch.where(mask, predicted, torch.zeros_like(predicted)),
            torch.where(mask, groundtruth, torch.zeros_like(groundtruth)))


def depth_to_disparity(depth: torch.Tensor, scenario: str = "indoor_flying") -> torch.Tensor:
    return DISPARITY_MULTIPLIER * FOCAL_LENGTH_X_BASELINE[scenario] / (depth + 1e-15)


def disparity_to_depth(disparity: torch.Tensor,
                       scenario: str = "indoor_flying") -> torch.Tensor:
    return DISPARITY_MULTIPLIER * FOCAL_LENGTH_X_BASELINE[scenario] / (disparity + 1e-7)


def lin_to_log_depths(depth_lin: torch.Tensor, Dmax: float = 10.0,
                      alpha: float = 6.0) -> torch.Tensor:
    """Normalized log depth in [0, 1]."""
    d = torch.clamp(depth_lin, 0.0, Dmax) / Dmax
    return torch.clamp(1.0 + torch.log(d) / alpha, 0.0, 1.0)


def log_to_lin_depths(depth_log: torch.Tensor, Dmax: float = 10.0,
                      alpha: float = 6.0) -> torch.Tensor:
    """Inverse of :func:`lin_to_log_depths`."""
    return Dmax * torch.exp(alpha * (depth_log - 1.0))


def convert_to_lin(x: torch.Tensor, learn_on: str) -> torch.Tensor:
    """Map a prediction or label from its learned metric back to linear depth."""
    if learn_on == "LIN":
        return x
    if learn_on == "LOG":
        return log_to_lin_depths(x)
    if learn_on == "DISP":
        return disparity_to_depth(x)
    raise ValueError("learn_on must be 'LIN', 'LOG' or 'DISP'")


def mean_depth_error(predicted: torch.Tensor, groundtruth: torch.Tensor,
                     mask: torch.Tensor, group=None) -> torch.Tensor:
    """Mean absolute depth residual over valid pixels; with a process
    ``group``, over the valid pixels of every rank (the global MDE; one
    all-reduce of the count and the sum)."""
    maskf = mask.to(predicted.dtype)
    n, total = psum(torch.stack([maskf.sum(), ((predicted - groundtruth) * maskf).abs().sum()]),
                    group)
    return total / torch.clamp(n, min=1.0)
