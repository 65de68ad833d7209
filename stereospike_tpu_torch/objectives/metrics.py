"""Depth metrics and label-space conversions (counterpart of
``stereospike_tpu/objectives/metrics.py``).

Ground truth travels as a ``(values, valid_mask)`` pair with static shapes
(the reference encodes invalid pixels as NaN); every reduction is a masked
sum divided by the valid count.

Constants: DISPARITY_MULTIPLIER = 7.0, FOCAL_LENGTH_X_BASELINE
['indoor_flying'] = 19.941772; log depth with Dmax = 10, alpha = 6.
"""

from __future__ import annotations

import torch

DISPARITY_MULTIPLIER = 7.0
FOCAL_LENGTH_X_BASELINE = {"indoor_flying": 19.941772}


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
                     mask: torch.Tensor) -> torch.Tensor:
    """Mean absolute depth residual over valid pixels."""
    maskf = mask.to(predicted.dtype)
    n = maskf.sum()
    total = ((predicted - groundtruth) * maskf).abs().sum()
    return total / torch.clamp(n, min=1.0)
