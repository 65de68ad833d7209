"""Training losses (counterpart of ``stereospike_tpu/objectives/losses.py``):
multiscale scale-invariant + Sobel gradient matching, with optional spike
penalization.

Invalid ground-truth pixels are a boolean mask, every reduction is a
masked sum over static shapes, and the per-scale GT rescale is a
mask-aware bilinear resize (the identity for the flagship, whose four
heads all predict at full resolution). Maps are NHWC [B, H, W, 1], as in
the JAX package. With n the number of valid pixels and res = (pred − gt)
zeroed at invalid pixels:

- scale-invariant:    Σ res² / n  −  (Σ res)² / n²
- gradient matching:  Σ (|∂x res| + |∂y res|)·mask / n, 3×3 Sobel filters
  as a cross-correlation, stride 1, zero padding 1
- spike penalization: Σ_tensors Σ s² / (2·numel)
- total: SI + α·GM (+ β·SP), defaults α = 0.5, scale weights (1, 1, 1, 1),
  β = 1
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from stereospike_tpu_torch.nn.layers import bilinear_resize


def _masked_residual(predicted: torch.Tensor, groundtruth: torch.Tensor,
                     mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    maskf = mask.to(predicted.dtype)
    n = torch.clamp(maskf.sum(), min=1.0)
    res = (predicted - groundtruth) * maskf
    return res, maskf, n


def scale_invariant_loss(predicted: torch.Tensor, groundtruth: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Masked scale-invariant MSE."""
    res, _, n = _masked_residual(predicted, groundtruth, mask)
    mse = (res * res).sum() / n
    quad = torch.square(res.sum()) / (n * n)
    return mse - quad


def _sobel(res: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sobel x/y of [B, H, W, 1] maps by padded shifts (zero padding 1,
    cross-correlation orientation), in the JAX package's order of sums."""
    h, w = res.shape[1], res.shape[2]
    z = F.pad(res, (0, 0, 1, 1, 1, 1))

    def sh(dy: int, dx: int) -> torch.Tensor:
        return z[:, 1 + dy:h + 1 + dy, 1 + dx:w + 1 + dx]

    left = sh(-1, -1) + 2 * sh(0, -1) + sh(1, -1)
    right = sh(-1, 1) + 2 * sh(0, 1) + sh(1, 1)
    top = sh(-1, -1) + 2 * sh(-1, 0) + sh(-1, 1)
    bot = sh(1, -1) + 2 * sh(1, 0) + sh(1, 1)
    return left - right, top - bot


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with the JAX package's derivative at 0: +1 (``jnp.abs``
    differentiates as ``x >= 0 ? 1 : -1``), where ``torch.abs`` gives 0.
    The two differ wherever a Sobel response is exactly 0 at a valid pixel,
    as on a GT that is flat along a row near the border."""
    return torch.where(x >= 0, x, -x)


def gradient_matching_loss(predicted: torch.Tensor, groundtruth: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Masked Sobel gradient-matching L1."""
    res, maskf, n = _masked_residual(predicted, groundtruth, mask)
    gx, gy = _sobel(res)
    return ((_abs(gx) + _abs(gy)) * maskf).sum() / n


def resize_groundtruth(groundtruth: torch.Tensor, mask: torch.Tensor,
                       size: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask-aware bilinear GT rescale: values = bilinear(gt·mask), valid =
    bilinear(mask) == 1 (full valid support; the reference interpolates
    NaN-laden GT, which marks the same pixels invalid)."""
    if tuple(groundtruth.shape[1:3]) == tuple(size):
        return groundtruth, mask
    maskf = mask.to(groundtruth.dtype)
    vals = bilinear_resize(groundtruth * maskf, size, align_corners=False)
    cover = bilinear_resize(maskf, size, align_corners=False)
    return vals, cover >= 1.0 - 1e-6


def _multiscale(loss_fn, predicted: Sequence[torch.Tensor], groundtruth: torch.Tensor,
                mask: torch.Tensor, factors: Optional[Sequence[float]]) -> torch.Tensor:
    factors = (1.0,) * len(predicted) if factors is None else factors
    total = 0.0
    for f, p in zip(factors, predicted):
        gt_s, m_s = resize_groundtruth(groundtruth, mask, tuple(p.shape[1:3]))
        total = total + f * loss_fn(p, gt_s, m_s)
    return total


def multiscale_scale_invariant_loss(predicted: Sequence[torch.Tensor],
                                    groundtruth: torch.Tensor, mask: torch.Tensor,
                                    factors: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Σ_scales factor · SI(pred_s, resize(gt))."""
    return _multiscale(scale_invariant_loss, predicted, groundtruth, mask, factors)


def multiscale_gradient_matching_loss(predicted: Sequence[torch.Tensor],
                                      groundtruth: torch.Tensor, mask: torch.Tensor,
                                      factors: Optional[Sequence[float]] = None
                                      ) -> torch.Tensor:
    """Σ_scales factor · GM(pred_s, resize(gt))."""
    return _multiscale(gradient_matching_loss, predicted, groundtruth, mask, factors)


def spike_penalization_loss(spike_tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Σ_tensors mean(s²)/2: the activity regulariser."""
    total = 0.0
    for s in spike_tensors:
        total = total + (s * s).sum() / (2.0 * float(s.numel()))
    return total


@dataclasses.dataclass(frozen=True)
class TotalLossConfig:
    """The JAX package's fields and defaults (alpha 0.5 for metric depth)."""

    alpha: float = 0.5
    scale_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    penalize_spikes: bool = False
    beta: float = 1.0


def total_loss(predicted: Sequence[torch.Tensor], groundtruth: torch.Tensor,
               mask: torch.Tensor, spike_tensors: Optional[Sequence[torch.Tensor]] = None,
               cfg: TotalLossConfig = TotalLossConfig()) -> torch.Tensor:
    """SI + α·GM (+ β·SP) over the prediction pyramid."""
    w = cfg.scale_weights[: len(predicted)]
    out = multiscale_scale_invariant_loss(predicted, groundtruth, mask, w)
    out = out + cfg.alpha * multiscale_gradient_matching_loss(predicted, groundtruth, mask, w)
    if cfg.penalize_spikes:
        out = out + cfg.beta * spike_penalization_loss(spike_tensors or ())
    return out
