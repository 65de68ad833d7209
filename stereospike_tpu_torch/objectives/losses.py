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

``group``: under data parallelism (``parallel/mesh.py``) the sums run
over the ranks of that process group: every head's n, Σ res, Σ res² and
GM sum in one all-reduce, the spike tensors' Σ s² in another, and each
spike tensor's element count is its local one times the world size (every
rank's batch has the same shape). The loss then equals the single-device
loss of the global batch; n and the quadratic term are not linear in the
batch, so per-rank losses averaged afterwards would not.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from stereospike_tpu_torch.nn.layers import bilinear_resize
from stereospike_tpu_torch.parallel.collectives import psum, world_size

Group = Optional["torch.distributed.ProcessGroup"]


def _head_sums(predicted: torch.Tensor, groundtruth: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """One head's local sums, stacked: n, Σ res², Σ res and the
    gradient-matching sum Σ (|∂x res| + |∂y res|)·mask."""
    maskf = mask.to(predicted.dtype)
    res = (predicted - groundtruth) * maskf
    gx, gy = _sobel(res)
    return torch.stack([maskf.sum(), (res * res).sum(), res.sum(),
                        ((_abs(gx) + _abs(gy)) * maskf).sum()])


def _si(sums: torch.Tensor) -> torch.Tensor:
    """The scale-invariant MSE from a head's (global) sums."""
    n = torch.clamp(sums[0], min=1.0)
    return sums[1] / n - torch.square(sums[2]) / (n * n)


def _gm(sums: torch.Tensor) -> torch.Tensor:
    """The gradient-matching L1 from a head's (global) sums."""
    return sums[3] / torch.clamp(sums[0], min=1.0)


def scale_invariant_loss(predicted: torch.Tensor, groundtruth: torch.Tensor,
                         mask: torch.Tensor, group: Group = None) -> torch.Tensor:
    """Masked scale-invariant MSE."""
    return _si(psum(_head_sums(predicted, groundtruth, mask), group))


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
                           mask: torch.Tensor, group: Group = None) -> torch.Tensor:
    """Masked Sobel gradient-matching L1."""
    return _gm(psum(_head_sums(predicted, groundtruth, mask), group))


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


def _pyramid_sums(predicted: Sequence[torch.Tensor], groundtruth: torch.Tensor,
                  mask: torch.Tensor, group: Group) -> torch.Tensor:
    """[heads, 4]: every head's sums against the GT at its resolution,
    summed over the ranks of ``group`` by one all-reduce."""
    return psum(torch.stack([
        _head_sums(p, *resize_groundtruth(groundtruth, mask, tuple(p.shape[1:3])))
        for p in predicted]), group)


def _multiscale(term, sums: torch.Tensor,
                factors: Optional[Sequence[float]]) -> torch.Tensor:
    factors = (1.0,) * len(sums) if factors is None else factors
    total = 0.0
    for f, s in zip(factors, sums):
        total = total + f * term(s)
    return total


def multiscale_scale_invariant_loss(predicted: Sequence[torch.Tensor],
                                    groundtruth: torch.Tensor, mask: torch.Tensor,
                                    factors: Optional[Sequence[float]] = None,
                                    group: Group = None) -> torch.Tensor:
    """Σ_scales factor · SI(pred_s, resize(gt))."""
    return _multiscale(_si, _pyramid_sums(predicted, groundtruth, mask, group), factors)


def multiscale_gradient_matching_loss(predicted: Sequence[torch.Tensor],
                                      groundtruth: torch.Tensor, mask: torch.Tensor,
                                      factors: Optional[Sequence[float]] = None,
                                      group: Group = None) -> torch.Tensor:
    """Σ_scales factor · GM(pred_s, resize(gt))."""
    return _multiscale(_gm, _pyramid_sums(predicted, groundtruth, mask, group), factors)


def spike_penalization_loss(spike_tensors: Sequence[torch.Tensor],
                            group: Group = None) -> torch.Tensor:
    """Σ_tensors mean(s²)/2: the activity regulariser."""
    total = 0.0
    if not spike_tensors:
        return total
    squares = psum(torch.stack([(s * s).sum() for s in spike_tensors]), group)
    for s, sq in zip(spike_tensors, squares):
        total = total + sq / (2.0 * float(s.numel() * world_size(group)))
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
               cfg: TotalLossConfig = TotalLossConfig(), group: Group = None) -> torch.Tensor:
    """SI + α·GM (+ β·SP) over the prediction pyramid; over the ranks of
    ``group`` when given."""
    w = cfg.scale_weights[: len(predicted)]
    sums = _pyramid_sums(predicted, groundtruth, mask, group)
    out = _multiscale(_si, sums, w) + cfg.alpha * _multiscale(_gm, sums, w)
    if cfg.penalize_spikes:
        out = out + cfg.beta * spike_penalization_loss(spike_tensors or (), group)
    return out
