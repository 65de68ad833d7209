"""Synthetic event-depth batches (counterpart of
``stereospike_tpu/data/synthetic.py``), shaped like the MVSEC pipeline's
output so that training runs without the MVSEC hdf5 files.

Draws come from an explicit ``torch.Generator`` and are made on its
device; its stream differs from ``jax.random``'s, so tests that compare
with the JAX package feed both the same arrays.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple, Union

import torch

from stereospike_tpu_torch.nn.layers import bilinear_resize

Device = Union[str, torch.device]


def _smooth_depth(generator: torch.Generator, batch: int, hw: Tuple[int, int],
                  d_min: float = 1.0, d_max: float = 6.0) -> torch.Tensor:
    """Smooth random depth surface: low-res uniform noise, bilinear-upsampled."""
    coarse = torch.rand((batch, 8, 11, 1), generator=generator, device=generator.device)
    return bilinear_resize(coarse * (d_max - d_min) + d_min, hw, align_corners=False)


def synthetic_batch(generator: torch.Generator, batch: int = 1,
                    in_hw: Tuple[int, int] = (260, 346), channels: int = 4, T: int = 1,
                    rate: float = 0.35, invalid_frac: float = 0.15,
                    dtype: torch.dtype = torch.float32,
                    device: Device = "cuda") -> Dict[str, torch.Tensor]:
    """One batch ``{chunks [B, T, H, W, C], gt [B, H, W, 1], mask [B, H, W, 1]
    bool}``: Poisson event counts at ``rate`` per pixel and frame (about an
    MVSEC indoor_flying 50 ms window), a smooth GT depth in [1, 6) and
    ``invalid_frac`` of invalid pixels (GT 0 there), on ``device``."""
    gdev = generator.device
    chunks = torch.poisson(torch.full((batch, T, *in_hw, channels), rate, device=gdev),
                           generator=generator).to(dtype)
    gt = _smooth_depth(generator, batch, tuple(in_hw)).to(dtype)
    mask = torch.rand(gt.shape, generator=generator, device=gdev) >= invalid_frac
    gt = torch.where(mask, gt, torch.zeros_like(gt))
    return {"chunks": chunks.to(device), "gt": gt.to(device), "mask": mask.to(device)}


def synthetic_stream(seed: int, num_batches: int, **kwargs) -> Iterator[Dict[str, torch.Tensor]]:
    """Finite stream of synthetic batches, deterministic in ``seed`` (drawn
    on the CPU)."""
    generator = torch.Generator().manual_seed(seed)
    for _ in range(num_batches):
        yield synthetic_batch(generator, **kwargs)
