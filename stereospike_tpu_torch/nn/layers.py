"""Low-level layers (counterpart of ``stereospike_tpu/nn/layers.py``).

Inside the port, activations are NCHW and weights OIHW, PyTorch's layout
for ``F.conv2d``; the public functions of the model keep the JAX package's
NHWC. Only the canonical forms are ported: the TPU execution forms of the
JAX package (s2d level 0, phase-stacked and polyphase upsample-convs,
selection-matrix upsampling, the factorized one-channel heads) compute the
same function up to float reassociation.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, *,
           stride: int = 1, padding: int = 0) -> torch.Tensor:
    """2-D convolution, activations NCHW, weights OIHW (torch ``nn.Conv2d``
    with integer zero padding).

    float32 runs in true float32, as the JAX package's ``Precision.HIGHEST``
    does: cuDNN would run it in TF32 by default, which keeps about three
    decimal digits and flips spikes at the threshold. So a float32 CUDA call
    turns ``torch.backends.cudnn.allow_tf32`` off for the process. bfloat16
    takes the tensor cores, with their float32 accumulator."""
    if x.dtype == torch.float32 and x.is_cuda:
        torch.backends.cudnn.allow_tf32 = False
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def conv_init(generator: torch.Generator, kernel_size: int, c_in: int, c_out: int, *,
              bias: bool = False, dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Torch-default conv init, U(-1/√fan_in, 1/√fan_in) for the weight and
    the bias, drawn on the CPU from ``generator`` (weight first):
    ``{"w": OIHW [, "b": [c_out]]}``."""
    bound = 1.0 / math.sqrt(c_in * kernel_size * kernel_size)
    out = {"w": torch.empty(c_out, c_in, kernel_size, kernel_size, dtype=dtype).uniform_(
        -bound, bound, generator=generator)}
    if bias:
        out["b"] = torch.empty(c_out, dtype=dtype).uniform_(-bound, bound, generator=generator)
    return out


@functools.lru_cache(maxsize=64)
def _nearest_index(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return (torch.arange(out_size, dtype=torch.int64) * in_size // out_size).to(device)


def nearest_source_indices(in_size: int, out_size: int) -> torch.Tensor:
    """torch ``UpsamplingNearest2d(size=...)`` source rows, in integers:
    ``src = (dst · in) // out``. ``F.interpolate`` computes the same rule
    with a float scale, which can pick another source pixel."""
    return _nearest_index(in_size, out_size, torch.device("cpu"))


def nearest_upsample(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of NCHW ``x`` to spatial ``size``."""
    h_in, w_in = x.shape[2], x.shape[3]
    h_out, w_out = size
    if w_in != w_out:
        x = x.index_select(3, _nearest_index(w_in, w_out, x.device))
    if h_in != h_out:
        x = x.index_select(2, _nearest_index(h_in, h_out, x.device))
    return x


def upsample_conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                  *, target_hw: Tuple[int, int]) -> torch.Tensor:
    """NNConvUpsampling: nearest resize to ``target + (k - 1)``, then a k×k
    VALID conv that lands exactly on ``target`` (the JAX package's canonical
    composite, ``nn/layers.py::upsample_conv``)."""
    k = w.shape[-1]
    up = nearest_upsample(x, (target_hw[0] + k - 1, target_hw[1] + k - 1))
    return conv2d(up, w, b, stride=1, padding=0)


@functools.lru_cache(maxsize=None)
def _linear_weights(in_size: int, out_size: int,
                    align_corners: bool) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Source rows (lo, hi) and the float32 weight of ``hi`` for a linear
    resize, by the JAX package's rule (torch ``F.interpolate`` semantics).
    align_corners: ``src = dst·(in-1)/(out-1)``; otherwise ``src =
    (dst+0.5)·in/out - 0.5`` clipped to [0, in-1]. Computed in float64 on
    the host and rounded once, so the weights do not depend on how a
    device would form the scale."""
    if align_corners:
        if out_size == 1:
            src = np.zeros(1)
        else:
            src = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    else:
        src = (np.arange(out_size) + 0.5) * in_size / out_size - 0.5
        src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = (src - lo).astype(np.float32)
    return lo, hi, w_hi


def bilinear_resize(x: torch.Tensor, size: Tuple[int, int], *,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of NHWC ``x`` to spatial ``size``: rows, then
    columns, each ``x[lo]·(1 - w) + x[hi]·w``. Not ``F.interpolate``,
    which forms its source coordinate from a float scale and can round it
    otherwise."""
    h_in, w_in = x.shape[1], x.shape[2]
    h_out, w_out = size
    if (h_in, w_in) == (h_out, w_out):
        return x
    lo_h, hi_h, wh = _linear_weights(h_in, h_out, align_corners)
    lo_w, hi_w, ww = _linear_weights(w_in, w_out, align_corners)

    def lerp(t: torch.Tensor, dim: int, lo: np.ndarray, hi: np.ndarray,
             w: np.ndarray) -> torch.Tensor:
        shape = [1, 1, 1, 1]
        shape[dim] = -1
        w_t = torch.from_numpy(w).to(device=t.device, dtype=t.dtype).reshape(shape)
        return (t.index_select(dim, torch.from_numpy(lo).to(t.device)) * (1 - w_t)
                + t.index_select(dim, torch.from_numpy(hi).to(t.device)) * w_t)

    return lerp(lerp(x, 1, lo_h, hi_h, wh), 2, lo_w, hi_w, ww)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """NHWC [B, 2H, 2W, C] → [B, H, W, 4C]; channel block (p·2+q)·C+c holds
    the (row-parity p, col-parity q) phase — the JAX package's level-0
    state layout. Used only to exchange state with it."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    n, h2, w2, c4 = x.shape
    c = c4 // 4
    x = x.reshape(n, h2, w2, 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h2 * 2, w2 * 2, c)
