"""Surrogate-gradient spike functions (counterpart of ``stereospike_tpu/snn/surrogate.py``).

Forward: the Heaviside step ``spike = 1[x >= 0]``, firing at exactly 0 as
SpikingJelly does. Backward: a smooth pseudo-derivative, SpikingJelly's

- ATan (default ``alpha = 2.0``): d/dx = alpha / (2 * (1 + (pi/2 * alpha * x)^2))
- Sigmoid (default ``alpha = 4.0``), s = sigmoid(alpha * x): d/dx = alpha * s * (1 - s)

Each is a ``torch.autograd.Function``. :func:`surrogate_grad` is the
pseudo-derivative alone; the cells' backward and the plain version of the
fused fire's backward (``snn/cuda_kernels.py``) share it, and the CUDA
kernel ``csrc/fire_bwd.cu`` spells the same operations in the same order.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

_HALF_PI = math.pi / 2.0
DEFAULT_ALPHA = {"atan": 2.0, "sigmoid": 4.0}


def resolve_alpha(name: str, alpha: float | None = None) -> float:
    """The surrogate's alpha, or its default (2.0 for ATan, 4.0 for Sigmoid)."""
    if name not in DEFAULT_ALPHA:
        raise ValueError(f"unknown surrogate '{name}' (expected 'atan' or 'sigmoid')")
    return DEFAULT_ALPHA[name] if alpha is None else float(alpha)


def surrogate_grad(u: torch.Tensor, name: str, alpha: float) -> torch.Tensor:
    """The pseudo-derivative at ``u = h - v_threshold``, in the order of the
    JAX package's ``_surrogate_grad``: ATan ``(pi/2*alpha)*u`` then
    ``alpha / (2*(1 + s*s))`` as a true division (``alpha / tensor`` in
    PyTorch multiplies by a reciprocal, which rounds twice); Sigmoid
    ``(alpha*s)*(1 - s)`` with ``s = sigmoid(alpha*u)``."""
    if name == "atan":
        s = _HALF_PI * alpha * u
        return torch.div(torch.tensor(alpha, dtype=u.dtype), 2.0 * (1.0 + s * s))
    if name == "sigmoid":
        s = torch.sigmoid(alpha * u)
        return alpha * s * (1.0 - s)
    raise ValueError(f"unknown surrogate '{name}' (expected 'atan' or 'sigmoid')")


def heaviside(x: torch.Tensor) -> torch.Tensor:
    """Heaviside step with H(0) = 1, in the input dtype (0./1. spikes)."""
    return (x >= 0).to(x.dtype)


class SpikeATan(torch.autograd.Function):
    """Heaviside spike with the arctan surrogate gradient (SpikingJelly ATan)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, alpha: float = 2.0) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.alpha = alpha
        return heaviside(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (x,) = ctx.saved_tensors
        return grad * surrogate_grad(x, "atan", ctx.alpha), None


class SpikeSigmoid(torch.autograd.Function):
    """Heaviside spike with the sigmoid surrogate gradient (SpikingJelly Sigmoid)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, alpha: float = 4.0) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.alpha = alpha
        return heaviside(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (x,) = ctx.saved_tensors
        return grad * surrogate_grad(x, "sigmoid", ctx.alpha), None


def spike_atan(x: torch.Tensor, alpha: float = 2.0) -> torch.Tensor:
    return SpikeATan.apply(x, alpha)


def spike_sigmoid(x: torch.Tensor, alpha: float = 4.0) -> torch.Tensor:
    return SpikeSigmoid.apply(x, alpha)


def make_spike_fn(name: str = "atan",
                  alpha: float | None = None) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build a spike function by name ('atan' | 'sigmoid') with optional alpha."""
    a = resolve_alpha(name, alpha)
    if name == "atan":
        return lambda x: spike_atan(x, a)
    return lambda x: spike_sigmoid(x, a)
