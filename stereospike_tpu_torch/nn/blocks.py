"""Network blocks (counterpart of ``stereospike_tpu/nn/blocks.py``).

- conv block   = conv(k5) → MultiplyBy → spiking neuron
- upsample blk = NNConvUpsampling → MultiplyBy → neuron
- SEW residual = [conv3 → ×c → fire] ×2, connected with the identity
- ``connect``  = spike-element-wise combine (ADD/MUL/AND/OR/NMUL)
- ANN blocks   = BatchNorm2d with running statistics, and the equivalent
  ANN's residual block [conv3 → activation → BN] ×2 + identity

MultiplyBy is a scalar scale against vanishing spikes: a static config
constant, or a learnable scalar stored under the block's ``scale`` entry.
Parameters are passed as small dicts ``{"w": OIHW [, "b"] [, "scale"]}``.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Tuple, Union

import torch
import torch.nn.functional as F

from stereospike_tpu_torch.nn.layers import conv2d, conv_init, upsample_conv
from stereospike_tpu_torch.parallel.collectives import psum, world_size

Params = Mapping[str, torch.Tensor]


def connect(out: torch.Tensor, identity: torch.Tensor, kind: str = "ADD") -> torch.Tensor:
    """Spike-element-wise combine of a residual branch with its identity
    ('OR' is the algebraic a + b − a·b)."""
    if kind == "ADD":
        return out + identity
    if kind in ("MUL", "AND"):
        return out * identity
    if kind == "OR":
        return out + identity - out * identity
    if kind == "NMUL":
        return identity * (1.0 - out)
    raise NotImplementedError(f"unknown connect function '{kind}'")


def _apply_scale(x: torch.Tensor, params: Params, static_scale: float) -> torch.Tensor:
    if "scale" in params:
        return x * params["scale"]
    if static_scale != 1.0:
        return x * static_scale
    return x


def conv_scale(x: torch.Tensor, params: Params, *, stride: int = 1, padding: int = 0,
               static_scale: float = 1.0) -> torch.Tensor:
    """conv → MultiplyBy (pre-neuron charge of an SNN conv block)."""
    out = conv2d(x, params["w"], params.get("b"), stride=stride, padding=padding)
    return _apply_scale(out, params, static_scale)


def upsample_conv_scale(x: torch.Tensor, params: Params, *, target_hw: Tuple[int, int],
                        static_scale: float = 1.0) -> torch.Tensor:
    """NNConvUpsampling → MultiplyBy (pre-neuron charge of a decoder block)."""
    out = upsample_conv(x, params["w"], params.get("b"), target_hw=target_hw)
    return _apply_scale(out, params, static_scale)


def sew_block_apply(conv1: Params, conv2: Params, x: torch.Tensor,
                    fire1: Callable[[torch.Tensor], torch.Tensor],
                    fire2: Callable[[torch.Tensor], torch.Tensor], *,
                    static_scale: float = 1.0, connect_fn: str = "ADD") -> torch.Tensor:
    """SEW residual block. ``fire*`` are charge→spike closures (the caller
    keeps the membrane state)."""
    out = fire1(conv_scale(x, conv1, stride=1, padding=1, static_scale=static_scale))
    out = fire2(conv_scale(out, conv2, stride=1, padding=1, static_scale=static_scale))
    return connect(out, x, connect_fn)


# --------------------------------------------------------------- ANN blocks
Device = Union[str, torch.device]
Activation = Callable[[torch.Tensor], torch.Tensor]


def init_batchnorm(channels: int, *, device: Device = "cuda",
                   dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """BatchNorm2d's affine parameters: weight 1, bias 0."""
    return {"weight": torch.ones(channels, dtype=dtype, device=device),
            "bias": torch.zeros(channels, dtype=dtype, device=device)}


def init_bn_state(channels: int, *, device: Device = "cuda",
                  dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """BatchNorm2d's running statistics: mean 0, variance 1."""
    return {"running_mean": torch.zeros(channels, dtype=dtype, device=device),
            "running_var": torch.ones(channels, dtype=dtype, device=device)}


def batchnorm_apply(params: Params, x: torch.Tensor, *, state: Params, train: bool,
                    momentum: float = 0.1, eps: float = 1e-5, group=None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """BatchNorm2d over NCHW ``x``, torch semantics: in training the biased
    batch variance normalizes and the running variance takes the unbiased
    one, each running statistic moving by ``momentum``; in eval the running
    statistics normalize. Returns ``(y, new_state)``; ``state`` itself is
    left as it was.

    Training under a process ``group`` (data parallelism) normalizes by
    the global batch's statistics, as the JAX package's GSPMD lowering
    does: the mean from a sum over ranks, the variance from a centred sum
    of squares over ranks, both differentiable; the running statistics
    then equal the single-device ones."""
    new_state = ({k: v.detach().clone() for k, v in state.items()} if train
                 else dict(state))
    if not train or group is None:
        y = F.batch_norm(x, new_state["running_mean"], new_state["running_var"],
                         params["weight"], params["bias"], training=train,
                         momentum=momentum, eps=eps)
        return y, new_state
    return _global_batchnorm(params, x, new_state, momentum, eps, group)


def _global_batchnorm(params: Params, x: torch.Tensor, new_state: Dict[str, torch.Tensor],
                      momentum: float, eps: float, group
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training BatchNorm with the batch statistics of every rank's batch;
    ``new_state`` (a copy) moves in place."""
    dims = (0, 2, 3)
    n = torch.tensor(float(x.numel() // x.shape[1] * world_size(group)), dtype=x.dtype,
                     device=x.device)
    # each rank's activations feed the statistics and are normalized by
    # them, so the cotangents of the sums are summed over ranks too
    mean = psum(x.sum(dims), group, sum_cotangents=True) / n
    centred = x - mean.view(1, -1, 1, 1)
    var = psum((centred * centred).sum(dims), group, sum_cotangents=True) / n
    y = (centred * torch.rsqrt(var + eps).view(1, -1, 1, 1) * params["weight"].view(1, -1, 1, 1)
         + params["bias"].view(1, -1, 1, 1))
    with torch.no_grad():
        unbiased = var * n / torch.clamp(n - 1, min=1.0)
        new_state["running_mean"].mul_(1 - momentum).add_(momentum * mean)
        new_state["running_var"].mul_(1 - momentum).add_(momentum * unbiased)
    return y, new_state


def init_ann_res_block(generator: torch.Generator, channels: int, *, bias: bool = True,
                       device: Device = "cuda", dtype: torch.dtype = torch.float32
                       ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"conv1": {"w"[, "b"]}, "bn1": {...}, "conv2": ..., "bn2": ...}``,
    3×3 convs drawn from ``generator``."""
    out = {}
    for i in (1, 2):
        conv = conv_init(generator, 3, channels, channels, bias=bias, dtype=dtype)
        out[f"conv{i}"] = {k: v.to(device) for k, v in conv.items()}
        out[f"bn{i}"] = init_batchnorm(channels, device=device, dtype=dtype)
    return out


def ann_res_block_apply(params: Mapping[str, Params], x: torch.Tensor, act: Activation, *,
                        bn_state: Mapping[str, Params], train: bool, connect_fn: str = "ADD",
                        group=None
                        ) -> Tuple[torch.Tensor, Dict[str, Dict[str, torch.Tensor]]]:
    """ANN residual block: [conv3 → act → BN] ×2, then connect with the
    identity. Returns ``(y, {"bn1": ..., "bn2": ...})``, the new BN state.
    ``group``: BN over the global batch (:func:`batchnorm_apply`)."""
    out = x
    new_state = {}
    for i in (1, 2):
        conv = params[f"conv{i}"]
        out = conv2d(out, conv["w"], conv.get("b"), stride=1, padding=1)
        out, new_state[f"bn{i}"] = batchnorm_apply(params[f"bn{i}"], act(out),
                                                   state=bn_state[f"bn{i}"], train=train,
                                                   group=group)
    return connect(out, x, connect_fn), new_state
