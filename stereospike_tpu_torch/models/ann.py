"""Equivalent ANN baseline (counterpart of ``stereospike_tpu/models/ann.py``):
the StereoSpike U-Net topology with analog activations and BatchNorm.

As the reference ``StereoSpike_equivalentANN``: encoder convs have biases,
each conv or upsample-conv block is conv → activation → BatchNorm2d, the
bottleneck is two residual blocks, and the heads charge the same
infinite-threshold integrator pool as the SNN, so the depths are
cumulative. The paper compares Sigmoid, Tanh and LeakyReLU activations.

Parameters are a flat dict under the reference ``.pth`` keys
(:data:`ANN_CONV_SITES`, :data:`ANN_BN_SITES`), weights OIHW; the BN
running statistics are a second flat dict under ``<stem>.running_mean`` and
``<stem>.running_var``. Activations are NCHW inside; frames and depths are
NHWC, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from stereospike_tpu_torch.models.stereospike import StereoSpikeConfig
from stereospike_tpu_torch.nn.blocks import (
    ann_res_block_apply,
    batchnorm_apply,
    init_ann_res_block,
    init_batchnorm,
    init_bn_state,
)
from stereospike_tpu_torch.nn.layers import conv2d, conv_init, upsample_conv
from stereospike_tpu_torch.snn.neurons import integrator_step

Params = Dict[str, torch.Tensor]
Device = Union[str, torch.device]

_ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "relu": torch.relu,
}

# (path in the JAX parameter tree, reference .pth stem) of every conv: the
# conv Sequentials are (Conv2d, activation, BatchNorm2d), the residual
# blocks' inner Sequentials likewise, the heads a plain NNConvUpsampling
ANN_CONV_SITES: Tuple[Tuple[Tuple[str, ...], str], ...] = (
    (("bottom",), "bottom.0"),
    (("conv1",), "conv1.0"),
    (("conv2",), "conv2.0"),
    (("conv3",), "conv3.0"),
    (("conv4",), "conv4.0"),
    (("res1", "conv1"), "bottleneck.0.conv1.0"),
    (("res1", "conv2"), "bottleneck.0.conv2.0"),
    (("res2", "conv1"), "bottleneck.1.conv1.0"),
    (("res2", "conv2"), "bottleneck.1.conv2.0"),
    (("deconv4",), "deconv4.0.up.1"),
    (("deconv3",), "deconv3.0.up.1"),
    (("deconv2",), "deconv2.0.up.1"),
    (("deconv1",), "deconv1.0.up.1"),
    (("pred4",), "predict_depth4.0.up.1"),
    (("pred3",), "predict_depth3.0.up.1"),
    (("pred2",), "predict_depth2.0.up.1"),
    (("pred1",), "predict_depth1.0.up.1"),
)
# (path of a BN in the JAX parameter and BN-state trees, .pth stem)
ANN_BN_SITES: Tuple[Tuple[Tuple[str, ...], str], ...] = (
    (("bn_bottom",), "bottom.2"),
    (("bn_conv1",), "conv1.2"),
    (("bn_conv2",), "conv2.2"),
    (("bn_conv3",), "conv3.2"),
    (("bn_conv4",), "conv4.2"),
    (("res1", "bn1"), "bottleneck.0.conv1.2"),
    (("res1", "bn2"), "bottleneck.0.conv2.2"),
    (("res2", "bn1"), "bottleneck.1.conv1.2"),
    (("res2", "bn2"), "bottleneck.1.conv2.2"),
    (("bn_deconv4",), "deconv4.2"),
    (("bn_deconv3",), "deconv3.2"),
    (("bn_deconv2",), "deconv2.2"),
    (("bn_deconv1",), "deconv1.2"),
)
_RES_STEMS = {1: "bottleneck.0", 2: "bottleneck.1"}


@dataclasses.dataclass(frozen=True)
class AnnConfig:
    in_channels: int = 4
    base_channels: int = 32
    in_hw: Tuple[int, int] = (260, 346)
    activation: str = "sigmoid"   # sigmoid | tanh | leaky_relu | relu

    @property
    def skeleton(self) -> StereoSpikeConfig:
        """The SNN config whose channels and level sizes the ANN shares."""
        return StereoSpikeConfig(in_channels=self.in_channels,
                                 base_channels=self.base_channels, in_hw=self.in_hw)


def _bn_channels(cfg: AnnConfig) -> Dict[str, int]:
    """.pth stem → channel count of every BN."""
    c = cfg.skeleton.channels
    out = {"bottom.2": c[0], **{f"conv{i}.2": c[i] for i in range(1, 5)},
           **{f"deconv{s}.2": c[s - 1] for s in (4, 3, 2, 1)}}
    out.update({f"{stem}.conv{j}.2": c[4] for stem in _RES_STEMS.values() for j in (1, 2)})
    return out


def init_ann_params(generator: torch.Generator, cfg: AnnConfig, *, device: Device = "cuda",
                    dtype: torch.dtype = torch.float32) -> Params:
    """Fresh parameters: torch-default conv init drawn on the CPU from
    ``generator``, BN weight 1 and bias 0, moved to ``device``. The
    upsample-convs of the decoder have no bias."""
    c = cfg.skeleton.channels
    convs = {"bottom.0": (5, cfg.in_channels, c[0], True)}
    for i in range(1, 5):
        convs[f"conv{i}.0"] = (5, c[i - 1], c[i], True)
    for s in (4, 3, 2, 1):
        convs[f"deconv{s}.0.up.1"] = (5, c[s], c[s - 1], False)
    for s in (1, 2, 3, 4):
        convs[f"predict_depth{s}.0.up.1"] = (3, c[s - 1], 1, True)
    params: Params = {}
    for stem, (k, c_in, c_out, bias) in convs.items():
        for name, t in conv_init(generator, k, c_in, c_out, bias=bias, dtype=dtype).items():
            params[f"{stem}.{'weight' if name == 'w' else 'bias'}"] = t.to(device)
    for stem in _RES_STEMS.values():
        block = init_ann_res_block(generator, c[4], device=device, dtype=dtype)
        for i in (1, 2):
            params[f"{stem}.conv{i}.0.weight"] = block[f"conv{i}"]["w"]
            params[f"{stem}.conv{i}.0.bias"] = block[f"conv{i}"]["b"]
    for stem, channels in _bn_channels(cfg).items():
        for name, t in init_batchnorm(channels, device=device, dtype=dtype).items():
            params[f"{stem}.{name}"] = t
    return params


def init_ann_state(cfg: AnnConfig, *, device: Device = "cuda",
                   dtype: torch.dtype = torch.float32) -> Params:
    """Fresh BN running statistics (mean 0, variance 1) for every BN."""
    state: Params = {}
    for stem, channels in _bn_channels(cfg).items():
        for name, t in init_bn_state(channels, device=device, dtype=dtype).items():
            state[f"{stem}.{name}"] = t
    return state


def _bn(tree: Params, stem: str, names: Tuple[str, str]) -> Params:
    return {n: tree[f"{stem}.{n}"] for n in names}


_AFFINE = ("weight", "bias")
_RUNNING = ("running_mean", "running_var")


def ann_forward(params: Params, frame: torch.Tensor, cfg: AnnConfig, state: Params, *,
                train: bool = False, init_depth: Optional[torch.Tensor] = None, group=None
                ) -> Tuple[List[torch.Tensor], Params]:
    """``frame`` [B, H, W, C] → ``([depth1, ..., depth4], new_bn_state)``,
    each depth [B, H, W, 1] and cumulative through the shared integrator
    pool, which starts at ``init_depth`` [B, H, W, 1] (zero by default).
    ``train``: normalize by batch statistics and move the running ones;
    otherwise normalize by the running statistics, which stay. ``group``:
    in training, BatchNorm over the global batch of that process group."""
    act = _ACTIVATIONS[cfg.activation]
    sizes = cfg.skeleton.sizes
    new_state: Params = {}

    def act_bn(stem: str, x: torch.Tensor) -> torch.Tensor:
        y, s = batchnorm_apply(_bn(params, stem, _AFFINE), act(x),
                               state=_bn(state, stem, _RUNNING), train=train, group=group)
        new_state.update({f"{stem}.{n}": v for n, v in s.items()})
        return y

    def conv_act_bn(name: str, x: torch.Tensor, stride: int) -> torch.Tensor:
        out = conv2d(x, params[f"{name}.0.weight"], params[f"{name}.0.bias"], stride=stride,
                     padding=2)
        return act_bn(f"{name}.2", out)

    def res(i: int, x: torch.Tensor) -> torch.Tensor:
        stem = _RES_STEMS[i]
        block = {}
        for j in (1, 2):
            block[f"conv{j}"] = {"w": params[f"{stem}.conv{j}.0.weight"],
                                 "b": params[f"{stem}.conv{j}.0.bias"]}
            block[f"bn{j}"] = _bn(params, f"{stem}.conv{j}.2", _AFFINE)
        bn_state = {f"bn{j}": _bn(state, f"{stem}.conv{j}.2", _RUNNING) for j in (1, 2)}
        y, s = ann_res_block_apply(block, x, act, bn_state=bn_state, train=train, group=group)
        for j in (1, 2):
            new_state.update({f"{stem}.conv{j}.2.{n}": v for n, v in s[f"bn{j}"].items()})
        return y

    x = frame.permute(0, 3, 1, 2).contiguous()
    out_bottom = conv_act_bn("bottom", x, 1)
    out_conv1 = conv_act_bn("conv1", out_bottom, 2)
    out_conv2 = conv_act_bn("conv2", out_conv1, 2)
    out_conv3 = conv_act_bn("conv3", out_conv2, 2)
    out_conv4 = conv_act_bn("conv4", out_conv3, 2)
    out_rconv = res(2, res(1, out_conv4))

    b = frame.shape[0]
    v_depth = (torch.zeros(b, 1, *sizes[0], dtype=frame.dtype, device=frame.device)
               if init_depth is None else init_depth.permute(0, 3, 1, 2))
    skips = (out_bottom, out_conv1, out_conv2, out_conv3)
    depths: Dict[int, torch.Tensor] = {}
    x = out_rconv
    for scale in (4, 3, 2, 1):
        up = upsample_conv(x, params[f"deconv{scale}.0.up.1.weight"],
                           target_hw=sizes[scale - 1])
        x = act_bn(f"deconv{scale}.2", up) + skips[scale - 1]
        head = f"predict_depth{scale}.0.up.1"
        charge = upsample_conv(x, params[f"{head}.weight"], params[f"{head}.bias"],
                               target_hw=sizes[0])
        v_depth = integrator_step(v_depth, charge)
        depths[scale] = v_depth
    h, w = sizes[0]
    return [depths[s].reshape(b, h, w, 1) for s in (1, 2, 3, 4)], new_state
