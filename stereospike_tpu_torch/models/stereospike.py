"""StereoSpike: fully-spiking U-Net for dense depth from event streams
(counterpart of ``stereospike_tpu/models/stereospike.py``).

- encoder: bottom conv(k5, s1), then 4× conv(k5, s2), channels b→2b→4b→8b→16b
- bottleneck: 2 SEW residual blocks
- decoder: 4× NNConvUpsampling(k5) to the mirrored encoder sizes, with
  additive spike skips
- prediction: per-scale NNConvUpsampling(k3, bias) heads charging one
  shared pool of non-firing integrator neurons, deepest head first; the
  pool's potential after head k is depth_k (cumulative prediction)

Parameters are a flat dict of tensors under the reference ``.pth`` keys
(``bottom.0.weight``, ``bottleneck.0.sn1.w``, ...), weights OIHW. Membrane
state is a dict of NCHW tensors, one per spiking site plus the integrator
pool ``Ineurons``. Every spiking site goes through the fused fire kernel
(:func:`stereospike_tpu_torch.snn.cuda_kernels.multistep_fire`) at T = 1,
whose backward (the site's surrogate derivative, and the PLIF leak's
gradient through ``sigmoid(w)`` to ``w``) is the hand-written backward
kernel when a gradient is wanted.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from stereospike_tpu_torch.nn.blocks import conv_scale, sew_block_apply, upsample_conv_scale
from stereospike_tpu_torch.snn.cuda_kernels import multistep_fire
from stereospike_tpu_torch.snn.neurons import integrator_step, plif_w_from_tau
from stereospike_tpu_torch.snn.surrogate import resolve_alpha

Params = Dict[str, torch.Tensor]
State = Dict[str, torch.Tensor]
FireFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]

# spiking site → (conv stem, learnable-MultiplyBy key, PLIF key): the
# reference module tree's state-dict names
SITE_KEYS: Dict[str, Tuple[str, str, Optional[str]]] = {
    "bottom": ("bottom.0", "bottom.1.scale_value", "bottom.2.w"),
    "conv1": ("conv1.0", "conv1.1.scale_value", "conv1.2.w"),
    "conv2": ("conv2.0", "conv2.1.scale_value", "conv2.2.w"),
    "conv3": ("conv3.0", "conv3.1.scale_value", "conv3.2.w"),
    "conv4": ("conv4.0", "conv4.1.scale_value", "conv4.2.w"),
    "sew1_a": ("bottleneck.0.conv1.0", "bottleneck.0.conv1.1.scale_value",
               "bottleneck.0.sn1.w"),
    "sew1_b": ("bottleneck.0.conv2.0", "bottleneck.0.conv2.1.scale_value",
               "bottleneck.0.sn2.w"),
    "sew2_a": ("bottleneck.1.conv1.0", "bottleneck.1.conv1.1.scale_value",
               "bottleneck.1.sn1.w"),
    "sew2_b": ("bottleneck.1.conv2.0", "bottleneck.1.conv2.1.scale_value",
               "bottleneck.1.sn2.w"),
    "deconv4": ("deconv4.0.up.1", "deconv4.1.scale_value", "deconv4.2.w"),
    "deconv3": ("deconv3.0.up.1", "deconv3.1.scale_value", "deconv3.2.w"),
    "deconv2": ("deconv2.0.up.1", "deconv2.1.scale_value", "deconv2.2.w"),
    "deconv1": ("deconv1.0.up.1", "deconv1.1.scale_value", "deconv1.2.w"),
    "pred4": ("predict_depth4.0.up.1", "predict_depth4.1.scale_value", None),
    "pred3": ("predict_depth3.0.up.1", "predict_depth3.1.scale_value", None),
    "pred2": ("predict_depth2.0.up.1", "predict_depth2.1.scale_value", None),
    "pred1": ("predict_depth1.0.up.1", "predict_depth1.1.scale_value", None),
}
SPIKING_SITES = tuple(s for s in SITE_KEYS if not s.startswith("pred"))
# level of each spiking site's membrane (0 = input resolution)
SITE_LEVEL = {"bottom": 0, "conv1": 1, "conv2": 2, "conv3": 3, "conv4": 4,
              "sew1_a": 4, "sew1_b": 4, "sew2_a": 4, "sew2_b": 4,
              "deconv4": 3, "deconv3": 2, "deconv2": 1, "deconv1": 0}
PRED_HEAD_K = 3


@dataclasses.dataclass(frozen=True)
class StereoSpikeConfig:
    """Architecture + neuron configuration for the StereoSpike family
    (the JAX package's fields, so a config moves between the two)."""

    in_channels: int = 4                 # 4 binocular, 2 monocular
    base_channels: int = 32
    in_hw: Tuple[int, int] = (260, 346)
    neuron: str = "if"                   # 'if' | 'lif' | 'plif' (encoder/decoder)
    tau: float = 3.0                     # LIF tau / PLIF init tau
    surrogate: str = "atan"
    surrogate_alpha: Optional[float] = None
    sew_neuron: Optional[str] = None     # default: 'if' if neuron=='if' else 'plif'
    sew_surrogate: str = "sigmoid"
    sew_surrogate_alpha: Optional[float] = None
    v_threshold: float = 1.0
    v_reset: Optional[float] = 0.0
    detach_reset: bool = True
    multiply_factor: float = 1.0
    learnable_multiply: bool = False
    use_skips: bool = True
    heads: Tuple[int, ...] = (1, 2, 3, 4)
    connect_fn: str = "ADD"
    # The JAX package's TPU execution forms. They compute the same function
    # up to float reassociation and the port has only the canonical form,
    # so they change nothing here, except that ``s2d_level0`` decides the
    # level-0 state layout on the JAX side of ``interop.state_{to,from}_jax``.
    phase_upsample: bool = False
    s2d_level0: bool = True
    poly_deconv1: bool = True
    poly_min_batch: int = 128
    poly_deconv: Union[bool, Tuple[int, ...]] = (3,)
    pred_s2d_conv: bool = False

    @property
    def channels(self) -> Tuple[int, ...]:
        b = self.base_channels
        return (b, 2 * b, 4 * b, 8 * b, 16 * b)

    @property
    def sizes(self) -> Tuple[Tuple[int, int], ...]:
        """Spatial sizes per level (k5/s2/p2 convs: H → ceil(H/2)); at
        260×346: (260,346)/(130,173)/(65,87)/(33,44)/(17,22)."""
        h, w = self.in_hw
        out = [(h, w)]
        for _ in range(4):
            h, w = math.ceil(h / 2), math.ceil(w / 2)
            out.append((h, w))
        return tuple(out)

    def for_inference(self) -> "StereoSpikeConfig":
        """The JAX package's no-grad profile (phase-stacked upsample-convs),
        kept so that inference configs compare equal across the packages."""
        return dataclasses.replace(self, phase_upsample=True)

    @property
    def use_s2d_level0(self) -> bool:
        """Whether the JAX package keeps level-0 state in s2d layout."""
        return bool(self.s2d_level0
                    and self.in_hw[0] % 2 == 0 and self.in_hw[1] % 2 == 0)

    @property
    def effective_sew_neuron(self) -> str:
        if self.sew_neuron is not None:
            return self.sew_neuron
        return "if" if self.neuron == "if" else "plif"

    @property
    def learnable_scale(self) -> Optional[float]:
        return self.multiply_factor if self.learnable_multiply else None

    def site_neuron(self, site: str) -> str:
        return self.effective_sew_neuron if site.startswith("sew") else self.neuron

    def site_surrogate(self, site: str) -> Tuple[str, float]:
        """(surrogate, alpha) of a spiking site: the SEW sites' own, the
        encoder/decoder's elsewhere; alpha defaults by surrogate."""
        if site.startswith("sew"):
            return self.sew_surrogate, resolve_alpha(self.sew_surrogate,
                                                     self.sew_surrogate_alpha)
        return self.surrogate, resolve_alpha(self.surrogate, self.surrogate_alpha)


# ------------------------------------------------------------------ params
def _site_shapes(cfg: StereoSpikeConfig) -> Dict[str, Tuple[int, int, int]]:
    """site → (c_in, c_out, k) of its conv."""
    c = cfg.channels
    shapes = {
        "bottom": (cfg.in_channels, c[0], 5),
        "conv1": (c[0], c[1], 5), "conv2": (c[1], c[2], 5),
        "conv3": (c[2], c[3], 5), "conv4": (c[3], c[4], 5),
        "sew1_a": (c[4], c[4], 3), "sew1_b": (c[4], c[4], 3),
        "sew2_a": (c[4], c[4], 3), "sew2_b": (c[4], c[4], 3),
        "deconv4": (c[4], c[3], 5), "deconv3": (c[3], c[2], 5),
        "deconv2": (c[2], c[1], 5), "deconv1": (c[1], c[0], 5),
    }
    for s in cfg.heads:
        shapes[f"pred{s}"] = (c[s - 1], 1, PRED_HEAD_K)
    return shapes


def init_params(generator: torch.Generator, cfg: StereoSpikeConfig, *,
                device: Union[str, torch.device] = "cuda",
                dtype: torch.dtype = torch.float32) -> Params:
    """Fresh parameters, torch-default conv init U(-1/√fan_in, 1/√fan_in)
    for weights and biases, drawn on the CPU from ``generator`` and moved
    to ``device``. PLIF leaks start at sigmoid(w) = 1/tau."""
    params: Params = {}
    for site, (c_in, c_out, k) in _site_shapes(cfg).items():
        stem, scale_key, plif_key = SITE_KEYS[site]
        bound = 1.0 / math.sqrt(c_in * k * k)
        params[f"{stem}.weight"] = torch.empty(c_out, c_in, k, k, dtype=dtype).uniform_(
            -bound, bound, generator=generator)
        if site.startswith("pred"):
            params[f"{stem}.bias"] = torch.empty(c_out, dtype=dtype).uniform_(
                -bound, bound, generator=generator)
        if cfg.learnable_scale is not None:
            params[scale_key] = torch.full((1,), cfg.learnable_scale, dtype=dtype)
        if plif_key is not None and cfg.site_neuron(site) == "plif":
            params[plif_key] = plif_w_from_tau(cfg.tau, dtype)
    return {k: v.to(device) for k, v in params.items()}


def _block(params: Params, site: str) -> Dict[str, torch.Tensor]:
    stem, scale_key, _ = SITE_KEYS[site]
    out = {"w": params[f"{stem}.weight"]}
    if f"{stem}.bias" in params:
        out["b"] = params[f"{stem}.bias"]
    if scale_key in params:
        out["scale"] = params[scale_key]
    return out


def init_state(cfg: StereoSpikeConfig, batch: int, dtype: torch.dtype = torch.float32,
               *, device: Union[str, torch.device] = "cuda") -> State:
    """Zero membrane state (the functional ``reset_net``): every spiking
    site as NCHW at its level, and the depth-integrator pool [B, 1, H, W]."""
    c, s = cfg.channels, cfg.sizes
    state = {}
    for site in SPIKING_SITES:
        lvl = SITE_LEVEL[site]
        state[site] = torch.zeros(batch, c[lvl], *s[lvl], dtype=dtype, device=device)
    state["Ineurons"] = torch.zeros(batch, 1, *s[0], dtype=dtype, device=device)
    return state


# ------------------------------------------------------------------ forward
def _leak(params: Params, cfg: StereoSpikeConfig, site: str,
          x: torch.Tensor) -> Optional[torch.Tensor]:
    """The fire kernel's leak for a site: None for IF, 1/tau for LIF,
    sigmoid(w) for PLIF, rounded to the charge's dtype (as the JAX
    package's fused path does)."""
    kind = cfg.site_neuron(site)
    if kind == "if":
        return None
    if kind == "lif":
        return torch.full((1,), 1.0 / cfg.tau, dtype=x.dtype, device=x.device)
    if kind == "plif":
        return torch.sigmoid(params[SITE_KEYS[site][2]]).to(x.dtype)
    raise ValueError(f"unknown neuron '{kind}'")


def forward(params: Params, frame: torch.Tensor, cfg: StereoSpikeConfig,
            state: Optional[State] = None, *, fire_fn: FireFn = multistep_fire):
    """One timestep. ``frame``: [B, H, W, C_in] (NHWC, as in the JAX package).

    Returns ``(depths, spikes, new_state)``: ``depths`` full-scale first,
    each [B, H, W, 1]; ``spikes`` = [out_rconv, out_add4, ..., out_add1] as
    NHWC views; ``new_state`` the membrane state after this step.
    ``fire_fn`` is the fused fire (the kernel wrapper; its plain version
    for a comparison run). Gradients flow to ``params`` and ``frame``
    through the fire's surrogate when grad mode is on."""
    if not cfg.detach_reset or cfg.v_reset != 0.0:
        raise NotImplementedError(
            "the fused fire kernel implements the detached hard reset to 0 "
            f"only (detach_reset={cfg.detach_reset}, v_reset={cfg.v_reset!r})")
    x_in = frame.permute(0, 3, 1, 2).contiguous()
    if state is None:
        state = init_state(cfg, frame.shape[0], frame.dtype, device=frame.device)
    new_state: State = {}

    def fire(site: str, x: torch.Tensor) -> torch.Tensor:
        surrogate, alpha = cfg.site_surrogate(site)
        spikes, v = fire_fn(x.reshape(1, -1), state[site].reshape(-1),
                            _leak(params, cfg, site, x), cfg.v_threshold,
                            cfg.v_reset, cfg.site_neuron(site) == "if",
                            surrogate=surrogate, alpha=alpha)
        new_state[site] = v.view(x.shape)
        return spikes.view(x.shape)

    ms = cfg.multiply_factor if not cfg.learnable_multiply else 1.0
    sizes = cfg.sizes

    def enc(site: str, x: torch.Tensor, stride: int) -> torch.Tensor:
        return fire(site, conv_scale(x, _block(params, site), stride=stride,
                                     padding=2, static_scale=ms))

    out_bottom = enc("bottom", x_in, 1)
    out_conv1 = enc("conv1", out_bottom, 2)
    out_conv2 = enc("conv2", out_conv1, 2)
    out_conv3 = enc("conv3", out_conv2, 2)
    out_conv4 = enc("conv4", out_conv3, 2)

    out = sew_block_apply(_block(params, "sew1_a"), _block(params, "sew1_b"), out_conv4,
                          lambda x: fire("sew1_a", x), lambda x: fire("sew1_b", x),
                          static_scale=ms, connect_fn=cfg.connect_fn)
    out_rconv = sew_block_apply(_block(params, "sew2_a"), _block(params, "sew2_b"), out,
                                lambda x: fire("sew2_a", x), lambda x: fire("sew2_b", x),
                                static_scale=ms, connect_fn=cfg.connect_fn)

    v_depth = state["Ineurons"]
    skips = (out_bottom, out_conv1, out_conv2, out_conv3)
    depths_by_scale: Dict[int, torch.Tensor] = {}
    spikes: List[torch.Tensor] = [out_rconv]
    x = out_rconv
    for scale in (4, 3, 2, 1):
        site = f"deconv{scale}"
        x = fire(site, upsample_conv_scale(x, _block(params, site),
                                           target_hw=sizes[scale - 1], static_scale=ms))
        if cfg.use_skips:
            x = x + skips[scale - 1]
        spikes.append(x)
        if scale in cfg.heads:
            charge = upsample_conv_scale(x, _block(params, f"pred{scale}"),
                                         target_hw=sizes[0], static_scale=ms)
            v_depth = integrator_step(v_depth, charge)
            depths_by_scale[scale] = v_depth
    new_state["Ineurons"] = v_depth
    b, _, h, w = v_depth.shape
    depths = [depths_by_scale[s].reshape(b, h, w, 1) for s in sorted(cfg.heads)]
    return depths, [s.permute(0, 2, 3, 1) for s in spikes], new_state


def forward_sequence(params: Params, frames: torch.Tensor, cfg: StereoSpikeConfig,
                     state: Optional[State] = None, *, remat: bool = False,
                     fire_fn: FireFn = multistep_fire):
    """Run :func:`forward` over time. ``frames``: [B, T, H, W, C].

    Membrane potentials (the depth integrator's included) carry across the
    steps; returns the **last** step's ``(depths, spikes, new_state)``.
    Steps 0..T-2 keep only the state. ``remat=True`` recomputes each of
    them in the backward pass (``torch.utils.checkpoint``), so memory holds
    O(1) steps of activations instead of O(T); their fire kernels then
    launch twice."""
    steps = frames.shape[1]
    if state is None:
        state = init_state(cfg, frames.shape[0], frames.dtype, device=frames.device)

    def step(st: State, frame: torch.Tensor) -> State:
        return forward(params, frame, cfg, st, fire_fn=fire_fn)[2]

    for t in range(steps - 1):
        if remat:
            state = checkpoint(step, state, frames[:, t], use_reentrant=False)
        else:
            state = step(state, frames[:, t])
    return forward(params, frames[:, -1], cfg, state, fire_fn=fire_fn)
