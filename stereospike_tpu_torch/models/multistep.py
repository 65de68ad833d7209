"""Layer-major multi-timestep forward (counterpart of
``stereospike_tpu/models/multistep.py``).

:func:`~stereospike_tpu_torch.models.stereospike.forward_sequence` runs
the whole network once per timestep. The network is feedforward, so it can
run **layer-major** instead: each layer takes all T timesteps before the
next layer starts.

- Every conv runs over the T·B merged samples of an NCHW ``[T·B, C, h, w]``
  tensor, T-major: rows t·B .. (t+1)·B - 1 are step t.
- Each of the 13 spiking sites calls the fused fire **once** over all T
  steps. A ``.view(T, -1)`` of the T-major tensor is the kernel's
  ``[T, M]`` with ``M = B·C·h·w``, and the site's state ``[B, C, h, w]``
  viewed as ``[M]`` is its ``v0``, so no copy is made around a site. On
  the card that is ``csrc/fire_fwd.cu`` and, under autograd,
  ``csrc/fire_bwd.cu``: 13 launches of each per step instead of 13·T.

The JAX function chooses between an unrolled chain and the Pallas kernel
(``use_pallas``, ``interpret``), because on the TPU the kernel's opaque
custom call forced ``[T·B, h, w, c] ↔ [T, M]`` relayouts around every
site. That relayout does not exist here, so the port has no such switch:
every site takes ``fire_fn``, the kernel wrapper by default.

Outputs match ``forward_sequence``: the last step's depths and spikes and
the final state; the depth-integrator pool adds the heads' charges in the
order that the shared I-neurons do.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from stereospike_tpu_torch.models.stereospike import (
    FireFn,
    Params,
    State,
    StereoSpikeConfig,
    _block,
    _leak,
    init_state,
)
from stereospike_tpu_torch.nn.blocks import conv_scale, sew_block_apply, upsample_conv_scale
from stereospike_tpu_torch.snn.cuda_kernels import multistep_fire


def forward_multistep(params: Params, frames: torch.Tensor, cfg: StereoSpikeConfig,
                      state: Optional[State] = None, *, fire_fn: FireFn = multistep_fire):
    """``frames`` [B, T, H, W, C] → ``(depths, spikes, new_state)`` of the
    last step, as :func:`~stereospike_tpu_torch.models.stereospike.forward_sequence`
    returns them: ``depths`` full-scale first, each [B, H, W, 1]; ``spikes``
    [out_rconv, out_add4, ..., out_add1] of step T-1 as NHWC views; the
    membrane state after step T-1."""
    b, steps = frames.shape[:2]
    if state is None:
        state = init_state(cfg, b, frames.dtype, device=frames.device)
    new_state: State = {}
    ms = cfg.multiply_factor if not cfg.learnable_multiply else 1.0
    sizes = cfg.sizes

    def step_slice(a: torch.Tensor, t: int) -> torch.Tensor:
        """Step t's [B, ...] rows of a T-major [T·B, ...] tensor (a view)."""
        return a[t * b:(t + 1) * b]

    def fire(site: str, x: torch.Tensor) -> torch.Tensor:
        surrogate, alpha = cfg.site_surrogate(site)
        v0 = state[site]
        # x.view: the conv's own T-major layout is the kernel's [T, M]; a
        # layout that is not would raise here rather than be copied
        spikes, v = fire_fn(x.view(steps, -1), v0.reshape(-1), _leak(params, cfg, site, x),
                            cfg.v_threshold, cfg.v_reset, cfg.site_neuron(site) == "if",
                            surrogate=surrogate, alpha=alpha, detach_reset=cfg.detach_reset)
        new_state[site] = v.view(v0.shape)
        return spikes.view(x.shape)

    def enc(site: str, x: torch.Tensor, stride: int) -> torch.Tensor:
        return fire(site, conv_scale(x, _block(params, site), stride=stride, padding=2,
                                     static_scale=ms))

    def sew(block: str, x: torch.Tensor) -> torch.Tensor:
        return sew_block_apply(_block(params, f"{block}_a"), _block(params, f"{block}_b"), x,
                               lambda c: fire(f"{block}_a", c), lambda c: fire(f"{block}_b", c),
                               static_scale=ms, connect_fn=cfg.connect_fn)

    # the one transpose in: [B, T, H, W, C] → T-major NCHW [T·B, C, H, W],
    # contiguous, so that every conv after it writes contiguous NCHW
    h, w, c = frames.shape[2:]
    x = frames.permute(1, 0, 4, 2, 3).contiguous().view(steps * b, c, h, w)
    out_bottom = enc("bottom", x, 1)
    out_conv1 = enc("conv1", out_bottom, 2)
    out_conv2 = enc("conv2", out_conv1, 2)
    out_conv3 = enc("conv3", out_conv2, 2)
    out_conv4 = enc("conv4", out_conv3, 2)
    out_rconv = sew("sew2", sew("sew1", out_conv4))

    skips = (out_bottom, out_conv1, out_conv2, out_conv3)
    charges: Dict[int, torch.Tensor] = {}
    spikes_last: List[torch.Tensor] = [step_slice(out_rconv, steps - 1)]
    xdec = out_rconv
    for scale in (4, 3, 2, 1):
        site = f"deconv{scale}"
        xdec = fire(site, upsample_conv_scale(xdec, _block(params, site),
                                              target_hw=sizes[scale - 1], static_scale=ms))
        if cfg.use_skips:
            xdec = xdec + skips[scale - 1]
        spikes_last.append(step_slice(xdec, steps - 1))
        if scale in cfg.heads:
            charges[scale] = upsample_conv_scale(xdec, _block(params, f"pred{scale}"),
                                                 target_hw=sizes[0], static_scale=ms)

    # depth-integrator pool: within step t the heads charge in the order
    # 4 → 1, and the potential carries across steps. So the last step's
    # depth_k is v0 + every charge of steps < T-1 + the charges of the
    # heads >= k at step T-1 (summed in the JAX package's order).
    head_order = sorted(cfg.heads, reverse=True)
    running = state["Ineurons"].to(frames.dtype)
    if steps > 1:
        running = running + sum(step_slice(charges[s], t)
                                for s in head_order for t in range(steps - 1))
    depths_by_scale: Dict[int, torch.Tensor] = {}
    for s in head_order:
        running = running + step_slice(charges[s], steps - 1)
        depths_by_scale[s] = running
    new_state["Ineurons"] = running

    depths = [depths_by_scale[s].reshape(b, h, w, 1) for s in sorted(cfg.heads)]
    return depths, [s.permute(0, 2, 3, 1) for s in spikes_last], new_state
