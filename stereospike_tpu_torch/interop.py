"""Exchange of parameters and membrane state with the JAX package
(counterpart of ``stereospike_tpu/interop.py``).

The port's parameters already live under the reference ``.pth`` keys
(``models/stereospike.py::SITE_KEYS``), so the bridge from the JAX
parameter tree (HWIO weights, ``{'bottom': {'w'}, 'sew1': {'conv1': ...},
'pred1': {'w', 'b'}, 'plif': {site: w}}``) is a transposition to OIHW and
a renaming, both ways (:func:`params_from_jax`, :func:`params_to_jax`).
Arrays come in and go out as numpy, so neither package imports the other.

State: the JAX package keeps NHWC membranes, with the level-0 sites
``bottom`` and ``deconv1`` in space-to-depth layout ``[B, H/2, W/2, 4C]``
when ``cfg.use_s2d_level0``; the port keeps NCHW everywhere.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from stereospike_tpu_torch.models.stereospike import (
    SITE_KEYS,
    SITE_LEVEL,
    StereoSpikeConfig,
    _site_shapes,
)
from stereospike_tpu_torch.nn.layers import depth_to_space, space_to_depth

# port site → path of its conv in the JAX parameter tree
_JAX_PATHS = {site: (site,) for site in SITE_KEYS}
_JAX_PATHS.update({"sew1_a": ("sew1", "conv1"), "sew1_b": ("sew1", "conv2"),
                   "sew2_a": ("sew2", "conv1"), "sew2_b": ("sew2", "conv2")})


def _leaf(tree: Mapping, path) -> Mapping:
    for p in path:
        tree = tree[p]
    return tree


def params_from_jax(tree: Mapping, cfg: StereoSpikeConfig, *,
                    device: Union[str, torch.device] = "cpu") -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) → the port's parameter dict, in the
    leaves' own dtype, on ``device``."""
    out: Dict[str, np.ndarray] = {}
    for site in _site_shapes(cfg):
        stem, scale_key, plif_key = SITE_KEYS[site]
        leaf = _leaf(tree, _JAX_PATHS[site])
        out[f"{stem}.weight"] = np.asarray(leaf["w"]).transpose(3, 2, 0, 1)  # HWIO → OIHW
        if "b" in leaf:
            out[f"{stem}.bias"] = np.asarray(leaf["b"])
        if "scale" in leaf:
            out[scale_key] = np.asarray(leaf["scale"]).reshape(1)
        if plif_key is not None and site in tree.get("plif", {}):
            out[plif_key] = np.asarray(tree["plif"][site]).reshape(())
    return {k: torch.from_numpy(np.array(v, order="C")).to(device) for k, v in out.items()}


def params_to_jax(params: Mapping[str, torch.Tensor],
                  cfg: StereoSpikeConfig) -> Dict[str, object]:
    """The port's parameter dict → the JAX parameter tree with numpy leaves
    (the inverse of :func:`params_from_jax`), in the tensors' own dtype."""
    tree: Dict[str, object] = {}
    for site in _site_shapes(cfg):
        stem, scale_key, plif_key = SITE_KEYS[site]
        leaf = {"w": params[f"{stem}.weight"].detach().cpu().numpy().transpose(2, 3, 1, 0)}
        if f"{stem}.bias" in params:
            leaf["b"] = params[f"{stem}.bias"].detach().cpu().numpy()
        if scale_key in params:
            leaf["scale"] = params[scale_key].detach().cpu().numpy().reshape(1)
        node = tree
        for p in _JAX_PATHS[site][:-1]:
            node = node.setdefault(p, {})
        node[_JAX_PATHS[site][-1]] = {k: np.ascontiguousarray(v) for k, v in leaf.items()}
        if plif_key is not None and plif_key in params:
            tree.setdefault("plif", {})[site] = params[plif_key].detach().cpu().numpy().reshape(())
    return tree


def _s2d_site(cfg: StereoSpikeConfig, site: str) -> bool:
    return cfg.use_s2d_level0 and SITE_LEVEL.get(site) == 0


def state_from_jax(state: Mapping, cfg: StereoSpikeConfig, *,
                   device: Union[str, torch.device] = "cpu") -> Dict[str, torch.Tensor]:
    """JAX membrane state (numpy leaves) → the port's NCHW state."""
    out = {}
    for site, v in state.items():
        t = torch.from_numpy(np.array(v, order="C"))
        if _s2d_site(cfg, site):
            t = depth_to_space(t)
        out[site] = t.permute(0, 3, 1, 2).contiguous().to(device)
    return out


def state_to_jax(state: Mapping[str, torch.Tensor],
                 cfg: StereoSpikeConfig) -> Dict[str, np.ndarray]:
    """The port's NCHW state → the JAX package's layout, as numpy."""
    out = {}
    for site, v in state.items():
        t = v.detach().cpu().permute(0, 2, 3, 1)
        if _s2d_site(cfg, site):
            t = space_to_depth(t)
        out[site] = t.contiguous().numpy()
    return out
