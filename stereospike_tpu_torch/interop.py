"""Exchange of parameters and membrane state with the JAX package
(counterpart of ``stereospike_tpu/interop.py``).

The port's parameters already live under the reference ``.pth`` keys
(``models/stereospike.py::SITE_KEYS``), so the bridge from the JAX
parameter tree (HWIO weights, ``{'bottom': {'w'}, 'sew1': {'conv1': ...},
'pred1': {'w', 'b'}, 'plif': {site: w}}``) is a transposition to OIHW and
a renaming, both ways (:func:`params_from_jax`, :func:`params_to_jax`).
Arrays come in and go out as numpy, so neither package imports the other.

The equivalent ANN's bridge (:func:`ann_params_from_jax`,
:func:`ann_params_to_jax`) maps the JAX ``(params, bn_state)`` trees
(conv ``{'w', 'b'}``, BN ``{'gamma', 'beta'}`` and ``{'mean', 'var'}``) to
the port's two flat dicts under the ``.pth`` keys.

Reference ``.pth`` files: :func:`load_torch_checkpoint` and
:func:`load_torch_ann_checkpoint` read them; :func:`params_to_torch_state_dict`
and :func:`ann_params_to_torch_state_dict` write the port's weights in
their layout, as the JAX exports of the same names do (``cli export-pth``).

State: the JAX package keeps NHWC membranes, with the level-0 sites
``bottom`` and ``deconv1`` in space-to-depth layout ``[B, H/2, W/2, 4C]``
when ``cfg.use_s2d_level0``; the port keeps NCHW everywhere.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch

from stereospike_tpu_torch.models.ann import ANN_BN_SITES, ANN_CONV_SITES
from stereospike_tpu_torch.models.stereospike import (
    SITE_KEYS,
    SITE_LEVEL,
    SPIKING_SITES,
    StereoSpikeConfig,
    _site_shapes,
)
from stereospike_tpu_torch.nn.layers import depth_to_space, space_to_depth

# port site → path of its conv in the JAX parameter tree
_JAX_PATHS = {site: (site,) for site in SITE_KEYS}
_JAX_PATHS.update({"sew1_a": ("sew1", "conv1"), "sew1_b": ("sew1", "conv2"),
                   "sew2_a": ("sew2", "conv1"), "sew2_b": ("sew2", "conv2")})


def _tensor(a, device) -> torch.Tensor:
    """A numpy leaf as a tensor of its own dtype on ``device`` (a copy)."""
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _leaf(tree: Mapping, path) -> Mapping:
    for p in path:
        tree = tree[p]
    return tree


def params_from_jax(tree: Mapping, cfg: StereoSpikeConfig, *,
                    device: Union[str, torch.device] = "cuda") -> Dict[str, torch.Tensor]:
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
    return {k: _tensor(v, device) for k, v in out.items()}


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
                   device: Union[str, torch.device] = "cuda") -> Dict[str, torch.Tensor]:
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


# JAX names of the BN leaves → the port's
_BN_PARAM_NAMES = {"gamma": "weight", "beta": "bias"}
_BN_STATE_NAMES = {"mean": "running_mean", "var": "running_var"}


def ann_params_from_jax(params_tree: Mapping, bn_state_tree: Mapping, *,
                        device: Union[str, torch.device] = "cuda"
                        ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """JAX ``(params, bn_state)`` trees of the equivalent ANN (numpy leaves)
    → the port's ``(params, bn_state)`` dicts, in the leaves' own dtype, on
    ``device``."""
    params: Dict[str, torch.Tensor] = {}
    for path, stem in ANN_CONV_SITES:
        leaf = _leaf(params_tree, path)
        params[f"{stem}.weight"] = _tensor(np.asarray(leaf["w"]).transpose(3, 2, 0, 1), device)
        if "b" in leaf:
            params[f"{stem}.bias"] = _tensor(leaf["b"], device)
    bn_state: Dict[str, torch.Tensor] = {}
    for path, stem in ANN_BN_SITES:
        for theirs, ours in _BN_PARAM_NAMES.items():
            params[f"{stem}.{ours}"] = _tensor(_leaf(params_tree, path)[theirs], device)
        for theirs, ours in _BN_STATE_NAMES.items():
            bn_state[f"{stem}.{ours}"] = _tensor(_leaf(bn_state_tree, path)[theirs], device)
    return params, bn_state


def _put(tree: Dict, path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def ann_params_to_jax(params: Mapping[str, torch.Tensor], bn_state: Mapping[str, torch.Tensor]
                      ) -> Tuple[Dict[str, object], Dict[str, object]]:
    """The port's ANN ``(params, bn_state)`` → the JAX trees with numpy
    leaves (the inverse of :func:`ann_params_from_jax`)."""
    def np_(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    tree: Dict[str, object] = {}
    for path, stem in ANN_CONV_SITES:
        leaf = {"w": np.ascontiguousarray(np_(params[f"{stem}.weight"]).transpose(2, 3, 1, 0))}
        if f"{stem}.bias" in params:
            leaf["b"] = np_(params[f"{stem}.bias"])
        _put(tree, path, leaf)
    state_tree: Dict[str, object] = {}
    for path, stem in ANN_BN_SITES:
        _put(tree, path, {theirs: np_(params[f"{stem}.{ours}"])
                          for theirs, ours in _BN_PARAM_NAMES.items()})
        _put(state_tree, path, {theirs: np_(bn_state[f"{stem}.{ours}"])
                                for theirs, ours in _BN_STATE_NAMES.items()})
    return tree, state_tree


def _checked(sd: Mapping[str, torch.Tensor], expected: Mapping[str, torch.Tensor],
             ignored: set, what: str, device) -> Dict[str, torch.Tensor]:
    """``expected``'s keys from ``sd``, shape-checked (PLIF ``w`` may come
    as [] or [1]), as float32 on ``device``; ``sd`` may hold nothing else
    but ``ignored`` keys."""
    missing = sorted(set(expected) - set(sd))
    unused = sorted(set(sd) - set(expected) - ignored)
    if missing or unused:
        raise KeyError(f"{what} does not match the config: missing {missing[:4]}, "
                       f"unmapped {unused[:4]} ({len(missing)} and {len(unused)} keys)")
    out = {}
    for k, ref in expected.items():
        t = torch.as_tensor(sd[k])
        if t.numel() == ref.numel() and t.dim() <= 1 and ref.dim() <= 1:
            t = t.reshape(ref.shape)  # 0-dim PLIF w and [1] scales either way
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{what} '{k}' is {tuple(t.shape)}, the config expects "
                             f"{tuple(ref.shape)}")
        out[k] = t.to(device=device, dtype=ref.dtype)
    return out


def _f32(t: torch.Tensor) -> torch.Tensor:
    """A float32 CPU copy, the reference ``.pth`` files' type."""
    return t.detach().to("cpu", torch.float32).clone()


def params_to_torch_state_dict(params: Mapping[str, torch.Tensor],
                               fill_missing_heads: bool = True) -> Dict[str, torch.Tensor]:
    """The port's parameters as the reference's ``state_dict``: float32 CPU
    tensors, OIHW weights, the 0-dim PLIF ``w`` that SpikingJelly's
    ``ParametricLIFNode`` keeps (a [1] one fails its ``load_state_dict``),
    in the JAX export's key order (the conv sites, then the PLIF nodes).

    ``fill_missing_heads``: the reference's cut-predict class still defines
    the prediction heads it does not call, so a strict ``load_state_dict``
    wants their keys; a head the parameters lack gets zeros (and scale 1
    when the model has learnable scales)."""
    any_scale = any(k.endswith(".scale_value") for k in params)
    out: Dict[str, torch.Tensor] = {}
    for site, (stem, scale_key, _) in SITE_KEYS.items():
        if f"{stem}.weight" not in params:
            if fill_missing_heads and site.startswith("pred"):
                c_in = params[f"deconv{site[-1]}.0.up.1.weight"].shape[0]
                out[f"{stem}.weight"] = torch.zeros(1, c_in, 3, 3)
                out[f"{stem}.bias"] = torch.zeros(1)
                if any_scale:
                    out[scale_key] = torch.ones(1)
            continue
        for key in (f"{stem}.weight", f"{stem}.bias", scale_key):
            if key in params:
                out[key] = _f32(params[key])
    for site in SPIKING_SITES:
        plif_key = SITE_KEYS[site][2]
        if plif_key in params:
            out[plif_key] = _f32(params[plif_key]).reshape(())
    return out


def ann_params_to_torch_state_dict(params: Mapping[str, torch.Tensor],
                                   bn_state: Mapping[str, torch.Tensor]
                                   ) -> Dict[str, torch.Tensor]:
    """The equivalent ANN's ``(params, bn_state)`` as the reference's
    ``state_dict``: float32 CPU tensors, the conv sites then the BN sites,
    each BN with ``num_batches_tracked`` 0 as the JAX export writes it."""
    out: Dict[str, torch.Tensor] = {}
    for _, stem in ANN_CONV_SITES:
        for key in (f"{stem}.weight", f"{stem}.bias"):
            if key in params:
                out[key] = _f32(params[key])
    for _, stem in ANN_BN_SITES:
        for key in ("weight", "bias"):
            out[f"{stem}.{key}"] = _f32(params[f"{stem}.{key}"])
        for key in ("running_mean", "running_var"):
            out[f"{stem}.{key}"] = _f32(bn_state[f"{stem}.{key}"])
        out[f"{stem}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return out


def load_torch_checkpoint(path: str, cfg: StereoSpikeConfig, *,
                          device: Union[str, torch.device] = "cuda") -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` state dict → the port's parameters for ``cfg``.

    The port's keys are the ``.pth`` keys, so this is ``torch.load(
    weights_only=True)`` and a key and shape check against ``cfg``: a
    missing or unmapped key raises (an ANN checkpoint, another neuron
    type), except the prediction heads that ``cfg`` cuts, which the
    reference class still defines."""
    from stereospike_tpu_torch.models.stereospike import init_params

    sd = torch.load(path, map_location="cpu", weights_only=True)
    expected = init_params(torch.Generator().manual_seed(0), cfg, device="meta")
    cut = {k for s in (1, 2, 3, 4) if s not in cfg.heads
           for k in sd if k.startswith(f"predict_depth{s}.")}
    return _checked(sd, expected, cut, f"checkpoint {path}", device)


def load_torch_ann_checkpoint(path: str, cfg, *, device: Union[str, torch.device] = "cuda"
                              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """A reference equivalent-ANN ``.pth`` → the port's ``(params,
    bn_state)`` for ``cfg`` (an ``AnnConfig``), key- and shape-checked;
    BatchNorm's ``num_batches_tracked`` is torch bookkeeping and dropped."""
    from stereospike_tpu_torch.models.ann import init_ann_params, init_ann_state

    sd = torch.load(path, map_location="cpu", weights_only=True)
    params = init_ann_params(torch.Generator().manual_seed(0), cfg, device="meta")
    bn_state = init_ann_state(cfg, device="meta")
    counters = {k for k in sd if k.endswith(".num_batches_tracked")}
    both = _checked(sd, {**params, **bn_state}, counters, f"checkpoint {path}", device)
    return ({k: both[k] for k in params}, {k: both[k] for k in bn_state})
