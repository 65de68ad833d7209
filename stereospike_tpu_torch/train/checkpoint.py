"""Atomic full-state checkpoints (counterpart of ``stereospike_tpu/train/checkpoint.py``).

The whole train state (``train/state.py::TrainState``, or the ANN's
``AnnTrainState``) goes into one file: the parameters, Adam's state, the
step, the epoch, the best validation metric, the augmentation generators'
states and, for the ANN, the BatchNorm running statistics. It is a plain
dict of tensors, numbers and lists, so ``torch.load(weights_only=True)``
reads it back. Every write is atomic: a temporary file in the same
directory, fsync, ``os.replace``. ``best.pt`` holds the best-on-val state
(the reference's semantics), ``latest.pt`` the resume point,
``<tag>.pt`` periodic snapshots, and ``checkpoint_meta.json`` the step,
epoch, best metric and whatever the loop adds (``steps_per_epoch``,
``epoch_step_offset``).
"""

from __future__ import annotations

import io
import json
import os
import tempfile
from typing import Dict, Optional

import torch

from stereospike_tpu_torch.utils.logging import is_lead_process

BEST = "best.pt"
LATEST = "latest.pt"
META = "checkpoint_meta.json"
_GENERATORS = ("generator", "device_generator")


def _atomic_write(path: str, data: bytes) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in tensors.items()}


def state_dict(state, generators: Optional[Dict[str, object]] = None) -> Dict:
    """The checkpoint's dict of a train state. ``generators`` overrides the
    generators' current states (a loop that has drawn ahead of its last
    trained batch saves the states it needs on resume); a data-parallel
    loop gives each generator's states as a list, one per rank."""
    out = {"params": _cpu(state.params),
           "optimizer": state.optimizer.state_dict(),
           "step": int(state.step), "epoch": int(state.epoch),
           "best_metric": float(state.best_metric)}
    if getattr(state, "bn_state", None) is not None:
        out["bn_state"] = _cpu(state.bn_state)
    for name in _GENERATORS:
        if generators is not None and name in generators:
            out[name] = generators[name]
        else:
            g = getattr(state, name, None)
            out[name] = None if g is None else g.get_state()
    return out


def save_checkpoint(ckpt_dir: str, state, *, best: bool = False, tag: Optional[str] = None,
                    meta_extra: Optional[dict] = None,
                    generators: Optional[Dict[str, object]] = None) -> str:
    """Write ``latest`` (always), plus ``best`` and the ``tag`` snapshot.

    ``meta_extra`` merges more run facts into ``checkpoint_meta.json``
    (the steps per epoch the LR schedule was built on, so that a resume
    with another batch size keeps the milestones where they were)."""
    path = os.path.join(ckpt_dir, LATEST)
    if not is_lead_process():
        return path
    buf = io.BytesIO()
    torch.save(state_dict(state, generators), buf)
    data = buf.getvalue()
    _atomic_write(path, data)
    if best:
        _atomic_write(os.path.join(ckpt_dir, BEST), data)
    if tag is not None:
        _atomic_write(os.path.join(ckpt_dir, f"{tag}.pt"), data)
    meta = {"step": int(state.step), "epoch": int(state.epoch),
            "best_metric": float(state.best_metric), **(meta_extra or {})}
    _atomic_write(os.path.join(ckpt_dir, META), json.dumps(meta, indent=2).encode())
    return path


def load_meta(ckpt_dir: str) -> Optional[dict]:
    """``checkpoint_meta.json``, if present."""
    path = os.path.join(ckpt_dir, META)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def has_checkpoint(ckpt_dir: str, which: str = LATEST) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, which))


def _load(ckpt_dir: str, which: str) -> Dict:
    return torch.load(os.path.join(ckpt_dir, which), map_location="cpu", weights_only=True)


def _copy_into(target: Dict[str, torch.Tensor], saved: Dict[str, torch.Tensor],
               what: str) -> None:
    if set(saved) != set(target):
        raise KeyError(f"checkpoint {what} keys differ: missing "
                       f"{sorted(set(target) - set(saved))[:4]}, unexpected "
                       f"{sorted(set(saved) - set(target))[:4]}")
    with torch.no_grad():
        for k, t in target.items():
            if tuple(saved[k].shape) != tuple(t.shape):
                raise ValueError(f"checkpoint {what} '{k}' is {tuple(saved[k].shape)}, "
                                 f"expected {tuple(t.shape)}")
            t.copy_(saved[k])


def restore_checkpoint(ckpt_dir: str, target, which: str = LATEST, rank: int = 0):
    """Restore a checkpoint into ``target`` (a train state of the same
    structure) in place, and return it. Generators saved one per rank give
    ``rank`` its own; a rank beyond those saved keeps its fresh ones."""
    sd = _load(ckpt_dir, which)
    _copy_into(target.params, sd["params"], "params")
    target.optimizer.load_state_dict(sd["optimizer"])
    if "bn_state" in sd:
        _copy_into(target.bn_state, sd["bn_state"], "bn_state")
    target.step, target.epoch = int(sd["step"]), int(sd["epoch"])
    target.best_metric = float(sd["best_metric"])
    for name in _GENERATORS:
        g, saved = getattr(target, name, None), sd.get(name)
        if isinstance(saved, list):
            saved = saved[rank] if rank < len(saved) else None
        if g is not None and saved is not None:
            g.set_state(saved)
    return target


def restore_params(ckpt_dir: str, target_params: Dict[str, torch.Tensor],
                   which: str = BEST) -> Dict[str, torch.Tensor]:
    """Weights only (the reference's eval path, test.py:84): the saved
    parameters in ``target_params``' dtypes and devices."""
    return restore_fields(ckpt_dir, {"params": target_params}, which)["params"]


def restore_fields(ckpt_dir: str, targets: Dict[str, Dict[str, torch.Tensor]],
                   which: str = BEST) -> Dict[str, Dict[str, torch.Tensor]]:
    """A subset of the saved tensor dicts by name (``params``, ``bn_state``),
    each in its target's dtypes and devices, without the optimizer's."""
    sd = _load(ckpt_dir, which)
    out = {}
    for name, target in targets.items():
        fresh = {k: v.detach().clone() for k, v in target.items()}
        _copy_into(fresh, sd[name], name)
        out[name] = fresh
    return out
