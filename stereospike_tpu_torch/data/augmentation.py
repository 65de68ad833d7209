"""Data augmentation of canonical batches on the batch's device
(counterpart of ``stereospike_tpu/data/augmentation.py``).

The reference's per-sample transforms (``datasets/data_augmentation.py``)
as vectorized tensor code: each transform takes a per-sample Bernoulli
flag and selects between the original and the transformed sample with
``torch.where``.

Batch layout: ``chunks`` [B, T, H, W, C], C channel-stacked eye-major
(eye, chunk, frame, polarity); ``gt``/``mask``/``init_pots``/``init_mask``
[B, H, W, 1]; optionally ``warmup`` [B, Tw, H, W, C].

- horizontal/vertical flip (data_augmentation.py:33-82): flip W / H of
  every spatial entry together;
- time mirror (:85-124): reverse T and, within each eye's channel block,
  the (chunk, frame, polarity) order, over [warmup | chunks] jointly, and
  swap ``gt ↔ init_pots`` together with ``mask ↔ init_mask``;
- event drop (:127-163): a per-sample rate q ~ U[min, max], each count
  zeroed with probability q.

Draws. The per-sample draws (the four flags and q) come from a CPU
``torch.Generator``, as one [5, B] uniform block in a fixed order; the
per-element keep masks of the event drop from a generator on the batch's
device. Every transform also takes its draws as arguments (``flag``,
``q``, ``keep``), so that a test can feed it the draws JAX made. The
streams differ from ``jax.random``'s. :func:`time_mirror_flags` peeks at
the CPU generator and returns exactly the flags :func:`augment_batch`
will draw from it, so that an input stage can swap the labels on the host
before the upload and pass the flags in: both paths give identical batches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

Batch = Dict[str, torch.Tensor]
_SPATIAL = ("gt", "mask", "init_pots", "init_mask")
# rows of the per-sample draw block
_HFLIP, _VFLIP, _MIRROR, _DROP, _Q = range(5)


def _sel(flag: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(flag.to(a.device).view(-1, *([1] * (a.dim() - 1))), a, b)


def _flag(batch: Batch, p: float, generator: Optional[torch.Generator],
          flag: Optional[torch.Tensor]) -> torch.Tensor:
    if flag is None:
        flag = torch.rand(batch["gt"].shape[0], generator=generator) < p
    return flag


def _flip(batch: Batch, flag: torch.Tensor, frame_dim: int) -> Batch:
    """Flip spatial dim ``frame_dim`` of [B, T, H, W, C] entries and
    ``frame_dim - 1`` of [B, H, W, 1] entries, where ``flag``."""
    out = dict(batch)
    for k in ("chunks", "warmup"):
        if k in batch:
            out[k] = _sel(flag, batch[k].flip(frame_dim), batch[k])
    for k in _SPATIAL:
        if k in batch:
            out[k] = _sel(flag, batch[k].flip(frame_dim - 1), batch[k])
    return out


def random_horizontal_flip(batch: Batch, p: float = 0.5, *,
                           generator: Optional[torch.Generator] = None,
                           flag: Optional[torch.Tensor] = None) -> Batch:
    return _flip(batch, _flag(batch, p, generator, flag), 3)


def random_vertical_flip(batch: Batch, p: float = 0.5, *,
                         generator: Optional[torch.Generator] = None,
                         flag: Optional[torch.Tensor] = None) -> Batch:
    return _flip(batch, _flag(batch, p, generator, flag), 2)


def _mirror_channels(x: torch.Tensor, eyes: int) -> torch.Tensor:
    """Reverse T and, within each eye block, the stacked channel order."""
    b, t, h, w, c = x.shape
    return x.flip(1).reshape(b, t, h, w, eyes, c // eyes).flip(5).reshape(b, t, h, w, c)


def random_time_mirror(batch: Batch, p: float = 0.5, eyes: int = 2, *,
                       generator: Optional[torch.Generator] = None,
                       flag: Optional[torch.Tensor] = None) -> Batch:
    """Mirror time where ``flag``. The chronological order is [warmup |
    chunks]: mirroring reverses the concatenation and splits it again
    (data_augmentation.py:103-112). ``gt ↔ init_pots`` swap with their
    masks, so a batch that carries ``init_pots`` must carry ``init_mask``."""
    flag = _flag(batch, p, generator, flag)
    out = dict(batch)
    if "warmup" in batch:
        t_w = batch["warmup"].shape[1]
        mirrored = _mirror_channels(torch.cat([batch["warmup"], batch["chunks"]], dim=1), eyes)
        out["warmup"] = _sel(flag, mirrored[:, :t_w], batch["warmup"])
        out["chunks"] = _sel(flag, mirrored[:, t_w:], batch["chunks"])
    else:
        out["chunks"] = _sel(flag, _mirror_channels(batch["chunks"], eyes), batch["chunks"])
    if "init_pots" in batch:
        if "init_mask" not in batch:
            raise ValueError("time-mirror swaps gt<->init_pots and must swap their masks: "
                             "batches carrying init_pots must also carry init_mask")
        out["init_pots"] = _sel(flag, batch["gt"], batch["init_pots"])
        out["gt"] = _sel(flag, batch["init_pots"], batch["gt"])
        out["init_mask"] = _sel(flag, batch["mask"], batch["init_mask"])
        out["mask"] = _sel(flag, batch["init_mask"], batch["mask"])
    return out


def _keep(x: torch.Tensor, q: torch.Tensor,
          device_generator: Optional[torch.Generator]) -> torch.Tensor:
    u = torch.rand(x.shape, generator=device_generator, device=x.device)
    return u > q.to(x.device).view(-1, *([1] * (x.dim() - 1)))


def random_event_drop(batch: Batch, p: float = 0.5, min_drop_rate: float = 0.0,
                      max_drop_rate: float = 0.4, *,
                      generator: Optional[torch.Generator] = None,
                      device_generator: Optional[torch.Generator] = None,
                      flag: Optional[torch.Tensor] = None, q: Optional[torch.Tensor] = None,
                      keep: Optional[torch.Tensor] = None,
                      keep_warmup: Optional[torch.Tensor] = None) -> Batch:
    """Where ``flag``, zero each count of ``chunks`` (and ``warmup``) whose
    keep mask is False; the masks are ``U(0, 1) > q`` per element."""
    b = batch["gt"].shape[0]
    if flag is None:
        flag = torch.rand(b, generator=generator) < p
    if q is None:
        q = min_drop_rate + torch.rand(b, generator=generator) * (max_drop_rate - min_drop_rate)
    out = dict(batch)
    for k, mask in (("chunks", keep), ("warmup", keep_warmup)):
        if k in batch:
            x = batch[k]
            mask = _keep(x, q, device_generator) if mask is None else mask.to(x.device)
            out[k] = _sel(flag, x * mask, x)
    return out


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """The reference's composed pipeline (data_augmentation.py:166-172)."""

    hflip_p: float = 0.5
    vflip_p: float = 0.1
    time_mirror_p: float = 0.5
    event_drop_p: float = 0.6
    min_drop_rate: float = 0.0
    max_drop_rate: float = 0.4
    eyes: int = 2


def _draws(batch_size: int, generator: torch.Generator) -> torch.Tensor:
    """The per-sample draw block [5, B] of one :func:`augment_batch` call."""
    return torch.rand((5, batch_size), generator=generator)


def time_mirror_flags(generator: torch.Generator, batch_size: int,
                      cfg: AugmentConfig = AugmentConfig()) -> torch.Tensor:
    """The time-mirror flags [B] (bool, CPU) that :func:`augment_batch`
    will draw from ``generator``'s current state; ``generator`` does not
    advance."""
    peek = torch.Generator()
    peek.set_state(generator.get_state())
    return _draws(batch_size, peek)[_MIRROR] < cfg.time_mirror_p


def augment_batch(batch: Batch, cfg: AugmentConfig = AugmentConfig(), *,
                  generator: torch.Generator, device_generator: Optional[torch.Generator],
                  mirror_flag: Optional[torch.Tensor] = None) -> Batch:
    """All four transforms, in the reference's order. ``generator`` (CPU)
    gives the flags and drop rates, ``device_generator`` (on the batch's
    device) the keep masks, drawn for ``chunks`` then ``warmup`` whatever
    the flags. ``mirror_flag`` replaces the drawn time-mirror flags by
    :func:`time_mirror_flags`' (equal by construction) for the host-swap
    input path; every draw happens all the same."""
    u = _draws(batch["gt"].shape[0], generator)
    q = cfg.min_drop_rate + u[_Q] * (cfg.max_drop_rate - cfg.min_drop_rate)
    keep = _keep(batch["chunks"], q, device_generator)
    keep_warmup = _keep(batch["warmup"], q, device_generator) if "warmup" in batch else None
    flag = u[_MIRROR] < cfg.time_mirror_p if mirror_flag is None else mirror_flag
    batch = random_horizontal_flip(batch, flag=u[_HFLIP] < cfg.hflip_p)
    batch = random_vertical_flip(batch, flag=u[_VFLIP] < cfg.vflip_p)
    batch = random_time_mirror(batch, eyes=cfg.eyes, flag=flag)
    return random_event_drop(batch, flag=u[_DROP] < cfg.event_drop_p, q=q, keep=keep,
                             keep_warmup=keep_warmup)


def burn_augment_draws(batch_size: int, chunks_shape, warmup_shape,
                       generator: torch.Generator,
                       device_generator: Optional[torch.Generator],
                       device: torch.device) -> None:
    """Advance both generators past one :func:`augment_batch` call on a
    batch of these shapes without augmenting (a resumed run skipping the
    batches an interrupted epoch had already trained on)."""
    _draws(batch_size, generator)
    for shape in (chunks_shape, warmup_shape):
        if shape is not None:
            torch.rand(shape, generator=device_generator, device=device)
