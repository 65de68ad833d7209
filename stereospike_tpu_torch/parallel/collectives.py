"""The collectives that the model, the losses and the steps call under data
parallelism (``parallel/mesh.py`` sets up the process group and the
sharded steps; this module needs only ``torch.distributed``)."""

from __future__ import annotations

from typing import Iterable, Optional

import torch
import torch.distributed as dist


class _Psum(torch.autograd.Function):
    """Σ over ranks; the backward is the identity or, with
    ``sum_cotangents``, the same sum over ranks."""

    @staticmethod
    def forward(ctx, x, group, sum_cotangents: bool):
        ctx.group, ctx.sum_cotangents = group, sum_cotangents
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_cotangents:
            g = g.clone()
            dist.all_reduce(g, group=ctx.group)
        return g, None, None


def psum(x: torch.Tensor, group: Optional["dist.ProcessGroup"], *,
         sum_cotangents: bool = False) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (``x`` itself when ``group``
    is None), differentiable.

    The default backward is the identity: for a sum that every rank then
    feeds into the same replicated math (the loss from its sufficient
    statistics), each rank's cotangent is already the whole derivative of
    the global loss, so each rank's backward holds its own data's share of
    the gradient, and the shares are summed by :func:`all_reduce_grads`.
    (``torch.distributed.nn.functional.all_reduce`` sums the cotangents
    too, which counts every term ``world`` times there.) A sum that feeds
    each rank's own activations (BatchNorm's batch statistics) gets its
    cotangent from each rank's data alone: ``sum_cotangents=True`` sums
    them, so each rank's backward sees the global derivative."""
    if group is None:
        return x
    return _Psum.apply(x, group, sum_cotangents)


def world_size(group: Optional["dist.ProcessGroup"]) -> int:
    """The ranks of ``group`` (1 without one). Every rank's batch has the
    same shape, so a count fixed by the shapes is the local one times this."""
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_grads(params: Iterable[torch.Tensor], group: "dist.ProcessGroup") -> None:
    """Sum each parameter's ``.grad`` over ranks with one all-reduce of a
    flattened buffer (a missing gradient counts as zeros); each ``.grad``
    becomes a view of the summed buffer."""
    params = list(params)
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    offset = 0
    for p, g in zip(params, grads):
        p.grad = flat[offset:offset + g.numel()].view_as(g)
        offset += g.numel()
