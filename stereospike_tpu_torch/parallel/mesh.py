"""Data-parallel training over ``torch.distributed`` (counterpart of
``stereospike_tpu/parallel/mesh.py``).

The JAX package lays a ``('data', 'spatial')`` device mesh over its
devices and lets GSPMD derive the collectives. Here each rank is one
process with one device, launched by ``python -m torch.distributed.run``
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``),
which is the JAX package's multi-host contract: ``batch_size`` is per
process, each process reads its own shard of the data, and the global batch
is ``batch_size × world``. The collectives are written out:

- the loss and the MDE are formed from sufficient statistics summed over
  ranks (``collectives.psum`` in ``objectives/``: one all-reduce of every
  head's loss statistics, one of the MDE's, one more with the spike
  penalty), so they equal the single-device values on the global batch;
- the ANN's BatchNorm normalizes by global-batch statistics (a sum and a
  centred sum of squares over ranks, ``nn/blocks.py``), so its running
  statistics equal the single-device ones;
- after each rank's backward, its fp32 master gradients, each its own
  data's share of the global gradient, are summed over ranks by one
  all-reduce of a flattened buffer (``collectives.all_reduce_grads``).

``make_train_step(..., group=mesh.group)`` (``train/steps.py``) is the
in-step counterpart of the JAX ``grad_psum_axis``, and so of
``make_shardmap_train_step``: a step over a rank's own batch. The
``make_sharded_*`` wrappers below take the global batch instead, as the
JAX jit-sharded steps do, and run each rank on its slice. Only the data
axis is ported: ``mesh_shape=(d, s>1)``, the H split with halo exchanges,
raises (ROADMAP A.7).
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

Device = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A data-parallel process group: this process's rank, the world size,
    the group its collectives run over and its device."""

    group: "dist.ProcessGroup"
    rank: int
    world: int
    device: torch.device


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_mesh(shape: Optional[Tuple[int, int]] = None, *, device: Device = "cuda") -> Mesh:
    """This process's place in a ``(data, 1)`` mesh of one device per process.

    The launch comes from the environment that ``python -m
    torch.distributed.run`` sets; a process group that the caller has
    initialized already is used as it is. Otherwise one is initialized:
    NCCL on ``cuda`` (after ``torch.cuda.set_device(LOCAL_RANK)``), gloo on
    ``cpu``; a world of one needs no launcher (a free localhost port).
    ``shape`` defaults to ``(world, 1)``; a data axis other than the world
    size raises ``ValueError``, a spatial axis above 1
    ``NotImplementedError``."""
    device = torch.device(device)
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        rank = int(os.environ.get("RANK", "0"))
    shape = (world, 1) if shape is None else tuple(shape)
    if len(shape) != 2:
        raise ValueError(f"mesh_shape {shape} must be (data, spatial)")
    if shape[1] != 1:
        raise NotImplementedError(
            f"mesh_shape {shape}: spatial sharding (the H split with halo exchanges) is not "
            "ported yet (ROADMAP A.7); use (data, 1)")
    if shape[0] != world:
        raise ValueError(
            f"mesh_shape {shape} needs one process per device on the data axis, and this "
            f"launch has {world}: run `python -m torch.distributed.run --nproc_per_node "
            f"{shape[0]} -m stereospike_tpu_torch.cli train --mesh-shape {shape[0]},1 ...`")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"running on {device} needs a CUDA device; "
                               "pass device='cpu' to run on the CPU")
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local_rank)
        device = torch.device("cuda", local_rank)
    if not dist.is_initialized():
        init = "env://"
        if world == 1 and "MASTER_ADDR" not in os.environ:
            init = f"tcp://localhost:{_free_port()}"
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=init, rank=rank, world_size=world)
    return Mesh(group=dist.group.WORLD, rank=rank, world=world, device=device)


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's contiguous slice of a global batch (every entry along
    dim 0, numpy arrays or tensors): rank r of w takes rows [r·B/w,
    (r+1)·B/w)."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % mesh.world:
            raise ValueError(f"batch '{k}' of {b} does not divide over {mesh.world} ranks")
        n = b // mesh.world
        out[k] = v[mesh.rank * n:(mesh.rank + 1) * n]
    return out


def make_sharded_train_step(step_fn: Callable, mesh: Mesh) -> Callable:
    """``step(state, global_batch)``: ``step_fn`` — built with ``group=
    mesh.group`` — on this rank's slice. The loss and MDE it returns are
    the global batch's, and the replicas stay equal."""
    def step(state, batch):
        return step_fn(state, shard_batch(batch, mesh))

    return step


# the ANN's train step takes (state, batch) as the SNN's does
make_sharded_ann_train_step = make_sharded_train_step


def _gather_eval(out: Dict[str, torch.Tensor], n_local: int, mesh: Mesh) -> Dict:
    """Per-sample means of the rank's slice → the global batch's, and the
    depth maps of every rank in rank order."""
    stats = torch.stack([out["loss"] * n_local, out["mde"] * n_local])
    dist.all_reduce(stats, group=mesh.group)
    depths = [torch.empty_like(out["depth"]) for _ in range(mesh.world)]
    dist.all_gather(depths, out["depth"].contiguous(), group=mesh.group)
    total = n_local * mesh.world
    return {"loss": stats[0] / total, "mde": stats[1] / total, "depth": torch.cat(depths)}


def make_sharded_eval_step(eval_fn: Callable, mesh: Mesh) -> Callable:
    """``eval(params, global_batch)``: ``eval_fn`` on this rank's slice,
    then the per-sample loss and MDE means of the global batch and its
    depth maps, the same on every rank."""
    def step(params, batch):
        local = shard_batch(batch, mesh)
        return _gather_eval(eval_fn(params, local), local["gt"].shape[0], mesh)

    return step


def make_sharded_ann_eval_step(eval_fn: Callable, mesh: Mesh) -> Callable:
    """``eval(params, bn_state, global_batch)``, as :func:`make_sharded_eval_step`."""
    def step(params, bn_state, batch):
        local = shard_batch(batch, mesh)
        return _gather_eval(eval_fn(params, bn_state, local), local["gt"].shape[0], mesh)

    return step
