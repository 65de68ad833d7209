"""The train and eval steps (counterpart of ``stereospike_tpu/train/steps.py``):
forward over T → masked multiscale loss → BPTT through the fire kernels →
Adam, one call per optimizer step; and the no-grad eval step with
per-sample statistics.

The forward over T is step-major (``forward_sequence``: the whole network
once per step) or, with ``multistep=True``, layer-major
(``models/multistep.py::forward_multistep``: each layer over all T steps,
one fire launch per site).

Batch convention, as in the JAX package (NHWC):

    chunks: [B, T, H, W, C] float — voxelized event frames
    gt:     [B, H, W, 1] float — label in the learned metric (LIN/LOG/DISP)
    mask:   [B, H, W, 1] bool — valid-pixel mask

optionally ``warmup`` [B, Tw, H, W, C] (no-grad chunks that settle the
membranes first) and ``init_pots`` [B, H, W, 1] (the prior label seeding
the depth integrators).

Mixed precision: with ``compute_dtype=torch.bfloat16`` the forward and the
backward run in bf16 (convolutions on the tensor cores with fp32
accumulation, fire kernels with fp32 arithmetic), while the master
parameters, their gradients, the loss and Adam's moments stay fp32.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from stereospike_tpu_torch.models.multistep import forward_multistep
from stereospike_tpu_torch.models.stereospike import (
    FireFn,
    StereoSpikeConfig,
    forward_sequence,
    init_state,
)
from stereospike_tpu_torch.objectives.losses import TotalLossConfig, total_loss
from stereospike_tpu_torch.objectives.metrics import convert_to_lin, mean_depth_error
from stereospike_tpu_torch.parallel.collectives import all_reduce_grads
from stereospike_tpu_torch.snn.cuda_kernels import multistep_fire
from stereospike_tpu_torch.train.state import Optimizer, TrainState

Batch = Dict[str, torch.Tensor]


def _to_master(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Cast floating tensors up to at least fp32 (bf16 → fp32 master
    precision) without truncating float64."""
    return [t.to(torch.promote_types(t.dtype, torch.float32)) for t in tensors]


def per_sample_eval_stats(depths: Sequence[torch.Tensor],
                          spikes: Optional[Sequence[torch.Tensor]], gt: torch.Tensor,
                          mask: torch.Tensor, loss_cfg: TotalLossConfig,
                          learn_on: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample loss and MDE, averaged over the batch: the reference's
    batch-size-1 accumulation, where every sample weighs the same whatever
    its valid-pixel count. Each sample keeps its own n and its own
    (Σ res)²/n² term, as the JAX package's vmap over the batch does.

    Returns ``(loss_mean, mde_mean)``; a caller accumulates them weighted by
    the batch's sample count."""
    losses, mdes = [], []
    for i in range(gt.shape[0]):
        dep = [d[i:i + 1] for d in depths]
        spk = [s[i:i + 1] for s in spikes or ()]
        losses.append(total_loss(dep, gt[i:i + 1], mask[i:i + 1], spk, loss_cfg))
        mdes.append(mean_depth_error(convert_to_lin(dep[0], learn_on),
                                     convert_to_lin(gt[i:i + 1], learn_on), mask[i:i + 1]))
    return torch.stack(losses).mean(), torch.stack(mdes).mean()


def _loss_and_metrics(params: Dict[str, torch.Tensor], batch: Batch,
                      model_cfg: StereoSpikeConfig, loss_cfg: TotalLossConfig,
                      learn_on: str, compute_dtype: torch.dtype, remat: bool,
                      multistep: bool, use_warmup: bool, use_init_pots: bool,
                      fire_fn: FireFn, per_sample: bool = False, group=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(loss, MDE, full-scale depth) of a batch; with ``per_sample`` the
    loss and MDE are :func:`per_sample_eval_stats`; with a process
    ``group`` the loss and MDE are those of every rank's batch together."""
    chunks = batch["chunks"].to(compute_dtype)
    p = ({k: v.to(compute_dtype) for k, v in params.items()}
         if compute_dtype != torch.float32 else params)

    def fwd(frames, state=None):
        if multistep:
            return forward_multistep(p, frames, model_cfg, state, fire_fn=fire_fn)
        return forward_sequence(p, frames, model_cfg, state, remat=remat, fire_fn=fire_fn)

    state0 = None
    if use_warmup and "warmup" in batch:
        # no-grad warmup inference settles the hidden state before the
        # train chunks (the reference's stateful-model recipe)
        with torch.no_grad():
            _, _, state0 = fwd(batch["warmup"].to(compute_dtype))
    if use_init_pots and "init_pots" in batch:
        # seed the depth-integrator pool with the prior label
        if state0 is None:
            state0 = init_state(model_cfg, chunks.shape[0], chunks.dtype, device=chunks.device)
        state0 = dict(state0)
        state0["Ineurons"] = (batch["init_pots"].to(compute_dtype)
                              .permute(0, 3, 1, 2).contiguous())
    depths, spikes, _ = fwd(chunks, state0)
    depths = _to_master(depths)
    spikes = _to_master(spikes)
    gt, mask = batch["gt"], batch["mask"]
    if per_sample:
        loss, mde = per_sample_eval_stats(depths, spikes, gt, mask, loss_cfg, learn_on)
        return loss, mde, depths[0]
    loss = total_loss(depths, gt, mask, spikes, loss_cfg, group)
    with torch.no_grad():
        mde = mean_depth_error(convert_to_lin(depths[0], learn_on),
                               convert_to_lin(gt, learn_on), mask, group)
    return loss, mde, depths[0]


def make_train_step(model_cfg: StereoSpikeConfig, loss_cfg: TotalLossConfig,
                    tx: Optimizer, *, learn_on: str = "LIN",
                    compute_dtype: torch.dtype = torch.float32, remat: bool = False,
                    multistep: bool = False, use_warmup: bool = False,
                    use_init_pots: bool = False, accum_steps: int = 1,
                    fire_fn: FireFn = multistep_fire, group=None
                    ) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict]]:
    """Build ``step(state, batch) -> (state, {"loss", "mde"})``.

    The state is updated in place (parameters, Adam's moments, ``step``)
    and returned. The learning rate of each update is ``tx.lr(state.step)``.
    ``multistep=True`` runs the layer-major forward (13 fire launches per
    step over [T, M] whatever T); otherwise the step-major
    ``forward_sequence``, where ``remat`` recomputes steps 0..T-2.
    ``accum_steps > 1``: the batch is split into that many microbatches,
    each forward and backward in turn, so one microbatch of activations is
    live at a time; the gradient, loss and MDE are the means over the
    microbatches (each microbatch's loss its own pooled masked mean), as
    in the JAX package. ``fire_fn`` is the model's fire (the kernels; the
    plain version for a comparison run).

    ``group`` (data parallelism, ``parallel/mesh.py``; the JAX
    ``grad_psum_axis``): each rank passes its own batch; the loss and MDE
    are formed from statistics summed over the group's ranks, so they are
    the global batch's, and each rank's backward holds its data's share of
    the gradient; the shares are summed (not averaged) over ranks by one
    all-reduce before Adam, so every replica takes the same update. With
    ``accum_steps`` each rank splits its own batch, as under the JAX
    ``shard_map``."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def loss_fn(params, batch):
        return _loss_and_metrics(params, batch, model_cfg, loss_cfg, learn_on, compute_dtype,
                                 remat, multistep, use_warmup, use_init_pots, fire_fn,
                                 group=group)[:2]

    def step(state: TrainState, batch: Batch):
        state.optimizer.zero_grad(set_to_none=True)
        if accum_steps == 1:
            loss, mde = loss_fn(state.params, batch)
            loss.backward()
            loss = loss.detach()
        else:
            b = batch["gt"].shape[0]
            if b % accum_steps:
                raise ValueError(f"batch size {b} is not divisible by "
                                 f"accum_steps={accum_steps}")
            size = b // accum_steps
            loss = mde = 0.0
            for i in range(accum_steps):
                micro = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                mb_loss, mb_mde = loss_fn(state.params, micro)
                mb_loss.backward()
                loss = loss + mb_loss.detach()
                mde = mde + mb_mde
            inv = 1.0 / accum_steps
            for p in state.params.values():
                if p.grad is not None:
                    p.grad.mul_(inv)
            loss, mde = loss * inv, mde * inv
        if group is not None:
            all_reduce_grads(state.params.values(), group)
        lr = tx.lr(state.step)
        for param_group in state.optimizer.param_groups:
            param_group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss, "mde": mde}

    return step


def make_eval_step(model_cfg: StereoSpikeConfig, loss_cfg: TotalLossConfig, *,
                   learn_on: str = "LIN", compute_dtype: torch.dtype = torch.float32,
                   multistep: bool = False, fire_fn: FireFn = multistep_fire
                   ) -> Callable[[Dict[str, torch.Tensor], Batch], Dict[str, torch.Tensor]]:
    """Build ``eval_step(params, batch) -> {"loss", "mde", "depth"}``, the
    reference's no-grad validation and test body.

    ``loss`` and ``mde`` are per-sample means over the batch
    (:func:`per_sample_eval_stats`); ``depth`` is the full-scale depth
    [B, H, W, 1]. It runs under ``torch.no_grad()``, so the fire launches
    its forward kernel only. ``model_cfg.for_inference()`` is applied as in
    the JAX package, where it selects a TPU execution form; here it changes
    nothing."""
    model_cfg = model_cfg.for_inference()

    def step(params: Dict[str, torch.Tensor], batch: Batch) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            loss, mde, depth = _loss_and_metrics(
                params, batch, model_cfg, loss_cfg, learn_on, compute_dtype, False,
                multistep, False, False, fire_fn, per_sample=True)
        return {"loss": loss, "mde": mde, "depth": depth}

    return step
