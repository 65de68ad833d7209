"""The train step (counterpart of ``stereospike_tpu/train/steps.py``):
forward over T → masked multiscale loss → BPTT through the fire kernels →
Adam, one call per optimizer step.

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

from typing import Callable, Dict, List, Tuple

import torch

from stereospike_tpu_torch.models.stereospike import (
    FireFn,
    StereoSpikeConfig,
    forward_sequence,
    init_state,
)
from stereospike_tpu_torch.objectives.losses import TotalLossConfig, total_loss
from stereospike_tpu_torch.objectives.metrics import convert_to_lin, mean_depth_error
from stereospike_tpu_torch.snn.cuda_kernels import multistep_fire
from stereospike_tpu_torch.train.state import Optimizer, TrainState

Batch = Dict[str, torch.Tensor]


def _to_master(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Cast floating tensors up to at least fp32 (bf16 → fp32 master
    precision) without truncating float64."""
    return [t.to(torch.promote_types(t.dtype, torch.float32)) for t in tensors]


def _loss_and_metrics(params: Dict[str, torch.Tensor], batch: Batch,
                      model_cfg: StereoSpikeConfig, loss_cfg: TotalLossConfig,
                      learn_on: str, compute_dtype: torch.dtype, remat: bool,
                      use_warmup: bool, use_init_pots: bool,
                      fire_fn: FireFn) -> Tuple[torch.Tensor, torch.Tensor]:
    chunks = batch["chunks"].to(compute_dtype)
    p = ({k: v.to(compute_dtype) for k, v in params.items()}
         if compute_dtype != torch.float32 else params)
    state0 = None
    if use_warmup and "warmup" in batch:
        # no-grad warmup inference settles the hidden state before the
        # train chunks (the reference's stateful-model recipe)
        with torch.no_grad():
            _, _, state0 = forward_sequence(p, batch["warmup"].to(compute_dtype), model_cfg,
                                            fire_fn=fire_fn)
    if use_init_pots and "init_pots" in batch:
        # seed the depth-integrator pool with the prior label
        if state0 is None:
            state0 = init_state(model_cfg, chunks.shape[0], chunks.dtype, device=chunks.device)
        state0 = dict(state0)
        state0["Ineurons"] = (batch["init_pots"].to(compute_dtype)
                              .permute(0, 3, 1, 2).contiguous())
    depths, spikes, _ = forward_sequence(p, chunks, model_cfg, state0, remat=remat,
                                         fire_fn=fire_fn)
    depths = _to_master(depths)
    spikes = _to_master(spikes)
    gt, mask = batch["gt"], batch["mask"]
    loss = total_loss(depths, gt, mask, spikes, loss_cfg)
    with torch.no_grad():
        mde = mean_depth_error(convert_to_lin(depths[0], learn_on),
                               convert_to_lin(gt, learn_on), mask)
    return loss, mde


def make_train_step(model_cfg: StereoSpikeConfig, loss_cfg: TotalLossConfig,
                    tx: Optimizer, *, learn_on: str = "LIN",
                    compute_dtype: torch.dtype = torch.float32, remat: bool = False,
                    use_warmup: bool = False, use_init_pots: bool = False,
                    accum_steps: int = 1, fire_fn: FireFn = multistep_fire
                    ) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict]]:
    """Build ``step(state, batch) -> (state, {"loss", "mde"})``.

    The state is updated in place (parameters, Adam's moments, ``step``)
    and returned. The learning rate of each update is ``tx.lr(state.step)``.
    ``accum_steps > 1``: the batch is split into that many microbatches,
    each forward and backward in turn, so one microbatch of activations is
    live at a time; the gradient, loss and MDE are the means over the
    microbatches (each microbatch's loss its own pooled masked mean), as
    in the JAX package. ``fire_fn`` is the model's fire (the kernels; the
    plain version for a comparison run)."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def loss_fn(params, batch):
        return _loss_and_metrics(params, batch, model_cfg, loss_cfg, learn_on,
                                 compute_dtype, remat, use_warmup, use_init_pots, fire_fn)

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
        lr = tx.lr(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss, "mde": mde}

    return step
