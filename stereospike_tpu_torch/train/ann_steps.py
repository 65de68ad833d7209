"""Train and eval steps of the equivalent ANN (counterpart of
``stereospike_tpu/train/ann_steps.py``).

The ANN (``models/ann.py``) carries BatchNorm running statistics beside its
parameters, so it has its own train state and step factories; the loss,
the metrics and the optimizer are the SNN's (the paper compares the two
under identical training). It is single-step: it reads ``chunks[:, 0]``,
cast to the parameters' dtype, float32 as in the JAX package (count frames
may arrive as uint8), or float64 for a float64 comparison run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from stereospike_tpu_torch.models.ann import AnnConfig, ann_forward
from stereospike_tpu_torch.objectives.losses import TotalLossConfig, total_loss
from stereospike_tpu_torch.objectives.metrics import convert_to_lin, mean_depth_error
from stereospike_tpu_torch.parallel.collectives import all_reduce_grads
from stereospike_tpu_torch.train.state import Optimizer
from stereospike_tpu_torch.train.steps import Batch, per_sample_eval_stats

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AnnTrainState:
    """Parameters (leaves that require grad), BN running statistics, the
    Adam built over the parameters, the global optimizer step, the epoch,
    the best validation metric so far and the augmentation's generators
    (as in ``train/state.py::TrainState``). The train step updates it in
    place."""

    params: Params
    bn_state: Params
    optimizer: torch.optim.Adam
    step: int = 0
    epoch: int = 0
    best_metric: float = math.inf
    generator: Optional[torch.Generator] = None
    device_generator: Optional[torch.Generator] = None


def _frame(batch: Batch, params: Params) -> torch.Tensor:
    """Step 0 of the chunks in the parameters' floating dtype (at least float32)."""
    dtype = torch.promote_types(next(iter(params.values())).dtype, torch.float32)
    return batch["chunks"][:, 0].to(dtype)


def create_ann_train_state(params: Params, bn_state: Params, tx: Optimizer) -> AnnTrainState:
    """A train state owning copies of ``params`` and ``bn_state``."""
    own = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    return AnnTrainState(params=own, bn_state={k: v.detach().clone() for k, v in bn_state.items()},
                         optimizer=tx.build(own.values()))


def make_ann_train_step(cfg: AnnConfig, loss_cfg: TotalLossConfig, tx: Optimizer, *,
                        learn_on: str = "LIN", group=None
                        ) -> Callable[[AnnTrainState, Batch], Tuple[AnnTrainState, Dict]]:
    """Build ``step(state, batch) -> (state, {"loss", "mde"})``: forward
    with batch statistics, total loss (no spike term), backward, Adam at
    ``tx.lr(state.step)``; the BN running statistics move.

    ``group`` (data parallelism): each rank passes its own batch; the BN
    batch statistics, the loss and the MDE are the global batch's, and
    the gradients are summed over ranks before Adam (as
    ``train/steps.py::make_train_step``)."""

    def step(state: AnnTrainState, batch: Batch):
        frame = _frame(batch, state.params)
        state.optimizer.zero_grad(set_to_none=True)
        depths, new_bn = ann_forward(state.params, frame, cfg, state.bn_state, train=True,
                                     group=group)
        loss = total_loss(depths, batch["gt"], batch["mask"], None, loss_cfg, group)
        loss.backward()
        with torch.no_grad():
            mde = mean_depth_error(convert_to_lin(depths[0], learn_on),
                                   convert_to_lin(batch["gt"], learn_on), batch["mask"], group)
        if group is not None:
            all_reduce_grads(state.params.values(), group)
        lr = tx.lr(state.step)
        for param_group in state.optimizer.param_groups:
            param_group["lr"] = lr
        state.optimizer.step()
        state.bn_state = new_bn
        state.step += 1
        return state, {"loss": loss.detach(), "mde": mde}

    return step


def make_ann_eval_step(cfg: AnnConfig, loss_cfg: TotalLossConfig, *, learn_on: str = "LIN"
                       ) -> Callable[[Params, Params, Batch], Dict[str, torch.Tensor]]:
    """Build ``eval_step(params, bn_state, batch) -> {"loss", "mde",
    "depth"}`` with frozen BN statistics, no graph; ``loss`` and ``mde``
    are per-sample means over the batch (``train/steps.py::per_sample_eval_stats``)."""

    def step(params: Params, bn_state: Params, batch: Batch) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            depths, _ = ann_forward(params, _frame(batch, params), cfg,
                                    bn_state, train=False)
            loss, mde = per_sample_eval_stats(depths, None, batch["gt"], batch["mask"],
                                              loss_cfg, learn_on)
        return {"loss": loss, "mde": mde, "depth": depths[0]}

    return step
