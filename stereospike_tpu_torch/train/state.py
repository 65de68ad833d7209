"""Train state and optimizer (counterpart of ``stereospike_tpu/train/state.py``).

The reference's recipe: Adam (lr 2e-4, torch defaults) with MultiStepLR
(milestones [8, 42, 60], gamma 0.5) stepped per epoch. Here the schedule
is a function of the optimizer step, as in the JAX package, so milestones
count ``milestone · steps_per_epoch`` optimizer steps.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Optional, Sequence, Union

import torch

Schedule = Callable[[int], float]


def multistep_lr_schedule(base_lr: float, milestones: Sequence[int], gamma: float,
                          steps_per_epoch: int) -> Schedule:
    """torch MultiStepLR stepped per epoch, as a function of the optimizer
    step: the LR is scaled by ``gamma`` once step >= milestone ·
    steps_per_epoch (optax ``piecewise_constant_schedule``'s boundary,
    repeated milestones counted once as there)."""
    boundaries = {int(m) * steps_per_epoch: gamma for m in milestones}

    def schedule(step: int) -> float:
        lr = base_lr
        for boundary in sorted(boundaries):
            if step >= boundary:
                lr *= boundaries[boundary]
        return lr

    return schedule


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Adam with torch defaults; ``weight_decay`` as torch Adam's L2 term
    (added to the gradient before the moment updates, as the JAX package's
    ``optax.add_decayed_weights`` before ``scale_by_adam``). The learning
    rate is a number or a schedule over optimizer steps."""

    learning_rate: Union[float, Schedule]
    weight_decay: float = 0.0

    def lr(self, step: int) -> float:
        return float(self.learning_rate(step) if callable(self.learning_rate)
                     else self.learning_rate)

    def build(self, params: Iterable[torch.Tensor]) -> torch.optim.Adam:
        return torch.optim.Adam(params, lr=self.lr(0), betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=self.weight_decay)


def make_optimizer(learning_rate: Union[float, Schedule],
                   weight_decay: float = 0.0) -> Optimizer:
    return Optimizer(learning_rate, weight_decay)


@dataclasses.dataclass
class TrainState:
    """Parameters (fp32 master leaves that require grad), the Adam built
    over them, the global optimizer step, the epoch, the best validation
    metric so far, and the augmentation's generators: ``generator`` on the
    CPU (per-sample draws) and ``device_generator`` on the batch's device
    (per-element draws). The train step updates it in place; the
    checkpoint holds all of it."""

    params: Dict[str, torch.Tensor]
    optimizer: torch.optim.Adam
    step: int = 0
    epoch: int = 0
    best_metric: float = math.inf
    generator: torch.Generator = dataclasses.field(default_factory=torch.Generator)
    device_generator: Optional[torch.Generator] = None


def create_train_state(params: Dict[str, torch.Tensor], tx: Optimizer,
                       generator: torch.Generator) -> TrainState:
    """A train state owning copies of ``params`` as trainable leaves."""
    own = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    return TrainState(params=own, optimizer=tx.build(own.values()), generator=generator)
