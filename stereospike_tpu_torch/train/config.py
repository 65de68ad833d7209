"""Run configuration (counterpart of ``stereospike_tpu/train/config.py``).

The fields of the JAX package's ``TrainConfig`` that the serving loop and
the train step read, with the same names and defaults, so a CLI flag means
the same in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # a factory name in models.factory: stereospike, stereospike_tempo,
    # stereospike_monocular, stereospike_noskip, stereospike_cutpredict
    model: str = "stereospike"
    in_hw: Tuple[int, int] = (260, 346)
    # None = the model factory's default (e.g. the tempo variant's 10.0)
    multiply_factor: Optional[float] = None
    tau: float = 3.0
    use_plif: bool = True
    # prediction-head scales; None = the factory's default
    heads: Optional[Tuple[int, ...]] = None
    nfpdm: int = 1                    # frames per depth map (dt = 50/nfpdm ms)
    n_inference: int = 1              # chunks per sample
    n_timesteps: int = 1              # steps the chunks are spread over
    batch_size: int = 1
    learn_on: str = "LIN"             # LIN | LOG | DISP

    # optimization (reference train.py:126-128)
    learning_rate: float = 2e-4
    weight_decay: float = 0.0
    lr_milestones: Tuple[int, ...] = (8, 42, 60)
    lr_gamma: float = 0.5

    # loss (reference loss.py:119)
    loss_alpha: float = 0.5
    scale_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    penalize_spikes: bool = False
    loss_beta: float = 1.0

    # gradient accumulation over this many microbatches of each batch
    accum_steps: int = 1
    # no-grad warmup inference before the train chunks
    use_warmup: bool = False
    # seed the depth integrators with the previous GT
    use_init_pots: bool = False

    seed: int = 2021
    compute_dtype: str = "float32"    # or "bfloat16"
    checkpoint_dir: str = "./results/checkpoints"
