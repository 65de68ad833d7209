"""Training infrastructure: run configuration, optimizer, train state, the
SNN and ANN train and eval steps, checkpoints (``train.checkpoint``), and
the training, evaluation, profiling and serving loops (``train.loop``)."""

from stereospike_tpu_torch.train.config import TrainConfig  # noqa: F401
from stereospike_tpu_torch.train.state import (  # noqa: F401
    TrainState,
    create_train_state,
    make_optimizer,
    multistep_lr_schedule,
)
from stereospike_tpu_torch.train.steps import (  # noqa: F401
    make_eval_step,
    make_train_step,
    per_sample_eval_stats,
)
from stereospike_tpu_torch.train.ann_steps import (  # noqa: F401
    AnnTrainState,
    create_ann_train_state,
    make_ann_eval_step,
    make_ann_train_step,
)
