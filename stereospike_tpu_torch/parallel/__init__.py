"""Data-parallel execution: the process-group mesh, the sharded steps and
the collectives they use."""

from stereospike_tpu_torch.parallel.collectives import all_reduce_grads, psum  # noqa: F401
from stereospike_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    make_sharded_ann_eval_step,
    make_sharded_ann_train_step,
    make_sharded_eval_step,
    make_sharded_train_step,
    shard_batch,
)
