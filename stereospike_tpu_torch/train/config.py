"""Run configuration (counterpart of ``stereospike_tpu/train/config.py``).

Every field of the JAX package's ``TrainConfig``, with the same names and
defaults, so that a CLI flag or a saved JSON config means the same in both
packages. Parts not ported yet are refused by the loops with a message:
``save_viz > 0`` (the figures, ``viz.py``) and a ``mesh_shape`` with a
spatial axis above 1 (the H split).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # a factory name in models.factory (stereospike, stereospike_tempo,
    # stereospike_monocular, stereospike_noskip, stereospike_cutpredict) or an
    # equivalent-ANN baseline (ann, ann_sigmoid, ann_tanh, ann_leaky_relu,
    # ann_relu)
    model: str = "stereospike"
    in_hw: Tuple[int, int] = (260, 346)
    # None = the model factory's default (e.g. the tempo variant's 10.0)
    multiply_factor: Optional[float] = None
    tau: float = 3.0
    use_plif: bool = True
    # prediction-head scales; None = the factory's default
    heads: Optional[Tuple[int, ...]] = None

    # data (reference train.py:60-68): 'mvsec' (stereo) or 'dense'
    # (monocular CARLA .npy tree, with a contiguous train/val/test split)
    dataset: str = "mvsec"
    nfpdm: int = 1                    # frames per depth map (dt = 50/nfpdm ms)
    n_inference: int = 1              # chunks per training sample
    n_warmup: int = 1                 # no-grad warmup chunks (stateful models)
    batch_size: int = 1
    learn_on: str = "LIN"             # LIN | LOG | DISP
    scenario: str = "indoor_flying"
    split: str = "1"
    data_root: str = "./datasets/MVSEC/data/"
    # bound the dataset build's event memory: stream the events table in
    # blocks of this many rows through the native binner (None = read it whole)
    event_block_rows: Optional[int] = None
    normalize: bool = False
    # TensorBoard event files beside the JSONL sink, when the package is there
    tensorboard: bool = True
    # --synthetic fixture sizing (data/fixtures.py::make_mvsec_fixture): depth
    # frames and events per sequence, and whether the scene is learnable
    synth_frames: int = 16
    synth_events: int = 30000
    synth_learnable: bool = False
    # hflip / vflip / time mirror / event drop on every training batch
    # (data_augmentation.py:166-172, train.py:84-90)
    augment: bool = True

    # optimization (train.py:126-128)
    learning_rate: float = 2e-4
    weight_decay: float = 0.0
    epochs: int = 70
    lr_milestones: Tuple[int, ...] = (8, 42, 60)
    lr_gamma: float = 0.5

    # loss (loss.py:119)
    loss_alpha: float = 0.5
    scale_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    penalize_spikes: bool = False
    loss_beta: float = 1.0

    # execution
    # T axis of each batch: the n_inference chunks of a sample are spread
    # over n_timesteps steps (must divide n_inference)
    n_timesteps: int = 1
    # layer-major forward over the n_timesteps steps (models/multistep.py):
    # convs over T·B merged samples, one fire launch per site
    multistep: bool = False
    # gradient accumulation over this many microbatches of each batch
    accum_steps: int = 1
    # a background worker assembles, uploads and augments up to this many
    # batches ahead of the step in flight; 0 = synchronous
    prefetch: int = 2
    # wire-compress training uploads (data/packing.py): bit-packed masks and
    # float16 labels; eval uploads stay exact
    pack_io: bool = True
    # no-grad warmup inference before the train chunks (train.py:223-228)
    use_warmup: bool = False
    # seed the depth integrators with the previous GT (SNN_models.py:247-248)
    use_init_pots: bool = False
    # a 4-panel figure every N eval batches (0 = off); not ported yet
    save_viz: int = 0
    # per-tap firing-rate densities of one validation batch in the training
    # JSONL every N epochs (0 = off)
    log_firing_rates: int = 0

    # initialize the model from a reference .pth state dict (interop.py)
    import_pth: Optional[str] = None

    # runtime
    seed: int = 2021                  # train.py:53
    compute_dtype: str = "float32"    # or "bfloat16"
    checkpoint_dir: str = "./results/checkpoints"
    checkpoint_every: int = 0         # extra periodic full-state checkpoint (0 = off)
    resume: bool = False
    # (data, 1): one process per device (parallel/mesh.py); spatial > 1 is not ported yet
    mesh_shape: Optional[Tuple[int, int]] = None
    debug_nans: bool = False

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "TrainConfig":
        d = json.loads(text)
        for key in ("in_hw", "lr_milestones", "scale_weights", "mesh_shape", "heads"):
            if d.get(key) is not None:
                d[key] = tuple(d[key])
        return cls(**d)
