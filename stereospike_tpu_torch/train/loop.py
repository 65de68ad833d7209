"""Training, evaluation, profiling and serving drivers (counterpart of
``stereospike_tpu/train/loop.py``).

The reference's entry scripts (train.py, test.py, calculate_firing_rates.py)
as functions over a :class:`TrainConfig`, sharing one data, model and step
assembly: :func:`train_loop` (epochs of shuffled, augmented training, a
validation pass, best-on-val and ``latest`` checkpoints, exact resume),
:func:`eval_loop` (the test set from a checkpoint), :func:`firing_rates_loop`
(per-tap spike densities over the test set), their equivalent-ANN
counterparts, and :func:`stream_loop` (serving).

The loops' contracts, as in the JAX package:

- per-step metrics stay on the device; one stacked fetch per epoch
  (:func:`_fetch_sums`), so the host prepares batch k+1 while the card runs
  step k;
- a background worker (:class:`_Prefetcher`) assembles batches on the host,
  pins them, uploads them on a copy stream that the compute stream waits
  on, and runs the wire unpack and the augmentation there, ``prefetch``
  batches ahead; one worker, so the augmentation draws keep one order;
- val and test statistics weigh each batch by its sample count, with
  ``drop_last=False``;
- ``best`` and ``latest`` every epoch; ``steps_per_epoch`` of the LR
  schedule from the checkpoint's meta on resume;
- SIGTERM writes ``latest`` with ``epoch_step_offset`` and the augmentation
  generators' states at the start of the interrupted epoch; ``resume``
  skips exactly that many batches, their augmentation draws included, so a
  resumed run trains on the same batches as an uninterrupted one.

Data parallelism (``parallel/mesh.py``), under ``python -m
torch.distributed.run`` or with ``mesh_shape=(d, 1)``: one process per
device, ``batch_size`` per process, each rank training on its own stride
of the shuffled order (MVSEC only) with its own augmentation draws; the
loss, the ANN's BatchNorm statistics and the summed gradients are global,
so the replicas stay equal; validation and test batches are split over
the ranks when they divide, and every rank gets the global statistics;
rank 0 alone writes checkpoints and logs; a SIGTERM on any rank stops
every rank at the same step (a MAX all-reduce of the flag every 16
steps).

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``, and raises without a card. Not ported yet: the figures
(``save_viz``, ``--save-video``) and spatial sharding
(``mesh_shape=(d, s>1)``).
"""

from __future__ import annotations

import atexit
import os
import queue
import shutil
import signal
import tempfile
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from stereospike_tpu_torch.data.augmentation import (
    AugmentConfig,
    augment_batch,
    burn_augment_draws,
    time_mirror_flags,
)
from stereospike_tpu_torch.data.packing import pack_batch_host, unpack_batch_device
from stereospike_tpu_torch.models import factory as model_factory
from stereospike_tpu_torch.models.ann import AnnConfig, init_ann_params, init_ann_state
from stereospike_tpu_torch.models.stereospike import (
    TAP_NAMES,
    StereoSpikeConfig,
    count_params,
    firing_rates_sequence,
    init_params,
)
from stereospike_tpu_torch.objectives.losses import TotalLossConfig
from stereospike_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    make_sharded_ann_eval_step,
    make_sharded_eval_step,
)
from stereospike_tpu_torch.streaming import StreamingEvaluator, serving_device
from stereospike_tpu_torch.train.ann_steps import (
    create_ann_train_state,
    make_ann_eval_step,
    make_ann_train_step,
)
from stereospike_tpu_torch.train.checkpoint import (
    BEST,
    has_checkpoint,
    load_meta,
    restore_checkpoint,
    restore_fields,
    restore_params,
    save_checkpoint,
)
from stereospike_tpu_torch.train.config import TrainConfig
from stereospike_tpu_torch.train.state import (
    create_train_state,
    make_optimizer,
    multistep_lr_schedule,
)
from stereospike_tpu_torch.train.steps import make_eval_step, make_train_step
from stereospike_tpu_torch.utils.logging import MetricsLogger
from stereospike_tpu_torch.utils.profiling import enable_nan_debugging

Device = Union[str, torch.device]
Batch = Dict[str, torch.Tensor]
HostBatch = Dict[str, np.ndarray]
EVAL_KEYS = ("chunks", "gt", "mask")


# equivalent-ANN model names → activation
ANN_MODELS = {
    "ann": "sigmoid",
    "ann_sigmoid": "sigmoid",
    "ann_tanh": "tanh",
    "ann_leaky_relu": "leaky_relu",
    "ann_relu": "relu",
}


def is_ann_model(name: str) -> bool:
    return name in ANN_MODELS


def _in_channels(cfg: TrainConfig) -> int:
    """Per-step channel count: eyes · (n_inference / n_timesteps) · nfpdm · 2."""
    eyes = 1 if cfg.model == "stereospike_monocular" else 2
    if cfg.n_inference % cfg.n_timesteps:
        raise ValueError(f"n_timesteps={cfg.n_timesteps} must divide "
                         f"n_inference={cfg.n_inference}")
    return eyes * (cfg.n_inference // cfg.n_timesteps) * cfg.nfpdm * 2


def build_model_config(cfg: TrainConfig) -> StereoSpikeConfig:
    """Resolve the model factory and the input channel count."""
    fac = getattr(model_factory, cfg.model)
    kwargs = dict(in_hw=tuple(cfg.in_hw), in_channels=_in_channels(cfg))
    if cfg.multiply_factor is not None:
        kwargs["multiply_factor"] = cfg.multiply_factor
    if cfg.heads is not None:
        if 1 not in cfg.heads or not set(cfg.heads) <= {1, 2, 3, 4}:
            raise ValueError(f"heads={cfg.heads} must be a subset of "
                             "{1,2,3,4} containing 1")
        kwargs["heads"] = tuple(sorted(cfg.heads))
    if cfg.model != "stereospike":
        kwargs.update(tau=cfg.tau, use_plif=cfg.use_plif)
    return fac(**kwargs)


def build_ann_config(cfg: TrainConfig) -> AnnConfig:
    """Resolve an equivalent-ANN config from ``cfg.model``."""
    if cfg.n_timesteps != 1:
        # the ANN has no membrane to carry: a T>1 batch would train and
        # evaluate on step 0 only, so refuse it
        raise ValueError(
            f"ANN models are single-step (n_timesteps={cfg.n_timesteps}); "
            "channel-stack the chunks (n_timesteps=1) or use an SNN model")
    return AnnConfig(in_channels=_in_channels(cfg), in_hw=tuple(cfg.in_hw),
                     activation=ANN_MODELS[cfg.model])


def _loss_config(cfg: TrainConfig) -> TotalLossConfig:
    return TotalLossConfig(alpha=cfg.loss_alpha, scale_weights=tuple(cfg.scale_weights),
                           penalize_spikes=cfg.penalize_spikes, beta=cfg.loss_beta)


def _compute_dtype(cfg: TrainConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _run_device(device: Device) -> torch.device:
    """``device`` as a ``torch.device``; CUDA without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"running on {device} needs a CUDA device; "
                           "pass device='cpu' to run on the CPU")
    return device


def _check_ported(cfg: TrainConfig) -> None:
    """Refuse the config fields whose parts are not ported yet."""
    if cfg.save_viz:
        raise NotImplementedError("save_viz needs the figures (viz.py), not ported yet; "
                                  "pass --save-viz 0")


def _device_setup(cfg: TrainConfig, device: torch.device) -> Optional[Mesh]:
    """The launch's data-parallel mesh (``parallel/mesh.py::make_mesh``), or
    None for one process without ``mesh_shape``, which runs with no
    process group (the JAX ``_device_setup`` returns None for one device)."""
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if cfg.mesh_shape is None and world == 1:
        return None
    return make_mesh(cfg.mesh_shape, device=device)


def _rank_seed(seed: int, mesh: Optional[Mesh]) -> int:
    """The seed of this rank's augmentation generators: ``seed`` on rank 0,
    so that a world of one draws as a single process does, and a stream of
    its own on every other rank (ranks train on different samples; equal
    draws would correlate the global batch), as the JAX loop folds the
    process index into its key."""
    if mesh is None or mesh.rank == 0:
        return seed
    return int(np.random.SeedSequence((seed, mesh.rank)).generate_state(1)[0])


def _eval_steps(eval_step: Callable, mesh: Optional[Mesh], make_sharded: Callable):
    """``batch size → step``: under a mesh a batch that divides over the
    ranks is split over them (``make_sharded(eval_step, mesh)``); any other
    (a short last batch) runs whole on every rank, as the JAX loops fall
    back to the single-device step."""
    sharded = None if mesh is None else make_sharded(eval_step, mesh)

    def pick(bsz: int) -> Callable:
        return sharded if sharded is not None and bsz % mesh.world == 0 else eval_step

    return pick


# ------------------------------------------------------------------ data
def _dense_guard(cfg: TrainConfig) -> None:
    """The DENSE dataset's constraints (monocular CARLA, dense_dataset.py):
    one 2-channel chunk per depth map, no warmup, no stereo disparity."""
    if cfg.model != "stereospike_monocular":
        raise ValueError("DENSE is a monocular dataset (dense_dataset.py:100: "
                         "data_right=None); use model=stereospike_monocular")
    if cfg.n_timesteps != 1 or cfg.n_inference != 1:
        raise ValueError("DENSE emits one chunk per depth map: n_timesteps and "
                         "n_inference must both be 1")
    if cfg.use_warmup or cfg.use_init_pots:
        raise ValueError("DENSE samples carry no warmup chunks / init_pots")
    if cfg.learn_on == "DISP":
        raise ValueError("DENSE has no stereo baseline; learn_on must be LIN or LOG")


# synthetic fixtures written in this process: key → (root, tables); each
# is written once and removed at exit
_FIXTURES: Dict[tuple, Tuple[str, Optional[Dict]]] = {}


def _fixture(key: tuple, write: Callable[[str], Optional[Dict]]
             ) -> Tuple[str, Optional[Dict], Optional[float]]:
    """(root, tables, seconds to write it, None when reused)."""
    if key in _FIXTURES and os.path.isdir(_FIXTURES[key][0]):
        return (*_FIXTURES[key], None)
    root = tempfile.mkdtemp(prefix=f"stereospike_torch_{key[0]}_")
    atexit.register(shutil.rmtree, root, True)
    t0 = time.perf_counter()
    tables = write(root)
    _FIXTURES[key] = (root, tables)
    return root, tables, time.perf_counter() - t0


def _make_data(cfg: TrainConfig, synthetic: bool, test_only: bool = False,
               device: Device = "cuda"):
    """``((train, val, test) or test, timings)``: the views, and the seconds
    spent writing the synthetic fixture (None when none was written) and
    building the dataset from its files. ``test_only`` loads the test
    sequence alone (the reference's load_test_only, test.py:64-67)."""
    timings = {"fixture_write_s": None}
    if cfg.dataset == "dense":
        from stereospike_tpu_torch.data.dense import load_dense, split_dense

        _dense_guard(cfg)
        root = cfg.data_root
        if synthetic:
            from stereospike_tpu_torch.data.fixtures import make_dense_fixture

            root, _, timings["fixture_write_s"] = _fixture(
                ("dense", tuple(cfg.in_hw), cfg.seed),
                lambda r: make_dense_fixture(r, hw=tuple(cfg.in_hw), n_maps=12, seed=cfg.seed))
        t0 = time.perf_counter()
        ds = load_dense(root, nfpdm=cfg.nfpdm, take_log=(cfg.learn_on == "LOG"),
                        hw=tuple(cfg.in_hw))
        train, val, test = split_dense(ds)
        timings["data_build_s"] = time.perf_counter() - t0
        return (test if test_only else (train, val, test)), timings
    if cfg.dataset != "mvsec":
        raise ValueError(f"unknown dataset {cfg.dataset!r} (mvsec | dense)")
    from stereospike_tpu_torch.data.mvsec import load_mvsec

    if synthetic:
        from stereospike_tpu_torch.data.fixtures import make_mvsec_fixture

        root, tables, timings["fixture_write_s"] = _fixture(
            ("mvsec", tuple(cfg.in_hw), cfg.synth_frames, cfg.synth_events,
             cfg.synth_learnable, cfg.seed),
            lambda r: make_mvsec_fixture(r, hw=tuple(cfg.in_hw), n_depth=cfg.synth_frames,
                                         n_events=cfg.synth_events,
                                         learnable=cfg.synth_learnable, seed=cfg.seed))
        kw = dict(split="1", tables=tables)
    else:
        root = cfg.data_root
        kw = dict(scenario=cfg.scenario, split=cfg.split, normalize=cfg.normalize)
    t0 = time.perf_counter()
    views = load_mvsec(root, hw=tuple(cfg.in_hw), nfpdm=cfg.nfpdm,
                       warmup_chunks=cfg.n_warmup, train_chunks=cfg.n_inference,
                       learn_on=cfg.learn_on, load_test_only=test_only,
                       event_block_rows=cfg.event_block_rows, device=device, **kw)
    timings["data_build_s"] = time.perf_counter() - t0
    return views, timings


def _test_view(cfg: TrainConfig, synthetic: bool, data, device: Device):
    if data is None:
        return _make_data(cfg, synthetic, test_only=True, device=device)[0]
    return data[2] if isinstance(data, tuple) else data


def _fetch_sums(stats: Sequence[Tuple[torch.Tensor, ...]], width: int = 2) -> np.ndarray:
    """Sum per-step device scalars in one device op and one fetch: the
    loops keep their metrics on the device while iterating (a per-step
    ``.item()`` would serialise the host's preparation of the next batch
    behind the current step), and this is the one deferred fetch."""
    if not stats:
        return np.zeros(width)
    return (torch.stack([torch.stack([s.to(torch.float32) for s in row]) for row in stats])
            .sum(0).cpu().numpy())


def _batch_iter(cfg: TrainConfig, view, mesh: Optional[Mesh] = None, **kw):
    """Host batches of a view: MVSEC's eye-stacked batcher or DENSE's
    monocular one. ``kw``: shuffle, seed and drop_last; the layout
    arguments come from ``cfg``. ``mesh`` (training batches of a
    data-parallel run): this rank's disjoint stride of the seed-determined
    order, equal step counts on every rank; MVSEC only, as in the JAX
    package."""
    if mesh is not None and mesh.world > 1:
        if cfg.dataset == "dense":
            raise NotImplementedError("data-parallel sharding is MVSEC-only for now")
        kw["shard"] = (mesh.rank, mesh.world)
    if cfg.dataset == "dense":
        from stereospike_tpu_torch.data.dense import dense_batches

        return dense_batches(view, cfg.batch_size, **kw)
    from stereospike_tpu_torch.data.mvsec import batches

    return batches(view, cfg.batch_size, binocular=cfg.model != "stereospike_monocular",
                   n_timesteps=cfg.n_timesteps, include_warmup=cfg.use_warmup, **kw)


# ------------------------------------------------------------- input stage
class _Staged:
    """A batch staged on the device, and the event its copy stream recorded
    after the upload and augmentation (None on the CPU)."""

    def __init__(self, batch: Batch, event: Optional[torch.cuda.Event],
                 device: torch.device):
        self.batch, self.event, self.device = batch, event, device

    def take(self) -> Batch:
        """The batch, with the current stream ordered after its staging."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self.event)
            for t in self.batch.values():
                t.record_stream(stream)  # the allocator keeps it until the step is done
        return self.batch


class _Stager:
    """Host → device staging. On a card: host arrays are pinned, copied with
    ``non_blocking`` on a copy stream, and whatever ``fn`` does after the
    upload (the wire unpack, the augmentation) runs on that stream too; each
    pinned buffer is kept until its copy's event has completed. On the CPU:
    the arrays become tensors in place."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._pinned: List[torch.Tensor] = []
        self._inflight: List[Tuple[torch.cuda.Event, List[torch.Tensor]]] = []

    def upload(self, host: HostBatch, keys: Sequence[str], pack: bool) -> Batch:
        """The ``keys`` of a host batch on the device, optionally wire-packed
        (data/packing.py) and unpacked there, so the caller always receives
        float32 labels and bool masks."""
        sub = {k: host[k] for k in keys if k in host}
        if pack:
            sub = pack_batch_host(sub)
        out = {}
        for k, a in sub.items():
            t = torch.from_numpy(np.ascontiguousarray(a))
            if self.stream is not None:
                t = t.pin_memory()
                self._pinned.append(t)
            out[k] = t.to(self.device, non_blocking=True)
        if not pack:
            return out
        with torch.profiler.record_function("stereospike::unpack"):
            return unpack_batch_device(out)

    def eval_batch(self, host: HostBatch) -> Batch:
        """``chunks``, ``gt`` and ``mask`` of a host batch on the device,
        float-exact (never wire-packed), ready for the current stream."""
        return self(lambda h: self.upload(h, EVAL_KEYS, False), host).take()

    def __call__(self, fn: Callable[[HostBatch], Batch], host: HostBatch) -> _Staged:
        if self.stream is None:
            return _Staged(fn(host), None, self.device)
        self._inflight = [(e, p) for e, p in self._inflight if not e.query()]
        with torch.cuda.stream(self.stream):
            batch = fn(host)
            event = torch.cuda.Event()
            event.record(self.stream)
        self._inflight.append((event, self._pinned))
        self._pinned = []
        return _Staged(batch, event, self.device)


class _Prefetcher:
    """Bounded background input stage: one worker thread walks the batch
    iterator and runs ``prep`` (assembly, pinning, upload, augmentation) up
    to ``depth`` batches ahead of the step in flight, as the reference's
    DataLoader workers with ``pin_memory`` (train.py:100) do. One worker,
    not a pool: the augmentation draws then keep the order of the
    synchronous path (``depth=0``, no thread). A worker's exception is
    raised in the consuming thread."""

    _DONE = object()

    def __init__(self, it, prep_fn: Callable, depth: int = 2):
        self._it, self._prep, self._depth = it, prep_fn, max(int(depth), 0)
        self._thread = None
        if self._depth == 0:
            return
        self._q: queue.Queue = queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._err: List[BaseException] = []

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def work():
            try:
                for b in self._it:
                    if not put(self._prep(b)):
                        return
            except BaseException as e:  # noqa: BLE001 — raised in the consumer
                self._err.append(e)
            finally:
                put(self._DONE)

        self._thread = threading.Thread(target=work, daemon=True, name="stereospike-prefetch")
        self._thread.start()

    def __iter__(self):
        if self._depth == 0:
            for b in self._it:
                yield self._prep(b)
            return
        while True:
            item = self._q.get()
            if item is self._DONE:
                break
            yield item
        if self._err:
            raise self._err[0]

    def close(self) -> None:
        """Stop the worker and drop the staged batches not consumed (an
        early exit: ``max_steps``, preemption)."""
        if self._thread is None:
            return
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class _PreemptionGuard:
    """SIGTERM → finish the step in flight, checkpoint, return. Handlers
    install in the main thread only; elsewhere the guard does nothing."""

    def __init__(self):
        self.requested = False
        self._old = None
        try:
            self._old = signal.signal(signal.SIGTERM, self._on_term)
        except ValueError:  # not the main thread
            pass

    def _on_term(self, signum, frame):
        self.requested = True

    def restore(self) -> None:
        if self._old is not None:
            signal.signal(signal.SIGTERM, self._old)
            self._old = None


def _augmented_prep(stager: _Stager, aug_cfg: AugmentConfig, keys: Sequence[str],
                    pack: bool, state) -> Callable[[HostBatch], Batch]:
    """Upload and augment one training batch. When the step does not read
    ``init_pots``, the time mirror's ``gt ↔ init_pots`` and ``mask ↔
    init_mask`` swap runs on the host with the flags
    :func:`time_mirror_flags` reads off the generator, and neither
    ``init_pots`` nor ``init_mask`` is uploaded (36 % of a default batch's
    bytes); the device then augments with those flags. This gives the
    batch the all-device path gives."""

    def fn(batch: HostBatch) -> Batch:
        flags = None
        if "init_pots" in batch and "init_pots" not in keys:
            flags = time_mirror_flags(state.generator, batch["gt"].shape[0], aug_cfg)
            f = flags.numpy().reshape((-1,) + (1,) * (batch["gt"].ndim - 1))
            batch = dict(batch, gt=np.where(f, batch["init_pots"], batch["gt"]),
                         mask=np.where(f, batch["init_mask"], batch["mask"]))
            dev = stager.upload(batch, keys, pack)
        else:
            dev = stager.upload(batch, tuple(batch), pack)
        with torch.profiler.record_function("stereospike::augment"):
            dev = augment_batch(dev, aug_cfg, generator=state.generator,
                                device_generator=state.device_generator, mirror_flag=flags)
        return {k: dev[k] for k in keys if k in dev}

    return fn


def _train_prep(stager: _Stager, cfg: TrainConfig, aug_cfg: AugmentConfig,
                keys: Sequence[str], state) -> Callable[[HostBatch], _Staged]:
    """The training batches' input stage: upload (wire-packed with
    ``pack_io``) and, with ``augment``, the augmentation."""
    if cfg.augment:
        fn = _augmented_prep(stager, aug_cfg, keys, cfg.pack_io, state)
    else:
        def fn(b):
            return stager.upload(b, keys, cfg.pack_io)
    return lambda b: stager(fn, b)


def _generator_states(state) -> Dict[str, Optional[torch.Tensor]]:
    return {name: None if g is None else g.get_state()
            for name, g in (("generator", state.generator),
                            ("device_generator", state.device_generator))}


def _checkpoint_generators(gens: Dict[str, Optional[torch.Tensor]],
                           mesh: Optional[Mesh]) -> Dict[str, object]:
    """The generator states a checkpoint keeps: this process's, or, in a
    data-parallel run, every rank's (a list per generator, gathered to all
    ranks; rank 0 writes them), so that each rank resumes its own draws."""
    if mesh is None or mesh.world == 1:
        return gens
    every: List[Optional[Dict]] = [None] * mesh.world
    dist.all_gather_object(every, gens, group=mesh.group)
    return {name: [g[name] for g in every] for name in gens}


PREEMPT_EVERY = 16


def _warm_preempt_collective(mesh: Optional[Mesh]) -> None:
    """Run :func:`_preempt_sync`'s collective once before training starts,
    signal-free and in lockstep, so that its first connection cannot race
    a SIGTERM (the JAX loop saw a gloo connect time out so)."""
    if mesh is not None and mesh.world > 1:
        dist.all_reduce(torch.zeros(1, device=mesh.device), op=dist.ReduceOp.MAX,
                        group=mesh.group)


def _preempt_sync(guard: "_PreemptionGuard", step_idx: int, mesh: Optional[Mesh]) -> bool:
    """Whether to stop for a SIGTERM. One process: its own flag, every step.
    Data-parallel: a rank leaving the step loop alone would leave the
    others waiting in the gradient all-reduce, so every ``PREEMPT_EVERY``
    steps (the same steps on every rank) the flags are MAX-reduced over
    ranks, and all stop at that step."""
    if mesh is None or mesh.world == 1:
        return guard.requested
    if step_idx % PREEMPT_EVERY:
        return False
    flag = torch.full((1,), float(guard.requested), device=mesh.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(flag.item() > 0)


def _skip_batches(batch_it, n: int, augment: bool, state, device: torch.device) -> None:
    """A resumed epoch: pass over the ``n`` batches the interrupted run had
    trained on, burning their augmentation draws, before the worker starts."""
    for _ in range(n):
        b = next(batch_it, None)
        if b is None:
            break
        if augment:
            burn_augment_draws(b["gt"].shape[0], b["chunks"].shape,
                               b["warmup"].shape if "warmup" in b else None,
                               state.generator, state.device_generator, device)


def _resume_meta(cfg: TrainConfig, steps_per_epoch: int) -> Tuple[int, int]:
    """(steps per epoch of the LR schedule, batches to skip): the original
    run's, from the checkpoint's meta, when resuming."""
    if cfg.resume and has_checkpoint(cfg.checkpoint_dir):
        meta = load_meta(cfg.checkpoint_dir) or {}
        return (int(meta.get("steps_per_epoch", steps_per_epoch)),
                int(meta.get("epoch_step_offset", 0)))
    return steps_per_epoch, 0


def _f32(x: float) -> float:
    """A float rounded to float32, as the JAX train state keeps the best metric."""
    return float(np.float32(x))


# --------------------------------------------------------------- the loops
def _epochs(cfg: TrainConfig, state, train_view, step_fn, prep, logger: MetricsLogger,
            val_fn, sched_steps: int, resume_skip: int, max_steps: Optional[int],
            device: torch.device, on_step: Optional[Callable[[int], None]],
            extra_scalars: Callable[..., Dict], mesh: Optional[Mesh]) -> Dict:
    """The epoch loop the SNN and ANN trainers share: train, validate,
    checkpoint, with preemption and ``max_steps``. ``val_fn(epoch)`` →
    (loss sum, MDE sum, samples, seconds, extra scalars);
    ``extra_scalars(steps_done, n_steps, train_time, val_time)`` → more
    scalars for the epoch's record. ``mesh``: a data-parallel run's
    rank-sharded batches and lockstep preemption."""
    done = False
    summary: Dict = {}
    steps_done = state.step
    start_epoch = state.epoch
    _warm_preempt_collective(mesh)
    guard = _PreemptionGuard()
    try:
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.time()
            at_start = _generator_states(state)
            step_metrics = []
            preempt_now = False
            base_off = resume_skip if epoch == start_epoch else 0
            batch_it = iter(_batch_iter(cfg, train_view, mesh, shuffle=True,
                                        seed=cfg.seed + epoch))
            _skip_batches(batch_it, base_off, cfg.augment, state, device)
            with _Prefetcher(batch_it, prep, depth=cfg.prefetch) as staged:
                for item in staged:
                    state, metrics = step_fn(state, item.take())
                    step_metrics.append((metrics["loss"], metrics["mde"]))
                    steps_done += 1
                    if on_step is not None:
                        on_step(steps_done)
                    if max_steps is not None and steps_done >= max_steps:
                        done = True
                        break
                    if _preempt_sync(guard, steps_done, mesh):
                        preempt_now = True
                        break
            if preempt_now:
                # the exact resume point: the batch cursor within this epoch,
                # and the generators as they stood at its start (the worker
                # has drawn ahead of the last trained batch); no validation
                save_checkpoint(cfg.checkpoint_dir, state,
                                generators=_checkpoint_generators(at_start, mesh),
                                meta_extra={"steps_per_epoch": sched_steps,
                                            "epoch_step_offset": base_off + len(step_metrics)})
                logger.text(f"SIGTERM: checkpointed at step {steps_done}; "
                            "resume with --resume true")
                summary = {"epoch": epoch, "step": steps_done, "preempted": True}
                break
            n_steps = len(step_metrics)
            train_loss, train_mde = map(float, _fetch_sums(step_metrics))
            train_time = time.time() - t0

            val_loss, val_mde, n_val, val_time, fr_scalars = val_fn(epoch)
            state.epoch = epoch + 1
            scalars = {
                "train_loss": train_loss / max(n_steps, 1),
                "train_MDE": train_mde / max(n_steps, 1),
                "val_loss": val_loss / max(n_val, 1),
                "val_MDE": val_mde / max(n_val, 1),
                **extra_scalars(steps_done, n_steps, train_time, val_time),
                **fr_scalars,
            }
            logger.log(scalars, step=steps_done, epoch=epoch)
            logger.text(
                f"epoch {epoch}: train loss {scalars['train_loss']:.4f} "
                f"MDE {scalars['train_MDE']:.4f} | val loss {scalars['val_loss']:.4f} "
                f"MDE {scalars['val_MDE']:.4f} | {train_time:.1f}s+{val_time:.1f}s")
            is_best = n_val > 0 and scalars["val_MDE"] < state.best_metric
            if is_best:
                state.best_metric = _f32(scalars["val_MDE"])
            tag = (f"epoch_{epoch:04d}"
                   if cfg.checkpoint_every and (epoch + 1) % cfg.checkpoint_every == 0 else None)
            save_checkpoint(cfg.checkpoint_dir, state, best=is_best, tag=tag,
                            meta_extra={"steps_per_epoch": sched_steps},
                            generators=_checkpoint_generators(_generator_states(state), mesh))
            summary = {"epoch": epoch, **scalars, "best_val_MDE": state.best_metric}
            if done:
                break
    finally:
        # an exception mid-epoch must not leave the process deaf to SIGTERM
        guard.restore()
        logger.close()
    return summary


def train_loop(cfg: TrainConfig, *, synthetic: bool = False, max_steps: Optional[int] = None,
               data=None, return_state: bool = False, device: Device = "cuda",
               on_step: Optional[Callable[[int], None]] = None) -> Dict:
    """A full training run (reference train.py epoch loop, :180-356).

    Per epoch: a shuffled, augmented train pass, a validation pass, the
    best-on-val and ``latest`` checkpoints. Returns a summary dict: the
    last epoch's scalars, ``best_val_MDE``, and the seconds spent writing
    the synthetic fixture and building the dataset; ``return_state`` adds
    the final train state under ``"state"``. ``on_step(steps_done)`` is
    called after every optimizer step (a hook for profiling and tests)."""
    if is_ann_model(cfg.model):
        return _ann_train_loop(cfg, synthetic=synthetic, max_steps=max_steps, data=data,
                               device=device, on_step=on_step)
    device = _run_device(device)
    _check_ported(cfg)
    mesh = _device_setup(cfg, device)
    if mesh is not None:
        device = mesh.device
    group, rank, world = (None, 0, 1) if mesh is None else (mesh.group, mesh.rank, mesh.world)
    if cfg.debug_nans:
        enable_nan_debugging(True)

    model_cfg = build_model_config(cfg)
    loss_cfg = _loss_config(cfg)
    binocular = cfg.model != "stereospike_monocular"
    timings = {"fixture_write_s": None, "data_build_s": None}
    if data is None:
        data, timings = _make_data(cfg, synthetic, device=device)
    train_view, val_view, _ = data
    # the global batch is batch_size × world: the LR milestones are epochs
    # of global steps
    steps_per_epoch = max(len(train_view) // (cfg.batch_size * world), 1)
    sched_steps, resume_skip = _resume_meta(cfg, steps_per_epoch)
    sched = multistep_lr_schedule(cfg.learning_rate, cfg.lr_milestones, cfg.lr_gamma,
                                  sched_steps)
    tx = make_optimizer(sched, cfg.weight_decay)

    if cfg.import_pth:
        # a warm start from a reference .pth; the run's own checkpoint
        # below still takes priority on resume
        from stereospike_tpu_torch.interop import load_torch_checkpoint

        params = load_torch_checkpoint(cfg.import_pth, model_cfg, device=device)
    else:
        params = init_params(torch.Generator().manual_seed(cfg.seed), model_cfg, device=device)
    state = create_train_state(params, tx,
                               torch.Generator().manual_seed(_rank_seed(cfg.seed + 1234, mesh)))
    state.device_generator = torch.Generator(device=device).manual_seed(
        _rank_seed(cfg.seed + 1235, mesh))
    if cfg.resume and has_checkpoint(cfg.checkpoint_dir):
        restore_checkpoint(cfg.checkpoint_dir, state, rank=rank)

    dtype = _compute_dtype(cfg)
    # the batch entries the step reads; the rest is dropped after augmentation
    keep = ["chunks", "gt", "mask"]
    if cfg.use_warmup:
        keep.append("warmup")
    if cfg.use_init_pots:
        keep.append("init_pots")
    train_step = make_train_step(model_cfg, loss_cfg, tx, learn_on=cfg.learn_on,
                                 compute_dtype=dtype, multistep=cfg.multistep,
                                 use_warmup=cfg.use_warmup, use_init_pots=cfg.use_init_pots,
                                 accum_steps=cfg.accum_steps, group=group)
    eval_step = make_eval_step(model_cfg, loss_cfg, learn_on=cfg.learn_on, compute_dtype=dtype,
                               multistep=cfg.multistep)
    pick_eval = _eval_steps(eval_step, mesh, make_sharded_eval_step)
    stager = _Stager(device)
    # training uploads only are wire-packed: eval metrics stay float-exact
    prep = _train_prep(stager, cfg, AugmentConfig(eyes=2 if binocular else 1), keep, state)

    logger = MetricsLogger(cfg.checkpoint_dir, tensorboard=cfg.tensorboard)
    logger.text(f"model={cfg.model} params={count_params(params):,} device={device} "
                f"ranks={world} steps/epoch={steps_per_epoch} batch={cfg.batch_size} "
                f"T={cfg.n_timesteps} "
                f"multistep={cfg.multistep} lr={cfg.learning_rate} dtype={cfg.compute_dtype} "
                f"augment={cfg.augment} fixture_write_s={timings['fixture_write_s']} "
                f"data_build_s={timings['data_build_s']}")

    def val_fn(epoch: int):
        t0 = time.time()
        n_val = n_batches = 0
        stats, rates = [], None
        for batch in _batch_iter(cfg, val_view, drop_last=False):
            bsz = batch["gt"].shape[0]
            out = pick_eval(bsz)(state.params, stager.eval_batch(batch))
            # per-sample means weighted by the batch's sample count: the
            # reference's per-sample statistics with a short last batch
            stats.append((out["loss"] * bsz, out["mde"] * bsz))
            if n_batches == 0 and cfg.log_firing_rates and epoch % cfg.log_firing_rates == 0:
                chunks = torch.from_numpy(np.ascontiguousarray(batch["chunks"])).to(device)
                taps = firing_rates_sequence(state.params, chunks, model_cfg)
                rates = torch.stack([taps[k] for k in TAP_NAMES])
            n_val += bsz
            n_batches += 1
        val_loss, val_mde = map(float, _fetch_sums(stats))
        fr = ({} if rates is None else
              {f"fr_{k}": float(v) for k, v in zip(TAP_NAMES, rates.cpu().numpy())})
        return val_loss, val_mde, n_val, time.time() - t0, fr

    def extra(steps_done, n_steps, train_time, val_time):
        return {"lr": float(sched(steps_done)), "train_time_s": train_time,
                "val_time_s": val_time,
                # wall-clock frames per second including host preparation
                "train_frames_per_s": round(n_steps * cfg.batch_size * cfg.n_timesteps
                                            / max(train_time, 1e-9), 2)}

    summary = _epochs(cfg, state, train_view, train_step, prep, logger, val_fn, sched_steps,
                      resume_skip, max_steps, device, on_step, extra, mesh)
    summary = dict(summary, **timings, steps_per_epoch=steps_per_epoch)
    if return_state:
        summary["state"] = state
    return summary


def _load_params(cfg: TrainConfig, model_cfg: StereoSpikeConfig, which: str,
                 device: Device) -> Dict[str, torch.Tensor]:
    """Inference parameters: a reference ``.pth`` (``import_pth``) first,
    else the run's checkpoint ``which``, else a fresh init from ``cfg.seed``."""
    if cfg.import_pth:
        from stereospike_tpu_torch.interop import load_torch_checkpoint

        return load_torch_checkpoint(cfg.import_pth, model_cfg, device=device)
    params = init_params(torch.Generator().manual_seed(cfg.seed), model_cfg, device=device)
    if has_checkpoint(cfg.checkpoint_dir, which):
        params = restore_params(cfg.checkpoint_dir, params, which)
    return params


def _test_results(stats, n_batches: int, n_samples: int, cfg: TrainConfig) -> Dict:
    tot = _fetch_sums(stats)
    results = {"test_loss": float(tot[0]) / max(n_samples, 1),
               "test_MDE": float(tot[1]) / max(n_samples, 1),
               "n_batches": n_batches, "n_samples": n_samples}
    logger = MetricsLogger(cfg.checkpoint_dir, name="test", tensorboard=cfg.tensorboard)
    logger.log(results)
    logger.text(f"Test loss: {results['test_loss']:.4f}  "
                f"Test MDE (m): {results['test_MDE']:.4f}")
    logger.close()
    return results


def eval_loop(cfg: TrainConfig, *, synthetic: bool = False, data=None, which: str = BEST,
              device: Device = "cuda") -> Dict:
    """Offline test-set evaluation (reference test.py): restore the
    checkpoint ``which``, accumulate the loss and MDE per sample, log them
    under the name ``test``. Only the test sequence is loaded."""
    if is_ann_model(cfg.model):
        return _ann_eval_loop(cfg, synthetic=synthetic, data=data, which=which, device=device)
    device = _run_device(device)
    _check_ported(cfg)
    mesh = _device_setup(cfg, device)  # offline eval keeps the launch's mesh contract
    if mesh is not None:
        device = mesh.device
    model_cfg = build_model_config(cfg)
    test_view = _test_view(cfg, synthetic, data, device)
    params = _load_params(cfg, model_cfg, which, device)
    eval_step = make_eval_step(model_cfg, _loss_config(cfg), learn_on=cfg.learn_on,
                               compute_dtype=_compute_dtype(cfg), multistep=cfg.multistep)
    pick_eval = _eval_steps(eval_step, mesh, make_sharded_eval_step)
    stager = _Stager(device)
    stats = []
    n_samples = n = 0
    for batch in _batch_iter(cfg, test_view, drop_last=False):
        bsz = batch["gt"].shape[0]
        out = pick_eval(bsz)(params, stager.eval_batch(batch))
        stats.append((out["loss"] * bsz, out["mde"] * bsz))
        n_samples += bsz
        n += 1
    return _test_results(stats, n, n_samples, cfg)


def firing_rates_loop(cfg: TrainConfig, *, synthetic: bool = False, data=None,
                      which: str = BEST, device: Device = "cuda") -> Dict[str, float]:
    """Spike-density profiling over the test set (reference
    calculate_firing_rates.py): the mean over batches of each tap's density
    over the whole T-step sequence, logged under the name ``firing_rates``.
    One forward per batch; the densities stay on the device until one
    fetch at the end."""
    if is_ann_model(cfg.model):
        raise ValueError("firing-rates profiles spike densities; ANN models "
                         "have no spikes (use an SNN model)")
    device = _run_device(device)
    _check_ported(cfg)
    mesh = _device_setup(cfg, device)  # every rank profiles the whole set; rank 0 logs
    if mesh is not None:
        device = mesh.device
    model_cfg = build_model_config(cfg)
    test_view = _test_view(cfg, synthetic, data, device)
    params = _load_params(cfg, model_cfg, which, device)
    rates_cfg = model_cfg.for_inference()
    per_batch = []
    for batch in _batch_iter(cfg, test_view, drop_last=False):
        chunks = torch.from_numpy(np.ascontiguousarray(batch["chunks"])).to(device)
        taps = firing_rates_sequence(params, chunks, rates_cfg)
        per_batch.append(torch.stack([taps[k] for k in TAP_NAMES]))
    acc = np.zeros(len(TAP_NAMES))
    for row in (torch.stack(per_batch).cpu().numpy() if per_batch else []):
        acc += row  # float64 accumulation of the float32 densities, in order
    out = {k: float(v) / max(len(per_batch), 1) for k, v in zip(TAP_NAMES, acc)}
    logger = MetricsLogger(cfg.checkpoint_dir, name="firing_rates",
                           tensorboard=cfg.tensorboard)
    logger.log(out)
    for k, v in out.items():
        logger.text(f"{k}: {v:.4f}")
    logger.text(f"mean encoder rate: {np.mean([out[k] for k in TAP_NAMES[:6]]):.4f}  "
                f"mean decoder rate: {np.mean([out[k] for k in TAP_NAMES[6:]]):.4f}")
    logger.close()
    return out


# ----------------------------------------------------------- ANN baselines
def _ann_train_loop(cfg: TrainConfig, *, synthetic: bool = False,
                    max_steps: Optional[int] = None, data=None, device: Device = "cuda",
                    on_step: Optional[Callable[[int], None]] = None) -> Dict:
    """Equivalent-ANN training (reference train.py with the ANN constructor,
    :118-120): the SNN loop's data, recipe and checkpoints, with the BN
    running statistics in the state."""
    device = _run_device(device)
    _check_ported(cfg)
    mesh = _device_setup(cfg, device)
    if mesh is not None:
        device = mesh.device
    group, rank, world = (None, 0, 1) if mesh is None else (mesh.group, mesh.rank, mesh.world)
    if cfg.debug_nans:
        enable_nan_debugging(True)
    ann_cfg = build_ann_config(cfg)
    loss_cfg = _loss_config(cfg)
    timings = {"fixture_write_s": None, "data_build_s": None}
    if data is None:
        data, timings = _make_data(cfg, synthetic, device=device)
    train_view, val_view, _ = data
    steps_per_epoch = max(len(train_view) // (cfg.batch_size * world), 1)
    sched_steps, resume_skip = _resume_meta(cfg, steps_per_epoch)
    sched = multistep_lr_schedule(cfg.learning_rate, cfg.lr_milestones, cfg.lr_gamma,
                                  sched_steps)
    tx = make_optimizer(sched, cfg.weight_decay)

    if cfg.import_pth:
        from stereospike_tpu_torch.interop import load_torch_ann_checkpoint

        params, bn_state = load_torch_ann_checkpoint(cfg.import_pth, ann_cfg, device=device)
    else:
        params = init_ann_params(torch.Generator().manual_seed(cfg.seed), ann_cfg,
                                 device=device)
        bn_state = init_ann_state(ann_cfg, device=device)
    state = create_ann_train_state(params, bn_state, tx)
    state.generator = torch.Generator().manual_seed(_rank_seed(cfg.seed + 777, mesh))
    state.device_generator = torch.Generator(device=device).manual_seed(
        _rank_seed(cfg.seed + 778, mesh))
    if cfg.resume and has_checkpoint(cfg.checkpoint_dir):
        restore_checkpoint(cfg.checkpoint_dir, state, rank=rank)

    train_step = make_ann_train_step(ann_cfg, loss_cfg, tx, learn_on=cfg.learn_on, group=group)
    eval_step = make_ann_eval_step(ann_cfg, loss_cfg, learn_on=cfg.learn_on)
    pick_eval = _eval_steps(eval_step, mesh, make_sharded_ann_eval_step)
    stager = _Stager(device)
    prep = _train_prep(stager, cfg, AugmentConfig(), EVAL_KEYS, state)

    logger = MetricsLogger(cfg.checkpoint_dir, tensorboard=cfg.tensorboard)
    logger.text(f"model={cfg.model} (ANN {ann_cfg.activation}) "
                f"params={count_params(params):,} ranks={world} "
                f"steps/epoch={steps_per_epoch} batch={cfg.batch_size}")

    def val_fn(epoch: int):
        t0 = time.time()
        stats, n_val = [], 0
        for batch in _batch_iter(cfg, val_view, drop_last=False):
            bsz = batch["gt"].shape[0]
            out = pick_eval(bsz)(state.params, state.bn_state, stager.eval_batch(batch))
            stats.append((out["loss"] * bsz, out["mde"] * bsz))
            n_val += bsz
        va = _fetch_sums(stats)
        return float(va[0]), float(va[1]), n_val, time.time() - t0, {}

    summary = _epochs(cfg, state, train_view, train_step, prep, logger, val_fn, sched_steps,
                      resume_skip, max_steps, device, on_step, lambda *a: {}, mesh)
    return dict(summary, **timings, steps_per_epoch=steps_per_epoch)


def _ann_eval_loop(cfg: TrainConfig, *, synthetic: bool = False, data=None,
                   which: str = BEST, device: Device = "cuda") -> Dict:
    """Equivalent-ANN test-set evaluation (reference test.py, :80-84)."""
    device = _run_device(device)
    _check_ported(cfg)
    mesh = _device_setup(cfg, device)
    if mesh is not None:
        device = mesh.device
    ann_cfg = build_ann_config(cfg)
    test_view = _test_view(cfg, synthetic, data, device)
    if cfg.import_pth:
        from stereospike_tpu_torch.interop import load_torch_ann_checkpoint

        params, bn_state = load_torch_ann_checkpoint(cfg.import_pth, ann_cfg, device=device)
    else:
        params = init_ann_params(torch.Generator().manual_seed(cfg.seed), ann_cfg,
                                 device=device)
        bn_state = init_ann_state(ann_cfg, device=device)
        if has_checkpoint(cfg.checkpoint_dir, which):
            restored = restore_fields(cfg.checkpoint_dir,
                                      {"params": params, "bn_state": bn_state}, which)
            params, bn_state = restored["params"], restored["bn_state"]
    eval_step = make_ann_eval_step(ann_cfg, _loss_config(cfg), learn_on=cfg.learn_on)
    pick_eval = _eval_steps(eval_step, mesh, make_sharded_ann_eval_step)
    stager = _Stager(device)
    stats = []
    n_samples = n = 0
    for batch in _batch_iter(cfg, test_view, drop_last=False):
        bsz = batch["gt"].shape[0]
        out = pick_eval(bsz)(params, bn_state, stager.eval_batch(batch))
        stats.append((out["loss"] * bsz, out["mde"] * bsz))
        n_samples += bsz
        n += 1
    return _test_results(stats, n, n_samples, cfg)


# ----------------------------------------------------------------- serving
def stream_loop(cfg: TrainConfig, *, synthetic: bool = False, events_dir: Optional[str] = None,
                n_windows: int = 20, pipeline: int = 1, events_per_window: int = 20000,
                save_video: Optional[str] = None, aer_format: str = "TXYP",
                listen: Optional[str] = None, source=None, reply: bool = False,
                artifact: Optional[str] = None, aedat: Optional[str] = None,
                realtime: bool = False, which: str = BEST, device: Device = "cuda",
                depths: Optional[List[np.ndarray]] = None) -> Dict:
    """Streaming-serving driver: feed event windows through the
    :class:`~stereospike_tpu_torch.streaming.StreamingEvaluator`, carrying
    the membrane state across windows, and log per-window latencies.

    Weights (:func:`_load_params`): ``cfg.import_pth``, else ``which`` in
    ``cfg.checkpoint_dir``, else a fresh init from ``cfg.seed``. Sources
    (:mod:`stereospike_tpu_torch.sources`): ``synthetic`` random windows;
    ``events_dir`` — a DENSE-format ``events/data/*.npy`` directory (one
    file per window; monocular); ``listen`` — ``"host:port"`` (or just
    ``"port"``) to accept a live SPKE-protocol TCP event feed (``n_windows
    <= 0`` serves successive producers until a re-accept times out);
    ``aedat`` — an AEDAT 3.1 recording path (or ``"left,right"`` paths for
    a stereo rig); or an explicit ``source`` iterable of per-eye window
    dicts. ``reply`` sends each depth map back to the ``listen`` producer.

    ``artifact``: serve from an exported ``.ssx`` artifact (``cli
    export-serving``) instead of live params: geometry (eyes, window,
    block, streams) comes from its manifest and the step from its exported
    program; ``cfg.model`` and checkpoints are ignored.

    Served depth maps are appended to ``depths`` when a list is given.
    Returns the JAX package's result keys. ``save_video`` is not ported
    (it needs cv2, which the card's machine lacks) and raises.
    """
    from stereospike_tpu_torch import sources as src

    if save_video:
        raise NotImplementedError("--save-video is not ported: it needs cv2 (ROADMAP A.9)")
    evaluator = None
    if artifact is not None:
        evaluator = StreamingEvaluator.from_artifact(artifact, pipeline=pipeline,
                                                     reset_each_window=False)
        if evaluator.n_streams != 1:
            raise ValueError(
                f"this driver's sources emit single-camera windows; the artifact serves "
                f"n_streams={evaluator.n_streams} — use StreamingEvaluator.from_artifact "
                "directly and push() per-stream lists")
        eyes = evaluator.eyes
        binocular = len(eyes) > 1
    else:
        if is_ann_model(cfg.model):
            raise ValueError("streaming serves the stateful SNN models")
        device = serving_device(device)
        model_cfg = build_model_config(cfg)
        binocular = cfg.model != "stereospike_monocular"
        params = _load_params(cfg, model_cfg, which, device)
        eyes = ("left", "right") if binocular else ("left",)

    # the MVSEC 20 Hz cadence; an artifact's baked grid wins
    window_s = evaluator.window if evaluator is not None else 0.05
    max_windows = None  # set by the --listen branch (unbounded elsewhere)
    if source is not None:
        window_s = float(getattr(source, "window_s", window_s))
    elif listen is not None:
        host, _, port = listen.rpartition(":")
        # the source object itself is kept (reply() and late_dropped live on
        # it): the window count is bounded in the serving loop below
        source = src.SocketSource(host or "127.0.0.1", int(port), eyes=eyes,
                                  window_s=window_s, reconnect=n_windows <= 0)
        max_windows = n_windows if n_windows > 0 else None
    elif aedat is not None:
        paths = [p for p in aedat.split(",") if p]
        if len(paths) != len(eyes):
            raise ValueError(
                f"model {cfg.model} consumes {len(eyes)} eye(s) ({'/'.join(eyes)}); "
                f"--aedat got {len(paths)} path(s) — pass one AEDAT 3.1 file per eye, "
                "comma-separated")
        source = src.AedatFileSource(dict(zip(eyes, paths)), window_s=window_s,
                                     n_windows=n_windows or None, realtime=realtime)
    elif events_dir is not None:
        if binocular:
            raise ValueError("events_dir is a monocular (DENSE-format) source; use "
                             "model=stereospike_monocular")
        # the bin grid is window/nfpdm: ReplayDirSource sizes the window from
        # the longest file's span, so no file's tail lands in the dump bin
        source = src.ReplayDirSource(events_dir, aer_format=aer_format,
                                     n_windows=n_windows)
        window_s = source.window_s
    else:
        if not synthetic:
            raise ValueError("need --synthetic, an events_dir, an --aedat recording, or a "
                             "--listen source")
        hw = (tuple(evaluator.artifact.meta["in_hw"]) if evaluator is not None
              else tuple(cfg.in_hw))
        source = src.SyntheticSource(hw=hw, eyes=eyes, n_windows=n_windows,
                                     events_per_window=events_per_window, window_s=window_s,
                                     seed=cfg.seed)

    if evaluator is None:
        evaluator = StreamingEvaluator(params, model_cfg, eyes=eyes, nfpdm=cfg.nfpdm,
                                       window=window_s, reset_each_window=False,
                                       pipeline=pipeline, compute_dtype=_compute_dtype(cfg),
                                       device=device)
    elif abs(window_s - evaluator.window) > 0.1 * evaluator.window:
        # the artifact's bin grid (window/nfpdm) is baked into its step
        warnings.warn(
            f"source window {window_s * 1e3:.1f} ms differs from the artifact's baked "
            f"{evaluator.window * 1e3:.1f} ms grid; events past the grid land in the dump "
            "bin (binned_out_events)")

    can_reply = reply and hasattr(source, "reply")
    if reply and not can_reply:
        raise ValueError("--reply needs a --listen (socket) source")
    if can_reply and max_windows is None and pipeline:
        # serve-forever spans producer reconnects: a pipelined depth of
        # producer A would be replied over producer B's connection
        warnings.warn("--reply with --n-windows 0 forces --pipeline 0 "
                      "(pipelined replies would cross producer reconnects)")
        pipeline = 0
        evaluator.pipeline = 0

    def served(d: Optional[np.ndarray]) -> int:
        if d is None:
            return 0
        if depths is not None:
            depths.append(d)
        if can_reply:
            # per reply, not a latch: a producer that stops reading loses
            # only its own replies
            try:
                source.reply(d)
            except (OSError, RuntimeError):
                pass
        return 1

    lat = []
    n_served = 0
    t_start = time.time()
    # the iterator outlives the window bound: a socket source's connection
    # stays open until the pipelined tail below has been replied
    windows = iter(source)
    for win in windows:
        t0 = time.time()
        d = evaluator.push(win)
        lat.append(time.time() - t0)
        n_served += served(d)
        if max_windows is not None and len(lat) >= max_windows:
            break
    while served(evaluator.flush()):
        n_served += 1
    if hasattr(windows, "close"):
        windows.close()
    lat_ms = np.asarray(lat[1:] or lat) * 1e3  # drop the first (warm-up) window

    results = {
        "n_windows": n_served,
        "interval_ms_mean": round(float(lat_ms.mean()), 3) if len(lat_ms) else None,
        "interval_ms_p99": (round(float(np.percentile(lat_ms, 99)), 3)
                            if len(lat_ms) else None),
        "pipeline": pipeline,
        "dropped_events": int(sum(b.dropped for sb in evaluator.stream_buffers
                                  for b in sb.values())),
        # events the voxelizer rejected (out-of-window timestamps / view):
        # nonzero usually means a mis-relativized event feed
        "binned_out_events": int(evaluator.binning_dropped),
        # events that arrived after their window was emitted (socket, AEDAT)
        "late_events": int(getattr(source, "late_dropped", 0)),
        "video": None,
        "total_time_s": round(time.time() - t_start, 3),
    }
    logger = MetricsLogger(cfg.checkpoint_dir, name="stream", tensorboard=cfg.tensorboard)
    logger.log(results)
    logger.close()
    return results
