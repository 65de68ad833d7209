"""The port's drivers (``stereospike_tpu_torch/train/loop.py``, ``cli.py``,
``train/checkpoint.py``) on the CPU, against the JAX package's.

- The training loop against JAX's: both start from one reference ``.pth``
  (``import_pth``) on their own synthetic fixtures (equal arrays,
  ``tests/test_torch_data.py``), flagship, float32, no augmentation, wire
  packing on, B=4, 2 epochs cut at 7 steps. Equal exactly: the steps per
  epoch, the batch order of each epoch, the LR of every step (as float32,
  the JAX schedule's type), and which epochs write ``best``. The
  per-epoch scalars to rtol 1e-4 (train) and 1e-3 (val). What separates
  them is float32 reassociation: the JAX training forward runs its TPU
  execution forms (space-to-depth level 0, polyphase upsample-convs),
  which sum in another order than the port's canonical convolutions, and
  Adam magnifies a near-zero gradient's ulps into whole steps. Measured
  here: 2e-5 relative at most.
- The checkpoint round trip (SNN and ANN states, generators included, read
  back by ``torch.load(weights_only=True)``).
- SIGTERM mid-epoch, then ``resume``: the same batches, in the same order,
  with the same augmentation, and the same final state as an
  uninterrupted run.
- The CLI's ``train`` / ``eval`` / ``firing-rates``, ``--save-config``, the
  layer-major path with warmup and seeded integrators, DENSE and the ANN
  loop; the refusals (no card without ``device="cpu"``, fields whose parts
  are not ported).
"""

import dataclasses
import hashlib
import json
import os
import shutil
import signal

import numpy as np
import pytest
import torch

from stereospike_tpu.interop import params_to_torch_state_dict
from stereospike_tpu.models import factory as jax_factory
from stereospike_tpu.models import init_params as jax_init_params
from stereospike_tpu.train import loop as jax_loop
from stereospike_tpu.train.config import TrainConfig as JaxTrainConfig
from stereospike_tpu.train.state import multistep_lr_schedule as jax_schedule
from stereospike_tpu_torch import cli
from stereospike_tpu_torch.interop import load_torch_checkpoint
from stereospike_tpu_torch.models import factory
from stereospike_tpu_torch.models.ann import AnnConfig, init_ann_params, init_ann_state
from stereospike_tpu_torch.models.stereospike import TAP_NAMES, init_params
from stereospike_tpu_torch.train import loop
from stereospike_tpu_torch.train.ann_steps import create_ann_train_state
from stereospike_tpu_torch.train.checkpoint import (
    has_checkpoint,
    load_meta,
    restore_checkpoint,
    restore_fields,
    restore_params,
    save_checkpoint,
)
from stereospike_tpu_torch.train.config import TrainConfig
from stereospike_tpu_torch.train.state import create_train_state, make_optimizer

HW = (32, 44)
# 12 depth frames: 2 train sequences of 10 samples, B=4 → 5 steps per epoch
DATA = dict(in_hw=HW, batch_size=4, synth_frames=12, synth_events=4000, synth_learnable=True,
            tensorboard=False, seed=3)
MAX_STEPS = 7
TRAIN_RTOL, VAL_RTOL = 1e-4, 1e-3


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """Each run writes full checkpoints (flagship parameters and Adam's two
    moments, ~218 MB a file): remove a test's files when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _records(path):
    with open(os.path.join(path, "training_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX and one port training run from the same reference .pth."""
    tmp = tmp_path_factory.mktemp("loops")
    mcfg = jax_factory.stereospike(in_hw=HW, in_channels=4)
    sd = params_to_torch_state_dict(jax_init_params(__import__("jax").random.PRNGKey(0), mcfg))
    pth = str(tmp / "weights.pth")
    torch.save({k: torch.as_tensor(np.array(v)) for k, v in sd.items()}, pth)
    kw = dict(DATA, model="stereospike", epochs=2, augment=False, import_pth=pth)
    jcfg = JaxTrainConfig(**kw, checkpoint_dir=str(tmp / "jax"))
    pcfg = TrainConfig(**kw, checkpoint_dir=str(tmp / "port"))
    jsum = jax_loop.train_loop(jcfg, synthetic=True, max_steps=MAX_STEPS)
    psum = loop.train_loop(pcfg, synthetic=True, max_steps=MAX_STEPS, device="cpu")
    yield jcfg, pcfg, jsum, psum
    shutil.rmtree(tmp, ignore_errors=True)


def test_train_loop_matches_jax(runs):
    jcfg, pcfg, jsum, psum = runs
    jrec, prec = _records(jcfg.checkpoint_dir), _records(pcfg.checkpoint_dir)
    assert len(jrec) == len(prec) == 2
    assert [r["step"] for r in prec] == [r["step"] for r in jrec] == [5, MAX_STEPS]
    assert psum["steps_per_epoch"] == 5
    assert (load_meta(pcfg.checkpoint_dir)["steps_per_epoch"]
            == json.load(open(os.path.join(jcfg.checkpoint_dir,
                                           "checkpoint_meta.json")))["steps_per_epoch"])
    for j, p in zip(jrec, prec):
        assert np.float32(p["lr"]) == np.float32(j["lr"])
        for k in ("train_loss", "train_MDE"):
            np.testing.assert_allclose(p[k], j[k], rtol=TRAIN_RTOL, err_msg=k)
        for k in ("val_loss", "val_MDE"):
            np.testing.assert_allclose(p[k], j[k], rtol=VAL_RTOL, err_msg=k)
    # which epochs wrote best: a strict improvement of val_MDE each time

    def bests(rec):
        out, best = [], np.inf
        for r in rec:
            out.append(r["val_MDE"] < best)
            best = min(best, np.float32(r["val_MDE"])) if out[-1] else best
        return out

    assert bests(prec) == bests(jrec)
    assert has_checkpoint(pcfg.checkpoint_dir, "best.pt")
    np.testing.assert_allclose(psum["best_val_MDE"], jsum["best_val_MDE"], rtol=VAL_RTOL)


def test_batch_order_and_lr_match_jax(runs):
    jcfg, pcfg, _, _ = runs
    jtrain = jax_loop._make_data(jcfg, True, None)[0]
    ptrain = loop._make_data(pcfg, True, device="cpu")[0][0]
    for epoch in range(2):
        kw = dict(shuffle=True, seed=pcfg.seed + epoch)
        got = list(loop._batch_iter(pcfg, ptrain, **kw))
        want = list(jax_loop._batch_iter(jcfg, jtrain, **kw))
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    ours = loop.multistep_lr_schedule(2e-4, (1, 2), 0.5, 5)
    theirs = jax_schedule(2e-4, (1, 2), 0.5, 5)
    assert [np.float32(ours(s)) for s in range(16)] == [np.float32(theirs(s))
                                                       for s in range(16)]


def test_checkpoint_round_trip(tmp_path):
    cfg = factory.stereospike_tempo(in_hw=(16, 20), base_channels=4)
    tx = make_optimizer(1e-3)
    state = create_train_state(init_params(torch.Generator().manual_seed(0), cfg, device="cpu"),
                               tx, torch.Generator().manual_seed(1))
    state.device_generator = torch.Generator().manual_seed(2)
    sum(p.sum() for p in state.params.values()).backward()
    state.optimizer.step()
    state.step, state.epoch, state.best_metric = 7, 2, 0.25
    torch.rand(5, generator=state.generator)
    d = str(tmp_path)
    save_checkpoint(d, state, best=True, tag="epoch_0001", meta_extra={"steps_per_epoch": 3})
    assert all(has_checkpoint(d, w) for w in ("latest.pt", "best.pt", "epoch_0001.pt"))
    assert load_meta(d) == {"step": 7, "epoch": 2, "best_metric": 0.25, "steps_per_epoch": 3}
    raw = torch.load(os.path.join(d, "latest.pt"), weights_only=True)
    assert raw["step"] == 7 and set(raw["params"]) == set(state.params)

    fresh = create_train_state(init_params(torch.Generator().manual_seed(9), cfg, device="cpu"),
                               tx, torch.Generator().manual_seed(8))
    fresh.device_generator = torch.Generator().manual_seed(7)
    restore_checkpoint(d, fresh)
    assert (fresh.step, fresh.epoch, fresh.best_metric) == (7, 2, 0.25)
    for k, v in state.params.items():
        assert torch.equal(fresh.params[k], v), k
    for g in ("generator", "device_generator"):
        assert torch.equal(getattr(fresh, g).get_state(), getattr(state, g).get_state())
    ours, theirs = fresh.optimizer.state_dict(), state.optimizer.state_dict()
    for i, s in theirs["state"].items():
        for k, v in s.items():
            assert torch.equal(ours["state"][i][k], v), (i, k)
    p = restore_params(d, init_params(torch.Generator().manual_seed(5), cfg, device="cpu"))
    assert all(torch.equal(p[k], state.params[k]) for k in p)

    acfg = AnnConfig(in_channels=4, base_channels=4, in_hw=(16, 20))
    ann = create_ann_train_state(init_ann_params(torch.Generator().manual_seed(0), acfg,
                                                 device="cpu"),
                                 init_ann_state(acfg, device="cpu"), tx)
    for v in ann.bn_state.values():
        v.add_(0.5)
    save_checkpoint(str(tmp_path / "ann"), ann, best=True)
    back = restore_fields(str(tmp_path / "ann"),
                          {"params": init_ann_params(torch.Generator().manual_seed(3), acfg,
                                                     device="cpu"),
                           "bn_state": init_ann_state(acfg, device="cpu")})
    for name in ("params", "bn_state"):
        for k, v in getattr(ann, name).items():
            assert torch.equal(back[name][k], v), k
    with pytest.raises(KeyError):
        restore_params(d, init_params(torch.Generator().manual_seed(5),
                                      factory.stereospike(in_hw=(16, 20), base_channels=4),
                                      device="cpu"))


def _recording_steps(monkeypatch):
    """Record a digest of every batch the train step receives."""
    seen = []
    make = loop.make_train_step

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def wrapped(state, batch):
            h = hashlib.sha1()
            for k in sorted(batch):
                h.update(k.encode() + batch[k].contiguous().numpy().tobytes())
            seen.append(h.hexdigest())
            return step(state, batch)

        return wrapped

    monkeypatch.setattr(loop, "make_train_step", recording)
    return seen


def test_sigterm_then_resume_reproduces_the_uninterrupted_run(tmp_path, monkeypatch):
    seen = _recording_steps(monkeypatch)
    kw = dict(DATA, model="stereospike", epochs=2, augment=True, pack_io=True, prefetch=2)
    full = loop.train_loop(TrainConfig(**kw, checkpoint_dir=str(tmp_path / "full")),
                           synthetic=True, device="cpu", return_state=True)
    uninterrupted = list(seen)
    assert len(uninterrupted) == 10 and len(set(uninterrupted)) == 10
    seen.clear()

    cfg = TrainConfig(**kw, checkpoint_dir=str(tmp_path / "cut"))

    def preempt(step):
        if step == 3:  # mid-epoch 0, with the worker staged batches ahead
            os.kill(os.getpid(), signal.SIGTERM)

    cut = loop.train_loop(cfg, synthetic=True, device="cpu", on_step=preempt)
    assert cut == {"epoch": 0, "step": 3, "preempted": True} | {
        k: cut[k] for k in ("fixture_write_s", "data_build_s", "steps_per_epoch")}
    assert load_meta(cfg.checkpoint_dir)["epoch_step_offset"] == 3
    assert signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL, signal.SIG_IGN)
    resumed = loop.train_loop(dataclasses.replace(cfg, resume=True), synthetic=True,
                              device="cpu", return_state=True)
    assert seen == uninterrupted
    assert resumed["epoch"] == full["epoch"] == 1
    a, b = full["state"], resumed["state"]
    assert (a.step, a.epoch) == (b.step, b.epoch) == (10, 2)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert torch.equal(a.device_generator.get_state(), b.device_generator.get_state())
    for k in ("train_loss", "val_loss", "val_MDE"):
        assert resumed[k] == full[k], k


def _cli(argv, capsys):
    assert cli.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _flags(**kw):
    out = []
    for k, v in kw.items():
        out += ["--" + k.replace("_", "-"),
                ",".join(map(str, v)) if isinstance(v, tuple) else str(v).lower()
                if isinstance(v, bool) else str(v)]
    return out


def test_cli_train_eval_firing_rates_and_resume(tmp_path, capsys):
    ckpt = str(tmp_path / "run")
    common = ["--synthetic", "--device", "cpu", "--checkpoint-dir", ckpt, "--model",
              "stereospike_tempo", *_flags(**DATA)]
    out = _cli(["train", "--epochs", "2", "--max-steps", "6", *common], capsys)
    assert out["epoch"] == 1 and np.isfinite(out["train_loss"])
    assert has_checkpoint(ckpt, "best.pt") and has_checkpoint(ckpt, "latest.pt")
    test = _cli(["eval", "--which", "best.pt", *common], capsys)
    assert test["n_batches"] > 0 and np.isfinite(test["test_MDE"])
    assert os.path.exists(os.path.join(ckpt, "test_logs.txt"))
    rates = _cli(["firing-rates", *common], capsys)
    assert list(rates) == list(TAP_NAMES) and all(0.0 <= v <= 1.0 for v in rates.values())
    resumed = _cli(["train", "--epochs", "3", "--resume", "true", *common], capsys)
    assert resumed["epoch"] == 2 and load_meta(ckpt)["step"] == 11
    path = str(tmp_path / "cfg.json")
    _cli(["train", "--save-config", path, "--learning-rate", "0.001", *common], capsys)
    saved = TrainConfig.from_json(open(path).read())
    assert saved.learning_rate == 0.001 and saved.in_hw == HW and saved.synth_learnable
    assert cli.build_config(cli.build_parser().parse_args(
        ["eval", "--config", path, "--seed", "9"])) == dataclasses.replace(saved, seed=9)


def test_cli_layer_major_dense_and_ann(tmp_path, capsys):
    base = ["--synthetic", "--device", "cpu", *_flags(**DATA)]
    ms = _cli(["train", "--epochs", "1", "--max-steps", "2", "--model", "stereospike_tempo",
               "--n-inference", "2", "--n-timesteps", "2", "--multistep", "true",
               "--use-warmup", "true", "--use-init-pots", "true", "--n-warmup", "2",
               "--checkpoint-dir", str(tmp_path / "ms"), *base], capsys)
    assert np.isfinite(ms["train_loss"]) and load_meta(str(tmp_path / "ms"))["step"] == 2
    dense = _cli(["train", "--epochs", "1", "--dataset", "dense", "--model",
                  "stereospike_monocular", "--checkpoint-dir", str(tmp_path / "dense"), *base],
                 capsys)
    assert dense["steps_per_epoch"] == 2 and np.isfinite(dense["val_MDE"])
    ann = ["--model", "ann_sigmoid", "--checkpoint-dir", str(tmp_path / "ann"), *base]
    out = _cli(["train", "--epochs", "1", "--max-steps", "2", *ann], capsys)
    assert np.isfinite(out["val_MDE"]) and has_checkpoint(str(tmp_path / "ann"), "best.pt")
    raw = torch.load(os.path.join(tmp_path, "ann", "best.pt"), weights_only=True)
    assert raw["bn_state"] and raw["step"] == 2
    test = _cli(["eval", *ann], capsys)
    assert np.isfinite(test["test_MDE"])


def test_refusals(tmp_path):
    cfg = TrainConfig(**DATA, checkpoint_dir=str(tmp_path))
    if not torch.cuda.is_available():
        for fn in (loop.train_loop, loop.eval_loop, loop.firing_rates_loop):
            with pytest.raises(RuntimeError, match="CUDA"):
                fn(cfg, synthetic=True)
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["train", "--synthetic", "--checkpoint-dir", str(tmp_path)])
    for bad in (dict(save_viz=1), dict(mesh_shape=(1, 2))):
        with pytest.raises(NotImplementedError):
            loop.train_loop(dataclasses.replace(cfg, **bad), synthetic=True, device="cpu")
    mcfg = factory.stereospike(in_hw=HW)
    sd = init_params(torch.Generator().manual_seed(0), mcfg, device="cpu")
    pth = str(tmp_path / "w.pth")
    torch.save(sd, pth)
    back = load_torch_checkpoint(pth, mcfg, device="cpu")
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    with pytest.raises(KeyError):
        load_torch_checkpoint(pth, factory.stereospike_tempo(in_hw=HW), device="cpu")
    with pytest.raises(ValueError):
        load_torch_checkpoint(pth, factory.stereospike(in_hw=HW, in_channels=2), device="cpu")
