"""Data-parallel training of the port (``parallel/mesh.py``) on the CPU:
two gloo ranks in two processes (``tests/torch_parallel_worker.py``, whose
output goes to a file, not a pipe) against one process on the global
batch, and against the JAX package's sharded steps.

At the step level (base 8, 32×44, global batch 4, two ranks of 2):

- the flagship's step at T=1, layer-major at T=2 and with
  ``accum_steps=2``, at float64: loss and MDE to rtol 1e-9, the summed
  gradients to 1e-8 of each tensor's largest magnitude, the parameters
  after Adam to rtol 1e-8 / atol 1e-11 (``test_torch_train.py``'s
  tolerances); both ranks' parameters bit-equal. Float64, so that no
  spike flips at the threshold between the two summation orders;
- the equivalent ANN's step, with BatchNorm over the global batch, at
  float64: the same tolerances, and the BN running statistics to rtol
  1e-9. The global BatchNorm alone at float64, against ``F.batch_norm``
  on the whole batch: rtol 1e-12;
- the flagship's and the ANN's eval steps split over the two ranks,
  against one process on the whole batch at float64: rtol 1e-12;
- JAX anchors: the 2-rank flagship step against the JAX
  ``make_sharded_train_step`` over a (2, 1) mesh of the conftest's
  virtual CPU devices at float64 (rtol 1e-9, parameters rtol 1e-8 / atol
  1e-11), and the 2-rank ANN step against ``make_sharded_ann_train_step``
  at float32, the JAX ANN step's only dtype: loss, MDE and BN running
  statistics to rtol 1e-5, parameters as in ``test_torch_ann.py`` (all
  within 6 learning rates, 99.9 % within 1e-5: Adam's first update is
  about lr·sign(g), and a gradient within float32 noise of 0 may change
  sign).

The loop: ``train_loop`` in two processes against one process at twice
the batch (final parameters within rtol 1e-3 / atol 1e-5, the JAX
multi-host test's tolerance: float32 training); only rank 0 writes; a
SIGTERM to one rank stops both at the same step, and the resumed run ends
bit for bit where the uninterrupted one does; ``mesh_shape`` with a
spatial axis or a wrong data axis raises.
"""

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stereospike_tpu.models import factory as jax_factory
from stereospike_tpu.models.ann import AnnConfig as JaxAnnConfig
from stereospike_tpu.objectives.losses import TotalLossConfig as JaxTotalLossConfig
from stereospike_tpu.parallel import make_mesh as jax_make_mesh
from stereospike_tpu.parallel import make_sharded_ann_train_step as jax_sharded_ann_step
from stereospike_tpu.parallel import make_sharded_train_step as jax_sharded_step
from stereospike_tpu.parallel import shard_batch as jax_shard_batch
from stereospike_tpu.train.ann_steps import create_ann_train_state as jax_create_ann_state
from stereospike_tpu.train.ann_steps import make_ann_train_step as jax_make_ann_step
from stereospike_tpu.train.state import create_train_state as jax_create_train_state
from stereospike_tpu.train.state import make_optimizer as jax_make_optimizer
from stereospike_tpu.train.steps import make_train_step as jax_make_train_step
from stereospike_tpu_torch import cli
from stereospike_tpu_torch.data.synthetic import synthetic_batch
from stereospike_tpu_torch.interop import ann_params_to_jax, params_to_jax
from stereospike_tpu_torch.models import factory
from stereospike_tpu_torch.models.ann import AnnConfig, init_ann_params, init_ann_state
from stereospike_tpu_torch.models.stereospike import init_params
from stereospike_tpu_torch.train.config import TrainConfig
from stereospike_tpu_torch.train.loop import train_loop
from test_torch_sequence import _leaves
from torch_parallel_worker import LR, SNN_CASES, ann_step, eval_steps, snn_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
HW = (32, 44)
WORLD, PER_RANK = 2, 2
WORKER_TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(workdir, args, tag, world=WORLD, extra=None):
    """``world`` worker processes with the launcher's environment; each
    one's output goes to ``<tag>_<rank>.log``."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="2")
        log = open(os.path.join(workdir, f"{tag}_{rank}.log"), "w")
        argv = [sys.executable, "-u", WORKER, "--workdir", workdir, *args,
                *((extra or {}).get(rank, ()))]
        procs.append((subprocess.Popen(argv, cwd=REPO, env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    return procs


def _wait(procs, timeout_s=WORKER_TIMEOUT_S):
    deadline = time.time() + timeout_s
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.time(), 1.0))
    except subprocess.TimeoutExpired:
        for p, _ in procs:
            p.kill()
            p.wait()
    for rank, (p, log) in enumerate(procs):
        log.close()
        with open(log.name) as f:
            out = f.read()
        assert p.returncode == 0, f"rank {rank} rc={p.returncode}\n{out[-4000:]}"


def _run(workdir, args, tag, **kw):
    _wait(_launch(workdir, args, tag, **kw))


# ----------------------------------------------------------------- the steps
def _snn_params():
    """The port's flagship weights at base 8, float64, conv weights ×4 so
    that every site fires at this size (as ``test_torch_sequence.py``)."""
    cfg = factory.stereospike(in_hw=HW, base_channels=8)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu",
                         dtype=torch.float64)
    return {k: v * 4.0 if k.endswith(".weight") else v for k, v in params.items()}


def _batch(seed, dtype, T=1):
    return synthetic_batch(torch.Generator().manual_seed(seed), batch=WORLD * PER_RANK,
                           in_hw=HW, T=T, dtype=dtype, device="cpu")


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The inputs (written here), both ranks' results and the inputs."""
    batches = {case: _batch(10 + i, torch.float64, T)
               for i, (case, (_, T)) in enumerate(SNN_CASES.items())}
    batches["ann64"] = _batch(20, torch.float64)
    batches["ann"] = {k: v.float() if v.is_floating_point() else v
                      for k, v in batches["ann64"].items()}
    ann_cfg = AnnConfig(in_hw=HW, base_channels=8)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0.3, 2.0, (WORLD * PER_RANK, 5, 6, 7)))
    inputs = {
        "hw": HW,
        "snn_params": _snn_params(),
        "ann_params": init_ann_params(torch.Generator().manual_seed(3), ann_cfg, device="cpu"),
        # running statistics away from their initial 0 and 1
        "ann_bn": {k: v + 0.25 for k, v in init_ann_state(ann_cfg, device="cpu").items()},
        "batches": batches,
        "bn": {"x": x, "probe": torch.from_numpy(rng.normal(size=x.shape)),
               "weight": torch.from_numpy(rng.normal(1.0, 0.2, 5)),
               "bias": torch.from_numpy(rng.normal(0.0, 0.2, 5)),
               "state": {"running_mean": torch.zeros(5, dtype=torch.float64),
                         "running_var": torch.ones(5, dtype=torch.float64)}},
    }
    workdir = str(tmp_path_factory.mktemp("steps"))
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    _run(workdir, ["--scenario", "steps"], "steps")
    ranks = [torch.load(os.path.join(workdir, f"steps_{r}.pt"), weights_only=True)
             for r in range(WORLD)]
    return {"ranks": ranks, "inputs": inputs}


def _ranks_bit_equal(ranks, case):
    for k, v in ranks[0][case]["params"].items():
        assert torch.equal(v, ranks[1][case]["params"][k]), (case, k)


def _close_grads(got, want, rel):
    for k, g in want.items():
        scale = float(g.abs().max())
        assert float((got[k] - g).abs().max()) <= rel * max(scale, 1e-300), k


def _interleaved(batch):
    """The global batch as one process's ``accum_steps=2`` sees the two
    ranks' microbatches: microbatch k = rank 0's k-th and rank 1's k-th."""
    order = [r * PER_RANK + k for k in range(PER_RANK) for r in range(WORLD)]
    return {k: v[order] for k, v in batch.items()}


@pytest.mark.parametrize("case", list(SNN_CASES))
def test_two_ranks_equal_one_rank_snn_step(steps, case):
    ranks, inp = steps["ranks"], steps["inputs"]
    _ranks_bit_equal(ranks, case)
    batch = inp["batches"][case]
    if case == "snn_accum2":
        batch = _interleaved(batch)
    step, state = snn_step(case, inp["snn_params"], HW)
    state, m = step(state, batch)
    got = ranks[0][case]
    np.testing.assert_allclose([got["loss"], got["mde"]], [float(m["loss"]), float(m["mde"])],
                               rtol=1e-9)
    want_grads = {k: p.grad for k, p in state.params.items()}
    assert sum(float(g.abs().max()) > 0 for g in want_grads.values()) >= len(want_grads) - 2
    _close_grads(got["grads"], want_grads, 1e-8)
    for k, p in state.params.items():
        np.testing.assert_allclose(got["params"][k].numpy(), p.detach().numpy(), rtol=1e-8,
                                   atol=1e-11, err_msg=k)


def test_all_reduces_per_step(steps):
    """The collectives of one step, on both ranks: the loss's sums of
    every head in one all-reduce, the MDE's in one, the gradients in one
    flattened buffer; ``accum_steps=2`` forms the loss and the MDE once per
    microbatch; the ANN adds, at each BatchNorm, the sum and the centred
    sum of squares and their cotangents (``chip_smoke.py`` holds the
    flagship's T=1 step on the card to the same 3)."""
    ranks = steps["ranks"]
    n_bn = sum(k.endswith("running_mean") for k in steps["inputs"]["ann_bn"])
    want = {"snn_t1": 3, "snn_layer_major": 3, "snn_accum2": 5,
            "ann": 3 + 4 * n_bn, "ann64": 3 + 4 * n_bn}
    assert n_bn > 0
    for r in ranks:
        assert {case: r[case]["all_reduces"] for case in want} == want


def _ann_params_close(got, want):
    """All within 6 learning rates; 99.9 % within 1e-5."""
    diffs = np.concatenate([(got[k] - want[k]).abs().reshape(-1).numpy() for k in want])
    assert diffs.max() <= 6 * LR, diffs.max()
    assert np.mean(diffs <= 1e-5) >= 0.999


def test_two_ranks_equal_one_rank_ann_step_with_global_batchnorm(steps):
    """The ANN step at float64 (its input cast to the parameters' dtype):
    the tolerances of the flagship's step, and the BN running statistics
    to rtol 1e-9."""
    ranks, inp = steps["ranks"], steps["inputs"]
    _ranks_bit_equal(ranks, "ann64")
    params = {k: v.double() for k, v in inp["ann_params"].items()}
    bn0 = {k: v.double() for k, v in inp["ann_bn"].items()}
    step, state = ann_step(params, bn0, HW)
    state, m = step(state, inp["batches"]["ann64"])
    got = ranks[0]["ann64"]
    np.testing.assert_allclose([got["loss"], got["mde"]], [float(m["loss"]), float(m["mde"])],
                               rtol=1e-9)
    for k, v in state.bn_state.items():
        assert not torch.equal(v, bn0[k]), k  # the statistics moved
        np.testing.assert_allclose(got["bn_state"][k].numpy(), v.numpy(), rtol=1e-9, err_msg=k)
        assert torch.equal(got["bn_state"][k], ranks[1]["ann64"]["bn_state"][k])
    _close_grads(got["grads"], {k: p.grad for k, p in state.params.items()}, 1e-8)
    for k, p in state.params.items():
        np.testing.assert_allclose(got["params"][k].numpy(), p.detach().numpy(), rtol=1e-8,
                                   atol=1e-11, err_msg=k)


@pytest.mark.parametrize("model", ["snn", "ann"])
def test_two_rank_eval_step_equals_one_process(steps, model):
    """The eval step split over two ranks (each its half of the batch, the
    per-sample means and the depth maps gathered) against one process on
    the whole batch, at float64: loss, MDE and depth to rtol 1e-12, the
    same on both ranks."""
    inp = steps["inputs"]
    snn_eval, ann_eval = eval_steps(HW)
    if model == "snn":
        want = snn_eval(inp["snn_params"], inp["batches"]["snn_t1"])
    else:
        want = ann_eval({k: v.double() for k, v in inp["ann_params"].items()},
                        {k: v.double() for k, v in inp["ann_bn"].items()},
                        inp["batches"]["ann64"])
    got = [r[f"{model}_eval"] for r in steps["ranks"]]
    for k in ("loss", "mde", "depth"):
        assert torch.equal(got[0][k], got[1][k]), k
        np.testing.assert_allclose(got[0][k].numpy(), want[k].numpy(), rtol=1e-12, err_msg=k)


def test_global_batchnorm_float64(steps):
    """The BatchNorm over two ranks' halves == ``F.batch_norm`` over the
    whole batch: output, running statistics, the input's gradient and
    (summed over ranks) the weight's."""
    ranks, bn = steps["ranks"], steps["inputs"]["bn"]
    weight = bn["weight"].clone().requires_grad_(True)
    x = bn["x"].clone().requires_grad_(True)
    rm, rv = bn["state"]["running_mean"].clone(), bn["state"]["running_var"].clone()
    y = F.batch_norm(x, rm, rv, weight, bn["bias"], training=True, momentum=0.1, eps=1e-5)
    (y * bn["probe"]).sum().backward()
    got = [r["bn64"] for r in ranks]
    rtol = 1e-12
    np.testing.assert_allclose(torch.cat([g["y"] for g in got]).numpy(), y.detach().numpy(),
                               rtol=rtol, atol=1e-12)
    np.testing.assert_allclose(torch.cat([g["grad_x"] for g in got]).numpy(), x.grad.numpy(),
                               rtol=rtol, atol=1e-12)
    np.testing.assert_allclose((got[0]["grad_weight"] + got[1]["grad_weight"]).numpy(),
                               weight.grad.numpy(), rtol=rtol)
    for g in got:
        np.testing.assert_allclose(g["state"]["running_mean"].numpy(), rm.numpy(), rtol=rtol)
        np.testing.assert_allclose(g["state"]["running_var"].numpy(), rv.numpy(), rtol=rtol)


def test_two_rank_step_matches_jax_sharded_step(steps):
    tcfg = factory.stereospike(in_hw=HW, base_channels=8)
    jax.config.update("jax_enable_x64", True)
    try:
        jcfg = jax_factory.stereospike(in_hw=HW, base_channels=8)
        tx = jax_make_optimizer(LR)
        tree = params_to_jax(steps["inputs"]["snn_params"], tcfg)
        state = jax_create_train_state(jax.tree.map(jnp.asarray, tree), tx,
                                       jax.random.PRNGKey(1))
        mesh = jax_make_mesh((WORLD, 1), devices=jax.devices()[:WORLD])
        step = jax_sharded_step(jax_make_train_step(jcfg, JaxTotalLossConfig(), tx,
                                                    compute_dtype=jnp.float64),
                                mesh, spatial=False)
        batch = {k: jnp.asarray(v.numpy())
                 for k, v in steps["inputs"]["batches"]["snn_t1"].items()}
        state, m = step(state, jax_shard_batch(batch, mesh, spatial=False))
        want = (float(m["loss"]), float(m["mde"]))
        want_params = _leaves(jax.tree.map(np.asarray, state.params))
    finally:
        jax.config.update("jax_enable_x64", False)
    got = steps["ranks"][0]["snn_t1"]
    np.testing.assert_allclose([got["loss"], got["mde"]], want, rtol=1e-9)
    ours = _leaves(params_to_jax(got["params"], tcfg))
    assert ours.keys() == want_params.keys()
    for k in want_params:
        np.testing.assert_allclose(ours[k], want_params[k], rtol=1e-8, atol=1e-11, err_msg=k)


def test_two_rank_ann_step_matches_jax_sharded_step(steps):
    cfg = JaxAnnConfig(in_hw=HW, base_channels=8)
    tx = jax_make_optimizer(LR)
    params, bn = ann_params_to_jax(steps["inputs"]["ann_params"], steps["inputs"]["ann_bn"])
    state = jax_create_ann_state(jax.tree.map(jnp.asarray, params),
                                 jax.tree.map(jnp.asarray, bn), tx)
    mesh = jax_make_mesh((WORLD, 1), devices=jax.devices()[:WORLD])
    step = jax_sharded_ann_step(jax_make_ann_step(cfg, JaxTotalLossConfig(), tx), mesh)
    batch = {k: jnp.asarray(v.numpy()) for k, v in steps["inputs"]["batches"]["ann"].items()}
    state, m = step(state, jax_shard_batch(batch, mesh, spatial=False))
    got = steps["ranks"][0]["ann"]
    np.testing.assert_allclose([got["loss"], got["mde"]], [float(m["loss"]), float(m["mde"])],
                               rtol=1e-5)
    ours_p, ours_bn = ann_params_to_jax(got["params"], got["bn_state"])
    want_bn = _leaves(jax.tree.map(np.asarray, state.bn_state))
    for k, v in _leaves(ours_bn).items():
        np.testing.assert_allclose(v, want_bn[k], rtol=1e-5, atol=1e-7, err_msg=k)
    want_p = _leaves(jax.tree.map(np.asarray, state.params))
    ours_p = _leaves(ours_p)
    assert ours_p.keys() == want_p.keys()
    _ann_params_close({k: torch.from_numpy(np.array(v)) for k, v in ours_p.items()},
                      {k: torch.from_numpy(np.array(v)) for k, v in want_p.items()})


# ------------------------------------------------------------------ the loop
def _loop_cfg(workdir, name, **kw):
    """The flagship at 32×44 on the synthetic fixture: 38 depth frames give
    72 training samples, one epoch of 18 global steps of 2 × 2; written to
    ``<name>.json`` for the workers."""
    cfg = TrainConfig(in_hw=HW, batch_size=PER_RANK, epochs=1, seed=7, synth_frames=38,
                      synth_events=2000, augment=False, pack_io=False, prefetch=1,
                      tensorboard=False, learning_rate=1e-3,
                      checkpoint_dir=os.path.join(workdir, name))
    cfg = dataclasses.replace(cfg, **kw)
    with open(os.path.join(workdir, f"{name}.json"), "w") as f:
        f.write(cfg.to_json())
    return cfg


def _loop_out(workdir, name):
    out = []
    for rank in range(WORLD):
        with open(os.path.join(workdir, f"{name}_{rank}.json")) as f:
            summary = json.load(f)
        params = torch.load(os.path.join(workdir, f"{name}_{rank}.pt"), weights_only=True)
        out.append((summary, params))
    return out


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    """Two-process runs: ``equiv`` (no augmentation, a checkpoint directory
    per rank), ``full`` (augmentation and packed uploads, uninterrupted),
    ``cut`` (as ``full``, rank 1 sends itself SIGTERM after step 3) and
    ``resume`` (``cut`` resumed); and one process at twice the batch."""
    workdir = str(tmp_path_factory.mktemp("loops"))
    equiv = _loop_cfg(workdir, "equiv")
    aug = dict(augment=True, pack_io=True, prefetch=2)
    _loop_cfg(workdir, "full", **aug)
    cut = _loop_cfg(workdir, "cut", **aug)
    _loop_cfg(workdir, "resume", **aug, resume=True, checkpoint_dir=cut.checkpoint_dir)
    loop_args = ["--scenario", "loop", "--name"]
    _wait(_launch(workdir, [*loop_args, "equiv", "--own-dir"], "equiv")
          + _launch(workdir, [*loop_args, "full"], "full"))
    _run(workdir, [*loop_args, "cut"], "cut", extra={1: ["--sigterm-at", "3"]})
    with open(os.path.join(cut.checkpoint_dir, "checkpoint_meta.json")) as f:
        cut_meta = json.load(f)
    _run(workdir, [*loop_args, "resume"], "resume")
    single = train_loop(dataclasses.replace(equiv, batch_size=WORLD * PER_RANK,
                                            checkpoint_dir=os.path.join(workdir, "single")),
                        synthetic=True, return_state=True, device="cpu")
    yield {"equiv_cfg": equiv, "cut_meta": cut_meta,
            "single": single["state"],
           **{n: _loop_out(workdir, n) for n in ("equiv", "full", "cut", "resume")}}
    shutil.rmtree(workdir, ignore_errors=True)  # ~2 GB of flagship checkpoints


def test_two_process_train_loop_matches_one_process(loops):
    (s0, p0), (s1, p1) = loops["equiv"]
    single = loops["single"]
    assert s0 == s1 == {"step": 18, "epoch": 1, "preempted": False}
    assert single.step == 18
    for k, v in single.params.items():
        assert torch.equal(p0[k], p1[k]), k
        np.testing.assert_allclose(p0[k].numpy(), v.detach().numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=k)


def test_only_rank_zero_writes(loops):
    """Each rank of ``equiv`` was given a directory of its own: rank 0's
    holds the checkpoints and logs, rank 1's was never made."""
    base = loops["equiv_cfg"].checkpoint_dir
    for name in ("best.pt", "latest.pt", "checkpoint_meta.json", "training_metrics.jsonl",
                 "training_logs.txt"):
        assert os.path.exists(os.path.join(f"{base}_rank0", name)), name
    assert not os.path.exists(f"{base}_rank1")


def test_sigterm_on_one_rank_stops_both_and_resume_is_exact(loops):
    """Rank 1 alone gets SIGTERM after step 3; the flags meet at step 16
    (every 16 steps), where both ranks stop; rank 0 checkpoints there; the
    resumed run (augmentation draws included, each rank its own) ends
    where the uninterrupted one does, bit for bit."""
    cut = [s for s, _ in loops["cut"]]
    assert cut == [{"step": 16, "epoch": 0, "preempted": True}] * WORLD
    assert loops["cut_meta"]["step"] == 16 and loops["cut_meta"]["epoch_step_offset"] == 16
    for (rs, rp), (fs, fp) in zip(loops["resume"], loops["full"], strict=True):
        assert rs == fs == {"step": 18, "epoch": 1, "preempted": False}
        for k in fp:
            assert torch.equal(rp[k], fp[k]), k
    assert not all(torch.equal(loops["full"][0][1][k], loops["equiv"][0][1][k])
                   for k in loops["full"][0][1])  # augmentation changed the run


@pytest.mark.parametrize("model", ["stereospike", "ann_sigmoid"])
@pytest.mark.parametrize("shape,error", [((2, 2), NotImplementedError), ((3, 1), ValueError)])
def test_mesh_shape_refusals_under_world_two(model, shape, error, tmp_path, monkeypatch):
    """A spatial axis, or a data axis other than the world size, raises
    before any process group starts: through ``cli train`` and ``eval``,
    for the SNN and the ANN driver."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    flags = ["--synthetic", "--device", "cpu", "--in-hw", "32,44", "--model", model,
             "--mesh-shape", ",".join(map(str, shape)), "--checkpoint-dir", str(tmp_path)]
    for command in ("train", "eval"):
        with pytest.raises(error, match="mesh_shape"):
            cli.main([command, *flags])
    assert not torch.distributed.is_initialized()
