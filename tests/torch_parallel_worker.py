"""One rank of a data-parallel run of the PyTorch port on the CPU (gloo),
started by ``tests/test_torch_parallel.py``; it imports no JAX.

    python tests/torch_parallel_worker.py --scenario steps --workdir D

The launch comes from the environment, as ``python -m
torch.distributed.run`` sets it (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``). Scenarios:

- ``steps``: one optimizer step per case of ``D/inputs.pt`` (weights and
  a global batch each, written by the test) through
  ``make_sharded_train_step`` / ``make_sharded_ann_train_step`` (the ANN
  at float32 and float64), the global BatchNorm alone at float64, and the
  flagship's and the ANN's eval steps through ``make_sharded_eval_step``
  / ``make_sharded_ann_eval_step``; writes ``D/steps_<rank>.pt`` (loss,
  MDE, summed gradients, parameters after the step, BN statistics, the
  step's all-reduce calls; the eval steps' outputs).
- ``loop``: ``train_loop`` on the synthetic fixture with the config in
  ``D/<name>.json``; ``--own-dir`` gives each rank a checkpoint directory
  of its own (to show which rank writes), ``--sigterm-at N`` makes this
  rank send itself SIGTERM after step N; writes ``D/<name>_<rank>.pt``
  (the final parameters) and ``D/<name>_<rank>.json``.
"""

import argparse
import dataclasses
import json
import os
import signal
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stereospike_tpu_torch.models import factory  # noqa: E402
from stereospike_tpu_torch.models.ann import AnnConfig  # noqa: E402
from stereospike_tpu_torch.nn.blocks import batchnorm_apply  # noqa: E402
from stereospike_tpu_torch.objectives.losses import TotalLossConfig  # noqa: E402
from stereospike_tpu_torch.parallel import (  # noqa: E402
    make_mesh,
    make_sharded_ann_eval_step,
    make_sharded_ann_train_step,
    make_sharded_eval_step,
    make_sharded_train_step,
    shard_batch,
)
from stereospike_tpu_torch.train.ann_steps import (  # noqa: E402
    create_ann_train_state,
    make_ann_eval_step,
    make_ann_train_step,
)
from stereospike_tpu_torch.train.config import TrainConfig  # noqa: E402
from stereospike_tpu_torch.train.state import create_train_state, make_optimizer  # noqa: E402
from stereospike_tpu_torch.train.steps import make_eval_step, make_train_step  # noqa: E402

LR = 1e-3
# case → (make_train_step keywords, T); every SNN case runs at float64
SNN_CASES = {
    "snn_t1": ({}, 1),
    "snn_layer_major": ({"multistep": True}, 2),
    "snn_accum2": ({"accum_steps": 2}, 1),
}


def snn_step(case: str, params, hw, group=None):
    """The float64 step of the flagship at base 8 for ``case``, and a
    fresh train state from ``params``: ``(step, state)``."""
    kw, _ = SNN_CASES[case]
    cfg = factory.stereospike(in_hw=hw, base_channels=8)
    tx = make_optimizer(LR)
    state = create_train_state(params, tx, torch.Generator().manual_seed(1))
    step = make_train_step(cfg, TotalLossConfig(), tx, compute_dtype=torch.float64,
                           group=group, **kw)
    return step, state


def ann_step(params, bn_state, hw, group=None):
    """The equivalent ANN's step at base 8 and a fresh state: ``(step, state)``."""
    cfg = AnnConfig(in_hw=hw, base_channels=8)
    tx = make_optimizer(LR)
    state = create_ann_train_state(params, bn_state, tx)
    return make_ann_train_step(cfg, TotalLossConfig(), tx, group=group), state


def eval_steps(hw):
    """The flagship's float64 eval step and the ANN's: ``(snn, ann)``."""
    cfg = factory.stereospike(in_hw=hw, base_channels=8)
    return (make_eval_step(cfg, TotalLossConfig(), compute_dtype=torch.float64),
            make_ann_eval_step(AnnConfig(in_hw=hw, base_channels=8), TotalLossConfig()))


def _record(state, metrics):
    return {"loss": float(metrics["loss"]), "mde": float(metrics["mde"]),
            "grads": {k: p.grad.detach().clone() for k, p in state.params.items()},
            "params": {k: p.detach().clone() for k, p in state.params.items()},
            "bn_state": {k: v.clone() for k, v in getattr(state, "bn_state", {}).items()}}


def _counting_all_reduces(fn):
    """``(fn(), n)``: n the calls of ``torch.distributed.all_reduce`` that
    ``fn`` made (forward and backward)."""
    inner, calls = torch.distributed.all_reduce, []

    def counted(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    torch.distributed.all_reduce = counted
    try:
        return fn(), len(calls)
    finally:
        torch.distributed.all_reduce = inner


def run_steps(workdir: str) -> None:
    mesh = make_mesh(device="cpu")
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=True)
    hw = tuple(inp["hw"])
    out = {}
    for case in SNN_CASES:
        step, state = snn_step(case, inp["snn_params"], hw, mesh.group)
        (state, m), n = _counting_all_reduces(
            lambda: make_sharded_train_step(step, mesh)(state, inp["batches"][case]))
        out[case] = {**_record(state, m), "all_reduces": n}
    for case, dtype in (("ann", torch.float32), ("ann64", torch.float64)):
        params = {k: v.to(dtype) for k, v in inp["ann_params"].items()}
        bn_state = {k: v.to(dtype) for k, v in inp["ann_bn"].items()}
        step, state = ann_step(params, bn_state, hw, mesh.group)
        (state, m), n = _counting_all_reduces(
            lambda: make_sharded_ann_train_step(step, mesh)(state, inp["batches"][case]))
        out[case] = {**_record(state, m), "all_reduces": n}

    snn_eval, ann_eval = eval_steps(hw)
    out["snn_eval"] = make_sharded_eval_step(snn_eval, mesh)(inp["snn_params"],
                                                             inp["batches"]["snn_t1"])
    out["ann_eval"] = make_sharded_ann_eval_step(ann_eval, mesh)(
        {k: v.double() for k, v in inp["ann_params"].items()},
        {k: v.double() for k, v in inp["ann_bn"].items()}, inp["batches"]["ann64"])

    bn = inp["bn"]
    weight = bn["weight"].clone().requires_grad_(True)
    x = shard_batch({"x": bn["x"]}, mesh)["x"].clone().requires_grad_(True)
    y, new_state = batchnorm_apply({"weight": weight, "bias": bn["bias"]}, x,
                                   state=bn["state"], train=True, group=mesh.group)
    (y * shard_batch({"w": bn["probe"]}, mesh)["w"]).sum().backward()
    out["bn64"] = {"y": y.detach(), "state": new_state, "grad_x": x.grad,
                   "grad_weight": weight.grad}
    torch.save(out, os.path.join(workdir, f"steps_{mesh.rank}.pt"))


def run_loop(workdir: str, name: str, own_dir: bool, sigterm_at: int) -> None:
    from stereospike_tpu_torch.train.loop import train_loop

    rank = int(os.environ["RANK"])
    with open(os.path.join(workdir, f"{name}.json")) as f:
        cfg = TrainConfig.from_json(f.read())
    if own_dir:
        cfg = dataclasses.replace(cfg, checkpoint_dir=f"{cfg.checkpoint_dir}_rank{rank}")

    def on_step(step: int) -> None:
        if step == sigterm_at:
            os.kill(os.getpid(), signal.SIGTERM)

    summary = train_loop(cfg, synthetic=True, return_state=True, device="cpu",
                         on_step=on_step if sigterm_at else None)
    state = summary.pop("state")
    torch.save({k: p.detach() for k, p in state.params.items()},
               os.path.join(workdir, f"{name}_{rank}.pt"))
    with open(os.path.join(workdir, f"{name}_{rank}.json"), "w") as f:
        json.dump({"step": state.step, "epoch": state.epoch,
                   "preempted": bool(summary.get("preempted", False))}, f)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--scenario", choices=("steps", "loop"), required=True)
    p.add_argument("--workdir", required=True)
    p.add_argument("--name", default="loop")
    p.add_argument("--own-dir", action="store_true")
    p.add_argument("--sigterm-at", type=int, default=0)
    a = p.parse_args()
    torch.set_num_threads(2)
    if a.scenario == "steps":
        run_steps(a.workdir)
    else:
        run_loop(a.workdir, a.name, a.own_dir, a.sigterm_at)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
