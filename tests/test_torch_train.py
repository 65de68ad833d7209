"""The port's train step against the JAX package's, on the CPU.

- The train step, three steps across an LR milestone, at float64, from the
  same JAX-initialised weights on the same JAX-made synthetic batches:
  per-step losses and MDE to rtol 1e-9, final parameters to rtol 1e-8 and
  atol 1e-11 (``tests/test_trajectory_oracle.py``'s tolerances); also with
  ``accum_steps=2`` together with a warmup chunk, seeded integrators and
  weight decay.
  Float64, so that no spike can flip at the threshold between the two
  summation orders.
- A bf16 step keeps fp32 master parameters and gradients.

The weights and configurations are those of ``tests/test_torch_sequence.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereospike_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from stereospike_tpu.objectives.losses import TotalLossConfig as JaxTotalLossConfig
from stereospike_tpu.train.state import create_train_state as jax_create_train_state
from stereospike_tpu.train.state import make_optimizer as jax_make_optimizer
from stereospike_tpu.train.state import multistep_lr_schedule as jax_multistep_lr_schedule
from stereospike_tpu.train.steps import make_train_step as jax_make_train_step
from stereospike_tpu_torch.interop import params_from_jax, params_to_jax
from stereospike_tpu_torch.models.stereospike import init_params
from stereospike_tpu_torch.objectives.losses import TotalLossConfig
from stereospike_tpu_torch.train.config import TrainConfig
from stereospike_tpu_torch.train.loop import _loss_config
from stereospike_tpu_torch.train.state import (
    create_train_state,
    make_optimizer,
    multistep_lr_schedule,
)
from stereospike_tpu_torch.train.steps import make_train_step
from test_torch_sequence import HW, _configs, _jax_params_np, _leaves, x64  # noqa: F401

LR = 2e-4
MILESTONES = (2,)  # the LR halves before the third step


def _jax_batches(n, with_warmup, dtype=jnp.float64):
    out = []
    for i in range(n):
        b = jax_synthetic_batch(jax.random.PRNGKey(10 + i), batch=2, in_hw=HW, dtype=dtype)
        if with_warmup:
            w = jax_synthetic_batch(jax.random.PRNGKey(100 + i), batch=2, in_hw=HW,
                                    dtype=dtype)
            b = {**b, "warmup": w["chunks"], "init_pots": w["gt"]}
        out.append({k: np.array(v) for k, v in b.items()})  # writable copies for torch
    return out


@pytest.mark.parametrize("case", ["plain", "accum2_warmup_init_pots_decay"])
def test_train_steps_match_jax(case, x64):
    """Three steps of forward → total loss → BPTT → Adam, the LR halving
    before the last, against the JAX ``make_train_step``."""
    name = "stereospike"
    jcfg, tcfg = _configs(name)
    kw = {} if case == "plain" else dict(accum_steps=2, use_warmup=True, use_init_pots=True)
    wd = 0.0 if case == "plain" else 1e-3
    batches = _jax_batches(3, case != "plain")

    jtx = jax_make_optimizer(jax_multistep_lr_schedule(LR, MILESTONES, 0.5, 1), wd)
    jstate = jax_create_train_state(jax.tree.map(jnp.asarray, _jax_params_np(name)), jtx,
                                    jax.random.PRNGKey(1))
    jstep = jax.jit(jax_make_train_step(jcfg, JaxTotalLossConfig(), jtx,
                                        compute_dtype=jnp.float64, **kw))
    jax_metrics = []
    for b in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jax_metrics.append((float(m["loss"]), float(m["mde"])))

    tx = make_optimizer(multistep_lr_schedule(LR, MILESTONES, 0.5, 1), wd)
    state = create_train_state(params_from_jax(_jax_params_np(name), tcfg, device="cpu"), tx,
                               torch.Generator().manual_seed(1))
    step = make_train_step(tcfg, TotalLossConfig(), tx, compute_dtype=torch.float64, **kw)
    ours = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        ours.append((float(m["loss"]), float(m["mde"])))

    assert state.step == 3 and tx.lr(2) == LR / 2
    np.testing.assert_allclose(ours, jax_metrics, rtol=1e-9)
    final = _leaves(params_to_jax(state.params, tcfg))
    theirs = _leaves(jax.tree.map(np.asarray, jstate.params))
    assert final.keys() == theirs.keys()
    for k in theirs:
        np.testing.assert_allclose(final[k], theirs[k], rtol=1e-8, atol=1e-11, err_msg=k)


def test_bf16_step_keeps_fp32_master():
    """bf16 compute: the forward runs in bf16, the master parameters, their
    gradients and Adam's moments stay fp32, and the loss is close to the
    fp32 step's on the same batch."""
    _, tcfg = _configs("stereospike", base_channels=8)
    params = init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _jax_batches(1, False, jnp.float32)[0].items()}
    tx = make_optimizer(LR)
    losses = {}
    for dtype in (torch.float32, torch.bfloat16):
        state = create_train_state(params, tx, torch.Generator().manual_seed(1))
        step = make_train_step(tcfg, TotalLossConfig(), tx, compute_dtype=dtype)
        state, m = step(state, batch)
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                   for p in state.params.values())
        assert all(v.dtype == torch.float32 for s in state.optimizer.state.values()
                   for v in s.values() if v.is_floating_point() and v.dim() > 0)
        assert m["loss"].dtype == torch.float32 and torch.isfinite(m["loss"])
        assert any(not torch.equal(state.params[k], params[k]) for k in params)
        losses[dtype] = float(m["loss"])
    assert losses[torch.bfloat16] == pytest.approx(losses[torch.float32], rel=2e-2)


def test_synthetic_stream_is_deterministic_in_its_seed():
    from stereospike_tpu_torch.data.synthetic import synthetic_stream

    kw = dict(batch=1, in_hw=(16, 22), device="cpu")
    a, b = list(synthetic_stream(3, 2, **kw)), list(synthetic_stream(3, 2, **kw))
    c = next(synthetic_stream(4, 1, **kw))
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert not torch.equal(a[0]["chunks"], a[1]["chunks"])
    assert not torch.equal(a[0]["chunks"], c["chunks"])
    assert a[0]["chunks"].shape == (1, 1, 16, 22, 4) and a[0]["mask"].dtype == torch.bool
    assert float(a[0]["gt"][a[0]["mask"]].min()) >= 1.0
    assert not a[0]["gt"][~a[0]["mask"]].any()


def test_config_fields_and_schedule_match_jax():
    """The TrainConfig fields the step reads keep the JAX names and
    defaults; the loss config and the LR schedule are built alike."""
    import dataclasses

    from stereospike_tpu.train.config import TrainConfig as JaxTrainConfig
    from stereospike_tpu.train.loop import _loss_config as jax_loss_config

    ours = dataclasses.asdict(TrainConfig())
    theirs = dataclasses.asdict(JaxTrainConfig())
    for field in ("batch_size", "learn_on", "learning_rate", "weight_decay", "lr_milestones",
                  "lr_gamma", "loss_alpha", "scale_weights", "penalize_spikes", "loss_beta",
                  "accum_steps", "use_warmup", "use_init_pots"):
        assert ours[field] == theirs[field], field
    cfg = TrainConfig(loss_alpha=0.3, penalize_spikes=True, loss_beta=0.25)
    jcfg = JaxTrainConfig(loss_alpha=0.3, penalize_spikes=True, loss_beta=0.25)
    assert dataclasses.asdict(_loss_config(cfg)) == dataclasses.asdict(jax_loss_config(jcfg))
    ours_lr = multistep_lr_schedule(2e-4, (8, 42, 60), 0.5, steps_per_epoch=7)
    theirs_lr = jax_multistep_lr_schedule(2e-4, (8, 42, 60), 0.5, steps_per_epoch=7)
    for s in (0, 55, 56, 57, 293, 294, 419, 420, 1000):
        assert ours_lr(s) == pytest.approx(float(theirs_lr(s)), rel=1e-7), s
