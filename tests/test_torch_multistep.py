"""The port's layer-major forward against the JAX package's, on the CPU.

``forward_multistep`` from a carried (non-zero) membrane state, for the
flagship (IF, ATan encoder and decoder, Sigmoid SEW; multiply factor 10 so
that every site fires at this size) and the PLIF "tempo" variant, at T=1
and T=3, against three JAX functions on the same JAX-initialised weights
and inputs:

- ``forward_multistep(use_pallas=False)``, the unrolled chain;
- ``forward_multistep(use_pallas=True, interpret=True)``, the Pallas kernels;
- ``forward_sequence``, the step-major scan.

Float64, so that no spike can flip at the threshold between the summation
orders: depths and the depth integrator to rtol 1e-9, spikes exactly, the
membranes to rtol 1e-9 (atol 1e-9 of the site's largest magnitude),
except against the Pallas kernels, which compute in float32 whatever their
I/O dtype: those membranes to rtol 1e-6 and atol 1e-6 of the site's
largest magnitude (a few float32 ulps over the T steps). Gradients with respect to the input and
every parameter, through a loss that also reads the final membranes (so
the fire's v_T gradient is exercised), against ``jax.grad`` of the
unrolled chain at rtol 1e-8 / atol 1e-10, as ``tests/test_torch_sequence.py``
holds them.

The train step at T=3 with ``multistep=True``: three float64 steps across
an LR milestone against the JAX ``make_train_step(multistep=True)``, plain
(flagship) and with a warmup chunk and seeded integrators (tempo), whose
warmup also runs layer-major: losses and MDE to rtol 1e-9, final
parameters to rtol 1e-8 / atol 1e-11, as ``tests/test_torch_train.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereospike_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from stereospike_tpu.models import factory as jax_factory
from stereospike_tpu.models.multistep import forward_multistep as jax_forward_multistep
from stereospike_tpu.models.stereospike import forward_sequence as jax_forward_sequence
from stereospike_tpu.models.stereospike import init_params as jax_init_params
from stereospike_tpu.objectives.losses import TotalLossConfig as JaxTotalLossConfig
from stereospike_tpu.train.config import TrainConfig as JaxTrainConfig
from stereospike_tpu.train.state import create_train_state as jax_create_train_state
from stereospike_tpu.train.state import make_optimizer as jax_make_optimizer
from stereospike_tpu.train.state import multistep_lr_schedule as jax_multistep_lr_schedule
from stereospike_tpu.train.steps import make_train_step as jax_make_train_step
from stereospike_tpu_torch.interop import params_from_jax, params_to_jax, state_from_jax
from stereospike_tpu_torch.interop import state_to_jax
from stereospike_tpu_torch.models import factory
from stereospike_tpu_torch.models.multistep import forward_multistep
from stereospike_tpu_torch.models.stereospike import SPIKING_SITES
from stereospike_tpu_torch.objectives.losses import TotalLossConfig
from stereospike_tpu_torch.snn.cuda_kernels import multistep_fire
from stereospike_tpu_torch.train.config import TrainConfig
from stereospike_tpu_torch.train.state import (
    create_train_state,
    make_optimizer,
    multistep_lr_schedule,
)
from stereospike_tpu_torch.train.steps import make_train_step
from test_torch_sequence import _leaves, _loss_jax, _loss_torch, x64  # noqa: F401

HW = (32, 44)
BASE = 8
# the flagship fires deep into the network at this size only with a larger
# multiply factor (as tests/test_multistep.py runs it); tempo's default is 10
CONFIG = {"stereospike": dict(multiply_factor=10.0), "stereospike_tempo": {}}


def configs(name):
    kw = dict(in_hw=HW, base_channels=BASE, **CONFIG[name])
    return getattr(jax_factory, name)(**kw), getattr(factory, name)(**kw)


@functools.lru_cache(maxsize=None)
def jax_params_np(name):
    """JAX-initialised parameters as numpy float64 leaves."""
    jcfg, _ = configs(name)
    return jax.tree.map(lambda a: np.asarray(a, np.float64),
                        jax_init_params(jax.random.PRNGKey(0), jcfg))


def frames_np(T, seed=1, batch=2):
    return np.random.default_rng(seed).poisson(0.4, (batch, T, *HW, 4)).astype(np.float64)


@functools.lru_cache(maxsize=None)
def carried_state_np(name):
    """A non-zero membrane state in the JAX layout: the state after one
    step of the JAX ``forward_sequence`` on another frame."""
    jcfg, _ = configs(name)
    _, _, st = jax.jit(lambda p, x: jax_forward_sequence(p, x, jcfg))(
        jax_params_np(name), frames_np(1, seed=2))
    return jax.tree.map(np.asarray, st)


def _jax_run(name, T, variant):
    jcfg, _ = configs(name)
    if variant == "sequence":
        fn = functools.partial(jax_forward_sequence, cfg=jcfg)
    else:
        fn = functools.partial(jax_forward_multistep, cfg=jcfg,
                               use_pallas=variant == "pallas", interpret=True)
    depths, spikes, state = jax.jit(lambda p, x, s: fn(p, x, state=s))(
        jax_params_np(name), frames_np(T), carried_state_np(name))
    return ([np.asarray(d) for d in depths], [np.asarray(s) for s in spikes],
            jax.tree.map(np.asarray, state))


@pytest.mark.parametrize("variant", ["unrolled", "pallas", "sequence"])
@pytest.mark.parametrize("name,T", [("stereospike", 1), ("stereospike", 3),
                                    ("stereospike_tempo", 1), ("stereospike_tempo", 3)])
def test_forward_multistep_matches_jax(name, T, variant, x64):
    _, tcfg = configs(name)
    depths_j, spikes_j, state_j = _jax_run(name, T, variant)
    params = params_from_jax(jax_params_np(name), tcfg, device="cpu")
    state0 = state_from_jax(carried_state_np(name), tcfg, device="cpu")
    depths, spikes, state = forward_multistep(params, torch.from_numpy(frames_np(T)), tcfg,
                                              state0)

    assert len(depths) == len(depths_j) == 4
    for d, dj in zip(depths, depths_j):
        assert d.dtype == torch.float64 and d.shape == dj.shape
        np.testing.assert_allclose(d.numpy(), dj, rtol=1e-9, atol=1e-12)
    # the JAX level-0 spikes are in the canonical layout already
    for s, sj in zip(spikes, spikes_j):
        np.testing.assert_array_equal(s.numpy(), sj)
    ours = state_to_jax(state, tcfg)
    assert ours.keys() == state_j.keys()
    for site, v in state_j.items():
        tol = 1e-6 if variant == "pallas" and site != "Ineurons" else 1e-9
        np.testing.assert_allclose(ours[site], v, rtol=tol, atol=tol * np.abs(v).max(),
                                   err_msg=site)
    # the decoder's spike tensors are not empty in the last step
    assert all(float(s.sum()) > 0 for s in spikes)


def _state_loss_torch(state):
    return 0.01 * sum((state[s] ** 2).sum() for s in SPIKING_SITES)


def _state_loss_jax(state):
    return 0.01 * sum(jnp.sum(state[s] ** 2) for s in SPIKING_SITES)


@pytest.mark.parametrize("name", ["stereospike", "stereospike_tempo"])
def test_forward_multistep_gradients_match_jax(name, x64):
    T = 3
    jcfg, tcfg = configs(name)
    frames = frames_np(T, seed=3)

    def loss_fn(p, x, s):
        depths, spikes, state = jax_forward_multistep(p, x, jcfg, s, use_pallas=False)
        return _loss_jax(depths, spikes) + _state_loss_jax(state)

    loss_j, (g_params, g_x) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(
        jax_params_np(name), frames, carried_state_np(name))

    params = {k: v.requires_grad_(True)
              for k, v in params_from_jax(jax_params_np(name), tcfg, device="cpu").items()}
    x = torch.from_numpy(frames).requires_grad_(True)
    state0 = state_from_jax(carried_state_np(name), tcfg, device="cpu")
    depths, spikes, state = forward_multistep(params, x, tcfg, state0)
    loss = _loss_torch(depths, spikes) + _state_loss_torch(state)
    loss.backward()

    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-9)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_x), rtol=1e-8, atol=1e-10)
    ours = _leaves(params_to_jax({k: v.grad for k, v in params.items()}, tcfg))
    theirs = _leaves(jax.tree.map(np.asarray, g_params))
    assert ours.keys() == theirs.keys()
    nonzero = {k for k in theirs if np.abs(theirs[k]).max() > 0}
    # all 21 of the flagship's tensors get a gradient; in the tempo variant
    # 11 of the 13 PLIF leaks (its sew*_b sites pass none back at this size)
    assert (nonzero == theirs.keys() if name == "stereospike"
            else sum(k.startswith("plif/") for k in nonzero) == 11), sorted(nonzero)
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-8, atol=1e-10, err_msg=k)


def test_forward_multistep_makes_one_fire_call_per_site():
    """13 fire calls per forward whatever T, each over [T, B·C·h·w] with the
    site's state as [B·C·h·w]; the guards of the fused fire hold."""
    _, tcfg = configs("stereospike")
    params = params_from_jax(jax_params_np("stereospike"), tcfg, device="cpu")
    calls = []

    def spy(x, v0, *args, **kwargs):
        calls.append((tuple(x.shape), tuple(v0.shape)))
        return multistep_fire(x, v0, *args, **kwargs)

    _, _, state = forward_multistep(params, torch.from_numpy(frames_np(5)), tcfg, fire_fn=spy)
    assert calls == [((5, state[s].numel()), (state[s].numel(),)) for s in SPIKING_SITES]
    # every reset mode goes through the same 13 calls
    for mode in (dict(detach_reset=False), dict(v_reset=0.5), dict(v_reset=None)):
        calls.clear()
        forward_multistep(params, torch.from_numpy(frames_np(1)),
                          dataclasses.replace(tcfg, **mode), fire_fn=spy)
        assert len(calls) == len(SPIKING_SITES), mode


LR = 2e-4
MILESTONES = (2,)  # the LR halves before the third step


def _jax_batches(n, T, with_warmup):
    out = []
    for i in range(n):
        b = jax_synthetic_batch(jax.random.PRNGKey(20 + i), batch=2, in_hw=HW, T=T,
                                dtype=jnp.float64)
        if with_warmup:
            w = jax_synthetic_batch(jax.random.PRNGKey(200 + i), batch=2, in_hw=HW, T=2,
                                    dtype=jnp.float64)
            b = {**b, "warmup": w["chunks"], "init_pots": w["gt"]}
        out.append({k: np.array(v) for k, v in b.items()})  # writable copies for torch
    return out


@pytest.mark.parametrize("name,case", [("stereospike", "plain"),
                                       ("stereospike_tempo", "warmup_init_pots")])
def test_multistep_train_steps_match_jax(name, case, x64):
    """Three layer-major steps of forward → total loss → BPTT → Adam at
    T=3, the LR halving before the last, against the JAX step."""
    jcfg, tcfg = configs(name)
    kw = dict(multistep=True)
    if case != "plain":
        kw.update(use_warmup=True, use_init_pots=True)
    batches = _jax_batches(3, 3, case != "plain")

    jtx = jax_make_optimizer(jax_multistep_lr_schedule(LR, MILESTONES, 0.5, 1))
    jstate = jax_create_train_state(jax.tree.map(jnp.asarray, jax_params_np(name)), jtx,
                                    jax.random.PRNGKey(1))
    jstep = jax.jit(jax_make_train_step(jcfg, JaxTotalLossConfig(), jtx,
                                        compute_dtype=jnp.float64, **kw))
    jax_metrics = []
    for b in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jax_metrics.append((float(m["loss"]), float(m["mde"])))

    tx = make_optimizer(multistep_lr_schedule(LR, MILESTONES, 0.5, 1))
    state = create_train_state(params_from_jax(jax_params_np(name), tcfg, device="cpu"), tx,
                               torch.Generator().manual_seed(1))
    step = make_train_step(tcfg, TotalLossConfig(), tx, compute_dtype=torch.float64, **kw)
    ours = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        ours.append((float(m["loss"]), float(m["mde"])))

    assert state.step == 3
    np.testing.assert_allclose(ours, jax_metrics, rtol=1e-9)
    final = _leaves(params_to_jax(state.params, tcfg))
    theirs = _leaves(jax.tree.map(np.asarray, jstate.params))
    assert final.keys() == theirs.keys()
    for k in theirs:
        np.testing.assert_allclose(final[k], theirs[k], rtol=1e-8, atol=1e-11, err_msg=k)


def test_multistep_config_field_matches_jax():
    assert TrainConfig().multistep is JaxTrainConfig().multistep is False
    assert TrainConfig().n_timesteps == JaxTrainConfig().n_timesteps
