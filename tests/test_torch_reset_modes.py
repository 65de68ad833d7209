"""Every reset mode of the fused fire against the JAX package's cells, on
the CPU.

The JAX fused kernel refuses these modes (``models/multistep.py``,
``use_pallas=True``), so the reference is its unrolled cells
(``snn/neurons.py``): ``forward_sequence``, which runs them step by step.

- The port's ``forward_sequence`` and ``forward_multistep`` against the
  JAX ``forward_sequence`` at float64, for {IF, PLIF} × {soft reset, hard
  reset to 0.3} × ``detach_reset`` ∈ {True, False}, at T=2 from a zero
  state: spikes exactly, depths and membranes to rtol 1e-9, the gradients
  of a loss that reads depths, spikes and final membranes, with respect to
  the input and every parameter, to rtol 1e-8 (atol 1e-10).
- The plain fire's backward against ``jax.vjp`` of a T-loop of the JAX
  cells at float64, for IF, LIF and PLIF in every mode, ATan and Sigmoid:
  gx, gv0 and the PLIF leak gradient to rtol 1e-9.
- On the card (``tests/test_torch_fire_backward.py``, which needs no JAX):
  both kernels against their plain versions in these modes.

Float64, so that no spike can flip at the threshold between the two
summation orders.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereospike_tpu.models import factory as jax_factory
from stereospike_tpu.models.stereospike import forward_sequence as jax_forward_sequence
from stereospike_tpu.models.stereospike import init_params as jax_init_params
from stereospike_tpu.snn import neurons as jax_neurons
from stereospike_tpu.snn import surrogate as jax_surrogate
from stereospike_tpu_torch.interop import params_from_jax, params_to_jax, state_to_jax
from stereospike_tpu_torch.models import factory
from stereospike_tpu_torch.models.multistep import forward_multistep
from stereospike_tpu_torch.models.stereospike import forward_sequence
from stereospike_tpu_torch.snn.cuda_kernels import (
    multistep_fire,
    multistep_fire_backward,
    multistep_fire_backward_reference,
)
from test_torch_sequence import _leaves, _loss_jax, _loss_torch, x64  # noqa: F401

HW = (32, 44)
BASE = 4
T = 2
# {IF, PLIF}: the flagship with a multiply factor of 10 (so that every site
# fires at this size) and the PLIF "tempo" variant
MODELS = {"if": ("stereospike", dict(multiply_factor=10.0)), "plif": ("stereospike_tempo", {})}
RESETS = {"soft": None, "hard0.3": 0.3}


def _configs(neuron, reset, detach):
    name, kw = MODELS[neuron]
    kw = dict(in_hw=HW, base_channels=BASE, v_reset=RESETS[reset], detach_reset=detach, **kw)
    return getattr(jax_factory, name)(**kw), getattr(factory, name)(**kw)


@functools.lru_cache(maxsize=None)
def _jax_params_np(neuron):
    jcfg, _ = _configs(neuron, "soft", True)
    return jax.tree.map(lambda a: np.asarray(a, np.float64),
                        jax_init_params(jax.random.PRNGKey(3), jcfg))


def _state_loss_torch(state):
    return sum(0.01 * (v * v).sum() for k, v in sorted(state.items()) if k != "Ineurons")


def _state_loss_jax(state):
    return sum(0.01 * jnp.sum(v * v) for k, v in sorted(state.items()) if k != "Ineurons")


@pytest.mark.parametrize("detach", [True, False], ids=["detached", "undetached"])
@pytest.mark.parametrize("reset", list(RESETS))
@pytest.mark.parametrize("neuron", list(MODELS))
def test_forward_and_gradients_match_jax_cells(neuron, reset, detach, x64):
    jcfg, tcfg = _configs(neuron, reset, detach)
    jp = _jax_params_np(neuron)
    frames = np.random.default_rng(4).poisson(0.5, (2, T, *HW, 4)).astype(np.float64)

    def loss_fn(p, x):
        depths, spikes, state = jax_forward_sequence(p, x, jcfg)
        return _loss_jax(depths, spikes) + _state_loss_jax(state), (depths, spikes, state)

    (loss_j, (depths_j, spikes_j, state_j)), (g_params, g_x) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(jax.tree.map(jnp.asarray, jp),
                                               jnp.asarray(frames))
    assert sum(float(jnp.sum(s)) for s in spikes_j) > 0

    theirs = _leaves(jax.tree.map(np.asarray, g_params))
    for run in (forward_sequence, forward_multistep):
        params = {k: v.requires_grad_(True)
                  for k, v in params_from_jax(jp, tcfg, device="cpu").items()}
        x = torch.from_numpy(frames).requires_grad_(True)
        depths, spikes, state = run(params, x, tcfg)
        loss = _loss_torch(depths, spikes) + _state_loss_torch(state)
        loss.backward()
        where = run.__name__
        for d_t, d_j in zip(depths, depths_j):
            np.testing.assert_allclose(d_t.detach().numpy(), np.asarray(d_j), rtol=1e-9,
                                       atol=1e-9, err_msg=where)
        for s_t, s_j in zip(spikes, spikes_j):
            np.testing.assert_array_equal(s_t.detach().numpy(), np.asarray(s_j), err_msg=where)
        ours_state = state_to_jax(state, tcfg)
        for site, v in state_j.items():
            np.testing.assert_allclose(ours_state[site], np.asarray(v), rtol=1e-9, atol=1e-9,
                                       err_msg=f"{where} {site}")
        np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-9, err_msg=where)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_x), rtol=1e-8, atol=1e-10,
                                   err_msg=where)
        ours = _leaves(params_to_jax({k: v.grad for k, v in params.items()}, tcfg))
        assert ours.keys() == theirs.keys()
        for k in theirs:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-8, atol=1e-10,
                                       err_msg=f"{where} {k}")


LEAK = 0.4


def _jax_cell_grads(x, v0, gs, gvT, kind, v_reset, detach, name):
    spike_fn = jax_surrogate.make_spike_fn(name)
    w0 = jnp.asarray(-np.log(1.0 / LEAK - 1.0))

    def f(xx, vv, w):
        v, spikes = vv, []
        for t in range(xx.shape[0]):
            kw = dict(v_reset=v_reset, spike_fn=spike_fn, detach_reset=detach)
            if kind == "if":
                v, s = jax_neurons.if_step(v, xx[t], **kw)
            elif kind == "lif":
                v, s = jax_neurons.lif_step(v, xx[t], tau=1.0 / LEAK, **kw)
            else:
                v, s = jax_neurons.plif_step(v, xx[t], w, **kw)
            spikes.append(s)
        return jnp.stack(spikes), v

    (spikes, v_t), vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(v0), w0)
    gx, gv0, gw = vjp((jnp.asarray(gs), jnp.asarray(gvT)))
    # sigmoid'(w) = leak·(1 - leak): the leak's own gradient
    return (np.asarray(spikes), np.asarray(v_t), np.asarray(gx), np.asarray(gv0),
            float(gw) / (LEAK * (1.0 - LEAK)))


@pytest.mark.parametrize("name", ["atan", "sigmoid"])
@pytest.mark.parametrize("detach", [True, False], ids=["detached", "undetached"])
@pytest.mark.parametrize("reset", list(RESETS))
@pytest.mark.parametrize("kind", ["if", "lif", "plif"])
def test_plain_fire_backward_matches_jax_autodiff(kind, reset, detach, name, x64):
    rng = np.random.default_rng(6)
    steps, m = 4, 300
    x = rng.normal(0.7, 0.6, (steps, m)) / (1.0 if kind == "if" else LEAK)
    v0 = rng.uniform(0.0, 0.6, m)
    gs, gvT = rng.normal(size=(steps, m)), rng.normal(size=m)
    v_reset = RESETS[reset]
    leak = None if kind == "if" else torch.tensor(LEAK, dtype=torch.float64)
    args = (torch.from_numpy(x), torch.from_numpy(v0), leak, torch.from_numpy(gs),
            torch.from_numpy(gvT), 1.0, v_reset, kind == "if", name, None, kind == "plif")
    gx, gv0, gl = multistep_fire_backward_reference(*args, detach_reset=detach)
    # on the CPU the wrapper takes the plain version
    wx, wv0, wl = multistep_fire_backward(*args, detach_reset=detach)
    assert torch.equal(gx, wx) and torch.equal(gv0, wv0) and (gl is None or torch.equal(gl, wl))
    spikes_j, v_j, jx, jv0, jl = _jax_cell_grads(x, v0, gs, gvT, kind, v_reset, detach, name)
    np.testing.assert_allclose(gx.numpy(), jx, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(gv0.numpy(), jv0, rtol=1e-9, atol=1e-12)
    if kind == "plif":
        np.testing.assert_allclose(float(gl), jl, rtol=1e-9)
    # and the forward: spikes and v_T of the same cells
    s, v = multistep_fire(torch.from_numpy(x), torch.from_numpy(v0), leak, 1.0, v_reset,
                          kind == "if", name)
    np.testing.assert_array_equal(s.numpy(), spikes_j)
    np.testing.assert_allclose(v.numpy(), v_j, rtol=1e-12, atol=1e-14)
