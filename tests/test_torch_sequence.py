"""The port's ``forward_sequence`` and its gradients against the JAX
package's, on the CPU.

At T=1 the flagship (IF, ATan encoder and decoder, Sigmoid SEW) and at T=3
the PLIF "tempo" variant, whose leak gradients flow through ``sigmoid(w)``
and whose membranes carry across steps: depths, the loss of
``tests/test_full_model_oracle.py``, and its gradients with respect to the
input and every parameter, through the fire's autograd Function (its plain
backward on the CPU). Float64, so that no spike can flip at the threshold
between the two summation orders: values to rtol 1e-9, gradients to rtol
1e-8 / atol 1e-10, as that oracle holds them.

The JAX side runs its default execution knobs (s2d level 0 and the rest);
the port computes the canonical composite, the same function up to
reassociation.
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
from stereospike_tpu_torch.interop import params_from_jax, params_to_jax
from stereospike_tpu_torch.models import factory
from stereospike_tpu_torch.models.stereospike import forward_sequence, init_params

HW = (48, 64)
BASE = 8  # narrow widths: the JAX compile, not the width, is what the test needs


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _configs(name, **kw):
    kw = dict(in_hw=HW, **{"base_channels": BASE, **kw})
    return getattr(jax_factory, name)(**kw), getattr(factory, name)(**kw)


@functools.lru_cache(maxsize=None)
def _jax_params_np(name):
    """JAX-initialised parameters as numpy float64 leaves. The flagship's
    conv weights are scaled by 4 (exactly, at float64): at the torch-default
    init its spikes die out before the bottleneck at this size, and only 7
    of its 21 tensors would get a gradient; scaled, every site fires and
    all 21 do."""
    jcfg, _ = _configs(name)
    scale = 4.0 if name == "stereospike" else 1.0
    tree = jax_init_params(jax.random.PRNGKey(0), jcfg)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a, np.float64) * (scale if path[-1].key == "w" else 1.0),
        tree)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {f"{prefix}{k}": np.asarray(v)})
    return out


def _loss_torch(depths, spikes):
    loss = sum((i + 1) * (d ** 2).sum() for i, d in enumerate(depths))
    return loss + 0.1 * sum((s * s).sum() for s in spikes)


def _loss_jax(depths, spikes):
    loss = sum((i + 1) * jnp.sum(d ** 2) for i, d in enumerate(depths))
    return loss + 0.1 * sum(jnp.sum(s * s) for s in spikes)


@pytest.mark.parametrize("name,T", [("stereospike", 1), ("stereospike_tempo", 3)])
def test_forward_sequence_gradients_match_jax(name, T, x64):
    jcfg, tcfg = _configs(name)
    jp = _jax_params_np(name)
    frames = np.random.default_rng(1).poisson(0.4, (2, T, *HW, 4)).astype(np.float64)

    def loss_fn(p, x):
        depths, spikes, _ = jax_forward_sequence(p, x, jcfg)
        return _loss_jax(depths, spikes), depths

    (loss_j, depths_j), (g_params, g_x) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(jax.tree.map(jnp.asarray, jp),
                                               jnp.asarray(frames))

    params = {k: v.requires_grad_(True) for k, v in params_from_jax(jp, tcfg).items()}
    x = torch.from_numpy(frames).requires_grad_(True)
    depths, spikes, _ = forward_sequence(params, x, tcfg)
    loss = _loss_torch(depths, spikes)
    loss.backward()

    for d_t, d_j in zip(depths, depths_j):
        np.testing.assert_allclose(d_t.detach().numpy(), np.asarray(d_j), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-9)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_x), rtol=1e-8, atol=1e-10)
    ours = _leaves(params_to_jax({k: v.grad for k, v in params.items()}, tcfg))
    theirs = _leaves(jax.tree.map(np.asarray, g_params))
    assert ours.keys() == theirs.keys()
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-8, atol=1e-10, err_msg=k)
    if name == "stereospike_tempo":
        assert sum(k.startswith("plif/") for k in ours) == 13


def test_remat_recomputes_the_same_gradients():
    """``remat=True`` recomputes steps 0..T-2 in the backward pass and
    gives exactly the gradients of the plain run."""
    _, tcfg = _configs("stereospike_tempo", base_channels=4)
    frames = torch.from_numpy(
        np.random.default_rng(2).poisson(0.4, (1, 3, *HW, 4)).astype(np.float64))
    grads = []
    for remat in (False, True):
        params = {k: v.double().requires_grad_(True) for k, v in
                  init_params(torch.Generator().manual_seed(0), tcfg, device="cpu").items()}
        depths, spikes, _ = forward_sequence(params, frames, tcfg, remat=remat)
        _loss_torch(depths, spikes).backward()
        grads.append({k: v.grad for k, v in params.items()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=0, atol=0)
