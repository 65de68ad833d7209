"""The PyTorch port's StereoSpike forward against the JAX package's.

Same JAX-initialised weights (moved over by ``interop.params_from_jax``),
same numpy frames, three stateful windows, everything in float64 so that
no spike can flip at the threshold between the two summation orders: the
depths agree to rtol 1e-9 and so does the final membrane state (compared
in the JAX layout through ``state_to_jax``, level 0 in s2d).

The JAX side runs ``cfg.for_inference()`` with its default execution knobs
(s2d level 0, phase-stacked upsample-convs); the port computes the
canonical composite, which is the same function up to reassociation.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereospike_tpu.models import factory as jax_factory
from stereospike_tpu.models.stereospike import forward as jax_forward
from stereospike_tpu.models.stereospike import init_params as jax_init_params
from stereospike_tpu.models.stereospike import init_state as jax_init_state
from stereospike_tpu_torch.interop import params_from_jax, state_from_jax, state_to_jax
from stereospike_tpu_torch.models import factory
from stereospike_tpu_torch.models.stereospike import forward, init_params, init_state
from stereospike_tpu_torch.snn import cuda_kernels

HW = (32, 44)
BASE = 8
VARIANTS = ("stereospike", "stereospike_tempo", "stereospike_monocular",
            "stereospike_noskip", "stereospike_cutpredict")


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _configs(name):
    kw = dict(in_hw=HW, base_channels=BASE)
    return getattr(jax_factory, name)(**kw), getattr(factory, name)(**kw)


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    """JAX-initialised parameters as numpy (float32), one draw per variant."""
    return jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0), _configs(name)[0]))


@pytest.mark.parametrize("name", VARIANTS)
def test_factory_configs_match(name):
    jcfg, tcfg = _configs(name)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert jcfg.sizes == tcfg.sizes and jcfg.channels == tcfg.channels
    assert dataclasses.asdict(jcfg.for_inference()) == dataclasses.asdict(tcfg.for_inference())


@pytest.mark.parametrize("name", ["stereospike", "stereospike_tempo"])
def test_init_params_and_state_match_jax_layout(name):
    """Same keys and shapes as the JAX tree brought over by interop; the
    torch-default init bound U(-1/sqrt(fan_in), +) holds; PLIF leaks start
    at sigmoid(w) = 1/tau."""
    jcfg, tcfg = _configs(name)
    ours = init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    theirs = params_from_jax(_jax_params(name), tcfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in theirs.items()}
    for k, v in ours.items():
        if k.endswith(".weight"):
            bound = 1.0 / np.sqrt(v[0].numel())
            assert float(v.abs().max()) <= bound
        if k.endswith(".w"):
            np.testing.assert_allclose(float(torch.sigmoid(v)), 1.0 / tcfg.tau, rtol=1e-6)
    st = init_state(tcfg, 2, device="cpu")
    jst = state_from_jax(jax.tree.map(np.asarray, jax_init_state(jcfg, 2)), tcfg,
                         device="cpu")
    assert {k: tuple(v.shape) for k, v in st.items()} == \
        {k: tuple(v.shape) for k, v in jst.items()}


@pytest.mark.parametrize("name", ["stereospike", "stereospike_tempo"])
def test_stateful_forward_matches_jax(name, x64):
    jcfg, tcfg = _configs(name)
    jcfg = jcfg.for_inference()
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), _jax_params(name))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    assert all(v.dtype == torch.float64 for v in params.values())
    rng = np.random.default_rng(1)
    frames = rng.poisson(2.0, (3, 1, *HW, 4)).astype(np.float64)

    jstep = jax.jit(lambda p, f, s: jax_forward(p, f, jcfg, s))
    jstate = jax_init_state(jcfg, 1, jnp.float64)
    state = init_state(tcfg, 1, torch.float64, device="cpu")
    launches = cuda_kernels.multistep_fire.launches
    for frame in frames:
        jdepths, _, jstate = jstep(jparams, jnp.asarray(frame), jstate)
        depths, spikes, state = forward(params, torch.from_numpy(frame), tcfg, state)
        assert len(depths) == len(jdepths) == len(tcfg.heads)
        for d, jd in zip(depths, jdepths):
            assert d.shape == jd.shape
            np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-9, atol=1e-12)
        assert [tuple(s.shape) for s in spikes] == [
            (1, *tcfg.sizes[lvl], tcfg.channels[lvl]) for lvl in (4, 3, 2, 1, 0)]
    if name == "stereospike_tempo":
        # the PLIF ×10 variant fires at every level, bottleneck included (the
        # flagship's random weights leave its bottleneck quiet)
        assert all(float(s.sum()) > 0 for s in spikes)
    # a CPU run takes the plain version, never the kernel
    assert cuda_kernels.multistep_fire.launches == launches
    ours = state_to_jax(state, tcfg)
    assert set(ours) == set(jstate)
    for site, v in jstate.items():
        np.testing.assert_allclose(ours[site], np.asarray(v), rtol=1e-9, atol=1e-12,
                                   err_msg=site)
    # and the state comes back through state_from_jax unchanged
    back = state_from_jax(ours, tcfg, device="cpu")
    for site, v in state.items():
        assert torch.equal(back[site], v), site


def test_forward_rejects_what_the_kernel_cannot_compute():
    """Nothing is refused any more: the fused fire computes the soft reset
    and the undetached reset (tests/test_torch_reset_modes.py holds them
    against the JAX cells). The reset's detachment changes gradients only,
    so its forward equals the default's; a soft reset's differs."""
    _, tcfg = _configs("stereospike")
    params = init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    frame = torch.from_numpy(np.random.default_rng(0).poisson(2.0, (1, *HW, 4))
                             .astype(np.float32))
    ref = forward(params, frame, tcfg)[0]
    undetached = forward(params, frame, dataclasses.replace(tcfg, detach_reset=False))[0]
    soft = forward(params, frame, dataclasses.replace(tcfg, v_reset=None))[0]
    for a, b, c in zip(ref, undetached, soft):
        assert torch.equal(a, b)
        assert torch.isfinite(c).all()
