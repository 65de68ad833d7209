"""The port's fused fire (``stereospike_tpu_torch/snn/cuda_kernels.py``) and
neuron cells against the JAX package.

On the CPU the wrapper runs its plain version; it is held against the JAX
Pallas kernel run in interpret mode (as ``tests/test_pallas_kernels.py``
runs it) and against the JAX scan reference. Spikes must agree exactly; the
membrane to rtol 1e-6 at float32 (the two frameworks may contract the LIF
charge into an FMA differently, one rounding) and to one bfloat16 ulp
(rtol 2**-8) at bfloat16, where that rounding can land on either side.

The kernel itself runs only on a card: that case carries the ``cuda``
marker and needs no JAX, so the card's machine runs it with
``python -m pytest tests/test_torch_fire.py -m cuda --noconftest``. The JAX
side is therefore imported by the tests that compare against it.
"""

import numpy as np
import pytest
import torch

from stereospike_tpu_torch.snn import cuda_kernels, neurons, surrogate
from stereospike_tpu_torch.snn.cuda_kernels import multistep_fire, multistep_fire_reference

M = 1000  # not a multiple of the TPU kernel's 128-lane tile: its padding path runs
LEAKS = {"if": 0.0, "lif": 1.0 / 3.0, "plif": float(1.0 / (1.0 + np.exp(-0.3)))}


def _data(T, m=M, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, m)) * 0.6 + 0.7).astype(np.float32)
    v0 = (rng.uniform(0.0, 0.5, m)).astype(np.float32)
    x[0, :16] = 1.0 - v0[:16]  # charges that land exactly on the threshold
    return x, v0


def _bf16_np(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("kind", list(LEAKS))
def test_fire_matches_jax_kernel(kind, T, dtype):
    import jax.numpy as jnp

    from stereospike_tpu.snn.pallas_kernels import multistep_fire as jax_multistep_fire
    from stereospike_tpu.snn.pallas_kernels import (
        multistep_fire_reference as jax_multistep_fire_reference,
    )

    x, v0 = _data(T)
    if dtype == "bfloat16":
        x, v0 = _bf16_np(x), _bf16_np(v0)
    leak = LEAKS[kind]
    is_if = kind == "if"
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    js, jv = jax_multistep_fire(jnp.asarray(x, jdt), jnp.asarray(v0, jdt),
                                jnp.asarray(leak, jnp.float32), interpret=True, is_if=is_if)
    ts, tv = multistep_fire(torch.from_numpy(x).to(tdt), torch.from_numpy(v0).to(tdt),
                            None if is_if else torch.tensor(leak), is_if=is_if)
    assert ts.dtype == tdt and tv.dtype == tdt
    np.testing.assert_array_equal(ts.float().numpy(), np.asarray(js.astype(jnp.float32)))
    rtol = 2.0 ** -8 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(tv.float().numpy(), np.asarray(jv.astype(jnp.float32)),
                               rtol=rtol, atol=1e-6)
    if dtype == "float32":
        rs, rv = jax_multistep_fire_reference(jnp.asarray(x), jnp.asarray(v0),
                                              jnp.asarray(leak, jnp.float32))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
        np.testing.assert_allclose(tv.numpy(), np.asarray(rv), rtol=1e-6, atol=1e-6)
    ps, pv = multistep_fire_reference(torch.from_numpy(x).to(tdt), torch.from_numpy(v0).to(tdt),
                                      torch.tensor(leak), is_if=is_if)
    assert torch.equal(ps, ts) and torch.equal(pv, tv)


def test_fire_float64_plain_version_and_validation():
    """float64 stays float64 (the model's float64 parity runs need it); a
    hard reset to a non-zero potential and the soft reset are computed as
    the cells compute them; the wrapper refuses mismatched shapes."""
    x, v0 = _data(3, 64)
    s, v = multistep_fire(torch.from_numpy(x).double(), torch.from_numpy(v0).double(),
                          torch.tensor(0.25, dtype=torch.float64))
    assert s.dtype == v.dtype == torch.float64
    for v_reset in (0.5, None):
        s, v = multistep_fire(torch.from_numpy(x), torch.from_numpy(v0), None, v_reset=v_reset,
                              is_if=True)
        cv = torch.from_numpy(v0)
        for t in range(3):
            cv, cs = neurons.if_step(cv, torch.from_numpy(x[t]), v_reset=v_reset)
            assert torch.equal(s[t], cs)
        assert torch.equal(v, cv)
    with pytest.raises(ValueError):
        multistep_fire(torch.from_numpy(x), torch.from_numpy(v0[:10]), None, is_if=True)


@pytest.mark.parametrize("cell", ["if", "lif", "plif"])
def test_neuron_cells_match_jax(cell):
    import jax.numpy as jnp

    from stereospike_tpu.snn import neurons as jax_neurons

    x, v0 = _data(1, 256, seed=3)
    tx, tv = torch.from_numpy(x[0]), torch.from_numpy(v0)
    jx, jv = jnp.asarray(x[0]), jnp.asarray(v0)
    if cell == "if":
        ov, os_ = neurons.if_step(tv, tx)
        rv, rs = jax_neurons.if_step(jv, jx)
    elif cell == "lif":
        ov, os_ = neurons.lif_step(tv, tx, tau=3.0)
        rv, rs = jax_neurons.lif_step(jv, jx, tau=3.0)
    else:
        w = neurons.plif_w_from_tau(3.0)
        np.testing.assert_allclose(float(w), float(jax_neurons.plif_w_from_tau(3.0)), rtol=1e-7)
        ov, os_ = neurons.plif_step(tv, tx, w)
        rv, rs = jax_neurons.plif_step(jv, jx, jax_neurons.plif_w_from_tau(3.0))
    np.testing.assert_array_equal(os_.numpy(), np.asarray(rs))
    np.testing.assert_allclose(ov.numpy(), np.asarray(rv), rtol=1e-6, atol=1e-7)
    soft_v, _ = neurons.if_step(tv, tx, v_reset=None)
    soft_j, _ = jax_neurons.if_step(jv, jx, v_reset=None)
    np.testing.assert_allclose(soft_v.numpy(), np.asarray(soft_j), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(neurons.integrator_step(tv, tx).numpy(),
                                  np.asarray(jax_neurons.integrator_step(jv, jx)))


@pytest.mark.parametrize("name", ["atan", "sigmoid"])
def test_surrogate_matches_jax(name):
    """Heaviside forward with H(0) = 1 and the pseudo-derivative backward."""
    import jax
    import jax.numpy as jnp

    from stereospike_tpu.snn import surrogate as jax_surrogate

    u = np.linspace(-2.0, 2.0, 101).astype(np.float32)
    t = torch.from_numpy(u).requires_grad_(True)
    s = surrogate.make_spike_fn(name)(t)
    s.sum().backward()
    jfn = jax_surrogate.make_spike_fn(name)
    np.testing.assert_array_equal(s.detach().numpy(), np.asarray(jfn(jnp.asarray(u))))
    assert float(surrogate.make_spike_fn(name)(torch.zeros(1))) == 1.0
    jgrad = jax.grad(lambda a: jnp.sum(jfn(a)))(jnp.asarray(u))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        surrogate.make_spike_fn("relu")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version_on_the_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fire kernel has no CPU build")
    g = torch.Generator(device="cuda").manual_seed(0)
    launches = cuda_kernels.multistep_fire.launches
    for m in (1000, 1003, 191488):
        for T in (1, 5):
            for kind, leak in LEAKS.items():
                x = (torch.randn(T, m, generator=g, device="cuda") * 0.6 + 0.7).to(dtype)
                v0 = (torch.rand(m, generator=g, device="cuda") * 0.5).to(dtype)
                lk = None if kind == "if" else torch.tensor(leak, device="cuda")
                s, v = multistep_fire(x, v0, lk, is_if=kind == "if")
                rs, rv = multistep_fire_reference(x, v0, lk, is_if=kind == "if")
                assert torch.equal(s, rs) and torch.equal(v, rv), (m, T, kind)
    torch.cuda.synchronize()
    assert cuda_kernels.multistep_fire.launches == launches + 3 * 2 * len(LEAKS)
