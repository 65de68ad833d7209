"""The gradient of the port's fused fire (``stereospike_tpu_torch/snn/cuda_kernels.py``)
against the JAX package's.

On the CPU the autograd Function's backward runs its plain version,
``multistep_fire_backward_reference``. It is held against ``jax.vjp`` of
the JAX Pallas fire run in interpret mode (its backward is the Pallas
``_bwd_kernel``, as ``tests/test_pallas_kernels.py`` runs it) and of the
JAX scan reference, on the same numpy inputs and cotangents. Tolerances:

- float32: gx and gv0 to rtol 1e-6 (ATan; the same operations in the same
  order, but XLA may contract a product and a sum into an FMA) and 1e-5
  (Sigmoid; the two frameworks' ``exp`` differ by an ulp or two), each
  also within that share of the array's largest magnitude (dh sums two
  products, and where they nearly cancel an ulp of either is a large
  share of a small result);
- bfloat16: gx and gv0 to one bfloat16 ulp (rtol 2**-7), since an ulp of
  difference in float32 can round either way;
- the PLIF leak gradient, a sum over M·T terms in another order (and, in
  JAX at bfloat16, of terms rounded to bfloat16 first), to 1e-6 (float32)
  or 2**-7 (bfloat16) of the sum of the terms' magnitudes.

The kernel itself runs only on a card: that case carries the ``cuda``
marker and needs no JAX (``python -m pytest
tests/test_torch_fire_backward.py -m cuda --noconftest``), so JAX is
imported inside the tests that compare against it.
"""

import math

import numpy as np
import pytest
import torch

from stereospike_tpu_torch.snn import cuda_kernels, neurons, surrogate
from stereospike_tpu_torch.snn.cuda_kernels import (
    multistep_fire,
    multistep_fire_backward,
    multistep_fire_backward_reference,
    multistep_fire_reference,
)

M = 1000  # not a multiple of the TPU kernel's 128-lane tile: its padding path runs
LEAKS = {"if": 0.0, "lif": 1.0 / 3.0, "plif": float(1.0 / (1.0 + np.exp(-0.3)))}
ALPHAS = {"atan": 2.0, "sigmoid": 4.0}


def _data(T, m=M, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, m)) * 0.6 + 0.7).astype(np.float32)
    v0 = rng.uniform(0.0, 0.5, m).astype(np.float32)
    gs = rng.standard_normal((T, m)).astype(np.float32)
    gvT = rng.standard_normal(m).astype(np.float32)
    x[0, :16] = 1.0 - v0[:16]  # charges that land exactly on the threshold
    return x, v0, gs, gvT


def _round_bf16(*arrays):
    return [torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in arrays]


def _torch_grads(x, v0, leak, gs, gvT, kind, name, dtype, fire=multistep_fire):
    """(gx, gv0, gleak) of the port's fire under autograd; ``gvT=None``
    leaves v_T out of the loss."""
    tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
    tv = torch.from_numpy(v0).to(dtype).requires_grad_(True)
    tl = None
    if kind != "if":
        # the leak in float32 at bfloat16 I/O, as the JAX side gets it
        ldt = torch.float64 if dtype == torch.float64 else torch.float32
        tl = torch.tensor(leak, dtype=ldt).requires_grad_(kind == "plif")
    s, v = fire(tx, tv, tl, is_if=kind == "if", surrogate=name, alpha=ALPHAS[name])
    loss = (s * torch.from_numpy(gs).to(dtype)).sum()
    if gvT is not None:
        loss = loss + (v * torch.from_numpy(gvT).to(dtype)).sum()
    loss.backward()
    gleak = None if tl is None or tl.grad is None else float(tl.grad)
    return tx.grad.double().numpy(), tv.grad.double().numpy(), gleak


def _jax_grads(x, v0, leak, gs, gvT, kind, name, dtype, pallas=True):
    import jax
    import jax.numpy as jnp

    from stereospike_tpu.snn.pallas_kernels import multistep_fire as jfire
    from stereospike_tpu.snn.pallas_kernels import multistep_fire_reference as jref

    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    alpha = ALPHAS[name]

    def f(xx, vv, ll):
        if pallas:
            return jfire(xx, vv, ll, 1.0, 0.0, name, alpha, kind == "plif", True, kind == "if")
        return jref(xx, vv, ll, 1.0, 0.0, name, alpha, kind == "plif")

    _, vjp = jax.vjp(f, jnp.asarray(x, jdt), jnp.asarray(v0, jdt),
                     jnp.asarray(leak, jnp.float32))
    gx, gv0, gl = vjp((jnp.asarray(gs, jdt), jnp.asarray(gvT, jdt)))
    return (np.asarray(gx.astype(jnp.float32)), np.asarray(gv0.astype(jnp.float32)),
            float(gl))


def _gleak_scale(x, v0, leak, gs, gvT, kind, name):
    """Σ|terms| of the PLIF leak gradient: the scale of its tolerance."""
    _, _, terms = multistep_fire_backward_reference(
        torch.from_numpy(x), torch.from_numpy(v0), torch.tensor(leak),
        torch.from_numpy(gs), None if gvT is None else torch.from_numpy(gvT),
        is_if=kind == "if", surrogate=name, need_gleak=True, reduce=False)
    return float(terms.abs().sum())


def _assert_close(ours, theirs, dtype, name, scale, context):
    gx, gv0, gl = ours
    jgx, jgv0, jgl = theirs
    if dtype == torch.bfloat16:
        rtol, gl_tol = 2.0 ** -7, 2.0 ** -7
    else:
        rtol, gl_tol = (1e-6 if name == "atan" else 1e-5), 1e-6
    # relative to the array's scale: dh sums two products, and where they
    # nearly cancel an ulp of either is a large share of a small result
    atol = rtol * max(np.abs(jgx).max(), np.abs(jgv0).max())
    np.testing.assert_allclose(gx, jgx, rtol=rtol, atol=atol, err_msg=f"gx {context}")
    np.testing.assert_allclose(gv0, jgv0, rtol=rtol, atol=atol, err_msg=f"gv0 {context}")
    if gl is not None:
        assert abs(gl - jgl) <= gl_tol * scale, (context, gl, jgl, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["atan", "sigmoid"])
@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("kind", list(LEAKS))
def test_fire_gradients_match_jax(kind, T, name, dtype):
    x, v0, gs, gvT = _data(T)
    if dtype == torch.bfloat16:
        x, v0, gs, gvT = _round_bf16(x, v0, gs, gvT)
    leak = LEAKS[kind]
    ours = _torch_grads(x, v0, leak, gs, gvT, kind, name, dtype)
    scale = _gleak_scale(x, v0, leak, gs, gvT, kind, name)
    _assert_close(ours, _jax_grads(x, v0, leak, gs, gvT, kind, name, dtype),
                  dtype, name, scale, "pallas")
    if dtype == torch.float32:
        _assert_close(ours, _jax_grads(x, v0, leak, gs, gvT, kind, name, dtype, pallas=False),
                      dtype, name, scale, "scan reference")


@pytest.mark.parametrize("name", ["atan", "sigmoid"])
def test_unused_v_t_is_a_zero_gradient(name):
    """At T=1 the loss reads no v_T: autograd hands the backward None, which
    must equal an explicit zero cotangent (and JAX's)."""
    x, v0, gs, _ = _data(1, seed=4)
    zeros = np.zeros_like(v0)
    ours = _torch_grads(x, v0, LEAKS["plif"], gs, None, "plif", name, torch.float32)
    explicit = _torch_grads(x, v0, LEAKS["plif"], gs, zeros, "plif", name, torch.float32)
    for a, b in zip(ours, explicit):
        np.testing.assert_array_equal(a, b)
    scale = _gleak_scale(x, v0, LEAKS["plif"], gs, None, "plif", name)
    _assert_close(ours, _jax_grads(x, v0, LEAKS["plif"], gs, zeros, "plif", name,
                                   torch.float32), torch.float32, name, scale, "pallas")


@pytest.mark.parametrize("tau", [1.0, 1.0 + 1e-6, 1.0005])
def test_leak_near_one_is_finite(tau):
    """leak = 1/tau → 1: the replay never divides by (1 - leak), so every
    gradient stays finite and matches the JAX kernel's."""
    x, v0, gs, gvT = _data(5, m=256, seed=2)
    leak = float(np.float32(1.0 / tau))
    ours = _torch_grads(x, v0, leak, gs, gvT, "plif", "atan", torch.float32)
    assert all(np.isfinite(a).all() for a in ours[:2]) and math.isfinite(ours[2])
    scale = _gleak_scale(x, v0, leak, gs, gvT, "plif", "atan")
    _assert_close(ours, _jax_grads(x, v0, leak, gs, gvT, "plif", "atan", torch.float32),
                  torch.float32, "atan", scale, f"tau={tau}")


def test_long_sequence_small_m():
    """T past the kernel's register replay (it then keeps v_{t-1} in a
    scratch), at a small M."""
    x, v0, gs, gvT = _data(24, m=130, seed=3)
    leak = LEAKS["plif"]
    ours = _torch_grads(x, v0, leak, gs, gvT, "plif", "sigmoid", torch.float32)
    scale = _gleak_scale(x, v0, leak, gs, gvT, "plif", "sigmoid")
    _assert_close(ours, _jax_grads(x, v0, leak, gs, gvT, "plif", "sigmoid", torch.float32),
                  torch.float32, "sigmoid", scale, "T=24")


@pytest.mark.parametrize("kind", list(LEAKS))
def test_backward_matches_autograd_of_the_cells(kind):
    """An independent derivation: autograd through a T-loop of the
    ``snn/neurons.py`` cells with the surrogate spike functions, float64."""
    x, v0, gs, gvT = (a.astype(np.float64) for a in _data(4, m=300, seed=5))
    for name in ("atan", "sigmoid"):
        ours = _torch_grads(x, v0, LEAKS[kind], gs, gvT, kind, name, torch.float64)
        tx = torch.from_numpy(x).requires_grad_(True)
        tv = torch.from_numpy(v0).requires_grad_(True)
        w = torch.tensor(-math.log(1.0 / LEAKS["plif"] - 1.0), dtype=torch.float64,
                         requires_grad=True)
        spike_fn = surrogate.make_spike_fn(name)
        v, loss = tv, 0.0
        for t in range(x.shape[0]):
            if kind == "if":
                v, s = neurons.if_step(v, tx[t], spike_fn=spike_fn)
            elif kind == "lif":
                v, s = neurons.lif_step(v, tx[t], tau=3.0, spike_fn=spike_fn)
            else:
                v, s = neurons.plif_step(v, tx[t], w, spike_fn=spike_fn)
            loss = loss + (s * torch.from_numpy(gs[t])).sum()
        (loss + (v * torch.from_numpy(gvT)).sum()).backward()
        np.testing.assert_allclose(ours[0], tx.grad.numpy(), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(ours[1], tv.grad.numpy(), rtol=1e-12, atol=1e-14)
        if kind == "plif":
            # autograd reaches w through sigmoid'(w) = leak·(1 - leak)
            lk = LEAKS["plif"]
            assert ours[2] * lk * (1 - lk) == pytest.approx(float(w.grad), rel=1e-6)


def test_reference_path_and_validation():
    """The plain fire is differentiable through the same backward; no_grad
    saves nothing; the backward refuses what it does not compute."""
    x, v0, gs, gvT = _data(3, m=64)
    a = _torch_grads(x, v0, LEAKS["plif"], gs, gvT, "plif", "atan", torch.float32)
    b = _torch_grads(x, v0, LEAKS["plif"], gs, gvT, "plif", "atan", torch.float32,
                     fire=multistep_fire_reference)
    for u, w in zip(a, b):
        np.testing.assert_array_equal(u, w)
    tx = torch.from_numpy(x).requires_grad_(True)
    with torch.no_grad():
        s, _ = multistep_fire(tx, torch.from_numpy(v0), None, is_if=True)
    assert s.grad_fn is None
    with pytest.raises(ValueError):
        multistep_fire_backward(torch.from_numpy(x), torch.from_numpy(v0), None,
                                torch.from_numpy(gs), None, is_if=True, need_gleak=True)
    with pytest.raises(ValueError):
        multistep_fire_backward(torch.from_numpy(x), torch.from_numpy(v0), None,
                                torch.from_numpy(gs[:1]), None, is_if=True)
    with pytest.raises(ValueError):
        multistep_fire(torch.from_numpy(x), torch.from_numpy(v0), None, is_if=True,
                       surrogate="relu")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_matches_plain_version_on_the_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fire backward kernel has no CPU build")
    g = torch.Generator(device="cuda").manual_seed(0)
    launches = cuda_kernels.multistep_fire_backward.launches
    n = 0
    for m in (1000, 1003, 191488):
        for T in (1, 5, 12):
            for kind, leak in LEAKS.items():
                for name in ("atan", "sigmoid"):
                    x = (torch.randn(T, m, generator=g, device="cuda") * 0.6 + 0.7).to(dtype)
                    v0 = (torch.rand(m, generator=g, device="cuda") * 0.5).to(dtype)
                    gs = torch.randn(T, m, generator=g, device="cuda").to(dtype)
                    gvT = None if T == 1 else torch.randn(m, generator=g, device="cuda").to(dtype)
                    lk = None if kind == "if" else torch.tensor(leak, device="cuda")
                    args = (x, v0, lk, gs, gvT, 1.0, 0.0, kind == "if", name, None,
                            kind == "plif")
                    gx, gv0, gl = multistep_fire_backward(*args)
                    rx, rv0, rl = multistep_fire_backward_reference(*args)
                    if name == "atan":
                        assert torch.equal(gx, rx) and torch.equal(gv0, rv0), (m, T, kind)
                    else:
                        rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-6
                        torch.testing.assert_close(gx, rx, rtol=rtol, atol=1e-6)
                        torch.testing.assert_close(gv0, rv0, rtol=rtol, atol=1e-6)
                    if kind == "plif":
                        _, _, terms = multistep_fire_backward_reference(*args, reduce=False)
                        assert abs(float(gl) - float(rl)) <= 1e-5 * float(terms.abs().sum())
                    n += 1
    torch.cuda.synchronize()
    assert cuda_kernels.multistep_fire_backward.launches == launches + n
