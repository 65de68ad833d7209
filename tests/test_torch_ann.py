"""The port's equivalent ANN against the JAX package's, on the CPU.

- BatchNorm: ``batchnorm_apply`` (``F.batch_norm``) against the JAX
  ``batchnorm_apply`` in training (biased batch variance normalizes, the
  unbiased one moves the running variance, momentum 0.1, eps 1e-5) and in
  eval, at float64: rtol 1e-12.
- ``ann_forward`` in train and in eval mode, with the BN running
  statistics, and its gradients, against the JAX function on the same
  JAX-initialised weights at float64: depths and statistics to rtol 1e-9,
  gradients to rtol 1e-8 / atol 1e-10.
- Three train steps and one eval step against JAX ``train/ann_steps.py``.
  Both steps cast the frame to float32 (and JAX's convolution takes no
  mixed dtypes), so this runs at float32: losses, MDE, eval statistics and
  running statistics to rtol 1e-4; parameters all within 6 learning rates
  and 99.9 % of them within 1e-5. Adam's first updates move each weight by
  about the learning rate times the sign of its gradient, so where a
  gradient is within float32 noise of 0 its sign, and the update, may flip
  between two summation orders (a few hundred of ~1 M weights here).
- The ANN config resolution: the ``n_timesteps != 1`` refusal and the
  model names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereospike_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from stereospike_tpu.models.ann import AnnConfig as JaxAnnConfig
from stereospike_tpu.models.ann import ann_forward as jax_ann_forward
from stereospike_tpu.models.ann import init_ann_params as jax_init_ann_params
from stereospike_tpu.models.ann import init_ann_state as jax_init_ann_state
from stereospike_tpu.nn.blocks import batchnorm_apply as jax_batchnorm_apply
from stereospike_tpu.objectives.losses import TotalLossConfig as JaxTotalLossConfig
from stereospike_tpu.train.ann_steps import create_ann_train_state as jax_create_ann_train_state
from stereospike_tpu.train.ann_steps import make_ann_eval_step as jax_make_ann_eval_step
from stereospike_tpu.train.ann_steps import make_ann_train_step as jax_make_ann_train_step
from stereospike_tpu.train.config import TrainConfig as JaxTrainConfig
from stereospike_tpu.train.loop import ANN_MODELS as JAX_ANN_MODELS
from stereospike_tpu.train.loop import build_ann_config as jax_build_ann_config
from stereospike_tpu.train.state import make_optimizer as jax_make_optimizer
from stereospike_tpu_torch.interop import ann_params_from_jax, ann_params_to_jax
from stereospike_tpu_torch.models.ann import (
    AnnConfig,
    ann_forward,
    init_ann_params,
    init_ann_state,
)
from stereospike_tpu_torch.nn.blocks import batchnorm_apply
from stereospike_tpu_torch.objectives.losses import TotalLossConfig
from stereospike_tpu_torch.train.ann_steps import (
    create_ann_train_state,
    make_ann_eval_step,
    make_ann_train_step,
)
from stereospike_tpu_torch.train.config import TrainConfig
from stereospike_tpu_torch.train.loop import ANN_MODELS, build_ann_config, is_ann_model
from stereospike_tpu_torch.train.state import make_optimizer
from test_torch_sequence import _leaves, x64  # noqa: F401

HW = (32, 44)
BASE = 8
LR = 2e-4


def _jax_model(dtype):
    """JAX-initialised (params, bn_state) as numpy leaves of ``dtype``."""
    cfg = JaxAnnConfig(in_hw=HW, base_channels=BASE)
    cast = lambda a: np.asarray(a, dtype)  # noqa: E731
    return (jax.tree.map(cast, jax_init_ann_params(jax.random.PRNGKey(0), cfg)),
            jax.tree.map(cast, jax_init_ann_state(cfg)))


def _frame(dtype=np.float64, seed=1, b=2):
    return np.random.default_rng(seed).poisson(0.4, (b, *HW, 4)).astype(dtype)


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_jax(train, x64):
    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 2.0, (3, 6, 5, 7))  # NHWC for JAX
    params = {"gamma": rng.uniform(0.5, 1.5, 7), "beta": rng.normal(0, 1, 7)}
    state = {"mean": rng.normal(0, 1, 7), "var": rng.uniform(0.5, 2.0, 7)}
    y_j, s_j = jax_batchnorm_apply({k: jnp.asarray(v) for k, v in params.items()},
                                   jnp.asarray(x), state={k: jnp.asarray(v)
                                                          for k, v in state.items()},
                                   train=train)
    ours_state = {"running_mean": torch.from_numpy(state["mean"]),
                  "running_var": torch.from_numpy(state["var"])}
    y, s = batchnorm_apply({"weight": torch.from_numpy(params["gamma"]),
                            "bias": torch.from_numpy(params["beta"])},
                           torch.from_numpy(x).permute(0, 3, 1, 2), state=ours_state,
                           train=train)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), np.asarray(y_j), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(s["running_mean"].numpy(), np.asarray(s_j["mean"]), rtol=1e-12)
    np.testing.assert_allclose(s["running_var"].numpy(), np.asarray(s_j["var"]), rtol=1e-12)
    # the state passed in is left as it was
    assert np.array_equal(ours_state["running_mean"].numpy(), state["mean"])


def _stats_after_one_update(bn_state_np):
    """A BN state that is not the init: the running statistics of one JAX
    training forward, so that eval mode reads non-trivial statistics."""
    params, _ = _jax_model(np.float64)
    cfg = JaxAnnConfig(in_hw=HW, base_channels=BASE)
    _, st = jax.jit(lambda p, x, s: jax_ann_forward(p, x, cfg, s, train=True))(
        params, _frame(seed=9), bn_state_np)
    return jax.tree.map(np.asarray, st)


@pytest.mark.parametrize("train", [True, False])
def test_ann_forward_and_gradients_match_jax(train, x64):
    jcfg = JaxAnnConfig(in_hw=HW, base_channels=BASE)
    cfg = AnnConfig(in_hw=HW, base_channels=BASE)
    params_np, bn_np = _jax_model(np.float64)
    bn_np = _stats_after_one_update(bn_np)
    frame = _frame()
    init_depth = np.random.default_rng(2).uniform(1.0, 2.0, (2, *HW, 1))

    def loss_fn(p, x, s):
        depths, new_state = jax_ann_forward(p, x, jcfg, s, train=train, init_depth=init_depth)
        return sum((i + 1) * jnp.sum(d ** 2) for i, d in enumerate(depths)), (depths, new_state)

    (loss_j, (depths_j, state_j)), g_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params_np, frame, bn_np)

    params, bn_state = ann_params_from_jax(params_np, bn_np, device="cpu")
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    depths, new_state = ann_forward(params, torch.from_numpy(frame), cfg, bn_state,
                                    train=train, init_depth=torch.from_numpy(init_depth))
    loss = sum((i + 1) * (d ** 2).sum() for i, d in enumerate(depths))
    loss.backward()

    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-9)
    for d, dj in zip(depths, depths_j):
        assert d.shape == dj.shape == (2, *HW, 1)
        np.testing.assert_allclose(d.detach().numpy(), np.asarray(dj), rtol=1e-9, atol=1e-12)
    _, state_back = ann_params_to_jax({k: v.detach() for k, v in params.items()}, new_state)
    theirs = _leaves(jax.tree.map(np.asarray, state_j))
    ours = _leaves(state_back)
    assert ours.keys() == theirs.keys() and len(ours) == 26
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-9, err_msg=k)
    if not train:  # eval reads the running statistics and leaves them
        assert all(np.array_equal(ours[k], v) for k, v in _leaves(bn_np).items())
    grads, _ = ann_params_to_jax({k: v.grad for k, v in params.items()}, new_state)
    ours, theirs = _leaves(grads), _leaves(jax.tree.map(np.asarray, g_j))
    assert ours.keys() == theirs.keys()
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-8, atol=1e-10, err_msg=k)


def test_ann_init_and_interop_match_jax_layout():
    """Fresh parameters and statistics have the JAX shapes under the .pth
    keys, and the bridge to the JAX trees is exact both ways."""
    cfg = AnnConfig(in_hw=HW, base_channels=BASE)
    params_np, bn_np = _jax_model(np.float32)
    params, bn_state = ann_params_from_jax(params_np, bn_np, device="cpu")
    ours = init_ann_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    ours_bn = init_ann_state(cfg, device="cpu")
    assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in params.items()}
    assert {k: v.shape for k, v in ours_bn.items()} == {k: v.shape for k, v in bn_state.items()}
    assert len(ours) == 17 + 13 + 2 * 13  # 17 weights, 13 conv biases, 13 BN pairs
    assert all(torch.equal(ours_bn[k], bn_state[k]) for k in ours_bn)
    assert "bottleneck.1.conv2.2.running_var" in ours_bn and "deconv1.0.up.1.bias" not in ours
    tree, bn_tree = ann_params_to_jax(params, bn_state)
    for a, b in ((tree, params_np), (bn_tree, bn_np)):
        a, b = _leaves(a), _leaves(b)
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_ann_train_and_eval_steps_match_jax():
    jcfg = JaxAnnConfig(in_hw=HW, base_channels=BASE)
    cfg = AnnConfig(in_hw=HW, base_channels=BASE)
    params_np, bn_np = _jax_model(np.float32)
    batches = [{k: np.array(v) for k, v in jax_synthetic_batch(
        jax.random.PRNGKey(30 + i), batch=2, in_hw=HW).items()} for i in range(4)]

    jtx = jax_make_optimizer(LR)
    jstate = jax_create_ann_train_state(jax.tree.map(jnp.asarray, params_np),
                                        jax.tree.map(jnp.asarray, bn_np), jtx)
    jstep = jax.jit(jax_make_ann_train_step(jcfg, JaxTotalLossConfig(), jtx))
    jax_metrics = []
    for b in batches[:3]:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jax_metrics.append((float(m["loss"]), float(m["mde"])))
    jeval = jax.jit(jax_make_ann_eval_step(jcfg, JaxTotalLossConfig()))(
        jstate.params, jstate.bn_state, {k: jnp.asarray(v) for k, v in batches[3].items()})

    tx = make_optimizer(LR)
    params, bn_state = ann_params_from_jax(params_np, bn_np, device="cpu")
    state = create_ann_train_state(params, bn_state, tx)
    step = make_ann_train_step(cfg, TotalLossConfig(), tx)
    ours = []
    for b in batches[:3]:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        ours.append((float(m["loss"]), float(m["mde"])))
    ev = make_ann_eval_step(cfg, TotalLossConfig())(
        state.params, state.bn_state, {k: torch.from_numpy(v) for k, v in batches[3].items()})

    assert state.step == 3
    np.testing.assert_allclose(ours, jax_metrics, rtol=1e-4)
    np.testing.assert_allclose([float(ev["loss"]), float(ev["mde"])],
                               [float(jeval["loss"]), float(jeval["mde"])], rtol=1e-4)
    np.testing.assert_allclose(ev["depth"].numpy(), np.asarray(jeval["depth"]), rtol=1e-4,
                               atol=1e-4)
    tree, bn_tree = ann_params_to_jax(state.params, state.bn_state)
    diffs = np.concatenate([np.abs(_leaves(tree)[k] - v).ravel() for k, v in
                            _leaves(jax.tree.map(np.asarray, jstate.params)).items()])
    assert diffs.max() <= 6 * LR and np.mean(diffs > 1e-5) < 1e-3, (diffs.max(),
                                                                     np.mean(diffs > 1e-5))
    moved = 0
    for k, v in _leaves(jax.tree.map(np.asarray, jstate.bn_state)).items():
        np.testing.assert_allclose(_leaves(bn_tree)[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
        moved += not np.array_equal(v, _leaves(bn_np)[k])
    assert moved == 26  # every running statistic moved from its init


def test_ann_config_resolution_matches_jax():
    assert ANN_MODELS == JAX_ANN_MODELS
    assert is_ann_model("ann_tanh") and not is_ann_model("stereospike")
    for model in ANN_MODELS:
        ours = build_ann_config(TrainConfig(model=model, in_hw=HW, n_inference=2))
        theirs = jax_build_ann_config(JaxTrainConfig(model=model, in_hw=HW, n_inference=2))
        assert (ours.in_channels, ours.in_hw, ours.activation) == \
            (theirs.in_channels, theirs.in_hw, theirs.activation)
    with pytest.raises(ValueError, match="single-step"):
        build_ann_config(TrainConfig(model="ann", n_inference=2, n_timesteps=2))
    with pytest.raises(ValueError, match="single-step"):
        jax_build_ann_config(JaxTrainConfig(model="ann", n_inference=2, n_timesteps=2))
