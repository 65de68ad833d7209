"""The port's eval step, per-sample statistics, firing-rate taps and NaN
masks against the JAX package's, on the CPU.

- ``make_eval_step`` at T=1 (step-major) and T=3 (layer-major) on a batch
  whose three samples have different valid-pixel counts, with the spike
  penalty on, so that each sample's n, (Σ res)²/n² and spike term stay its
  own: loss and MDE to rtol 1e-9, the full-scale depth to rtol 1e-9 /
  atol 1e-12. The eval step makes no graph: its fire runs without grad.
- ``per_sample_eval_stats`` on random maps to rtol 1e-12 (the same
  arithmetic in another framework), and unlike the pooled loss.
- ``firing_rates`` and ``firing_rates_sequence`` (T=3, carried state; T=1
  equal to the single step), exactly: the densities are float32
  count/size ratios of spikes that agree exactly at float64.
- ``valid_mask_from_nan`` and ``mask_invalid`` exactly.

Float64 throughout, on the weights and configurations of
``tests/test_torch_multistep.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereospike_tpu.models.stereospike import TAP_NAMES as JAX_TAP_NAMES
from stereospike_tpu.models.stereospike import count_params as jax_count_params
from stereospike_tpu.models.stereospike import firing_rates as jax_firing_rates
from stereospike_tpu.models.stereospike import firing_rates_sequence as jax_firing_rates_sequence
from stereospike_tpu.objectives.losses import TotalLossConfig as JaxTotalLossConfig
from stereospike_tpu.objectives.losses import total_loss as jax_total_loss
from stereospike_tpu.objectives.metrics import mask_invalid as jax_mask_invalid
from stereospike_tpu.objectives.metrics import valid_mask_from_nan as jax_valid_mask_from_nan
from stereospike_tpu.train.steps import make_eval_step as jax_make_eval_step
from stereospike_tpu.train.steps import per_sample_eval_stats as jax_per_sample_eval_stats
from stereospike_tpu_torch.interop import params_from_jax, state_from_jax
from stereospike_tpu_torch.models.stereospike import (
    TAP_NAMES,
    count_params,
    firing_rates,
    firing_rates_sequence,
)
from stereospike_tpu_torch.objectives.losses import TotalLossConfig, total_loss
from stereospike_tpu_torch.objectives.metrics import mask_invalid, valid_mask_from_nan
from stereospike_tpu_torch.snn.cuda_kernels import multistep_fire
from stereospike_tpu_torch.train.steps import make_eval_step, per_sample_eval_stats
from test_torch_multistep import HW, carried_state_np, configs, frames_np, jax_params_np
from test_torch_sequence import x64  # noqa: F401


def _batch(T, seed=7, b=3):
    """Poisson chunks, GT in [1, 6), and valid fractions 0.3, 0.5, 0.7."""
    rng = np.random.default_rng(seed)
    h, w = HW
    return {"chunks": rng.poisson(0.4, (b, T, h, w, 4)).astype(np.float64),
            "gt": rng.uniform(1.0, 6.0, (b, h, w, 1)),
            "mask": np.stack([rng.random((h, w, 1)) < 0.3 + 0.6 * i / b for i in range(b)])}


@pytest.mark.parametrize("name,T,multistep", [("stereospike", 1, False),
                                              ("stereospike_tempo", 3, True)])
def test_eval_step_matches_jax(name, T, multistep, x64):
    jcfg, tcfg = configs(name)
    batch = _batch(T)
    jstep = jax.jit(jax_make_eval_step(jcfg, JaxTotalLossConfig(penalize_spikes=True),
                                       learn_on="LOG", compute_dtype=jnp.float64,
                                       multistep=multistep))
    theirs = jstep(jax_params_np(name), {k: jnp.asarray(v) for k, v in batch.items()})

    params = {k: v.requires_grad_(True) for k, v in
              params_from_jax(jax_params_np(name), tcfg, device="cpu").items()}
    grad_modes = []

    def fire(*args, **kwargs):
        grad_modes.append(torch.is_grad_enabled())
        return multistep_fire(*args, **kwargs)

    step = make_eval_step(tcfg, TotalLossConfig(penalize_spikes=True), learn_on="LOG",
                          compute_dtype=torch.float64, multistep=multistep, fire_fn=fire)
    ours = step(params, {k: torch.from_numpy(v) for k, v in batch.items()})

    assert grad_modes == [False] * 13 * (1 if multistep else T)
    assert not any(v.requires_grad for v in ours.values())
    np.testing.assert_allclose(float(ours["loss"]), float(theirs["loss"]), rtol=1e-9)
    np.testing.assert_allclose(float(ours["mde"]), float(theirs["mde"]), rtol=1e-9)
    np.testing.assert_allclose(ours["depth"].numpy(), np.asarray(theirs["depth"]),
                               rtol=1e-9, atol=1e-12)


def test_per_sample_eval_stats_match_jax(x64):
    rng = np.random.default_rng(3)
    b, (h, w) = 3, HW
    depths = [rng.uniform(0.5, 7.0, (b, h, w, 1)) for _ in range(4)]
    spikes = [(rng.random((b, h // 2, w // 2, 8)) < 0.3).astype(np.float64) for _ in range(5)]
    gt = rng.uniform(1.0, 6.0, (b, h, w, 1))
    mask = np.stack([rng.random((h, w, 1)) < 0.2 + 0.3 * i for i in range(b)])
    for cfg_kw, learn_on in ((dict(), "LIN"), (dict(penalize_spikes=True, beta=0.5), "DISP")):
        theirs = jax_per_sample_eval_stats(
            [jnp.asarray(d) for d in depths], [jnp.asarray(s) for s in spikes],
            jnp.asarray(gt), jnp.asarray(mask), JaxTotalLossConfig(**cfg_kw), learn_on)
        t = [torch.from_numpy(a) for a in depths], [torch.from_numpy(a) for a in spikes]
        ours = per_sample_eval_stats(*t, torch.from_numpy(gt), torch.from_numpy(mask),
                                     TotalLossConfig(**cfg_kw), learn_on)
        np.testing.assert_allclose([float(v) for v in ours], [float(v) for v in theirs],
                                   rtol=1e-12)
        pooled = float(total_loss(*t[:1], torch.from_numpy(gt), torch.from_numpy(mask),
                                  t[1], TotalLossConfig(**cfg_kw)))
        np.testing.assert_allclose(pooled, float(jax_total_loss(
            [jnp.asarray(d) for d in depths], jnp.asarray(gt), jnp.asarray(mask),
            [jnp.asarray(s) for s in spikes], JaxTotalLossConfig(**cfg_kw))), rtol=1e-12)
        assert abs(pooled - float(ours[0])) > 1e-3  # per-sample is not the pooled mean


@pytest.mark.parametrize("name", ["stereospike", "stereospike_tempo"])
def test_firing_rates_match_jax(name, x64):
    jcfg, tcfg = configs(name)
    assert TAP_NAMES == JAX_TAP_NAMES and len(TAP_NAMES) == 14
    params = params_from_jax(jax_params_np(name), tcfg, device="cpu")
    assert count_params(params) == jax_count_params(jax_params_np(name))
    state_j = carried_state_np(name)
    state = state_from_jax(state_j, tcfg, device="cpu")
    frames = frames_np(3, seed=5)

    seq_j = jax.jit(lambda p, x, s: jax_firing_rates_sequence(p, x, jcfg, s))(
        jax_params_np(name), frames, state_j)
    seq = firing_rates_sequence(params, torch.from_numpy(frames), tcfg, state)
    assert list(seq) == list(TAP_NAMES) and set(seq_j) == set(TAP_NAMES)
    for k in TAP_NAMES:
        assert seq[k].dtype == torch.float32 and 0.0 <= float(seq[k]) <= 1.0
        assert float(seq[k]) == float(seq_j[k]), (k, float(seq[k]), float(seq_j[k]))
    assert sum(float(v) > 0 for v in seq.values()) == 14

    one_j = jax.jit(lambda p, x, s: jax_firing_rates(p, x, jcfg, s))(
        jax_params_np(name), frames[:, 0], state_j)
    one = firing_rates(params, torch.from_numpy(frames[:, 0]), tcfg, state)
    first = firing_rates_sequence(params, torch.from_numpy(frames[:, :1]), tcfg, state)
    for k in TAP_NAMES:
        assert float(one[k]) == float(one_j[k]) == float(first[k]), k


def test_firing_rates_take_integer_frames():
    """uint8 count frames are cast to float32 first."""
    _, tcfg = configs("stereospike")
    params = {k: v.float() for k, v in
              params_from_jax(jax_params_np("stereospike"), tcfg, device="cpu").items()}
    frames = frames_np(2, seed=6)
    as_uint8 = firing_rates_sequence(params, torch.from_numpy(frames.astype(np.uint8)), tcfg)
    as_float = firing_rates_sequence(params, torch.from_numpy(frames.astype(np.float32)), tcfg)
    assert all(torch.equal(as_uint8[k], as_float[k]) for k in TAP_NAMES)


def test_nan_masks_match_jax():
    rng = np.random.default_rng(4)
    gt = rng.uniform(1.0, 6.0, (2, 8, 10, 1)).astype(np.float32)
    gt[rng.random(gt.shape) < 0.3] = np.nan
    pred = rng.uniform(1.0, 6.0, gt.shape).astype(np.float32)
    values, mask = valid_mask_from_nan(torch.from_numpy(gt))
    values_j, mask_j = jax_valid_mask_from_nan(jnp.asarray(gt))
    np.testing.assert_array_equal(values.numpy(), np.asarray(values_j))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    assert mask.dtype == torch.bool and not torch.isnan(values).any()
    for a, b in zip(mask_invalid(torch.from_numpy(pred), values, mask),
                    jax_mask_invalid(jnp.asarray(pred), values_j, mask_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
