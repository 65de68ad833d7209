"""The port's losses, metrics and bilinear resize against the JAX package's,
at float64 on the same numpy inputs: values to rtol 1e-12, and the
losses' gradients with respect to the predictions and spikes to rtol 1e-10
(the same formulas in the same order; only the summation order of the
reductions differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereospike_tpu.nn.layers import bilinear_resize as jax_bilinear_resize
from stereospike_tpu.objectives import losses as jax_losses
from stereospike_tpu.objectives import metrics as jax_metrics
from stereospike_tpu_torch.nn.layers import bilinear_resize
from stereospike_tpu_torch.objectives import losses, metrics

HW = (24, 34)


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _maps(seed=0, shape=(2, *HW, 1), invalid=0.25):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(1.0, 9.0, shape)
    mask = rng.random(shape) >= invalid
    return rng.normal(4.0, 2.0, shape), np.where(mask, gt, 0.0), mask


@pytest.mark.parametrize("size,align_corners", [
    ((48, 68), False), ((12, 17), False), ((17, 40), False), ((48, 68), True),
    ((13, 9), True), ((24, 1), True)])
def test_bilinear_resize_matches_jax(size, align_corners, x64):
    x = np.random.default_rng(1).normal(size=(2, *HW, 3))
    ours = bilinear_resize(torch.from_numpy(x), size, align_corners=align_corners)
    theirs = jax_bilinear_resize(jnp.asarray(x), size, align_corners=align_corners)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-12, atol=1e-12)
    same = torch.from_numpy(x)
    assert bilinear_resize(same, HW) is same


@pytest.mark.parametrize("case", ["identity", "resized_heads", "penalized", "flat"])
def test_total_loss_and_gradients_match_jax(case, x64):
    """Full-resolution heads (the flagship's), heads at lower resolutions
    (the mask-aware GT resize runs), spike penalization with other
    weights, and flat maps whose Sobel responses are exactly 0 at valid
    pixels (where ``jnp.abs`` differentiates to 1 and ``torch.abs`` to 0)."""
    _, gt, mask = _maps()
    rng = np.random.default_rng(2)
    sizes = [HW] * 4 if case != "resized_heads" else [HW, (12, 17), (6, 9), (3, 5)]
    preds = [rng.normal(4.0, 2.0, (2, *s, 1)) for s in sizes]
    if case == "flat":
        gt = np.broadcast_to(np.linspace(1.0, 5.0, HW[0])[None, :, None, None], gt.shape).copy()
        mask = np.ones_like(mask)
        preds = [np.full((2, *HW, 1), 3.0 + k) for k in range(4)]
    spikes = [(rng.random((2, 6, 9, 8)) < 0.3).astype(np.float64),
              (rng.random((2, *HW, 4)) < 0.2).astype(np.float64)]
    kw = dict(alpha=0.5, scale_weights=(1.0, 1.0, 1.0, 1.0))
    if case == "penalized":
        kw = dict(alpha=0.3, scale_weights=(1.0, 0.5, 0.25, 2.0), penalize_spikes=True,
                  beta=0.7)
    tp = [torch.from_numpy(p).requires_grad_(True) for p in preds]
    ts = [torch.from_numpy(s).requires_grad_(True) for s in spikes]
    ours = losses.total_loss(tp, torch.from_numpy(gt), torch.from_numpy(mask), ts,
                             losses.TotalLossConfig(**kw))
    ours.backward()

    def f(p, s):
        return jax_losses.total_loss(p, jnp.asarray(gt), jnp.asarray(mask), s,
                                     jax_losses.TotalLossConfig(**kw))

    theirs, (gp, gs) = jax.value_and_grad(f, argnums=(0, 1))(
        [jnp.asarray(p) for p in preds], [jnp.asarray(s) for s in spikes])
    np.testing.assert_allclose(float(ours.detach()), float(theirs), rtol=1e-12)
    for t, g in zip(tp + ts, list(gp) + list(gs)):
        ours_g = torch.zeros_like(t) if t.grad is None else t.grad  # unpenalized spikes
        np.testing.assert_allclose(ours_g.numpy(), np.asarray(g), rtol=1e-10, atol=1e-14)


def test_loss_terms_and_gt_resize_match_jax(x64):
    pred, gt, mask = _maps(seed=3)
    tp, tg, tm = (torch.from_numpy(a) for a in (pred, gt, mask))
    jp, jg, jm = (jnp.asarray(a) for a in (pred, gt, mask))
    for name in ("scale_invariant_loss", "gradient_matching_loss"):
        np.testing.assert_allclose(float(getattr(losses, name)(tp, tg, tm)),
                                   float(getattr(jax_losses, name)(jp, jg, jm)), rtol=1e-12)
    for size in ((12, 17), (7, 30)):
        vals, valid = losses.resize_groundtruth(tg, tm, size)
        jvals, jvalid = jax_losses.resize_groundtruth(jg, jm, size)
        np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        assert 0 < valid.sum() < valid.numel()
    same, same_mask = losses.resize_groundtruth(tg, tm, HW)
    assert same is tg and same_mask is tm
    # no valid pixel at all: n clamps to 1 and the loss is 0, not NaN
    none = torch.zeros_like(tm)
    assert float(losses.scale_invariant_loss(tp, tg, none)) == 0.0


def test_metrics_match_jax(x64):
    pred, gt, mask = _maps(seed=4)
    tp, tg, tm = (torch.from_numpy(a) for a in (pred, gt, mask))
    jp, jg, jm = (jnp.asarray(a) for a in (pred, gt, mask))
    np.testing.assert_allclose(float(metrics.mean_depth_error(tp, tg, tm)),
                               float(jax_metrics.mean_depth_error(jp, jg, jm)), rtol=1e-12)
    positive = np.abs(pred) + 0.1
    for name in ("depth_to_disparity", "disparity_to_depth", "lin_to_log_depths",
                 "log_to_lin_depths"):
        np.testing.assert_allclose(getattr(metrics, name)(torch.from_numpy(positive)).numpy(),
                                   np.asarray(getattr(jax_metrics, name)(jnp.asarray(positive))),
                                   rtol=1e-12, err_msg=name)
    for learn_on in ("LIN", "LOG", "DISP"):
        np.testing.assert_allclose(
            metrics.convert_to_lin(torch.from_numpy(positive), learn_on).numpy(),
            np.asarray(jax_metrics.convert_to_lin(jnp.asarray(positive), learn_on)),
            rtol=1e-12, err_msg=learn_on)
    with pytest.raises(ValueError):
        metrics.convert_to_lin(tp, "INV")
    assert metrics.DISPARITY_MULTIPLIER == jax_metrics.DISPARITY_MULTIPLIER == 7.0
    assert metrics.FOCAL_LENGTH_X_BASELINE == jax_metrics.FOCAL_LENGTH_X_BASELINE
