"""The port's augmentation (``stereospike_tpu_torch/data/augmentation.py``)
against the JAX package's, on the CPU.

The two packages draw from different random streams, so each transform is
fed the draws JAX made (its flags, drop rates ``q`` and keep masks, taken
from the same keys and splits as the JAX transform takes them) and must
then give JAX's batch exactly: the flips, the time mirror with the warmup
split and the ``gt ↔ init_pots`` / ``mask ↔ init_mask`` swap, the event
drop, and JAX's ``augment_batch`` through the port's transforms in the
port's order. Then the port's own draws: ``augment_batch`` is that
composition over the draws its generators give, ``time_mirror_flags``
reads those flags without advancing the generator, and the host-swap input
path (labels swapped on the host, ``init_pots`` never uploaded) gives
exactly the all-device path's batch.
"""

import jax
import numpy as np
import pytest
import torch

from stereospike_tpu.data import augmentation as jax_aug
from stereospike_tpu_torch.data import augmentation as aug

B, T, TW, HW, EYES, PER_EYE = 4, 2, 2, (10, 14), 2, 4


def _batch(seed, warmup=True):
    rng = np.random.default_rng(seed)
    c = EYES * PER_EYE
    b = {"chunks": rng.integers(0, 5, (B, T, *HW, c)).astype(np.uint8),
         "gt": rng.uniform(0.5, 9.0, (B, *HW, 1)).astype(np.float32),
         "mask": rng.random((B, *HW, 1)) < 0.7,
         "init_pots": rng.uniform(0.5, 9.0, (B, *HW, 1)).astype(np.float32),
         "init_mask": rng.random((B, *HW, 1)) < 0.6}
    if warmup:
        b["warmup"] = rng.integers(0, 5, (B, TW, *HW, c)).astype(np.uint8)
    return b


def _torch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _assert_equal(ours, theirs):
    assert set(ours) == set(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]), err_msg=k)
        assert ours[k].numpy().dtype == np.asarray(theirs[k]).dtype, k


def _flags(key, p):
    return torch.from_numpy(np.array(jax.random.uniform(key, (B,)) < p))


@pytest.mark.parametrize("which", ["horizontal", "vertical"])
def test_flips_match_jax(which):
    batch = _batch(0)
    key = jax.random.PRNGKey(1)
    fn = {"horizontal": (jax_aug.random_horizontal_flip, aug.random_horizontal_flip),
          "vertical": (jax_aug.random_vertical_flip, aug.random_vertical_flip)}[which]
    theirs = fn[0](key, batch, 0.5)
    flag = _flags(key, 0.5)
    assert 0 < int(flag.sum()) < B
    _assert_equal(fn[1](_torch(batch), flag=flag), theirs)


@pytest.mark.parametrize("warmup", [True, False], ids=["warmup", "no_warmup"])
def test_time_mirror_matches_jax(warmup):
    batch = _batch(2, warmup)
    key = jax.random.PRNGKey(3)
    theirs = jax_aug.random_time_mirror(key, batch, 0.5, EYES)
    flag = _flags(key, 0.5)
    assert 0 < int(flag.sum()) < B
    ours = aug.random_time_mirror(_torch(batch), 0.5, EYES, flag=flag)
    _assert_equal(ours, theirs)
    # the swap of the labels carried their masks
    i = int(torch.nonzero(flag)[0])
    np.testing.assert_array_equal(ours["mask"][i].numpy(), batch["init_mask"][i])
    with pytest.raises(ValueError, match="init_mask"):
        aug.random_time_mirror({k: v for k, v in _torch(batch).items() if k != "init_mask"},
                               flag=flag)


def _jax_drop_draws(key, batch, p, lo, hi):
    """The flag, q and keep masks ``random_event_drop`` draws from ``key``."""
    k_apply, k_q, k_mask, k_warm = jax.random.split(key, 4)
    flag = jax.random.uniform(k_apply, (B,)) < p
    q = jax.random.uniform(k_q, (B,), minval=lo, maxval=hi)

    def keep(k, x):
        return jax.random.uniform(k, x.shape) > q.reshape((-1,) + (1,) * (x.ndim - 1))

    out = [torch.from_numpy(np.array(a)) for a in (flag, q, keep(k_mask, batch["chunks"]))]
    out.append(torch.from_numpy(np.array(keep(k_warm, batch["warmup"])))
               if "warmup" in batch else None)
    return out


def test_event_drop_matches_jax():
    batch = _batch(4)
    key = jax.random.PRNGKey(5)
    theirs = jax_aug.random_event_drop(key, batch, 0.5, 0.1, 0.6)
    flag, q, keep, keep_w = _jax_drop_draws(key, batch, 0.5, 0.1, 0.6)
    assert 0 < int(flag.sum()) < B
    ours = aug.random_event_drop(_torch(batch), flag=flag, q=q, keep=keep, keep_warmup=keep_w)
    _assert_equal(ours, theirs)
    assert int((ours["chunks"] != _torch(batch)["chunks"]).sum()) > 0


@pytest.mark.parametrize("seed", [6, 7])
def test_augment_batch_matches_jax_given_its_draws(seed):
    """JAX's ``augment_batch`` equals the port's transforms in the port's
    order, each fed the draws JAX's key split gives it."""
    batch = _batch(seed)
    cfg = aug.AugmentConfig(vflip_p=0.5)
    jcfg = jax_aug.AugmentConfig(vflip_p=0.5)
    key = jax.random.PRNGKey(seed)
    theirs = jax_aug.augment_batch(key, batch, jcfg)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    flag4, q, keep, keep_w = _jax_drop_draws(k4, batch, cfg.event_drop_p, cfg.min_drop_rate,
                                             cfg.max_drop_rate)
    ours = aug.random_horizontal_flip(_torch(batch), flag=_flags(k1, cfg.hflip_p))
    ours = aug.random_vertical_flip(ours, flag=_flags(k2, cfg.vflip_p))
    ours = aug.random_time_mirror(ours, eyes=EYES, flag=_flags(k3, cfg.time_mirror_p))
    ours = aug.random_event_drop(ours, flag=flag4, q=q, keep=keep, keep_warmup=keep_w)
    _assert_equal(ours, theirs)


def _generators(seed):
    return torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed + 1)


def test_augment_batch_is_the_composition_over_its_draws():
    batch = _torch(_batch(8))
    cfg = aug.AugmentConfig(vflip_p=0.5)
    g, dg = _generators(9)
    ours = aug.augment_batch(batch, cfg, generator=g, device_generator=dg)
    g, dg = _generators(9)
    u = torch.rand((5, B), generator=g)
    q = cfg.min_drop_rate + u[4] * (cfg.max_drop_rate - cfg.min_drop_rate)
    keep = torch.rand(batch["chunks"].shape, generator=dg) > q.view(-1, 1, 1, 1, 1)
    keep_w = torch.rand(batch["warmup"].shape, generator=dg) > q.view(-1, 1, 1, 1, 1)
    want = aug.random_horizontal_flip(batch, flag=u[0] < cfg.hflip_p)
    want = aug.random_vertical_flip(want, flag=u[1] < cfg.vflip_p)
    want = aug.random_time_mirror(want, eyes=cfg.eyes, flag=u[2] < cfg.time_mirror_p)
    want = aug.random_event_drop(want, flag=u[3] < cfg.event_drop_p, q=q, keep=keep,
                                 keep_warmup=keep_w)
    for k in want:
        assert torch.equal(ours[k], want[k]), k
    # burning one call's draws leaves the generators where the call left them
    g2, dg2 = _generators(9)
    aug.burn_augment_draws(B, batch["chunks"].shape, batch["warmup"].shape, g2, dg2,
                           torch.device("cpu"))
    assert torch.equal(g2.get_state(), g.get_state())
    assert torch.equal(dg2.get_state(), dg.get_state())


@pytest.mark.parametrize("warmup", [True, False], ids=["warmup", "no_warmup"])
def test_host_swap_path_equals_all_device_path(warmup):
    host = _batch(10, warmup)
    cfg = aug.AugmentConfig()
    g, dg = _generators(11)
    all_device = aug.augment_batch(_torch(host), cfg, generator=g, device_generator=dg)

    g, dg = _generators(11)
    before = g.get_state()
    flags = aug.time_mirror_flags(g, B, cfg)
    assert torch.equal(g.get_state(), before)  # a peek: the generator did not move
    assert 0 < int(flags.sum()) < B
    f = flags.numpy().reshape(-1, 1, 1, 1)
    swapped = dict(host, gt=np.where(f, host["init_pots"], host["gt"]),
                   mask=np.where(f, host["init_mask"], host["mask"]))
    keys = ["chunks", "gt", "mask"] + (["warmup"] if warmup else [])
    uploaded = {k: torch.from_numpy(swapped[k].copy()) for k in keys}
    host_swap = aug.augment_batch(uploaded, cfg, generator=g, device_generator=dg,
                                  mirror_flag=flags)
    for k in keys:
        assert torch.equal(host_swap[k], all_device[k]), k
