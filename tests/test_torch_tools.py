"""The port's tooling against the JAX package's, on the CPU.

- ``params_to_torch_state_dict`` and ``ann_params_to_torch_state_dict``
  against the JAX exports of the same names for the same weights: the
  same keys in the same order (the PLIF nodes last, in any order), shapes
  (OIHW, 0-dim PLIF ``w``), dtypes and values bit for bit, with and
  without cut-predict heads and learnable scales; each export loads back
  through the port's ``load_torch_checkpoint`` /
  ``load_torch_ann_checkpoint`` bit for bit.
- ``cli export-pth`` of a port checkpoint (flagship and ANN) writes the
  JAX export of the checkpoint's weights, bit for bit.
- ``cli doctor`` without a card: exit 2, ``"ok": false``, the missing card
  named; ``_run_with_timeout`` bounds a hang and reports an exception.
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from stereospike_tpu.interop import (
    ann_params_to_torch_state_dict as jax_ann_params_to_torch_state_dict,
)
from stereospike_tpu.interop import params_to_torch_state_dict as jax_params_to_torch_state_dict
from stereospike_tpu_torch import cli
from stereospike_tpu_torch.doctor import _run_with_timeout
from stereospike_tpu_torch.interop import (
    ann_params_to_jax,
    ann_params_to_torch_state_dict,
    load_torch_ann_checkpoint,
    load_torch_checkpoint,
    params_to_jax,
    params_to_torch_state_dict,
)
from stereospike_tpu_torch.models import factory
from stereospike_tpu_torch.models.ann import AnnConfig, init_ann_params, init_ann_state
from stereospike_tpu_torch.models.stereospike import init_params
from stereospike_tpu_torch.train.ann_steps import create_ann_train_state
from stereospike_tpu_torch.train.checkpoint import save_checkpoint
from stereospike_tpu_torch.train.state import create_train_state, make_optimizer

HW = (32, 44)


def _assert_same_export(ours, theirs):
    """Same keys, in the same order up to the PLIF nodes (which the JAX
    export writes in the order of its tree's ``plif`` dict), same dtypes,
    shapes and values."""
    assert set(ours) == set(theirs)
    assert ([k for k in ours if not k.endswith(".w")]
            == [k for k in theirs if not k.endswith(".w")])
    for k, want in theirs.items():
        want = np.asarray(want)
        got = ours[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def _config(name, learnable):
    cfg = getattr(factory, name)(in_hw=HW, base_channels=8)
    if learnable:
        cfg = dataclasses.replace(cfg, learnable_multiply=True, multiply_factor=10.0)
    return cfg


@pytest.mark.parametrize("name,learnable", [
    ("stereospike", False), ("stereospike_tempo", False), ("stereospike_tempo", True),
    ("stereospike_cutpredict", False), ("stereospike_cutpredict", True)])
def test_params_to_torch_state_dict_matches_jax(name, learnable, tmp_path):
    tcfg = _config(name, learnable)
    params = init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    sd = params_to_torch_state_dict(params)
    _assert_same_export(sd, jax_params_to_torch_state_dict(params_to_jax(params, tcfg)))
    if tcfg.site_neuron("bottom") == "plif":
        assert sd["bottom.2.w"].shape == ()
    if 4 not in tcfg.heads:  # the head the reference class defines but never calls
        assert not sd["predict_depth4.0.up.1.weight"].any()
    path = str(tmp_path / "w.pth")
    torch.save(sd, path)
    back = load_torch_checkpoint(path, tcfg, device="cpu")
    assert back.keys() == params.keys()
    for k, v in params.items():
        assert torch.equal(back[k], v), k


def test_ann_params_to_torch_state_dict_matches_jax(tmp_path):
    cfg = AnnConfig(in_hw=HW, base_channels=8)
    params = init_ann_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    # running statistics that moved
    bn_state = {k: v + 0.25 for k, v in init_ann_state(cfg, device="cpu").items()}
    sd = ann_params_to_torch_state_dict(params, bn_state)
    _assert_same_export(sd, jax_ann_params_to_torch_state_dict(*ann_params_to_jax(params,
                                                                                  bn_state)))
    path = str(tmp_path / "ann.pth")
    torch.save(sd, path)
    back_p, back_bn = load_torch_ann_checkpoint(path, cfg, device="cpu")
    for ours, back in ((params, back_p), (bn_state, back_bn)):
        assert back.keys() == ours.keys()
        assert all(torch.equal(back[k], v) for k, v in ours.items())


@pytest.mark.parametrize("model", ["stereospike", "ann_sigmoid"])
def test_cli_export_pth_writes_the_jax_export_of_the_checkpoint(model, tmp_path, capsys):
    """A checkpoint of weights other than the fresh init (``--seed 5`` would
    make those), exported by ``cli export-pth``: the JAX export of the same
    weights, bit for bit."""
    ckpt, out = str(tmp_path / "run"), str(tmp_path / "out.pth")
    tx = make_optimizer(1e-3)
    gen = torch.Generator().manual_seed(11)
    if model == "ann_sigmoid":
        cfg = AnnConfig(in_hw=HW)
        params, bn_state = init_ann_params(gen, cfg, device="cpu"), init_ann_state(cfg,
                                                                                   device="cpu")
        bn_state = {k: v + 0.5 for k, v in bn_state.items()}
        state = create_ann_train_state(params, bn_state, tx)
        want = jax_ann_params_to_torch_state_dict(*ann_params_to_jax(params, bn_state))
    else:
        cfg = factory.stereospike(in_hw=HW)
        params = init_params(gen, cfg, device="cpu")
        state = create_train_state(params, tx, torch.Generator().manual_seed(1))
        want = jax_params_to_torch_state_dict(params_to_jax(params, cfg))
    save_checkpoint(ckpt, state, best=True)
    assert cli.main(["export-pth", "--device", "cpu", "--model", model, "--in-hw", "32,44",
                     "--seed", "5", "--checkpoint-dir", ckpt, "--out", out]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == {"exported": out, "n_tensors": len(want)}
    _assert_same_export(torch.load(out, weights_only=True), want)
    with pytest.raises(FileNotFoundError, match="random-init"):
        cli.main(["export-pth", "--device", "cpu", "--in-hw", "32,44", "--checkpoint-dir",
                  str(tmp_path / "absent"), "--out", out])


def test_cli_doctor_without_a_card_exits_2(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["doctor", "--data-root", str(tmp_path)]) == 2
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["ok"] is False and report["devices"] is None
    assert "no CUDA device" in report["device_error"]
    assert "device_roundtrip" not in report
    assert report["native_host_ops"]["ok"] is True
    assert report["data_root"] == {"path": str(tmp_path), "exists": True}
    assert set(report) >= {"nvcc", "fire_kernels", "host_cpu_count", "torch"}


def test_run_with_timeout_bounds_a_hang_and_reports_an_exception():
    t0 = time.perf_counter()
    res, err, secs = _run_with_timeout(lambda: time.sleep(60), 0.2)
    assert res is None and "timed out" in err and secs == 0.2
    assert time.perf_counter() - t0 < 5

    def boom():
        raise RuntimeError("no card")

    res, err, _ = _run_with_timeout(boom, 5.0)
    assert res is None and err == "RuntimeError: no card"
    res, err, _ = _run_with_timeout(lambda: 3, 5.0)
    assert (res, err) == (3, None)
