"""The port's serving artifacts (``stereospike_tpu_torch/deploy.py``) and the
fire forward as the registered op ``stereospike::fire_fwd``, on the CPU.

An exported float64 artifact's step is held against the JAX evaluator's at
rtol 1e-9 (float64: no spike can flip under another summation order); a
float32 artifact against the port's live evaluator bit for bit, its
rejected-event count included.
"""

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereospike_tpu.models import factory as jax_factory
from stereospike_tpu.models.stereospike import init_params as jax_init_params
from stereospike_tpu.streaming import StreamingEvaluator as JaxEvaluator
from stereospike_tpu_torch import cli
from stereospike_tpu_torch.deploy import (
    FORMAT_VERSION,
    MANIFEST,
    ServingArtifact,
    export_serving_artifact,
    load_serving_artifact,
)
from stereospike_tpu_torch.interop import params_from_jax
from stereospike_tpu_torch.models import factory
from stereospike_tpu_torch.snn import cuda_kernels
from stereospike_tpu_torch.streaming import StreamingEvaluator

HW = (32, 44)
BLOCK = 1024
KW = dict(in_hw=HW, base_channels=8)


def _maps(seed):
    rng = np.random.default_rng(seed)
    return {e: ((np.arange(HW[1])[None, :] + rng.normal(0, 1.5, HW)).astype(np.float32),
                (np.arange(HW[0])[:, None] + rng.normal(0, 1.5, HW)).astype(np.float32))
            for e in ("left", "right")}


def _events(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(-2, HW[1] + 2, n), rng.integers(-2, HW[0] + 2, n),
                     np.sort(rng.uniform(-0.01, 0.05, n)), rng.choice([0.0, 1.0], n)],
                    axis=1).astype(np.float32)


def _window(i, streams=1):
    return [{"left": _events(700, 10 * i + 2 * s), "right": _events(700, 10 * i + 2 * s + 1)}
            for s in range(streams)]


def _padded(wins, eyes=("left", "right")):
    """A window's ``(events, valids)`` as the calling convention has them."""
    events, valids = {}, {}
    for e in eyes:
        ev = np.zeros((len(wins), BLOCK, 4), np.float32)
        ok = np.zeros((len(wins), BLOCK), bool)
        for s, w in enumerate(wins):
            ev[s, :len(w[e])] = w[e]
            ok[s, :len(w[e])] = True
        events[e], valids[e] = ev, ok
    return events, valids


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = jax_factory.stereospike(**KW), factory.stereospike(**KW)
    jparams = jax_init_params(jax.random.PRNGKey(3), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                                device="cpu")


@pytest.fixture(scope="module")
def artifacts(weights, tmp_path_factory):
    """float64 with maps, float32 with maps, bfloat16 at two streams."""
    _, tcfg, _, params = weights
    root = tmp_path_factory.mktemp("ssx")
    out = {}
    for name, dtype, streams in (("f64", torch.float64, 1), ("f32", torch.float32, 1),
                                 ("bf16", torch.bfloat16, 2)):
        live = StreamingEvaluator(params, tcfg, maps=_maps(1), block=BLOCK, n_streams=streams,
                                  reset_each_window=False, compute_dtype=dtype, device="cpu")
        path = str(root / f"{name}.ssx")
        manifest = export_serving_artifact(live, path, extra_meta={"model": "stereospike"})
        out[name] = (live, path, manifest)
    return out


def test_float64_artifact_step_matches_jax(weights, artifacts):
    """Three windows through the exported step, membranes chained by hand,
    against the JAX evaluator's jitted step (x64) on the same weights and
    maps: depth at rtol 1e-9, the rejected count exactly."""
    jcfg, _, jparams, _ = weights
    jax.config.update("jax_enable_x64", True)
    try:
        theirs = JaxEvaluator(jparams, jcfg, maps=_maps(1), block=BLOCK,
                              reset_each_window=False, compute_dtype=jnp.float64)
        art = load_serving_artifact(artifacts["f64"][1])
        state, jstate = art.init_state(), theirs._init_state()
        for i in range(3):
            events, valids = _padded(_window(i))
            depth, state, rejected = art.step(
                state, {e: torch.from_numpy(v) for e, v in events.items()},
                {e: torch.from_numpy(v) for e, v in valids.items()})
            jdepth, jstate, jrejected = theirs._step(
                theirs.params, jstate, {e: jnp.asarray(v) for e, v in events.items()},
                {e: jnp.asarray(v) for e, v in valids.items()})
            assert depth.dtype == torch.float32 and depth.shape == (1, *HW, 1)
            np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), rtol=1e-9,
                                       atol=1e-12)
            assert float(rejected) == float(jrejected) > 0
    finally:
        jax.config.update("jax_enable_x64", False)


def test_float32_artifact_equals_live_evaluator(artifacts):
    """The exported step equals the live step bit for bit, rejected count
    and state included; ``from_artifact`` pushes equal live pushes
    (pipelined, state carried), and ``reset`` goes back to zero membranes."""
    live, path, manifest = artifacts["f32"]
    art = load_serving_artifact(path)
    state, live_state = art.init_state(), live.init_state()
    assert list(state) == list(live_state) == [n for n, _ in manifest["state"]]
    for i in range(2):
        events, valids = _padded(_window(i))
        ev = {e: torch.from_numpy(v) for e, v in events.items()}
        ok = {e: torch.from_numpy(v) for e, v in valids.items()}
        got = art.step(state, ev, ok)
        want = live.step(live_state, ev, ok)
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
        assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])
        state, live_state = got[1], want[1]

    served = StreamingEvaluator.from_artifact(path, pipeline=1, reset_each_window=False)
    assert served.artifact.meta == manifest and served.n_streams == 1
    assert (served.window, served.block, served.eyes) == (0.05, BLOCK, ("left", "right"))
    live.reset()
    live.pipeline = 1
    got, want = [], []
    for i in range(3):
        got.append(served.push(_window(i)[0]))
        want.append(live.push(_window(i)[0]))
    got.append(served.flush())
    want.append(live.flush())
    assert got[0] is None and want[0] is None
    for d, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(d, w)
    assert served.binning_dropped == live.binning_dropped > 0
    served.reset()
    assert all(not v.any() for v in served._state.values())


def test_bf16_two_stream_artifact_shapes_and_dtypes(artifacts):
    live, path, manifest = artifacts["bf16"]
    assert manifest["compute_dtype"] == "bfloat16" and manifest["n_streams"] == 2
    served = StreamingEvaluator.from_artifact(path)
    assert served.compute_dtype == torch.bfloat16
    depth = served.push(_window(0, streams=2))
    assert depth.shape == (2, *HW, 1) and depth.dtype == np.float32
    assert np.isfinite(depth).all()
    assert all(v.dtype == torch.bfloat16 and v.shape[0] == 2 for v in served._state.values())
    np.testing.assert_array_equal(depth, live.push(_window(0, streams=2)))
    with pytest.raises(ValueError, match="evaluator serves 2 streams"):
        served.push(_window(0)[0])


def test_manifest_version_guard_and_platform(artifacts, tmp_path):
    _, path, manifest = artifacts["f32"]
    assert manifest["platforms"] == ["cpu"] and manifest["format_version"] == FORMAT_VERSION
    for key in ("eyes", "n_streams", "block", "window_s", "nfpdm", "in_hw", "compute_dtype",
                "calling_convention"):
        assert key in manifest
    with zipfile.ZipFile(path) as z:
        members = {n: z.read(n) for n in z.namelist()}

    def rewritten(name, **changes):
        out = tmp_path / name
        with zipfile.ZipFile(out, "w") as z:
            for n, data in members.items():
                if n == MANIFEST:
                    data = json.dumps({**json.loads(data), **changes})
                z.writestr(n, data)
        return str(out)

    with pytest.raises(ValueError, match="unsupported artifact version 2"):
        ServingArtifact.load(rewritten("v2.ssx", format_version=FORMAT_VERSION + 1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="exported for cuda"):
            load_serving_artifact(rewritten("cuda.ssx", platforms=["cuda"]))


def test_cli_export_serving_then_stream_artifact(tmp_path, capsys, monkeypatch):
    """``export-serving`` from a ``.pth`` (and its refusals), then ``stream
    --artifact``, which serves with the artifact's geometry; a multi-stream
    artifact is refused by the single-camera driver. The loop builds the
    flagship at base_channels=8 (``TrainConfig`` has no width field)."""
    import dataclasses

    from stereospike_tpu_torch.models.stereospike import init_params
    from stereospike_tpu_torch.train import loop
    from stereospike_tpu_torch.train.config import TrainConfig

    build = loop.build_model_config
    monkeypatch.setattr(loop, "build_model_config",
                        lambda cfg: dataclasses.replace(build(cfg), base_channels=8))
    build_model_config, stream_loop = loop.build_model_config, loop.stream_loop

    hw = "16,24"
    params = init_params(torch.Generator().manual_seed(4),
                         build_model_config(TrainConfig(in_hw=(16, 24))), device="cpu")
    torch.save(params, tmp_path / "w.pth")
    common = ["--device", "cpu", "--in-hw", hw, "--tensorboard", "false",
              "--checkpoint-dir", str(tmp_path / "run")]
    with pytest.raises(FileNotFoundError, match="refusing to export"):
        cli.main(["export-serving", "--out", str(tmp_path / "x.ssx"), *common])
    with pytest.raises(ValueError, match="ANN"):
        cli.main(["export-serving", "--out", str(tmp_path / "x.ssx"), "--model", "ann",
                  *common])
    out = str(tmp_path / "m.ssx")
    assert cli.main(["export-serving", "--out", out, "--block", "2048", "--window-s", "0.04",
                     "--import-pth", str(tmp_path / "w.pth"), *common]) == 0
    exported = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert exported["platforms"] == ["cpu"] and exported["block"] == 2048
    weight_bytes = 4 * sum(p.numel() for p in params.values())
    assert weight_bytes < exported["bytes"] < weight_bytes + (1 << 20)  # weights, no inputs
    assert cli.main(["stream", "--artifact", out, "--synthetic", "--n-windows", "3",
                     "--events-per-window", "300", *common]) == 0
    served = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the synthetic windows take the artifact's 40 ms: every event is binned
    assert served["n_windows"] == 3 and served["binned_out_events"] == 0

    two = str(tmp_path / "two.ssx")
    assert cli.main(["export-serving", "--out", two, "--n-streams", "2", "--block", "256",
                     "--import-pth", str(tmp_path / "w.pth"), *common]) == 0
    with pytest.raises(ValueError, match="n_streams=2"):
        stream_loop(TrainConfig(in_hw=(16, 24), tensorboard=False,
                                checkpoint_dir=str(tmp_path / "run")),
                    artifact=two, synthetic=True, device="cpu")


@pytest.mark.parametrize("neuron", ["if", "plif_soft"])
def test_fire_op_opcheck(neuron):
    """``torch.library.opcheck`` of ``stereospike::fire_fwd`` on CPU inputs:
    schema, fake shapes and dtypes against the real kernel (the plain
    version on the CPU), and that ``multistep_fire`` goes through it."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 257)).astype(np.float32))
    v0 = torch.from_numpy(rng.uniform(0, 0.5, 257).astype(np.float32))
    args = ((x, v0, None, 1.0, 0.0, True) if neuron == "if"
            else (x, v0, torch.tensor([0.4]), 1.0, None, False))
    torch.library.opcheck(cuda_kernels.fire_fwd_op, args)
    spikes, v_t = torch.ops.stereospike.fire_fwd(*args)
    want = cuda_kernels.multistep_fire(x, v0, args[2], v_reset=args[4], is_if=args[5])
    assert torch.equal(spikes, want[0]) and torch.equal(v_t, want[1])
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode()
    fx, fv0 = mode.from_tensor(x.bfloat16()), mode.from_tensor(v0.bfloat16())
    with mode:
        fs, fv = cuda_kernels.fire_fwd_op(fx, fv0, None, 1.0, 0.0, True)
    assert (fs.shape, fs.dtype, fv.shape, fv.dtype) == ((3, 257), torch.bfloat16, (257,),
                                                        torch.bfloat16)
