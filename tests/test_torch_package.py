"""The PyTorch port stands alone: it imports neither ``jax`` nor the JAX
package, nor does ``chip_smoke.py``; and serving never falls back to the
CPU by itself."""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import stereospike_tpu_torch
from stereospike_tpu_torch.models import factory
from stereospike_tpu_torch.models.stereospike import init_params
from stereospike_tpu_torch.streaming import StreamingEvaluator

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "stereospike_tpu")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(stereospike_tpu_torch.__path__,
                                                        "stereospike_tpu_torch."))


# every module of the port so far; a new one is added here as it is ported
PORTED = (
    "cli", "data.augmentation", "data.dense", "data.fixtures", "data.mvsec", "data.packing",
    "data.synthetic", "data.voxelizer", "deploy", "doctor", "interop", "models.ann",
    "models.factory", "models.multistep", "models.stereospike", "native", "nn.blocks",
    "nn.layers", "objectives.losses", "objectives.metrics", "parallel", "parallel.collectives",
    "parallel.mesh", "snn.cuda_kernels", "snn.neurons",
    "snn.surrogate", "sources", "streaming", "train.ann_steps", "train.checkpoint",
    "train.config", "train.loop", "train.state", "train.steps", "utils.logging",
    "utils.profiling",
)


def test_package_imports_no_jax():
    mods = ["stereospike_tpu_torch", *_modules()]
    missing = sorted(f"stereospike_tpu_torch.{m}" for m in PORTED
                     if f"stereospike_tpu_torch.{m}" not in mods)
    assert not missing, missing
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    loaded = set(json.loads(out.strip().splitlines()[-1]))
    bad = sorted(m for m in loaded if m.split(".")[0] in FORBIDDEN)
    assert not bad, bad


def _imported_roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", ["chip_smoke.py", *[
    str(p.relative_to(ROOT)) for p in sorted((ROOT / "stereospike_tpu_torch").rglob("*.py"))]])
def test_sources_import_no_jax(path):
    roots = _imported_roots(ROOT / path)
    assert not roots & set(FORBIDDEN), (path, roots & set(FORBIDDEN))


def _module_level_imports(path: Path):
    """Roots imported by statements outside any function or class."""
    roots = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", ["chip_smoke.py", *[
    str(p.relative_to(ROOT)) for p in sorted((ROOT / "stereospike_tpu_torch").rglob("*.py"))]])
def test_h5py_only_inside_the_hdf5_reader(path):
    """h5py is imported by no module at import time, and inside one
    function only: ``data/mvsec.py::_open_hdf5``."""
    tree = ast.parse((ROOT / path).read_text())
    assert "h5py" not in _module_level_imports(ROOT / path)
    inside = {fn.name for fn in ast.walk(tree)
              if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
              for node in ast.walk(fn)
              if isinstance(node, ast.Import) and any(a.name == "h5py" for a in node.names)}
    assert inside == ({"_open_hdf5"} if path.endswith("data/mvsec.py") else set()), inside


def test_native_build_uses_the_ports_source_and_build_dir():
    from stereospike_tpu_torch import native

    assert native.SOURCE == ROOT / "stereospike_tpu_torch" / "native" / "host_ops.cpp"
    assert native.BUILD_DIR == ROOT / "build" / "stereospike_tpu_torch"
    lib = native.library_path()
    assert lib.parent == native.BUILD_DIR
    assert ROOT / "stereospike_tpu" / "native" not in (lib.parent, *lib.parents)
    assert native.build() == lib and lib.exists()


def test_chip_smoke_refuses_without_a_card():
    """No card, no result: a non-zero exit and no JSON result line."""
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a card")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_evaluator_needs_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a card")
    cfg = factory.stereospike(in_hw=(32, 44), base_channels=8)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingEvaluator(params, cfg)
    StreamingEvaluator(params, cfg, device="cpu")


def test_loading_an_artifact_imports_no_model_code(tmp_path):
    """A served artifact needs ``torch`` and ``snn.cuda_kernels`` (the op's
    registration): loading one and running its step imports no models, nn,
    train or data module of the port."""
    from stereospike_tpu_torch.deploy import export_serving_artifact

    cfg = factory.stereospike(in_hw=(16, 24), base_channels=4)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    path = tmp_path / "tiny.ssx"
    export_serving_artifact(StreamingEvaluator(params, cfg, block=64, device="cpu"), str(path))
    code = ("import json, sys, torch\n"
            "from stereospike_tpu_torch.deploy import load_serving_artifact\n"
            f"art = load_serving_artifact({str(path)!r})\n"
            "ev = {e: torch.zeros(1, 64, 4) for e in art.meta['eyes']}\n"
            "ok = {e: torch.ones(1, 64, dtype=torch.bool) for e in art.meta['eyes']}\n"
            "depth, state, rejected = art.step(art.init_state(), ev, ok)\n"
            "print(json.dumps([list(depth.shape), float(rejected), sorted(sys.modules)]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    shape, rejected, loaded = json.loads(out.strip().splitlines()[-1])
    assert shape == [1, 16, 24, 1] and rejected == 0.0
    ours = sorted(m for m in loaded if m.startswith("stereospike_tpu_torch."))
    assert ours == ["stereospike_tpu_torch.deploy", "stereospike_tpu_torch.snn",
                    "stereospike_tpu_torch.snn.cuda_kernels", "stereospike_tpu_torch.snn.neurons",
                    "stereospike_tpu_torch.snn.surrogate"], ours
    assert not [m for m in loaded if m.split(".")[0] in FORBIDDEN]
