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
    "cli", "data.synthetic", "data.voxelizer", "interop", "models.factory",
    "models.stereospike", "nn.blocks", "nn.layers", "objectives.losses",
    "objectives.metrics", "snn.cuda_kernels", "snn.neurons", "snn.surrogate", "sources",
    "streaming", "train.config", "train.loop", "train.state", "train.steps",
    "utils.logging",
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
