"""Portable serving artifacts: the serving step as one file (counterpart of
``stereospike_tpu/deploy.py``).

The whole per-window serving computation of a
:class:`~stereospike_tpu_torch.streaming.StreamingEvaluator` (per-eye
rectification, voxelization, the stateful spiking forward, with the
weights baked in as constants) is exported once with :mod:`torch.export`
and saved with ``torch.export.save``. The fire kernel is in the program as
the registered op ``stereospike::fire_fwd``
(:mod:`stereospike_tpu_torch.snn.cuda_kernels`).

To load and run, an artifact needs ``torch`` and that one module of this
package, which registers the op (and builds ``csrc/fire_fwd.cu`` at the
first CUDA call): none of the model, nn, data or training code. That is
where it differs from the JAX artifact, which needs only ``jax``: an
exported program that calls a custom op needs the op's registration.

An artifact runs on the device it was exported for, recorded under
``platforms`` in the manifest: a ``cuda`` artifact only on a CUDA card
(its weights and its program live there), a ``cpu`` one on the CPU.

Container format (``.ssx``): a zip holding ``manifest.json`` (window
geometry, the calling convention, the state's names, shapes and dtype) and
``step.pt2`` (the serving step ``(state, events, valids) -> (depth,
new_state, rejected)``).

CLI: ``python -m stereospike_tpu_torch.cli export-serving --out model.ssx``.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Dict, Optional, Tuple

import torch

from stereospike_tpu_torch.snn import cuda_kernels  # noqa: F401  registers stereospike::fire_fwd

MANIFEST = "manifest.json"
STEP_PT2 = "step.pt2"
FORMAT_VERSION = 1


def export_serving_artifact(evaluator, path: str, *,
                            extra_meta: Optional[dict] = None) -> dict:
    """Export a live :class:`~stereospike_tpu_torch.streaming.StreamingEvaluator`'s
    serving step (weights baked in) to ``path``, for the evaluator's device.
    Returns the manifest."""
    from stereospike_tpu_torch.nn import layers

    s, block, dev = evaluator.n_streams, evaluator.block, evaluator.device
    eyes = list(evaluator.eyes)
    state = evaluator.init_state()
    events = {e: torch.zeros(s, block, 4, dtype=torch.float32, device=dev) for e in eyes}
    valids = {e: torch.zeros(s, block, dtype=torch.bool, device=dev) for e in eyes}
    with torch.no_grad():
        program = torch.export.export(evaluator.step, (state, events, valids), strict=False)
    # an index cached while tracing holds a FakeTensor: drop them all
    layers._nearest_index.cache_clear()
    # the example inputs (a zero state of every site at B = S, the padded
    # blocks) would be saved beside the weights: they are not needed to run
    program.example_inputs = None
    dtype = str(evaluator.compute_dtype).removeprefix("torch.")
    manifest = {
        "format_version": FORMAT_VERSION,
        "platforms": [dev.type],
        "eyes": eyes,
        "n_streams": s,
        "block": block,
        "window_s": evaluator.window,
        "nfpdm": evaluator.nfpdm,
        "in_hw": list(evaluator.cfg.in_hw),
        "compute_dtype": dtype,
        "state": [[name, list(t.shape)] for name, t in state.items()],
        "calling_convention": {
            "step": "(state, events, valids) -> (depth_f32, new_state, rejected_events)",
            "events": f"{{eye: float32[{s}, {block}, 4] (x, y, t_rel, p), zero-padded}}",
            "valids": f"{{eye: bool[{s}, {block}]}}",
            "state": f"{{name: {dtype}[shape]}} in the manifest's order, zeros at the start",
            "note": "event timestamps are window-relative seconds; rectification (if maps "
                    "were configured) is inside; every tensor on the platform's device",
        },
        **(extra_meta or {}),
    }
    buf = io.BytesIO()
    torch.export.save(program, buf)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with zipfile.ZipFile(path, "w") as z:
        z.writestr(MANIFEST, json.dumps(manifest, indent=2), compress_type=zipfile.ZIP_DEFLATED)
        z.writestr(STEP_PT2, buf.getvalue())  # stored: the weights do not deflate
    return manifest


class ServingArtifact:
    """A loaded ``.ssx`` serving artifact. ``step`` chains membrane state
    explicitly:

    >>> art = ServingArtifact.load("model.ssx")
    >>> state = art.init_state()
    >>> depth, state, rejected = art.step(state, events, valids)
    """

    def __init__(self, meta: dict, program):
        self.meta = meta
        self.program = program
        self._module = program.module()
        self.device = torch.device(meta["platforms"][0])
        self.compute_dtype = getattr(torch, meta["compute_dtype"])

    @classmethod
    def load(cls, path: str) -> "ServingArtifact":
        with zipfile.ZipFile(path) as z:
            meta = json.loads(z.read(MANIFEST))
            if meta.get("format_version") != FORMAT_VERSION:
                raise ValueError(f"unsupported artifact version {meta.get('format_version')}"
                                 f" (loader speaks {FORMAT_VERSION})")
            platform = meta["platforms"][0]
            if platform == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"{path} was exported for cuda and runs only on a CUDA "
                                   "card; export it with --device cpu to serve on the CPU")
            program = torch.export.load(io.BytesIO(z.read(STEP_PT2)))
        return cls(meta, program)

    def init_state(self) -> Dict[str, torch.Tensor]:
        """Fresh zero membrane state (names, shapes and dtype from the manifest)."""
        return {name: torch.zeros(shape, dtype=self.compute_dtype, device=self.device)
                for name, shape in self.meta["state"]}

    def step(self, state: Dict[str, torch.Tensor], events: Dict[str, torch.Tensor],
             valids: Dict[str, torch.Tensor]) -> Tuple:
        """One serving step: ``(depth [S,H,W,1] f32, new_state, rejected)``.
        ``events``/``valids`` follow ``meta['calling_convention']``."""
        if self.device.type == "cuda" and self.compute_dtype == torch.float32:
            # the live step's float32 convs run in true float32 (nn/layers.py::conv2d)
            torch.backends.cudnn.allow_tf32 = False
        with torch.no_grad():
            return self._module(state, events, valids)


def load_serving_artifact(path: str) -> ServingArtifact:
    return ServingArtifact.load(path)
