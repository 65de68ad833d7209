"""PyTorch/CUDA port of stereospike_tpu for NVIDIA Hopper (H100).

A second package beside the JAX one, held against it by the tests
(``tests/test_torch_*.py``). It imports ``torch``, numpy and the standard
library only — never ``jax`` and nothing of ``stereospike_tpu``; h5py only
inside the one function that opens an ``.hdf5`` file, and tensorboard only
where it is installed. Module
names mirror the JAX package so each counterpart is easy to find.

Ported paths. Serving: ``python -m stereospike_tpu_torch.cli stream``
feeds event windows (synthetic, a live TCP feed, an AEDAT 3.1 recording or
a DENSE directory, ``sources.py``) through
:class:`~stereospike_tpu_torch.streaming.StreamingEvaluator`, which
voxelizes on the device and runs one stateful step of the StereoSpike
forward per window, for one camera or ``n_streams`` in one batch, from a
checkpoint or a ``.pth``; ``deploy.py`` exports that step as a
self-contained ``.ssx`` artifact (``torch.export``), which
``StreamingEvaluator.from_artifact`` serves. Training: ``train/steps.py::make_train_step`` runs
forward, total loss, BPTT and Adam on a batch (``data/synthetic.py``),
step-major or, with ``multistep=True``, layer-major over T
(``models/multistep.py``); ``make_eval_step`` gives per-sample statistics
without a graph; ``models/stereospike.py::firing_rates_sequence`` the
per-tap spike densities. The equivalent ANN baseline: ``models/ann.py``
and ``train/ann_steps.py``. Drivers: ``python -m stereospike_tpu_torch.cli
train|eval|firing-rates`` (``train/loop.py``) over the MVSEC and DENSE data
pipelines (``data/``, with the native host ops of ``native/``), with
augmentation, packed and prefetched uploads, and checkpoints
(``train/checkpoint.py``) that resume exactly. Every spiking site goes
through the hand-written Hopper fire kernels (``csrc/fire_fwd.cu`` and, under
autograd, ``csrc/fire_bwd.cu``, bound in ``snn/cuda_kernels.py``). Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

# the serving surface, imported on first use: importing the package (as
# loading an artifact does, for snn.cuda_kernels) pulls in no model code
_EXPORTS = {
    "StreamingEvaluator": "stereospike_tpu_torch.streaming",
    "ServingStep": "stereospike_tpu_torch.streaming",
    "EventRingBuffer": "stereospike_tpu_torch.streaming",
    "ServingArtifact": "stereospike_tpu_torch.deploy",
    "export_serving_artifact": "stereospike_tpu_torch.deploy",
    "load_serving_artifact": "stereospike_tpu_torch.deploy",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
