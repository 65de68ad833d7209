"""PyTorch/CUDA port of stereospike_tpu for NVIDIA Hopper (H100).

A second package beside the JAX one, held against it by the tests
(``tests/test_torch_*.py``). It imports ``torch``, numpy and the standard
library only — never ``jax`` and nothing of ``stereospike_tpu``. Module
names mirror the JAX package so each counterpart is easy to find.

Two paths are ported. Serving: ``python -m stereospike_tpu_torch.cli
stream --synthetic`` feeds synthetic event windows through
:class:`~stereospike_tpu_torch.streaming.StreamingEvaluator`, which
voxelizes on the device and runs one stateful step of the StereoSpike
forward per window. Training: ``train/steps.py::make_train_step`` runs
forward, total loss, BPTT and Adam on a batch (``data/synthetic.py``).
Every spiking site goes through the hand-written Hopper fire kernels
(``csrc/fire_fwd.cu`` and, under autograd, ``csrc/fire_bwd.cu``, bound in
``snn/cuda_kernels.py``). Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
