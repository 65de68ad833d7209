"""Profiling and debugging hooks (counterpart of ``stereospike_tpu/utils/profiling.py``).

- :func:`trace_profile`: a ``torch.profiler`` context over the host and,
  when there is a card, the device, writing a Chrome trace into a directory;
- :func:`enable_nan_debugging`: autograd's anomaly mode, which raises at the
  operation whose backward produced a NaN.

The per-layer spike densities live on the model
(``models/stereospike.py::firing_rates_sequence``) and the CLI's
``firing-rates`` command.
"""

from __future__ import annotations

import contextlib
import os

import torch


def enable_nan_debugging(enable: bool = True) -> None:
    """Raise at the first NaN that autograd's backward produces."""
    torch.autograd.set_detect_anomaly(enable)


@contextlib.contextmanager
def trace_profile(log_dir: str):
    """``with trace_profile('prof') as prof: step(...)``: a torch.profiler
    trace of the block, saved as ``<log_dir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
