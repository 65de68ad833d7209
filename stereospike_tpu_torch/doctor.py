"""Environment diagnostics: ``python -m stereospike_tpu_torch.cli doctor``
(counterpart of ``stereospike_tpu/doctor.py``).

Training and serving on the card rest on a few parts that can each be
missing or stuck: the CUDA card itself, ``nvcc``, the build of the two
hand-written fire kernels (``csrc/fire_fwd.cu``, ``csrc/fire_bwd.cu``),
the native host ops (``native/host_ops.cpp``), the host's CPUs and the
data root. Each is probed with a timeout (a stuck driver or compiler gives
a report that says so, not a hung diagnostic), and the report is one JSON
object. ``ok`` is true only when a CUDA card answered a round trip: the
doctor never reports a CPU run as a healthy install. A timed-out probe
leaves its daemon thread behind, which the process exit ends.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, Optional, Tuple

# nvcc takes 26–43 s for both kernels on the card's machine
BUILD_TIMEOUT_S = 600.0


def _run_with_timeout(fn: Callable, timeout_s: float) -> Tuple[object, Optional[str], float]:
    """``(result, error, seconds)`` of ``fn()`` run in a daemon thread, so
    that a hung probe cannot hang the doctor; an exception becomes the
    error string."""
    out: Dict = {}

    def body():
        t0 = time.perf_counter()
        try:
            out["result"] = fn()
        except Exception as e:  # noqa: BLE001 — reported, not raised
            out["error"] = f"{type(e).__name__}: {e}"
        out["seconds"] = time.perf_counter() - t0

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        return None, f"timed out after {timeout_s:g} s", timeout_s
    return out.get("result"), out.get("error"), out.get("seconds", 0.0)


def _probe(report: Dict, key: str, fn: Callable, timeout_s: float) -> None:
    result, err, secs = _run_with_timeout(fn, timeout_s)
    report[key] = ({"ok": True, "result": result, "seconds": round(secs, 2)} if err is None
                   else {"ok": False, "error": err})


def _devices():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    return [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]


def _roundtrip() -> bool:
    import torch

    return float(torch.ones((), device="cuda") + 1.0) == 2.0


def _nvcc_version() -> str:
    from stereospike_tpu_torch.snn.cuda_kernels import _nvcc

    proc = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True,
                          timeout=60, check=True)
    return proc.stdout.strip().splitlines()[-1]


def _fire_kernels() -> Dict[str, str]:
    """Both fire kernels built (or found built) and loaded."""
    from stereospike_tpu_torch.snn import cuda_kernels

    libs = cuda_kernels.build()
    for name in libs:
        cuda_kernels._library(name)
    return {name: str(path) for name, path in libs.items()}


def _host_ops() -> str:
    from stereospike_tpu_torch import native

    native._library()
    return str(native.library_path())


def run_doctor(device_timeout_s: float = 240.0, data_root: Optional[str] = None) -> Dict:
    """The report: python and torch versions, ``devices`` (or
    ``device_error``), ``device_roundtrip``, ``nvcc``, ``fire_kernels``,
    ``native_host_ops``, ``host_cpu_count``, ``data_root`` when given, and
    ``ok``."""
    import torch

    report: Dict = {"python": sys.version.split()[0], "torch": torch.__version__,
                    "torch_cuda": torch.version.cuda}
    devices, err, secs = _run_with_timeout(_devices, device_timeout_s)
    if devices is not None:
        report["devices"] = devices
        report["device_init_s"] = round(secs, 2)
        val, rerr, rsecs = _run_with_timeout(_roundtrip, device_timeout_s)
        report["device_roundtrip"] = ({"ok": val is True, "seconds": round(rsecs, 2)}
                                      if rerr is None else {"ok": False, "error": rerr})
    else:
        report["devices"] = None
        report["device_error"] = err
    for key, probe in (("nvcc", _nvcc_version), ("fire_kernels", _fire_kernels),
                       ("native_host_ops", _host_ops)):
        _probe(report, key, probe, BUILD_TIMEOUT_S)
    report["host_cpu_count"] = os.cpu_count()
    if data_root:
        report["data_root"] = {"path": data_root, "exists": os.path.isdir(data_root)}
    report["ok"] = bool(report["devices"]) and bool(
        report.get("device_roundtrip", {}).get("ok"))
    return report
