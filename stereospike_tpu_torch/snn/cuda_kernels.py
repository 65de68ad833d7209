"""The fused multi-step fire kernels for Hopper, their build, the autograd
Function over them, and their plain versions.

Counterpart of ``stereospike_tpu/snn/pallas_kernels.py``. The CUDA sources
are ``csrc/fire_fwd.cu`` (it replaces the TPU kernel ``_fwd_kernel``) and
``csrc/fire_bwd.cu`` (it replaces ``_bwd_kernel``, the custom-VJP
backward); their header notes give the bounds and the designs. Each is
compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, at first use, under ``build/stereospike_tpu_torch/`` beside the
package, and loaded with ``ctypes``.

:func:`multistep_fire` runs the forward; when a gradient is wanted it goes
through one ``torch.autograd.Function`` whose backward is
:func:`multistep_fire_backward`. Each wrapper launches its kernel for a
CUDA tensor and raises if it cannot; it takes its plain version
(:func:`multistep_fire_reference`, :func:`multistep_fire_backward_reference`)
only for a tensor on the CPU. ``multistep_fire.launches`` and
``multistep_fire_backward.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from stereospike_tpu_torch.snn.neurons import fire_and_reset, if_step
from stereospike_tpu_torch.snn.surrogate import heaviside, resolve_alpha, surrogate_grad

_PACKAGE = Path(__file__).resolve().parents[1]
SOURCES = {"fire_fwd": _PACKAGE / "csrc" / "fire_fwd.cu",
           "fire_bwd": _PACKAGE / "csrc" / "fire_bwd.cu"}
BUILD_DIR = _PACKAGE.parent / "build" / "stereospike_tpu_torch"
# -fmad=false: no FMA contraction, so the kernel rounds where the plain
# version does (the source also spells every operation with _rn intrinsics)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SURROGATE_CODES = {"atan": 0, "sigmoid": 1}
_VECTOR_BYTES = 16

Grads = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the fire kernels are built from csrc/*.cu")
    return found


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library lives; the file name hashes the
    source and the flags."""
    tag = hashlib.sha1(SOURCES[name].read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{tag[:12]}.so"


def build(*names: str) -> Dict[str, Path]:
    """Compile the named kernels (all by default) unless this source was
    built already, one ``nvcc`` per source, all started together.

    The compiler's report (``-Xptxas=-v``: registers, spills) is kept in a
    ``.log`` beside each library. Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {name: library_path(name) for name in (names or SOURCES)}
    running = {}
    for name, lib in out.items():
        if not lib.exists():
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            running[name] = (proc, tmp)
    failed = []
    for name, (proc, tmp) in running.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {SOURCES[name]} (exit {proc.returncode}):\n{report}")
            continue
        out[name].with_suffix(".log").write_text(report)
        os.replace(tmp, out[name])  # atomic: a concurrent build never loads a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)[name]))


@functools.cache
def _forward_kernel():
    fn = _library("fire_fwd").stereospike_fire_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                      ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _backward_kernel():
    lib = _library("fire_bwd")
    lib.stereospike_fire_bwd_register_steps.argtypes = []
    lib.stereospike_fire_bwd_register_steps.restype = ctypes.c_int
    fn = lib.stereospike_fire_bwd
    fn.argtypes = ([ctypes.c_void_p] * 9
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                      ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, lib.stereospike_fire_bwd_register_steps()


def _check(x: torch.Tensor, v0: torch.Tensor, v_reset: float) -> None:
    if v_reset != 0.0:
        raise NotImplementedError(
            f"the fused fire kernel resets to 0 only, got v_reset={v_reset!r}")
    if x.dim() != 2 or v0.shape != x.shape[1:]:
        raise ValueError(f"need x [T, M] and v0 [M], got {tuple(x.shape)} "
                         f"and {tuple(v0.shape)}")


def _check_cuda(x: torch.Tensor, leak: Optional[torch.Tensor], is_if: bool,
                *others: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Refuse what the kernels do not take; the leak as a one-element fp32
    tensor on the device (None for IF)."""
    if x.device.type != "cuda":
        raise ValueError(f"no fire kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the fire kernels take float32 or bfloat16, got {x.dtype}")
    for t in others:
        if t is not None and (t.dtype != x.dtype or t.device != x.device):
            raise TypeError(f"all tensors must share x's dtype {x.dtype} and device "
                            f"{x.device}, got {t.dtype} on {t.device}")
    if is_if:
        return None
    if leak is None or leak.device != x.device or leak.numel() != 1:
        raise ValueError("LIF/PLIF need a one-element leak on the device of x")
    return leak.detach().reshape(1).to(torch.float32)


def _vectorized(steps: int, m: int, element_size: int, *tensors: Optional[torch.Tensor]) -> bool:
    """Whether every row start is 16-byte aligned, so the kernels may use
    16-byte loads and stores."""
    per_vec = _VECTOR_BYTES // element_size
    return (all(t.data_ptr() % _VECTOR_BYTES == 0 for t in tensors if t is not None)
            and (steps == 1 or m % per_vec == 0))


def _fire_forward(x: torch.Tensor, v0: torch.Tensor, leak: Optional[torch.Tensor],
                  v_threshold: float, v_reset: float,
                  is_if: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel for a CUDA tensor, the plain version for a CPU one."""
    if x.device.type == "cpu":
        return _reference_forward(x, v0, leak, v_threshold, v_reset, is_if)
    leak32 = _check_cuda(x, leak, is_if, v0)
    x = x.detach().contiguous()
    v0 = v0.detach().contiguous()
    steps, m = x.shape
    spikes = torch.empty_like(x)
    v_t = torch.empty_like(v0)
    vec = _vectorized(steps, m, x.element_size(), x, v0, spikes, v_t)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _forward_kernel()(x.data_ptr(), v0.data_ptr(),
                                None if leak32 is None else leak32.data_ptr(),
                                spikes.data_ptr(), v_t.data_ptr(), m, steps,
                                float(v_threshold), float(v_reset),
                                _DTYPE_CODES[x.dtype], int(is_if), int(vec), stream)
    if err != 0:
        raise RuntimeError(f"fire forward kernel launch failed: cudaError_t {err}")
    multistep_fire.launches += 1
    return spikes, v_t


def _reference_forward(x: torch.Tensor, v0: torch.Tensor, leak: Optional[torch.Tensor],
                       v_threshold: float, v_reset: float,
                       is_if: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """A loop over T of the ``snn/neurons.py`` cells, in float32 for
    float32/bfloat16 I/O (float64 stays float64), without a graph."""
    compute = torch.float64 if x.dtype == torch.float64 else torch.float32
    with torch.no_grad():
        v = v0.to(compute)
        lk = None if is_if else leak.reshape(()).to(compute)
        spikes = torch.empty_like(x)
        for t in range(x.shape[0]):
            xt = x[t].to(compute)
            if is_if:
                v, s = if_step(v, xt, v_threshold=v_threshold, v_reset=v_reset,
                               spike_fn=heaviside)
            else:
                v, s = fire_and_reset(v + (xt - v) * lk, v_threshold, v_reset,
                                      heaviside, detach_reset=True)
            spikes[t] = s
    return spikes, v.to(v0.dtype)


class _Fire(torch.autograd.Function):
    """The fire with its surrogate gradient: forward :func:`_fire_forward`,
    backward :func:`multistep_fire_backward` (``plain``: both plain
    versions, on any device). Saves (x, v0, leak), as ``_ms_fwd`` does."""

    @staticmethod
    def forward(ctx, x, v0, leak, v_threshold, v_reset, is_if, surrogate, alpha, plain):
        fwd = _reference_forward if plain else _fire_forward
        spikes, v_t = fwd(x, v0, leak, v_threshold, v_reset, is_if)
        ctx.save_for_backward(x, v0, leak)
        ctx.meta = (v_threshold, v_reset, is_if, surrogate, alpha, plain)
        # an unused vT (T=1 training) arrives as None: the kernel skips its read
        ctx.set_materialize_grads(False)
        return spikes, v_t

    @staticmethod
    def backward(ctx, g_spikes, g_v_t):
        x, v0, leak = ctx.saved_tensors
        v_threshold, v_reset, is_if, surrogate, alpha, plain = ctx.meta
        if g_spikes is None:
            g_spikes = torch.zeros_like(x)
        need_gleak = not is_if and leak is not None and ctx.needs_input_grad[2]
        bwd = multistep_fire_backward_reference if plain else multistep_fire_backward
        gx, gv0, gleak = bwd(x, v0, leak, g_spikes, g_v_t, v_threshold, v_reset, is_if,
                             surrogate, alpha, need_gleak)
        return (gx, gv0 if ctx.needs_input_grad[1] else None, gleak,
                None, None, None, None, None, None)


def _wants_grad(x: torch.Tensor, v0: torch.Tensor, leak: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, v0, leak))


def multistep_fire(x: torch.Tensor, v0: torch.Tensor, leak: Optional[torch.Tensor],
                   v_threshold: float = 1.0, v_reset: float = 0.0, is_if: bool = False,
                   surrogate: str = "atan",
                   alpha: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused T-step fire: charges ``x`` [T, M] from membrane ``v0`` [M] →
    (spikes [T, M], v_T [M]) in the dtype of ``x``.

    ``leak`` is unused for IF (``is_if=True``, h = v + x) and may be None;
    otherwise it is a one-element tensor on the device of ``x`` holding the
    LIF/PLIF decay 1/tau or sigmoid(w) (h = v + (x - v)·leak), read by the
    kernel from device memory. Fires on ``h - v_threshold >= 0`` and resets hard
    to ``v_reset``, which must be 0 (the reset is always detached).

    When grad mode is on and ``x``, ``v0`` or ``leak`` requires grad, the
    call records the fire's backward: the ``surrogate`` derivative ('atan'
    or 'sigmoid', ``alpha`` by default 2.0 or 4.0) through the hand-written
    backward kernel, and the leak's gradient when it requires one (PLIF).
    Under ``no_grad`` nothing is saved. A CUDA tensor launches the kernel
    (float32 or bfloat16) or raises; a CPU tensor runs the plain version."""
    _check(x, v0, v_reset)
    alpha = resolve_alpha(surrogate, alpha)
    if _wants_grad(x, v0, leak):
        return _Fire.apply(x, v0, leak, v_threshold, v_reset, is_if, surrogate, alpha, False)
    return _fire_forward(x, v0, leak, v_threshold, v_reset, is_if)


multistep_fire.launches = 0


def multistep_fire_reference(x: torch.Tensor, v0: torch.Tensor,
                             leak: Optional[torch.Tensor],
                             v_threshold: float = 1.0, v_reset: float = 0.0,
                             is_if: bool = False, surrogate: str = "atan",
                             alpha: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`multistep_fire`, on any device: a loop
    over T of the ``snn/neurons.py`` cells, computed in float32 for
    float32/bfloat16 I/O (float64 stays float64). Its gradient is
    :func:`multistep_fire_backward_reference`."""
    _check(x, v0, v_reset)
    alpha = resolve_alpha(surrogate, alpha)
    if _wants_grad(x, v0, leak):
        return _Fire.apply(x, v0, leak, v_threshold, v_reset, is_if, surrogate, alpha, True)
    return _reference_forward(x, v0, leak, v_threshold, v_reset, is_if)


def multistep_fire_backward(x: torch.Tensor, v0: torch.Tensor, leak: Optional[torch.Tensor],
                            g_spikes: torch.Tensor, g_v_t: Optional[torch.Tensor],
                            v_threshold: float = 1.0, v_reset: float = 0.0,
                            is_if: bool = False, surrogate: str = "atan",
                            alpha: Optional[float] = None, need_gleak: bool = False) -> Grads:
    """Backward of the fused fire: from the saved (x, v0, leak) and the
    gradients of spikes [T, M] and of v_T [M] (None: zero, as for an unused
    v_T), → (gx [T, M], gv0 [M], gleak), gx and gv0 in the dtype of ``x``.
    ``gleak`` is the PLIF leak's gradient in the leak's dtype and shape when
    ``need_gleak``, else None.

    A CUDA tensor launches ``csrc/fire_bwd.cu`` (float32 or bfloat16) or
    raises; a CPU tensor runs :func:`multistep_fire_backward_reference`."""
    _check(x, v0, v_reset)
    alpha = resolve_alpha(surrogate, alpha)
    if need_gleak and (is_if or leak is None):
        raise ValueError("a leak gradient needs a LIF/PLIF fire with a leak")
    if g_spikes.shape != x.shape or (g_v_t is not None and g_v_t.shape != v0.shape):
        raise ValueError(f"gradient shapes {tuple(g_spikes.shape)} and "
                         f"{None if g_v_t is None else tuple(g_v_t.shape)} do not match "
                         f"x {tuple(x.shape)} and v0 {tuple(v0.shape)}")
    if x.device.type == "cpu":
        return multistep_fire_backward_reference(x, v0, leak, g_spikes, g_v_t, v_threshold,
                                                 v_reset, is_if, surrogate, alpha, need_gleak)
    leak32 = _check_cuda(x, leak, is_if, v0, g_spikes, g_v_t)
    kernel, register_steps = _backward_kernel()
    x, v0, g_spikes = (t.detach().contiguous() for t in (x, v0, g_spikes))
    g_v_t = None if g_v_t is None else g_v_t.detach().contiguous()
    steps, m = x.shape
    gx = torch.empty_like(x)
    gv0 = torch.empty_like(v0)
    gleak32 = torch.zeros(1, dtype=torch.float32, device=x.device) if need_gleak else None
    scratch = (torch.empty(steps, m, dtype=torch.float32, device=x.device)
               if steps > register_steps else None)
    vec = _vectorized(steps, m, x.element_size(), x, v0, g_spikes, g_v_t, gx, gv0)
    mode = 0 if is_if else (2 if need_gleak else 1)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = kernel(x.data_ptr(), v0.data_ptr(), ptr(leak32), g_spikes.data_ptr(),
                     ptr(g_v_t), gx.data_ptr(), gv0.data_ptr(), ptr(gleak32), ptr(scratch),
                     m, steps, float(v_threshold), float(v_reset),
                     _SURROGATE_CODES[surrogate], float(alpha),
                     # ATan's pi/2·alpha as the plain version forms it: in
                     # double, rounded once to float32 (by ctypes here)
                     math.pi / 2.0 * alpha, _DTYPE_CODES[x.dtype], mode, int(vec), stream)
    if err != 0:
        raise RuntimeError(f"fire backward kernel launch failed: cudaError_t {err}")
    multistep_fire_backward.launches += 1
    gleak = gleak32.reshape(leak.shape).to(leak.dtype) if need_gleak else None
    return gx, gv0, gleak


multistep_fire_backward.launches = 0


def multistep_fire_backward_reference(x: torch.Tensor, v0: torch.Tensor,
                                      leak: Optional[torch.Tensor], g_spikes: torch.Tensor,
                                      g_v_t: Optional[torch.Tensor],
                                      v_threshold: float = 1.0, v_reset: float = 0.0,
                                      is_if: bool = False, surrogate: str = "atan",
                                      alpha: Optional[float] = None,
                                      need_gleak: bool = False, reduce: bool = True) -> Grads:
    """The plain version of :func:`multistep_fire_backward`, on any device:
    replay the forward in float32 (float64 stays float64) keeping v_{t-1},
    then walk t = T-1..0 with the surrogate derivative of
    ``snn/surrogate.py``, in the order of the kernel's operations.

    ``reduce=False`` returns the per-element PLIF terms (float32 [M]) in
    place of their sum, from which a caller states the tolerance of the
    kernel's differently ordered sum."""
    _check(x, v0, v_reset)
    alpha = resolve_alpha(surrogate, alpha)
    compute = torch.float64 if x.dtype == torch.float64 else torch.float32
    with torch.no_grad():
        lk = None if is_if else leak.detach().reshape(()).to(compute)

        def charge(v, xt):
            return v + xt if is_if else v + (xt - v) * lk

        v = v0.to(compute)
        v_prev = []
        for t in range(x.shape[0]):
            v_prev.append(v)
            h = charge(v, x[t].to(compute))
            s = (h - v_threshold >= 0).to(compute)
            v = (1.0 - s) * h + s * v_reset
        gv = (torch.zeros_like(v) if g_v_t is None else g_v_t.to(compute))
        gleak_terms = torch.zeros_like(v) if need_gleak else None
        gx = torch.empty_like(x)
        for t in range(x.shape[0] - 1, -1, -1):
            xt = x[t].to(compute)
            u = charge(v_prev[t], xt) - v_threshold
            s = (u >= 0).to(compute)
            dh = g_spikes[t].to(compute) * surrogate_grad(u, surrogate, alpha) + gv * (1.0 - s)
            if is_if:
                gx[t] = dh
                gv = dh
            else:
                gx[t] = dh * lk
                gv = dh * (1.0 - lk)
            if need_gleak:
                gleak_terms = gleak_terms + dh * (xt - v_prev[t])
    gleak = None
    if need_gleak:
        gleak = (gleak_terms.sum().reshape(leak.shape).to(leak.dtype) if reduce
                 else gleak_terms)
    return gx, gv.to(v0.dtype), gleak
