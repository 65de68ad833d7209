"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card. Phases, in
order; any failure ends the run with a non-zero exit and no result line:

1. device   — a CUDA card is present; print its name and power limit.
2. build    — compile ``stereospike_tpu_torch/csrc/fire_fwd.cu`` and
              ``fire_bwd.cu`` with nvcc, one process each, side by side.
3. kernel   — the fire forward kernel against its plain PyTorch version on
              the card at the 13 spiking-site sizes of the flagship
              StereoSpike (260×346, B=1), T in {1, 5}, float32 and
              bfloat16, IF / LIF / PLIF (leak a device tensor); spikes and
              membrane must agree exactly. Then time it at T=1 per site
              with CUDA events.
4. backward — the fire backward kernel against its plain version at the
              same sizes, T in {1, 5}, float32 and bfloat16, IF / LIF /
              PLIF, ATan / Sigmoid: gx and gv0 exactly for ATan, within the
              stated tolerance for Sigmoid, the PLIF leak gradient within
              its stated tolerance; then time it at T=1 per site.
5. slice    — serve 20 synthetic windows (20,000 events per eye) through the
              port's ``stream_loop`` with the flagship at float32, pipeline 1:
              13 fire launches per window, finite depths; window 0 once more
              through an evaluator whose fire is the plain version, which
              must give the same depth; 5 windows at bfloat16; a short
              profile of one window's device time by kernel.
6. train    — the flagship's training step (``make_train_step``: forward,
              total loss, BPTT through the fire kernels, Adam) at 260×346,
              T=1, bf16 compute over fp32 master weights: B=16, 2 warm-up
              and 5 timed steps, 13 forward and 13 backward fire launches
              per step, finite losses; one step at B=128; one float32 step
              at B=2 through the kernels and through the plain fire, whose
              losses must agree exactly and gradients to a stated
              tolerance; a profile of one B=16 step by kernel.
7. result   — the kernels' JSON line, the card's ``nvidia-smi`` line, and,
              last, ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
FLAGSHIP_HW = (260, 346)
N_WINDOWS = 20
EVENTS_PER_WINDOW = 20000
TIMING_REPS = 25
TRAIN_BATCH = 16            # bench.py::measure's default batch
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
HEADLINE_BATCH = 128        # bench.py's headline batch
# the backward's Sigmoid tolerance: one ulp of each element in the I/O
# type, or 4 float32 ulps of the array's largest magnitude, whichever is
# larger (expf may round otherwise than PyTorch's sigmoid, and 1 - s
# magnifies an ulp of s near s = 1, where the derivative is small)
SIGMOID_F32_ULPS = 4
# the PLIF leak gradient: a sum of M·T float32 terms in another order
# (per-block partial sums and atomics against PyTorch's sum)
GLEAK_RTOL = 1e-5
# kernel path against plain path, float32 step: each weight gradient
# within this share of the tensor's largest magnitude (the Sigmoid sites
# may differ by ulps; the nearest-upsampling backward's atomics sum in no
# fixed order)
GRAD_RTOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def device_phase(torch) -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    return smi


def build_phase(ck) -> float:
    for name in ck.SOURCES:
        ck.library_path(name).unlink(missing_ok=True)  # build from this checkout's source
    t0 = time.perf_counter()
    libs = ck.build()
    seconds = time.perf_counter() - t0
    for name, lib in libs.items():
        log(f"[build] {ck.SOURCES[name].relative_to(ROOT)} -> {lib.relative_to(ROOT)}")
        log(lib.with_suffix(".log").read_text().strip())
    log(f"[build] both kernels in {seconds:.2f} s")
    return seconds


def site_sizes(cfg):
    """(site, M) of the 13 spiking sites at B=1."""
    from stereospike_tpu_torch.models.stereospike import SITE_LEVEL, SPIKING_SITES

    return [(s, cfg.channels[SITE_LEVEL[s]] * cfg.sizes[SITE_LEVEL[s]][0]
             * cfg.sizes[SITE_LEVEL[s]][1]) for s in SPIKING_SITES]


def _device_times(torch, fn, reps: int, flush) -> list:
    """Per-launch device times (ms) from CUDA events, with the L2 cache
    flushed by a read (clean lines, nothing to write back) before each
    launch. A GPU-side sleep first lets the host queue every launch before
    the GPU reaches them, so host overhead cannot show as device time."""
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~50 ms of spinning at the H100's clock
    pairs = []
    for _ in range(reps):
        flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in pairs]


def kernel_phase(torch, ck, cfg):
    """Kernel against plain version at every site size, then timing at T=1."""
    g = torch.Generator(device="cuda").manual_seed(0)
    leaks = {"if": (None, 1.0), "lif": (torch.tensor(1.0 / 3.0, device="cuda"), 1.0 / 3.0),
             "plif": (torch.sigmoid(torch.tensor(0.3, device="cuda")), 0.5744425)}
    launches0 = ck.multistep_fire.launches
    n_checks, max_err = 0, 0.0
    for site, m in site_sizes(cfg):
        for steps in (1, 5):
            for dtype in (torch.float32, torch.bfloat16):
                for kind, (leak, k) in leaks.items():
                    # charges around the threshold: with v0 ~ U(0, 0.8) the
                    # charged h = (1 - k)·v0 + k·x centres on v_th = 1
                    v0 = (torch.rand(m, generator=g, device="cuda") * 0.8).to(dtype)
                    x = (torch.randn(steps, m, generator=g, device="cuda") * (0.5 / k)
                         + (1.0 - (1.0 - k) * 0.4) / k).to(dtype)
                    s, v = ck.multistep_fire(x, v0, leak, is_if=kind == "if")
                    rs, rv = ck.multistep_fire_reference(x, v0, leak, is_if=kind == "if")
                    torch.cuda.synchronize()
                    err = float((v.float() - rv.float()).abs().max())
                    flips = int((s != rs).sum())
                    rate = float(s.float().mean())
                    if flips or err != 0.0 or not 0.01 < rate < 0.99:
                        raise SystemExit(
                            f"[kernel] {site} M={m} T={steps} {dtype} {kind}: {flips} spike "
                            f"flips, max |vT diff| {err} (tolerance 0 at float32 and "
                            f"bfloat16), spike rate {rate:.3f}")
                    max_err = max(max_err, err)
                    n_checks += 1
    log(f"[kernel] fire_fwd == plain version on {n_checks} cases (13 sites x T in {{1,5}} "
        "x float32/bfloat16 x IF/LIF/PLIF): spikes identical, vT max |diff| "
        f"{max_err} (tolerance 0)")
    ck.multistep_fire.launches = launches0  # comparison launches do not count

    flush_buf = torch.ones(24 * 2 ** 20, dtype=torch.float32, device="cuda")  # 96 MB > L2
    flush = flush_buf.sum
    sites = []
    for site, m in site_sizes(cfg):
        x = (torch.randn(1, m, generator=g, device="cuda") * 0.5 + 0.6)
        v0 = torch.rand(m, generator=g, device="cuda") * 0.8
        kernel = lambda: ck.multistep_fire(x, v0, None, is_if=True)  # noqa: E731
        plain = lambda: ck.multistep_fire_reference(x, v0, None, is_if=True)  # noqa: E731
        for fn in (kernel, plain):  # warm-up
            fn()
        k_ms = statistics.median(_device_times(torch, kernel, TIMING_REPS, flush))
        p_ms = statistics.median(_device_times(torch, plain, TIMING_REPS, flush))
        nbytes = 4 * m * 4               # x, v0 read; spikes, vT written; fp32
        nflops = 3 * m                   # add, compare, reset select
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nflops / FP32_FLOPS * 1e3
        sites.append({"site": site, "M": m, "ms": k_ms, "plain_ms": p_ms,
                      "bound_ms": max(bytes_ms, ops_ms),
                      "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"})
        log(f"[kernel] {site:8s} M={m:8d} kernel {k_ms * 1e3:8.2f} us  plain "
            f"{p_ms * 1e3:8.2f} us  bound {max(bytes_ms, ops_ms) * 1e3:6.2f} us "
            f"({nbytes / 1e6:.2f} MB)")
    ck.multistep_fire.launches = launches0
    return {"n_checks": n_checks, "max_abs_err": max_err, "sites": sites}


def slice_phase(torch, ck, workdir: Path):
    from stereospike_tpu_torch import cli
    from stereospike_tpu_torch.models.stereospike import init_params
    from stereospike_tpu_torch.sources import SyntheticSource
    from stereospike_tpu_torch.streaming import StreamingEvaluator
    from stereospike_tpu_torch.train.loop import build_model_config, stream_loop

    def run(dtype: str, n_windows: int):
        argv = ["stream", "--synthetic", "--n-windows", str(n_windows), "--pipeline", "1",
                "--events-per-window", str(EVENTS_PER_WINDOW), "--model", "stereospike",
                "--in-hw", ",".join(map(str, FLAGSHIP_HW)), "--compute-dtype", dtype,
                "--seed", "0", "--device", "cuda", "--checkpoint-dir", str(workdir)]
        args = cli.build_parser().parse_args(argv)
        cfg = cli.build_config(args)
        depths = []
        ck.multistep_fire.launches = 0
        result = stream_loop(cfg, synthetic=args.synthetic, n_windows=args.n_windows,
                             pipeline=args.pipeline, events_per_window=args.events_per_window,
                             device=args.device, depths=depths)
        torch.cuda.synchronize()
        launches = ck.multistep_fire.launches
        log(f"[slice] {dtype}: {json.dumps(result)}; fire launches {launches}")
        if launches != 13 * n_windows:
            raise SystemExit(f"[slice] fire launched {launches} times for {n_windows} "
                             f"windows; expected 13 per window")
        if result["n_windows"] != n_windows or len(depths) != n_windows:
            raise SystemExit(f"[slice] served {result['n_windows']} of {n_windows} windows")
        for i, d in enumerate(depths):
            if d.shape != (*FLAGSHIP_HW, 1) or not torch.isfinite(torch.from_numpy(d)).all():
                raise SystemExit(f"[slice] window {i}: depth shape {d.shape} or non-finite")
        return cfg, result, depths, launches

    cfg, result, depths, launches = run("float32", N_WINDOWS)

    # window 0 again: kernel fire against the plain fire, same card, same
    # params; deterministic cuDNN so that only the fire differs
    model_cfg = build_model_config(cfg)
    params = init_params(torch.Generator().manual_seed(cfg.seed), model_cfg, device="cuda")
    window0 = next(iter(SyntheticSource(hw=FLAGSHIP_HW, eyes=("left", "right"), n_windows=1,
                                        events_per_window=EVENTS_PER_WINDOW, seed=cfg.seed)))
    torch.backends.cudnn.deterministic = True
    saved = ck.multistep_fire.launches
    out = {}
    for name, fire in (("kernel", ck.multistep_fire), ("plain", ck.multistep_fire_reference)):
        ev = StreamingEvaluator(params, model_cfg, reset_each_window=False, fire_fn=fire)
        out[name] = ev.push(window0)
    torch.backends.cudnn.deterministic = False
    ck.multistep_fire.launches = saved
    diff = float(abs(out["kernel"] - out["plain"]).max())
    main_diff = float(abs(out["kernel"] - depths[0]).max())
    log(f"[slice] window 0: kernel vs plain fire max |depth diff| {diff} (tolerance 0); "
        f"served window 0 vs this run {main_diff} (tolerance 1e-4); depth range "
        f"[{out['kernel'].min():.4f}, {out['kernel'].max():.4f}]")
    if diff != 0.0:
        raise SystemExit("[slice] the kernel path's depth differs from the plain fire's")
    if main_diff > 1e-4:
        raise SystemExit("[slice] the served window 0 differs from its re-run")

    _, result_bf16, _, launches_bf16 = run("bfloat16", 5)
    return {"result": result, "launches": launches, "result_bf16": result_bf16,
            "launches_bf16": launches_bf16, "window0_kernel_vs_plain": diff,
            "params": params, "model_cfg": model_cfg, "window0": window0}


def profile_phase(torch, sl, site_names) -> dict:
    """Device time of steady float32 windows by kernel (torch.profiler), the
    fire kernel's time at each site on the served path, and the share of
    the window's wall time the device sat idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stereospike_tpu_torch.streaming import StreamingEvaluator

    ev = StreamingEvaluator(sl["params"], sl["model_cfg"], reset_each_window=False)
    for _ in range(3):
        ev.push(sl["window0"])
    torch.cuda.synchronize()
    n = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            ev.push(sl["window0"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        log("[profile] torch.profiler reported no device time: not measured")
        return {}
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / n / 1e3
    busy = sum(by_name.values())
    fire = sorted((e for e in dev if "fire_fwd_kernel" in e.name),
                  key=lambda e: e.time_range.start)
    if len(fire) != len(site_names) * n:
        raise SystemExit(f"[profile] {len(fire)} fire kernels in {n} windows")
    path = {site: sum(fire[w * len(site_names) + i].time_range.elapsed_us()
                      for w in range(n)) / n / 1e3 for i, site in enumerate(site_names)}
    fire_ms = sum(path.values())
    log(f"[profile] per float32 window: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"(idle {100 * (1 - busy / wall_ms):.1f}%), fire_fwd {fire_ms * 1e3:.1f} us "
        f"({100 * fire_ms / busy:.2f}% of busy)")
    log("[profile] fire_fwd on the path, us: " + ", ".join(
        f"{k} {v * 1e3:.2f}" for k, v in path.items()))
    for name, ms in sorted(by_name.items(), key=lambda r: -r[1])[:12]:
        log(f"[profile]   {ms:8.4f} ms  {name[:110]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "fire_path_ms": fire_ms, "path": path}


def _ordered(t, torch):
    """Float bits as integers ordered like the floats (+0 and -0 alike)."""
    if t.dtype == torch.float32:
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    i = t.contiguous().view(torch.int16).to(torch.int64)
    return torch.where(i < 0, -(i & 0x7FFF), i)


def _sigmoid_ok(got, ref, torch):
    """(within tolerance, max |diff|, max ulps) for a Sigmoid case."""
    diff = (got.float() - ref.float()).abs()
    mantissa = 23 if ref.dtype == torch.float32 else 7
    _, e = torch.frexp(ref.float())
    elem_ulp = torch.ldexp(torch.ones_like(diff), (e - 1 - mantissa).to(torch.int32))
    scale_ulp = SIGMOID_F32_ULPS * 2.0 ** -23 * float(ref.float().abs().max())
    ok = bool((diff <= torch.clamp(elem_ulp, min=scale_ulp)).all())
    ulps = int((_ordered(got, torch) - _ordered(ref, torch)).abs().max())
    return ok, float(diff.max()), ulps


def backward_phase(torch, ck, cfg, flush):
    """Backward kernel against plain version at every site size, then
    timing at T=1 on the main path's calls (IF; ATan, Sigmoid at SEW)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    leaks = {"if": (None, 1.0), "lif": (torch.tensor(1.0 / 3.0, device="cuda"), 1.0 / 3.0),
             "plif": (torch.sigmoid(torch.tensor(0.3, device="cuda")), 0.5744425)}
    launches0 = ck.multistep_fire_backward.launches
    n_checks, max_err, sig_err, sig_ulps, gl_rel = 0, 0.0, 0.0, 0, 0.0
    for site, m in site_sizes(cfg):
        for steps in (1, 5):
            for dtype in (torch.float32, torch.bfloat16):
                for kind, (leak, k) in leaks.items():
                    for name in ("atan", "sigmoid"):
                        v0 = (torch.rand(m, generator=g, device="cuda") * 0.8).to(dtype)
                        x = (torch.randn(steps, m, generator=g, device="cuda") * (0.5 / k)
                             + (1.0 - (1.0 - k) * 0.4) / k).to(dtype)
                        gs = torch.randn(steps, m, generator=g, device="cuda").to(dtype)
                        # T=1 as on the training path: v_T unused, no gradient
                        gvt = (None if steps == 1 else
                               torch.randn(m, generator=g, device="cuda").to(dtype))
                        args = (x, v0, leak, gs, gvt, 1.0, 0.0, kind == "if", name, None,
                                kind == "plif")
                        gx, gv0, gl = ck.multistep_fire_backward(*args)
                        rx, rv0, rl = ck.multistep_fire_backward_reference(*args)
                        torch.cuda.synchronize()
                        err = max(float((gx.float() - rx.float()).abs().max()),
                                  float((gv0.float() - rv0.float()).abs().max()))
                        where = f"[backward] {site} M={m} T={steps} {dtype} {kind} {name}"
                        if name == "atan":
                            if err != 0.0:
                                raise SystemExit(f"{where}: max |diff| {err} (tolerance 0)")
                        else:
                            for got, ref in ((gx, rx), (gv0, rv0)):
                                ok, e, ulps = _sigmoid_ok(got, ref, torch)
                                sig_err, sig_ulps = max(sig_err, e), max(sig_ulps, ulps)
                                if not ok:
                                    raise SystemExit(f"{where}: max |diff| {e}, {ulps} ulps, "
                                                     "beyond the Sigmoid tolerance")
                        if kind == "plif":
                            _, _, terms = ck.multistep_fire_backward_reference(*args,
                                                                               reduce=False)
                            bound = GLEAK_RTOL * float(terms.abs().sum())
                            gerr = abs(float(gl) - float(rl))
                            gl_rel = max(gl_rel, gerr / max(bound / GLEAK_RTOL, 1e-30))
                            if gerr > bound:
                                raise SystemExit(f"{where}: gleak {float(gl)} vs "
                                                 f"{float(rl)}, beyond {bound}")
                        max_err = max(max_err, err)
                        n_checks += 1
    log(f"[backward] fire_bwd vs plain version on {n_checks} cases (13 sites x T in {{1,5}} "
        "x float32/bfloat16 x IF/LIF/PLIF x ATan/Sigmoid): ATan gx, gv0 identical; "
        f"Sigmoid max |diff| {sig_err} ({sig_ulps} ulps; tolerance one ulp of the element "
        f"or {SIGMOID_F32_ULPS} float32 ulps of the array's max); PLIF gleak max |diff| "
        f"{gl_rel:.3g} of sum|terms| (tolerance {GLEAK_RTOL})")

    sites = []
    for site, m in site_sizes(cfg):
        name, alpha = cfg.site_surrogate(site)
        x = torch.randn(1, m, generator=g, device="cuda") * 0.5 + 0.6
        v0 = torch.rand(m, generator=g, device="cuda") * 0.8
        gs = torch.randn(1, m, generator=g, device="cuda")
        args = (x, v0, None, gs, None, 1.0, 0.0, True, name, alpha, False)
        kernel = lambda: ck.multistep_fire_backward(*args)  # noqa: E731
        plain = lambda: ck.multistep_fire_backward_reference(*args)  # noqa: E731
        for fn in (kernel, plain):  # warm-up
            fn()
        k_ms = statistics.median(_device_times(torch, kernel, TIMING_REPS, flush))
        p_ms = statistics.median(_device_times(torch, plain, TIMING_REPS, flush))
        nbytes = 5 * m * 4               # x, v0, gs read; gx, gv0 written; fp32
        nflops = 12 * m                  # replayed charge and compare, surrogate, dh, gx
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nflops / FP32_FLOPS * 1e3
        sites.append({"site": site, "M": m, "surrogate": name, "ms": k_ms, "plain_ms": p_ms,
                      "bound_ms": max(bytes_ms, ops_ms),
                      "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"})
        log(f"[backward] {site:8s} M={m:8d} {name:7s} kernel {k_ms * 1e3:8.2f} us  plain "
            f"{p_ms * 1e3:8.2f} us  bound {max(bytes_ms, ops_ms) * 1e3:6.2f} us "
            f"({nbytes / 1e6:.2f} MB)")
    ck.multistep_fire_backward.launches = launches0  # comparison launches do not count
    return {"n_checks": n_checks, "max_abs_err": max(max_err, sig_err), "sigmoid_ulps": sig_ulps,
            "gleak_rel": gl_rel, "sites": sites}


def train_phase(torch, ck, cfg):
    """The flagship's training step at bf16 over fp32 master: B=16 timed,
    B=128 once, and the kernel path against the plain-fire path at B=2."""
    from stereospike_tpu_torch.data.synthetic import synthetic_batch
    from stereospike_tpu_torch.models.stereospike import init_params
    from stereospike_tpu_torch.objectives.losses import TotalLossConfig
    from stereospike_tpu_torch.train.state import create_train_state, make_optimizer
    from stereospike_tpu_torch.train.steps import make_train_step

    params = init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    tx = make_optimizer(2e-4)

    def setup(batch_size, dtype, fire=ck.multistep_fire, seed=2):
        state = create_train_state(params, tx, torch.Generator().manual_seed(1))
        batch = synthetic_batch(torch.Generator(device="cuda").manual_seed(seed),
                                batch=batch_size, in_hw=cfg.in_hw, T=1, device="cuda")
        step = make_train_step(cfg, TotalLossConfig(), tx, compute_dtype=dtype, fire_fn=fire)
        return state, batch, step

    def check(metrics, where):
        for i, m in enumerate(metrics):
            if not (torch.isfinite(m["loss"]) and torch.isfinite(m["mde"])):
                raise SystemExit(f"[train] {where} step {i}: loss {m['loss']} mde {m['mde']}")

    # B=16, bf16: the main path of this slice
    state, batch, step = setup(TRAIN_BATCH, torch.bfloat16)
    for _ in range(TRAIN_WARMUP):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_STEPS + 1)]
    metrics = []
    ck.multistep_fire.launches = 0
    ck.multistep_fire_backward.launches = 0
    t0 = time.perf_counter()
    events[0].record()
    for i in range(TRAIN_STEPS):
        state, m = step(state, batch)
        events[i + 1].record()
        metrics.append(m)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    fwd, bwd = ck.multistep_fire.launches, ck.multistep_fire_backward.launches
    peak = torch.cuda.max_memory_allocated()
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(TRAIN_STEPS)]
    check(metrics, f"B={TRAIN_BATCH}")
    losses = [float(m["loss"]) for m in metrics]
    mdes = [float(m["mde"]) for m in metrics]
    b16 = {"batch": TRAIN_BATCH, "steps": TRAIN_STEPS, "step_ms": wall_s * 1e3 / TRAIN_STEPS,
           "step_ms_events": step_ms, "frames_per_s": TRAIN_BATCH * TRAIN_STEPS / wall_s,
           "peak_bytes": peak, "loss": losses, "mde": mdes,
           "fire_fwd_launches": fwd, "fire_bwd_launches": bwd}
    log(f"[train] B={TRAIN_BATCH} bf16: {json.dumps(b16)}")
    if fwd != 13 * TRAIN_STEPS or bwd != 13 * TRAIN_STEPS:
        raise SystemExit(f"[train] {fwd} forward and {bwd} backward fire launches in "
                         f"{TRAIN_STEPS} steps; expected 13 of each per step")
    profile_state = (state, batch, step)

    # B=128, bf16: one warm-up step, then one timed
    torch.cuda.empty_cache()
    big_state, big_batch, big_step = setup(HEADLINE_BATCH, torch.bfloat16, seed=3)
    big_step(big_state, big_batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, m = big_step(big_state, big_batch)
    torch.cuda.synchronize()
    b128 = {"batch": HEADLINE_BATCH, "step_ms": (time.perf_counter() - t0) * 1e3,
            "peak_bytes": torch.cuda.max_memory_allocated(), "loss": float(m["loss"]),
            "mde": float(m["mde"])}
    b128["frames_per_s"] = HEADLINE_BATCH / b128["step_ms"] * 1e3
    check([m], f"B={HEADLINE_BATCH}")
    log(f"[train] B={HEADLINE_BATCH} bf16: {json.dumps(b128)}")
    del big_state, big_batch, big_step, m
    torch.cuda.empty_cache()

    # kernel path against plain-fire path: float32, B=2, deterministic cuDNN
    saved = ck.multistep_fire.launches, ck.multistep_fire_backward.launches
    torch.backends.cudnn.deterministic = True
    runs = {}
    for name, fire in (("kernel", ck.multistep_fire), ("plain", ck.multistep_fire_reference)):
        st, bt, sp = setup(2, torch.float32, fire=fire, seed=4)
        _, m = sp(st, bt)
        runs[name] = (float(m["loss"]), float(m["mde"]),
                      {k: p.grad.detach().clone() for k, p in st.params.items()})
    torch.backends.cudnn.deterministic = False
    ck.multistep_fire.launches, ck.multistep_fire_backward.launches = saved
    (lk, mk, gk), (lp, mp, gp) = runs["kernel"], runs["plain"]
    worst, worst_key = 0.0, None
    for k in gk:
        scale = float(gp[k].abs().max())
        rel = float((gk[k] - gp[k]).abs().max()) / scale if scale > 0 else float(
            gk[k].abs().max())
        if rel > worst:
            worst, worst_key = rel, k
    paths = {"loss_kernel": lk, "loss_plain": lp, "mde_kernel": mk, "mde_plain": mp,
             "grad_max_rel": worst, "grad_worst": worst_key,
             "grads_nonzero": sum(float(g.abs().max()) > 0 for g in gp.values()),
             "grads": len(gp)}
    log(f"[train] float32 B=2 kernel vs plain fire: {json.dumps(paths)} (loss tolerance 0, "
        f"gradients {GRAD_RTOL} of each tensor's max)")
    if lk != lp or mk != mp:
        raise SystemExit("[train] the kernel path's loss differs from the plain fire's")
    if worst > GRAD_RTOL:
        raise SystemExit(f"[train] gradient {worst_key} differs by {worst} of its max")
    return {"b16": b16, "b128": b128, "paths": paths, "profile_state": profile_state}


def train_profile_phase(torch, tr) -> dict:
    """Device time of one bf16 B=16 training step by kernel: the fire
    forward and backward shares, and the idle share of the step's wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state, batch, step = tr["profile_state"]
    step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        log("[train-profile] torch.profiler reported no device time: not measured")
        return {}
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    fwd = [e for e in dev if "fire_fwd_kernel" in e.name]
    bwd = [e for e in dev if "fire_bwd_kernel" in e.name]
    if len(fwd) != 13 or len(bwd) != 13:
        raise SystemExit(f"[train-profile] {len(fwd)} forward and {len(bwd)} backward fire "
                         "kernels in one step; expected 13 of each")
    fwd_ms = sum(e.time_range.elapsed_us() for e in fwd) / 1e3
    bwd_ms = sum(e.time_range.elapsed_us() for e in bwd) / 1e3
    out = {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1 - busy / wall_ms,
           "fire_fwd_ms": fwd_ms, "fire_bwd_ms": bwd_ms,
           "fire_fwd_share": fwd_ms / busy, "fire_bwd_share": bwd_ms / busy}
    log(f"[train-profile] one bf16 B={TRAIN_BATCH} step: {json.dumps(out)}")
    for name, ms in sorted(by_name.items(), key=lambda r: -r[1])[:15]:
        log(f"[train-profile]   {ms:8.4f} ms  {name[:110]}")
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    smi = device_phase(torch)
    import stereospike_tpu_torch
    from stereospike_tpu_torch.models import factory
    from stereospike_tpu_torch.snn import cuda_kernels as ck

    if Path(stereospike_tpu_torch.__file__).resolve().parent != ROOT / "stereospike_tpu_torch":
        raise SystemExit("chip_smoke: stereospike_tpu_torch must come from this checkout")
    build_s = build_phase(ck)
    cfg = factory.stereospike(in_hw=FLAGSHIP_HW)
    kern = kernel_phase(torch, ck, cfg)
    flush_buf = torch.ones(24 * 2 ** 20, dtype=torch.float32, device="cuda")  # 96 MB > L2
    bwd = backward_phase(torch, ck, cfg, flush_buf.sum)
    del flush_buf
    workdir = ROOT / "build" / "chip_smoke"
    sl = slice_phase(torch, ck, workdir)
    prof = profile_phase(torch, sl, [site for site, _ in site_sizes(cfg)])
    for row in kern["sites"]:
        row["path_ms"] = prof.get("path", {}).get(row["site"])
    serve_launches, serve_launches_bf16 = sl["launches"], sl["launches_bf16"]
    del sl  # its parameters and evaluator free the card for training
    tr = train_phase(torch, ck, cfg)
    tprof = train_profile_phase(torch, tr)
    del tr["profile_state"]
    log(json.dumps({"train": {**tr, "profile": tprof}}))

    sites = kern["sites"]
    kernels = {"kernels": [{
        "name": "fire_fwd",
        "route": "cuda",
        "source": "stereospike_tpu_torch/csrc/fire_fwd.cu",
        "replaces": "stereospike_tpu/snn/pallas_kernels.py:180",
        "launches": serve_launches,
        "max_abs_err": kern["max_abs_err"],
        # one window's 13 sites at T=1, float32, B=1, timed alone with the
        # L2 cache cold (per-site rows below)
        "ms": sum(s["ms"] for s in sites),
        "plain_ms": sum(s["plain_ms"] for s in sites),
        "bound_ms": sum(s["bound_ms"] for s in sites),
        "bound_by": "bytes",
        "library_ms": None,
        "checks": kern["n_checks"],
        "build_s": build_s,
        "launches_bf16_run": serve_launches_bf16,
        # the same 13 launches inside a served window (torch.profiler)
        "path_ms": prof.get("fire_path_ms"),
        # the 13 launches of one bf16 B=16 training step (torch.profiler)
        "train_launches": tr["b16"]["fire_fwd_launches"],
        "train_path_ms": tprof.get("fire_fwd_ms"),
        "sites": sites,
    }, {
        "name": "fire_bwd",
        "route": "cuda",
        "source": "stereospike_tpu_torch/csrc/fire_bwd.cu",
        "replaces": "stereospike_tpu/snn/pallas_kernels.py:226",
        # from the timed bf16 B=16 training steps
        "launches": tr["b16"]["fire_bwd_launches"],
        "max_abs_err": bwd["max_abs_err"],
        # one step's 13 sites at T=1, float32, B=1, v_T unused, timed alone
        # with the L2 cache cold (per-site rows below)
        "ms": sum(r["ms"] for r in bwd["sites"]),
        "plain_ms": sum(r["plain_ms"] for r in bwd["sites"]),
        "bound_ms": sum(r["bound_ms"] for r in bwd["sites"]),
        "bound_by": "bytes",
        "library_ms": None,
        "checks": bwd["n_checks"],
        "sigmoid_max_ulps": bwd["sigmoid_ulps"],
        "gleak_max_rel": bwd["gleak_rel"],
        "train_path_ms": tprof.get("fire_bwd_ms"),
        "sites": bwd["sites"],
    }]}
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
