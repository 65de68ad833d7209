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
              membrane must agree exactly. The other reset modes at 3 site
              sizes (bottom, conv2, conv4): soft reset (IF, PLIF), hard
              reset to 0.3 (LIF, PLIF), undetached reset (IF, PLIF), exactly
              too. Then time it at T=1 per site with CUDA events.
4. backward — the fire backward kernel against its plain version at the
              same sizes, T in {1, 5}, float32 and bfloat16, IF / LIF /
              PLIF, ATan / Sigmoid: gx and gv0 exactly for ATan, within the
              stated tolerance for Sigmoid, the PLIF leak gradient within
              its stated tolerance; the same in the other reset modes at
              the 3 site sizes; then time it at T=1 per site.
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
7. multistep — the layer-major training step (``make_train_step(multistep=
              True)``) at T=5, B=16, bf16 over fp32 master (bench.py's T>1
              configuration): 2 warm-up and 5 timed steps, exactly 13
              forward and 13 backward fire launches per step over [T, M];
              the step-major ``forward_sequence`` (remat) at the same size
              for comparison; float32 B=2 steps at T=5 and T=12 (fire_bwd's
              scratch path) through the kernels and through the plain fire,
              losses equal and gradients within a stated tolerance; a
              profile of one layer-major step by kernel, with no copy
              kernel just before or after any fire launch.
8. eval     — ``make_eval_step`` at B=16, float32, T=1 step-major and T=5
              layer-major: finite per-sample loss and MDE, 13 forward and
              0 backward launches per step, its time.
9. taps     — ``firing_rates_sequence`` at T=5, B=2: 14 densities in
              [0, 1], identical between the kernel and the plain fire.
10. ann     — the equivalent ANN (sigmoid), float32, B=16: 2 warm-up and 5
              timed train steps (finite, falling loss; every BN running
              statistic moved) and one eval step with the frozen statistics.
11. driver  — the training driver through ``stereospike_tpu_torch.cli.main``
              in this process, on the learnable synthetic MVSEC fixture at
              260×346 (66 depth frames: 8 steps per epoch at B=16), written
              once as a ``.npy`` tree into a temporary directory removed at
              the end: ``train`` (flagship, bf16, B=16, T=1, 2 epochs,
              augmentation, packed uploads, prefetch 2), ``eval`` of
              best.pt, ``firing-rates``, ``train --resume`` to a third
              epoch, the layer-major path with warmup and seeded
              integrators (T=5, B=4, 3 steps), DENSE (monocular, 1 epoch);
              each with exact fire-launch counts (13 forward and 13 backward
              per train step, 13 forward per warmup, val, test and
              firing-rates batch), finite results, and h5py never imported;
              then a profile of two steps inside a running loop with the
              prefetcher live; one ``driver`` JSON line. Its ``best.pt`` is
              kept for the serving phase.
12. serving — the rest of serving, with the driver's trained flagship
              (float32 unless stated, deterministic cuDNN): ``stream
              --which best.pt`` and ``--import-pth`` of its ``cli
              export-pth`` file, 20 windows each, equal depths; 8 cameras
              in one batched step (float32 and bf16, 20 windows, pipeline
              1), each stream
              against a 1-stream evaluator within the stated tolerance,
              with a profile of the fire kernel per 8-stream window; ``cli
              stream --listen --reply --n-windows 10`` for the monocular and
              the binocular model, fed by a producer thread over the
              loopback, replies equal to a direct evaluator's depths; a
              stereo AEDAT 3.1 recording served in full; ``cli
              export-serving`` at 1 stream (float32) and 4 (bf16),
              ``from_artifact`` equal to the live evaluator bit for bit, the
              4-stream artifact served, ``stream --artifact`` for 20
              windows; exactly 13 fire launches per window everywhere; one
              ``serving`` JSON line.
13. parallel — data parallelism: ``python -m torch.distributed.run
              --nproc_per_node 1`` of this script as a worker, which runs
              ``cli train --mesh-shape 1,1`` (NCCL, world 1, ``driver``'s
              flagship bf16 B=16 T=1 run cut to a few steps): 13 forward
              and 13 backward fire launches per step read by the profiler
              over two steps of the running loop, the all-reduce present,
              exact launch counts, and the bare step under the process group
              timed against ``train``'s; two ranks sharing the card over
              gloo (float32, layer-major T=5, B=4 each, 2 steps, cuDNN
              deterministic) against one process at B=8 from the same
              weights: loss and MDE, and the parameters, within the stated
              tolerances, and both ranks' parameters bit-equal; ``cli
              doctor`` ok and naming the card; one ``parallel`` JSON line.
14. result  — the kernels' JSON line, the card's ``nvidia-smi`` line, and,
              last, ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

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
MS_T, MS_BATCH = 5, 16      # bench.py's T>1 configuration (BENCH_T, BENCH_BATCH_T)
LONG_T = 12                 # beyond fire_bwd's register replay (T <= 8)
EVAL_BATCH = ANN_BATCH = 16
TAPS_BATCH = 2
# the reset modes besides the default detached hard reset to 0, held at
# three site sizes: (name, neuron, v_reset, detach_reset)
RESET_MODES = (("soft", "if", None, True), ("soft", "plif", None, True),
               ("hard0.3", "lif", 0.3, True), ("hard0.3", "plif", 0.3, True),
               ("undetached", "if", 0.0, False), ("undetached", "plif", 0.0, False))
RESET_SITES = ("bottom", "conv2", "conv4")
# the driver: 66 synthetic depth frames give 2·(66 − 2) = 128 train samples
# per epoch (8 steps at B=16), 22 val and 21 test samples
DRIVER_FRAMES, DRIVER_BATCH = 66, 16
# serving: cameras in one batched step, socket and AEDAT windows
SERVE_STREAMS, SOCKET_WINDOWS, AEDAT_WINDOWS = 8, 10, 6
# stream s of the 8-stream evaluator against a 1-stream evaluator (deterministic
# cuDNN): the two batch sizes may pick other conv algorithms, which sum in
# another order (float32: ulps; bf16: its rounding), and a charge that lands
# on the threshold then flips a spike (measured on the H100: 0 at both)
SERVE_STREAM_TOL = {"float32": 1e-3, "bfloat16": 1e-1}
LM_BATCH, LM_STEPS, DENSE_BATCH = 4, 3, 4
# data parallelism: the optimizer steps of the world-1 cli train; two gloo
# ranks of B=4 at float32, layer-major T=5, 2 steps, against one process of B=8
DP_STEPS = 4
# the all-reduces of one T=1 step: every head's loss sums, the MDE's sums,
# the flattened gradient buffer
DP_ALLREDUCES_PER_STEP = 3
GLOO_RANKS, GLOO_BATCH, GLOO_STEPS = 2, 4, 2
# 2 ranks against 1 process (deterministic cuDNN): the weight gradients sum
# over the batch in another order (each rank's half, then the all-reduce),
# which may flip a spike whose charge sits at the threshold, and Adam's
# first updates are about lr·sign(g), so a gradient within float32 noise of
# 0 may move its weight the other way. Loss and MDE within GLOO_RTOL
# relative; each tensor's change over the steps within GLOO_DELTA_RTOL of
# the one process's change (L2 norms). Controls, read in every run: a run
# whose optimizer never stepped reads 1.0 on the change, and the loss of
# step 2 then equals that of step 1; a run that lost its last update reads
# ‖p1 − p2‖ / ‖p2 − p0‖. Each control must fail its tolerance.
GLOO_RTOL = 1e-4
GLOO_DELTA_RTOL = 5e-2
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
    n_reset = 0
    for site, m, steps, dtype, mode, kind, v_reset, _, (leak, k) in _reset_cases(torch, cfg,
                                                                                  leaks):
        v0 = (torch.rand(m, generator=g, device="cuda") * 0.8).to(dtype)
        x = (torch.randn(steps, m, generator=g, device="cuda") * (0.5 / k)
             + (1.0 - (1.0 - k) * 0.4) / k).to(dtype)
        s, v = ck.multistep_fire(x, v0, leak, 1.0, v_reset, kind == "if")
        rs, rv = ck.multistep_fire_reference(x, v0, leak, 1.0, v_reset, kind == "if")
        torch.cuda.synchronize()
        flips, err = int((s != rs).sum()), float((v.float() - rv.float()).abs().max())
        rate = float(s.float().mean())
        if flips or err != 0.0 or not 0.01 < rate < 0.99:
            raise SystemExit(f"[kernel] {mode} {site} M={m} T={steps} {dtype} {kind}: {flips} "
                             f"spike flips, max |vT diff| {err} (tolerance 0), spike rate "
                             f"{rate:.3f}")
        n_reset += 1
    log(f"[kernel] fire_fwd == plain version in the other reset modes on {n_reset} cases "
        f"({'/'.join(RESET_SITES)} x T in {{1,5}} x float32/bfloat16 x "
        f"{', '.join(f'{m} {k}' for m, k, _, _ in RESET_MODES)}): spikes and vT identical")
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
    return {"n_checks": n_checks, "reset_mode_checks": n_reset, "max_abs_err": max_err,
            "sites": sites}


def _reset_cases(torch, cfg, leaks):
    """(site, M, T, dtype, mode, neuron, v_reset, detach_reset, leak) of
    every reset-mode case."""
    for site, m in site_sizes(cfg):
        if site not in RESET_SITES:
            continue
        for steps in (1, 5):
            for dtype in (torch.float32, torch.bfloat16):
                for mode, kind, v_reset, detach in RESET_MODES:
                    yield site, m, steps, dtype, mode, kind, v_reset, detach, leaks[kind]


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
    n_reset = 0
    for site, m, steps, dtype, mode, kind, v_reset, detach, (leak, k) in _reset_cases(
            torch, cfg, leaks):
        for name in ("atan", "sigmoid"):
            v0 = (torch.rand(m, generator=g, device="cuda") * 0.8).to(dtype)
            x = (torch.randn(steps, m, generator=g, device="cuda") * (0.5 / k)
                 + (1.0 - (1.0 - k) * 0.4) / k).to(dtype)
            gs = torch.randn(steps, m, generator=g, device="cuda").to(dtype)
            gvt = torch.randn(m, generator=g, device="cuda").to(dtype)
            args = (x, v0, leak, gs, gvt, 1.0, v_reset, kind == "if", name, None,
                    kind == "plif")
            gx, gv0, gl = ck.multistep_fire_backward(*args, detach_reset=detach)
            rx, rv0, rl = ck.multistep_fire_backward_reference(*args, detach_reset=detach)
            torch.cuda.synchronize()
            where = f"[backward] {mode} {site} M={m} T={steps} {dtype} {kind} {name}"
            if name == "atan":
                err = max(float((gx.float() - rx.float()).abs().max()),
                          float((gv0.float() - rv0.float()).abs().max()))
                if err != 0.0:
                    raise SystemExit(f"{where}: max |diff| {err} (tolerance 0)")
            else:
                for got, ref in ((gx, rx), (gv0, rv0)):
                    ok, e, ulps = _sigmoid_ok(got, ref, torch)
                    sig_err, sig_ulps = max(sig_err, e), max(sig_ulps, ulps)
                    if not ok:
                        raise SystemExit(f"{where}: max |diff| {e}, {ulps} ulps, beyond the "
                                         "Sigmoid tolerance")
            if kind == "plif":
                _, _, terms = ck.multistep_fire_backward_reference(*args, reduce=False,
                                                                   detach_reset=detach)
                bound = GLEAK_RTOL * float(terms.abs().sum())
                gerr = abs(float(gl) - float(rl))
                gl_rel = max(gl_rel, gerr / max(bound / GLEAK_RTOL, 1e-30))
                if gerr > bound:
                    raise SystemExit(f"{where}: gleak {float(gl)} vs {float(rl)}, beyond {bound}")
            n_reset += 1
    log(f"[backward] fire_bwd vs plain version in the other reset modes on {n_reset} cases "
        f"({'/'.join(RESET_SITES)} x T in {{1,5}} x float32/bfloat16 x "
        f"{', '.join(f'{m} {k}' for m, k, _, _ in RESET_MODES)} x ATan/Sigmoid): ATan "
        f"identical; Sigmoid and gleak within the tolerances above (max {sig_ulps} ulps, "
        f"gleak {gl_rel:.3g} of sum|terms|)")

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
    return {"n_checks": n_checks, "reset_mode_checks": n_reset,
            "max_abs_err": max(max_err, sig_err), "sigmoid_ulps": sig_ulps,
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
    b16 = {"batch": TRAIN_BATCH, **_timed_steps(torch, step, state, batch, TRAIN_WARMUP,
                                                 TRAIN_STEPS, ck)}
    b16["frames_per_s"] = TRAIN_BATCH / b16["step_ms"] * 1e3
    log(f"[train] B={TRAIN_BATCH} bf16: {json.dumps(b16)}")
    fwd, bwd = b16["fire_fwd_launches"], b16["fire_bwd_launches"]
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
    paths = _kernel_vs_plain(torch, ck, lambda fire: setup(2, torch.float32, fire=fire, seed=4),
                             "[train] float32 B=2")
    return {"b16": b16, "b128": b128, "paths": paths, "profile_state": profile_state}


def train_profile_phase(torch, tr) -> dict:
    """Device time of one bf16 B=16 training step by kernel: the fire
    forward and backward shares, and the idle share of the step's wall."""
    state, batch, step = tr["profile_state"]
    return _profile(torch, lambda: step(state, batch), f"[train-profile] one bf16 "
                    f"B={TRAIN_BATCH} step:", 13, 13)


def _timed_steps(torch, step, state, batch, warmup: int, steps: int, ck=None) -> dict:
    """``warmup`` steps, then ``steps`` timed ones: host clock over the
    steps ending in a synchronize, CUDA events per step, peak memory, the
    metrics; with ``ck``, the fire counts set to 0 just before the timed
    steps and read just after."""
    for _ in range(warmup):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    metrics = []
    if ck is not None:
        ck.multistep_fire.launches = 0
        ck.multistep_fire_backward.launches = 0
    t0 = time.perf_counter()
    events[0].record()
    for i in range(steps):
        state, m = step(state, batch)
        events[i + 1].record()
        metrics.append(m)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    out = {"steps": steps, "step_ms": wall_s * 1e3 / steps,
           "step_ms_events": [events[i].elapsed_time(events[i + 1]) for i in range(steps)],
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "loss": [float(m["loss"]) for m in metrics], "mde": [float(m["mde"]) for m in metrics]}
    if ck is not None:
        out["fire_fwd_launches"] = ck.multistep_fire.launches
        out["fire_bwd_launches"] = ck.multistep_fire_backward.launches
    for i, m in enumerate(metrics):
        if not (torch.isfinite(m["loss"]) and torch.isfinite(m["mde"])):
            raise SystemExit(f"step {i}: loss {m['loss']} mde {m['mde']}")
    return out


def _kernel_vs_plain(torch, ck, setup, where: str) -> dict:
    """One float32 step through the kernels and one through the plain fire,
    same inputs, deterministic cuDNN: losses equal, each gradient within
    GRAD_RTOL of the plain one's largest magnitude. The fire counts are
    restored after: comparison launches do not count."""
    saved = ck.multistep_fire.launches, ck.multistep_fire_backward.launches
    torch.backends.cudnn.deterministic = True
    runs = {}
    for name, fire in (("kernel", ck.multistep_fire), ("plain", ck.multistep_fire_reference)):
        st, bt, sp = setup(fire)
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
    log(f"{where} kernel vs plain fire: {json.dumps(paths)} (loss tolerance 0, gradients "
        f"{GRAD_RTOL} of each tensor's max)")
    if lk != lp or mk != mp:
        raise SystemExit(f"{where} the kernel path's loss differs from the plain fire's")
    if worst > GRAD_RTOL:
        raise SystemExit(f"{where} gradient {worst_key} differs by {worst} of its max")
    return paths


def _profile(torch, fn, tag: str, n_fwd: int, n_bwd: int) -> dict:
    """Device time of one call of ``fn`` by kernel (torch.profiler): the
    fire kernels' launches in order, busy and idle, top kernels. Fails
    unless it finds ``n_fwd`` and ``n_bwd`` fire launches and no copy
    kernel just before or after any of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    if not dev:
        log(f"{tag} torch.profiler reported no device time: not measured")
        return {}
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    fwd = [e for e in dev if "fire_fwd_kernel" in e.name]
    bwd = [e for e in dev if "fire_bwd_kernel" in e.name]
    # the kernels just before and after each fire launch: a layout copy
    # around a site would show here
    beside = [dev[k].name for i, e in enumerate(dev) if "fire_" in e.name
              for k in (i - 1, i + 1) if 0 <= k < len(dev) and "fire_" not in dev[k].name]
    if len(fwd) != n_fwd or len(bwd) != n_bwd:
        raise SystemExit(f"{tag} {len(fwd)} forward and {len(bwd)} backward fire kernels; "
                         f"expected {n_fwd} and {n_bwd}")
    out = {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1 - busy / wall_ms,
           "fire_fwd_ms": sum(e.time_range.elapsed_us() for e in fwd) / 1e3,
           "fire_bwd_ms": sum(e.time_range.elapsed_us() for e in bwd) / 1e3,
           "fire_fwd_us": [e.time_range.elapsed_us() for e in fwd],
           "fire_bwd_us": [e.time_range.elapsed_us() for e in bwd],
           "copies_beside_fire": sorted({n[:80] for n in beside if "copy" in n.lower()})}
    out["fire_fwd_share"] = out["fire_fwd_ms"] / busy
    out["fire_bwd_share"] = out["fire_bwd_ms"] / busy
    log(f"{tag} {json.dumps(out)}")
    for name, ms in sorted(by_name.items(), key=lambda r: -r[1])[:15]:
        log(f"{tag}   {ms:8.4f} ms  {name[:110]}")
    if out["copies_beside_fire"]:
        raise SystemExit(f"{tag} a copy kernel runs beside a fire launch")
    return out


def multistep_phase(torch, ck, cfg) -> dict:
    """Layer-major training at T=5 (the main path of this phase), the
    step-major path beside it, and the kernel path against the plain fire
    at T=5 and T=12."""
    from stereospike_tpu_torch.data.synthetic import synthetic_batch
    from stereospike_tpu_torch.models.multistep import forward_multistep
    from stereospike_tpu_torch.models.stereospike import init_params
    from stereospike_tpu_torch.objectives.losses import TotalLossConfig
    from stereospike_tpu_torch.train.state import create_train_state, make_optimizer
    from stereospike_tpu_torch.train.steps import make_train_step

    params = init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    tx = make_optimizer(2e-4)

    def setup(batch_size, steps, dtype, multistep, fire=ck.multistep_fire, seed=5):
        state = create_train_state(params, tx, torch.Generator().manual_seed(1))
        batch = synthetic_batch(torch.Generator(device="cuda").manual_seed(seed),
                                batch=batch_size, in_hw=cfg.in_hw, T=steps, device="cuda")
        step = make_train_step(cfg, TotalLossConfig(), tx, compute_dtype=dtype,
                               multistep=multistep, remat=not multistep, fire_fn=fire)
        return state, batch, step

    frames = MS_BATCH * MS_T
    state, batch, step = setup(MS_BATCH, MS_T, torch.bfloat16, True)
    lm = _timed_steps(torch, step, state, batch, TRAIN_WARMUP, TRAIN_STEPS, ck)
    lm["frames_per_s"] = frames / lm["step_ms"] * 1e3
    log(f"[multistep] layer-major T={MS_T} B={MS_BATCH} bf16: {json.dumps(lm)}")
    if (lm["fire_fwd_launches"] != 13 * TRAIN_STEPS
            or lm["fire_bwd_launches"] != 13 * TRAIN_STEPS):
        raise SystemExit(f"[multistep] {lm['fire_fwd_launches']} forward and "
                         f"{lm['fire_bwd_launches']} backward fire launches in {TRAIN_STEPS} "
                         "layer-major steps; expected 13 of each per step")

    # the [T, M] of each site's launch, from one no-grad forward
    shapes = []

    def spy(x, *args, **kwargs):
        shapes.append(tuple(x.shape))
        return ck.multistep_fire(x, *args, **kwargs)

    saved = ck.multistep_fire.launches
    with torch.no_grad():
        forward_multistep({k: v.to(torch.bfloat16) for k, v in state.params.items()},
                          batch["chunks"].to(torch.bfloat16), cfg, fire_fn=spy)
    ck.multistep_fire.launches = saved
    if len(shapes) != 13 or any(t != MS_T for t, _ in shapes):
        raise SystemExit(f"[multistep] fire calls over {shapes}")
    lm["fire_shapes"] = shapes
    log(f"[multistep] [T, M] of the 13 launches: {shapes}")
    prof = _profile(torch, lambda: step(state, batch), f"[multistep-profile] one bf16 "
                    f"layer-major T={MS_T} B={MS_BATCH} step:", 13, 13)
    del state, batch, step
    torch.cuda.empty_cache()

    state, batch, step = setup(MS_BATCH, MS_T, torch.bfloat16, False)
    sm = _timed_steps(torch, step, state, batch, TRAIN_WARMUP, TRAIN_STEPS, ck)
    sm["frames_per_s"] = frames / sm["step_ms"] * 1e3
    log(f"[multistep] step-major (remat) T={MS_T} B={MS_BATCH} bf16: {json.dumps(sm)}")
    if sm["fire_bwd_launches"] != 13 * MS_T * TRAIN_STEPS:
        raise SystemExit(f"[multistep] step-major: {sm['fire_bwd_launches']} backward launches")
    del state, batch, step
    torch.cuda.empty_cache()

    paths = {steps: _kernel_vs_plain(
        torch, ck, lambda fire, steps=steps: setup(2, steps, torch.float32, True, fire, seed=6),
        f"[multistep] float32 B=2 T={steps} layer-major") for steps in (MS_T, LONG_T)}
    return {"layer_major": lm, "step_major": sm, "profile": prof, "paths": paths}


def eval_phase(torch, ck, cfg) -> dict:
    """``make_eval_step`` at B=16, float32: T=1 step-major, T=5 layer-major."""
    from stereospike_tpu_torch.data.synthetic import synthetic_batch
    from stereospike_tpu_torch.models.stereospike import init_params
    from stereospike_tpu_torch.objectives.losses import TotalLossConfig
    from stereospike_tpu_torch.train.steps import make_eval_step

    params = init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    out = {}
    for steps, multistep in ((1, False), (MS_T, True)):
        batch = synthetic_batch(torch.Generator(device="cuda").manual_seed(8), batch=EVAL_BATCH,
                                in_hw=cfg.in_hw, T=steps, device="cuda")
        step = make_eval_step(cfg, TotalLossConfig(), multistep=multistep)
        step(params, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ck.multistep_fire.launches = 0
        ck.multistep_fire_backward.launches = 0
        t0 = time.perf_counter()
        res = step(params, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        fwd, bwd = ck.multistep_fire.launches, ck.multistep_fire_backward.launches
        row = {"T": steps, "multistep": multistep, "batch": EVAL_BATCH, "step_ms": ms,
               "frames_per_s": EVAL_BATCH * steps / ms * 1e3,
               "peak_bytes": torch.cuda.max_memory_allocated(), "loss": float(res["loss"]),
               "mde": float(res["mde"]), "fire_fwd_launches": fwd, "fire_bwd_launches": bwd}
        log(f"[eval] {json.dumps(row)}")
        if fwd != 13 or bwd != 0:
            raise SystemExit(f"[eval] T={steps}: {fwd} forward and {bwd} backward launches; "
                             "expected 13 and 0")
        if not (math.isfinite(row["loss"]) and math.isfinite(row["mde"])
                and tuple(res["depth"].shape) == (EVAL_BATCH, *cfg.in_hw, 1)):
            raise SystemExit(f"[eval] T={steps}: loss {row['loss']}, mde {row['mde']}, depth "
                             f"{tuple(res['depth'].shape)}")
        out[f"T{steps}"] = row
    return out


def taps_phase(torch, ck, cfg) -> dict:
    """The 14 firing-rate densities at T=5, kernel fire against plain fire."""
    from stereospike_tpu_torch.data.synthetic import synthetic_batch
    from stereospike_tpu_torch.models.stereospike import (
        TAP_NAMES,
        firing_rates_sequence,
        init_params,
    )

    params = init_params(torch.Generator().manual_seed(0), cfg, device="cuda")
    frames = synthetic_batch(torch.Generator(device="cuda").manual_seed(9), batch=TAPS_BATCH,
                             in_hw=cfg.in_hw, T=MS_T, device="cuda")["chunks"]
    torch.backends.cudnn.deterministic = True
    ck.multistep_fire.launches = 0
    ck.multistep_fire_backward.launches = 0
    dens = {k: float(v) for k, v in firing_rates_sequence(params, frames, cfg).items()}
    fwd, bwd = ck.multistep_fire.launches, ck.multistep_fire_backward.launches
    plain = {k: float(v) for k, v in firing_rates_sequence(
        params, frames, cfg, fire_fn=ck.multistep_fire_reference).items()}
    torch.backends.cudnn.deterministic = False
    log(f"[taps] T={MS_T} B={TAPS_BATCH}: {json.dumps(dens)}; fire launches {fwd} forward, "
        f"{bwd} backward")
    if list(dens) != list(TAP_NAMES) or not all(0.0 <= v <= 1.0 for v in dens.values()):
        raise SystemExit(f"[taps] densities {dens}")
    if dens != plain:
        raise SystemExit(f"[taps] kernel densities differ from the plain fire's: {plain}")
    if fwd != 13 * MS_T or bwd != 0:
        raise SystemExit(f"[taps] {fwd} forward and {bwd} backward launches; expected "
                         f"{13 * MS_T} and 0")
    return {"densities": dens, "fire_fwd_launches": fwd}


def ann_phase(torch, cfg) -> dict:
    """The equivalent ANN (sigmoid) at the flagship's width, float32, B=16."""
    from stereospike_tpu_torch.data.synthetic import synthetic_batch
    from stereospike_tpu_torch.models.ann import AnnConfig, init_ann_params, init_ann_state
    from stereospike_tpu_torch.objectives.losses import TotalLossConfig
    from stereospike_tpu_torch.train.ann_steps import (
        create_ann_train_state,
        make_ann_eval_step,
        make_ann_train_step,
    )
    from stereospike_tpu_torch.train.state import make_optimizer

    acfg = AnnConfig(in_channels=cfg.in_channels, base_channels=cfg.base_channels,
                     in_hw=cfg.in_hw, activation="sigmoid")
    bn0 = init_ann_state(acfg, device="cuda")
    tx = make_optimizer(2e-4)
    state = create_ann_train_state(init_ann_params(torch.Generator().manual_seed(0), acfg,
                                                   device="cuda"), bn0, tx)
    batch = synthetic_batch(torch.Generator(device="cuda").manual_seed(10), batch=ANN_BATCH,
                            in_hw=cfg.in_hw, T=1, device="cuda")
    step = make_ann_train_step(acfg, TotalLossConfig(), tx)
    first = float(step(state, batch)[1]["loss"])
    row = _timed_steps(torch, step, state, batch, TRAIN_WARMUP - 1, TRAIN_STEPS)
    row["frames_per_s"] = ANN_BATCH / row["step_ms"] * 1e3
    row["first_loss"] = first
    moved = sum(not torch.equal(state.bn_state[k], bn0[k]) for k in bn0)
    row["bn_statistics_moved"] = f"{moved} of {len(bn0)}"
    ev_fn = make_ann_eval_step(acfg, TotalLossConfig())
    ev_fn(state.params, state.bn_state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = ev_fn(state.params, state.bn_state, batch)
    torch.cuda.synchronize()
    row["eval_ms"] = (time.perf_counter() - t0) * 1e3
    row["eval_loss"], row["eval_mde"] = float(ev["loss"]), float(ev["mde"])
    log(f"[ann] sigmoid float32 B={ANN_BATCH}: {json.dumps(row)}")
    if not row["loss"][-1] < first:
        raise SystemExit(f"[ann] the loss did not fall: {first} -> {row['loss']}")
    if moved != len(bn0):
        raise SystemExit(f"[ann] {moved} of {len(bn0)} BN running statistics moved")
    if not (math.isfinite(row["eval_loss"]) and math.isfinite(row["eval_mde"])):
        raise SystemExit(f"[ann] eval loss {row['eval_loss']} mde {row['eval_mde']}")
    return row


def _cli_run(torch, ck, argv, tag: str):
    """``cli.main(argv)`` in this process with the fire counts set to 0
    just before and read just after: (its JSON result, forward launches,
    backward launches, wall seconds)."""
    import contextlib
    import io

    from stereospike_tpu_torch import cli

    ck.multistep_fire.launches = 0
    ck.multistep_fire_backward.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = ck.multistep_fire.launches, ck.multistep_fire_backward.launches
    if rc != 0:
        raise SystemExit(f"[driver] {tag}: cli exit {rc}")
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    log(f"[driver] {tag}: {json.dumps(result)}; fire launches {fwd} forward, {bwd} backward; "
        f"{wall:.2f} s")
    return result, fwd, bwd, wall


def _expect(tag: str, got, want, phase: str = "driver") -> None:
    if got != want:
        raise SystemExit(f"[{phase}] {tag}: {got}, expected {want}")


def _finite(tag: str, result: dict, keys) -> None:
    for k in keys:
        if not math.isfinite(result[k]):
            raise SystemExit(f"[driver] {tag}: {k} = {result[k]}")


def _records(ckpt: Path):
    with open(ckpt / "training_metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _busy_ms(events) -> float:
    """The union of the device kernels' intervals, ms (two streams overlap)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def driver_profile(torch, ck, common, ckpt: Path, tag: str = "[driver-profile]",
                   staging: bool = True) -> dict:
    """torch.profiler over two steps (4 and 5) inside a running training
    loop, the prefetcher live: the device's idle share over those steps'
    wall time, the top kernels, the fire kernels, the all-reduce calls
    (``c10d::allreduce_`` and the backend's own op) and their kernels, and
    the device time of the wire unpack and the augmentation (their
    ``record_function`` spans); with ``staging``, :func:`staging_profile`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stereospike_tpu_torch import cli
    from stereospike_tpu_torch.train import loop

    args = cli.build_parser().parse_args(["train", *common, "--checkpoint-dir", str(ckpt),
                                          "--epochs", "1"])
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def hook(step: int) -> None:
        if step == 3:
            torch.cuda.synchronize()
            prof.__enter__()
            window["t0"] = time.perf_counter()
        elif step == 5:
            torch.cuda.synchronize()
            window["wall_ms"] = (time.perf_counter() - window["t0"]) * 1e3
            prof.__exit__(None, None, None)

    loop.train_loop(cli.build_config(args), synthetic=True, max_steps=6, device="cuda",
                    on_step=hook)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        log(f"{tag} torch.profiler reported no device time: not measured")
        return {"idle_share": None}
    host_ops = [e.name for e in prof.events() if e.device_type != DeviceType.CUDA]
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = _busy_ms(dev)
    spans = {}
    for e in prof.key_averages():
        if e.key in ("stereospike::augment", "stereospike::unpack"):
            spans[e.key] = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
    out = {"wall_ms": window["wall_ms"], "busy_ms": busy,
           "idle_share": 1 - busy / window["wall_ms"],
           "fire_fwd": sum("fire_fwd_kernel" in e.name for e in dev),
           "fire_bwd": sum("fire_bwd_kernel" in e.name for e in dev),
           "allreduce_calls": sum(n == "c10d::allreduce_" for n in host_ops),
           "backend_allreduce_ops": sum(n in ("nccl:all_reduce", "gloo:all_reduce")
                                        for n in host_ops),
           "nccl_kernels": sum("nccl" in e.name.lower() for e in dev),
           # the worker thread's spans, where the profiler records them
           "worker_spans_ms": {k: v / 1e3 for k, v in spans.items()},
           "top": [[n[:80], ms] for n, ms in sorted(by_name.items(), key=lambda r: -r[1])[:10]]}
    log(f"{tag} two bf16 B={DRIVER_BATCH} steps in the running loop: {json.dumps(out)}")
    if staging:
        out["staging"] = staging_profile(torch, cli.build_config(args))
    return out


def staging_profile(torch, cfg) -> dict:
    """One training batch's input stage, in this thread: the host time to
    assemble it (``batches``) and to stage it (pin, upload, unpack,
    augment: the worker's share of a step), and under torch.profiler the
    device time of the wire unpack's and the augmentation's kernels and of
    the host-to-device copies."""
    import types

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stereospike_tpu_torch.data.augmentation import AugmentConfig
    from stereospike_tpu_torch.train import loop

    (train_view, _, _), _ = loop._make_data(cfg, True, device="cuda")
    batches = loop._batch_iter(cfg, train_view, shuffle=True, seed=cfg.seed)
    state = types.SimpleNamespace(generator=torch.Generator().manual_seed(1),
                                  device_generator=torch.Generator(device="cuda").manual_seed(2))
    stager = loop._Stager(torch.device("cuda"))
    prep = loop._augmented_prep(stager, AugmentConfig(), ("chunks", "gt", "mask"), True, state)
    stager(prep, next(batches)).take()
    torch.cuda.synchronize()
    assemble, stage = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        host = next(batches)
        t1 = time.perf_counter()
        staged = stager(prep, host)
        t2 = time.perf_counter()
        staged.take()
        torch.cuda.synchronize()
        assemble.append((t1 - t0) * 1e3)
        stage.append((t2 - t1) * 1e3)
    host = next(batches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stager(prep, host).take()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = {e.key: getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)) / 1e3
             for e in prof.key_averages()
             if e.key in ("stereospike::augment", "stereospike::unpack")}
    out = {"assemble_host_ms": statistics.median(assemble),
           "stage_host_ms": statistics.median(stage),
           "augment_device_ms": spans.get("stereospike::augment"),
           "unpack_device_ms": spans.get("stereospike::unpack"),
           "h2d_device_ms": sum(e.time_range.elapsed_us() for e in dev
                                if "memcpy" in e.name.lower()) / 1e3,
           "copies": [[e.name[:60], e.time_range.elapsed_us()] for e in dev
                      if "memcpy" in e.name.lower()],
           "host_bytes": int(sum(a.nbytes for a in host.values())),
           "kernels": len([e for e in dev if "memcpy" not in e.name.lower()])}
    log(f"[driver-staging] one B={cfg.batch_size} training batch's input stage: "
        f"{json.dumps(out)}")
    return out


def _driver_flags():
    """``driver_phase``'s CLI flags: (data, the flagship at bf16 and B=16, its
    training run: T=1, augmentation, packed uploads, prefetch 2)."""
    hw = ",".join(map(str, FLAGSHIP_HW))
    data = ["--synthetic", "--device", "cuda", "--in-hw", hw, "--seed", "0",
            "--synth-frames", str(DRIVER_FRAMES), "--synth-learnable", "true"]
    flagship = [*data, "--model", "stereospike", "--compute-dtype", "bfloat16",
                "--batch-size", str(DRIVER_BATCH)]
    train = [*flagship, "--n-timesteps", "1", "--augment", "true", "--pack-io", "true",
             "--prefetch", "2"]
    return data, flagship, train


def driver_phase(torch, ck, bare_frames_per_s: float, keep: Path) -> dict:
    """The training driver on the card, through the CLI, on the learnable
    synthetic MVSEC fixture at 260×346 (written once, removed at the end).
    The trained ``best.pt`` is copied into ``keep`` for the serving phase."""
    import shutil
    import tempfile

    from stereospike_tpu_torch.train import loop

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_driver_"))
    try:
        data, flagship, train = _driver_flags()
        ckpt = work / "flagship"
        steps = 2 * (DRIVER_FRAMES - 2) // DRIVER_BATCH           # per epoch
        n_val = len(range(0, DRIVER_FRAMES - 2, 3))
        n_test = len(range(1, DRIVER_FRAMES - 2, 3))
        val_batches = -(-n_val // DRIVER_BATCH)
        test_batches = -(-n_test // DRIVER_BATCH)

        torch.cuda.reset_peak_memory_stats()
        tr, fwd, bwd, wall = _cli_run(torch, ck, ["train", *train, "--epochs", "2",
                                                  "--checkpoint-dir", str(ckpt)],
                                      "train 2 epochs")
        peak = torch.cuda.max_memory_allocated()
        _expect("train steps per epoch", tr["steps_per_epoch"], steps)
        _expect("train forward launches", fwd, 13 * 2 * (steps + val_batches))
        _expect("train backward launches", bwd, 13 * 2 * steps)
        for name in ("best.pt", "latest.pt"):
            if not (ckpt / name).exists():
                raise SystemExit(f"[driver] train wrote no {name}")
        recs = _records(ckpt)
        _expect("train epochs logged", len(recs), 2)
        for r in recs:
            _finite("train", r, ("train_loss", "train_MDE", "val_loss", "val_MDE"))
        if "h5py" in sys.modules:
            raise SystemExit("[driver] the --synthetic path imported h5py")

        ev, efwd, ebwd, ewall = _cli_run(torch, ck, ["eval", *flagship, "--which", "best.pt",
                                                     "--checkpoint-dir", str(ckpt)], "eval")
        _expect("eval launches", (efwd, ebwd), (13 * test_batches, 0))
        _expect("eval samples", ev["n_samples"], n_test)
        _finite("eval", ev, ("test_loss", "test_MDE"))

        fr, ffwd, fbwd, _ = _cli_run(torch, ck, ["firing-rates", *flagship,
                                                 "--checkpoint-dir", str(ckpt)],
                                     "firing-rates")
        _expect("firing-rates launches", (ffwd, fbwd), (13 * test_batches, 0))
        if len(fr) != 14 or not all(0.0 <= v <= 1.0 for v in fr.values()):
            raise SystemExit(f"[driver] firing rates {fr}")

        rs, rfwd, rbwd, _ = _cli_run(torch, ck, ["train", *train, "--epochs", "3", "--resume",
                                                 "true", "--checkpoint-dir", str(ckpt)],
                                     "train --resume to epoch 3")
        _expect("resumed epoch", rs["epoch"], 2)
        with open(ckpt / "checkpoint_meta.json") as f:
            _expect("resumed step count", json.load(f)["step"], 3 * steps)
        _expect("resume launches", (rfwd, rbwd), (13 * (steps + val_batches), 13 * steps))
        _finite("resume", rs, ("train_loss", "val_MDE"))

        # layer-major T=5 with a warmup chunk and seeded integrators: per
        # step a no-grad warmup forward (13) and the train forward and
        # backward (13 + 13); validation has no warmup
        lm_val = -(-len([i for i in range(0, DRIVER_FRAMES - 2, 3)
                         if i < DRIVER_FRAMES - (1 + MS_T)]) // LM_BATCH)
        lm, lfwd, lbwd, _ = _cli_run(torch, ck, [
            "train", *data, "--model", "stereospike", "--compute-dtype", "bfloat16",
            "--batch-size", str(LM_BATCH), "--n-inference", str(MS_T), "--n-timesteps",
            str(MS_T), "--multistep", "true", "--use-warmup", "true", "--use-init-pots", "true",
            "--max-steps", str(LM_STEPS), "--epochs", "1", "--checkpoint-dir",
            str(work / "layer_major")], "layer-major T=5 warmup init-pots")
        _expect("layer-major launches", (lfwd, lbwd),
                (13 * (2 * LM_STEPS + lm_val), 13 * LM_STEPS))
        _finite("layer-major", lm, ("train_loss", "val_MDE"))

        dn, dfwd, dbwd, _ = _cli_run(torch, ck, [
            "train", *data, "--dataset", "dense", "--model", "stereospike_monocular",
            "--compute-dtype", "bfloat16", "--batch-size", str(DENSE_BATCH), "--epochs", "1",
            "--checkpoint-dir", str(work / "dense")], "DENSE 1 epoch")
        # 12 maps: 8 train, 2 val, 2 test
        _expect("DENSE launches", (dfwd, dbwd), (13 * (8 // DENSE_BATCH + 1),
                                                 13 * (8 // DENSE_BATCH)))
        _finite("DENSE", dn, ("train_loss", "val_MDE"))

        prof = driver_profile(torch, ck, train, work / "profile")
        row = {
            "fixture_write_s": tr["fixture_write_s"], "data_build_s": tr["data_build_s"],
            "steps_per_epoch": tr["steps_per_epoch"],
            # epoch 1: the first after cuDNN's autotuning and the allocator's warm-up
            "train_frames_per_s": recs[1]["train_frames_per_s"],
            "train_frames_per_s_epoch0": recs[0]["train_frames_per_s"],
            "bare_step_frames_per_s": bare_frames_per_s,
            "train_time_s": [r["train_time_s"] for r in recs],
            "val_time_s": [r["val_time_s"] for r in recs],
            "train_wall_s": wall, "eval_wall_s": ewall, "test_MDE": ev["test_MDE"],
            "val_MDE": [r["val_MDE"] for r in recs], "peak_bytes": peak,
            "launches": {"train": [fwd, bwd], "eval": [efwd, ebwd], "firing_rates": [ffwd, fbwd],
                         "resume": [rfwd, rbwd], "layer_major": [lfwd, lbwd],
                         "dense": [dfwd, dbwd]},
            "idle_share": prof.get("idle_share"), "profile": prof,
            "h5py_imported": "h5py" in sys.modules,
        }
        print(json.dumps({"driver": row}), flush=True)
        keep.mkdir(parents=True, exist_ok=True)
        shutil.copy(ckpt / "best.pt", keep / "best.pt")
        return row
    finally:
        shutil.rmtree(work, ignore_errors=True)
        for root, _ in loop._FIXTURES.values():  # the fixture: written once, removed here
            shutil.rmtree(root, ignore_errors=True)
        loop._FIXTURES.clear()


def _serving_windows(n_windows: int, streams: int, eyes=("left", "right"), seed: int = 0):
    """``n_windows`` lists of ``streams`` synthetic window dicts at 260×346
    (stream s draws from seed ``seed + 1000·s``)."""
    from stereospike_tpu_torch.sources import SyntheticSource

    per_stream = [list(SyntheticSource(hw=FLAGSHIP_HW, eyes=eyes, n_windows=n_windows,
                                       events_per_window=EVENTS_PER_WINDOW,
                                       seed=seed + 1000 * s)) for s in range(streams)]
    return [[per_stream[s][i] for s in range(streams)] for i in range(n_windows)]


def _serve_timed(torch, ck, ev, windows, stacked: bool = True):
    """Push ``windows`` through ``ev`` (host clock per push, as ``stream_loop``
    times it), drain the pipeline: (depths, per-push ms, forward launches,
    seconds from the end of the first push to the end of the drain)."""
    ck.multistep_fire.launches = 0
    depths, lat = [], []
    t_first = None
    for win in windows:
        t0 = time.perf_counter()
        d = ev.push(win if stacked else win[0])
        lat.append((time.perf_counter() - t0) * 1e3)
        t_first = t_first or time.perf_counter()
        if d is not None:
            depths.append(d)
    while (d := ev.flush()) is not None:
        depths.append(d)
    torch.cuda.synchronize()
    return depths, lat, ck.multistep_fire.launches, time.perf_counter() - t_first


def _interval(lat) -> dict:
    steady = lat[1:] or lat
    return {"interval_ms_mean": statistics.fmean(steady),
            "interval_ms_p99": float(sorted(steady)[max(0, math.ceil(0.99 * len(steady)) - 1)])}


def _producer(send_events, recv_depth, port: int, packets, n_replies: int, out: list,
              errors: list) -> None:
    """A camera driver on the loopback: connect (the server may still be
    loading), send ``packets``, read ``n_replies`` depth replies."""
    import socket

    try:
        deadline = time.time() + 120
        while True:
            try:
                sock = socket.create_connection(("127.0.0.1", port), timeout=5)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.05)
        with sock:
            sock.settimeout(120)
            for eye, ev in packets:
                send_events(sock, eye, ev)
            for _ in range(n_replies):
                out.append(recv_depth(sock))
    except Exception as e:  # reported by the caller
        errors.append(e)


def _socket_case(torch, ck, sources, model: str, eyes, common, n_windows: int) -> dict:
    """``cli stream --listen --reply --n-windows N`` fed by a producer
    thread; the replies against a direct evaluator on the windows the wire
    assembles (float32, deterministic cuDNN: equal bit for bit)."""
    import socket
    import threading

    from stereospike_tpu_torch import cli
    from stereospike_tpu_torch.streaming import StreamingEvaluator
    from stereospike_tpu_torch.train import loop

    rng = np.random.default_rng(7)
    streams = []
    for e in range(len(eyes)):
        n = (n_windows + 1) * EVENTS_PER_WINDOW
        t = 1.7e9 + np.sort(rng.uniform(0, 0.05 * (n_windows + 1), n))
        ev = np.stack([rng.integers(0, FLAGSHIP_HW[1], n), rng.integers(0, FLAGSHIP_HW[0], n),
                       t, rng.integers(0, 2, n)], axis=1).astype(np.float64)
        streams.append([(e, chunk) for chunk in np.array_split(ev, 8 * (n_windows + 1))])
    # the windows the wire assembles; stop at the packet that completes window N
    asm = sources._WindowAssembler(eyes, 0.05)
    packets, windows = [], []
    for eye, ev in (p for group in zip(*streams) for p in group):
        if len(windows) == n_windows:
            break
        packets.append((eye, ev))
        t_base = float(ev[0, 2])
        wire = ev.astype(np.float32).astype(np.float64)
        wire[:, 2] = (ev[:, 2] - t_base).astype(np.float32).astype(np.float64) + t_base
        asm.add(eyes[eye], wire)
        while asm.ready():
            windows.append(asm.emit())
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    replies, errors = [], []
    thread = threading.Thread(target=_producer, args=(sources.send_events, sources.recv_depth,
                                                      port, packets, n_windows, replies,
                                                      errors), daemon=True)
    thread.start()
    argv = ["stream", *common, "--model", model, "--listen", f"127.0.0.1:{port}", "--reply",
            "--n-windows", str(n_windows)]
    result, fwd, _, wall = _cli_run(torch, ck, argv, f"stream --listen --reply {model}")
    thread.join(60)
    if thread.is_alive() or errors:
        raise SystemExit(f"[serving] {model} producer: {errors or 'still running'}")
    _expect(f"{model} windows served", result["n_windows"], n_windows, "serving")
    _expect(f"{model} replies", len(replies), n_windows, "serving")
    _expect(f"{model} fire launches", fwd, 13 * n_windows, "serving")
    cfg = cli.build_config(cli.build_parser().parse_args(argv))
    model_cfg = loop.build_model_config(cfg)
    direct = StreamingEvaluator(loop._load_params(cfg, model_cfg, "best.pt", "cuda"), model_cfg,
                                eyes=eyes, reset_each_window=False)
    saved = ck.multistep_fire.launches
    diff = max(float(np.abs(r - direct.push(w)[None, ..., 0]).max())
               for r, w in zip(replies, windows))
    ck.multistep_fire.launches = saved
    log(f"[serving] {model}: {n_windows} replies against a direct evaluator, max |diff| "
        f"{diff} (tolerance 0)")
    if diff != 0.0:
        raise SystemExit(f"[serving] {model}: socket replies differ from the direct evaluator")
    return {"result": result, "launches": fwd, "wall_s": wall, "max_abs_diff": diff}


def serving_phase(torch, ck, cfg, trained: Path) -> dict:
    """The rest of serving on the card: 8 cameras in one batched step,
    trained weights through ``--which`` and ``--import-pth``, the loopback
    SPKE socket with replies, an AEDAT 3.1 recording, and ``.ssx``
    artifacts (export, ``from_artifact``, ``stream --artifact``)."""
    import shutil
    import tempfile

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stereospike_tpu_torch import cli, sources
    from stereospike_tpu_torch.streaming import StreamingEvaluator
    from stereospike_tpu_torch.train import loop

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_serving_"))
    torch.backends.cudnn.deterministic = True  # each comparison below differs only where stated
    try:
        hw = ",".join(map(str, FLAGSHIP_HW))
        common = ["--device", "cuda", "--in-hw", hw, "--seed", "0", "--compute-dtype", "float32",
                  "--tensorboard", "false", "--checkpoint-dir", str(trained)]
        row = {}

        # trained weights: --which best.pt, and --import-pth of their export-pth file
        def stream_depths(extra, tag):
            args = cli.build_parser().parse_args(["stream", "--synthetic", "--n-windows",
                                                  str(N_WINDOWS), *common, *extra])
            depths = []
            ck.multistep_fire.launches = 0
            res = loop.stream_loop(cli.build_config(args), synthetic=True,
                                   n_windows=args.n_windows, pipeline=args.pipeline,
                                   events_per_window=args.events_per_window, which=args.which,
                                   device="cuda", depths=depths)
            torch.cuda.synchronize()
            _expect(f"{tag} fire launches", ck.multistep_fire.launches, 13 * N_WINDOWS,
                    "serving")
            _expect(f"{tag} windows", len(depths), N_WINDOWS, "serving")
            log(f"[serving] stream {tag}: {json.dumps(res)}")
            return res, depths

        base = cli.build_config(cli.build_parser().parse_args(["stream", *common]))
        model_cfg = loop.build_model_config(base)
        params = loop._load_params(base, model_cfg, "best.pt", "cuda")
        # the checkpoint as a reference .pth, through cli export-pth
        pth = work / "trained.pth"
        row["export_pth"], _, _, _ = _cli_run(torch, ck, ["export-pth", *common, "--which",
                                                          "best.pt", "--out", str(pth)],
                                              "export-pth")
        which, d_which = stream_depths(["--which", "best.pt"], "--which best.pt")
        _, d_pth = stream_depths(["--import-pth", str(pth), "--which", "absent.pt"],
                                 "--import-pth of the export-pth file")
        diff = max(float(np.abs(a - b).max()) for a, b in zip(d_which, d_pth))
        if diff != 0.0:
            raise SystemExit(f"[serving] --which best.pt and --import-pth differ by {diff}")
        row["s1"] = {k: which[k] for k in ("interval_ms_mean", "interval_ms_p99")}
        row["trained_which_vs_pth_max_abs_diff"] = diff

        # 8 cameras in one batched step, float32 and bf16, against 1-stream evaluators
        windows = _serving_windows(N_WINDOWS, SERVE_STREAMS)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).removeprefix("torch.")
            torch.cuda.reset_peak_memory_stats()
            ev = StreamingEvaluator(params, model_cfg, n_streams=SERVE_STREAMS, pipeline=1,
                                    reset_each_window=False, compute_dtype=dtype)
            depths, lat, launches, seconds = _serve_timed(torch, ck, ev, windows)
            _expect(f"S={SERVE_STREAMS} {name} fire launches", launches, 13 * N_WINDOWS,
                    "serving")
            if len(depths) != N_WINDOWS or any(d.shape != (SERVE_STREAMS, *FLAGSHIP_HW, 1)
                                               or not np.isfinite(d).all() for d in depths):
                raise SystemExit(f"[serving] S={SERVE_STREAMS} {name}: bad depths")
            out = {**_interval(lat), "launches": launches,
                   "stream_windows_per_s": SERVE_STREAMS * (N_WINDOWS - 1) / seconds,
                   "peak_bytes": torch.cuda.max_memory_allocated()}
            # stream s against a 1-stream evaluator fed stream s's windows
            saved = ck.multistep_fire.launches
            worst = 0.0
            for s in range(SERVE_STREAMS):
                one = StreamingEvaluator(params, model_cfg, reset_each_window=False,
                                         compute_dtype=dtype)
                for i, win in enumerate(windows):
                    worst = max(worst, float(np.abs(one.push(win[s]) - depths[i][s]).max()))
            ck.multistep_fire.launches = saved
            out["per_stream_max_abs_diff"] = worst
            tol = SERVE_STREAM_TOL[name]
            log(f"[serving] S={SERVE_STREAMS} {name}: {json.dumps(out)}; stream s vs a "
                f"1-stream evaluator max |diff| {worst} (tolerance {tol})")
            if worst > tol:
                raise SystemExit(f"[serving] S={SERVE_STREAMS} {name}: a stream differs from "
                                 f"its 1-stream evaluator by {worst} > {tol}")
            row[f"s{SERVE_STREAMS}_{name}"] = out
            # the fire kernel's and the device's time per window (torch.profiler)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for win in windows[:5]:
                    ev.push(win)
                while ev.flush() is not None:
                    pass
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / 5
            dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            fire = [e for e in dev if "fire_fwd_kernel" in e.name]
            if dev and len(fire) != 13 * 5:
                raise SystemExit(f"[serving] {len(fire)} fire kernels in 5 S=8 windows")
            out["fire_path_ms"] = (sum(e.time_range.elapsed_us() for e in fire) / 5e3
                                   if dev else None)
            out["busy_ms"] = _busy_ms(dev) / 5 if dev else None
            out["profiled_wall_ms"] = wall_ms
            # x, v0 in and spikes, v_T out at T=1: 4·M values
            m = SERVE_STREAMS * sum(mm for _, mm in site_sizes(cfg))
            elem = torch.empty(0, dtype=dtype).element_size()
            out["fire_bound_ms"] = 4 * m * elem / HBM_BYTES_PER_S * 1e3
            log(f"[serving] S={SERVE_STREAMS} {name} profiled window: wall {wall_ms:.3f} "
                f"ms, busy {out['busy_ms']} ms, fire_fwd {out['fire_path_ms']} ms "
                f"(bound {out['fire_bound_ms']:.4f} ms)")
            del ev

        # the loopback socket, monocular and binocular
        # (the monocular model from seed 0: the trained checkpoint is binocular)
        row["socket"] = {
            model: _socket_case(torch, ck, sources, model, eyes, [*common, *extra],
                                SOCKET_WINDOWS)
            for model, eyes, extra in (
                ("stereospike_monocular", ("left",), ["--checkpoint-dir", str(work / "mono")]),
                ("stereospike", ("left", "right"), []))}

        # a stereo AEDAT 3.1 recording (written from synthetic events)
        rng = np.random.default_rng(11)
        paths = []
        for eye in ("left", "right"):
            n = AEDAT_WINDOWS * EVENTS_PER_WINDOW
            ev = np.stack([rng.integers(0, FLAGSHIP_HW[1], n), rng.integers(0, FLAGSHIP_HW[0], n),
                           5.0 + np.sort(rng.uniform(0, 0.05 * AEDAT_WINDOWS, n)),
                           rng.integers(0, 2, n)], axis=1).astype(np.float64)
            paths.append(str(work / f"{eye}.aedat"))
            sources.write_aedat31(paths[-1], ev)
        # every window of the recording: its full windows and the partial tail
        n_aedat = len(list(sources.AedatFileSource(dict(zip(("left", "right"), paths)))))
        if n_aedat < AEDAT_WINDOWS:
            raise SystemExit(f"[serving] the recording holds {n_aedat} windows")
        aedat, afwd, _, _ = _cli_run(torch, ck, ["stream", *common, "--aedat", ",".join(paths),
                                                 "--n-windows", "0"], "stream --aedat")
        _expect("AEDAT windows", aedat["n_windows"], n_aedat, "serving")
        _expect("AEDAT late events", aedat["late_events"], 0, "serving")
        _expect("AEDAT fire launches", afwd, 13 * n_aedat, "serving")
        row["aedat"] = aedat

        # artifacts: float32 at S=1, bf16 at S=4
        arts = {}
        for name, streams, dtype in (("float32", 1, "float32"), ("bf16_s4", 4, "bfloat16")):
            path = work / f"{name}.ssx"
            argv = ["export-serving", *common, "--out", str(path), "--which", "best.pt",
                    "--n-streams", str(streams), "--compute-dtype", dtype]
            exp, _, _, export_s = _cli_run(torch, ck, argv, f"export-serving {name}")
            arts[name] = {"bytes": exp["bytes"], "export_s": export_s, "path": path}
        served = StreamingEvaluator.from_artifact(str(arts["float32"]["path"]),
                                                  reset_each_window=False)
        live = StreamingEvaluator(params, model_cfg, reset_each_window=False)
        five = [w[0] for w in windows[:5]]
        a_depths, _, a_launches, _ = _serve_timed(torch, ck, served, [[w] for w in five], False)
        saved = ck.multistep_fire.launches
        l_depths = [live.push(w) for w in five]
        ck.multistep_fire.launches = saved
        _expect("artifact fire launches", a_launches, 13 * 5, "serving")
        if not all(np.array_equal(a, b) for a, b in zip(a_depths, l_depths, strict=True)):
            raise SystemExit("[serving] the float32 artifact differs from the live evaluator")
        if served.binning_dropped != live.binning_dropped:
            raise SystemExit("[serving] the artifact's rejected count differs from the live one")
        four = StreamingEvaluator.from_artifact(str(arts["bf16_s4"]["path"]), pipeline=1,
                                                reset_each_window=False)
        q_depths, _, q_launches, _ = _serve_timed(torch, ck, four,
                                                  [w[:4] for w in windows[:5]])
        _expect("bf16 S=4 artifact fire launches", q_launches, 13 * 5, "serving")
        if any(d.shape != (4, *FLAGSHIP_HW, 1) or not np.isfinite(d).all() for d in q_depths):
            raise SystemExit("[serving] bf16 S=4 artifact: bad depths")
        del served, four, live
        art_run, art_fwd, _, _ = _cli_run(torch, ck, [
            "stream", *common, "--artifact", str(arts["float32"]["path"]), "--synthetic",
            "--n-windows", str(N_WINDOWS)], "stream --artifact")
        _expect("stream --artifact windows", art_run["n_windows"], N_WINDOWS, "serving")
        _expect("stream --artifact fire launches", art_fwd, 13 * N_WINDOWS, "serving")
        row["artifacts"] = {k: {kk: vv for kk, vv in v.items() if kk != "path"}
                            for k, v in arts.items()}
        row["artifact_stream"] = art_run
        row["artifact_vs_live"] = "equal bit for bit"
        print(json.dumps({"serving": row}), flush=True)
        return row
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(work, ignore_errors=True)


# ------------------------------------------------------------- data parallel
def _workers(argvs, envs, work: Path, tag: str, timeout_s: float = 900.0) -> None:
    """Start one process per argv (its output to a file, not a pipe), wait
    for all, stop any still running at the deadline or on a failure, and
    fail unless each exits 0; the end of each one's output is logged."""
    procs = []
    try:
        for i, (argv, env) in enumerate(zip(argvs, envs)):
            out = open(work / f"{tag}_{i}.log", "w")
            procs.append((subprocess.Popen(argv, cwd=ROOT, env=env, stdout=out,
                                           stderr=subprocess.STDOUT), out))
        deadline = time.time() + timeout_s
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.time(), 1.0))
    finally:
        for p, out in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
    for i, (p, out) in enumerate(procs):
        text = Path(out.name).read_text()
        tail = [ln for ln in text.splitlines() if "ptxas" not in ln][-12:]
        log(f"[parallel] {tag} process {i} exit {p.returncode}; its last lines:\n  "
            + "\n  ".join(tail))
        if p.returncode != 0:
            raise SystemExit(f"[parallel] {tag} process {i} exited {p.returncode}")


def _gloo_setup(torch, cfg, batch_size: int, group=None):
    """The two-rank comparison's state, global batch and step: the flagship
    from seed 0, float32, layer-major at T=MS_T."""
    from stereospike_tpu_torch.data.synthetic import synthetic_batch
    from stereospike_tpu_torch.models.stereospike import init_params
    from stereospike_tpu_torch.objectives.losses import TotalLossConfig
    from stereospike_tpu_torch.train.state import create_train_state, make_optimizer
    from stereospike_tpu_torch.train.steps import make_train_step

    tx = make_optimizer(2e-4)
    state = create_train_state(init_params(torch.Generator().manual_seed(0), cfg,
                                           device="cuda"), tx, torch.Generator().manual_seed(1))
    batch = synthetic_batch(torch.Generator(device="cuda").manual_seed(7), batch=batch_size,
                            in_hw=cfg.in_hw, T=MS_T, device="cuda")
    step = make_train_step(cfg, TotalLossConfig(), tx, compute_dtype=torch.float32,
                           multistep=True, group=group)
    return state, batch, step


def _gloo_steps(torch, state, batch, step) -> dict:
    """GLOO_STEPS steps: their losses and MDEs, and the parameters before
    and after each step (``params[i]`` after i steps), on the host."""
    params = [{k: p.detach().cpu().clone() for k, p in state.params.items()}]
    metrics = []
    for _ in range(GLOO_STEPS):
        metrics.append(step(state, batch)[1])
        params.append({k: p.detach().cpu().clone() for k, p in state.params.items()})
    return {"loss": [float(m["loss"]) for m in metrics], "mde": [float(m["mde"]) for m in metrics],
            "params": params}


def _change_rel(got: dict, want: dict, start: dict) -> dict:
    """Each tensor's ‖got − want‖ / ‖want − start‖ (float64 L2 norms): the
    parameters' change over the steps against the reference change. A
    tensor that the reference leaves as it was is left out if ``got``
    equals it, and reads inf if not."""
    out = {}
    for k, w in want.items():
        moved = float((w.double() - start[k].double()).norm())
        off = float((got[k].double() - w.double()).norm())
        if moved:
            out[k] = off / moved
        elif off:
            out[k] = math.inf
    return out


def dp_worker(mode: str, work: Path) -> int:
    """One rank of the parallel phase (``chip_smoke.py --dp-worker MODE DIR``):
    ``world1`` under ``torch.distributed.run --nproc_per_node 1``, ``gloo``
    as one of two ranks on the one card; the results go to ``DIR``."""
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    from stereospike_tpu_torch.models import factory
    from stereospike_tpu_torch.parallel import make_mesh, make_sharded_train_step
    from stereospike_tpu_torch.snn import cuda_kernels as ck

    cfg = factory.stereospike(in_hw=FLAGSHIP_HW)
    if mode == "gloo":
        dist.init_process_group("gloo")  # NCCL refuses two ranks on one card
        mesh = make_mesh(device="cuda")
        torch.backends.cudnn.deterministic = True
        state, batch, step = _gloo_setup(torch, cfg, GLOO_BATCH * mesh.world, mesh.group)
        out = _gloo_steps(torch, state, batch, make_sharded_train_step(step, mesh))
        out["params"] = [out["params"][0], out["params"][-1]]  # the start and the end
        torch.save(out, work / f"gloo_{mesh.rank}.pt")
        dist.destroy_process_group()
        return 0

    from stereospike_tpu_torch.data.synthetic import synthetic_batch
    from stereospike_tpu_torch.models.stereospike import init_params
    from stereospike_tpu_torch.objectives.losses import TotalLossConfig
    from stereospike_tpu_torch.train.state import create_train_state, make_optimizer
    from stereospike_tpu_torch.train.steps import make_train_step

    _, _, train = _driver_flags()
    flags = [*train, "--mesh-shape", "1,1", "--tensorboard", "false"]
    row = {"world": int(os.environ["WORLD_SIZE"])}
    # two steps profiled inside the running loop of cli train's train_loop
    row["profile"] = driver_profile(torch, ck, flags, work / "profile",
                                    "[parallel] world 1 NCCL:", staging=False)
    # the bare step as train_phase times it, with the world-1 group and
    # without, in this process: each timed twice, in the order without,
    # with, with, without, each time after the same warm-up
    mesh = make_mesh((1, 1), device="cuda")
    tx = make_optimizer(2e-4)
    state = create_train_state(init_params(torch.Generator().manual_seed(0), cfg,
                                           device="cuda"), tx, torch.Generator().manual_seed(1))
    batch = synthetic_batch(torch.Generator(device="cuda").manual_seed(2), batch=TRAIN_BATCH,
                            in_hw=cfg.in_hw, T=1, device="cuda")
    steps = {g: make_train_step(cfg, TotalLossConfig(), tx, compute_dtype=torch.bfloat16,
                                group=mesh.group if g == "group" else None)
             for g in ("no_group", "group")}
    row["step"] = {"no_group": [], "group": []}
    for g in ("no_group", "group", "group", "no_group"):
        row["step"][g].append(_timed_steps(torch, steps[g], state, batch, TRAIN_WARMUP,
                                           TRAIN_STEPS, ck))
    del state, batch, steps
    torch.cuda.empty_cache()
    # cli train itself, counted; it ends the process group
    res, fwd, bwd, wall = _cli_run(torch, ck, [
        "train", *flags, "--epochs", "1", "--max-steps", str(DP_STEPS), "--checkpoint-dir",
        str(work / "cli")], "torchrun world 1: cli train --mesh-shape 1,1")
    row["cli"] = {"result": res, "launches": [fwd, bwd], "wall_s": wall}
    (work / "world1.json").write_text(json.dumps(row))
    return 0


def parallel_phase(torch, ck, cfg, bare_step_ms: float) -> dict:
    """Data parallelism on the card: ``cli train --mesh-shape 1,1`` under
    ``python -m torch.distributed.run --nproc_per_node 1`` (NCCL, world 1);
    two gloo ranks sharing the card against one process on their global
    batch; ``cli doctor``."""
    import shutil
    import socket
    import tempfile

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_parallel_"))
    row = {}
    try:
        # 1. world 1 over NCCL, through the launcher a user runs
        torch.cuda.empty_cache()
        _workers([[sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node", "1", str(ROOT / "chip_smoke.py"), "--dp-worker",
                   "world1", str(work)]], [dict(os.environ)], work, "torchrun world 1")
        w1 = json.loads((work / "world1.json").read_text())
        prof, step, cli_run = w1["profile"], w1["step"], w1["cli"]
        if prof.get("idle_share") is None:
            raise SystemExit("[parallel] torch.profiler recorded no device time in the world-1 "
                             "run: its fire launches and all-reduces went unchecked")
        _expect("world-1 profiled fire launches over 2 steps",
                (prof["fire_fwd"], prof["fire_bwd"]), (26, 26), "parallel")
        _expect("world-1 profiled all-reduce calls over 2 steps",
                (prof["allreduce_calls"], prof["backend_allreduce_ops"]),
                (2 * DP_ALLREDUCES_PER_STEP, 2 * DP_ALLREDUCES_PER_STEP), "parallel")
        for g, runs in step.items():
            for r in runs:
                _expect(f"world-1 timed step launches ({g})",
                        (r["fire_fwd_launches"], r["fire_bwd_launches"]),
                        (13 * TRAIN_STEPS, 13 * TRAIN_STEPS), "parallel")
        n_val = len(range(0, DRIVER_FRAMES - 2, 3))
        _expect("world-1 cli train launches", cli_run["launches"],
                [13 * (DP_STEPS + -(-n_val // DRIVER_BATCH)), 13 * DP_STEPS], "parallel")
        _finite("world-1 cli train", cli_run["result"], ("train_loss", "val_MDE"))
        with_group = statistics.fmean(r["step_ms"] for r in step["group"])
        without = statistics.fmean(r["step_ms"] for r in step["no_group"])
        row["world1_nccl"] = {
            "launches_per_step_profiled": [prof["fire_fwd"] / 2, prof["fire_bwd"] / 2],
            "allreduce_calls_per_step": prof["allreduce_calls"] / 2,
            "nccl_ops_per_step": prof["backend_allreduce_ops"] / 2,
            "nccl_kernels_per_step": prof["nccl_kernels"] / 2,
            "profile_idle_share": prof["idle_share"],
            "profile_wall_ms_per_step": prof["wall_ms"] / 2,
            # host clock over 5 steps after 2 of warm-up, in the order
            # without, with, with, without, all in the torchrun worker
            "step_ms_group": [r["step_ms"] for r in step["group"]],
            "step_ms_no_group": [r["step_ms"] for r in step["no_group"]],
            "step_ms_events_group": [r["step_ms_events"] for r in step["group"]],
            "step_ms_events_no_group": [r["step_ms_events"] for r in step["no_group"]],
            "group_ratio": with_group / without,
            # train_phase's step, timed in this process with no group
            "train_phase_step_ms": bare_step_ms,
            "cli_launches": cli_run["launches"], "cli_wall_s": cli_run["wall_s"],
            "cli_train_frames_per_s": cli_run["result"].get("train_frames_per_s")}
        log(f"[parallel] world 1 NCCL: {json.dumps(row['world1_nccl'])}")

        # 2. two gloo ranks on the one card against one process at twice the batch
        torch.cuda.empty_cache()
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        envs = [dict(os.environ, RANK=str(r), WORLD_SIZE=str(GLOO_RANKS), LOCAL_RANK="0",
                     MASTER_ADDR="localhost", MASTER_PORT=str(port))
                for r in range(GLOO_RANKS)]
        t0 = time.perf_counter()
        _workers([[sys.executable, str(ROOT / "chip_smoke.py"), "--dp-worker", "gloo",
                   str(work)]] * GLOO_RANKS, envs, work, "gloo")
        gloo_s = time.perf_counter() - t0
        ranks = [torch.load(work / f"gloo_{r}.pt", weights_only=True)
                 for r in range(GLOO_RANKS)]
        torch.backends.cudnn.deterministic = True
        try:
            one = _gloo_steps(torch, *_gloo_setup(torch, cfg, GLOO_BATCH * GLOO_RANKS))
        finally:
            torch.backends.cudnn.deterministic = False
        p0, p1, p2 = one["params"][0], one["params"][1], one["params"][-1]
        same_start = all(torch.equal(r["params"][0][k], p0[k]) for r in ranks for k in p0)
        bit_equal = all(torch.equal(ranks[0]["params"][1][k], r["params"][1][k])
                        for r in ranks[1:] for k in p0)
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["loss"], one["loss"]))
        mde_rel = max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["mde"], one["mde"]))
        change = _change_rel(ranks[0]["params"][1], p2, p0)
        worst = max(change, key=change.get)
        # the controls: no update at all (the change reads 1.0 and step 2's
        # loss is step 1's), and the last update lost (the parameters after
        # step 1 in place of those after step 2)
        loss_control = abs(one["loss"][1] - one["loss"][0]) / abs(one["loss"][0])
        lost = _change_rel(p1, p2, p0)
        g = {"ranks": GLOO_RANKS, "batch_per_rank": GLOO_BATCH, "T": MS_T, "steps": GLOO_STEPS,
             "loss_2_ranks": ranks[0]["loss"], "loss_1_process": one["loss"],
             "mde_2_ranks": ranks[0]["mde"], "mde_1_process": one["mde"],
             "loss_max_rel": loss_rel, "mde_max_rel": mde_rel,
             "change_max_rel": change[worst], "change_worst": worst,
             "change_median_rel": statistics.median(change.values()),
             "tensors_moved": len(change),
             "control_no_update_loss_rel": loss_control,
             "control_lost_update_change_min_rel": min(lost.values()),
             "control_lost_update_change_max_rel": max(lost.values()),
             "param_elements_differing": sum(int((ranks[0]["params"][1][k] != p).sum())
                                             for k, p in p2.items()),
             "param_elements": sum(p.numel() for p in p2.values()),
             "ranks_same_start": same_start, "ranks_bit_equal": bit_equal,
             "workers_wall_s": gloo_s}
        row["gloo_2_ranks"] = g
        log(f"[parallel] 2 gloo ranks vs 1 process: {json.dumps(g)} (tolerance: loss and MDE "
            f"{GLOO_RTOL} relative, each tensor's change {GLOO_DELTA_RTOL} of the one "
            "process's; the ranks bit-equal)")
        if not (same_start and bit_equal):
            raise SystemExit("[parallel] the two gloo ranks did not start from the one "
                             "process's weights or ended apart")
        if max(loss_rel, mde_rel) > GLOO_RTOL or change[worst] > GLOO_DELTA_RTOL:
            raise SystemExit("[parallel] 2 gloo ranks differ from 1 process beyond tolerance")
        if loss_control <= GLOO_RTOL or min(lost.values()) <= GLOO_DELTA_RTOL:
            raise SystemExit("[parallel] a control passes the tolerance: the check cannot "
                             "tell a run that skipped an update")

        # 3. the doctor
        doctor, _, _, _ = _cli_run(torch, ck, ["doctor"], "doctor")
        if not (doctor["ok"] and torch.cuda.get_device_name(0) in doctor["devices"]
                and doctor["fire_kernels"]["ok"] and doctor["nvcc"]["ok"]):
            raise SystemExit(f"[parallel] doctor: {doctor}")
        row["doctor"] = {k: doctor[k] for k in ("ok", "devices", "device_roundtrip", "nvcc",
                                                "host_cpu_count")}
        print(json.dumps({"parallel": row}), flush=True)
        return row
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    if sys.argv[1:2] == ["--dp-worker"]:
        return dp_worker(sys.argv[2], Path(sys.argv[3]))
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
    torch.cuda.empty_cache()
    ms = multistep_phase(torch, ck, cfg)
    ev = eval_phase(torch, ck, cfg)
    taps = taps_phase(torch, ck, cfg)
    ann = ann_phase(torch, cfg)
    log(json.dumps({"multistep": ms, "eval": ev, "taps": taps, "ann": ann}))
    torch.cuda.empty_cache()
    trained = ROOT / "build" / "chip_smoke" / "trained"
    drv = driver_phase(torch, ck, tr["b16"]["frames_per_s"], trained)
    torch.cuda.empty_cache()
    srv = serving_phase(torch, ck, cfg, trained)
    s8 = srv[f"s{SERVE_STREAMS}_float32"]
    torch.cuda.empty_cache()
    par = parallel_phase(torch, ck, cfg, tr["b16"]["step_ms"])
    w1 = par["world1_nccl"]
    # the fire kernels' bound on the layer-major bf16 step: every site's
    # [T, M] read and written once; forward x, v0 in and spikes, v_T out,
    # (2T+2)·M values; backward x, v0, gs in and gx, gv0 out, (3T+2)·M
    # values (the final membranes take no gradient, so no gv_T). The
    # backward really moves (4T+2)·M: its replay reads x once more.
    m_total = MS_BATCH * sum(m for _, m in site_sizes(cfg))
    lm_fwd_bound = (2 * MS_T + 2) * m_total * 2 / HBM_BYTES_PER_S * 1e3
    lm_bwd_bound = (3 * MS_T + 2) * m_total * 2 / HBM_BYTES_PER_S * 1e3
    lm_bwd_moved = (4 * MS_T + 2) * m_total * 2 / HBM_BYTES_PER_S * 1e3

    sites = kern["sites"]
    kernels = {"kernels": [{
        "name": "fire_fwd",
        "route": "cuda",
        "source": "stereospike_tpu_torch/csrc/fire_fwd.cu",
        "replaces": "stereospike_tpu/snn/pallas_kernels.py:180",
        # this slice's main path: cli train, 2 epochs (train steps and val batches)
        "launches": drv["launches"]["train"][0],
        "driver_launches": drv["launches"],
        "reset_mode_checks": kern["reset_mode_checks"],
        "serve_launches": serve_launches,
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
        # the 13 launches over [5, M] of one bf16 layer-major T=5 B=16 step
        "layer_major_launches": ms["layer_major"]["fire_fwd_launches"],
        "layer_major_path_ms": ms["profile"].get("fire_fwd_ms"),
        "layer_major_bound_ms": lm_fwd_bound,
        "eval_launches": [ev["T1"]["fire_fwd_launches"], ev[f"T{MS_T}"]["fire_fwd_launches"]],
        # serving 8 cameras in one batched float32 step: launches over 20
        # windows (13 each, M = 8 × site) and the 13 launches' device time
        # per window (torch.profiler) beside their bound
        "serving_s8_launches": s8["launches"],
        "serving_s8_path_ms": s8.get("fire_path_ms"),
        "serving_s8_bound_ms": s8.get("fire_bound_ms"),
        # data parallelism, world 1 over NCCL under torch.distributed.run:
        # launches per step in the profiled running loop, and cli train's
        "data_parallel_launches_per_step": w1["launches_per_step_profiled"][0],
        "data_parallel_cli_launches": w1["cli_launches"][0],
        "sites": sites,
    }, {
        "name": "fire_bwd",
        "route": "cuda",
        "source": "stereospike_tpu_torch/csrc/fire_bwd.cu",
        "replaces": "stereospike_tpu/snn/pallas_kernels.py:226",
        # this slice's main path: cli train, 2 epochs
        "launches": drv["launches"]["train"][1],
        "reset_mode_checks": bwd["reset_mode_checks"],
        # from the timed bf16 B=16 training steps
        "train_launches": tr["b16"]["fire_bwd_launches"],
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
        "layer_major_launches": ms["layer_major"]["fire_bwd_launches"],
        "layer_major_path_ms": ms["profile"].get("fire_bwd_ms"),
        "layer_major_bound_ms": lm_bwd_bound,
        "layer_major_moved_bytes_ms": lm_bwd_moved,
        "data_parallel_launches_per_step": w1["launches_per_step_profiled"][1],
        "data_parallel_cli_launches": w1["cli_launches"][1],
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
