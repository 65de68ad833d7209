"""Command-line interface: ``python -m stereospike_tpu_torch.cli <command>``
(counterpart of ``stereospike_tpu/cli.py``).

    train           a training run (epochs, validation, best/latest checkpoints)
    eval            test-set evaluation of a checkpoint
    firing-rates    per-layer spike densities over the test set
    stream          streaming serving: event windows in (synthetic, a TCP
                    feed, an AEDAT 3.1 recording, a DENSE directory), depth
                    maps out, from a checkpoint, a ``.pth`` or an artifact
    export-pth      a checkpoint as a reference torch ``.pth`` state dict
    export-serving  the serving step as a self-contained ``.ssx`` artifact
    doctor          environment diagnostics: the card, nvcc, the kernels'
                    build, the native host ops (one JSON object; exit 2
                    when the card does not answer)

Every ``TrainConfig`` field is a flag (``--batch-size 16``, ``--in-hw
260,346``, ``--augment false``), as in the JAX CLI; also ``--config
file.json`` (flags override it), ``--save-config path`` (write the resolved
config and exit), ``--synthetic`` (a generated on-disk fixture: no MVSEC
download, no h5py), ``--max-steps``, ``--which`` (the checkpoint ``eval``,
``firing-rates``, ``stream`` and the exports read, ``best.pt`` by
default) and ``--device`` (``cuda`` unless given). Each command prints its
loop's result as one JSON line.

Data-parallel training on N cards, one process each (``--mesh-shape N,1``;
``batch_size`` is per process)::

    python -m torch.distributed.run --nproc_per_node N \
        -m stereospike_tpu_torch.cli train --mesh-shape N,1 ...
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import typing
from typing import List, Optional

from stereospike_tpu_torch.train.config import TrainConfig

COMMANDS = {
    "train": "train a model",
    "eval": "evaluate a checkpoint on the test set",
    "firing-rates": "profile per-layer spike densities",
    "stream": "streaming serving: events in, depth maps out",
    "export-pth": "export a checkpoint as a reference torch .pth",
    "export-serving": "export the serving step as a self-contained .ssx artifact",
    "doctor": "probe the environment: the card, nvcc, the kernels' build, native ops",
}


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def _flag_parser(tp):
    """argparse ``type=`` callable and metavar for a config annotation."""
    origin = typing.get_origin(tp)
    if origin is typing.Union:  # Optional[X] → X
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) != 1:
            raise TypeError(f"unsupported Union annotation {tp}")
        tp = args[0]
        origin = typing.get_origin(tp)
    if tp is bool:
        return _parse_bool, "BOOL"
    if origin is tuple:
        elem = typing.get_args(tp)[0]

        def parse_tuple(s: str, elem=elem):
            return tuple(elem(x) for x in s.split(","))

        return parse_tuple, "X,Y,..."
    if tp in (int, float, str):
        return tp, None
    raise TypeError(f"unsupported config annotation {tp}")


def _add_config_flags(p: argparse.ArgumentParser) -> None:
    hints = typing.get_type_hints(TrainConfig)
    for field in dataclasses.fields(TrainConfig):
        parser, metavar = _flag_parser(hints[field.name])
        p.add_argument("--" + field.name.replace("_", "-"), type=parser, default=None,
                       metavar=metavar)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="stereospike_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    for name, helptext in COMMANDS.items():
        p = sub.add_parser(name, help=helptext)
        p.add_argument("--config", type=str, default=None,
                       help="JSON config file (flags override)")
        p.add_argument("--synthetic", action="store_true",
                       help="run on a generated synthetic fixture")
        p.add_argument("--max-steps", type=int, default=None,
                       help="stop after N optimizer steps (smoke runs)")
        p.add_argument("--save-config", type=str, default=None,
                       help="write the resolved config to this path and exit")
        p.add_argument("--device", type=str, default="cuda",
                       help="torch device to run on (default cuda)")
        if name not in ("train", "doctor"):
            p.add_argument("--which", type=str, default="best.pt",
                           help="checkpoint file in --checkpoint-dir to read")
        if name == "stream":
            p.add_argument("--n-windows", type=int, default=20,
                           help="windows to serve; with --listen, 0 serves until producers "
                                "stop reconnecting")
            p.add_argument("--pipeline", type=int, default=1,
                           help="windows in flight (0 = synchronous)")
            p.add_argument("--events-per-window", type=int, default=20000,
                           help="synthetic events per eye per window")
            p.add_argument("--events-dir", type=str, default=None,
                           help="DENSE-format events/data dir (one .npy file per window; "
                                "monocular)")
            p.add_argument("--aer-format", type=str, default="TXYP", choices=("TXYP", "XYTP"),
                           help="column order of the events-dir .npy files")
            p.add_argument("--aedat", type=str, default=None,
                           help="replay an AEDAT 3.1 recording; one path, or left,right "
                                "paths for a stereo rig")
            p.add_argument("--realtime", action="store_true",
                           help="pace --aedat replay to the recording cadence")
            p.add_argument("--listen", type=str, default=None,
                           help="accept a live SPKE-protocol TCP event feed on host:port "
                                "(or just a port); see stereospike_tpu_torch.sources")
            p.add_argument("--reply", action="store_true",
                           help="send depth maps back to the --listen producer")
            p.add_argument("--artifact", type=str, default=None,
                           help="serve from an exported .ssx artifact (export-serving) "
                                "instead of live params")
            p.add_argument("--save-video", type=str, default=None,
                           help="not ported: needs cv2 (ROADMAP A.9)")
        if name == "export-pth":
            p.add_argument("--out", type=str, required=True, help="output .pth path")
        if name == "doctor":
            p.add_argument("--device-timeout", type=float, default=240.0,
                           help="seconds before declaring the card unreachable")
        if name == "export-serving":
            p.add_argument("--out", type=str, required=True, help="output .ssx artifact path")
            p.add_argument("--block", type=int, default=1 << 16,
                           help="events per eye per window (pad/truncate)")
            p.add_argument("--n-streams", type=int, default=1,
                           help="cameras served per batched step")
            p.add_argument("--window-s", type=float, default=0.05,
                           help="binning window the step is built for")
        _add_config_flags(p)
    return parser


def build_config(args: argparse.Namespace) -> TrainConfig:
    """The run's config: ``--config`` (or the defaults), overridden by the
    flags given."""
    cfg = TrainConfig()
    if getattr(args, "config", None):
        with open(args.config) as f:
            cfg = TrainConfig.from_json(f.read())
    return dataclasses.replace(cfg, **{
        f.name: getattr(args, f.name) for f in dataclasses.fields(TrainConfig)
        if getattr(args, f.name, None) is not None})


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = build_config(args)
    if args.save_config:
        with open(args.save_config, "w") as f:
            f.write(cfg.to_json())
        print(json.dumps({"wrote": args.save_config}))
        return 0
    if args.command == "doctor":
        from stereospike_tpu_torch.doctor import run_doctor

        report = run_doctor(device_timeout_s=args.device_timeout, data_root=cfg.data_root)
        print(json.dumps(report))
        return 0 if report["ok"] else 2
    try:
        out = _run(cfg, args)
    finally:
        # a data-parallel launch's process group (train/eval with a mesh)
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    print(json.dumps(out))
    return 0


def _run(cfg: TrainConfig, args: argparse.Namespace) -> dict:
    from stereospike_tpu_torch.train import loop

    if args.command == "train":
        out = loop.train_loop(cfg, synthetic=args.synthetic, max_steps=args.max_steps,
                              device=args.device)
    elif args.command == "eval":
        out = loop.eval_loop(cfg, synthetic=args.synthetic, which=args.which,
                             device=args.device)
    elif args.command == "firing-rates":
        out = loop.firing_rates_loop(cfg, synthetic=args.synthetic, which=args.which,
                                     device=args.device)
    elif args.command == "stream":
        out = loop.stream_loop(cfg, synthetic=args.synthetic, events_dir=args.events_dir,
                               n_windows=args.n_windows, pipeline=args.pipeline,
                               events_per_window=args.events_per_window,
                               save_video=args.save_video, aer_format=args.aer_format,
                               listen=args.listen, reply=args.reply, artifact=args.artifact,
                               aedat=args.aedat, realtime=args.realtime, which=args.which,
                               device=args.device)
    elif args.command == "export-pth":
        out = _export_pth(cfg, args)
    else:
        out = _export_serving(cfg, args)
    return out


def _require_exportable_weights(cfg: TrainConfig, which: str) -> None:
    """``_load_params`` falls back to a fresh init; an export of random
    weights that looks valid is not wanted: a mistyped --checkpoint-dir
    fails here."""
    from stereospike_tpu_torch.train.checkpoint import has_checkpoint

    if not (cfg.import_pth or has_checkpoint(cfg.checkpoint_dir, which)):
        raise FileNotFoundError(f"no checkpoint {which!r} in {cfg.checkpoint_dir!r} and "
                                "no --import-pth; refusing to export fresh random-init weights")


def _export_pth(cfg: TrainConfig, args: argparse.Namespace) -> dict:
    """A checkpoint (``--which``) as a reference ``state_dict`` file, so that
    a model trained here loads into the reference code (``interop.py``)."""
    import torch

    from stereospike_tpu_torch.train.loop import (
        _load_params,
        build_ann_config,
        build_model_config,
        is_ann_model,
    )

    if is_ann_model(cfg.model):
        from stereospike_tpu_torch.interop import ann_params_to_torch_state_dict
        from stereospike_tpu_torch.models.ann import init_ann_params, init_ann_state
        from stereospike_tpu_torch.train.checkpoint import restore_fields

        ann_cfg = build_ann_config(cfg)
        template = {"params": init_ann_params(torch.Generator().manual_seed(cfg.seed), ann_cfg,
                                              device=args.device),
                    "bn_state": init_ann_state(ann_cfg, device=args.device)}
        restored = restore_fields(cfg.checkpoint_dir, template, args.which)
        sd = ann_params_to_torch_state_dict(restored["params"], restored["bn_state"])
    else:
        from stereospike_tpu_torch.interop import params_to_torch_state_dict

        _require_exportable_weights(cfg, args.which)
        sd = params_to_torch_state_dict(
            _load_params(cfg, build_model_config(cfg), args.which, args.device))
    torch.save(sd, args.out)
    return {"exported": args.out, "n_tensors": len(sd)}


def _export_serving(cfg: TrainConfig, args: argparse.Namespace) -> dict:
    """The serving step (voxelize → stateful forward, weights baked in) as
    a ``.ssx`` artifact for ``--device`` (``deploy.py``)."""
    from stereospike_tpu_torch.deploy import export_serving_artifact
    from stereospike_tpu_torch.streaming import StreamingEvaluator
    from stereospike_tpu_torch.train.loop import (
        _compute_dtype,
        _load_params,
        build_model_config,
        is_ann_model,
    )

    if is_ann_model(cfg.model):
        raise ValueError("serving artifacts wrap the stateful SNN models; ANN checkpoints "
                         "export via export-pth")
    _require_exportable_weights(cfg, args.which)
    model_cfg = build_model_config(cfg)
    params = _load_params(cfg, model_cfg, args.which, args.device)
    eyes = ("left",) if cfg.model == "stereospike_monocular" else ("left", "right")
    evaluator = StreamingEvaluator(params, model_cfg, eyes=eyes, nfpdm=cfg.nfpdm,
                                   window=args.window_s, block=args.block,
                                   n_streams=args.n_streams, compute_dtype=_compute_dtype(cfg),
                                   device=args.device)
    manifest = export_serving_artifact(evaluator, args.out, extra_meta={"model": cfg.model})
    return {"exported": args.out, "bytes": os.path.getsize(args.out),
            **{k: manifest[k] for k in ("platforms", "eyes", "block", "n_streams")}}


if __name__ == "__main__":
    sys.exit(main())
