"""Command-line interface: ``python -m stereospike_tpu_torch.cli <command>``
(counterpart of ``stereospike_tpu/cli.py``).

    train         a training run (epochs, validation, best/latest checkpoints)
    eval          test-set evaluation of a checkpoint
    firing-rates  per-layer spike densities over the test set
    stream        streaming serving: synthetic event windows in, depth maps out

Every ``TrainConfig`` field is a flag (``--batch-size 16``, ``--in-hw
260,346``, ``--augment false``), as in the JAX CLI; also ``--config
file.json`` (flags override it), ``--save-config path`` (write the resolved
config and exit), ``--synthetic`` (a generated on-disk fixture: no MVSEC
download, no h5py), ``--max-steps``, ``--which`` (the checkpoint ``eval``
and ``firing-rates`` read, ``best.pt`` by default) and ``--device``
(``cuda`` unless given). Each command prints its loop's result as one JSON
line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import typing
from typing import List, Optional

from stereospike_tpu_torch.train.config import TrainConfig

COMMANDS = {
    "train": "train a model",
    "eval": "evaluate a checkpoint on the test set",
    "firing-rates": "profile per-layer spike densities",
    "stream": "streaming serving: events in, depth maps out",
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
        if name in ("eval", "firing-rates"):
            p.add_argument("--which", type=str, default="best.pt",
                           help="checkpoint file in --checkpoint-dir to evaluate")
        if name == "stream":
            p.add_argument("--n-windows", type=int, default=20, help="windows to serve")
            p.add_argument("--pipeline", type=int, default=1,
                           help="windows in flight (0 = synchronous)")
            p.add_argument("--events-per-window", type=int, default=20000,
                           help="synthetic events per eye per window")
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
    else:
        out = loop.stream_loop(cfg, synthetic=args.synthetic, n_windows=args.n_windows,
                               pipeline=args.pipeline,
                               events_per_window=args.events_per_window, device=args.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
