"""Metrics and log sinks (counterpart of ``stereospike_tpu/utils/logging.py``).

Structured JSONL (the primary sink, always written), a human-readable text
log echoed to stderr, and, when the ``tensorboard`` package is importable,
TensorBoard event files under ``<log_dir>/tb_<name>/`` written with its own
pure-Python ``EventFileWriter``. Every float scalar passed to
:meth:`MetricsLogger.log` becomes a TensorBoard scalar.

In a data-parallel run (``parallel/mesh.py``) only rank 0, the lead
process (:func:`is_lead_process`), writes: the scalars are the same on
every rank, and N writers would interleave the files.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional

import torch.distributed as dist


class _TBWriter:
    """Minimal TensorBoard scalar sink; ``create`` returns None when the
    package is absent (the JSONL sink is the source of truth either way)."""

    @staticmethod
    def create(log_dir: str) -> Optional["_TBWriter"]:
        try:
            from tensorboard.compat.proto.event_pb2 import Event
            from tensorboard.compat.proto.summary_pb2 import Summary
            from tensorboard.summary.writer.event_file_writer import EventFileWriter
        except Exception:
            return None
        w = _TBWriter()
        w._Event, w._Summary = Event, Summary
        w._writer = EventFileWriter(log_dir)
        return w

    def scalars(self, scalars: Dict, step: int, wall_time: float) -> None:
        values = [self._Summary.Value(tag=k, simple_value=float(v))
                  for k, v in scalars.items()
                  if isinstance(v, (int, float)) and not isinstance(v, bool)]
        if values:
            self._writer.add_event(self._Event(wall_time=wall_time, step=step,
                                               summary=self._Summary(value=values)))

    def close(self) -> None:
        self._writer.close()


def is_lead_process() -> bool:
    """Whether this process owns shared-filesystem side effects
    (checkpoints, logs): rank 0 of an initialized process group, and
    every process outside one."""
    return not dist.is_initialized() or dist.get_rank() == 0


class MetricsLogger:
    """Append-only ``<name>_metrics.jsonl`` and ``<name>_logs.txt`` in
    ``log_dir``, plus TensorBoard scalars when ``tensorboard`` and the
    package is importable. Outside the lead process every method does
    nothing."""

    def __init__(self, log_dir: str, name: str = "training", echo: bool = True,
                 tensorboard: bool = True):
        self.active = is_lead_process()
        self.jsonl_path = os.path.join(log_dir, f"{name}_metrics.jsonl")
        self.text_path = os.path.join(log_dir, f"{name}_logs.txt")
        self.tb_dir = os.path.join(log_dir, f"tb_{name}")
        self.echo = echo
        self._tb = None
        if not self.active:
            return
        os.makedirs(log_dir, exist_ok=True)
        # step-less records (eval, firing rates, stream) continue the
        # TensorBoard step count from the records already in the sink, so
        # that re-runs into one directory do not stack at step 0
        self._tb_step = 0
        if os.path.exists(self.jsonl_path):
            with open(self.jsonl_path) as f:
                self._tb_step = sum(1 for _ in f)
        self._jsonl = open(self.jsonl_path, "a")
        self._text = open(self.text_path, "a")
        self._tb = _TBWriter.create(self.tb_dir) if tensorboard else None

    def log(self, scalars: Dict, *, step: Optional[int] = None,
            epoch: Optional[int] = None) -> None:
        if not self.active:
            return
        rec = {"time": time.time()}
        if step is not None:
            rec["step"] = int(step)
        if epoch is not None:
            rec["epoch"] = int(epoch)
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            if step is not None:
                tb_step = step
            elif epoch is not None:
                tb_step = epoch
            else:
                tb_step = self._tb_step
                self._tb_step += 1
            self._tb.scalars({k: v for k, v in rec.items()
                              if k not in ("time", "step", "epoch")}, int(tb_step), rec["time"])

    def text(self, message: str) -> None:
        if not self.active:
            return
        self._text.write(message.rstrip() + "\n")
        self._text.flush()
        if self.echo:
            print(message, file=sys.stderr)

    def close(self) -> None:
        if not self.active:
            return
        self._jsonl.close()
        self._text.close()
        if self._tb is not None:
            self._tb.close()
