"""Structured metrics logging: console + JSONL event file (+ TensorBoard)
(the port's own copy of fastdet/utils/logging.py).

Every step/eval metric is appended to a JSONL file so runs are
machine-readable, and optionally mirrored to TensorBoard event files
(`tensorboard=True` / `fastdet_torch.cli.train --tb`).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, logdir: Optional[str] = None, run_name: str = "run",
                 tensorboard: bool = False):
        self._fh = None
        self._tb = None
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            path = os.path.join(logdir, f"{run_name}.jsonl")
            self._fh = open(path, "a")
            self.path = path
            if tensorboard:
                # optional dependency: fall back to JSONL-only, but say
                # so — the user explicitly asked for TB (ADVICE r3)
                try:
                    from torch.utils.tensorboard import SummaryWriter
                    self._tb = SummaryWriter(
                        os.path.join(logdir, f"{run_name}_tb"))
                except Exception as e:
                    self._tb = None
                    print(f"[fastdet_torch] tensorboard requested but "
                          f"unavailable ({type(e).__name__}: {e}); "
                          f"logging JSONL only", file=sys.stderr)
                    self._fh.write(json.dumps(
                        {"ts": time.time(), "kind": "meta",
                         "tensorboard": False,
                         "reason": repr(e)[:120]}) + "\n")
                    self._fh.flush()

    def log(self, step: int, metrics: Dict[str, Any], kind: str = "train",
            echo: bool = False) -> None:
        rec = {"ts": time.time(), "step": int(step), "kind": kind}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("ts", "step", "kind") and isinstance(v, float):
                    self._tb.add_scalar(f"{kind}/{k}", v, int(step))
        if echo:
            parts = " ".join(f"{k}:{v:.6f}" if isinstance(v, float)
                             else f"{k}:{v}" for k, v in rec.items()
                             if k not in ("ts", "kind"))
            print(parts, flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
