"""Tracing, step timing and a model summary (the port's counterparts of
fastdet/utils/profiling.py):
  * `trace(logdir)`: a `torch.profiler` trace (CPU and, on a card, CUDA
    activity) of the enclosed block, written as a Chrome trace;
  * `StepTimer`: wall-clock step times with percentile summaries (a
    step's time on the card needs a synchronise inside the block);
  * `summarize_model`: a parameter/shape table.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the block into
    `<logdir>/trace.json`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Accumulates per-step wall times; reports p50/p90/mean."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        t = np.asarray(self._times)
        return {"steps": len(t), "mean_ms": float(t.mean() * 1e3),
                "p50_ms": float(np.percentile(t, 50) * 1e3),
                "p90_ms": float(np.percentile(t, 90) * 1e3)}


def summarize_model(model: torch.nn.Module, input_shape=(1, 352, 352, 3)
                    ) -> str:
    """Parameter/shape table (the torchsummary counterpart)."""
    lines = ["-" * 64, f"{'Param':<44}{'Shape':<14}{'Count':>6}", "=" * 64]
    total = 0
    for name, p in model.named_parameters():
        total += p.numel()
        lines.append(f"{name:<44}{str(tuple(p.shape)):<14}{p.numel():>6}")
    n_stats = sum(b.numel() for b in model.buffers())
    lines += ["=" * 64, f"Trainable params: {total:,}",
              f"BatchNorm stats:  {n_stats:,}",
              f"Total:            {total + n_stats:,}",
              f"Input shape:      {tuple(input_shape)}", "-" * 64]
    return "\n".join(lines)
