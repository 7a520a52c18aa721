"""Full train-state checkpoints with `torch.save` (takes the place of
the JAX package's orbax checkpoints, fastdet/io/checkpoint.py).

A checkpoint is `<ckpt_dir>/ckpt-<step>.pt`, written to a temporary name
and renamed, so that a crash never leaves a half-written one under the
final name.  `Trainer.state_dict()` is the state: parameters, BN buffers,
optimizer state, micro-step and accumulation state.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

_NAME = re.compile(r"^ckpt-(\d+)\.pt$")


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt-{int(step)}.pt")


def save_checkpoint(ckpt_dir: str, step: int, state: Any) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _path(ckpt_dir, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for m in map(_NAME.match, os.listdir(ckpt_dir))
             if m]
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                    map_location="cpu") -> Any:
    """The state saved at `step` (default: the latest)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {ckpt_dir}")
    return torch.load(_path(ckpt_dir, step), map_location=map_location,
                      weights_only=False)
