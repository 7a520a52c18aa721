"""fastdet_torch — the PyTorch/CUDA port of fastdet for NVIDIA Hopper.

A package of its own beside `fastdet/` (the JAX reference): it imports
`torch` and never `jax`, and nothing of `fastdet/`.  Module names follow
the JAX package so that each piece has an obvious counterpart.

Entry points run on CUDA unless the caller passes ``device="cpu"``; a
CUDA request on a machine without a card raises instead of running on
the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``.  Raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fastdet_torch: CUDA requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def disable_tf32(dev: torch.device) -> None:
    """On CUDA, turn TF32 off for the whole process
    (`torch.backends.cudnn.allow_tf32` and `cuda.matmul.allow_tf32`):
    cuDNN convs default to TF32, and the port computes f32, as the JAX
    package's default dtype does.  A no-op on the CPU."""
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
