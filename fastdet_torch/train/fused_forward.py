"""The fused-backbone training forward (counterpart of
fastdet/train/fused_forward.py, `input_format="nhwc"`).

`build_fused_train_apply(...)` returns `apply_fn(model, images_u8)`, the
training forward of the port's `Detector` with the backbone's three
stride-1 spans (3/7/3 blocks at 48/96/192 channels) through `SpanTrain`
(kernel B8 on the card, ghost BN within the JAX package's groups).  The
stem, the stride-2 blocks, the FPN and the heads are the model's own
modules in training mode, with exact full-batch BN: the JAX package
leaves them to XLA, so they stay library calls (cuDNN on the card).  The
spans' running statistics are the exact full-batch ones pooled from the
groups (`combine_ghost_stats`), updated with flax's momentum 0.9, as
training-mode BN updates every other layer's.

With every ghost group equal to the batch, the forward, its gradients and
the new running statistics are those of `model(images / 255)` in
training mode.  Not ported: `input_format="s2d_u8"`, whose stem is the
training stem kernel B7 (ROADMAP B7).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from fastdet_torch import resolve_device
from fastdet_torch.kernels.fused_train import (SpanTrain,
                                               combine_ghost_stats,
                                               pack_span_train_weights,
                                               pick_train_group)
from fastdet_torch.models.layers import update_running_stats

_STAGES = ((2, 4, 48), (3, 8, 96), (4, 4, 192))
_SPAN_BNS = ("main_pw", "main_dw", "main_pw_linear")


def build_fused_train_apply(input_hw: Tuple[int, int], *,
                            input_format: str = "nhwc",
                            device=None) -> Callable:
    """→ `apply_fn(model, images_u8 (B, H, W, 3)) -> 6 NHWC outputs`; the
    model is in training mode and its BN running statistics update."""
    if input_format == "s2d_u8":
        raise NotImplementedError(
            "fastdet_torch: the s2d_u8 training input and its fused stem "
            "kernel are ROADMAP B7, not ported yet")
    if input_format != "nhwc":
        raise ValueError(f"unknown input_format {input_format!r}")
    dev = resolve_device(device)

    def apply_fn(model, images):
        bb = model.backbone
        dtype = bb.first_conv.conv.weight.dtype
        x = images.to(dev).permute(0, 3, 1, 2).to(dtype) / 255.0
        if tuple(x.shape[2:]) != tuple(input_hw):
            raise ValueError(f"expected {input_hw} images, got "
                             f"{tuple(images.shape)}")
        x = F.max_pool2d(bb.first_conv(x), 3, 2, 1)
        feats = []
        for stage, reps, c in _STAGES:
            x = getattr(bb, f"stage{stage}_0")(x)
            b, _, h, w = x.shape
            g = pick_train_group(b, (h * w + 127) // 128 * 128, c)
            blocks = [getattr(bb, f"stage{stage}_{i}")
                      for i in range(1, reps)]
            x, stats = SpanTrain.apply(x.contiguous(),
                                       pack_span_train_weights(blocks), g)
            mean, var = combine_ghost_stats(stats)
            for i, blk in enumerate(blocks):
                for j, name in enumerate(_SPAN_BNS):
                    update_running_stats(getattr(blk, name).bn, mean[i, j],
                                         var[i, j])
            feats.append(x)
        return model.head(feats[1], feats[2])

    return apply_fn
