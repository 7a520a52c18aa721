"""The fused-backbone training forward (counterpart of
fastdet/train/fused_forward.py).

`build_fused_train_apply(...)` returns `apply_fn(model, images)`, the
training forward of the port's `Detector` with the backbone's stride-1
spans (3/7/3 blocks at 48/96/192 channels) of the stages in `span_stages`
through `SpanTrain` (kernel B8 on the card, ghost BN within the JAX
package's groups).  The stages left out of `span_stages` run the model's
own stride-1 blocks with exact full-batch BN.  The stride-2 blocks, the
FPN and the heads are the model's own modules in training mode, with
exact full-batch BN: the JAX package leaves them to XLA, so they stay
library calls (cuDNN on the card).

The stem depends on `input_format`:
  * "nhwc": images (B, H, W, 3) uint8; the model's stem on images / 255
    (conv, full-batch BN, ReLU, `max_pool2d`);
  * "s2d_u8": images (B, 48, pad128(H/4·W/4)) uint8 from
    `pack_images_s2d`; the stem is `StemTrain` (kernel B7 on the card:
    conv, ghost BN over `stem_group` images, ReLU and pool, forward and
    backward, the conv output never in device memory).  Its weight is
    `first_conv.conv.weight` scaled by 1/255 with a torch op, so autograd
    carries dW back through it.  `stem_group` defaults to 1, as in the JAX
    package: per-image BN statistics, not full-batch ones.

A model built to compute in bf16 (`Detector(dtype=torch.bfloat16)`)
takes the JAX package's bf16 fused forward: the nhwc stem takes
`images.astype(bf16) / bf16(255)`, `StemTrain` and `SpanTrain` run B7's
and B8's bf16 forms on bf16 activations, and the model's modules round
at flax's points, as the JAX package's XLA parts do.

Running statistics: exact full-batch, pooled from the groups
(`combine_ghost_stats`, `combine_stem_stats`) and updated with flax's
momentum 0.9, as training-mode BN updates every other layer's.  With
every ghost group equal to the batch, the forward, its gradients and the
new running statistics are those of `model(images / 255)` in training
mode (for s2d input, wherever no positive tie in a pool window crosses
the pool's tie order: see kernels/stem_train.py).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from fastdet_torch import resolve_device
from fastdet_torch.kernels.fused_train import (SpanTrain,
                                               combine_ghost_stats,
                                               pack_span_train_weights,
                                               pick_train_group)
from fastdet_torch.kernels.stem_train import StemTrain, combine_stem_stats
from fastdet_torch.models.layers import update_running_stats

_STAGES = ((2, 4, 48), (3, 8, 96), (4, 4, 192))
_SPAN_BNS = ("main_pw", "main_dw", "main_pw_linear")


def build_fused_train_apply(input_hw: Tuple[int, int], *,
                            input_format: str = "nhwc",
                            stem_group: Optional[int] = None,
                            span_stages: Tuple[int, ...] = (2, 3, 4),
                            device=None) -> Callable:
    """→ `apply_fn(model, images) -> 6 NHWC outputs`; the model is in
    training mode and its BN running statistics update.  images: (B, H, W,
    3) uint8 for "nhwc", (B, 48, pad128(H/4·W/4)) uint8 for "s2d_u8".
    The forward computes in the model's dtype: bfloat16, or its
    parameters' (f32, f64 in the parity tests)."""
    if input_format not in ("nhwc", "s2d_u8"):
        raise ValueError(f"unknown input_format {input_format!r}")
    dev = resolve_device(device)
    ih, iw = input_hw
    h4, w4 = ih // 4, iw // 4
    npad4 = (h4 * w4 + 127) // 128 * 128
    g_stem = 1 if stem_group is None else stem_group

    def stem_nhwc(bb, images, dtype):
        if images.dim() != 4 or tuple(images.shape[1:]) != (ih, iw, 3):
            raise ValueError(f"expected (B, {ih}, {iw}, 3) images, got "
                             f"{tuple(images.shape)}")
        x = images.permute(0, 3, 1, 2).to(dtype) / 255.0
        return F.max_pool2d(bb.first_conv(x), 3, 2, 1)

    def stem_s2d(bb, images, dtype):
        if (images.dim() != 3 or images.dtype != torch.uint8
                or tuple(images.shape[1:]) != (48, npad4)):
            raise ValueError(
                f"expected (B, 48, {npad4}) uint8 s2d images for "
                f"{input_hw}, got {images.dtype} {tuple(images.shape)}")
        fc = bb.first_conv
        y, stats = StemTrain.apply(images.contiguous(),
                                   fc.conv.weight * (1.0 / 255.0),
                                   fc.bn.weight, fc.bn.bias, h4, w4, g_stem,
                                   dtype == torch.bfloat16)
        update_running_stats(fc.bn, *combine_stem_stats(stats))
        return y

    stem = stem_s2d if input_format == "s2d_u8" else stem_nhwc

    def apply_fn(model, images):
        bb = model.backbone
        x = stem(bb, images.to(dev), torch.bfloat16
                 if model.dtype == torch.bfloat16
                 else bb.first_conv.conv.weight.dtype)
        feats = []
        for stage, reps, c in _STAGES:
            x = getattr(bb, f"stage{stage}_0")(x)
            blocks = [getattr(bb, f"stage{stage}_{i}")
                      for i in range(1, reps)]
            if stage not in span_stages:
                for blk in blocks:
                    x = blk(x)
                feats.append(x)
                continue
            b, _, h, w = x.shape
            g = pick_train_group(b, (h * w + 127) // 128 * 128, c)
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
