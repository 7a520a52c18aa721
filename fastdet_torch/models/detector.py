"""Yolo-FastestV2 detector (counterpart of fastdet/models/detector.py).

Takes an NHWC float batch and returns the raw-logit 6-tuple
(reg2, obj2, cls2, reg3, obj3, cls3), each NHWC, exactly as the JAX
`Detector.apply` does, in eval mode (running BN statistics) and in
training mode (batch statistics, running update): the postprocess flattens in
(h, w, anchor) order and reads `reg` channels anchor-major (a·4 + j), so
the layout at this boundary is part of the contract.  Inside, the
modules compute in NCHW with plain `torch.nn.functional` convs (cuDNN on
the card); the JAX package leaves these convs to XLA, outside any Pallas
kernel.  One set of head convs serves both scales.

`deploy=True` (the JAX `deploy=True`, the reference's export graph)
returns the two per-scale NHWC maps cat[σ(reg), σ(obj), softmax(cls)] of
shape (B, h, w, 4A + A + classes) instead (`layers.deploy_maps`): what
`fastdet_torch.export` serializes and `HybridPipeline`'s host
postprocess reads.

`dtype` is the compute dtype, as the JAX `Detector(dtype=)`: with
`torch.bfloat16` the input is cast to bf16 and every layer computes at
flax's rounding points (models/layers.py), so the outputs are bf16 while
the parameters and running statistics stay f32.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from fastdet_torch.models.fpn import LightFPN
from fastdet_torch.models.layers import BF16, deploy_maps, head_conv
from fastdet_torch.models.shufflenet import ShuffleNetV2


class Detector(nn.Module):
    def __init__(self, classes: int = 80, anchor_num: int = 3,
                 out_depth: int = 72,
                 stage_out_channels: Tuple[int, ...] = (-1, 24, 48, 96, 192),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.classes = classes
        self.anchor_num = anchor_num
        self.dtype = dtype
        self.backbone = ShuffleNetV2(stage_out_channels, dtype=dtype)
        self.fpn = LightFPN(stage_out_channels[3], stage_out_channels[4],
                            out_depth, dtype=dtype)
        self.output_reg = nn.Conv2d(out_depth, 4 * anchor_num, 1)
        self.output_obj = nn.Conv2d(out_depth, anchor_num, 1)
        self.output_cls = nn.Conv2d(out_depth, classes, 1)

    def forward(self, x, deploy: bool = False):
        """x: (B, H, W, 3) float NHWC → 6 raw NHWC head outputs, or with
        `deploy` the two baked maps (stride 16, stride 32)."""
        if self.dtype == BF16:
            x = x.to(BF16)
        outs = self.head(*self.backbone(x.permute(0, 3, 1, 2)))
        if deploy:
            return deploy_maps(*outs[:3]), deploy_maps(*outs[3:])
        return outs

    def head(self, C2, C3):
        """FPN and the shared head convs on the NCHW backbone features →
        the 6 raw NHWC outputs."""
        cls_2, obj_2, reg_2, cls_3, obj_3, reg_3 = self.fpn(C2, C3)
        d = self.dtype
        outs = (head_conv(self.output_reg, reg_2, d),
                head_conv(self.output_obj, obj_2, d),
                head_conv(self.output_cls, cls_2, d),
                head_conv(self.output_reg, reg_3, d),
                head_conv(self.output_obj, obj_3, d),
                head_conv(self.output_cls, cls_3, d))
        return tuple(o.permute(0, 2, 3, 1) for o in outs)
