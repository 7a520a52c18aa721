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
"""

from __future__ import annotations

from typing import Tuple

from torch import nn

from fastdet_torch.models.fpn import LightFPN
from fastdet_torch.models.shufflenet import ShuffleNetV2


class Detector(nn.Module):
    def __init__(self, classes: int = 80, anchor_num: int = 3,
                 out_depth: int = 72,
                 stage_out_channels: Tuple[int, ...] = (-1, 24, 48, 96, 192)):
        super().__init__()
        self.classes = classes
        self.anchor_num = anchor_num
        self.backbone = ShuffleNetV2(stage_out_channels)
        self.fpn = LightFPN(stage_out_channels[3], stage_out_channels[4],
                            out_depth)
        self.output_reg = nn.Conv2d(out_depth, 4 * anchor_num, 1)
        self.output_obj = nn.Conv2d(out_depth, anchor_num, 1)
        self.output_cls = nn.Conv2d(out_depth, classes, 1)

    def forward(self, x):
        """x: (B, H, W, 3) float NHWC → 6 raw NHWC head outputs."""
        return self.head(*self.backbone(x.permute(0, 3, 1, 2)))

    def head(self, C2, C3):
        """FPN and the shared head convs on the NCHW backbone features →
        the 6 raw NHWC outputs."""
        cls_2, obj_2, reg_2, cls_3, obj_3, reg_3 = self.fpn(C2, C3)
        outs = (self.output_reg(reg_2), self.output_obj(obj_2),
                self.output_cls(cls_2), self.output_reg(reg_3),
                self.output_obj(obj_3), self.output_cls(cls_3))
        return tuple(o.permute(0, 2, 3, 1) for o in outs)
