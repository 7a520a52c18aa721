"""Light two-scale FPN neck, NCHW (counterpart of fastdet/models/fpn.py).

The obj branch shares the cls head's feature map (obj_s = cls_s)."""

from __future__ import annotations

import torch
from torch import nn

from fastdet_torch.models.layers import ConvBN, DWConvBlock, upsample_nearest_2x


class LightFPN(nn.Module):
    def __init__(self, c2: int, c3: int, out_depth: int = 72,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = dtype
        self.conv1x1_3 = ConvBN(c3, out_depth, 1, relu=True, dtype=d)
        self.conv1x1_2 = ConvBN(c2 + c3, out_depth, 1, relu=True, dtype=d)
        self.cls_head_3 = DWConvBlock(out_depth, 5, dtype=d)
        self.reg_head_3 = DWConvBlock(out_depth, 5, dtype=d)
        self.cls_head_2 = DWConvBlock(out_depth, 5, dtype=d)
        self.reg_head_2 = DWConvBlock(out_depth, 5, dtype=d)

    def forward(self, C2, C3):
        S3 = self.conv1x1_3(C3)
        cls_3 = self.cls_head_3(S3)
        reg_3 = self.reg_head_3(S3)
        S2 = self.conv1x1_2(torch.cat([upsample_nearest_2x(C3), C2], dim=1))
        cls_2 = self.cls_head_2(S2)
        reg_2 = self.reg_head_2(S2)
        return cls_2, cls_2, reg_2, cls_3, cls_3, reg_3
