"""ShuffleNetV2 backbone, NCHW (counterpart of fastdet/models/shufflenet.py).

Stride-1 blocks split channels even → passthrough, odd → main branch
(the JAX package's NHWC last axis is dim 1 here) and concatenate
[passthrough, main].  Stride-2 blocks run both branches on the full input
and concatenate [proj, main].
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fastdet_torch.models.layers import ConvBN


class ShuffleV2Block(nn.Module):
    def __init__(self, inp: int, oup: int, mid: int, ksize: int = 3,
                 stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        if stride not in (1, 2):
            raise ValueError(f"stride must be 1 or 2, got {stride}")
        self.stride = stride
        out_main = oup - inp
        d = dtype
        self.main_pw = ConvBN(inp, mid, 1, relu=True, dtype=d)
        self.main_dw = ConvBN(mid, mid, ksize, stride=stride, groups=mid,
                              relu=False, dtype=d)
        self.main_pw_linear = ConvBN(mid, out_main, 1, relu=True, dtype=d)
        if stride == 2:
            self.proj_dw = ConvBN(inp, inp, ksize, stride=2, groups=inp,
                                  relu=False, dtype=d)
            self.proj_pw = ConvBN(inp, inp, 1, relu=True, dtype=d)

    def _main(self, x):
        return self.main_pw_linear(self.main_dw(self.main_pw(x)))

    def forward(self, x):
        if self.stride == 1:
            return torch.cat([x[:, 0::2], self._main(x[:, 1::2])], dim=1)
        return torch.cat([self.proj_pw(self.proj_dw(x)), self._main(x)],
                         dim=1)


class ShuffleNetV2(nn.Module):
    """Backbone returning (C2, C3) at stride 16 / 32.

    stage_out_channels follows the reference convention
    [-1, stem, stage2, stage3, stage4].  In bf16 the stem's max-pool runs
    on the bf16 values."""

    def __init__(self, stage_out_channels: Sequence[int] = (-1, 24, 48, 96,
                                                            192),
                 stage_repeats: Sequence[int] = (4, 8, 4),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        stem = stage_out_channels[1]
        self.first_conv = ConvBN(3, stem, 3, stride=2, relu=True,
                                 dtype=dtype)
        self.stage_names = []
        input_channel = stem
        for s, repeats in enumerate(stage_repeats):
            output_channel = stage_out_channels[s + 2]
            names = []
            for i in range(repeats):
                if i == 0:
                    block = ShuffleV2Block(input_channel, output_channel,
                                           output_channel // 2, 3, stride=2,
                                           dtype=dtype)
                else:
                    block = ShuffleV2Block(input_channel // 2, output_channel,
                                           output_channel // 2, 3, stride=1,
                                           dtype=dtype)
                name = f"stage{s + 2}_{i}"
                self.add_module(name, block)
                names.append(name)
                input_channel = output_channel
            self.stage_names.append(names)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.first_conv(x)
        x = F.max_pool2d(x, 3, 2, 1)                 # 3×3 s2, pad 1 (−inf)
        feats = []
        for names in self.stage_names:
            for name in names:
                x = getattr(self, name)(x)
            feats.append(x)
        return feats[1], feats[2]
