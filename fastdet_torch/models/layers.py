"""Shared conv building blocks (counterpart of fastdet/models/layers.py).

Modules compute in NCHW, PyTorch's habit; the Detector converts at its
edges so that its public layout stays the JAX package's NHWC.

Inference only in this slice: BatchNorm applies its running statistics.
The JAX package's training BN (flax momentum 0.9, two-pass biased
variance) is not yet ported, so a module in training mode raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


class BatchNorm(nn.Module):
    """Inference BatchNorm over dim 1 with eps 1e-5.  State dict keys are
    ``weight``, ``bias``, ``running_mean`` and ``running_var`` (no
    ``num_batches_tracked``: the JAX variables have none)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "fastdet_torch: training-mode BatchNorm is not ported yet")
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, BN_EPS)


class ConvBN(nn.Module):
    """Conv2d (no bias, 'same' padding k//2) + BatchNorm + optional ReLU.

    ``groups=features_in`` gives a depthwise conv."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1,
                 groups: int = 1, relu: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2,
                              groups=groups, bias=False)
        self.bn = BatchNorm(cout)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class DWConvBlock(nn.Module):
    """Head block: 2 × [dw k×k + BN + ReLU → pw 1×1 + BN], with NO ReLU
    after either pw (the reference's quirk, fastdet/models/layers.py:65)."""

    def __init__(self, features: int, kernel: int = 5):
        super().__init__()
        c = features
        self.dw1 = ConvBN(c, c, kernel, groups=c, relu=True)
        self.pw1 = ConvBN(c, c, 1, relu=False)
        self.dw2 = ConvBN(c, c, kernel, groups=c, relu=True)
        self.pw2 = ConvBN(c, c, 1, relu=False)

    def forward(self, x):
        return self.pw2(self.dw2(self.pw1(self.dw1(x))))


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """2× nearest-neighbour upsample of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
