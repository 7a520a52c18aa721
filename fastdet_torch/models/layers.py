"""Shared conv building blocks (counterpart of fastdet/models/layers.py).

Modules compute in NCHW, PyTorch's habit; the Detector converts at its
edges so that its public layout stays the JAX package's NHWC.

BatchNorm follows linen's (fastdet/models/layers.py): in eval mode it
applies its running statistics; in training mode it normalises with the
batch statistics (the mean, then the biased two-pass variance
mean((x-μ)²), eps 1e-5) and updates the running statistics as flax does
with momentum 0.9: running = 0.9·running + (1 - 0.9)·batch, from the
biased variance.  `F.batch_norm(training=True)` is not used for that
update: it would store the unbiased variance.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.9


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 with eps 1e-5.  State dict keys are
    ``weight``, ``bias``, ``running_mean`` and ``running_var`` (no
    ``num_batches_tracked``: the JAX variables have none)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, BN_EPS)
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1, -1] + [1] * (x.dim() - 2)
        mean = x.mean(dims)
        d = x - mean.view(shape)
        var = (d * d).mean(dims)
        update_running_stats(self, mean, var)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return d * mul.view(shape) + self.bias.view(shape)


@torch.no_grad()
def update_running_stats(bn: BatchNorm, mean, var) -> None:
    """flax's running update with momentum 0.9 from batch statistics."""
    for buf, batch in ((bn.running_mean, mean), (bn.running_var, var)):
        buf.copy_(BN_MOMENTUM * buf + (1 - BN_MOMENTUM) * batch.detach())


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
