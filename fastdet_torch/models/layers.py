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

Data parallel: with a process group set on the module
(`fastdet_torch.parallel.sync_batchnorm`, as
`nn.SyncBatchNorm.convert_sync_batchnorm` converts a model), training
mode takes the global batch's two-pass statistics over the group's
ranks, which hold equal batches: μ = all_reduce(Σx)/N, then var =
all_reduce(Σ(x−μ)²)/N, through the differentiable
`torch.distributed.nn.functional.all_reduce`, whose backward sums the
statistics' cotangents across the ranks as the global program does.  The
running statistics update from the global ones.  Two-pass statistics do
not depend on how the batch is partitioned, which is why the JAX package
chose `use_fast_variance=False`.  Without a group no collective runs.

Tensor parallel (`fastdet_torch.parallel.tp.tensor_parallel`): a sharded
`ConvBN` or head conv computes its block of the output channels between
the model group's collectives, which its `shard` carries, and its
BatchNorm takes its statistics over the data group (the `process_group`
above).  The models import nothing of `fastdet_torch.parallel`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.9
BF16 = torch.bfloat16


def conv16(x, w, stride: int = 1, padding: int = 0, groups: int = 1):
    """bf16 x ⊛ bf16 w → bf16: f32 accumulation, one rounding.  On the
    card cuDNN's bf16 convolution computes just that; on the CPU the
    products run in f32 from the bf16 values and are rounded after."""
    if x.device.type == "cuda":
        return F.conv2d(x, w, None, stride, padding, 1, groups)
    return F.conv2d(x.float(), w.float(), None, stride, padding, 1,
                    groups).to(BF16)


def round16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (to nearest even) and back to t's dtype (f32, or
    f64): a bf16 rounding point written out in a wider type, as the
    training kernels' plain versions compute."""
    return t.to(BF16).to(t.dtype)


def add_bias(x, b):
    """bf16 (or f32) x + the f32 bias → f32 (one kernel: the sum
    promotes)."""
    return x + b[:, None, None]


def head_conv(conv: nn.Conv2d, x, dtype):
    """A 1×1 head conv with bias: in bf16 as flax's `nn.Conv(dtype=bf16)`
    computes it (bf16 product, the bias cast to bf16 and added in bf16),
    else the module itself.  A sharded conv (`conv.shard`, tensor
    parallel) computes its output channels and gathers them."""
    shard = getattr(conv, "shard", None)
    if shard is not None:
        x = shard.copy(x)
    if dtype != BF16:
        y = conv(x)
    else:
        y = (conv16(x, conv.weight.to(BF16))
             + conv.bias.to(BF16)[:, None, None])
    return y if shard is None else shard.gather(y)


def deploy_maps(reg, obj, cls):
    """The deploy bake of one scale's NHWC head outputs: cat[σ(reg),
    σ(obj), softmax(cls)] on the last axis, in their dtype.  The softmax
    is `jax.nn.softmax`'s: exp(x − max) over its sum, the sum in f32 (jnp
    upcasts a bf16 sum), so a bf16 map rounds where flax's does."""
    e = torch.exp(cls - cls.amax(-1, keepdim=True))
    s = e.sum(-1, keepdim=True, dtype=torch.float32).to(e.dtype)
    return torch.cat([torch.sigmoid(reg), torch.sigmoid(obj), e / s], -1)


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 with eps 1e-5.  State dict keys are
    ``weight``, ``bias``, ``running_mean`` and ``running_var`` (no
    ``num_batches_tracked``: the JAX variables have none).
    `process_group` (None: this process's batch alone) makes training
    mode's statistics the group's global batch's."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.process_group = None

    def forward(self, x):
        if x.dtype == BF16:
            return self._forward16(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, BN_EPS)
        shape = [1, -1] + [1] * (x.dim() - 2)
        mean, d, var = self._stats(x)
        update_running_stats(self, mean, var)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return d * mul.view(shape) + self.bias.view(shape)

    def _stats(self, x):
        """(μ, x − μ, var) over every dim but 1: the batch's, or the
        group's global batch's."""
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1, -1] + [1] * (x.dim() - 2)
        group = self.process_group
        if group is None:
            mean = x.mean(dims)
            d = x - mean.view(shape)
            return mean, d, (d * d).mean(dims)
        from torch.distributed import get_world_size
        from torch.distributed.nn.functional import all_reduce
        n = x.numel() // x.shape[1] * get_world_size(group)
        mean = all_reduce(x.sum(dims), group=group) / n
        d = x - mean.view(shape)
        var = all_reduce((d * d).sum(dims), group=group) / n
        return mean, d, var

    def _forward16(self, x):
        """flax's BatchNorm(dtype=bf16): f32 statistics of the upcast
        input (two-pass variance), (x − μ)·(rsqrt(var + eps)·γ) + β in f32,
        one rounding to bf16."""
        xf = x.float()
        shape = [1, -1] + [1] * (x.dim() - 2)
        if self.training:
            mean, _, var = self._stats(xf)
            update_running_stats(self, mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return ((xf - mean.view(shape)) * mul.view(shape)
                + self.bias.view(shape)).to(BF16)


@torch.no_grad()
def update_running_stats(bn: BatchNorm, mean, var) -> None:
    """flax's running update with momentum 0.9 from batch statistics."""
    for buf, batch in ((bn.running_mean, mean), (bn.running_var, var)):
        buf.copy_(BN_MOMENTUM * buf + (1 - BN_MOMENTUM) * batch.detach())


class ConvBN(nn.Module):
    """Conv2d (no bias, 'same' padding k//2) + BatchNorm + optional ReLU.

    ``groups=features_in`` gives a depthwise conv.

    Tensor parallel (`shard`, set by `parallel.tp.tensor_parallel`): the
    conv and BN hold this rank's block of the output channels; the full
    input comes in through the shard's `copy` (a depthwise conv takes its
    block of the input's channels), and the full output leaves through its
    `gather` after BN and ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1,
                 groups: int = 1, relu: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2,
                              groups=groups, bias=False)
        self.bn = BatchNorm(cout)
        self.relu = relu
        self.dtype = dtype
        self.shard = None

    def whole(self, p: torch.Tensor) -> torch.Tensor:
        """Parameter `p` of this module whole: its shards gathered when
        the module is sharded (the gradient keeps this rank's slice)."""
        return p if self.shard is None else self.shard.gather(p, 0)

    def forward(self, x):
        c, shard = self.conv, self.shard
        groups = c.groups
        if shard is not None:
            x = shard.copy(x)
            if groups > 1:                   # depthwise: its own channels
                groups = c.weight.shape[0]
                x = shard.own(x, 1)
        if self.dtype == BF16:
            x = conv16(x.to(BF16), c.weight.to(BF16), c.stride[0],
                       c.padding[0], groups)
        elif shard is not None:
            x = F.conv2d(x, c.weight, None, c.stride, c.padding, 1, groups)
        else:
            x = c(x)
        x = self.bn(x)
        x = F.relu(x) if self.relu else x
        return x if shard is None else shard.gather(x)


class DWConvBlock(nn.Module):
    """Head block: 2 × [dw k×k + BN + ReLU → pw 1×1 + BN], with NO ReLU
    after either pw (the reference's quirk, fastdet/models/layers.py:65)."""

    def __init__(self, features: int, kernel: int = 5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c, d = features, dtype
        self.dw1 = ConvBN(c, c, kernel, groups=c, relu=True, dtype=d)
        self.pw1 = ConvBN(c, c, 1, relu=False, dtype=d)
        self.dw2 = ConvBN(c, c, kernel, groups=c, relu=True, dtype=d)
        self.pw2 = ConvBN(c, c, 1, relu=False, dtype=d)

    def forward(self, x):
        return self.pw2(self.dw2(self.pw1(self.dw1(x))))


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """2× nearest-neighbour upsample of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
