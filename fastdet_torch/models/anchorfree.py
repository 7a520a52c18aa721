"""Anchor-free single-scale detector (counterpart of
fastdet/models/anchorfree.py, the FastestDet-style family).

The ShuffleNetV2 backbone feeds one stride-16 scale: the stride-16 stage
concatenated with the 2× upsampled stride-32 stage ([C2, up(C3)], the
reverse of LightFPN's order), a 1×1 `fuse` ConvBN, and decoupled
depthwise-separable heads that predict per cell [obj, cls…, dx, dy, w, h]
with no anchor boxes:

    cx = (gx + σ(dx)·2 − 0.5) · stride
    cy = (gy + σ(dy)·2 − 0.5) · stride
    w  = σ(w)² · input_w          (box size as a fraction of the image)
    h  = σ(h)² · input_h

Training assigns each ground-truth box to its centre cell and the
YOLO-style neighbour cells: obj is BCE over the grid, box is CIoU, cls is
softmax CE at the assigned cells (`anchorfree_loss`).

The module names are the JAX package's, so `io.weights.from_jax_variables`
loads its `.npz` files.  The model takes and returns NHWC, as `Detector`
does; inside it computes NCHW.  Suppression is `ops.nms.batched_nms`,
which the JAX package leaves to XLA, so this family needs no kernel of its
own: its fused path (`build_anchorfree_fused_detect`) runs the backbone
kernels of `kernels/fused_infer.py` with `head="anchorfree"`.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fastdet_torch import disable_tf32, resolve_device
from fastdet_torch.models.layers import (BF16, BatchNorm, ConvBN,
                                         DWConvBlock, deploy_maps, head_conv,
                                         upsample_nearest_2x)
from fastdet_torch.models.shufflenet import ShuffleNetV2
from fastdet_torch.ops.decode import make_grid
from fastdet_torch.ops.iou import bbox_ciou
from fastdet_torch.ops.nms import batched_nms
from fastdet_torch.train.loss import (BOX_GAIN, CLS_GAIN, OBJ_GAIN,
                                      _bce_logits, _grid_mean,
                                      _masked_mean)
from fastdet_torch.train.targets import _OFFSETS


class AnchorFreeDetector(nn.Module):
    """Single-scale anchor-free detector: (B, H, W, 3) float NHWC → the raw
    NHWC (obj (B,h,w,1), cls (B,h,w,classes), reg (B,h,w,4)) at stride 16,
    or with `deploy=True` their decoded concat [σ(reg), σ(obj),
    softmax(cls)] (B, h, w, 5 + classes).  `dtype` is the compute dtype,
    as `Detector`'s: bf16 outputs from f32 parameters."""

    def __init__(self, classes: int = 80, out_depth: int = 96,
                 stage_out_channels: Tuple[int, ...] = (-1, 24, 48, 96, 192),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.classes = classes
        self.dtype = dtype
        self.backbone = ShuffleNetV2(stage_out_channels, dtype=dtype)
        self.fuse = ConvBN(stage_out_channels[3] + stage_out_channels[4],
                           out_depth, 1, relu=True, dtype=dtype)
        self.head_cls = DWConvBlock(out_depth, 5, dtype=dtype)
        self.head_reg = DWConvBlock(out_depth, 5, dtype=dtype)
        self.out_obj = nn.Conv2d(out_depth, 1, 1)
        self.out_cls = nn.Conv2d(out_depth, classes, 1)
        self.out_reg = nn.Conv2d(out_depth, 4, 1)

    def forward(self, x, deploy: bool = False):
        if self.dtype == BF16:
            x = x.to(BF16)
        c2, c3 = self.backbone(x.permute(0, 3, 1, 2))
        s = self.fuse(torch.cat([c2, upsample_nearest_2x(c3)], dim=1))
        feat_cls = self.head_cls(s)
        feat_reg = self.head_reg(s)
        d = self.dtype
        obj, cls, reg = (o.permute(0, 2, 3, 1) for o in (
            head_conv(self.out_obj, feat_cls, d),
            head_conv(self.out_cls, feat_cls, d),
            head_conv(self.out_reg, feat_reg, d)))
        if deploy:
            return deploy_maps(reg, obj, cls)
        return obj, cls, reg


@torch.no_grad()
def seeded_init(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights drawn from `generator` (on the CPU), as flax's
    defaults draw them: conv kernels N(0, 1/fan_in) (LeCun normal), conv
    biases 0, BN scale 1, bias 0, running mean 0 and variance 1.  → the
    model."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * fan_in ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return model


def decode_anchorfree(obj, cls, reg, input_hw: Tuple[int, int]):
    """Raw NHWC maps → (boxes_xywh (B,N,4) pixels, obj (B,N), cls (B,N,nc)),
    f32, N = h·w in row-major cell order.  The stride is input_h / h; the
    size scale is (input_w, input_h), width first."""
    b, h, w, _ = obj.shape
    nc = cls.shape[-1]
    stride = input_hw[0] / h
    grid = make_grid(h, w, obj.device)[None]
    r = torch.sigmoid(reg.float())
    xy = (r[..., :2] * 2.0 - 0.5 + grid) * stride
    wh = r[..., 2:4] ** 2 * torch.tensor(
        [input_hw[1], input_hw[0]], dtype=torch.float32, device=obj.device)
    boxes = torch.cat([xy, wh], dim=-1).reshape(b, h * w, 4)
    obj_p = torch.sigmoid(obj.float()).reshape(b, h * w)
    cls_p = torch.softmax(cls.float(), dim=-1).reshape(b, h * w, nc)
    return boxes, obj_p, cls_p


def build_anchorfree_detect_fn(model: AnchorFreeDetector, input_hw,
                               conf_thres=0.3, iou_thres=0.45, max_det=300,
                               max_nms=128, device=None) -> Callable:
    """→ `detect(images_u8_nhwc) -> (dets (B,max_det,6), counts (B,))`:
    /255, the model (moved to `device`, eval mode, f32), the decode, then
    `batched_nms`.  On CUDA this turns TF32 off for the whole process."""
    dev = resolve_device(device)
    disable_tf32(dev)
    model = model.to(dev).eval()

    @torch.inference_mode()
    def detect(images):
        obj, cls, reg = model(images.to(torch.float32) / 255.0)
        boxes, obj_p, cls_p = decode_anchorfree(obj, cls, reg, input_hw)
        return batched_nms(boxes, obj_p, cls_p, conf_thres=conf_thres,
                           iou_thres=iou_thres, max_det=max_det,
                           max_nms=max_nms)

    return detect


def build_anchorfree_fused_detect(state_dict, input_hw=(352, 352),
                                  conf_thres=0.3, iou_thres=0.45,
                                  max_det=300, max_nms=128,
                                  dtype=torch.float32, device=None
                                  ) -> Tuple[Callable,
                                             Dict[str, torch.Tensor]]:
    """The fused serving path of the family → (detect(packed, images) →
    (dets, counts), packed): the backbone's stem and span kernels
    (`build_fused_forward(head="anchorfree")`) on the s2d(4) uint8 batch
    of `pack_images_s2d`, then the decode and `batched_nms`, in `dtype`
    (torch.float32 or torch.bfloat16; the logits are f32 in both)."""
    from fastdet_torch.kernels.fused_infer import build_fused_forward

    fwd, packed = build_fused_forward(
        state_dict, input_hw=input_hw, dtype=dtype, input_format="s2d_u8",
        head="anchorfree", device=device)

    @torch.inference_mode()
    def detect(packed, images):
        obj, cls, reg = fwd(images, packed)
        boxes, obj_p, cls_p = decode_anchorfree(obj, cls, reg, input_hw)
        return batched_nms(boxes, obj_p, cls_p, conf_thres=conf_thres,
                           iou_thres=iou_thres, max_det=max_det,
                           max_nms=max_nms)

    return detect, packed


def anchorfree_loss(outputs, labels, label_mask, input_hw, group=None):
    """Dense anchor-free loss: centre + neighbour cell assignment, CIoU box,
    BCE obj over the grid, softmax CE cls at the assigned cells.

    outputs: raw NHWC (obj (B,H,W,1), cls (B,H,W,nc), reg (B,H,W,4)), cast
    to f32 first as the JAX function does; labels (B,M,5) [cls,cx,cy,w,h]
    normalized; label_mask (B,M) bool.  → (total, components).

    The obj target takes the max over the labels that land in a cell (two
    in one cell give 1, not 2); the gathers of reg and cls at the
    assigned cells accumulate their gradients where cells repeat.
    Invalid candidates get the unit box [0, 0, 1, 1] as their target.
    `input_hw` is unused, as in the JAX function: the loss works in grid
    units.  `group`: global normalizers over a data-parallel group, as
    `compute_loss` takes them."""
    obj, cls, reg = (o.float() for o in outputs)
    b, h, w, _ = obj.shape
    nc = cls.shape[-1]
    dev = obj.device
    labels = torch.as_tensor(labels, device=dev).float()
    label_mask = torch.as_tensor(label_mask, device=dev).bool()

    cls_t = labels[..., 0].long()                                 # (B,M)
    scale = torch.tensor([w, h], dtype=torch.float32, device=dev)
    gxy = labels[..., 1:3] * scale
    gwh_n = labels[..., 3:5]

    gx, gy = gxy[..., 0], gxy[..., 1]
    inv_x, inv_y = w - gx, h - gy
    j = (gx % 1.0 < 0.5) & (gx > 1.0)
    k = (gy % 1.0 < 0.5) & (gy > 1.0)
    l_ = (inv_x % 1.0 < 0.5) & (inv_x > 1.0)
    m_ = (inv_y % 1.0 < 0.5) & (inv_y > 1.0)
    off_ok = torch.stack([torch.ones_like(j), j, k, l_, m_], -1)  # (B,M,O)
    mask = label_mask[:, :, None] & off_ok
    maskf = mask.float()

    offs = torch.from_numpy(_OFFSETS).to(dev)
    gij = torch.floor(gxy[:, :, None, :] - offs).long()
    gi = gij[..., 0].clamp(0, w - 1)                              # (B,M,O)
    gj = gij[..., 1].clamp(0, h - 1)
    b_idx = torch.arange(b, device=dev)[:, None, None].expand_as(gi)

    # box: CIoU in grid units
    ps = reg[b_idx, gj, gi]                                       # (B,M,O,4)
    pxy = torch.sigmoid(ps[..., :2]) * 2.0 - 0.5
    pwh = torch.sigmoid(ps[..., 2:4]) ** 2 * scale
    dxy = gxy[:, :, None, :] - torch.stack([gi, gj], -1).float()
    twh = gwh_n[:, :, None, :] * scale
    tbox = torch.cat([dxy, twh.expand_as(dxy)], -1)
    tbox = torch.where(mask[..., None], tbox,
                       torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev))
    pbox = torch.cat([pxy, pwh], -1)
    lbox = _masked_mean(1.0 - bbox_ciou(pbox, tbox), maskf, group)

    # obj: BCE over the grid, target 1 at assigned cells (a scatter-max)
    cell = (b_idx * h + gj) * w + gi
    tobj = torch.zeros(b * h * w, device=dev).scatter_reduce_(
        0, cell.reshape(-1), maskf.reshape(-1), reduce="amax")
    lobj = _grid_mean(_bce_logits(obj[..., 0], tobj.reshape(b, h, w)), group)

    # cls at assigned cells
    if nc > 1:
        logp = F.log_softmax(cls[b_idx, gj, gi], -1)              # (B,M,O,nc)
        tcls = cls_t.clamp(0, nc - 1)[:, :, None, None].expand(
            -1, -1, logp.shape[2], 1)
        ce = -logp.gather(-1, tcls)[..., 0]
        lcls = _masked_mean(ce, maskf, group) / nc
    else:
        lcls = torch.zeros((), device=dev)

    lbox = lbox * BOX_GAIN
    lobj = lobj * OBJ_GAIN
    lcls = lcls * CLS_GAIN
    total = lbox + lobj + lcls
    return total, {"box": lbox, "obj": lobj, "cls": lcls, "total": total}
