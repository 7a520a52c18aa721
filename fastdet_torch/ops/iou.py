"""Box conversions and the training CIoU (counterpart of
fastdet/ops/iou.py, the parts the serving and training paths use)."""

from __future__ import annotations

import math

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) cx,cy,w,h → x1,y1,x2,y2."""
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def bbox_ciou(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """Elementwise CIoU between aligned (..., 4) xywh boxes (the reference
    training IoU, CIoU=True): the union has +1e-16 on box1's area term,
    the convex diagonal +1e-16, and the aspect-ratio weight alpha is a
    constant (detached)."""
    b1_x1, b1_x2 = box1[..., 0] - box1[..., 2] / 2, box1[..., 0] + box1[..., 2] / 2
    b1_y1, b1_y2 = box1[..., 1] - box1[..., 3] / 2, box1[..., 1] + box1[..., 3] / 2
    b2_x1, b2_x2 = box2[..., 0] - box2[..., 2] / 2, box2[..., 0] + box2[..., 2] / 2
    b2_y1, b2_y2 = box2[..., 1] - box2[..., 3] / 2, box2[..., 1] + box2[..., 3] / 2

    inter = ((torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1))
             .clamp(min=0)
             * (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1))
             .clamp(min=0))

    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1
    union = (w1 * h1 + 1e-16) + w2 * h2 - inter
    iou = inter / union

    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    c2 = cw ** 2 + ch ** 2 + 1e-16
    rho2 = (((b2_x1 + b2_x2) - (b1_x1 + b1_x2)) ** 2
            + ((b2_y1 + b2_y2) - (b1_y1 + b1_y2)) ** 2) / 4
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = (v / (1 - iou + v)).detach()
    return iou - (rho2 / c2 + v * alpha)
