"""Anchor decode: raw head logits → per-anchor boxes/scores (counterpart
of fastdet/ops/decode.py).

    xy = (sigmoid(r)·2 − 0.5 + cell) · stride
    wh = (sigmoid(r)·2)² · anchor_pixels
    obj = sigmoid(o);  cls = softmax(c) broadcast across anchors

Flatten order per scale is (h, w, anchor), stride-16 scale first.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def make_grid(h: int, w: int, device=None) -> torch.Tensor:
    """(h, w, 2) grid of (x=col, y=row) cell coordinates, f32."""
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1)


def decode_scale(reg, obj, cls, anchors, stride: float) -> torch.Tensor:
    """reg (B,H,W,4A), obj (B,H,W,A), cls (B,H,W,nc) raw, NHWC; anchors
    (A,2) pixels → (B, H·W·A, 5+nc)."""
    b, h, w, _ = reg.shape
    a = obj.shape[-1]
    nc = cls.shape[-1]
    r = reg.reshape(b, h, w, a, 4)
    grid = make_grid(h, w, reg.device)[None, :, :, None, :]
    xy = (torch.sigmoid(r[..., :2]) * 2.0 - 0.5 + grid) * stride
    t = torch.sigmoid(r[..., 2:4]) * 2.0
    wh = t * t * anchors[None, None, None]
    obj_p = torch.sigmoid(obj)[..., None]
    cls_p = torch.softmax(cls, dim=-1)[:, :, :, None, :].expand(b, h, w, a, nc)
    out = torch.cat([xy, wh, obj_p, cls_p], dim=-1)
    return out.reshape(b, h * w * a, 5 + nc)


def decode_outputs(outputs: Sequence[torch.Tensor], anchors: torch.Tensor,
                   input_hw: Tuple[int, int]) -> torch.Tensor:
    """Decode the 6-tuple (reg2, obj2, cls2, reg3, obj3, cls3).

    anchors: (num_scales, A, 2) pixels → (B, Σ H·W·A, 5+nc)."""
    per_scale = []
    for s in range(len(outputs) // 3):
        reg, obj, cls = outputs[3 * s:3 * s + 3]
        stride = input_hw[0] / reg.shape[1]
        per_scale.append(decode_scale(reg, obj, cls, anchors[s], stride))
    return torch.cat(per_scale, dim=1)
