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


def decode_ranked(combo_k: torch.Tensor, regs: torch.Tensor,
                  geo: torch.Tensor, *, nc: int):
    """The staged decode of a ranked window (fastdet/ops/postprocess.py's
    staged path, in its operation order): gather each candidate's raw reg
    logits and geometry row, then decode.

    combo_k (B,k) int = idx·nc + cls; regs (B,N,4) raw logits; geo (N,8)
    rows [cell x, cell y, stride, anchor w, anchor h, 0, 0, 0] (see
    ops/postprocess.py::_geo_table) → (boxes (B,k,4) f32 xyxy, cls (B,k)
    int64)."""
    combo = combo_k.long()
    idx, cls = combo // nc, combo % nc
    r = torch.gather(regs, 1, idx[..., None].expand(-1, -1, 4))
    g = geo[idx]                                          # (B,k,8)
    s = torch.sigmoid(r)
    x = (s[..., 0] * 2.0 - 0.5 + g[..., 0]) * g[..., 2]
    y = (s[..., 1] * 2.0 - 0.5 + g[..., 1]) * g[..., 2]
    tw = s[..., 2] * 2.0
    th = s[..., 3] * 2.0
    w = tw * tw * g[..., 3]
    h = th * th * g[..., 4]
    boxes = torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], dim=-1)
    return boxes, cls
