"""Box conversions (counterpart of fastdet/ops/iou.py, the part the
serving path uses)."""

from __future__ import annotations

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(..., 4) cx,cy,w,h → x1,y1,x2,y2."""
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)
