"""Compaction of ranked detections (counterpart of
fastdet/kernels/nms_kernel.py::compact_ranked).

A PyTorch op, not a kernel: the JAX package computes it in XLA, outside
any Pallas kernel.  The TPU keep-mask kernels of that module
(`keep_mask_batch`, `_suppress_call_tiled`) are not ported yet.
"""

from __future__ import annotations

import torch


def compact_ranked(keep, boxes_k, score_k, cls_k, *, max_det):
    """Kept rows to the front IN RANK ORDER via one sort on the unique
    integer key (rank | k+rank), then a gather — exactly the scatter
    compaction of ops/nms.py::suppress_ranked.

    keep (B,k) bool, boxes_k (B,k,4), score_k (B,k), cls_k (B,k) int
    → ((B,max_det,6) rows [xyxy, conf, cls], (B,) counts)."""
    b, k = score_k.shape
    n_keep = keep.sum(dim=1).clamp(max=max_det)
    rank = torch.arange(k, device=keep.device).expand(b, k)
    order = torch.sort(torch.where(keep, rank, rank + k), dim=1).indices
    rows = torch.cat([boxes_k, score_k[..., None],
                      cls_k.to(boxes_k.dtype)[..., None]], dim=-1)
    rows = torch.gather(rows, 1, order[..., None].expand(-1, -1, 6))
    if k < max_det:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, max_det - k))
    live = torch.arange(max_det, device=keep.device)[None] < n_keep[:, None]
    det = torch.where(live[..., None], rows[:, :max_det],
                      torch.zeros((), dtype=rows.dtype, device=rows.device))
    return det, n_keep
