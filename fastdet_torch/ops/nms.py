"""Fixed-shape class-aware greedy NMS, plain PyTorch (counterpart of
fastdet/ops/nms.py).

These are the plain reference versions: the dense oracle
(`postprocess_dense`), the CPU path of the fused kernel's plain version
and the tests use them.  Semantics are the JAX package's:

  * pre-filter obj > conf_thres; conf = obj·cls, single best class;
    second filter conf > conf_thres;
  * greedy suppression in score order with the class-offset trick
    (cls · 4096 added to the coords), IoU without the +1 convention;
  * at most `max_det` detections, score-descending, rows
    [x1, y1, x2, y2, conf, cls], zero past each image's count.

Batched over dim 0 (the JAX versions are vmapped per image).
"""

from __future__ import annotations

import torch

from fastdet_torch.ops.iou import xywh2xyxy

MAX_WH = 4096.0  # class-offset multiplier (reference utils/utils.py:240)


def keep_mask(boxes_k, cls_k, valid_k, *, iou_thres) -> torch.Tensor:
    """Greedy keep mask of rank-ordered candidates.

    boxes_k (B,k,4) xyxy, cls_k (B,k) int, valid_k (B,k) bool → keep (B,k)
    bool.  The f32 IoU is computed op for op as fastdet/ops/nms.py does,
    so the threshold compares are bitwise the same; then the fixpoint
    ``keep ← valid ∧ ¬∃ j<i: overlap[i,j] ∧ keep[j]`` is iterated to
    convergence (its solution is unique: it is the greedy scan)."""
    k = boxes_k.shape[1]
    off = boxes_k + (cls_k.to(boxes_k.dtype) * MAX_WH)[..., None]
    area = (off[..., 2] - off[..., 0]) * (off[..., 3] - off[..., 1])
    lt = torch.maximum(off[:, :, None, :2], off[:, None, :, :2])
    rb = torch.minimum(off[:, :, None, 2:], off[:, None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    iou = inter / (area[:, :, None] + area[:, None, :] - inter + 1e-9)
    lower = torch.ones(k, k, dtype=torch.bool, device=boxes_k.device).tril(-1)
    overlap = (iou > iou_thres) & lower & valid_k[:, None, :]
    keep = valid_k
    for _ in range(k):
        new = valid_k & ~(overlap & keep[:, None, :]).any(-1)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


def suppress_ranked(boxes_k, score_k, cls_k, valid_k, *, iou_thres, max_det):
    """Greedy suppression of score-DESCENDING candidates, then scatter
    compaction.  boxes_k (B,k,4), score_k (B,k), cls_k (B,k) int,
    valid_k (B,k) bool → ((B,max_det,6), (B,) counts)."""
    b = boxes_k.shape[0]
    keep = keep_mask(boxes_k, cls_k, valid_k, iou_thres=iou_thres)
    rank = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    sel = keep & (rank < max_det)
    rows = torch.cat([boxes_k, score_k[..., None],
                      cls_k.to(boxes_k.dtype)[..., None]], dim=-1)
    det = torch.zeros(b, max_det, 6, dtype=boxes_k.dtype,
                      device=boxes_k.device)
    img = torch.arange(b, device=boxes_k.device)[:, None].expand_as(keep)
    det[img[sel], rank[sel]] = rows[sel]
    return det, keep.sum(dim=1).clamp(max=max_det)


def batched_nms(boxes_xywh, obj, cls_scores, *, conf_thres=0.3,
                iou_thres=0.45, max_det=300, max_nms=1024):
    """boxes_xywh (B,N,4), obj (B,N), cls_scores (B,N,nc) →
    detections (B,max_det,6) + counts (B,)."""
    k = min(max_nms, boxes_xywh.shape[1])
    conf = cls_scores * obj[..., None]
    best_conf = conf.max(dim=-1).values
    best_cls = conf.argmax(dim=-1)
    valid = (obj > conf_thres) & (best_conf > conf_thres)
    score = torch.where(valid, best_conf, torch.full_like(best_conf, -1.0))
    # stable descending sort = lax.top_k's lower-index-first tie rule
    score_s, order = torch.sort(score, dim=1, descending=True, stable=True)
    score_k, order = score_s[:, :k], order[:, :k]
    boxes_k = xywh2xyxy(torch.gather(
        boxes_xywh, 1, order[..., None].expand(-1, -1, 4)))
    cls_k = torch.gather(best_cls, 1, order)
    return suppress_ranked(boxes_k, score_k, cls_k, score_k > 0,
                           iou_thres=iou_thres, max_det=max_det)
