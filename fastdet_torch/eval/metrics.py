"""Detection metrics: greedy TP matching + VOC all-point-interpolated AP
(the port's own copy of fastdet/eval/metrics.py, numpy only).

Semantic parity with the reference Yolo-FastestV2 eval path (its
utils/utils.py:110-230), including its quirks, which affect the reported mAP and therefore must be reproduced exactly:
  * predictions are scanned in score order; matching stops once every
    ground-truth box has been claimed
  * a prediction is only eligible if its class appears SOMEWHERE in the
    image's labels, but the IoU match itself is class-agnostic and the
    matched GT may have a different class
  * each GT may be claimed once; IoU uses the `+1` pixel convention
  * AP is the VOC all-point interpolation over the raw PR curve, per
    class present in the ground truth; P/R/F1 are curve endpoints

Implementation is vectorised numpy on the host — the tensors here are a
few hundred rows per image (the heavy lifting, NMS, already happened
on-device).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _iou_matrix_plus1(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4)×(M,4) xyxy IoU with the +1 pixel convention."""
    iw = np.clip(np.minimum(a[:, None, 2], b[None, :, 2])
                 - np.maximum(a[:, None, 0], b[None, :, 0]) + 1, 0, None)
    ih = np.clip(np.minimum(a[:, None, 3], b[None, :, 3])
                 - np.maximum(a[:, None, 1], b[None, :, 1]) + 1, 0, None)
    inter = iw * ih
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-16)


def batch_statistics(detections: Sequence[np.ndarray],
                     gt_boxes: Sequence[np.ndarray],
                     gt_labels: Sequence[np.ndarray],
                     iou_threshold: float = 0.5
                     ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Greedy per-image TP assignment.

    detections: per image (n,6) [x1,y1,x2,y2,conf,cls], ALREADY sorted by
    confidence descending (NMS output order).
    gt_boxes: per image (m,4) xyxy (input-pixel scale);
    gt_labels: per image (m,) class ids.
    Returns per image (tp, conf, pred_cls) arrays.
    """
    out = []
    for dets, tboxes, tlabels in zip(detections, gt_boxes, gt_labels):
        n = len(dets)
        tp = np.zeros(n)
        if n == 0:
            out.append((tp, np.zeros(0), np.zeros(0)))
            continue
        conf = dets[:, 4]
        pcls = dets[:, 5]
        m = len(tboxes)
        if m:
            label_set = set(np.asarray(tlabels).tolist())
            claimed = np.zeros(m, bool)
            iou_all = _iou_matrix_plus1(dets[:, :4], tboxes)
            for i in range(n):
                if claimed.all():
                    break
                if float(pcls[i]) not in label_set:
                    continue
                j = int(np.argmax(iou_all[i]))
                if iou_all[i, j] >= iou_threshold and not claimed[j]:
                    tp[i] = 1
                    claimed[j] = True
        out.append((tp, conf, pcls))
    return out


def average_precision(recall: np.ndarray, precision: np.ndarray) -> float:
    """VOC all-point interpolated AP (precision envelope · Δrecall)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.flatnonzero(mrec[1:] != mrec[:-1])
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def ap_per_class(tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray,
                 target_cls: np.ndarray
                 ) -> Tuple[float, float, float, float]:
    """Returns (mean P, mean R, mAP, mean F1) over classes present in GT."""
    order = np.argsort(-conf)
    tp, pred_cls = tp[order], pred_cls[order]

    ap, p, r = [], [], []
    for c in np.unique(target_cls):
        mask = pred_cls == c
        n_gt = int((target_cls == c).sum())
        n_p = int(mask.sum())
        if n_p == 0 and n_gt == 0:
            continue
        if n_p == 0 or n_gt == 0:
            ap.append(0.0)
            p.append(0.0)
            r.append(0.0)
            continue
        tpc = np.cumsum(tp[mask])
        fpc = np.cumsum(1 - tp[mask])
        recall_curve = tpc / (n_gt + 1e-16)
        precision_curve = tpc / (tpc + fpc)
        r.append(float(recall_curve[-1]))
        p.append(float(precision_curve[-1]))
        ap.append(average_precision(recall_curve, precision_curve))

    p, r, ap = np.asarray(p), np.asarray(r), np.asarray(ap)
    f1 = 2 * p * r / (p + r + 1e-16)
    return float(np.mean(p)), float(np.mean(r)), float(np.mean(ap)), \
        float(np.mean(f1))
