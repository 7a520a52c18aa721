"""Evaluation runner: batched inference and NMS on the device, metrics on
the host (counterpart of fastdet/eval/runner.py).

Capability parity with the reference Yolo-FastestV2 evaluation loop:
conf 0.01 / NMS 0.4 / IoU 0.5 defaults, targets scaled from normalized
cxcywh to input-pixel xyxy, and (meanP, meanR, mAP, meanF1) from
`ap_per_class`.  The image → detections path runs on the device, one
`detect_fn` call per batch.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import numpy as np

from fastdet_torch.eval.metrics import ap_per_class, batch_statistics


def evaluate(detect_fn: Callable, batches: Iterable,
             input_hw: Tuple[int, int], iou_thres: float = 0.5,
             progress: bool = False, distributed: bool = False
             ) -> Optional[Tuple[float, float, float, float]]:
    """detect_fn(images_u8) -> (dets (B,max_det,6), counts (B,)) tensors,
    where images_u8 is a (B,H,W,3) uint8 tensor on the pipeline's device
    (as `ops.postprocess.build_detect_fn`'s `detect` takes it).

    batches yields (images_u8 (B,H,W,3), labels (B,M,5) [cls,cx,cy,w,h]
    normalized, label_mask (B,M)).  Returns (P, R, mAP, F1) or None if
    there were no detections at all.

    distributed=True: each process of a job evaluated its own shard; the
    stats and labels are all-gathered in rank order
    (`parallel.gather_eval_stats`), so that every process returns the
    global metrics.  On one process it changes nothing."""
    h, w = input_hw
    all_stats = []
    all_labels = []

    it = batches
    if progress:
        try:
            from tqdm import tqdm
            it = tqdm(batches, desc="Evaluation model:")
        except ImportError:
            pass

    for images, labels, mask in it:
        dets, counts = detect_fn(images)
        dets = dets.cpu().numpy()
        counts = counts.cpu().numpy()

        det_list, gt_boxes, gt_labels = [], [], []
        for i in range(len(images)):
            det_list.append(dets[i, :counts[i]])
            lab = np.asarray(labels[i])[np.asarray(mask[i], bool)]
            cls = lab[:, 0]
            cxy, cwh = lab[:, 1:3], lab[:, 3:5]
            xyxy = np.concatenate([cxy - cwh / 2, cxy + cwh / 2], 1)
            xyxy *= np.asarray([w, h, w, h], np.float32)
            gt_boxes.append(xyxy)
            gt_labels.append(cls)
            all_labels.extend(cls.tolist())

        all_stats.extend(batch_statistics(det_list, gt_boxes, gt_labels,
                                          iou_thres))

    if distributed:
        from fastdet_torch.parallel.multihost import gather_eval_stats
        all_stats, all_labels = gather_eval_stats(all_stats, all_labels)

    if not all_stats:
        print("---- No detections over whole validation set ----")
        return None

    tp = np.concatenate([s[0] for s in all_stats])
    conf = np.concatenate([s[1] for s in all_stats])
    pcls = np.concatenate([s[2] for s in all_stats])
    if tp.size == 0:
        print("---- No detections over whole validation set ----")
        return None
    return ap_per_class(tp, conf, pcls, np.asarray(all_labels))
