"""Serving pipelines (counterpart of fastdet/serve.py).

`DevicePipeline` runs the whole detect chain on the device: uint8 NHWC →
/255 → Detector (f32) → postprocess with the fused rank→decode→NMS
kernel.  Defaults are the JAX package's serving operating point:
conf_thres 0.3, iou_thres 0.45, max_det 300 and a pre-NMS window of
`max_nms=128`, sized for conf ≥ 0.3 (fastdet/serve.py:20-26).

`FusedPipeline`, `ShardedPipeline`, `StreamingPipeline` and
`HybridPipeline` are not ported yet.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from fastdet_torch import resolve_device
from fastdet_torch.config import Config
from fastdet_torch.ops.postprocess import build_detect_fn


class DevicePipeline:
    """`pipe(images_u8)` with an (N,H,W,3) uint8 numpy batch → a list of
    (n_i, 6) float32 arrays [x1,y1,x2,y2,conf,cls] in model input
    coordinates.

    model: a `fastdet_torch.models.Detector`; variables: its state dict
    (e.g. from `fastdet_torch.io.load_state_dict`), loaded into it."""

    def __init__(self, model, variables, cfg: Config, conf_thres=0.3,
                 iou_thres=0.45, max_det=300, max_nms=128, device=None):
        self.device = resolve_device(device)
        model.load_state_dict(variables)
        self._detect = build_detect_fn(model, cfg, conf_thres=conf_thres,
                                       iou_thres=iou_thres, max_det=max_det,
                                       max_nms=max_nms, device=self.device)

    def detect(self, images: torch.Tensor):
        """(B,H,W,3) uint8 tensor on the device → (dets (B,max_det,6),
        counts (B,)) on the device, without a host round trip."""
        return self._detect(images)

    def __call__(self, images_u8: np.ndarray) -> List[np.ndarray]:
        images = torch.from_numpy(np.ascontiguousarray(images_u8))
        dets, counts = self._detect(images.to(self.device))
        dets, counts = dets.cpu().numpy(), counts.cpu().numpy()
        return [dets[i, :counts[i]] for i in range(len(counts))]
