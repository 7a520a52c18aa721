"""Model-family registry: a model, its detect builder and its loss
(counterpart of fastdet/models/registry.py).

Families:
  * "yolo-fastestv2" (default; aliases "yolofastestv2", "v2", "default")
    — the anchor-based two-scale `Detector`;
  * "anchorfree" (alias "fastestdet") — the single-scale
    `AnchorFreeDetector`.

`build_detect_fn(**kw)` takes the detect builder's keywords (conf_thres,
iou_thres, max_det, max_nms, device) and returns `detect(images_u8)`;
`loss_fn(outputs, labels, mask, anchors, input_hw)` is the signature the
Trainer calls, whichever family (the anchor-free loss ignores anchors).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch import nn

YOLO_NAMES = ("yolo-fastestv2", "yolofastestv2", "v2", "default")
ANCHORFREE_NAMES = ("anchorfree", "fastestdet")


class ModelFamily(NamedTuple):
    name: str
    model: nn.Module
    build_detect_fn: Callable
    loss_fn: Callable


def family_name(name) -> str:
    """A family's canonical name from any of its aliases; ValueError for
    an unknown one."""
    name = (name or "yolo-fastestv2").lower()
    if name in YOLO_NAMES:
        return "yolo-fastestv2"
    if name in ANCHORFREE_NAMES:
        return "anchorfree"
    raise ValueError(f"unknown model family: {name}")


def _model(cls, dtype, *args, **kw) -> nn.Module:
    """bf16 is a compute dtype (f32 parameters, as the JAX package's
    `get_family(dtype=bf16)`); any other dtype casts the parameters, as
    the f64 parity tests want."""
    if dtype == torch.bfloat16:
        return cls(*args, dtype=dtype, **kw)
    return cls(*args, **kw).to(dtype)


def get_family(name, cfg, dtype=torch.float32) -> ModelFamily:
    """The family `name` for the `.data` config `cfg`, its model computing
    in `dtype` with PyTorch's default initialisation (load a state dict
    into it)."""
    if family_name(name) == "yolo-fastestv2":
        from fastdet_torch.models.detector import Detector
        from fastdet_torch.ops.postprocess import build_detect_fn
        from fastdet_torch.train.loss import compute_loss

        model = _model(Detector, dtype, cfg.classes, cfg.anchor_num)

        def detect_builder(**kw):
            return build_detect_fn(model, cfg, **kw)

        return ModelFamily("yolo-fastestv2", model, detect_builder,
                           compute_loss)

    from fastdet_torch.models.anchorfree import (AnchorFreeDetector,
                                                 anchorfree_loss,
                                                 build_anchorfree_detect_fn)

    model = _model(AnchorFreeDetector, dtype, classes=cfg.classes)

    def detect_builder(**kw):
        kw.pop("dtype", None)
        return build_anchorfree_detect_fn(model, (cfg.height, cfg.width),
                                          **kw)

    def loss_fn(outputs, labels, mask, anchors, input_hw):
        return anchorfree_loss(outputs, labels, mask, input_hw)

    return ModelFamily("anchorfree", model, detect_builder, loss_fn)
