"""Decode + NMS on the raw head outputs (counterpart of
fastdet/ops/postprocess.py).

`postprocess` is the JAX package's top-k-first chain:

  1. per scale, score = sigmoid(obj) · max_c softmax(cls) and its argmax
     class, flattened in (h, w, anchor) order, stride-16 scale first;
     invalid candidates (obj or score ≤ conf_thres) rank as −1;
  2. the ranking sort.  The JAX package sorts the two keys
     (−ranked, combo = idx·nc + cls); `combo` ascends with the index, so
     a stable sort of −ranked is the same order;
  3. the top k = min(`max_nms`, N) candidates.  For k ≤ `MAX_K` (384,
     the serving windows) they go through `rank_decode_nms` (gather,
     decode, class-aware greedy NMS in one kernel).  Wider windows (the
     eval windows, 1,024 and 1,815 at 352²) take the staged path: the
     gather and decode in PyTorch (`ops.decode.decode_ranked`), validity
     score > 0, then `keep_mask_batch` (the `nms_keep` kernel);
  4. `compact_ranked` moves kept rows to the front.

The hand-written CUDA kernels run on the card; on the CPU their plain
versions.  The JAX package also sends k % 128 ≠ 0 and 640² windows to its
staged path, because of TPU VMEM caps (fastdet/ops/postprocess.py:175-178);
both paths give the same output, so the port splits at `MAX_K` alone.
The TPU path's `n·nc < 2²³` guard protects only its f32 index carry; the
CUDA kernel divides integers and needs no such bound.

`postprocess_dense` (decode everything, then `batched_nms`) is the
semantics oracle.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from fastdet_torch import disable_tf32, resolve_device
from fastdet_torch.config import Config
from fastdet_torch.kernels.nms_kernel import (compact_ranked,
                                              suppress_ranked_batch)
from fastdet_torch.kernels.pp_fused import MAX_K, rank_decode_nms
from fastdet_torch.ops.decode import decode_outputs, decode_ranked
from fastdet_torch.ops.nms import batched_nms


def _anchors_array(anchors) -> np.ndarray:
    """(num_scales, A, 2) pixels as a host f32 array."""
    if isinstance(anchors, torch.Tensor):
        anchors = anchors.detach().cpu().numpy()
    return np.asarray(anchors, np.float32)


def postprocess_dense(outputs, anchors, input_hw, *, conf_thres=0.3,
                      iou_thres=0.45, max_det=300, max_nms=1024):
    """Decode ALL candidates, then NMS (the semantics oracle)."""
    anchors_t = torch.from_numpy(_anchors_array(anchors)).to(
        outputs[0].device)
    decoded = decode_outputs(outputs, anchors_t, input_hw)
    return batched_nms(decoded[..., :4], decoded[..., 4], decoded[..., 5:],
                       conf_thres=conf_thres, iou_thres=iou_thres,
                       max_det=max_det, max_nms=max_nms)


@functools.lru_cache(maxsize=16)
def _geo_table(meta: tuple, anchors: tuple, device: str) -> torch.Tensor:
    """(N, 8) f32 geometry table, read-only: rows [cell x, cell y,
    stride, anchor w, anchor h, 0, 0, 0] per flat candidate index
    (flatten order (h, w, anchor), scales concatenated).  Built once per
    (shape, anchors, device)."""
    awh = np.asarray(anchors, np.float32).reshape(-1, 2)
    rows = []
    for s, (cnt, h, w, a, stride) in enumerate(meta):
        local = np.arange(cnt)
        ci = local // a
        g = np.zeros((cnt, 8), np.float32)
        g[:, 0] = ci % w
        g[:, 1] = ci // w
        g[:, 2] = np.float32(stride)
        g[:, 3:5] = awh[s * a + local % a]
        rows.append(g)
    return torch.from_numpy(np.concatenate(rows)).to(device)


def rank_scores(outputs: Sequence[torch.Tensor], input_hw, conf_thres):
    """Per-candidate ranking scores.  → (ranked (B,N) f32, reg_f (B,N,4)
    raw logits, cls_f (B,N) int64, meta: per scale (count, h, w, A,
    stride))."""
    b = outputs[0].shape[0]
    scores, objs, regs, clsargs, meta = [], [], [], [], []
    for s in range(len(outputs) // 3):
        reg, obj, cls = outputs[3 * s:3 * s + 3]
        _, h, w, _ = reg.shape
        a = obj.shape[-1]
        stride = input_hw[0] / h
        obj_p = torch.sigmoid(obj)                        # (B,h,w,A)
        cls_p = torch.softmax(cls, dim=-1)                # (B,h,w,nc)
        cls_max = cls_p.max(dim=-1).values
        cls_arg = cls_p.argmax(dim=-1)
        scores.append((obj_p * cls_max[..., None]).reshape(b, -1))
        objs.append(obj_p.reshape(b, -1))
        regs.append(reg.reshape(b, h * w * a, 4))
        clsargs.append(cls_arg[..., None].expand(b, h, w, a).reshape(b, -1))
        meta.append((h * w * a, h, w, a, stride))
    score = torch.cat(scores, dim=1)
    valid = (torch.cat(objs, dim=1) > conf_thres) & (score > conf_thres)
    ranked = torch.where(valid, score, torch.full_like(score, -1.0))
    return (ranked, torch.cat(regs, dim=1), torch.cat(clsargs, dim=1),
            tuple(meta))


def rank_topk(ranked, cls_f, *, nc: int, k: int):
    """The ranking sort and its top-k window.  → (neg_k (B,k) f32
    ascending, combo_k (B,k) int32 = idx·nc + cls)."""
    neg_s, order = torch.sort(-ranked, dim=1, stable=True)
    order = order[:, :k]
    combo_k = order * nc + torch.gather(cls_f, 1, order)
    return neg_s[:, :k].contiguous(), combo_k.to(torch.int32)


def postprocess(outputs, anchors, input_hw, *, conf_thres=0.3,
                iou_thres=0.45, max_det=300, max_nms=1024):
    """Raw NHWC 6-tuple → ((B,max_det,6) [x1,y1,x2,y2,conf,cls], (B,)
    counts); equal output to `postprocess_dense`."""
    ranked, reg_f, cls_f, meta = rank_scores(outputs, input_hw, conf_thres)
    n = ranked.shape[1]
    k = min(max_nms, n)
    nc = outputs[2].shape[-1]
    neg_k, combo_k = rank_topk(ranked, cls_f, nc=nc, k=k)
    geo = _geo_table(meta, tuple(_anchors_array(anchors).ravel().tolist()),
                     str(ranked.device))
    if k <= MAX_K:
        keep, boxes_k = rank_decode_nms(neg_k, combo_k, reg_f, geo, nc=nc,
                                        iou_thres=iou_thres)
        return compact_ranked(keep, boxes_k, -neg_k, combo_k % nc,
                              max_det=max_det)
    score_k = -neg_k
    boxes_k, cls_k = decode_ranked(combo_k, reg_f, geo, nc=nc)
    return suppress_ranked_batch(boxes_k, score_k, cls_k, score_k > 0,
                                 iou_thres=iou_thres, max_det=max_det)


def build_detect_fn(model, cfg: Config, *, conf_thres=0.3, iou_thres=0.45,
                    max_det=300, max_nms=1024, device=None) -> Callable:
    """Returns `detect(images_u8_nhwc) -> (dets, counts)`.

    `images_u8_nhwc` is a (B,H,W,3) uint8 tensor on the model's device
    (BGR, as the reference's cv2 pipeline gives it); /255 happens on the
    device.  The model is moved to `device` and put in eval mode.  Its
    outputs go to `postprocess` in f32, as the JAX package's detect casts
    them: a bf16 model's too.

    On CUDA this turns TF32 off for the whole process (`disable_tf32`)."""
    dev = resolve_device(device)
    disable_tf32(dev)
    model = model.to(dev).eval()
    anchors = np.asarray(cfg.anchors, np.float32).reshape(
        cfg.num_scales, cfg.anchor_num, 2)
    input_hw: Tuple[int, int] = (cfg.height, cfg.width)

    @torch.inference_mode()
    def detect(images):
        outputs = [o.float() for o in model(images.to(torch.float32)
                                            / 255.0)]
        return postprocess(outputs, anchors, input_hw,
                           conf_thres=conf_thres, iou_thres=iou_thres,
                           max_det=max_det, max_nms=max_nms)

    return detect
