"""Fused rank→decode→NMS for the serving postprocess (counterpart of
fastdet/kernels/pp_fused.py::rank_decode_nms).

`rank_decode_nms` takes, per image, the top-k rows of the ranking sort
and returns the greedy keep mask and the decoded boxes:

  * neg_k   (B,k) f32: −score, ascending (invalid candidates are +1);
  * combo_k (B,k) i32: idx·nc + cls;
  * regs    (B,N,4) f32: raw reg logits, unsorted, as the heads emit them;
  * geo     (N,8) f32: rows [cell x, cell y, stride, anchor w, anchor h,
    0, 0, 0] per flat candidate index (see ops/postprocess.py::_geo_table)

→ keep (B,k) bool, boxes (B,k,4) f32 xyxy.

On a CUDA tensor it launches the hand-written kernel in
`fastdet_torch/csrc/pp_fused.cu` (k ≤ `MAX_K`) or raises; on a CPU tensor
it runs `rank_decode_nms_reference`, the plain PyTorch version in the same
operation order.  The TPU kernel's (B,4,Np) lane layout and (8,Np) table
became row layouts here, so that the kernel gathers a candidate with one
16-byte load per row.
"""

from __future__ import annotations

import ctypes

import torch

from fastdet_torch.kernels import _build
from fastdet_torch.ops.nms import keep_mask

MAX_K = 384   # the kernel's window bound (shared-memory overlap bitmask)


def rank_decode_nms_reference(neg_k, combo_k, regs, geo, *, nc: int,
                              iou_thres: float):
    """Plain PyTorch version of the kernel, any k, any device: gather,
    decode in the JAX package's operation order (fastdet/ops/
    postprocess.py staged decode), then `ops.nms.keep_mask`."""
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
    return keep_mask(boxes, cls, neg_k < 0, iou_thres=iou_thres), boxes


_SIGNATURES = {
    "fastdet_rank_decode_nms": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
}


def rank_decode_nms(neg_k, combo_k, regs, geo, *, nc: int, iou_thres: float):
    """→ (keep (B,k) bool, boxes (B,k,4) f32).  CUDA: the kernel; CPU:
    the plain version."""
    dev = neg_k.device
    if dev.type == "cpu":
        return rank_decode_nms_reference(neg_k, combo_k, regs, geo, nc=nc,
                                         iou_thres=iou_thres)
    if dev.type != "cuda":
        raise ValueError(f"rank_decode_nms: unsupported device {dev}")
    b, k = neg_k.shape
    n = regs.shape[1]
    if k > MAX_K:
        raise ValueError(f"rank_decode_nms: k={k} > {MAX_K}")
    expect = ((neg_k, torch.float32, (b, k)), (combo_k, torch.int32, (b, k)),
              (regs, torch.float32, (b, n, 4)), (geo, torch.float32, (n, 8)))
    for t, dtype, shape in expect:
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"rank_decode_nms: expected a contiguous {dtype} {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    keep = torch.empty((b, k), dtype=torch.bool, device=dev)
    boxes = torch.empty((b, k, 4), dtype=torch.float32, device=dev)
    lib = _build.load("pp_fused", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.fastdet_rank_decode_nms(
            neg_k.data_ptr(), combo_k.data_ptr(), regs.data_ptr(),
            geo.data_ptr(), keep.data_ptr(), boxes.data_ptr(), b, k, n, nc,
            float(iou_thres), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "rank_decode_nms")
    rank_decode_nms.launches += 1
    return keep, boxes


rank_decode_nms.launches = 0
