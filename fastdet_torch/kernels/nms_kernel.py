"""Greedy keep mask of a ranked window and its compaction (counterpart of
fastdet/kernels/nms_kernel.py).

`keep_mask_batch` is the staged postprocess's NMS: rank-ordered boxes
(B,k,4) xyxy, classes (B,k) and validity (B,k) → keep (B,k) bool, the
greedy scan ``keep[i] = valid[i] ∧ ¬∃ j<i: keep[j] ∧ IoU(i,j) > thr``
with the class offset (cls · 4096 added to the coordinates).  On a CUDA
tensor it launches the hand-written kernel of `fastdet_torch/csrc/
nms_keep.cu`, at any k and B, or raises; on a CPU tensor it runs
`keep_mask_batch_reference`, the plain version (`ops/nms.py::
keep_mask`).  One kernel replaces both TPU kernels of the JAX module:
`keep_mask_batch`'s single tile (k ≤ 512) and `_suppress_call_tiled`'s
blocked variant (k > 512); their 512 split and T=512 tiles are VMEM
limits that the card does not have.

`compact_ranked` and `suppress_ranked_batch` are PyTorch ops, as the
JAX package computes them in XLA outside any Pallas kernel.
"""

from __future__ import annotations

import ctypes

import torch

from fastdet_torch.kernels import _build
from fastdet_torch.ops.nms import MAX_WH, keep_mask


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


def keep_mask_batch_reference(boxes_k, cls_k, valid_k, *, iou_thres):
    """Plain PyTorch version of the kernel, any device: `ops.nms.
    keep_mask`, whose IoU is the kernel's op for op."""
    return keep_mask(boxes_k, cls_k, valid_k, iou_thres=iou_thres)


_SIGNATURES = {
    "fastdet_nms_keep": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                         + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
}


def keep_mask_batch(boxes_k, cls_k, valid_k, *, iou_thres):
    """→ keep (B,k) bool.  boxes_k (B,k,4) f32 xyxy, cls_k (B,k) int,
    valid_k (B,k) bool; rows in rank order.  `valid_k` is authoritative
    (a valid candidate with score ≤ 0 is eligible); scores are not read.
    CUDA: the kernel, with a (B, k, ⌈k/64⌉) int64 workspace; CPU: the
    plain version."""
    dev = boxes_k.device
    if dev.type == "cpu":
        return keep_mask_batch_reference(boxes_k, cls_k, valid_k,
                                         iou_thres=iou_thres)
    if dev.type != "cuda":
        raise ValueError(f"keep_mask_batch: unsupported device {dev}")
    if boxes_k.dim() != 3 or boxes_k.shape[2] != 4:
        raise ValueError(f"keep_mask_batch: expected boxes (B, k, 4), got "
                         f"{tuple(boxes_k.shape)}")
    b, k = boxes_k.shape[:2]
    expect = ((boxes_k, (torch.float32,), (b, k, 4)),
              (cls_k, (torch.int32, torch.int64), (b, k)),
              (valid_k, (torch.bool,), (b, k)))
    for t, dtypes, shape in expect:
        if (t.device != dev or t.dtype not in dtypes
                or tuple(t.shape) != shape):
            raise ValueError(
                f"keep_mask_batch: expected {' or '.join(map(str, dtypes))} "
                f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if b == 0 or k == 0:
        return torch.zeros((b, k), dtype=torch.bool, device=dev)
    # the class offset in torch, as the JAX wrapper computes it outside
    # its pallas_call (and as the plain version does)
    off = (boxes_k + (cls_k.to(boxes_k.dtype) * MAX_WH)[..., None]) \
        .contiguous()
    valid = valid_k.contiguous()
    mask = torch.empty((b, k, (k + 63) // 64), dtype=torch.int64,
                       device=dev)
    keep = torch.empty((b, k), dtype=torch.bool, device=dev)
    lib = _build.load("nms_keep", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.fastdet_nms_keep(
            off.data_ptr(), valid.data_ptr(), mask.data_ptr(),
            keep.data_ptr(), b, k, float(iou_thres),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "nms_keep")
    keep_mask_batch.launches += 1
    return keep


keep_mask_batch.launches = 0


def suppress_ranked_batch(boxes_k, score_k, cls_k, valid_k, *, iou_thres,
                          max_det):
    """Batched greedy suppression: `keep_mask_batch` + `compact_ranked`.

    boxes_k (B,k,4) xyxy, score_k (B,k) descending, cls_k (B,k) int,
    valid_k (B,k) bool → ((B,max_det,6), (B,) counts); exactly
    `ops.nms.suppress_ranked`."""
    keep = keep_mask_batch(boxes_k, cls_k, valid_k, iou_thres=iou_thres)
    return compact_ranked(keep, boxes_k, score_k, cls_k, max_det=max_det)
