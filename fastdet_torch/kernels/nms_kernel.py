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

The kernel compacts each image's valid candidates first (in rank order),
builds the 64-bit overlap words of the compacted pairs only (the upper
triangle), and walks them a word at a time.  `nms_keep_plan` picks the kernel's variant by (B, k): one CTA
per image in one launch, the image on chip where it fits ("cta"), or
three launches over the whole card for small batches of wide windows
("grid").

`compact_ranked` and `suppress_ranked_batch` are PyTorch ops, as the
JAX package computes them in XLA outside any Pallas kernel.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from fastdet_torch.kernels import _build
from fastdet_torch.ops.nms import keep_mask


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


# ------------------------------------------------------- the launch plan
#
# The variants of csrc/nms_keep.cu; `fastdet_nms_keep_smem` and
# `fastdet_nms_keep_workspace` report what `nms_keep_smem` and
# `nms_keep_workspace` compute here.

NMS_VARIANTS = ("cta", "grid")
NMS_KERNELS = {"cta": ("nms_keep_kernel",),
               "grid": ("nms_compact_kernel", "nms_tile_kernel",
                        "nms_walk_kernel")}
NMS_THREADS = {"cta": (512,), "grid": (256, 128, 32)}
NMS_CAP_WORDS = 26           # kCapWords: the cta variant's rows on chip
NMS_SCAN_BYTES = 33 * 4      # kScanBytes
NMS_SMEM_PER_CTA = 227 * 1024
# the grid variant takes batches below this at windows wider than
# NMS_GRID_MIN_K: one CTA an image would leave most of the 132 SMs idle
NMS_GRID_MAX_B = 64
NMS_GRID_MIN_K = 384


def _image_bytes(np_: int) -> int:
    """An image's compacted list (box 16 B, area, rank and kept-list slot
    4 B each) for np_ candidates and its row triangle of np_ / 64 words
    (`image_bytes`)."""
    w = np_ // 64
    return 28 * np_ + 8 * 64 * (w * (w + 1) // 2)


def nms_keep_smem(variant: str, k: int) -> int:
    """Shared memory (bytes) of one CTA of the variant's largest launch:
    "cta" the on-chip image of min(⌈k/64⌉, NMS_CAP_WORDS) words and the
    scan's; "grid" the compaction's scan."""
    if variant == "grid":
        return NMS_SCAN_BYTES
    return _image_bytes(64 * min(-(-k // 64), NMS_CAP_WORDS)) \
        + NMS_SCAN_BYTES


def nms_keep_workspace(variant: str, b: int, k: int) -> int:
    """Device workspace (bytes): each image's compacted list and row
    triangle for n_v up to k ("cta" only where k is past its on-chip cap),
    and the grid variant's n_v an image."""
    kp = 64 * -(-k // 64)
    if variant == "cta":
        return 0 if kp <= 64 * NMS_CAP_WORDS else b * _image_bytes(kp)
    return b * _image_bytes(kp) + 4 * b


@dataclass(frozen=True)
class NmsKeepPlan:
    """How one call of `keep_mask_batch` runs on the card."""
    variant: str            # "cta" or "grid"
    kernels: Tuple[str, ...]
    threads: Tuple[int, ...]  # a CTA of each kernel, in launch order
    cluster: int            # CTAs of a cluster (1: none)
    smem_bytes: int         # shared memory a CTA, the largest launch's
    nv_cap: int             # n_v up to which an image's rows stay on chip
    workspace_bytes: int
    launches: int           # device launches a call


@functools.lru_cache(maxsize=None)
def _variant_plan(variant: str, b: int, k: int) -> NmsKeepPlan:
    """The launch plan of the named variant at (B, k) (the tests and the
    smoke hold and time both through it)."""
    if variant not in NMS_VARIANTS:
        raise ValueError(f"nms_keep_plan: unknown variant {variant!r}")
    kernels = NMS_KERNELS[variant]
    cap = 64 * min(-(-k // 64), NMS_CAP_WORDS) if variant == "cta" else 0
    return NmsKeepPlan(variant, kernels, NMS_THREADS[variant], 1,
                       nms_keep_smem(variant, k), cap,
                       nms_keep_workspace(variant, b, k), len(kernels))


def nms_keep_plan(b: int, k: int) -> NmsKeepPlan:
    """The launch plan of `nms_keep` at (B, k).  n_v is the data's, so
    the plan covers any: "cta" (one CTA an image, one launch; rows on
    chip to n_v = 64·min(⌈k/64⌉, NMS_CAP_WORDS), past that in the
    workspace) unless the batch is small and the window wide, where "grid"
    spreads the rows over the card (three launches)."""
    return _variant_plan("grid" if b < NMS_GRID_MAX_B and k > NMS_GRID_MIN_K
                         else "cta", b, k)


_SIGNATURES = {
    "fastdet_nms_keep": ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                         + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
                         ctypes.c_int),
    "fastdet_nms_keep_smem": ([ctypes.c_int] * 2, ctypes.c_size_t),
    "fastdet_nms_keep_workspace": ([ctypes.c_int] * 3, ctypes.c_size_t),
}


def keep_mask_batch(boxes_k, cls_k, valid_k, *, iou_thres):
    """→ keep (B,k) bool.  boxes_k (B,k,4) f32 xyxy, cls_k (B,k) int32 or
    int64, valid_k (B,k) bool; rows in rank order.  `valid_k` is
    authoritative (a valid candidate with score ≤ 0 is eligible); scores
    are not read.  CUDA: the kernel as `nms_keep_plan(B, k)` launches it,
    the class offset added inside it; CPU: the plain version."""
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
    return _launch(boxes_k, cls_k, valid_k, float(iou_thres),
                   nms_keep_plan(b, k))


def _launch(boxes_k, cls_k, valid_k, iou_thres: float, plan: NmsKeepPlan):
    """The kernel as `plan` launches it, on inputs `keep_mask_batch` has
    checked (the tests and the smoke pass a plan of either variant)."""
    b, k = valid_k.shape
    dev = boxes_k.device
    boxes, cls, valid = (t.contiguous() for t in (boxes_k, cls_k, valid_k))
    ws = (torch.empty(plan.workspace_bytes, dtype=torch.uint8, device=dev)
          if plan.workspace_bytes else None)
    keep = torch.empty((b, k), dtype=torch.bool, device=dev)
    lib = _build.load("nms_keep", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.fastdet_nms_keep(
            boxes.data_ptr(), cls.data_ptr(), int(cls.dtype == torch.int64),
            valid.data_ptr(), keep.data_ptr(),
            None if ws is None else ws.data_ptr(), b, k, iou_thres,
            NMS_VARIANTS.index(plan.variant),
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
