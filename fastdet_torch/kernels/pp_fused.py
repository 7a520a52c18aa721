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
`fastdet_torch/csrc/pp_fused.cu` (k ≤ `MAX_K`) as `rank_decode_nms_plan`
says, or raises; on a CPU tensor it runs `rank_decode_nms_reference`, the
plain PyTorch version in the same operation order.  The TPU kernel's
(B,4,Np) lane layout and (8,Np) table became row layouts here, so that
the kernel gathers a candidate with one 16-byte load per row.

The kernel decodes rank i in thread i, compacts the valid candidates in
rank order with a block-wide scan, and hands them to the NMS core it
shares with `nms_keep` (`csrc/nms_core.cuh`: 64-bit overlap words of the
compacted pairs in a row triangle, then a walk a word at a time).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from fastdet_torch.kernels import _build
from fastdet_torch.ops.decode import decode_ranked
from fastdet_torch.ops.nms import keep_mask

MAX_K = 384   # the kernel's window bound: one thread a rank


def rank_decode_nms_reference(neg_k, combo_k, regs, geo, *, nc: int,
                              iou_thres: float):
    """Plain PyTorch version of the kernel, any k, any device: gather,
    decode in the JAX package's operation order (`ops.decode.
    decode_ranked`, the staged decode), then `ops.nms.keep_mask`."""
    boxes, cls = decode_ranked(combo_k, regs, geo, nc=nc)
    return keep_mask(boxes, cls, neg_k < 0, iou_thres=iou_thres), boxes


# ------------------------------------------------------- the launch plan
#
# `fastdet_rank_decode_nms_smem` reports what `rank_decode_nms_smem`
# computes here.

RDN_KERNEL = "rank_decode_nms_kernel"
# a CTA of the most threads the kernel takes (kMaxThreads), whatever k: a
# thread a rank for the decode, and 32 warps for the rows, whose latency
# more warps hide (at B ≤ 132 a CTA has its SM to itself)
RDN_THREADS = 1024
RDN_SCAN_BYTES = 33 * 4      # kScanBytes


def rank_decode_nms_smem(k: int) -> int:
    """Shared memory (bytes) of one CTA at window k: the compacted list
    (box 16 B, area, rank and kept-list slot 4 B each) and the row
    triangle for n_v up to 64·⌈k/64⌉, and the scan's ints."""
    w = -(-k // 64)
    return 28 * 64 * w + 8 * 64 * (w * (w + 1) // 2) + RDN_SCAN_BYTES


@dataclass(frozen=True)
class RankDecodeNmsPlan:
    """How one call of `rank_decode_nms` runs on the card."""
    kernel: str
    ctas: int               # one an image
    threads: int            # a CTA (≥ k: one thread a rank)
    smem_bytes: int         # shared memory a CTA
    nv_cap: int             # n_v the shared memory holds (≥ k)
    launches: int           # device launches a call


@functools.lru_cache(maxsize=64)
def rank_decode_nms_plan(b: int, k: int) -> RankDecodeNmsPlan:
    """The launch plan at (B, k): one launch of one CTA an image of
    `RDN_THREADS`, the image's compacted candidates and overlap words in
    shared memory sized by k.  Cached: the wrapper asks for it at every
    launch."""
    if not 1 <= k <= MAX_K or b < 1:
        raise ValueError(f"rank_decode_nms_plan: b={b}, k={k} (k ≤ {MAX_K})")
    return RankDecodeNmsPlan(RDN_KERNEL, b, RDN_THREADS,
                             rank_decode_nms_smem(k), 64 * -(-k // 64), 1)


_SIGNATURES = {
    "fastdet_rank_decode_nms": (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    "fastdet_rank_decode_nms_smem": ([ctypes.c_int], ctypes.c_size_t),
}


def rank_decode_nms(neg_k, combo_k, regs, geo, *, nc: int, iou_thres: float):
    """→ (keep (B,k) bool, boxes (B,k,4) f32).  CUDA: the kernel as
    `rank_decode_nms_plan(B, k)` launches it; CPU: the plain version."""
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
    plan = rank_decode_nms_plan(b, k)
    keep = torch.empty((b, k), dtype=torch.bool, device=dev)
    boxes = torch.empty((b, k, 4), dtype=torch.float32, device=dev)
    lib = _build.load("pp_fused", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.fastdet_rank_decode_nms(
            neg_k.data_ptr(), combo_k.data_ptr(), regs.data_ptr(),
            geo.data_ptr(), keep.data_ptr(), boxes.data_ptr(), b, k, n, nc,
            float(iou_thres), plan.threads,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "rank_decode_nms")
    rank_decode_nms.launches += 1
    return keep, boxes


rank_decode_nms.launches = 0
