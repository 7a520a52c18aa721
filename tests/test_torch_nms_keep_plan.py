"""The staged NMS kernel's decomposition and launch plan, on the CPU.

`nms_keep` (fastdet_torch/csrc/nms_keep.cu) compacts each image's valid
candidates, builds the 64-bit overlap words of the compacted pairs in a
row triangle and walks them a word at a time.
`keep_mask_batch_steps` below is those steps in plain PyTorch; it is held
bitwise (`torch.equal`) to the plain version `keep_mask_batch_reference`
on crowded fields (invalid candidates scattered through the window),
prefix-valid windows of the staged postprocess, images with no, one and
all candidates valid, and n_v across the 64-candidate words; and to the
JAX package's `keep_mask_batch` (B4 at k = 512, B5's blocks at k = 1300)
in interpret mode.  `nms_keep_plan` is checked at phase 2c's 15 classes
of chip_smoke.py, the eval windows and a 640² window: shared memory,
clusters, launches, and a workspace that covers the worst n_v.  The card
holds the kernel to the plain version and the plan's shared memory to
the kernel's (tests/test_torch_cuda.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fastdet.kernels import nms_kernel as jnk
from fastdet_torch.kernels import nms_kernel as nk
from fastdet_torch.ops.nms import MAX_WH
from torch_cases import ANCHORS, crowded, head_outputs, staged_window

IOU = 0.4
SMOKE_2C = [(b, k) for k in (385, 512, 1024, 1815, 2048) for b in (1, 8, 32)]
EVAL_WINDOWS = [(128, 512), (128, 1024), (128, 1815)]
WINDOW_640 = (32, 2048)


def _row_off(j: int, u: int, w: int) -> int:
    """Offset of compacted row j's word u (u ≥ j // 64) in the kernel's
    row triangle of an image of w words (`row_off` in nms_keep.cu): row
    block r (rows 64r..64r+63) holds words r..w-1."""
    r = j >> 6
    return 64 * (r * w - r * (r - 1) // 2) + (j & 63) * (w - r) + (u - r)


_MASK64 = (1 << 64) - 1


def keep_mask_batch_steps(boxes_k, cls_k, valid_k, *, iou_thres):
    """The kernel's steps in plain PyTorch, image by image: (1) compaction
    of the valid candidates in rank order, the class offset as the kernel
    adds it, x + (cls·4096); (2) the 64-bit words of the compacted pairs,
    bit c of row j's word u set when candidate 64u + c comes after j and
    IoU > thr (the plain version's IoU op for op), stored in the kernel's
    row triangle; (3) the walk a word at a time: word u's removed bits are
    the OR of word u of every row kept so far, its greedy order is
    resolved on its diagonal block; (4) the kept candidates scattered back
    to their ranks.  → keep (B,k) bool."""
    keep = torch.zeros(valid_k.shape, dtype=torch.bool)
    for n in range(valid_k.shape[0]):
        rank = torch.nonzero(valid_k[n]).flatten()
        nv = rank.numel()
        off = boxes_k[n][rank] \
            + (cls_k[n][rank].to(torch.float32) * MAX_WH)[:, None]
        area = (off[:, 2] - off[:, 0]) * (off[:, 3] - off[:, 1])
        lt = torch.maximum(off[:, None, :2], off[None, :, :2])
        rb = torch.minimum(off[:, None, 2:], off[None, :, 2:])
        wh = (rb - lt).clamp(min=0)
        inter = wh[..., 0] * wh[..., 1]
        iou = inter / (area[None, :] + area[:, None] - inter + 1e-9)
        over = (iou > iou_thres) & torch.ones(nv, nv, dtype=torch.bool) \
            .triu(1)                                  # [j, i]: i after j
        w = -(-nv // 64)
        bits = F.pad(over, (0, 64 * w - nv)).reshape(nv, w, 64).long()
        words = (bits << torch.arange(64)).sum(-1).tolist()
        rows = [0] * (64 * (w * (w + 1) // 2))
        for j in range(nv):
            for u in range(j >> 6, w):
                rows[_row_off(j, u, w)] = words[j][u] & _MASK64
        kept = []
        for u in range(w):
            removed = 0
            for j in kept:
                removed |= rows[_row_off(j, u, w)]
            nrow = min(64, nv - 64 * u)
            avail = ((1 << nrow) - 1) & ~removed
            word = 0
            while avail:
                bit = (avail & -avail).bit_length() - 1
                word |= 1 << bit
                avail &= ~(rows[_row_off(64 * u + bit, u, w)] | 1 << bit)
            kept += [64 * u + c for c in range(64) if word >> c & 1]
        keep[n, rank[kept]] = True
    return keep


def as_torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def steps_and_plain(boxes, cls, valid):
    got = keep_mask_batch_steps(boxes, cls, valid, iou_thres=IOU)
    want = nk.keep_mask_batch_reference(boxes, cls, valid, iou_thres=IOU)
    assert got.dtype == want.dtype == torch.bool
    return got, want


@pytest.mark.parametrize("k", [63, 64, 65, 129, 385, 512, 1815, 2048])
def test_steps_bitwise_on_crowded_fields(k):
    boxes, _, cls, valid = as_torch(*crowded(k, 2, k))
    got, want = steps_and_plain(boxes, cls, valid)
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < int(valid.sum())


@pytest.mark.parametrize("k,conf", [(512, 0.01), (1024, 0.3), (1815, 0.01)])
def test_steps_bitwise_on_prefix_valid_windows(k, conf):
    """The main path's windows (`staged_window` on head outputs): validity
    is a prefix of each ranked window."""
    outs = [torch.from_numpy(o) for o in head_outputs(3, b=2)]
    boxes, score, cls = staged_window(outs, ANCHORS, (352, 352),
                                      conf_thres=conf, max_nms=k)
    valid = score > 0
    assert bool(((~valid).cumsum(1) > 0).eq(~valid).all())
    got, want = steps_and_plain(boxes, cls, valid)
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < int(valid.sum())


def test_steps_bitwise_with_no_one_and_all_valid():
    boxes, _, cls, valid = crowded(7, 3, 200)
    valid[0] = False
    valid[1] = False
    valid[1, 77] = True
    valid[2] = True
    got, want = steps_and_plain(*as_torch(boxes, cls.astype(np.int32),
                                          valid))
    assert torch.equal(got, want)
    assert not want[0].any() and want[1].tolist() == valid[1].tolist()
    assert 0 < int(want[2].sum()) < 200


@pytest.mark.parametrize("nv", [63, 64, 65, 127, 128, 129])
def test_steps_bitwise_across_words(nv):
    """n_v on both sides of the 64-candidate words: the last word's tail
    and a diagonal block of one row."""
    boxes, _, cls, valid = crowded(nv, 2, 300)
    valid[:] = False
    valid[0, :nv] = True
    valid[1, 300 - nv:] = True
    got, want = steps_and_plain(*as_torch(boxes, cls, valid))
    assert torch.equal(got, want)
    assert (want.sum(1) > 0).all() and int(want.sum()) < 2 * nv


@functools.lru_cache(maxsize=None)
def field(k):
    return crowded(5, 2, k)


@pytest.mark.parametrize("k", [512, 1300])
def test_steps_bitwise_vs_pallas(k):
    """Against the JAX package's TPU kernels in interpret mode: B4's
    single tile (k = 512) and B5's 512-blocks with padding (k = 1300)."""
    boxes, score, cls, valid = field(k)
    want = np.asarray(jnk.keep_mask_batch(
        *[jnp.asarray(a) for a in (boxes, score, cls, valid)],
        iou_thres=IOU, interpret=True))
    got = keep_mask_batch_steps(*as_torch(boxes, cls, valid),
                                   iou_thres=IOU)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < valid.sum()


@pytest.mark.parametrize("w", [1, 2, 3, 8, 29])
def test_row_triangle_is_dense_and_disjoint(w):
    """Every (row j, word u ≥ j // 64) of an image of w words has its own
    slot of the triangle, and the slots fill it."""
    offs = [_row_off(j, u, w) for j in range(64 * w)
            for u in range(j // 64, w)]
    assert sorted(offs) == list(range(64 * w * (w + 1) // 2))


def image_bytes_needed(nv):
    """Bytes an image of n_v valid candidates needs, from the layout: the
    compacted list (box 16 B, area, rank, kept-list slot 4 B each) for
    64·⌈n_v/64⌉ candidates and the row triangle up to its last slot."""
    w = -(-nv // 64)
    return 28 * 64 * w + 8 * (_row_off(64 * w - 1, w - 1, w) + 1)


@pytest.mark.parametrize("b,k", SMOKE_2C + EVAL_WINDOWS + [WINDOW_640])
def test_plan(b, k):
    for variant in nk.NMS_VARIANTS:
        plan = nk._variant_plan(variant, b, k)
        assert plan.smem_bytes <= nk.NMS_SMEM_PER_CTA
        assert plan.cluster <= 8
        assert plan.launches == len(plan.kernels) == len(plan.threads)
        assert all(t % 32 == 0 and t <= 1024 for t in plan.threads)
        if variant == "cta":
            assert plan.launches == 1
            # every n_v up to the cap fits on chip
            assert nk.NMS_SCAN_BYTES + image_bytes_needed(plan.nv_cap) \
                <= plan.smem_bytes
            assert plan.nv_cap == min(64 * -(-k // 64),
                                      64 * nk.NMS_CAP_WORDS)
            # past it, the workspace holds the worst n_v = k of each image
            worst = b * image_bytes_needed(k) if k > plan.nv_cap else 0
        else:
            assert plan.launches == 3 and plan.nv_cap == 0
            worst = b * image_bytes_needed(k) + 4 * b
        assert plan.workspace_bytes >= worst
    chosen = nk.nms_keep_plan(b, k)
    assert chosen.variant in nk.NMS_VARIANTS
    if (b, k) in EVAL_WINDOWS:
        assert chosen.variant == "cta" and chosen.launches == 1


def test_plan_refuses_an_unknown_variant():
    with pytest.raises(ValueError, match="unknown variant"):
        nk._variant_plan("tile", 1, 512)
