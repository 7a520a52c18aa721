"""The serving postprocess kernel's decomposition and launch plan, on the
CPU.

`rank_decode_nms` (fastdet_torch/csrc/pp_fused.cu) decodes rank i of the
window in thread i, compacts the valid candidates in rank order with a
block-wide scan, and hands them to the NMS core it shares with nms_keep
(fastdet_torch/csrc/nms_core.cuh): 64-bit overlap words of the compacted
pairs in a row triangle, then a walk a word at a time whose word order is
resolved as a fixpoint on the word's diagonal block.
`rank_decode_nms_steps` below is those steps in plain PyTorch with the
kernel's indexing; it is held bitwise (`torch.equal` on keep and boxes)
to the plain version `rank_decode_nms_reference` at k 128 / 256 / 384 on
the dense, sparse, tied and clustered windows of `torch_cases.make_inputs`,
at n_v across the 64-candidate words, on the served path's prefix-valid
windows and with combos out of range; and to the JAX package's
`rank_decode_nms` in interpret mode (keep bitwise, boxes within
BOX_ULPS_XLA).  `rank_decode_nms_plan` is checked at chip_smoke.py's phase
2 classes and the served shape.  The card holds the kernel to the plain
version and the plan's shared memory to the kernel's
(tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet.kernels.pp_fused import rank_decode_nms as jax_rank_decode_nms
from fastdet.ops.postprocess import _geo_table as jax_geo_table
from fastdet_torch.kernels import pp_fused
from fastdet_torch.ops.nms import MAX_WH
from fastdet_torch.ops.postprocess import rank_scores, rank_topk
from torch_cases import (ANCHORS, BOX_ULPS_XLA, CONV_K, CONV_NC, IOU, META,
                         N, NC, NV_CLASSES, OUT_OF_RANGE, box_ulps,
                         conv_window, head_outputs, make_inputs, nv_window,
                         out_of_range_window, port_geo)

NPAD = 1920   # the TPU kernel's lane padding of N
PHASE2 = [(b, k) for b in (1, 128) for k in (128, 256, 384)]
SERVED = (128, 128)
_MASK64 = (1 << 64) - 1


def _row_off(j: int, u: int, w: int) -> int:
    """Offset of compacted row j's word u (u ≥ j // 64) in the row
    triangle of an image of w words (`row_off` in nms_core.cuh)."""
    r = j >> 6
    return 64 * (r * w - r * (r - 1) // 2) + (j & 63) * (w - r) + (u - r)


def _block_scan(flags, threads):
    """The kernel's block-wide exclusive scan of one flag a thread
    (`block_scan`): inclusive scans within warps of 32, an exclusive scan
    of the warp totals → (positions, total)."""
    v = torch.zeros(threads, dtype=torch.int64)
    v[:flags.numel()] = flags.long()
    x = v.reshape(-1, 32).cumsum(1)
    base = x[:, -1].cumsum(0) - x[:, -1]
    return (base[:, None] + x).flatten() - v, int(x[:, -1].sum())


def _decode(neg, combo, regs, geo, nc):
    """Step 1 for one image: thread i decodes rank i.  idx = combo / nc
    truncated as C divides; a combo that is negative or whose idx ≥ N is
    out of range: its row is never read, its box is (NaN, 0, 0, 0) and it
    is invalid.  → (boxes (k,4), cls (k,), valid (k,))."""
    n = regs.shape[0]
    combo = combo.long()
    idx = torch.div(combo, nc, rounding_mode="trunc")
    ok = (combo >= 0) & (idx < n)
    safe = torch.where(ok, idx, torch.zeros_like(idx))
    cls = combo - safe * nc
    s = torch.sigmoid(regs[safe])
    g = geo[safe]
    x = (s[:, 0] * 2.0 - 0.5 + g[:, 0]) * g[:, 2]
    y = (s[:, 1] * 2.0 - 0.5 + g[:, 1]) * g[:, 2]
    tw = s[:, 2] * 2.0
    th = s[:, 3] * 2.0
    w = tw * tw * g[:, 3]
    h = th * th * g[:, 4]
    boxes = torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], -1)
    nan_box = torch.tensor([float("nan"), 0.0, 0.0, 0.0])
    boxes = torch.where(ok[:, None], boxes, nan_box)
    return boxes, cls, ok & (neg < 0)


def _overlaps(bi, ai, bj, aj, iou_thres):
    """`overlaps` of nms_core.cuh, candidates bi (m,4) against row bj (4,):
    disjoint pairs skip the division (0 / den is never above a threshold
    ≥ 0)."""
    iw = (torch.minimum(bi[:, 2], bj[2]) - torch.maximum(bi[:, 0], bj[0])) \
        .clamp(min=0)
    ih = (torch.minimum(bi[:, 3], bj[3]) - torch.maximum(bi[:, 1], bj[1])) \
        .clamp(min=0)
    inter = iw * ih
    den = ai + aj - inter + 1e-9
    return (inter > 0) & (inter / den > iou_thres)


def rank_decode_nms_steps(neg_k, combo_k, regs, geo, *, nc, iou_thres):
    """The kernel's steps in plain PyTorch, image by image, with its
    indexing and the CTA of `rank_decode_nms_plan`: (1) decode of every
    rank, boxes out and keep 0 for each; (2) compaction: the block scan
    of the validity flags gives each valid rank its position in buffers
    of nv_cap candidates (class-offset box x + cls·4096, area, rank; NaN
    where nothing is written); (3) rows: bit c of row j's word u set when
    candidate 64u + c comes after j, exists and overlaps it, stored in the
    row triangle (a slot never written stays None and fails its read);
    (4) the walk a word at a time: word u's removed bits are the OR of word
    u of every row kept so far, its greedy order the fixpoint of kept =
    avail & ~OR{diagonal row c : c in kept} (at most 65 rounds), its kept
    candidates scattered to their ranks.
    → (keep (B,k) bool, boxes (B,k,4) f32)."""
    b, k = neg_k.shape
    plan = pp_fused.rank_decode_nms_plan(b, k)
    keep = torch.zeros((b, k), dtype=torch.bool)
    boxes = torch.empty((b, k, 4), dtype=torch.float32)
    for m in range(b):
        box, cls, valid = _decode(neg_k[m], combo_k[m], regs[m], geo, nc)
        boxes[m] = box
        pos, nv = _block_scan(valid, plan.threads)
        assert nv <= plan.nv_cap
        cbox = torch.full((plan.nv_cap, 4), float("nan"))
        carea = torch.full((plan.nv_cap,), float("nan"))
        crank = torch.full((plan.nv_cap,), -1, dtype=torch.int64)
        sel = torch.nonzero(valid).flatten()
        off = box[sel] + (cls[sel].to(torch.float32) * MAX_WH)[:, None]
        cbox[pos[sel]] = off
        carea[pos[sel]] = (off[:, 2] - off[:, 0]) * (off[:, 3] - off[:, 1])
        crank[pos[sel]] = sel
        w = -(-nv // 64)
        rows = [None] * (64 * (w * (w + 1) // 2))
        for u in range(w):
            i = torch.arange(64 * u, 64 * u + 64)
            live = i < nv
            last = i.clamp(max=nv - 1)
            for j in range(min(64 * u + 64, nv)):
                bits = live & (i > j) & _overlaps(
                    cbox[last], carea[last], cbox[j], carea[j], iou_thres)
                rows[_row_off(j, u, w)] = sum(
                    1 << c for c in torch.nonzero(bits).flatten().tolist())
        kept = []
        for u in range(w):
            removed = 0
            for j in kept:
                removed |= rows[_row_off(j, u, w)]
            nrow = min(64, nv - 64 * u)
            avail = ((1 << nrow) - 1) & ~removed & _MASK64
            word = avail
            for _ in range(65):
                sup = 0
                for c in range(nrow):
                    if word >> c & 1:
                        sup |= rows[_row_off(64 * u + c, u, w)]
                nxt = avail & ~sup
                if nxt == word:
                    break
                word = nxt
            else:
                raise AssertionError("the word's fixpoint took > 65 rounds")
            kept += [64 * u + c for c in range(64) if word >> c & 1]
        keep[m, crank[kept]] = True
    return keep, boxes


def torch_inputs(neg_k, combo_k, regs):
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (neg_k, combo_k, regs)] + [port_geo()]


def steps_and_plain(args, nc=NC):
    keep, boxes = rank_decode_nms_steps(*args, nc=nc, iou_thres=IOU)
    rkeep, rboxes = pp_fused.rank_decode_nms_reference(*args, nc=nc,
                                                       iou_thres=IOU)
    assert keep.dtype == rkeep.dtype == torch.bool
    assert torch.equal(keep, rkeep) and torch.equal(boxes, rboxes)
    return keep


@pytest.mark.parametrize("k", [128, 256, 384])
@pytest.mark.parametrize("case", ["dense", "sparse", "tied", "clustered"])
def test_steps_bitwise_vs_plain(k, case):
    args = torch_inputs(*make_inputs(k + len(case), 2, k, case))
    keep = steps_and_plain(args)
    assert 0 < int(keep.sum()) < int((args[0] < 0).sum())


@pytest.mark.parametrize("nv", NV_CLASSES)
def test_steps_bitwise_across_words(nv):
    """n_v on both sides of the 64-candidate words at k = 384, all scores
    tied (`nv_window`): image 0 valid on a prefix, image 1 on a seeded
    scatter; 384 is the whole window valid."""
    args = torch_inputs(*nv_window(nv, 2))
    keep = steps_and_plain(args)
    kept = keep.sum(1).tolist()
    if nv <= 1:
        assert kept == [nv, nv]
    else:
        assert min(kept) > 0 and sum(kept) < 2 * nv


def test_steps_with_out_of_range_combos():
    """Combos below 0 or past the last candidate are never read: NaN box,
    keep 0, and invalid though their score ranks them; every other rank
    is the plain version's on the window with those ranks made invalid."""
    neg_k, combo_k, regs, clean_neg, clean_combo = out_of_range_window()
    keep, boxes = rank_decode_nms_steps(
        *torch_inputs(neg_k, combo_k, regs), nc=NC, iou_thres=IOU)
    rkeep, rboxes = pp_fused.rank_decode_nms_reference(
        *torch_inputs(clean_neg, clean_combo, regs), nc=NC, iou_thres=IOU)
    hit = torch.zeros_like(keep)
    for m, i in OUT_OF_RANGE:
        hit[m, i] = True
        assert torch.isnan(boxes[m, i, 0]) and not boxes[m, i, 1:].any()
    assert not keep[hit].any()
    assert torch.equal(keep, rkeep)
    assert torch.equal(boxes[~hit], rboxes[~hit])


@pytest.mark.parametrize("conf,k", [(0.3, 128), (0.01, 384)])
def test_steps_bitwise_on_served_windows(conf, k):
    """The served path's windows (`rank_scores` and `rank_topk` on head
    outputs): validity is a prefix of each ranked window."""
    outs = [torch.from_numpy(o) for o in head_outputs(5, b=2)]
    ranked, reg_f, cls_f, _ = rank_scores(outs, (352, 352), conf)
    neg_k, combo_k = rank_topk(ranked, cls_f, nc=NC, k=k)
    valid = neg_k < 0
    assert bool(((~valid).cumsum(1) > 0).eq(~valid).all())
    keep = steps_and_plain([neg_k, combo_k, reg_f.contiguous(), port_geo()])
    assert 0 < int(keep.sum()) < int(valid.sum())


def test_steps_bitwise_on_the_convergence_window():
    """The convergence check's eval window (b32 128², 3 classes, conf
    0.05, k = 240; `torch_cases.conv_window`)."""
    args = list(conv_window(7))
    valid = args[0] < 0
    keep = steps_and_plain(args, nc=CONV_NC)
    assert 0 < int(keep.sum()) < int(valid.sum())


@pytest.mark.parametrize("k", [128, 256])
def test_steps_vs_pallas(k):
    """Against the JAX package's TPU kernel in interpret mode: keep
    bitwise, boxes within BOX_ULPS_XLA (XLA's and PyTorch's sigmoids)."""
    neg_k, combo_k, regs = make_inputs(k + 3, 2, k, "clustered")
    regs_lane = np.pad(regs, ((0, 0), (0, NPAD - N), (0, 0))).transpose(
        0, 2, 1)
    jkeep, jboxes = jax_rank_decode_nms(
        jnp.asarray(neg_k), jnp.asarray(combo_k), jnp.asarray(regs_lane),
        jax_geo_table(META, jnp.asarray(ANCHORS), NPAD), nc=NC,
        iou_thres=IOU, interpret=True)
    keep, boxes = rank_decode_nms_steps(
        *torch_inputs(neg_k, combo_k, regs), nc=NC, iou_thres=IOU)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert box_ulps(boxes.numpy(), np.asarray(jboxes)).max() <= BOX_ULPS_XLA
    assert 0 < int(keep.sum()) < int((neg_k < 0).sum())


def image_bytes_needed(nv):
    """Bytes an image of n_v valid candidates needs, from the layout: the
    compacted list (box 16 B, area, rank, kept-list slot 4 B each) for
    64·⌈n_v/64⌉ candidates and the row triangle up to its last slot."""
    w = -(-nv // 64)
    return 28 * 64 * w + 8 * (_row_off(64 * w - 1, w - 1, w) + 1)


@pytest.mark.parametrize("b,k", PHASE2 + [SERVED, (1, 1), (2, 64), (2, 65),
                                          (8, 383), (32, CONV_K)])
def test_plan(b, k):
    plan = pp_fused.rank_decode_nms_plan(b, k)
    assert plan.launches == 1 and plan.kernel == "rank_decode_nms_kernel"
    assert plan.ctas == b
    # one thread a rank, whole warps, at most the kernel's bound
    assert k <= plan.threads <= 1024
    assert plan.threads % 32 == 0
    # every n_v up to k fits, within the 48 KB a launch takes unasked
    assert plan.nv_cap >= k
    assert image_bytes_needed(k) + pp_fused.RDN_SCAN_BYTES \
        <= plan.smem_bytes == pp_fused.rank_decode_nms_smem(k) <= 48 * 1024


@pytest.mark.parametrize("b,k", [(1, 0), (1, pp_fused.MAX_K + 1), (0, 128)])
def test_plan_refuses_what_the_kernel_does_not_take(b, k):
    with pytest.raises(ValueError, match="rank_decode_nms_plan"):
        pp_fused.rank_decode_nms_plan(b, k)
