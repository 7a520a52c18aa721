"""Card tests of the port: the CUDA kernels against their plain versions,
the wrappers' checks, the CUDA dispatch rules (k ≤ 384 through
rank_decode_nms, wider windows through nms_keep), and the pipelines on
the card.  They skip where there is no NVIDIA card.  The
file imports no JAX, so that it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fastdet_torch import disable_tf32
from fastdet_torch.config import Config
from fastdet_torch.io import load_state_dict
from fastdet_torch.kernels import (fold, fused_infer, fused_train,
                                   nms_kernel, pp_fused, stem_train)
from fastdet_torch.models import AnchorFreeDetector, Detector
from fastdet_torch.models.anchorfree import (build_anchorfree_detect_fn,
                                             seeded_init)
from fastdet_torch.ops import nms
from fastdet_torch.ops.postprocess import postprocess
from fastdet_torch.serve import DevicePipeline, FusedPipeline
from torch_cases import (AF_GOLDEN, ANCHORS, BOX_ULPS_CARD, CONV_NC, IOU, NC,
                         NV_CLASSES, OUT_OF_RANGE, S2SPAN_CASES, SPAN_CASES,
                         SPAN_TRAIN_B1, SPAN_TRAIN_CONV, SPAN_TRAIN_EDGE,
                         SPAN_TRAIN_FULL,
                         SPAN_TRAIN_SMALL, STEM8_CASES, STEM_CASES,
                         STEM_TRAIN_CASES,
                         box_ulps, conv_window, crowded, golden_image,
                         golden_mismatches, grad_err, head_outputs,
                         make_inputs, nv_window, out_of_range_window,
                         pool_ties, port_geo, s2span_case,
                         span16_backward_errs, span_train_case,
                         span_train_grad_errs,
                         staged_reference, staged_window, stem8_case,
                         stem_case, stem_train_case)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    """The card, with TF32 off: the plain versions' cuDNN convs and
    matmuls must compute f32 for any subset of these tests, not only after
    a pipeline has turned TF32 off for the process."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    dev = torch.device("cuda:0")
    disable_tf32(dev)
    return dev


@pytest.mark.parametrize("b", [1, 128])
@pytest.mark.parametrize("k", [128, 256, 384])
@pytest.mark.parametrize("case", ["dense", "sparse", "clustered"])
def test_kernel_matches_plain(card, b, k, case):
    neg_k, combo_k, regs = make_inputs(k + b, b, k, case)
    args = [torch.from_numpy(a).to(card) for a in (neg_k, combo_k, regs)]
    args.append(port_geo(str(card)))
    before = pp_fused.rank_decode_nms.launches
    keep, boxes = pp_fused.rank_decode_nms(*args, nc=NC, iou_thres=IOU)
    assert pp_fused.rank_decode_nms.launches == before + 1
    rkeep, rboxes = pp_fused.rank_decode_nms_reference(*args, nc=NC,
                                                       iou_thres=IOU)
    torch.cuda.synchronize()
    assert torch.equal(keep, rkeep)
    assert box_ulps(boxes.cpu().numpy(), rboxes.cpu().numpy()).max() \
        <= BOX_ULPS_CARD
    assert 0 < int(keep.sum()) < int((args[0] < 0).sum())


def _kernel_and_plain(card, arrays):
    """rank_decode_nms on the card (one launch) and its plain version on
    the same inputs → (keep, boxes, plain keep, plain boxes)."""
    args = [torch.from_numpy(a).to(card) for a in arrays]
    args.append(port_geo(str(card)))
    before = pp_fused.rank_decode_nms.launches
    keep, boxes = pp_fused.rank_decode_nms(*args, nc=NC, iou_thres=IOU)
    assert pp_fused.rank_decode_nms.launches == before + 1
    rkeep, rboxes = pp_fused.rank_decode_nms_reference(*args, nc=NC,
                                                       iou_thres=IOU)
    torch.cuda.synchronize()
    return keep, boxes, rkeep, rboxes


@pytest.mark.parametrize("b", [1, 128])
@pytest.mark.parametrize("nv", NV_CLASSES)
def test_kernel_matches_plain_across_words(card, b, nv):
    """n_v on both sides of the compacted list's 64-candidate words, none,
    one and all 384 valid (`nv_window`: prefix and scattered validity)."""
    keep, boxes, rkeep, rboxes = _kernel_and_plain(card, nv_window(nv, b))
    assert torch.equal(keep, rkeep)
    assert box_ulps(boxes.cpu().numpy(), rboxes.cpu().numpy()).max() \
        <= BOX_ULPS_CARD
    assert int(keep.sum(1).max()) <= nv
    if nv <= 1:
        assert int(keep.sum()) == nv * b


def test_kernel_with_out_of_range_combos(card):
    """Out-of-range combos are never read: NaN box, never kept; every
    other rank is the plain version's on the window with them invalid."""
    neg_k, combo_k, regs, clean_neg, clean_combo = out_of_range_window()
    geo = port_geo(str(card))
    keep, boxes = pp_fused.rank_decode_nms(
        *[torch.from_numpy(a).to(card) for a in (neg_k, combo_k, regs)],
        geo, nc=NC, iou_thres=IOU)
    rkeep, rboxes = pp_fused.rank_decode_nms_reference(
        *[torch.from_numpy(a).to(card)
          for a in (clean_neg, clean_combo, regs)],
        geo, nc=NC, iou_thres=IOU)
    torch.cuda.synchronize()
    hit = torch.zeros_like(keep)
    for m, i in OUT_OF_RANGE:
        hit[m, i] = True
        assert torch.isnan(boxes[m, i, 0]) and not boxes[m, i, 1:].any()
    assert torch.equal(keep, rkeep) and not keep[hit].any()
    assert box_ulps(boxes[~hit].cpu().numpy(),
                    rboxes[~hit].cpu().numpy()).max() <= BOX_ULPS_CARD


@pytest.mark.parametrize("conf,k", [(0.3, 128), (0.01, 384)])
def test_kernel_matches_plain_on_served_windows(card, conf, k):
    """The served path's windows (`rank_scores`, `rank_topk` on head
    outputs, b8): validity a prefix of each window."""
    from fastdet_torch.ops.postprocess import rank_scores, rank_topk
    outs = [torch.from_numpy(o).to(card) for o in head_outputs(5, b=8)]
    ranked, reg_f, cls_f, _ = rank_scores(outs, (352, 352), conf)
    neg_k, combo_k = rank_topk(ranked, cls_f, nc=NC, k=k)
    keep, boxes, rkeep, rboxes = _kernel_and_plain(
        card, [t.cpu().numpy() for t in (neg_k, combo_k, reg_f)])
    assert torch.equal(keep, rkeep)
    assert box_ulps(boxes.cpu().numpy(), rboxes.cpu().numpy()).max() \
        <= BOX_ULPS_CARD
    assert 0 < int(keep.sum()) < int((neg_k < 0).sum())


def test_kernel_matches_plain_on_the_convergence_window(card):
    """The convergence check's eval window (b32 128², 3 classes, conf
    0.05, k = 240; `torch_cases.conv_window`): one launch, keep bitwise,
    boxes within BOX_ULPS_CARD."""
    args = list(conv_window(7, device=card))
    before = pp_fused.rank_decode_nms.launches
    keep, boxes = pp_fused.rank_decode_nms(*args, nc=CONV_NC, iou_thres=IOU)
    assert pp_fused.rank_decode_nms.launches == before + 1
    rkeep, rboxes = pp_fused.rank_decode_nms_reference(*args, nc=CONV_NC,
                                                       iou_thres=IOU)
    torch.cuda.synchronize()
    assert keep.shape == (32, 240) and torch.equal(keep, rkeep)
    assert box_ulps(boxes.cpu().numpy(), rboxes.cpu().numpy()).max() \
        <= BOX_ULPS_CARD
    assert 0 < int(keep.sum()) < int((args[0] < 0).sum())


def test_bf16_family_detect_on_the_card(card):
    """The bf16 family's detect at the convergence check's eval (b32
    128², 3 classes, conf 0.05): the outputs cast to f32 reach
    rank_decode_nms (one launch), and the detections are the postprocess's
    on the same f32-cast outputs, bit for bit."""
    from fastdet_torch.models.registry import get_family
    from fastdet_torch.tools import convergence_check as cc
    cfg = cc.make_config(0.002, 32)
    torch.manual_seed(0)
    fam = get_family("yolo-fastestv2", cfg, dtype=torch.bfloat16)
    detect = fam.build_detect_fn(conf_thres=0.05, iou_thres=0.45,
                                 device=card)
    images = torch.from_numpy(cc.eval_set()[0][:32]).to(card)
    before = pp_fused.rank_decode_nms.launches
    dets, counts = detect(images)
    assert pp_fused.rank_decode_nms.launches == before + 1
    with torch.inference_mode():
        outs = [o.float() for o in fam.model(images.float() / 255.0)]
        rdets, rcounts = postprocess(
            outs, np.asarray(cfg.anchors, np.float32).reshape(2, 3, 2),
            (128, 128), conf_thres=0.05, iou_thres=0.45)
    torch.cuda.synchronize()
    assert dets.dtype == torch.float32 and int(counts.sum()) > 0
    assert torch.equal(counts, rcounts) and torch.equal(dets, rdets)


def test_rank_decode_nms_plan_matches_the_kernel(card):
    """`rank_decode_nms_plan`'s shared memory is the kernel's own
    (`fastdet_rank_decode_nms_smem`)."""
    lib = pp_fused._build.load("pp_fused", pp_fused._SIGNATURES)
    for k in (1, 63, 64, 65, 128, 129, 256, 383, 384):
        plan = pp_fused.rank_decode_nms_plan(128, k)
        assert lib.fastdet_rank_decode_nms_smem(k) == plan.smem_bytes, k


def test_rank_decode_nms_wrapper_checks_its_inputs(card):
    args = [torch.from_numpy(a).to(card)
            for a in make_inputs(0, 2, 128, "dense")] + [port_geo(str(card))]
    neg_k, combo_k, regs, geo = args
    for bad in ((neg_k.double(), combo_k, regs, geo),
                (neg_k, combo_k.long(), regs, geo),
                (neg_k, combo_k, regs[:, :-1], geo),
                (neg_k, combo_k, regs, geo.cpu()),
                (neg_k[:, ::2], combo_k[:, ::2], regs, geo)):
        with pytest.raises(ValueError, match="rank_decode_nms"):
            pp_fused.rank_decode_nms(*bad, nc=NC, iou_thres=IOU)
    wide = [torch.zeros((1, pp_fused.MAX_K + 1), dtype=t.dtype, device=card)
            for t in (neg_k, combo_k)]
    with pytest.raises(ValueError, match="rank_decode_nms"):
        pp_fused.rank_decode_nms(*wide, regs[:1], geo, nc=NC, iou_thres=IOU)


def test_wide_window_goes_through_nms_keep(card):
    """k > MAX_K on the card takes the staged path: one nms_keep launch, no
    rank_decode_nms, and the plain staged chain's output bit for bit."""
    outs = [torch.from_numpy(o).to(card) for o in head_outputs(11, b=4)]
    for max_nms in (385, 1024, 2048):
        kw = dict(conf_thres=0.01, iou_thres=0.4, max_nms=max_nms)
        before = (nms_kernel.keep_mask_batch.launches,
                  pp_fused.rank_decode_nms.launches)
        dets, counts = postprocess(outs, ANCHORS, (352, 352), **kw)
        assert (nms_kernel.keep_mask_batch.launches,
                pp_fused.rank_decode_nms.launches) == (before[0] + 1,
                                                       before[1])
        want, n = staged_reference(outs, ANCHORS, (352, 352), **kw)
        torch.cuda.synchronize()
        assert torch.equal(counts, n) and int(counts.min()) > 0
        assert torch.equal(dets, want)


# ------------------------------------------------ the staged NMS (B4, B5)

@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("k", [64, 65, 129, 385, 512, 1024, 1815, 2048])
def test_nms_keep_matches_plain(card, b, k):
    """Bitwise: the kernel's IoU is the plain version's op for op; both
    variants of `nms_keep_plan`, the plan's first."""
    boxes, score, cls, valid = (torch.from_numpy(a).to(card)
                                for a in crowded(k + b, b, k))
    before = nms_kernel.keep_mask_batch.launches
    keep = nms_kernel.keep_mask_batch(boxes, cls, valid, iou_thres=0.4)
    assert nms_kernel.keep_mask_batch.launches == before + 1
    want = nms_kernel.keep_mask_batch_reference(boxes, cls, valid,
                                                iou_thres=0.4)
    torch.cuda.synchronize()
    assert torch.equal(keep, want)
    assert 0 < int(keep.sum()) < int(valid.sum())
    for variant in nms_kernel.NMS_VARIANTS:
        other = _nms_keep_variant(variant, boxes, cls, valid)
        torch.cuda.synchronize()
        assert torch.equal(other, want), variant
    det, n = nms_kernel.suppress_ranked_batch(boxes, score, cls, valid,
                                              iou_thres=0.4, max_det=300)
    wdet, wn = nms.suppress_ranked(boxes, score, cls, valid, iou_thres=0.4,
                                   max_det=300)
    assert torch.equal(n, wn) and torch.equal(det, wdet)


def _nms_keep_variant(variant, boxes, cls, valid):
    """The kernel launched as the named variant's plan."""
    b, k = valid.shape
    return nms_kernel._launch(boxes, cls, valid, 0.4,
                              nms_kernel._variant_plan(variant, b, k))


def _nms_keep_both_variants(boxes, cls, valid):
    want = nms_kernel.keep_mask_batch_reference(boxes, cls, valid,
                                                iou_thres=0.4)
    for variant in nms_kernel.NMS_VARIANTS:
        keep = _nms_keep_variant(variant, boxes, cls, valid)
        torch.cuda.synchronize()
        assert torch.equal(keep, want), variant
    return want


@pytest.mark.parametrize("b", [3, 128])
def test_nms_keep_images_with_no_one_and_all_valid(card, b):
    """Images with no valid candidate, with one, with all valid (k = 129,
    int32 classes), beside crowded ones."""
    boxes, _, cls, valid = crowded(7, b, 129)
    valid[b // 2:b // 2 + 4] = False
    valid[0] = False
    valid[1] = False
    valid[1, 40] = True
    valid[2] = True
    want = _nms_keep_both_variants(*(torch.from_numpy(a).to(card) for a in
                                     (boxes, cls.astype(np.int32), valid)))
    assert not want[0].any() and want[1].tolist() == valid[1].tolist()
    assert 0 < int(want[2].sum()) < 129


def test_nms_keep_all_valid_past_the_on_chip_cap(card):
    """b128 k = 2048, every candidate valid: n_v = 2048 is past the cta
    variant's rows on chip (`nv_cap`), so its CTAs work in the
    workspace."""
    boxes, _, cls, valid = crowded(12, 128, 2048)
    valid[:] = True
    assert nms_kernel.nms_keep_plan(128, 2048).nv_cap < 2048
    want = _nms_keep_both_variants(*(torch.from_numpy(a).to(card)
                                     for a in (boxes, cls, valid)))
    assert 0 < int(want.sum()) < want.numel()


@pytest.mark.parametrize("k,conf", [(512, 0.01), (1024, 0.3), (1815, 0.01),
                                    (2048, 0.01)])
def test_nms_keep_prefix_valid_windows(card, k, conf):
    """The main path's windows: validity (score > 0 on ranked scores) is
    a prefix of each image's window."""
    outs = [torch.from_numpy(o).to(card) for o in head_outputs(21, b=8)]
    boxes, score, cls = staged_window(outs, ANCHORS, (352, 352),
                                      conf_thres=conf, max_nms=k)
    valid = score > 0
    assert bool(((~valid).cumsum(1) > 0).eq(~valid).all())
    assert bool(valid[:, 0].all())
    want = _nms_keep_both_variants(boxes, cls, valid)
    assert 0 < int(want.sum()) < int(valid.sum())


def test_nms_keep_plan_matches_the_kernel(card):
    """`nms_keep_plan`'s shared memory and workspace are the kernel's own
    (`fastdet_nms_keep_smem`, `fastdet_nms_keep_workspace`)."""
    lib = nms_kernel._build.load("nms_keep", nms_kernel._SIGNATURES)
    for b in (1, 8, 32, 128):
        for k in (64, 65, 129, 385, 512, 1024, 1664, 1665, 1815, 2048):
            for variant in nms_kernel.NMS_VARIANTS:
                plan = nms_kernel._variant_plan(variant, b, k)
                v = nms_kernel.NMS_VARIANTS.index(variant)
                assert lib.fastdet_nms_keep_smem(v, k) == plan.smem_bytes
                assert (lib.fastdet_nms_keep_workspace(v, b, k)
                        == plan.workspace_bytes), (b, k, variant)


def test_nms_keep_wrapper_checks_its_inputs(card):
    boxes, _, cls, valid = (torch.from_numpy(a).to(card)
                            for a in crowded(0, 2, 100))
    nms_kernel.keep_mask_batch(boxes, cls.int(), valid, iou_thres=0.4)
    for bad in ((boxes.double(), cls, valid), (boxes[..., :3], cls, valid),
                (boxes, cls.float(), valid), (boxes, cls, valid.byte()),
                (boxes, cls, valid.cpu()), (boxes[:, :50], cls, valid)):
        with pytest.raises(ValueError, match="keep_mask_batch"):
            nms_kernel.keep_mask_batch(*bad, iou_thres=0.4)
    empty = nms_kernel.keep_mask_batch(boxes[:, :0], cls[:, :0],
                                       valid[:, :0], iou_thres=0.4)
    assert tuple(empty.shape) == (2, 0)


def test_device_pipeline_card_matches_cpu(card):
    """The whole pipeline on the card (cuDNN f32 + the kernel) against the
    same pipeline on the CPU, at conf 0.01 on seeded images."""
    cfg = Config.from_file("data/coco.data")
    with torch.random.fork_rng():
        torch.manual_seed(0)
        sd = Detector().state_dict()       # random init: many candidates
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (4, 352, 352, 3), dtype=np.uint8)
    on_card = DevicePipeline(Detector(), sd, cfg, conf_thres=0.01,
                             device=card)(imgs)
    on_cpu = DevicePipeline(Detector(), sd, cfg, conf_thres=0.01,
                            device="cpu")(imgs)
    for a, b in zip(on_card, on_cpu):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)


# ------------------------------------------------ stem and span (B1, B2)
#
# Held to 2e-4 against their plain versions on the card, the fused
# forward's f32 contract: the kernels sum in other orders than cuDNN, and
# contract to FMA.

ATOL = 2e-4
REF_NPZ = "weights/coco2017-ref.npz"


@pytest.fixture(scope="module")
def packed():
    """The fused forward's folded weights: the stem's on the host, each
    stage's span as one tensor on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode)")
    return fused_infer.build_fused_forward(load_state_dict(REF_NPZ))[1]


def _span_weights(packed, stage):
    reps = {sid: r for sid, r, _ in fold.STAGES}[stage]
    return packed[f"s{stage}_span"], reps - 1


@pytest.mark.parametrize("case", STEM_CASES,
                         ids=[f"b{b}-{h}x{w}" for b, h, w in STEM_CASES])
def test_stem_kernel_matches_plain(card, packed, case):
    """b1 and b128 352², 160×96 (960 lanes padded to 1024, junk in the
    pad), b32 640² (B6) and tiles cut off at the image's edge; one launch
    (`stem_plan`)."""
    b, hgt, wid = case
    h4, w4 = hgt // 4, wid // 4
    x = stem_case(b + hgt, b, hgt, wid, card)
    w, bias = packed["stem_w"], packed["stem_b"]
    before = fused_infer.stem_s2d.launches
    got = fused_infer.stem_s2d(x, w, bias, h4, w4)
    assert fused_infer.stem_s2d.launches == before + fused_infer.stem_plan(
        b, h4, w4, 4).launches == before + 1
    want = fused_infer.stem_s2d_reference(x, w, bias, h4, w4)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (b, 24, h4, w4)
    assert float((got - want).abs().max()) <= ATOL


def test_stem_plan_matches_the_kernels(card):
    """The plan's shared memory is the stem kernel's own
    (`stem_smem_bytes` in csrc/stem_core.cuh, through `fastdet_stem_smem`
    of the factor's library) at every shape the card tests run, and an SM
    holds the CTAs the plan's persistent grid counts on."""
    from fastdet_torch.kernels import _build
    libs = {4: _build.load("stem_s2d", fused_infer._STEM_SIGNATURES),
            8: _build.load("stem_s2d8", fused_infer._STEM8_SIGNATURES)}
    shapes = ([(b, h // 4, w // 4, 4) for b, h, w in STEM_CASES]
              + [(b, h // 4, w // 4, 8) for b, h, w in STEM8_CASES])
    for b, h4, w4, factor in shapes:
        plan = fused_infer.stem_plan(b, h4, w4, factor)
        assert libs[factor].fastdet_stem_smem(plan.rows, plan.strips) == \
            plan.smem_bytes, (b, h4, w4, factor)
        assert libs[factor].fastdet_stem_ctas_per_sm(
            plan.rows, plan.strips) >= fused_infer.STEM_CTAS_PER_SM


@pytest.mark.parametrize("factor", [4, 8])
@pytest.mark.parametrize("offset", [1, 2])
def test_stems_take_unaligned_views(card, packed, factor, offset):
    """A contiguous uint8 view that starts off a 4-byte boundary (the
    kernel copies 4-byte plane words): the plain version's map, one
    launch."""
    w, bias = packed["stem_w"], packed["stem_b"]
    case = stem_case if factor == 4 else stem8_case
    fn, ref = ((fused_infer.stem_s2d, fused_infer.stem_s2d_reference)
               if factor == 4 else
               (fused_infer.stem_s2d8, fused_infer.stem_s2d8_reference))
    x = case(offset, 2, 160, 96, card)
    view = torch.empty(x.numel() + offset, dtype=torch.uint8,
                       device=card)[offset:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 4
    hk, wk = 160 // factor, 96 // factor
    before = fn.launches
    got = fn(view, w, bias, hk, wk)
    assert fn.launches == before + 1
    want = ref(x, w, bias, hk, wk)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize("case", SPAN_CASES,
                         ids=[f"b{b}-s{s}-{h}x{w}"
                              for b, s, h, w in SPAN_CASES])
def test_span_kernel_matches_plain(card, packed, case):
    """Every shape class of the fused forward at 352², 160×96 and 640²:
    the stage kernel in one launch (a cluster per image) or, at 640²
    stage 2, one launch per block; launches as `span_stage_plan` says."""
    b, stage, *hw = case
    weights, nblk = _span_weights(packed, stage)
    c = {sid: ch for sid, _, ch in fold.STAGES}[stage]
    rng = np.random.default_rng(stage)
    x = torch.from_numpy(np.abs(rng.normal(
        0.0, 1.0, (b, c, *hw))).astype(np.float32)).to(card)
    before = fused_infer.span.launches
    got = fused_infer.span(x, weights, nblk)
    assert fused_infer.span.launches == before + fused_infer.span_stage_plan(
        b, c, *hw, nblk).launches
    want = fused_infer.span_reference(x, weights, nblk)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= ATOL


def test_stem_and_span_wrappers_check_their_inputs(card, packed):
    w, bias = packed["stem_w"], packed["stem_b"]
    x = torch.zeros(2, 48, 1024, dtype=torch.uint8, device=card)
    fused_infer.stem_s2d(x, w, bias, 40, 24)
    with pytest.raises(ValueError, match="uint8"):
        fused_infer.stem_s2d(x.float(), w, bias, 40, 24)
    with pytest.raises(ValueError, match="uint8"):
        fused_infer.stem_s2d(x[:, :, :960], w, bias, 40, 24)
    with pytest.raises(ValueError, match="CPU"):
        fused_infer.stem_s2d(x, w.to(card), bias, 40, 24)
    weights, nblk = _span_weights(packed, 2)
    a = torch.zeros(2, 48, 20, 12, device=card)
    fused_infer.span(a, weights, nblk)
    with pytest.raises(ValueError, match="C in"):
        fused_infer.span(a.double(), weights, nblk)
    with pytest.raises(ValueError, match="C in"):
        fused_infer.span(torch.zeros(2, 64, 20, 12, device=card), weights,
                         nblk)
    with pytest.raises(ValueError, match="weights"):
        fused_infer.span(a, weights.cpu(), nblk)
    with pytest.raises(ValueError, match="weights"):
        fused_infer.span(a, weights, nblk + 1)


# ------------------------------------ the flag paths' kernels (B10, B9)

@pytest.mark.parametrize("case", STEM8_CASES,
                         ids=[f"b{b}-{h}x{w}" for b, h, w in STEM8_CASES])
def test_stem_s2d8_kernel_matches_plain(card, packed, case):
    b, hgt, wid = case
    h8, w8 = hgt // 8, wid // 8
    x = stem8_case(b + hgt, b, hgt, wid, card)
    w, bias = packed["stem_w"], packed["stem_b"]
    before = fused_infer.stem_s2d8.launches
    got = fused_infer.stem_s2d8(x, w, bias, h8, w8)
    assert fused_infer.stem_s2d8.launches == before + 1
    want = fused_infer.stem_s2d8_reference(x, w, bias, h8, w8)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (b, 24, 2 * h8, 2 * w8)
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize("case", S2SPAN_CASES,
                         ids=[f"b{b}-s{s}-{h}x{w}"
                              for b, s, h, w in S2SPAN_CASES])
def test_s2span_kernel_matches_plain(card, packed, case):
    b, stage, hin, win = case
    _, nblk = _span_weights(packed, stage)
    cin = {sid: ch for sid, _, ch in fold.STAGES}[stage] // 2
    x = s2span_case(stage * 1000 + hin, b, cin, hin, win, card)
    weights = packed[f"s{stage}_s2span"]
    h, w = (hin + 1) // 2, (win + 1) // 2
    before = fused_infer.s2span.launches
    got = fused_infer.s2span(x, weights, nblk)
    assert fused_infer.s2span.launches == before + fused_infer.span_stage_plan(
        b, 2 * cin, h, w, nblk, True).launches
    want = fused_infer.s2span_reference(x, weights, nblk)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (b, 2 * cin, h, w)
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize("case", [(128, 2, 88, 88), (2, 3, 30, 26),
                                  (2, 4, 40, 40)],
                         ids=["b128-s2-88x88", "b2-s3-30x26", "b2-s4-40x40"])
def test_s2span_kernel_without_span_blocks(card, packed, case):
    """nblk = 0: the stride-2 block alone (one launch of the stage kernel
    with no span blocks, in both of the plan's variants)."""
    b, stage, hin, win = case
    cin = {sid: ch for sid, _, ch in fold.STAGES}[stage] // 2
    x = s2span_case(stage * 1000 + hin, b, cin, hin, win, card)
    weights = packed[f"s{stage}_s2span"][:fused_infer.s2span_floats(cin, 0)]
    before = fused_infer.s2span.launches
    got = fused_infer.s2span(x, weights, 0)
    assert fused_infer.s2span.launches == before + 1
    want = fused_infer.s2span_reference(x, weights, 0)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= ATOL


def test_span_stage_plan_matches_the_kernels(card):
    """The plan's shared memory is the stage kernel's own (`stage_layout`
    in csrc/span_block.cuh, through `fastdet_span_stage_smem` of both
    libraries) at every shape the card tests run."""
    from fastdet_torch.kernels import _build
    libs = (_build.load("span", fused_infer._SPAN_SIGNATURES),
            _build.load("s2span", fused_infer._S2SPAN_SIGNATURES))
    chans = {sid: ch for sid, _, ch in fold.STAGES}
    shapes = ([(b, chans[s], h, w, False) for b, s, h, w in SPAN_CASES]
              + [(b, chans[s], (hin + 1) // 2, (win + 1) // 2, True)
                 for b, s, hin, win in S2SPAN_CASES])
    for b, c, h, w, s2 in shapes:
        nblk = {ch: reps - 1 for _, reps, ch in fold.STAGES}[c]
        plan = fused_infer.span_stage_plan(b, c, h, w, nblk, s2)
        for lib in libs:
            got = max(lib.fastdet_span_stage_smem(c // 2, rows, w, halo,
                                                  int(t))
                      for rows, halo, t in plan.layouts)
            assert got == plan.smem_bytes, (b, c, h, w, s2)


def test_stem_s2d8_and_s2span_wrappers_check_their_inputs(card, packed):
    w, bias = packed["stem_w"], packed["stem_b"]
    x = torch.zeros(2, 192, 256, dtype=torch.uint8, device=card)
    fused_infer.stem_s2d8(x, w, bias, 20, 12)
    with pytest.raises(ValueError, match="uint8"):
        fused_infer.stem_s2d8(x.float(), w, bias, 20, 12)
    with pytest.raises(ValueError, match="uint8"):
        fused_infer.stem_s2d8(x[:, :96], w, bias, 20, 12)
    with pytest.raises(ValueError, match="CPU"):
        fused_infer.stem_s2d8(x, w.to(card), bias, 20, 12)
    weights, nblk = packed["s2_s2span"], 3
    a = torch.zeros(2, 24, 40, 24, device=card)
    fused_infer.s2span(a, weights, nblk)
    with pytest.raises(ValueError, match="cin in"):
        fused_infer.s2span(a.double(), weights, nblk)
    with pytest.raises(ValueError, match="cin in"):
        fused_infer.s2span(torch.zeros(2, 32, 40, 24, device=card), weights,
                           nblk)
    with pytest.raises(ValueError, match="weights"):
        fused_infer.s2span(a, weights.cpu(), nblk)
    with pytest.raises(ValueError, match="weights"):
        fused_infer.s2span(a, weights, nblk + 1)
    with pytest.raises(ValueError, match="weights"):
        fused_infer.s2span(a, packed["s3_s2span"], nblk)


def test_fused_pipeline_card_matches_device_pipeline(card):
    """Both pipelines on the card, on seeded images, at the serving
    operating point.  (At a low threshold two candidates of random images
    can score within the forwards' 1e-5 difference and swap ranks;
    chip_smoke.py holds the pipelines on real photos.)"""
    cfg = Config.from_file("data/coco.data")
    sd = load_state_dict(REF_NPZ)
    imgs = np.random.default_rng(5).integers(0, 256, (4, 352, 352, 3),
                                             dtype=np.uint8)
    fused = FusedPipeline(sd, cfg, dtype=torch.float32, device=card)(imgs)
    device = DevicePipeline(Detector(), sd, cfg, device=card)(imgs)
    for a, b in zip(fused, device):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a[:, 5], b[:, 5])
        np.testing.assert_allclose(a[:, 4], b[:, 4], rtol=0, atol=1e-4)
        np.testing.assert_allclose(a[:, :4], b[:, :4], rtol=0, atol=1e-2)


@pytest.mark.parametrize("case", SPAN_TRAIN_FULL + SPAN_TRAIN_B1
                         + SPAN_TRAIN_SMALL + SPAN_TRAIN_EDGE
                         + SPAN_TRAIN_CONV)
def test_span_train_kernels_match_plain(card, case):
    """B8 forward against its plain version (out, saved inputs, stats
    within 2e-4 of each one's scale), then the backward kernel and the
    plain backward on the same dy, xsave and stats: every gradient leaf
    within 1e-4·max|ref| + 1e-4 (β2, zero in exact arithmetic: see
    `span_train_grad_errs`)."""
    b, c, h, w, nblk, g = case
    x, rows, dy = span_train_case(sum(case), b, c, h, w, nblk, card)
    before = (fused_train.span_train_forward.launches,
              fused_train.span_train_backward.launches)
    out, xsave, stats = fused_train.span_train_forward(x, rows, g)
    ref = fused_train.span_train_forward_reference(x, rows, g)
    torch.cuda.synchronize()
    pairs = [(out, ref[0]), (xsave, ref[1])] + [
        (stats[:, :, :, j], ref[2][:, :, :, j]) for j in range(3)]
    for got, want in pairs:              # μ, σinv and var one at a time
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 2e-4 * scale
    dx, drows = fused_train.span_train_backward(dy, xsave, stats, rows, g)
    rdx, rdrows = fused_train.span_train_backward_reference(dy, xsave,
                                                            stats, rows, g)
    torch.cuda.synchronize()
    assert (fused_train.span_train_forward.launches,
            fused_train.span_train_backward.launches) == (before[0] + 1,
                                                          before[1] + 1)
    for leaf, err, bound in span_train_grad_errs(dx, drows, rdx, rdrows):
        assert err <= bound, (leaf, err, bound)
    # fixed-order sums: a second run gives the same bits
    dx2, drows2 = fused_train.span_train_backward(dy, xsave, stats, rows, g)
    assert torch.equal(dx, dx2) and torch.equal(drows, drows2)


def test_span_train_plan_matches_the_kernels(card):
    """The plan's shared memory is the kernels' own (`Smem<MID>` in
    csrc/span_train.cu) at every shape the card tests run."""
    from fastdet_torch.kernels import _build
    lib = _build.load("span_train", fused_train._SIGNATURES)
    for b, c, h, w, nblk, g in (SPAN_TRAIN_FULL + SPAN_TRAIN_B1
                                + SPAN_TRAIN_SMALL + SPAN_TRAIN_EDGE
                                + SPAN_TRAIN_CONV):
        plan = fused_train.span_train_plan(b, c, h, w, nblk, g)
        for bwd, tile in ((0, plan.tile_fwd), (1, plan.tile_bwd)):
            assert lib.fastdet_span_train_smem(c, h, w, *tile, bwd) == \
                plan.smem_of(bwd), (b, c, h, w, bwd)


def test_span_train_wrappers_check_their_inputs(card):
    x, rows, dy = span_train_case(0, 4, 48, 6, 7, 2, card)
    out, xsave, stats = fused_train.span_train_forward(x, rows, 2)
    with pytest.raises(ValueError, match="C in"):
        fused_train.span_train_forward(x.double(), rows, 2)
    with pytest.raises(ValueError, match="C in"):
        fused_train.span_train_forward(x[:, :, :, ::2], rows, 2)
    with pytest.raises(ValueError, match="weights"):
        fused_train.span_train_forward(x, rows.cpu(), 2)
    with pytest.raises(ValueError, match="group"):
        fused_train.span_train_forward(x, rows, 3)
    with pytest.raises(ValueError, match="xsave|tensor"):
        fused_train.span_train_backward(dy, xsave[:1], stats, rows, 2)
    with pytest.raises(ValueError, match="tensor"):
        fused_train.span_train_backward(dy, xsave, stats.cpu(), rows, 2)


# ------------------------------------------------ the training stem (B7)

@pytest.mark.parametrize("case", STEM_TRAIN_CASES,
                         ids=["b128_352_g1", "b8_352_g4", "b2_160x96_g1",
                              "b4_96_ties", "b2_32x48_g1_edge",
                              "b4_36x52_g2_edge_ties", "b4_96_g2_ties_signed",
                              "b2_160x96_g1_signed", "b32_128_g1"])
def test_stem_train_kernels_match_plain(card, case):
    """B7 forward against its plain version (y within 2e-4 of its scale,
    the stats μ, σinv, var each within 2e-4 of its own; y and z bit for bit
    those of the plain conv, BN, ReLU and pool with the kernel's own
    stats), then the backward kernels and the plain backward on the same
    dy, x and stats: dW, dγ, dβ within 1e-4·max|ref| + 1e-4 each (the same
    recomputed conv outputs, masks and pool routing on both sides, the sums
    in another order); a second backward gives the same bits."""
    b, hgt, wid, g, tie, signed = case
    h4, w4 = hgt // 4, wid // 4
    x, w_raw, gamma, beta, dy = stem_train_case(sum(case), b, hgt, wid, tie,
                                                card, signed)
    w = (w_raw * (1.0 / 255.0)).contiguous()
    before = (stem_train.stem_train_forward.launches,
              stem_train.stem_train_backward.launches)
    y, stats, z = stem_train.stem_train_forward(x, w, gamma, beta, h4, w4,
                                                g)
    ry, rstats = stem_train.stem_train_forward_reference(x, w, gamma, beta,
                                                         h4, w4, g)
    torch.cuda.synchronize()
    assert y.shape == (b, 24, h4, w4) and stats.shape == (b // g, 24, 3)
    for got, want in [(y, ry)] + [(stats[..., k], rstats[..., k])
                                  for k in range(3)]:
        assert float((got - want).abs().max()) <= 2e-4 * float(
            want.abs().max())
    u = stem_train._conv(stem_train._image(x, h4, w4, w.dtype), w)
    bn, _ = stem_train._bn_parts(u, stats, gamma, beta, g)
    assert torch.equal(y, F.max_pool2d(torch.relu(bn), 3, 2, 1))
    assert torch.equal(z, stem_train.pooled_extreme(u, gamma))
    grads = stem_train.stem_train_backward(dy, x, stats, w, gamma, beta,
                                           h4, w4, g, z)
    refs = stem_train.stem_train_backward_reference(dy, x, stats, w, gamma,
                                                    beta, h4, w4, g)
    torch.cuda.synchronize()
    assert (stem_train.stem_train_forward.launches,
            stem_train.stem_train_backward.launches) == (before[0] + 1,
                                                         before[1] + 1)
    for name, got, want in zip(("dW", "dgamma", "dbeta"), grads, refs):
        err, bound = grad_err(got, want)
        assert err <= bound, (name, err, bound)
    again = stem_train.stem_train_backward(dy, x, stats, w, gamma, beta, h4,
                                           w4, g, z)
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))
    if tie:
        assert pool_ties(x, w, stats, gamma, beta, h4, w4, g) > 0


def test_stem_train_wrappers_check_their_inputs(card):
    x, w_raw, gamma, beta, dy = stem_train_case(0, 4, 32, 48, device=card)
    w = (w_raw * (1.0 / 255.0)).contiguous()
    y, stats, z = stem_train.stem_train_forward(x, w, gamma, beta, 8, 12, 2)
    with pytest.raises(ValueError, match="w as"):
        stem_train.stem_train_forward(x, w.cpu(), gamma, beta, 8, 12, 2)
    with pytest.raises(ValueError, match="uint8"):
        stem_train.stem_train_forward(x.float(), w, gamma, beta, 8, 12, 2)
    with pytest.raises(ValueError, match="group"):
        stem_train.stem_train_forward(x, w, gamma, beta, 8, 12, 3)
    with pytest.raises(ValueError, match="uint8"):
        stem_train.stem_train_forward(x[:, :, :96].contiguous(), w, gamma,
                                      beta, 8, 12, 2)
    with pytest.raises(ValueError, match="stats"):
        stem_train.stem_train_backward(dy, x, stats.cpu(), w, gamma, beta, 8,
                                       12, 2, z)
    with pytest.raises(ValueError, match="dy"):
        stem_train.stem_train_backward(dy[:2], x, stats, w, gamma, beta, 8,
                                       12, 2, z)
    with pytest.raises(ValueError, match="z as"):
        stem_train.stem_train_backward(dy, x, stats, w, gamma, beta, 8, 12,
                                       2, z[:2])


# ------------------------------------------------ the anchor-free family

AF_NPZ = "weights/anchorfree-synth.npz"


@pytest.mark.parametrize("input_format,fuse_s2", [
    ("s2d_u8", False), ("s2d_u8", True), ("s2d8_u8", False), ("nhwc", True)])
def test_anchorfree_fused_forward_matches_the_model(card, input_format,
                                                    fuse_s2):
    """The anchor-free fused forward on the card (stem and span kernels)
    against `AnchorFreeDetector` on the card, 80 classes from a seeded
    generator, b4 352², ≤ 2e-4; the stem and stage kernels launch."""
    model = seeded_init(AnchorFreeDetector(80),
                        torch.Generator().manual_seed(8))
    imgs = np.random.default_rng(9).integers(0, 256, (4, 352, 352, 3),
                                             dtype=np.uint8)
    x = {"s2d_u8": fused_infer.pack_images_s2d,
         "s2d8_u8": fused_infer.pack_images_s2d8,
         "nhwc": lambda a: a}[input_format](imgs)
    fwd, p = fused_infer.build_fused_forward(
        model.state_dict(), input_format=input_format, fuse_s2=fuse_s2,
        head="anchorfree", device=card)
    kernels = (fused_infer.stem_s2d, fused_infer.stem_s2d8,
               fused_infer.span, fused_infer.s2span)
    before = [k.launches for k in kernels]
    with torch.inference_mode():
        got = fwd(torch.from_numpy(x).to(card), p)
        want = model.to(card).eval()(
            torch.from_numpy(imgs).to(card).float() / 255.0)
    torch.cuda.synchronize()
    launched = [k.launches - b for k, b in zip(kernels, before)]
    assert sum(launched[:2]) == (input_format != "nhwc")
    assert sum(launched[2:]) > 0
    assert [tuple(g.shape) for g in got] == [(4, 22, 22, c)
                                              for c in (1, 80, 4)]
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 2e-4


def test_anchorfree_golden_on_the_card(card):
    """The golden detections (tests/data/anchorfree_golden.json) through
    `FusedPipeline(family="anchorfree")` (B1, B2) and through the nn path
    on the card, by the file's rule."""
    with open(AF_GOLDEN) as f:
        golden = json.load(f)
    img = golden_image(golden)[0][None]
    size = golden["size"]
    cfg = Config.from_dict({"classes": 3, "width": size, "height": size,
                            "anchor_num": 3})
    sd = load_state_dict(golden["weights"])
    kw = dict(conf_thres=golden["conf_thres"], iou_thres=golden["iou_thres"],
              max_nms=golden["max_nms"])
    before = fused_infer.stem_s2d.launches, fused_infer.span.launches
    fused = FusedPipeline(sd, cfg, dtype=torch.float32, device=card,
                          family="anchorfree", **kw)(img)[0]
    h4 = size // 4
    plans = [fused_infer.span_stage_plan(1, c, h4 >> i, h4 >> i, reps - 1)
             for i, (_, reps, c) in enumerate(fold.STAGES, 1)]
    assert (fused_infer.stem_s2d.launches - before[0],
            fused_infer.span.launches - before[1]) == (
        fused_infer.stem_plan(1, h4, h4, 4).launches,
        sum(p.launches for p in plans))
    model = AnchorFreeDetector(3)
    model.load_state_dict(sd)
    dets, counts = build_anchorfree_detect_fn(
        model, (size, size), device=card, **kw)(
            torch.from_numpy(img).to(card))
    plain = dets[0, :int(counts[0])].cpu().numpy()
    for got in (fused, plain):
        assert golden_mismatches(got, golden) == []


# ------------------------------------------------- the bf16 kernels (A1)
#
# The bf16 stems against their plain versions: each element within one
# bf16 ULP, ≥ 99% equal (one rounding after f32 sums of other orders);
# the bf16 stages within 2⁻⁶ of the output's max |value| (they round
# after every block, and a flip moves what follows).

BF16_STAGE_RTOL = 2.0 ** -6


@pytest.fixture(scope="module")
def packed16():
    """The bf16 forward's weights: the stem's bf16 weight on the host, each
    stage's bf16 span and stride-2 block in fragment order on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode)")
    return fused_infer.build_fused_forward(load_state_dict(REF_NPZ),
                                           dtype=torch.bfloat16)[1]


def _bf16_ulps(got, want):
    """Largest |Δ| in bf16 ULPs of each element's magnitude, taken at no
    less than 2⁻¹⁰: below it the f32 sums' own rounding (~1e-7 where a sum
    cancels) is many bf16 ULPs."""
    g, w = got.float(), want.float()
    e = torch.floor(torch.log2(torch.maximum(g.abs(), w.abs()).clamp_min(
        2.0 ** -10)))
    return float(((g - w).abs() / torch.exp2(e - 7)).max())


@pytest.mark.parametrize("factor", [4, 8])
@pytest.mark.parametrize("case", [(1, 352, 352), (128, 352, 352),
                                  (2, 160, 96), (3, 72, 104)],
                         ids=lambda c: "b%d-%dx%d" % c)
def test_stem_bf16_kernels_match_plain(card, packed16, factor, case):
    bsz, ih, iw = case
    make, fn, ref = ((stem_case, fused_infer.stem_s2d_bf16,
                      fused_infer.stem_s2d_reference_bf16) if factor == 4
                     else (stem8_case, fused_infer.stem_s2d8_bf16,
                           fused_infer.stem_s2d8_reference_bf16))
    x = make(bsz + ih, bsz, ih, iw, str(card))
    args = (packed16["stem_w"], packed16["stem_b"], ih // factor,
            iw // factor)
    before = fn.launches
    got = fn(x, *args)
    assert fn.launches == before + 1
    want = ref(x, *args)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _bf16_ulps(got, want) <= 1
    assert float((got == want).float().mean()) >= 0.99


@pytest.mark.parametrize("case", [(128, 2, 44, 44), (128, 3, 22, 22),
                                  (128, 4, 11, 11), (1, 2, 80, 80),
                                  (3, 4, 5, 3), (2, 2, 160, 160)],
                         ids=lambda c: "b%d-s%d-%dx%d" % c)
def test_span_bf16_kernel_matches_plain(card, packed16, case):
    """The stage variant at every width, and at 160² (1280² input) the
    per-block one, which no cluster of 8 holds."""
    bsz, stage, h, w = case
    reps, c = {s: (r, ch) for s, r, ch in fold.STAGES}[stage]
    x = s2span_case(stage + h, bsz, c, h, w, str(card)).to(torch.bfloat16)
    wts, bias = packed16[f"s{stage}_span16"], packed16[f"s{stage}_span16_b"]
    plan = fused_infer.span16_plan(bsz, c, h, w, reps - 1)
    assert plan.variant == ("per_block" if h > 80 else "stage")
    before = fused_infer.span_bf16.launches
    got = fused_infer.span_bf16(x, wts, bias, reps - 1)
    assert fused_infer.span_bf16.launches == before + plan.launches
    want = fused_infer.span_reference_bf16(x, wts, bias, reps - 1)
    err = float((got.float() - want.float()).abs().max())
    assert err <= BF16_STAGE_RTOL * float(want.float().abs().max())


@pytest.mark.parametrize("case", [(128, 2, 88, 88), (128, 4, 22, 22),
                                  (2, 3, 30, 26), (3, 4, 9, 13),
                                  (2, 2, 320, 320)],
                         ids=lambda c: "b%d-s%d-%dx%d" % c)
@pytest.mark.parametrize("span_blocks", [False, True])
def test_s2span_bf16_kernel_matches_plain(card, packed16, case, span_blocks):
    """The stage variant, and at 320² input the per-block one."""
    bsz, stage, hin, win = case
    reps, c = {s: (r, ch) for s, r, ch in fold.STAGES}[stage]
    nblk = reps - 1 if span_blocks else 0
    x = s2span_case(stage * 3 + hin, bsz, c // 2, hin, win,
                    str(card)).to(torch.bfloat16)
    args = (packed16[f"s{stage}_s2_16"], packed16[f"s{stage}_s2_16_b"],
            packed16[f"s{stage}_span16"][:nblk],
            packed16[f"s{stage}_span16_b"][:nblk])
    plan = fused_infer.span16_plan(bsz, c, (hin + 1) // 2, (win + 1) // 2,
                                   nblk, True, win)
    assert plan.variant == ("per_block" if hin > 160 else "stage")
    before = fused_infer.s2span_bf16.launches
    got = fused_infer.s2span_bf16(x, *args, nblk)
    assert fused_infer.s2span_bf16.launches == before + plan.launches
    want = fused_infer.s2span_reference_bf16(x, *args, nblk)
    err = float((got.float() - want.float()).abs().max())
    assert err <= BF16_STAGE_RTOL * float(want.float().abs().max())


def test_span16_plan_smem_matches_the_kernels(card):
    """`span16_plan`'s shared memory, launch by launch, is the kernel's
    (`fastdet_span16_smem`, from `span16_layout`) at every span and stage
    case, the per-block variant's too."""
    from fastdet_torch.kernels import _build
    lib = _build.load("span", fused_infer._SPAN_SIGNATURES)
    chans = {s: ch for s, _, ch in fold.STAGES}
    cases = ([(bsz, chans[stage], h, w, 0) for bsz, stage, h, w in SPAN_CASES]
             + [(bsz, chans[stage], (hin + 1) // 2, (win + 1) // 2, win)
                for bsz, stage, hin, win in S2SPAN_CASES]
             + [(2, 48, 160, 160, 0), (2, 48, 160, 160, 320)])
    for bsz, c, h, w, win in cases:
        plan = fused_infer.span16_plan(bsz, c, h, w, 3, win > 0, win)
        got = [lib.fastdet_span16_smem(c // 2, rows, w, halo, int(s2), win,
                                       orows)
               for rows, halo, s2, orows in plan.layouts]
        assert max(got) == plan.smem_bytes <= fused_infer.SMEM_PER_CTA
        assert plan.launches == (1 if plan.variant == "stage"
                                 else 3 + (win > 0))


def test_bf16_wrappers_check_their_inputs(card, packed16):
    x = stem_case(0, 2, 160, 96, str(card))
    with pytest.raises(ValueError, match="kernel parameters"):
        fused_infer.stem_s2d_bf16(x, packed16["stem_w"].float(),
                                  packed16["stem_b"], 40, 24)
    xs = torch.zeros(2, 48, 10, 6, dtype=torch.float32, device=card)
    with pytest.raises(ValueError, match="bf16"):
        fused_infer.span_bf16(xs, packed16["s2_span16"],
                              packed16["s2_span16_b"], 3)
    with pytest.raises(ValueError, match="weights"):
        fused_infer.span_bf16(xs.to(torch.bfloat16),
                              packed16["s2_span16"].cpu(),
                              packed16["s2_span16_b"], 3)


@pytest.mark.parametrize("family", ["yolo-fastestv2", "anchorfree"])
def test_fused_pipeline_bf16_default_on_the_card(card, family):
    """FusedPipeline(dtype=None) serves bf16 through the bf16 kernels (one
    stem and 3 span launches a batch, one a stage) and holds the JAX
    package's bf16 serving contract against the f32 pipeline: the same
    count and classes, boxes within 4 px (or 2⁻⁵ of the box's larger
    side, the smoke's rule for large boxes), scores within 0.05.
    Yolo-FastestV2 on seeded noise at conf 0.05, the anchor-free family on
    its golden image with its trained 3-class weights (real detections)."""
    if family == "anchorfree":
        with open(AF_GOLDEN) as f:
            golden = json.load(f)
        imgs = golden_image(golden)[0][None]
        size = golden["size"]
        cfg = Config.from_dict({"classes": 3, "width": size, "height": size,
                                "anchor_num": 3})
        sd = load_state_dict(golden["weights"])
        kw = dict(conf_thres=golden["conf_thres"],
                  iou_thres=golden["iou_thres"], max_nms=golden["max_nms"])
    else:
        cfg = Config.from_file("data/coco.data")
        sd = load_state_dict(REF_NPZ)
        imgs = np.random.default_rng(5).integers(0, 256, (4, 352, 352, 3),
                                                 dtype=np.uint8)
        kw = dict(conf_thres=0.05)
    before = fused_infer.stem_s2d_bf16.launches, fused_infer.span_bf16.launches
    pipe = FusedPipeline(sd, cfg, device=card, family=family, **kw)
    assert pipe.dtype == torch.bfloat16
    got = pipe(imgs)
    h = cfg.height // 8
    spans = sum(fused_infer.span16_plan(len(imgs), c, h >> i, h >> i,
                                        r - 1).launches
                for i, (_, r, c) in enumerate(fold.STAGES))
    assert spans == 3
    assert fused_infer.stem_s2d_bf16.launches == before[0] + 1
    assert fused_infer.span_bf16.launches == before[1] + spans
    want = FusedPipeline(sd, cfg, dtype=torch.float32, device=card,
                         family=family, **kw)(imgs)
    if family == "anchorfree":
        assert sum(len(g) for g in got) > 0
    for d, j in zip(got, want):
        assert d.shape == j.shape
        free = list(range(len(j)))
        for row in d:
            tol = max(4.0, 2.0 ** -5 * max(row[2] - row[0], row[3] - row[1]))
            hit = [i for i in free if j[i, 5] == row[5]
                   and np.abs(j[i, :4] - row[:4]).max() <= tol
                   and abs(j[i, 4] - row[4]) <= 0.05]
            assert hit
            free.remove(hit[0])


# ------------------------------------------ bf16 training (B8, B7 in bf16)

def _rel16(got, want):
    w = want.float()
    return float((got.float() - w).abs().max() / w.abs().max())


@pytest.mark.parametrize("case,real",
                         [(c, False) for c in SPAN_TRAIN_FULL]
                         + [(SPAN_TRAIN_FULL[1], True)]
                         + [(c, False) for c in SPAN_TRAIN_SMALL[:1]
                            + SPAN_TRAIN_EDGE[:2] + SPAN_TRAIN_CONV],
                         ids=["stage2_b128", "stage3_b128", "stage4_b128",
                              "stage3_b128_real", "small_g2", "edge_g3",
                              "edge_g1", "stage2_b32_128", "stage3_b32_128",
                              "stage4_b32_128"])
def test_span_train_bf16_kernels_match_plain(card, case, real):
    """B8's bf16 form against its plain bf16 version (the smoke's phase 10
    bounds): out and the saved inputs within 2⁻⁶ of max |value|, the
    first block's stats within 5e-5 of each kind's largest; the backward on
    the same dy, saved inputs and stats: dx and each weight gradient within
    2⁻⁶ of its max |value| (β2, zero in exact arithmetic, of the block's
    largest BN-parameter gradient); the seeded stage-3 case, whose plain
    version stands ~5% of dγ1's max |value| from itself summed in another
    order (the kernel 5.3%), and the convergence check's three stages
    (`SPAN_TRAIN_CONV`), within twice that distance from its f64 sums
    where that is larger (`torch_cases.span16_backward_errs`); bf16 in and out,
    f32 stats and gradients; one counted launch each; a second backward
    gives the same bits.  `real`: the stage's real span weights, as the
    smoke times them."""
    b, c, h, w, nblk, g = case
    x, rows, dy = span_train_case(sum(case) + 1, b, c, h, w, nblk, card)
    x, dy = x.to(torch.bfloat16), dy.to(torch.bfloat16)
    if real:
        det = Detector(80, 3)
        det.load_state_dict(load_state_dict(REF_NPZ))
        stage, reps = {48: (2, 4), 96: (3, 8), 192: (4, 4)}[c]
        rows = fused_train.pack_span_train_weights(
            [getattr(det.backbone, f"stage{stage}_{i}")
             for i in range(1, reps)]).detach().to(card).contiguous()
    before = (fused_train.span_train_forward_bf16.launches,
              fused_train.span_train_backward_bf16.launches)
    out, xsave, stats = fused_train.span_train_forward_bf16(x, rows, g)
    ref = fused_train.span_train_forward_reference(x, rows, g)
    torch.cuda.synchronize()
    assert out.dtype == xsave.dtype == torch.bfloat16
    assert stats.dtype == torch.float32
    assert _rel16(out, ref[0]) <= 2 ** -6
    assert _rel16(xsave, ref[1]) <= 2 ** -6
    for j in range(3):
        assert _rel16(stats[0, :, :, j], ref[2][0, :, :, j]) <= 5e-5
    dx, drows = fused_train.span_train_backward_bf16(dy, xsave, stats, rows,
                                                     g)
    torch.cuda.synchronize()
    assert dx.dtype == torch.bfloat16 and drows.dtype == torch.float32
    assert (fused_train.span_train_forward_bf16.launches,
            fused_train.span_train_backward_bf16.launches) == (
                before[0] + 1, before[1] + 1)
    errs, _ = span16_backward_errs((dx, drows), dy, xsave, stats, rows, g,
                                   witness=(case == SPAN_TRAIN_FULL[1]
                                            and not real)
                                   or case in SPAN_TRAIN_CONV)
    off = {k: v for k, v in errs.items() if v[0] > v[1]}
    assert not off, off
    dx2, drows2 = fused_train.span_train_backward_bf16(dy, xsave, stats,
                                                       rows, g)
    assert torch.equal(dx, dx2) and torch.equal(drows, drows2)


def test_span_train_bf16_plan_matches_the_kernels(card):
    """The bf16 form's plan (`span16_train_plan`) is the kernels' own: its
    shared memory is `fastdet_span16_train_smem`'s, the card holds at
    least one of its clusters at once, the backward's scratch is the f32
    gradient and one partial row a CTA and block, and the backward's
    recomputed z equals the forward's bit for bit."""
    from fastdet_torch.kernels import _build
    lib = _build.load("span16_train", fused_train._SIGNATURES16)
    for b, c, h, w, nblk, g in SPAN_TRAIN_FULL + SPAN_TRAIN_EDGE \
            + SPAN_TRAIN_CONV:
        plan = fused_train.span16_train_plan(b, c, h, w, nblk, g)
        for bwd, want in ((0, plan.smem_fwd), (1, plan.smem_bwd)):
            assert lib.fastdet_span16_train_smem(
                c // 2, plan.rows, w, plan.ipc, plan.cluster, bwd) == want
            assert lib.fastdet_span16_train_clusters(
                b, c, h, w, nblk, g, *plan.args, bwd) >= 1
        assert lib.fastdet_span16_train_scratch(
            b, c, h, w, nblk, g, *plan.args) == (
                b * c * h * w + nblk * plan.part_rows
                * fused_train.row_len(c // 2))
    b, c, h, w, nblk, g = SPAN_TRAIN_EDGE[1]
    x, rows, dy = span_train_case(1, b, c, h, w, nblk, card)
    x16, dy16 = x.to(torch.bfloat16), dy.to(torch.bfloat16)
    out, xsave, stats = fused_train.span_train_forward_bf16(x16, rows, g)
    rec = torch.empty((nblk, b, c // 2, h, w), dtype=torch.bfloat16,
                      device=card)
    fused_train.span16_backward_launch(dy16, xsave, stats, rows, g, rec)
    nexts = [xsave[k + 1] for k in range(nblk - 1)] + [out]
    assert all(torch.equal(rec[k], nexts[k][:, c // 2:])
               for k in range(nblk))


def test_span_train_bf16_wrappers_check_their_inputs(card):
    x, rows, dy = span_train_case(0, 4, 48, 6, 7, 2, card)
    x16, dy16 = x.to(torch.bfloat16), dy.to(torch.bfloat16)
    out, xsave, stats = fused_train.span_train_forward_bf16(x16, rows, 2)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_train.span_train_forward_bf16(x, rows, 2)       # f32 x
    with pytest.raises(ValueError, match="float32"):
        fused_train.span_train_forward(x16, rows, 2)          # bf16 x
    with pytest.raises(ValueError, match="weights"):
        fused_train.span_train_forward_bf16(x16, rows.to(torch.bfloat16), 2)
    with pytest.raises(ValueError, match="group"):
        fused_train.span_train_forward_bf16(x16, rows, 3)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_train.span_train_backward_bf16(dy, xsave, stats, rows, 2)
    with pytest.raises(ValueError, match="tensor"):
        fused_train.span_train_backward_bf16(dy16, xsave.float(), stats,
                                             rows, 2)


@pytest.mark.parametrize("case", [STEM_TRAIN_CASES[i]
                                  for i in (0, 1, 3, 6, 8)],
                         ids=["b128_352_g1", "b8_352_g4", "b4_96_ties",
                              "b4_96_g2_ties_signed", "b32_128_g1"])
def test_stem_train_bf16_kernels_match_plain(card, case):
    """B7's bf16 form (`csrc/stem16_train.cu`) against its plain bf16
    version: y bf16 within one bf16 ULP and bit for bit the plain conv,
    rounded BN + ReLU and pool with the kernel's stats, the pool windows'
    winners (code, zw) bit for bit `stem16_winners_reference` of the plain
    conv, the stats within 5e-5; dW, dγ, dβ within 2⁻⁶ of max |value| on
    the same bf16 dy, x, stats and winners; one counted launch each; a
    second backward gives the same bits."""
    b, hgt, wid, g, tie, signed = case
    h4, w4 = hgt // 4, wid // 4
    x, w_raw, gamma, beta, dy = stem_train_case(sum(case) + 1, b, hgt, wid,
                                                tie, card, signed)
    w = (w_raw * (1.0 / 255.0)).contiguous()
    dy = dy.to(torch.bfloat16)
    before = (stem_train.stem_train_forward_bf16.launches,
              stem_train.stem_train_backward_bf16.launches)
    y, stats, zw, code = stem_train.stem_train_forward_bf16(x, w, gamma, beta,
                                                            h4, w4, g)
    ry, rstats = stem_train.stem_train_forward_reference(x, w, gamma, beta,
                                                         h4, w4, g, True)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and zw.dtype == stats.dtype == \
        torch.float32 and code.dtype == torch.uint8
    assert _bf16_ulps(y, ry) <= 1
    for k in range(3):
        assert _rel16(stats[..., k], rstats[..., k]) <= 5e-5
    u = stem_train._conv(stem_train._image(x, h4, w4, w.dtype),
                         stem_train._rounded(w, True))
    bn, _ = stem_train._bn_parts(u, stats, gamma, beta, g)
    assert torch.equal(y, F.max_pool2d(torch.relu(bn).to(torch.bfloat16), 3,
                                       2, 1))
    rcode, rzw = stem_train.stem16_winners_reference(u, stats, gamma, beta,
                                                     g)
    assert torch.equal(code, rcode) and torch.equal(zw, rzw)
    grads = stem_train.stem_train_backward_bf16(dy, x, stats, w, gamma,
                                                beta, h4, w4, g, zw, code)
    refs = stem_train.stem_train_backward_reference(dy, x, stats, w, gamma,
                                                    beta, h4, w4, g, True)
    torch.cuda.synchronize()
    assert (stem_train.stem_train_forward_bf16.launches,
            stem_train.stem_train_backward_bf16.launches) == (
                before[0] + 1, before[1] + 1)
    for name, got, want in zip(("dW", "dgamma", "dbeta"), grads, refs):
        assert _rel16(got, want) <= 2 ** -6, name
    again = stem_train.stem_train_backward_bf16(dy, x, stats, w, gamma, beta,
                                                h4, w4, g, zw, code)
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))


def test_stem_train_bf16_wrappers_check_their_inputs(card):
    x, w_raw, gamma, beta, dy = stem_train_case(0, 4, 32, 48, device=card)
    w = (w_raw * (1.0 / 255.0)).contiguous()
    y, stats, zw, code = stem_train.stem_train_forward_bf16(x, w, gamma, beta,
                                                            8, 12, 2)
    assert y.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="w as"):
        stem_train.stem_train_forward_bf16(x, w.to(torch.bfloat16), gamma,
                                           beta, 8, 12, 2)
    with pytest.raises(ValueError, match="group"):
        stem_train.stem_train_forward_bf16(x, w, gamma, beta, 8, 12, 3)
    with pytest.raises(ValueError, match="dy"):
        stem_train.stem_train_backward_bf16(dy, x, stats, w, gamma, beta, 8,
                                            12, 2, zw, code)  # f32 dy
    with pytest.raises(ValueError, match="dy"):
        stem_train.stem_train_backward(dy.to(torch.bfloat16), x, stats, w,
                                       gamma, beta, 8, 12, 2, zw)
    with pytest.raises(ValueError, match="zw as"):
        stem_train.stem_train_backward_bf16(dy.to(torch.bfloat16), x, stats,
                                            w, gamma, beta, 8, 12, 2, zw[:2],
                                            code)
    with pytest.raises(ValueError, match="code as"):
        stem_train.stem_train_backward_bf16(dy.to(torch.bfloat16), x, stats,
                                            w, gamma, beta, 8, 12, 2, zw,
                                            code.float())


def test_bf16_trainer_on_the_card_matches_its_plain_versions(card):
    """`Trainer(compute_dtype=bf16)` in the fused s2d mode at b4 96² on the
    card: the bf16 kernels launch (B7 once each way, B8 three times) and
    the step's loss is within 2⁻⁵ of the same step on the CPU, whose spans
    and stem run the plain bf16 versions."""
    cfg = Config.from_dict({"classes": 80, "width": 96, "height": 96,
                            "anchor_num": 3,
                            "anchors": [4.0, 6.0, 9.0, 12.0, 16.0, 24.0,
                                        24.0, 16.0, 32.0, 40.0, 52.0, 48.0],
                            "learning_rate": 0.01, "steps": [1000],
                            "subdivisions": 1, "batch_size": 4,
                            "epochs": 1})
    from fastdet_torch.train.trainer import Trainer
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (4, 96, 96, 3), dtype=np.uint8)
    labels = np.zeros((4, 4, 5), np.float32)
    labels[:, 0] = [3, 0.4, 0.5, 0.3, 0.4]
    mask = np.zeros((4, 4), bool)
    mask[:, 0] = True
    x = fused_infer.pack_images_s2d(images)
    losses = {}
    for dev in (card, torch.device("cpu")):
        model = Detector(80, 3, dtype=torch.bfloat16)
        model.load_state_dict(load_state_dict(REF_NPZ))
        tr = Trainer(model, cfg, 1, device=dev, fused_backbone=True,
                     fused_input_format="s2d_u8",
                     compute_dtype=torch.bfloat16)
        before = (stem_train.stem_train_forward_bf16.launches,
                  fused_train.span_train_backward_bf16.launches)
        losses[dev.type] = float(tr.step(x, labels, mask)["total"])
        if dev.type == "cuda":
            assert (stem_train.stem_train_forward_bf16.launches,
                    fused_train.span_train_backward_bf16.launches) == (
                        before[0] + 1, before[1] + 3)
    assert abs(losses["cuda"] - losses["cpu"]) <= 2 ** -5 * abs(
        losses["cpu"])


@pytest.mark.parametrize("b,hw", [(1, (96, 96)), (2, (64, 96))])
def test_int8_forward_macs_match_the_cpu(card, b, hw):
    """`weights/coco-int8.npz` through `forward_from` on the card with both
    MACs: every op's int8 input and accumulator, and the maps, bit for
    bit each other's and the CPU run's.  At b1 96² the stride-32 heads
    have 9 rows, which `torch._int_mm` gets padded past 16."""
    from fastdet_torch.quant import forward_from, load_quantized
    qw, scales = load_quantized("weights/coco-int8.npz")
    images = torch.from_numpy(np.random.default_rng(b).integers(
        0, 256, (b, *hw, 3), dtype=np.uint8))
    runs = {}
    for mac, dev in (("bf16", card), ("int32", card), ("bf16", "cpu")):
        rec = {}
        outs = forward_from(qw, scales, mac=mac, device=dev)(images,
                                                             record=rec)
        assert all(o.device.type == torch.device(dev).type for o in outs)
        runs[mac, str(dev)] = ([o.cpu() for o in outs], rec)
    (want, wrec), *others = runs.values()
    for outs, rec in others:
        assert all(torch.equal(a, b) for a, b in zip(outs, want))
        assert set(rec) == set(wrec)
        for name, calls in rec.items():
            for (xq, acc), (wxq, wacc) in zip(calls, wrec[name]):
                assert torch.equal(xq.cpu(), wxq.cpu()), name
                assert torch.equal(acc.cpu().double(), wacc.cpu().double()), \
                    name
