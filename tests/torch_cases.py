"""Shared seeded inputs of the port's postprocess and NMS tests, and the
plain staged chain (imports no JAX, so that the card tests and
chip_smoke.py can use it on a machine without JAX).

Box tolerances are |Δ| in units in the last place (ULPs) of the box's
largest |coordinate|:
  * BOX_ULPS_XLA, the port against the JAX package on the CPU: XLA's and
    PyTorch's f32 sigmoids differ by up to 2 ULPs (pinned by
    test_torch_postprocess.py::test_transcendentals_within_stated_ulps),
    and w, h square the sigmoid;
  * BOX_ULPS_CARD, the CUDA kernel against the plain version on the card:
    both compute 1/(1+expf(-x)) with the same rounding steps, so the boxes
    are expected bitwise; 2 ULPs leaves room for one expf ULP.
"""

import contextlib
import os

import numpy as np

# Thread pools of a test's subprocess: two threads for torch's OpenMP pool
# and XLA's Eigen pool.  The suite runs in parallel workers; a full-width
# pool in each subprocess oversubscribes the CPU, and the f64 training
# parity subprocesses then ran 15× their time alone (~45 s each with
# these limits or without them, alone).
FEW_THREADS = {"OMP_NUM_THREADS": "2",
               "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false "
                            "intra_op_parallelism_threads=2"}

from fastdet_torch.ops.postprocess import _geo_table


@contextlib.contextmanager
def few_torch_threads(n=2):
    """torch's intra-op pool at `n` threads inside the block (as
    FEW_THREADS sets a subprocess's): in-process tests of many small ops
    ran 50-100× their time alone among the suite's parallel workers with
    a pool as wide as the machine."""
    import torch
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)

NC = 80
META = ((22 * 22 * 3, 22, 22, 3, 16.0), (11 * 11 * 3, 11, 11, 3, 32.0))
N = 1815
ANCHORS = np.asarray([12.64, 19.39, 37.88, 51.48, 55.71, 138.31, 126.91,
                      78.23, 131.57, 214.55, 279.92, 258.87],
                     np.float32).reshape(2, 3, 2)
IOU = 0.45
BOX_ULPS_XLA = 8
BOX_ULPS_CARD = 2


def head_outputs(seed, b=2):
    """Raw NHWC logits shaped like the Detector's.  obj is biased so that
    a few hundred candidates per image pass conf 0.3, and classes 0-2
    dominate so that same-class boxes overlap and suppress."""
    rng = np.random.default_rng(seed)
    cls_bias = np.zeros(NC, np.float32)
    cls_bias[:3] = 6.0
    outs = []
    for h in (22, 11):
        outs += [rng.normal(0, 1.5, (b, h, h, 12)).astype(np.float32),
                 rng.normal(-1.0, 2.0, (b, h, h, 3)).astype(np.float32),
                 rng.normal(0, 3.0, (b, h, h, NC)).astype(np.float32)
                 + cls_bias]
    return outs


def make_inputs(seed, b, k, case):
    """Seeded top-k window as the serving postprocess builds it: a ranked
    score row sorted stably, combo = idx·nc + cls, raw reg logits.
    Three classes only (one in the sparse and clustered cases), so that
    same-class boxes overlap and suppress."""
    rng = np.random.default_rng(seed)
    score = rng.uniform(0.3, 1.0, (b, N)).astype(np.float32)
    if case == "dense":
        valid = rng.random((b, N)) < 0.9
    elif case == "sparse":                 # fewer valid than the window
        valid = rng.random((b, N)) < 0.05
    elif case == "tied":                   # every score equal
        score[:] = np.float32(0.5)
        valid = np.ones((b, N), bool)
    elif case == "clustered":              # large same-class boxes: long
        valid = rng.random((b, N)) < 0.9   # chains of suppression
    else:
        raise ValueError(case)
    ranked = np.where(valid, score, np.float32(-1.0))
    cls = rng.integers(0, 1 if case in ("sparse", "clustered") else 3,
                       (b, N))
    order = np.argsort(-ranked, axis=1, kind="stable")[:, :k]
    neg_k = -np.take_along_axis(ranked, order, 1)
    combo_k = (order * NC + np.take_along_axis(cls, order, 1)).astype(np.int32)
    regs = rng.normal(0.0, 1.5, (b, N, 4)).astype(np.float32)
    if case == "clustered":
        regs[..., 2:] = np.abs(regs[..., 2:])
    return neg_k.astype(np.float32), combo_k, regs


# n_v classes of the serving kernel's tests and smoke: both sides of its
# 64-candidate words, none, one and the whole k = 384 window
NV_CLASSES = (0, 1, 63, 64, 65, 127, 128, 129, 384)


def nv_window(nv, b, k=384):
    """`make_inputs`' tied window (every score equal, every candidate
    valid) cut to n_v = nv valid candidates an image: a prefix of the
    window in even images, a seeded scatter in odd ones."""
    neg_k, combo_k, regs = make_inputs(nv, b, k, "tied")
    rng = np.random.default_rng(nv)
    for m in range(b):
        drop = np.arange(nv, k) if m % 2 == 0 else rng.permutation(k)[nv:]
        neg_k[m, drop] = 1.0
    return neg_k, combo_k, regs


# (image, rank) → a combo out of range: negative, or idx = combo // nc ≥ N
OUT_OF_RANGE = {(0, 0): -1, (0, 5): -NC * 5, (0, 40): N * NC,
                (1, 3): N * NC + 7, (1, 64): 2 ** 31 - 1,
                (1, 127): -(2 ** 31)}


def out_of_range_window():
    """A dense b2 k128 window whose `OUT_OF_RANGE` ranks (all of them
    valid by their score) carry combos out of range, and the same window
    with those ranks made invalid and in range (score +1, combo 0) →
    (neg_k, combo_k, regs, clean_neg, clean_combo)."""
    neg_k, combo_k, regs = make_inputs(7, 2, 128, "dense")
    clean_neg, clean_combo = neg_k.copy(), combo_k.copy()
    for (m, i), c in OUT_OF_RANGE.items():
        assert neg_k[m, i] < 0
        combo_k[m, i] = c
        clean_neg[m, i], clean_combo[m, i] = 1.0, 0
    return neg_k, combo_k, regs, clean_neg, clean_combo


# the convergence check's eval window (fastdet_torch/tools/
# convergence_check.py): b32 128², 3 classes, its anchors, conf 0.05 and
# iou 0.45, k = min(1024, (8·8 + 4·4)·3) = 240, through rank_decode_nms
CONV_ANCHORS = np.asarray([20.0, 20.0, 36.0, 36.0, 52.0, 28.0,
                           28.0, 52.0, 56.0, 56.0, 80.0, 80.0],
                          np.float32).reshape(2, 3, 2)
CONV_NC = 3
CONV_K = 240


def conv_window(seed, b=32, device="cpu"):
    """Seeded raw head logits at 128² with 3 classes, ranked at conf 0.05
    as `postprocess` ranks them → (neg_k (b, 240), combo_k, reg_f, geo) on
    `device`, validity a prefix of each window."""
    import torch
    from fastdet_torch.ops.postprocess import (_geo_table, rank_scores,
                                               rank_topk)
    rng = np.random.default_rng(seed)
    outs = []
    for h in (8, 4):
        outs += [rng.normal(0, 1.5, (b, h, h, 12)),
                 rng.normal(-2.0, 2.0, (b, h, h, 3)),
                 rng.normal(0, 3.0, (b, h, h, CONV_NC))]
    outs = [torch.from_numpy(o.astype(np.float32)).to(device) for o in outs]
    ranked, reg_f, cls_f, meta = rank_scores(outs, (128, 128), 0.05)
    neg_k, combo_k = rank_topk(ranked, cls_f, nc=CONV_NC, k=CONV_K)
    geo = _geo_table(meta, tuple(CONV_ANCHORS.ravel().tolist()), str(device))
    return neg_k, combo_k, reg_f.contiguous(), geo


def box_ulps(a, b):
    """|a − b| in ULPs of each box's largest |coordinate|."""
    scale = np.maximum(np.abs(a), np.abs(b)).max(-1, keepdims=True)
    return np.abs(a.astype(np.float64) - b) / np.spacing(scale)


def port_geo(device="cpu"):
    return _geo_table(META, tuple(ANCHORS.ravel().tolist()), device)


def crowded(seed, b, k):
    """Seeded crowded field for the staged NMS (the field of
    tests/test_postprocess.py's tiled-kernel test): (boxes (B,k,4) f32
    xyxy within 145 px, score (B,k) f32 descending with −1 where invalid,
    cls (B,k) int64 in 0-2, valid (B,k) bool, ~10% False).  Each image's
    lowest-ranked valid candidate scores 0: validity, not the score,
    makes a candidate eligible."""
    rng = np.random.RandomState(seed)
    cxy = rng.rand(b, k, 2).astype(np.float32) * 120
    wh = rng.rand(b, k, 2).astype(np.float32) * 50 + 10
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
    score = np.sort(rng.rand(b, k).astype(np.float32))[:, ::-1].copy()
    cls = rng.randint(0, 3, (b, k)).astype(np.int64)
    valid = rng.rand(b, k) > 0.1
    score = np.where(valid, score, -1.0).astype(np.float32)
    last = k - 1 - np.argmax(valid[:, ::-1], axis=1)
    score[np.arange(b), last] = 0.0
    return boxes, score, cls, valid


def staged_window(outputs, anchors, input_hw, *, conf_thres, max_nms):
    """The staged postprocess up to its NMS, from its plain pieces
    (ranking, window, `decode_ranked`), on the outputs' device.
    → (boxes_k (B,k,4) xyxy, score_k (B,k), cls_k (B,k) int64)."""
    from fastdet_torch.ops.decode import decode_ranked
    from fastdet_torch.ops.postprocess import rank_scores, rank_topk
    ranked, reg_f, cls_f, meta = rank_scores(outputs, input_hw, conf_thres)
    nc = outputs[2].shape[-1]
    neg_k, combo_k = rank_topk(ranked, cls_f, nc=nc,
                               k=min(max_nms, ranked.shape[1]))
    geo = _geo_table(meta, tuple(np.asarray(anchors, np.float32).ravel()
                                 .tolist()), str(ranked.device))
    boxes_k, cls_k = decode_ranked(combo_k, reg_f, geo, nc=nc)
    return boxes_k, -neg_k, cls_k


def staged_reference(outputs, anchors, input_hw, *, conf_thres, iou_thres,
                     max_nms, max_det=300):
    """The staged postprocess composed from its plain pieces
    (`staged_window`, validity score > 0, `keep_mask_batch_reference`,
    `compact_ranked`), on the outputs' device: what `postprocess` computes
    for a window wider than `MAX_K`, with no kernel."""
    from fastdet_torch.kernels.nms_kernel import (compact_ranked,
                                                  keep_mask_batch_reference)
    boxes_k, score_k, cls_k = staged_window(
        outputs, anchors, input_hw, conf_thres=conf_thres, max_nms=max_nms)
    keep = keep_mask_batch_reference(boxes_k, cls_k, score_k > 0,
                                     iou_thres=iou_thres)
    return compact_ranked(keep, boxes_k, score_k, cls_k, max_det=max_det)


# ---------------------------------------------- the training span B8

# (b, c, h, w, nblk, group): the three stages at b128 352² with the
# JAX package's ghost groups, the same at b1, and small geometries with
# group < batch
SPAN_TRAIN_FULL = ((128, 48, 44, 44, 3, 2), (128, 96, 22, 22, 7, 4),
                   (128, 192, 11, 11, 3, 16))
SPAN_TRAIN_B1 = ((1, 48, 44, 44, 3, 1), (1, 96, 22, 22, 7, 1),
                 (1, 192, 11, 11, 3, 1))
SPAN_TRAIN_SMALL = ((4, 48, 6, 7, 2, 2), (4, 192, 3, 3, 3, 2),
                    (6, 96, 5, 4, 2, 3))
# the edges of the kernels' launch plan (`span_train_plan`): a group of 3
# images in 3 tiles, g = 1 at an odd batch, a stage-4-width group of 16
# whose images the backward cuts into tiles of 6 and 5 rows, the stage-2
# geometry at b8, backward tiles of 6 and 3 rows, and tiles of 64 and 6
# columns
SPAN_TRAIN_EDGE = ((3, 96, 9, 7, 2, 3), (5, 48, 13, 5, 3, 1),
                   (16, 192, 11, 11, 1, 16), (8, 48, 44, 44, 1, 2),
                   (2, 96, 9, 22, 2, 1), (2, 48, 5, 70, 2, 2))

# the three stages of the convergence check's step (b32 128²,
# fastdet_torch/tools/convergence_check.py) with the JAX package's ghost
# groups: 16 images a group at every stage (stage 4's 4×4 maps take 128
# lanes an image in the JAX kernel's layout, 112 of them pad)
SPAN_TRAIN_CONV = ((32, 48, 16, 16, 3, 16), (32, 96, 8, 8, 7, 16),
                   (32, 192, 4, 4, 3, 16))


def span_train_case(seed, b, c, h, w, nblk, device="cpu"):
    """Seeded span input (≥ 0, as a stride-2 block's ReLU outputs are),
    packed weights of the JAX package's test scale (w ~ 0.3·N, γ ~ 1 +
    0.1·N, β ~ 0.1·N) and an output gradient, f32 on `device`."""
    import torch
    mid = c // 2
    rng = np.random.default_rng(seed)
    x = np.abs(rng.normal(0.0, 1.0, (b, c, h, w)))
    ws = rng.normal(0.0, 0.3, (nblk, 2 * mid * mid + 9 * mid))
    gb = np.tile(np.array([1.0, 0.0] * 3), mid).reshape(mid, 6).T
    gb = gb[None] + 0.1 * rng.normal(size=(nblk, 6, mid))
    rows = np.concatenate([ws, gb.reshape(nblk, 6 * mid)], 1)
    dy = rng.normal(0.0, 1.0, (b, c, h, w))
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device)
                 for a in (x, rows, dy))


def grad_err(got, want, scale=None):
    """max |Δ| against the gradient bound 1e-4·scale + 1e-4, scale =
    max|ref| unless given → (err, bound)."""
    want = want.double()
    err = float((got.double() - want).abs().max())
    if scale is None:
        scale = float(want.abs().max())
    return err, 1e-4 * scale + 1e-4


def span_train_grad_errs(dx, drows, rdx, rdrows):
    """[(leaf, err, bound)] of a B8 backward against its plain version.
    β2's gradient is 0 in exact arithmetic (BN3's backward removes each
    group's mean of du3, and u3 is linear in v = BN2(u2)), so both sides
    hold only the rounding noise of a sum over every pixel (248k at b128
    stage 2); it is held to 1e-4 × the largest gradient of the block's
    BN parameters instead of its own."""
    from fastdet_torch.kernels.fused_train import row_sections
    mid = dx.shape[1] // 2
    out = [("dx",) + grad_err(dx, rdx)]
    secs = row_sections(mid)
    gb_lo = secs[3][1]
    for i in range(drows.shape[0]):
        bn_scale = float(rdrows[i, gb_lo:].abs().max())
        for name, lo, hi in secs:
            scale = bn_scale if name == "b2" else None
            out.append((f"blk{i}.{name}",)
                       + grad_err(drows[i, lo:hi], rdrows[i, lo:hi], scale))
    return out


BF16_TRAIN_RTOL = 2.0 ** -6


def span_train_rel_errs(dx, drows, rdx, rdrows):
    """{leaf: max |Δ| / scale} of a B8 backward against another: dx and
    each block's fields over their own max |value|, β2 (0 in exact
    arithmetic, see `span_train_grad_errs`) over its block's largest
    BN-parameter gradient."""
    from fastdet_torch.kernels.fused_train import row_sections
    rdx = rdx.double()
    out = {"dx": float((dx.double() - rdx).abs().max() / rdx.abs().max())}
    secs = row_sections(dx.shape[1] // 2)
    for i in range(drows.shape[0]):
        got, want = drows[i].double(), rdrows[i].double()
        bn_scale = float(want[secs[3][1]:].abs().max())
        for name, lo, hi in secs:
            scale = bn_scale if name == "b2" else float(
                want[lo:hi].abs().max())
            out[f"blk{i}.{name}"] = (float((got[lo:hi] - want[lo:hi]).abs()
                                           .max()) / max(scale, 1e-30))
    return out


def span16_backward_errs(got, dy, xsave, stats, rows, g, witness=False):
    """B8's bf16 backward `got` = (dx, drows) against its plain version on
    the same bf16 dy, saved inputs and stats → ({leaf: (err, bound)}, the
    plain version's (dx, drows)), err as `span_train_rel_errs`, bound
    BF16_TRAIN_RTOL.  `witness`: an
    ill-conditioned case, where two correct sum orders of the bf16
    function flip roundings and ReLU masks that a deep span carries far;
    there a leaf's bound is twice the plain version's own distance on
    that leaf from the same function with every sum in f64, where that is
    the larger.  The seeded weights of `span_train_case` at stage 3, b128
    (7 blocks) are such a case: on the kernel's saved inputs and stats
    the plain version's f32 sums on the card stood 4.4% of dγ1's max
    |value| from its f64 sums and 4.1% from its own f32 sums on the CPU,
    the kernel 5.3% from it (smoke phase 10 prints the three).  So are
    stages 3 and 4 of `SPAN_TRAIN_CONV` (ghost groups of 16 small
    images): on the CPU the plain version stood 4.8% and 2.0% of dγ1's
    max |value| from its f64 sums, `span16_train_steps` 7.3% and 1.6%
    from it."""
    import torch
    from fastdet_torch.kernels.fused_train import \
        span_train_backward_reference as plain
    p32 = plain(dy, xsave, stats, rows, g)
    errs = span_train_rel_errs(*got, *p32)
    if not witness:
        return {k: (e, BF16_TRAIN_RTOL) for k, e in errs.items()}, p32
    spread = span_train_rel_errs(*p32, *plain(dy, xsave, stats, rows, g,
                                              torch.float64))
    return {k: (e, max(BF16_TRAIN_RTOL, 2 * spread[k]))
            for k, e in errs.items()}, p32


# (b, H, W, group, tie, signed): the training stem B7 at the main path's
# b128 352² with ghost group 1, grouped at b8, with pad lanes (160×96: 960
# of 1024 lanes), on images with flat blocks (positive ties in the pool),
# and at sizes whose 8×8-cell tiles are cut off at the image's edge: 32×48
# (w4 = 12) and 36×52 (h4 = 9, w4 = 13, grouped, with ties); then with γ
# of both signs and one γ = 0 (`signed`), grouped on the tie images and
# at 160×96; last the convergence check's step, b32 128² at group 1
STEM_TRAIN_CASES = ((128, 352, 352, 1, False, False),
                    (8, 352, 352, 4, False, False),
                    (2, 160, 96, 1, False, False),
                    (4, 96, 96, 1, True, False),
                    (2, 32, 48, 1, False, False),
                    (4, 36, 52, 2, True, False),
                    (4, 96, 96, 2, True, True),
                    (2, 160, 96, 1, False, True),
                    (32, 128, 128, 1, False, False))
# the channel whose γ a signed case sets to 0
STEM_ZERO_GAMMA = 4


def tie_blocks(images):
    """Paint flat blocks into (B, H, W, 3) uint8 images in place: inside
    one, the stem's conv outputs of a phase are bitwise equal, so the
    pool windows hold positive ties (where BN leaves them > 0)."""
    h, w = images.shape[1:3]
    images[:, h // 8:h // 2, w // 4:3 * w // 4] = (200, 120, 40)
    images[:, h // 2:, :w // 3] = 255
    return images


def stem_train_case(seed, b, hgt, wid, tie=False, device="cpu",
                    signed=False):
    """Seeded training-stem inputs: s2d uint8 images (B, 48, npad)
    (noise, with `tie_blocks` if tie), a raw OIHW conv weight (w ~ 0.3·N,
    before the 1/255 scale), γ ~ 1 + 0.1·N (if signed, negated on every
    third channel and 0 on channel STEM_ZERO_GAMMA, whose β is then
    0.2), β ~ 0.1·N and a
    pooled output gradient (B, 24, H/4, W/4), on `device`."""
    import torch
    from fastdet_torch.kernels.fused_infer import pack_images_s2d
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, hgt, wid, 3), dtype=np.uint8)
    if tie:
        tie_blocks(images)
    x = torch.from_numpy(pack_images_s2d(images)).to(device)
    w = rng.normal(0.0, 0.3, (24, 3, 3, 3))
    gamma = 1.0 + 0.1 * rng.normal(size=24)
    beta = 0.1 * rng.normal(size=24)
    if signed:
        gamma[::3] *= -1.0
        gamma[STEM_ZERO_GAMMA] = 0.0
        beta[STEM_ZERO_GAMMA] = 0.2      # ReLU passes the constant BN
    dy = rng.normal(0.0, 1.0, (b, 24, hgt // 4, wid // 4))
    return (x,) + tuple(torch.from_numpy(a.astype(np.float32)).to(device)
                        for a in (w, gamma, beta, dy))


def pool_ties(x, w, stats, gamma, beta, h4, w4, g):
    """Windows of the training stem's 3×3 s2 pool whose positive maximum
    occurs more than once, for s2d images x, the scaled weight w and the
    saved stats: the conv outputs recomputed as the plain version does."""
    import torch
    import torch.nn.functional as F
    from fastdet_torch.kernels import stem_train as st
    u = st._conv(st._image(x, h4, w4, w.dtype), w)
    yb = torch.relu(st._bn_parts(u, stats, gamma, beta, g)[0])
    p = F.pad(yb, (1, 1, 1, 1), value=float("-inf"))
    win = F.unfold(p.flatten(0, 1)[:, None], 3, stride=2)   # (B·24, 9, n)
    top = win.max(1, keepdim=True).values
    return int(((win == top).sum(1) > 1)[top[:, 0] > 0].sum())


# ---------------------------------------------- the inference stem B1 (B6)

# (b, H, W): the s2d(4) stem B1 at b1 and b128 352² (88² cells, 7,744 of
# 7,808 lanes), b2 160×96 (960 of 1,024 lanes, junk in the pad), b32 640²
# (B6: 25,600 lanes, no pad), and sizes whose tiles are cut off at the
# image's edge: 36×52 (9×13 cells) and 20×12 (5×3)
STEM_CASES = ((1, 352, 352), (128, 352, 352), (2, 160, 96), (32, 640, 640),
              (2, 36, 52), (3, 20, 12))


def stem_case(seed, b, hgt, wid, device="cpu", tie=False):
    """Seeded s2d(4) uint8 images (B, 48, npad) (noise, with `tie_blocks`
    if tie) with junk in the pad lanes, on `device`."""
    import torch
    from fastdet_torch.kernels.fused_infer import pack_images_s2d
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (b, hgt, wid, 3), dtype=np.uint8)
    xs = pack_images_s2d(tie_blocks(img) if tie else img)
    n = (hgt // 4) * (wid // 4)
    xs[:, :, n:] = rng.integers(0, 256, xs[:, :, n:].shape)
    return torch.from_numpy(xs).to(device)


# ---------------------------------------- the flag paths' kernels B10, B9

# (b, H, W): the s2d(8) stem B10 at b1 and b128 352² (44² coarse cells,
# 1,936 of 2,048 lanes), b2 160×96 (20×12 coarse, 240 of 256 lanes, junk
# in the pad), and sizes whose 4×4-coarse-cell tiles are cut off at the
# image's edge: 72×104 (9×13 coarse) and 40×24 (5×3)
STEM8_CASES = ((1, 352, 352), (128, 352, 352), (2, 160, 96), (3, 72, 104),
               (2, 40, 24))

# (b, stage, h, w): the span B2 at the three stages of 352² (44², 22², 11²)
# and of 160×96 (20×12, 10×6, 5×3), each at b1 and b128; and at 640² (80²,
# 40², 20²) at b1 and b32, where stage 2 takes the stage kernel's
# per-block variant and stages 3-4 clusters of 8 and 4 CTAs
SPAN_CASES = (tuple((b, stage, hw, hw) for b in (1, 128)
                    for stage, hw in ((2, 44), (3, 22), (4, 11)))
              + tuple((b, stage, h, w) for b in (1, 128)
                      for stage, h, w in ((2, 20, 12), (3, 10, 6),
                                          (4, 5, 3)))
              + tuple((b, stage, hw, hw) for b in (1, 32)
                      for stage, hw in ((2, 80), (3, 40), (4, 20))))

# (b, stage, Hin, Win): the stage kernel B9 at the three stages of 352²
# (88² → 44², 44² → 22², 22² → 11²) at b1 and b128; stage 2 of 160×96
# (40×24 → 20×12, where the TPU kernel's lanes hold pad); and partial
# tiles, odd sizes among them: 18×50 → 9×25, 30×26 → 15×13, 9×13 → 5×7
S2SPAN_CASES = ((1, 2, 88, 88), (128, 2, 88, 88), (1, 3, 44, 44),
                (128, 3, 44, 44), (1, 4, 22, 22), (128, 4, 22, 22),
                (2, 2, 40, 24), (2, 2, 18, 50), (2, 3, 30, 26),
                (3, 4, 9, 13))


def stem8_case(seed, b, hgt, wid, device="cpu"):
    """Seeded s2d(8) uint8 images (B, 192, npad) with junk in the pad
    lanes, on `device`."""
    import torch
    from fastdet_torch.kernels.fused_infer import pack_images_s2d8
    rng = np.random.default_rng(seed)
    xs = pack_images_s2d8(rng.integers(0, 256, (b, hgt, wid, 3),
                                       dtype=np.uint8))
    n = (hgt // 8) * (wid // 8)
    xs[:, :, n:] = rng.integers(0, 256, xs[:, :, n:].shape)
    return torch.from_numpy(xs).to(device)


def s2span_case(seed, b, cin, hgt, wid, device="cpu"):
    """Seeded stage input (≥ 0, as a stem's or a stage's ReLU outputs
    are), f32 (B, cin, H, W) on `device`."""
    import torch
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.abs(rng.normal(
        0.0, 1.0, (b, cin, hgt, wid))).astype(np.float32)).to(device)


# ------------------------------------------------ the anchor-free family

AF_GOLDEN = "tests/data/anchorfree_golden.json"   # relative to the repo


def make_sample(rng, size=128, n_max=3):
    """One sample of the synthetic rectangle task (solid coloured
    rectangles on a noise background, class = colour): (size, size, 3)
    uint8 and (n, 5) [cls, cx, cy, w, h] normalized labels.  The port's
    copy of tools/convergence_check.py::make_sample, draw for draw."""
    img = rng.randint(0, 80, (size, size, 3), np.uint8)
    n = rng.randint(1, n_max + 1)
    labels = []
    colors = [(220, 40, 40), (40, 220, 40), (40, 40, 220)]
    for _ in range(n):
        cls = rng.randint(0, 3)
        w = rng.randint(size // 8, size // 2)
        h = rng.randint(size // 8, size // 2)
        x1 = rng.randint(0, size - w)
        y1 = rng.randint(0, size - h)
        img[y1:y1 + h, x1:x1 + w] = colors[cls]
        labels.append([cls, (x1 + w / 2) / size, (y1 + h / 2) / size,
                       w / size, h / size])
    return img, np.asarray(labels, np.float32)


def golden_image(golden):
    """The golden file's image (`make_sample` at its seed and size)."""
    return make_sample(np.random.RandomState(golden["img_seed"]),
                       golden["size"])


def golden_mismatches(got, golden):
    """The golden file's rule (tests/test_anchorfree.py::
    test_af_golden_detections) on one image's (n, 6) detections: the
    count within 1 of the file's; every file detection scoring ≥ 0.32
    found in `got`, every detection of `got` scoring ≥ 0.35 found in the
    file (same class, box within 0.5 px, score within 0.02).  → the
    failures, [] when it holds."""
    want = np.asarray(golden["detections"], np.float32)

    def match(row, pool):
        same = pool[pool[:, 5] == row[5]]
        if not len(same):
            return False
        d = np.abs(same[:, :4] - row[:4]).max(1)
        ds = np.abs(same[:, 4] - row[4])
        return bool(((d < 0.5) & (ds < 0.02)).any())

    bad = []
    if abs(len(got) - golden["count"]) > 1:
        bad.append(f"count {len(got)}, golden {golden['count']}")
    bad += [f"pinned detection lost: {row}" for row in want[want[:, 4] >= 0.32]
            if not match(row, got)]
    bad += [f"unpinned new detection: {row}" for row in got[got[:, 4] >= 0.35]
            if not match(row, want)]
    return bad


def synth_world(root, weights):
    """A seeded 8-image Darknet set of the synthetic task in `root` (a
    pathlib.Path): PNGs written with cv2 at 128², label files holding each
    image's boxes, less one box in every third image and plus one
    spurious box (so that an evaluation has TP, FP and FN), a 3-class
    `synth.data` (b4, 2 epochs, `weights` as its pre_weights) whose train
    and val lists are these images.  → root."""
    import cv2
    rng = np.random.RandomState(17)
    paths = []
    for i in range(8):
        img, labels = make_sample(rng, 128)
        p = root / f"img{i}.png"
        cv2.imwrite(str(p), img)
        paths.append(str(p))
        rows = [tuple(r) for r in labels]
        if i % 3 == 0 and len(rows) > 1:
            rows = rows[1:]                              # a miss
        cx, cy = rng.uniform(0.2, 0.8, 2)
        rows.append((labels[0, 0], cx, cy, 0.1, 0.1))    # spurious
        with open(p.with_suffix(".txt"), "w") as f:
            f.writelines("%d %.6f %.6f %.6f %.6f\n" % tuple(r) for r in rows)
    (root / "list.txt").write_text("\n".join(paths) + "\n")
    (root / "synth.names").write_text("red\ngreen\nblue\n")
    (root / "synth.data").write_text(f"""[name]
model_name=synth

[train-configure]
epochs=2
steps=150,250
batch_size=4
subdivisions=1
learning_rate=0.001

[model-configure]
pre_weights={weights}
classes=3
width=128
height=128
anchor_num=3
anchors=12.64,19.39, 37.88,51.48, 55.71,138.31, 126.91,78.23, 131.57,214.55, 279.92,258.87

[data-configure]
train={root / "list.txt"}
val={root / "list.txt"}
names={root / "synth.names"}
""")
    return root


# ------------------------------------------ reference-layout .pth weights

def reference_state_dict(npz_path, backbone_only=False):
    """The reference's `.pth` state dict of a JAX-layout `.npz`, by the
    inverse of fastdet/io/torch_convert.py::convert_state_dict: each
    [conv, bn] pair back at its `nn.Sequential` indices, kernels HWIO →
    OIHW, BN scale/bias → weight/bias, mean/var → running_mean/var, and
    a `num_batches_tracked` beside each BN, as torch writes it.
    `backbone_only`: the backbone's keys without their "backbone."
    prefix, as a released backbone checkpoint holds them.  → {name:
    tensor}, f32 (int64 for the counters)."""
    import torch
    from fastdet_torch.io.weights import load_npz_variables
    tree = load_npz_variables(npz_path)
    params, stats = tree["params"], tree["batch_stats"]
    sd = {}

    def put(name, a):
        sd[name] = torch.from_numpy(np.ascontiguousarray(a, np.float32))

    def convbn(path, conv, bn):
        p, s = params, stats
        for k in path:
            p, s = p[k], s[k]
        put(f"{conv}.weight", np.transpose(p["conv"]["kernel"], (3, 2, 0, 1)))
        put(f"{bn}.weight", p["bn"]["scale"])
        put(f"{bn}.bias", p["bn"]["bias"])
        put(f"{bn}.running_mean", s["bn"]["mean"])
        put(f"{bn}.running_var", s["bn"]["var"])
        sd[f"{bn}.num_batches_tracked"] = torch.tensor(1000, dtype=torch.int64)

    bb = "" if backbone_only else "backbone."
    convbn(("backbone", "first_conv"), f"{bb}first_conv.0",
           f"{bb}first_conv.1")
    for stage, reps in ((2, 4), (3, 8), (4, 4)):
        for i in range(reps):
            path = ("backbone", f"stage{stage}_{i}")
            pre = f"{bb}stage{stage}.{i}"
            branches = [("main_pw", "branch_main", 0, 1),
                        ("main_dw", "branch_main", 3, 4),
                        ("main_pw_linear", "branch_main", 5, 6)]
            if i == 0:
                branches += [("proj_dw", "branch_proj", 0, 1),
                             ("proj_pw", "branch_proj", 2, 3)]
            for name, branch, ci, bi in branches:
                convbn(path + (name,), f"{pre}.{branch}.{ci}",
                       f"{pre}.{branch}.{bi}")
    if backbone_only:
        return sd
    for name in ("conv1x1_2", "conv1x1_3"):
        convbn(("fpn", name), f"fpn.{name}.0", f"fpn.{name}.1")
    for head in ("cls_head_2", "reg_head_2", "cls_head_3", "reg_head_3"):
        for name, ci, bi in (("dw1", 0, 1), ("pw1", 3, 4), ("dw2", 5, 6),
                             ("pw2", 8, 9)):
            convbn(("fpn", head, name), f"fpn.{head}.block.{ci}",
                   f"fpn.{head}.block.{bi}")
    for name, ref in (("output_reg", "output_reg_layers"),
                      ("output_obj", "output_obj_layers"),
                      ("output_cls", "output_cls_layers")):
        put(f"{ref}.weight",
            np.transpose(params[name]["kernel"], (3, 2, 0, 1)))
        put(f"{ref}.bias", params[name]["bias"])
    return sd


def write_reference_pth(npz_path, pth_path, backbone_only=False):
    """`torch.save` `reference_state_dict(npz_path, backbone_only)` to
    `pth_path` → pth_path."""
    import torch
    torch.save(reference_state_dict(npz_path, backbone_only), str(pth_path))
    return pth_path


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHOTO = os.path.join(REPO, "test_result.png")


def photo_crops(n, hw, seed):
    """Seeded crops (60-100% of each side, every other one mirrored) of
    the repository's photo at `hw`: real scenes, whose activations meet
    the rounding ties of round(x/s_x) that noise images rarely do."""
    import cv2
    rng = np.random.default_rng(seed)
    photo = cv2.imread(PHOTO)
    h, w = photo.shape[:2]
    out = []
    for i in range(n):
        ch, cw = int(rng.integers(int(0.6 * h), h)), int(
            rng.integers(int(0.6 * w), w))
        y0, x0 = int(rng.integers(0, h - ch)), int(rng.integers(0, w - cw))
        crop = photo[y0:y0 + ch, x0:x0 + cw]
        out.append(cv2.resize(crop if i % 2 else crop[:, ::-1],
                              (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR))
    return np.stack(out)


def photo_pair(hw=(352, 352)):
    """The repository's photo (BGR) at `hw` and its mirror image."""
    import cv2
    img = cv2.resize(cv2.imread(PHOTO), (hw[1], hw[0]),
                     interpolation=cv2.INTER_LINEAR)
    return np.stack([img, img[:, ::-1]])


def run_beside(jax_script, jax_args, *port_runs, timeout=600):
    """`cli/<jax_script> jax_args` and each (module, args) of the port
    (`python -m fastdet_torch.cli.<module> --device cpu args`) at once →
    their stdouts, JAX's first; each must exit 0."""
    import subprocess
    import sys
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("PYTHONPATH", None)
    cmds = [[os.path.join(REPO, "cli", jax_script), *jax_args]]
    cmds += [["-m", f"fastdet_torch.cli.{m}", "--device", "cpu", *a]
             for m, a in port_runs]
    procs = [subprocess.Popen([sys.executable, *c], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=REPO) for c in cmds]
    outs = []
    try:
        for c, p in zip(cmds, procs):
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, (c, (out + err)[-3000:])
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return outs


# the JAX package's bf16 serving contract (tests/test_postprocess.py::
# test_golden_image_bf16_serving): boxes within 4 px, scores within 0.05
BF16_BOX_ATOL = 4.0
BF16_SCORE_ATOL = 0.05


def assert_bf16_serving_contract(got, want):
    """Per image the same count, and each detection of `got` paired with
    one of `want` of the same class, box within 4 px and score within 0.05
    (scores that close may rank in either order)."""
    assert len(got) == len(want)
    for d, j in zip(got, want):
        assert d.shape == j.shape and len(d) > 0
        free = list(range(len(j)))
        for row in d:
            hit = [i for i in free if j[i, 5] == row[5]
                   and np.abs(j[i, :4] - row[:4]).max() <= BF16_BOX_ATOL
                   and abs(j[i, 4] - row[4]) <= BF16_SCORE_ATOL]
            assert hit, f"no partner for {row} in {j}"
            free.remove(hit[0])
