"""The port's eval chain (fastdet_torch/eval, the staged postprocess) against
the JAX package's on the CPU.

  * `metrics.batch_statistics` and `ap_per_class`: exactly equal, on
    seeded detections and labels (both are numpy);
  * `evaluate`: the same 4-tuple, exactly, given the same fixed
    detections;
  * `postprocess` at the eval windows (max_nms 512, 1024 and 2048; k =
    512, 1,024 and 1,815 at 352²), where the JAX package takes its XLA
    staged path: counts and classes equal, scores within SCORE_ATOL and
    boxes within BOX_ULPS_XLA ULPs (XLA's and PyTorch's sigmoid and
    softmax differ; see test_torch_postprocess.py); fed JAX's decoded
    window, the port's staged NMS and compaction are bitwise JAX's
    output.
"""

import importlib

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet.eval import metrics as jmetrics
from fastdet.eval.runner import evaluate as jax_evaluate
from fastdet_torch.config import Config
from fastdet_torch.eval import metrics
from fastdet_torch.eval.runner import evaluate
from fastdet_torch.io import load_state_dict
from fastdet_torch.kernels.nms_kernel import suppress_ranked_batch
from fastdet_torch.models import Detector
from fastdet_torch.ops import postprocess as pp
from test_torch_postprocess import HW, assert_dets_close
from torch_cases import ANCHORS, head_outputs, staged_reference

jpp = importlib.import_module("fastdet.ops.postprocess")

NC = 80


def seeded_eval_set(seed, n_img=6, n_cls=4):
    """Per image: labels (m,5) normalized [cls,cx,cy,w,h] and detections
    (n,6) [xyxy px, conf desc, cls] near them, with misses, duplicates,
    wrong classes and spurious boxes, so that TP, FP and FN all occur."""
    rng = np.random.default_rng(seed)
    labels, dets = [], []
    for _ in range(n_img):
        m = int(rng.integers(1, 6))
        cxy = rng.uniform(0.2, 0.8, (m, 2))
        wh = rng.uniform(0.05, 0.3, (m, 2))
        cls = rng.integers(0, n_cls, m)
        labels.append(np.concatenate([cls[:, None], cxy, wh], 1)
                      .astype(np.float32))
        px = np.concatenate([cxy - wh / 2, cxy + wh / 2], 1) * 352
        rows = []
        for j in range(m):
            for _ in range(int(rng.integers(0, 3))):          # 0-2 hits
                box = px[j] + rng.normal(0, 6, 4)
                c = cls[j] if rng.random() < 0.8 else rng.integers(0, n_cls)
                rows.append([*box, rng.uniform(0.01, 1), c])
        for _ in range(int(rng.integers(0, 4))):              # spurious
            xy = rng.uniform(0, 300, 2)
            rows.append([*xy, *(xy + rng.uniform(10, 50, 2)),
                         rng.uniform(0.01, 1), rng.integers(0, n_cls)])
        d = np.asarray(rows, np.float32).reshape(-1, 6)
        dets.append(d[np.argsort(-d[:, 4], kind="stable")])
    return labels, dets


def gt_xyxy(labels):
    boxes = []
    for lab in labels:
        cxy, cwh = lab[:, 1:3], lab[:, 3:5]
        boxes.append(np.concatenate([cxy - cwh / 2, cxy + cwh / 2], 1)
                     * np.float32(352))
    return boxes, [lab[:, 0] for lab in labels]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_jax(seed):
    labels, dets = seeded_eval_set(seed)
    boxes, classes = gt_xyxy(labels)
    got = metrics.batch_statistics(dets, boxes, classes, 0.5)
    want = jmetrics.batch_statistics(dets, boxes, classes, 0.5)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    tp = np.concatenate([s[0] for s in got])
    assert 0 < tp.sum() < len(tp)
    args = (tp, np.concatenate([s[1] for s in got]),
            np.concatenate([s[2] for s in got]), np.concatenate(classes))
    assert metrics.ap_per_class(*args) == jmetrics.ap_per_class(*args)


def _batches(labels, dets, bsz=4):
    """(images, labels (B,M,5), mask (B,M)) batches and the per-batch
    detections as a postprocess returns them: (B,300,6) + counts."""
    out = []
    for s in range(0, len(labels), bsz):
        lab, det = labels[s:s + bsz], dets[s:s + bsz]
        b = len(lab)
        packed = np.zeros((b, 8, 5), np.float32)
        mask = np.zeros((b, 8), bool)
        rows = np.zeros((b, 300, 6), np.float32)
        counts = np.zeros(b, np.int32)
        for i, (la, de) in enumerate(zip(lab, det)):
            packed[i, :len(la)], mask[i, :len(la)] = la, True
            rows[i, :len(de)], counts[i] = de, len(de)
        images = np.zeros((b, 352, 352, 3), np.uint8)
        out.append(((images, packed, mask), (rows, counts)))
    return out


def test_evaluate_equals_jax():
    labels, dets = seeded_eval_set(3, n_img=10)
    batches = _batches(labels, dets)
    table = {id(images): outs for (images, _, _), outs in batches}

    got = evaluate(lambda images: tuple(map(torch.from_numpy,
                                            table[id(images)])),
                   [b for b, _ in batches], HW)
    want = jax_evaluate(lambda _v, images: table[id(images)], None,
                        [b for b, _ in batches], HW)
    assert got == want
    assert all(0 < v < 1 for v in got)


def test_evaluate_no_detections_and_distributed():
    labels, dets = seeded_eval_set(4, n_img=2)
    batches = _batches(labels, [d[:0] for d in dets])
    table = {id(b[0]): tuple(map(torch.from_numpy, outs))
             for b, outs in batches}
    assert evaluate(lambda images: table[id(images)],
                    [b for b, _ in batches], HW) is None
    # distributed=True in one process: the gather is the identity
    assert evaluate(lambda images: table[id(images)],
                    [b for b, _ in batches], HW, distributed=True) is None
    labels, dets = seeded_eval_set(4, n_img=2)
    batches = _batches(labels, dets)
    table = {id(b[0]): tuple(map(torch.from_numpy, outs))
             for b, outs in batches}
    want = evaluate(lambda images: table[id(images)],
                    [b for b, _ in batches], HW)
    assert want is not None
    assert evaluate(lambda images: table[id(images)],
                    [b for b, _ in batches], HW, distributed=True) == want


def _jax_pp(outs, **kw):
    return jpp.postprocess([jnp.asarray(o) for o in outs],
                           jnp.asarray(ANCHORS), HW, **kw)


@pytest.mark.parametrize("max_nms", [512, 1024, 2048])
def test_staged_postprocess_matches_jax(max_nms):
    """conf 0.01 leaves ~1,700 of the 1,815 candidates per image valid,
    so every window is full."""
    outs = head_outputs(100 + max_nms)
    kw = dict(conf_thres=0.01, iou_thres=0.4, max_det=300, max_nms=max_nms)
    t_outs = [torch.from_numpy(o) for o in outs]
    ranked = pp.rank_scores(t_outs, HW, 0.01)[0]
    assert int((ranked > 0).sum(1).min()) >= min(max_nms, 1815) - 200
    dets, counts = pp.postprocess(t_outs, ANCHORS, HW, **kw)
    jdets, jcounts = _jax_pp(outs, **kw)
    assert_dets_close(jdets, jcounts, dets, counts)

    # JAX's decoded window through the port's staged NMS and compaction
    boxes_k, score_k, cls_k = _jax_pp(outs, **kw, _upto="decoded")
    score_k = torch.from_numpy(np.array(score_k))
    det, n = suppress_ranked_batch(
        torch.from_numpy(np.array(boxes_k)), score_k,
        torch.from_numpy(np.array(cls_k)).long(), score_k > 0,
        iou_thres=0.4, max_det=300)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(det.numpy(), np.asarray(jdets))


def test_staged_reference_is_the_cpu_postprocess():
    """`torch_cases.staged_reference`, the plain chain that the card tests
    and chip_smoke.py hold the kernel path to, is what `postprocess`
    computes on the CPU for a window over MAX_K."""
    outs = [torch.from_numpy(o) for o in head_outputs(7)]
    kw = dict(conf_thres=0.01, iou_thres=0.4, max_nms=1024)
    dets, counts = pp.postprocess(outs, ANCHORS, HW, **kw)
    want, n = staged_reference(outs, ANCHORS, HW, **kw)
    assert torch.equal(counts, n) and torch.equal(dets, want)


def test_build_detect_fn_default_window_runs():
    """`max_nms=1024` (the default) takes the staged path; the real weights
    on the repository's photo and its mirror image."""
    cfg = Config.from_file("data/coco.data")
    model = Detector()
    model.load_state_dict(load_state_dict("weights/coco2017-ref.npz"))
    detect = pp.build_detect_fn(model, cfg, conf_thres=0.01, device="cpu")
    photo = cv2.resize(cv2.imread("test_result.png"), (352, 352))
    dets, counts = detect(torch.from_numpy(np.stack([photo,
                                                     photo[:, ::-1]])))
    assert tuple(dets.shape) == (2, 300, 6)
    assert counts.min() > 0
    assert torch.isfinite(dets).all()
