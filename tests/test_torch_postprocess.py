"""The port's postprocess (fastdet_torch/ops) against the JAX package's,
on seeded raw head outputs at the serving shapes (352²: 22² and 11²
cells, 3 anchors, 80 classes).

  * fed the JAX-computed scores, boxes or keep masks, the ranking sort,
    the NMS and the compaction are bitwise equal;
  * the full function (the port's sigmoid and softmax against XLA's)
    matches JAX `postprocess_dense` and the staged `postprocess` with the
    same counts and classes, scores within SCORE_ATOL and boxes within
    BOX_ULPS_XLA ULPs of the box's largest coordinate: XLA's and PyTorch's
    sigmoid differ by up to 2 ULPs and their softmax by less than
    SCORE_ATOL (pinned by test_transcendentals_within_stated_ulps).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet.kernels.nms_kernel import compact_ranked as jax_compact_ranked
from fastdet.ops.nms import batched_nms as jax_batched_nms
from fastdet.ops.nms import suppress_ranked as jax_suppress_ranked
from fastdet_torch.kernels.nms_kernel import compact_ranked
from fastdet_torch.ops import nms
from fastdet_torch.ops import postprocess as pp
from torch_cases import BOX_ULPS_XLA, box_ulps

jpp = importlib.import_module("fastdet.ops.postprocess")

HW = (352, 352)
NC = 80
ANCHORS = np.asarray([12.64, 19.39, 37.88, 51.48, 55.71, 138.31, 126.91,
                      78.23, 131.57, 214.55, 279.92, 258.87],
                     np.float32).reshape(2, 3, 2)
SCORE_ATOL = 1e-6


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


def jax_pp(outs, **kw):
    return jpp.postprocess([jnp.asarray(o) for o in outs],
                           jnp.asarray(ANCHORS), HW, **kw)


def port_pp(fn, outs, **kw):
    return fn([torch.from_numpy(o) for o in outs], ANCHORS, HW, **kw)


def assert_dets_close(jdets, jcounts, dets, counts):
    jdets, jcounts = np.asarray(jdets), np.asarray(jcounts)
    dets, counts = dets.numpy(), counts.numpy()
    np.testing.assert_array_equal(counts, jcounts)
    np.testing.assert_array_equal(dets[..., 5], jdets[..., 5])
    np.testing.assert_allclose(dets[..., 4], jdets[..., 4], rtol=0,
                               atol=SCORE_ATOL)
    assert box_ulps(dets[..., :4], jdets[..., :4]).max() <= BOX_ULPS_XLA


@pytest.mark.parametrize("conf,max_nms", [(0.3, 128), (0.3, 256),
                                          (0.01, 128), (0.01, 1024)])
def test_full_postprocess_matches_jax(conf, max_nms):
    outs = head_outputs(int(conf * 100) + max_nms)
    kw = dict(conf_thres=conf, iou_thres=0.45, max_det=300, max_nms=max_nms)
    dets, counts = port_pp(pp.postprocess, outs, **kw)
    jdets, jcounts = jax_pp(outs, **kw)                       # staged
    assert_dets_close(jdets, jcounts, dets, counts)
    jdd, jdc = jpp.postprocess_dense([jnp.asarray(o) for o in outs],
                                     jnp.asarray(ANCHORS), HW, **kw)
    assert_dets_close(jdd, jdc, dets, counts)
    ddets, dcounts = port_pp(pp.postprocess_dense, outs, **kw)
    assert_dets_close(jdd, jdc, ddets, dcounts)
    assert counts.min() > 0


def test_rank_scores_match_jax():
    outs = head_outputs(1)
    jranked, jreg, jcls = jax_pp(outs, conf_thres=0.3, max_nms=128,
                                 _upto="scores")
    ranked, reg_f, cls_f, _ = pp.rank_scores(
        [torch.from_numpy(o) for o in outs], HW, 0.3)
    np.testing.assert_array_equal(reg_f.numpy(), np.asarray(jreg))
    np.testing.assert_array_equal(cls_f.numpy(), np.asarray(jcls))
    np.testing.assert_allclose(ranked.numpy(), np.asarray(jranked), rtol=0,
                               atol=SCORE_ATOL)
    np.testing.assert_array_equal(ranked.numpy() > 0, np.asarray(jranked) > 0)


@pytest.mark.parametrize("k", [128, 256, 1024, 1815])
def test_ranking_bitwise_given_jax_scores(k):
    outs = head_outputs(2)
    ranked, _, cls_f = jax_pp(outs, conf_thres=0.3, max_nms=k,
                              _upto="scores")
    score_k, order, cls_k, _ = jax_pp(outs, conf_thres=0.3, max_nms=k,
                                      _upto="sorted")
    neg_k, combo_k = pp.rank_topk(torch.from_numpy(np.array(ranked)),
                                  torch.from_numpy(np.array(cls_f)).long(),
                                  nc=NC, k=k)
    np.testing.assert_array_equal(-neg_k.numpy(), np.asarray(score_k))
    np.testing.assert_array_equal(combo_k.numpy() // NC, np.asarray(order))
    np.testing.assert_array_equal(combo_k.numpy() % NC, np.asarray(cls_k))


@pytest.mark.parametrize("k,max_det", [(128, 300), (1024, 300), (256, 20)])
def test_nms_bitwise_given_jax_boxes(k, max_det):
    outs = head_outputs(3)
    boxes_k, score_k, cls_k = jax_pp(outs, conf_thres=0.3, max_nms=k,
                                     _upto="decoded")
    valid_k = np.asarray(score_k) > 0
    fn = jax.vmap(lambda b, s, c, v: jax_suppress_ranked(
        b, s, c, v, iou_thres=0.45, max_det=max_det))
    jdet, jn = fn(boxes_k, score_k, cls_k, jnp.asarray(valid_k))
    det, n = nms.suppress_ranked(
        torch.from_numpy(np.array(boxes_k)),
        torch.from_numpy(np.array(score_k)),
        torch.from_numpy(np.array(cls_k)).long(),
        torch.from_numpy(valid_k), iou_thres=0.45, max_det=max_det)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(det.numpy(), np.asarray(jdet))
    assert (n.numpy() < valid_k.sum(1)).any()          # something suppressed


def test_batched_nms_bitwise_given_jax_decode():
    outs = head_outputs(4)
    decoded = np.array(importlib.import_module(
        "fastdet.ops.decode").decode_outputs(
            [jnp.asarray(o) for o in outs], jnp.asarray(ANCHORS), HW))
    args = (decoded[..., :4], decoded[..., 4], decoded[..., 5:])
    kw = dict(conf_thres=0.3, iou_thres=0.45, max_det=300, max_nms=256)
    jdet, jn = jax_batched_nms(*[jnp.asarray(a) for a in args], **kw)
    det, n = nms.batched_nms(*[torch.from_numpy(a) for a in args], **kw)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(det.numpy(), np.asarray(jdet))


@pytest.mark.parametrize("k,max_det", [(128, 300), (384, 300), (256, 50)])
def test_compaction_bitwise(k, max_det):
    rng = np.random.default_rng(k)
    b = 3
    keep = rng.random((b, k)) < 0.4
    boxes = rng.uniform(0, 352, (b, k, 4)).astype(np.float32)
    score = np.sort(rng.uniform(0, 1, (b, k)).astype(np.float32))[:, ::-1]
    cls = rng.integers(0, NC, (b, k)).astype(np.int32)
    jdet, jn = jax_compact_ranked(jnp.asarray(keep), jnp.asarray(boxes),
                                  jnp.asarray(score.copy()),
                                  jnp.asarray(cls), max_det=max_det)
    det, n = compact_ranked(torch.from_numpy(keep), torch.from_numpy(boxes),
                            torch.from_numpy(score.copy()),
                            torch.from_numpy(cls), max_det=max_det)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(det.numpy(), np.asarray(jdet))


def test_decode_matches_jax():
    outs = head_outputs(5)
    jdec = np.asarray(importlib.import_module(
        "fastdet.ops.decode").decode_outputs(
            [jnp.asarray(o) for o in outs], jnp.asarray(ANCHORS), HW))
    dec = importlib.import_module("fastdet_torch.ops.decode").decode_outputs(
        [torch.from_numpy(o) for o in outs], torch.from_numpy(ANCHORS), HW)
    assert box_ulps(dec[..., :4].numpy(), jdec[..., :4]).max() <= BOX_ULPS_XLA
    np.testing.assert_allclose(dec[..., 4:].numpy(), jdec[..., 4:], rtol=0,
                               atol=SCORE_ATOL)


def test_transcendentals_within_stated_ulps():
    """The ground of the tolerances above: on 10⁵ seeded logits, XLA's and
    PyTorch's f32 sigmoid differ by at most 2 ULPs, and their softmax
    probabilities by at most SCORE_ATOL."""
    rng = np.random.default_rng(6)
    x = rng.normal(0, 3, 100_000).astype(np.float32)
    js = np.asarray(jax.nn.sigmoid(jnp.asarray(x)))
    ts = torch.sigmoid(torch.from_numpy(x)).numpy()
    ulps = np.abs(js.astype(np.float64) - ts) / np.spacing(np.maximum(js, ts))
    assert ulps.max() <= 2
    c = rng.normal(0, 3, (2_000, NC)).astype(np.float32)
    jc = np.asarray(jax.nn.softmax(jnp.asarray(c), axis=-1))
    tc = torch.softmax(torch.from_numpy(c), dim=-1).numpy()
    np.testing.assert_allclose(tc, jc, rtol=0, atol=SCORE_ATOL)
