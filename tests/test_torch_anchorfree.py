"""The port's anchor-free family (fastdet_torch/models/anchorfree.py,
registry.py, `pack_fused_weights_af`, `build_fused_forward(head=
"anchorfree")`, `FusedPipeline(family="anchorfree")`) against the JAX
package's on the CPU, with the trained 3-class checkpoint
`weights/anchorfree-synth.npz` and a 5-class model initialised by JAX, at
64×96, 128² and 160×96 (non-square, so that a swap of height and width
shows), b ≤ 4.  The JAX fused forward runs its Pallas kernels in
interpret mode, as its own tests do; the port's kernels run their plain
versions.

Tolerances:
  * the weights' carrier and the fused packing: bitwise;
  * forwards (nn and fused, raw maps and `deploy=True`): 2e-4, the f32
    forward contract of tests/test_torch_fused_infer.py;
  * the decode on the same raw maps: 4 ULPs of each array's largest
    |value| (XLA's and PyTorch's sigmoid differ by up to 2 ULPs, and
    w, h square it);
  * detections from the same raw maps: equal counts and classes, scores
    within 1e-6, boxes within BOX_ULPS_XLA ULPs of the box's largest
    coordinate, as tests/test_torch_postprocess.py has;
  * detections from images (the forwards differ by ~1e-6): the pipeline
    tolerance of tests/test_torch_fused_serve.py, scores 1e-4 and boxes
    1e-2 px;
  * the golden detections (tests/data/anchorfree_golden.json): the rule
    of tests/test_anchorfree.py::test_af_golden_detections.
"""

import functools
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet.config import Config as JaxConfig
from fastdet.io.torch_convert import load_npz_variables
from fastdet.kernels import fold as jfold
from fastdet.kernels import fused_infer as jfi
from fastdet.models import anchorfree as jaf
from fastdet.serve import FusedPipeline as JaxFusedPipeline
from fastdet_torch.config import Config
from fastdet_torch.io import from_jax_variables, to_jax_variables
from fastdet_torch.kernels import fold, fused_infer
from fastdet_torch.models import anchorfree as af
from fastdet_torch.models.registry import get_family
from fastdet_torch.serve import FusedPipeline
from torch_cases import (AF_GOLDEN, BOX_ULPS_XLA, box_ulps, golden_image,
                         golden_mismatches, make_sample)
from tools.convergence_check import make_sample as tools_make_sample

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH_NPZ = os.path.join(REPO, "weights", "anchorfree-synth.npz")
ATOL = 2e-4
SCORE_ATOL = 1e-6
SIZES = {"64x96": (64, 96), "128x128": (128, 128), "160x96": (160, 96)}


@functools.lru_cache(maxsize=None)
def _variables(which):
    """"synth": the trained 3-class checkpoint; "init5": a 5-class model
    initialised by JAX (seed 0)."""
    if which == "synth":
        return load_npz_variables(SYNTH_NPZ)
    v = jaf.AnchorFreeDetector(classes=5).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)), train=False)
    return jax.tree.map(np.asarray, v)


CLASSES = {"synth": 3, "init5": 5}


@functools.lru_cache(maxsize=None)
def _state_dict(which):
    return from_jax_variables(_variables(which))


def _model(which):
    m = af.AnchorFreeDetector(CLASSES[which])
    m.load_state_dict(_state_dict(which), strict=True)
    return m.eval()


def _images(size, b=2):
    """Synthetic-task samples (the checkpoint detects their rectangles)
    resized by slicing a 160² sample: seeded, uint8 NHWC."""
    h, w = SIZES[size]
    rng = np.random.RandomState(h * 1000 + w)
    return np.stack([make_sample(rng, 160)[0][:h, :w] for _ in range(b)])


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# ---------------------------------------------------------------- weights

def test_synth_checkpoint_loads_strict_and_roundtrips_bitwise():
    variables = _variables("synth")
    m = _model("synth")
    back = dict(_leaves(to_jax_variables(m.state_dict())))
    want = dict(_leaves(variables))
    assert len(want) == 326 and set(back) == set(want)
    for k, v in want.items():
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], v, err_msg="/".join(k))
    assert tuple(m.out_cls.weight.shape) == (3, 96, 1, 1)


def test_registry_families():
    cfg = Config.from_dict({"classes": 3, "width": 96, "height": 64,
                            "anchor_num": 3})
    fam = get_family("fastestdet", cfg)
    assert fam.name == "anchorfree"
    assert isinstance(fam.model, af.AnchorFreeDetector)
    fam.model.load_state_dict(_state_dict("synth"), strict=True)
    assert get_family("V2", cfg).name == "yolo-fastestv2"
    with pytest.raises(ValueError, match="unknown model family"):
        get_family("yolov9", cfg)


def test_seeded_init_is_a_function_of_the_generator():
    a = af.seeded_init(af.AnchorFreeDetector(7),
                       torch.Generator().manual_seed(3))
    b = af.seeded_init(af.AnchorFreeDetector(7),
                       torch.Generator().manual_seed(3))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    w = a.fuse.conv.weight
    assert abs(float(w.detach().std()) * 288 ** 0.5 - 1.0) < 0.05


# ---------------------------------------------------------------- forward

@pytest.mark.parametrize("which,size", list(itertools.product(
    ("synth", "init5"), SIZES)))
def test_forward_and_deploy_match_jax(which, size):
    img = _images(size, b=3)
    x = img.astype(np.float32) / 255.0
    jm = jaf.AnchorFreeDetector(classes=CLASSES[which])
    v = jax.tree.map(jnp.asarray, _variables(which))
    want = jm.apply(v, jnp.asarray(x), train=False)
    want_dep = jm.apply(v, jnp.asarray(x), train=False, deploy=True)
    m = _model(which)
    with torch.inference_mode():
        got = m(torch.from_numpy(x))
        got_dep = m(torch.from_numpy(x), deploy=True)
    h, w = SIZES[size]
    nc = CLASSES[which]
    assert [tuple(g.shape) for g in got] == [
        (3, h // 16, w // 16, c) for c in (1, nc, 4)]
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                   atol=ATOL)
    assert tuple(got_dep.shape) == (3, h // 16, w // 16, 5 + nc)
    np.testing.assert_allclose(got_dep.numpy(), np.asarray(want_dep),
                               rtol=0, atol=ATOL)


def _raw_maps(seed, b=2, h=10, w=6, nc=3):
    """Seeded raw (obj, cls, reg) NHWC logits: obj biased so that about
    half the cells pass conf 0.3, class 0 favoured so that same-class
    boxes overlap and suppress."""
    rng = np.random.default_rng(seed)
    obj = rng.normal(0.5, 1.5, (b, h, w, 1)).astype(np.float32)
    cls = rng.normal(0, 2.0, (b, h, w, nc)).astype(np.float32)
    cls[..., 0] += 2.0
    reg = rng.normal(0, 1.5, (b, h, w, 4)).astype(np.float32)
    return obj, cls, reg


def test_decode_matches_jax_at_160x96():
    maps = _raw_maps(1)
    want = jaf.decode_anchorfree(*map(jnp.asarray, maps), (160, 96))
    got = af.decode_anchorfree(*map(torch.from_numpy, maps), (160, 96))
    for g, j in zip(got, want):
        j = np.asarray(j)
        assert g.shape == j.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), j, rtol=0,
                                   atol=4 * np.spacing(np.abs(j).max()))
    # x = column, stride = 160 / 10 = 16, size scale (w 96, h 160)
    boxes = got[0].numpy().reshape(2, 10, 6, 4)
    sig = 1 / (1 + np.exp(-maps[2].astype(np.float64)))
    np.testing.assert_allclose(boxes[0, 3, 5, :2],
                               (sig[0, 3, 5, :2] * 2 - 0.5 + [5, 3]) * 16,
                               rtol=1e-6)
    np.testing.assert_allclose(boxes[0, 3, 5, 2:],
                               sig[0, 3, 5, 2:] ** 2 * [96, 160], rtol=1e-6)


class _FixedMaps(torch.nn.Module):
    """A model whose forward returns fixed raw maps (the detect builder's
    chain after the forward, on identical inputs in both packages)."""

    def __init__(self, maps):
        super().__init__()
        self.maps = [torch.from_numpy(m) for m in maps]

    def forward(self, x):
        return tuple(self.maps)


class _JaxFixedMaps:
    dtype = jnp.float32

    def __init__(self, maps):
        self.maps = [jnp.asarray(m) for m in maps]

    def apply(self, variables, x, train=False):
        return tuple(self.maps)


@pytest.mark.parametrize("conf,max_nms", [(0.3, 128), (0.01, 1024),
                                          (0.3, 16)])
def test_detect_fn_matches_jax_on_the_same_maps(conf, max_nms):
    maps = _raw_maps(int(conf * 100) + max_nms, b=3)
    kw = dict(conf_thres=conf, iou_thres=0.45, max_nms=max_nms)
    images = np.zeros((3, 160, 96, 3), np.uint8)
    jdets, jcounts = jaf.build_anchorfree_detect_fn(
        _JaxFixedMaps(maps), (160, 96), **kw)(None, jnp.asarray(images))
    dets, counts = af.build_anchorfree_detect_fn(
        _FixedMaps(maps), (160, 96), device="cpu", **kw)(
            torch.from_numpy(images))
    jdets, jcounts = np.asarray(jdets), np.asarray(jcounts)
    dets, counts = dets.numpy(), counts.numpy()
    assert dets.shape == jdets.shape == (3, 300, 6)
    np.testing.assert_array_equal(counts, jcounts)
    assert counts.min() > 0
    np.testing.assert_array_equal(dets[..., 5], jdets[..., 5])
    np.testing.assert_allclose(dets[..., 4], jdets[..., 4], rtol=0,
                               atol=SCORE_ATOL)
    assert box_ulps(dets[..., :4], jdets[..., :4]).max() <= BOX_ULPS_XLA


def _assert_same_detections(got, want):
    """Per image: (n, 6) rows with equal counts and classes, scores within
    1e-4 and boxes within 1e-2 px."""
    assert len(got) == len(want)
    for d, j in zip(got, want):
        assert d.shape == j.shape
        np.testing.assert_array_equal(d[:, 5], j[:, 5])
        np.testing.assert_allclose(d[:, 4], j[:, 4], rtol=0, atol=1e-4)
        np.testing.assert_allclose(d[:, :4], j[:, :4], rtol=0, atol=1e-2)


def _rows(dets, counts):
    dets, counts = np.asarray(dets), np.asarray(counts)
    return [dets[i, :counts[i]] for i in range(len(counts))]


@pytest.mark.parametrize("size", list(SIZES))
def test_detect_fn_matches_jax_on_images(size):
    img = _images(size, b=4)
    kw = dict(conf_thres=0.3, iou_thres=0.45, max_nms=128)
    want = _rows(*jaf.build_anchorfree_detect_fn(
        jaf.AnchorFreeDetector(classes=3), SIZES[size], **kw)(
            jax.tree.map(jnp.asarray, _variables("synth")),
            jnp.asarray(img)))
    got = _rows(*af.build_anchorfree_detect_fn(
        _model("synth"), SIZES[size], device="cpu", **kw)(
            torch.from_numpy(img)))
    _assert_same_detections(got, want)
    assert sum(len(g) for g in got) > 0


# ---------------------------------------------------------------- golden

@functools.lru_cache(maxsize=None)
def _golden():
    with open(os.path.join(REPO, AF_GOLDEN)) as f:
        return json.load(f)


def test_make_sample_copy_is_bitwise():
    for seed in (0, 1234, 7):
        for size in (128, 96):
            a = make_sample(np.random.RandomState(seed), size)
            b = tools_make_sample(np.random.RandomState(seed), size)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("path", ["plain", "fused"])
def test_golden_detections(path):
    g = _golden()
    img, labels = golden_image(g)
    np.testing.assert_allclose(labels, g["labels"], atol=1e-5)
    hw = (g["size"], g["size"])
    kw = dict(conf_thres=g["conf_thres"], iou_thres=g["iou_thres"],
              max_nms=g["max_nms"])
    if path == "plain":
        detect = af.build_anchorfree_detect_fn(_model("synth"), hw,
                                               device="cpu", **kw)
        dets, counts = detect(torch.from_numpy(img[None]))
    else:
        detect, packed = af.build_anchorfree_fused_detect(
            _state_dict("synth"), hw, device="cpu", **kw)
        dets, counts = detect(packed, torch.from_numpy(
            fused_infer.pack_images_s2d(img[None])))
    got = _rows(dets, counts)[0]
    assert golden_mismatches(got, g) == []
    assert golden_mismatches(got[1:], g) != []        # the rule can fail


# ---------------------------------------------------------------- fused

@pytest.mark.parametrize("which", ["synth", "init5"])
def test_pack_fused_weights_af_bitwise(which):
    """Every array both packings share bit for bit (the stem, the stride-2
    blocks, `fuse`, the heads and the output convs); the JAX package's
    span matrices (its odd-select ∘ pw1 `wa`, its dw3×3 ∘ pw2 `wc`) built
    from the port's split stride-1 convs, as
    tests/test_torch_fused_infer.py holds them for the yolo head."""
    jp = jfold.pack_fused_weights_af(_variables(which))
    pp = fold.pack_fused_weights_af(_state_dict(which))
    s1 = [f"s{sid}_{i}" for sid, reps, _ in fold.STAGES
          for i in range(1, reps)]
    shared = {k for k in jp if "_0f_" not in k
              and not any(k.startswith(p + "_") for p in s1)}
    assert shared == {k for k in pp
                      if not any(k.startswith(p + "_") for p in s1)}
    assert {"fuse_w", "head_cls_dw1_w", "head_reg_pw2_b",
            "out_cls_w", "out_reg_b"} <= shared
    for k in shared:
        assert pp[k].dtype == np.float32, k
        np.testing.assert_array_equal(pp[k], jp[k], err_msg=k)
    for prefix in s1:
        w1, b1, wd, bd, w2, b2 = (pp[f"{prefix}_{n}"] for n in
                                  ("w1", "b1", "wd", "bd", "w2", "b2"))
        mid = b1.shape[0]
        np.testing.assert_array_equal(jp[f"{prefix}_wa"][:mid, 1::2], w1.T)
        np.testing.assert_array_equal(jp[f"{prefix}_ba"][:mid], b1)
        for t in range(9):
            np.testing.assert_array_equal(
                jp[f"{prefix}_wc"][:, t * mid:(t + 1) * mid],
                w2.T * wd[t // 3, t % 3][None, :])
        np.testing.assert_array_equal(jp[f"{prefix}_bc"], w2.T @ bd + b2)


def _inputs(images, input_format):
    if input_format == "s2d_u8":
        return fused_infer.pack_images_s2d(images)
    if input_format == "s2d8_u8":
        return fused_infer.pack_images_s2d8(images)
    return images


COMBOS = list(itertools.product(fused_infer.INPUT_FORMATS, (False, True)))


@pytest.mark.parametrize("input_format,fuse_s2", [
    pytest.param(f, s, id=f"{f}-{'fuse_s2' if s else 'xla_s2'}")
    for f, s in COMBOS])
def test_fused_forward_matches_jax(input_format, fuse_s2):
    """All six combinations at 64×96 against JAX's fused forward and the
    port's nn model, the 5-class model initialised by JAX."""
    img = _images("64x96")
    x = _inputs(img, input_format)
    jfwd, jpacked = jfi.build_fused_forward(
        jax.tree.map(jnp.asarray, _variables("init5")), input_hw=(64, 96),
        dtype=jnp.float32, interpret=True, input_format=input_format,
        fuse_s2=fuse_s2, head="anchorfree")
    want = jfwd(jnp.asarray(x), jpacked)
    fwd, packed = fused_infer.build_fused_forward(
        _state_dict("init5"), input_hw=(64, 96), input_format=input_format,
        fuse_s2=fuse_s2, head="anchorfree", device="cpu")
    kernels = (fused_infer.stem_s2d, fused_infer.stem_s2d8,
               fused_infer.span, fused_infer.s2span)
    before = [k.launches for k in kernels]
    with torch.inference_mode():
        got = fwd(torch.from_numpy(x), packed)
        nn_maps = _model("init5")(torch.from_numpy(img).float() / 255.0)
    assert [k.launches for k in kernels] == before       # CPU: no kernel
    assert len(got) == len(want) == 3
    for g, j, n in zip(got, want, nn_maps):
        assert g.dtype == torch.float32 and g.shape == n.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(g.numpy(), n.numpy(), rtol=0, atol=ATOL)


def test_fused_forward_rejects_unknown_head():
    with pytest.raises(ValueError, match="head"):
        fused_infer.build_fused_forward(_state_dict("synth"),
                                        head="centernet", device="cpu")


def _cfg(size, nc=3):
    h, w = SIZES[size]
    return {"classes": nc, "width": w, "height": h, "anchor_num": 3,
            "anchors": [10.0, 10.0, 20.0, 20.0, 40.0, 40.0,
                        80.0, 80.0, 120.0, 120.0, 160.0, 160.0]}


@pytest.mark.parametrize("size", ["128x128", "160x96"])
def test_fused_pipeline_matches_jax(size):
    img = _images(size, b=3)
    want = JaxFusedPipeline(_variables("synth"),
                            JaxConfig.from_dict(_cfg(size)), conf_thres=0.3,
                            iou_thres=0.45, dtype=jnp.float32,
                            interpret=True, family="anchorfree")(img)
    pipe = FusedPipeline(_state_dict("synth"), Config.from_dict(_cfg(size)),
                         conf_thres=0.3, iou_thres=0.45, dtype=torch.float32,
                         device="cpu", family="anchorfree")
    got = pipe(img)
    _assert_same_detections(got, want)
    assert sum(len(g) for g in got) > 0
    # pre-packed input and `detect` on the packed tensor: the same rows
    packed = fused_infer.pack_images_s2d(img)
    for a, b in zip(pipe(packed), got):
        np.testing.assert_array_equal(a, b)
    dets, counts = pipe.detect(torch.from_numpy(packed))
    assert tuple(dets.shape) == (3, 300, 6)
    assert counts.tolist() == [len(g) for g in got]
    # and the nn path's detections
    nn = _rows(*af.build_anchorfree_detect_fn(
        _model("synth"), SIZES[size], device="cpu", conf_thres=0.3,
        iou_thres=0.45, max_nms=128)(torch.from_numpy(img)))
    _assert_same_detections(got, nn)
