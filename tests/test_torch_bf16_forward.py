"""The port's bf16 serving path as a whole (`build_fused_forward(dtype=
torch.bfloat16)`, `FusedPipeline(dtype=None)`, the serve CLI's choice of
dtype) against the JAX package's bf16 on the CPU, with the real weights
`weights/coco2017-ref.npz` and the anchor-free family's trained
`weights/anchorfree-synth.npz`.  The JAX side runs its Pallas kernels in
interpret mode; the port's bf16 kernels run their plain versions.

Tolerances:
  * the whole forward: each map within 2⁻⁵ of its max |value|.  bf16
    rounds ~20 layers deep, and a one-ULP flip in an f32 sum of another
    order grows through them: the JAX package's own three bf16 paths
    (nhwc, s2d_u8, fuse_s2) differ among themselves by up to 4.9% of a
    map's max |value|;
  * detections: the JAX package's bf16 serving contract
    (tests/test_postprocess.py::test_golden_image_bf16_serving): the same
    count and classes, boxes within 4 px, scores within 0.05, against
    JAX's bf16 `FusedPipeline` and against the port's own f32 pipeline;
    rows are paired by class, box and score, since two scores within 0.05
    may rank in either order (the photo's two persons do).
"""

import functools
import itertools
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet.config import Config as JaxConfig
from fastdet.io.torch_convert import load_npz_variables
from fastdet.kernels import fused_infer as jfi
from fastdet.serve import FusedPipeline as JaxFusedPipeline
from fastdet_torch.cli import evaluation as eval_cli
from fastdet_torch.cli import serve as serve_cli
from fastdet_torch.config import Config
from fastdet_torch.io import from_jax_variables
from fastdet_torch.kernels import fused_infer
from fastdet_torch.serve import FusedPipeline
from torch_cases import assert_bf16_serving_contract, make_sample

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "coco.data")
WEIGHTS = {"yolo": os.path.join(REPO, "weights", "coco2017-ref.npz"),
           "anchorfree": os.path.join(REPO, "weights",
                                      "anchorfree-synth.npz")}
MAP_RTOL = 2.0 ** -5
HW = (128, 128)
BF16_KERNELS = (fused_infer.stem_s2d_bf16, fused_infer.stem_s2d8_bf16,
                fused_infer.span_bf16, fused_infer.s2span_bf16)


@functools.lru_cache(maxsize=None)
def _variables(head):
    return load_npz_variables(WEIGHTS[head])


@functools.lru_cache(maxsize=None)
def _state_dict(head):
    return from_jax_variables(_variables(head))


def _inputs(images, input_format):
    if input_format == "s2d_u8":
        return fused_infer.pack_images_s2d(images)
    if input_format == "s2d8_u8":
        return fused_infer.pack_images_s2d8(images)
    return images


def _images(head):
    """yolo: seeded noise; anchor-free: two samples of its synthetic task
    (the checkpoint detects their rectangles)."""
    if head == "yolo":
        return np.random.default_rng(11).integers(0, 256, (2,) + HW + (3,),
                                                  dtype=np.uint8)
    rng = np.random.RandomState(5)
    return np.stack([make_sample(rng, HW[0])[0] for _ in range(2)])


CASES = [pytest.param(f, s, h, id=f"{h}-{f}-{'fuse_s2' if s else 'xla_s2'}")
         for h in ("yolo", "anchorfree")
         for f, s in itertools.product(fused_infer.INPUT_FORMATS,
                                       (False, True))]


@pytest.mark.parametrize("input_format,fuse_s2,head", CASES)
def test_bf16_forward_matches_jax(input_format, fuse_s2, head):
    x = _inputs(_images(head), input_format)
    jfwd, jpacked = jfi.build_fused_forward(
        jax.tree.map(jnp.asarray, _variables(head)), input_hw=HW,
        dtype=jnp.bfloat16, interpret=True, input_format=input_format,
        fuse_s2=fuse_s2, head=head)
    want = jfwd(jnp.asarray(x), jpacked)
    fwd, packed = fused_infer.build_fused_forward(
        _state_dict(head), input_hw=HW, dtype=torch.bfloat16,
        input_format=input_format, fuse_s2=fuse_s2, head=head, device="cpu")
    before = [k.launches for k in BF16_KERNELS]
    with torch.inference_mode():
        got = fwd(torch.from_numpy(x), packed)
    assert [k.launches for k in BF16_KERNELS] == before  # CPU: no kernel
    assert len(got) == len(want) == (6 if head == "yolo" else 3)
    for g, j in zip(got, want):
        j = np.asarray(j)
        assert g.dtype == torch.float32 and j.dtype == np.float32
        assert tuple(g.shape) == j.shape
        err = float(np.abs(g.numpy() - j).max())
        assert err <= MAP_RTOL * float(np.abs(j).max()), err


@pytest.mark.parametrize("upto", ["stem", "s2", "s3", "s4"])
def test_bf16_forward_upto_returns_bf16_maps(upto):
    fwd, packed = fused_infer.build_fused_forward(
        _state_dict("yolo"), input_hw=HW, dtype=torch.bfloat16, upto=upto,
        device="cpu")
    out = fwd(torch.from_numpy(_inputs(_images("yolo"), "s2d_u8")), packed)
    c = {"stem": 24, "s2": 48, "s3": 96, "s4": 192}[upto]
    k = {"stem": 4, "s2": 8, "s3": 16, "s4": 32}[upto]
    assert out.dtype == torch.bfloat16
    assert tuple(out.shape) == (2, HW[0] // k, HW[1] // k, c)


def test_build_fused_forward_default_stays_f32():
    """A deliberate difference from the JAX package, whose default is bf16
    (ROADMAP §C): the port's `build_fused_forward` defaults to f32, and
    `FusedPipeline(dtype=None)` is where bf16 is the default."""
    _, packed = fused_infer.build_fused_forward(_state_dict("yolo"),
                                                input_hw=HW, device="cpu")
    assert packed["s2_span"].dtype == torch.float32
    assert "s2_span16" not in packed


# ---------------------------------------------------------------- serving

def _photo_batch():
    """The repo's photo at 352² and its mirror image (BGR)."""
    img = cv2.imread(os.path.join(REPO, "test_result.png"), cv2.IMREAD_COLOR)
    img = cv2.resize(img, (352, 352), interpolation=cv2.INTER_LINEAR)
    return np.stack([img, img[:, ::-1]])


def _af_cfg():
    return {"classes": 3, "width": HW[1], "height": HW[0], "anchor_num": 3,
            "anchors": [10.0, 10.0, 20.0, 20.0, 40.0, 40.0,
                        80.0, 80.0, 120.0, 120.0, 160.0, 160.0]}


@pytest.mark.parametrize("family", ["yolo-fastestv2", "anchorfree"])
def test_fused_pipeline_bf16_default_matches_jax_and_f32(family):
    """FusedPipeline(dtype=None) is bf16 in both packages: the port's
    detections against JAX's bf16 FusedPipeline and against the port's
    f32 pipeline, the yolo family on the photo at 352², the anchor-free
    family on two samples of its task at 128²."""
    if family == "anchorfree":
        head, images = "anchorfree", _images("anchorfree")
        jcfg, cfg = (JaxConfig.from_dict(_af_cfg()),
                     Config.from_dict(_af_cfg()))
    else:
        head, images = "yolo", _photo_batch()
        jcfg, cfg = JaxConfig.from_file(DATA), Config.from_file(DATA)
    want = JaxFusedPipeline(_variables(head), jcfg, interpret=True,
                            family=family)(images)
    pipe = FusedPipeline(_state_dict(head), cfg, device="cpu",
                         family=family)
    assert pipe.dtype == torch.bfloat16
    got = pipe(images)
    assert_bf16_serving_contract(got, want)
    f32 = FusedPipeline(_state_dict(head), cfg, dtype=torch.float32,
                        device="cpu", family=family)(images)
    assert_bf16_serving_contract(got, f32)


@pytest.mark.parametrize("device,dtype", [("cuda", torch.bfloat16),
                                          ("cpu", torch.float32)])
def test_serve_cli_serves_bf16_on_the_card_f32_on_the_cpu(monkeypatch,
                                                          device, dtype):
    """The JAX CLI serves bf16 on its accelerator and f32 elsewhere
    (cli/serve.py); the port's CLI chooses by --device.  The pipeline is
    recorded and the run stopped before any weights reach a device."""
    seen = {}

    class Stop(Exception):
        pass

    def fake_pipeline(*args, **kwargs):
        seen.update(kwargs)
        raise Stop

    import fastdet_torch.serve
    monkeypatch.setattr(fastdet_torch.serve, "FusedPipeline", fake_pipeline)
    with pytest.raises(Stop):
        serve_cli.main(["--data", DATA, "--weights", WEIGHTS["yolo"],
                        "--device", device])
    assert seen["dtype"] == dtype and seen["device"] == device


def test_evaluation_fused_pass_stays_f32(monkeypatch):
    """The eval entry point's fused pass is f32, as the JAX eval CLI's
    ("eval-grade precision"), whatever serving defaults to."""
    seen = {}

    class Stop(Exception):
        pass

    def fake_build(*args, **kwargs):
        seen.update(kwargs)
        raise Stop

    monkeypatch.setattr(eval_cli, "build_fused_forward", fake_build)
    with pytest.raises(Stop):
        eval_cli.run_evaluation(Config.from_file(DATA), _state_dict("yolo"),
                                lambda b: iter(()), fused=True, device="cpu",
                                batch=2)
    assert seen["dtype"] == torch.float32
