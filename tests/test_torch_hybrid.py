"""The host half of serving on the CPU: the port's C++ host postprocess
(`fastdet_torch.native.postprocess`, its copy of csrc/postprocess.cc)
bit for bit against the JAX package's `fastdet.native.postprocess`;
`HybridPipeline` against JAX's and against the port's `DevicePipeline`;
`StreamingPipeline` over the port's pipelines against their direct
calls.

Tolerances: `HybridPipeline` is held to the JAX package's own contract
(tests/test_native.py::test_hybrid_pipeline): the same counts, the first
five columns within 1e-2.  Everything else is bit for bit.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet import native as jax_native
from fastdet.config import Config as JaxConfig
from fastdet.io.torch_convert import load_npz_variables
from fastdet.models import Detector as JaxDetector
from fastdet.serve import HybridPipeline as JaxHybridPipeline
from fastdet_torch import native
from fastdet_torch.config import Config
from fastdet_torch.io import load_state_dict
from fastdet_torch.models import Detector
from fastdet_torch.serve import (DevicePipeline, FusedPipeline,
                                 HybridPipeline, StreamingPipeline)
from torch_cases import few_torch_threads, photo_crops, photo_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "coco.data")
WEIGHTS = os.path.join(REPO, "weights", "coco2017-ref.npz")
ANCHORS = np.asarray(Config.from_file(DATA).anchors, np.float32)
# (conf_thres, iou_thres, max_det)
SETTINGS = ((0.3, 0.45, 300), (0.05, 0.6, 40))


def _bits(dets):
    return [d.view(np.uint32) for d in dets]


def _same_bits(got, want):
    assert len(got) == len(want)
    for g, w in zip(_bits(got), _bits(want)):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def photo_maps():
    """The reference weights' f32 deploy maps of four photo crops at
    352²."""
    model = Detector(80, 3)
    model.load_state_dict(load_state_dict(WEIGHTS))
    x = torch.from_numpy(photo_crops(4, (352, 352), 11)).float() / 255.0
    with few_torch_threads(), torch.no_grad():
        return [m.numpy() for m in model.eval()(x, deploy=True)]


def _dense_maps(seed):
    """Seeded (3, 22, 22, 95) and (3, 11, 11, 95) maps in [0, 1): obj
    high everywhere and peaked class probabilities, so that hundreds of
    candidates pass the threshold, NMS removes some and the max_det cap
    cuts the rest."""
    rng = np.random.default_rng(seed)
    maps = []
    for h in (22, 11):
        m = rng.random((3, h, h, 95), dtype=np.float32)
        m[..., 12:15] = 0.5 + 0.5 * m[..., 12:15]
        m[..., 15:] = rng.dirichlet(np.full(80, 0.05), (3, h, h))
        maps.append(m.astype(np.float32))
    return maps


@pytest.mark.parametrize("conf,iou,max_det", SETTINGS)
def test_host_postprocess_bitwise_jax_on_photo_maps(photo_maps, conf, iou,
                                                    max_det):
    kw = dict(conf_thres=conf, iou_thres=iou, max_det=max_det)
    got = native.postprocess(*photo_maps, ANCHORS, (352, 352), **kw)
    want = jax_native.postprocess(*photo_maps, ANCHORS, (352, 352), **kw)
    assert sum(len(d) for d in got) > 0
    _same_bits(got, want)


@pytest.mark.parametrize("conf,iou,max_det", SETTINGS)
def test_host_postprocess_bitwise_jax_on_dense_maps(conf, iou, max_det):
    s16, s32 = _dense_maps(int(conf * 100))
    kw = dict(conf_thres=conf, iou_thres=iou, max_det=max_det)
    got = native.postprocess(s16, s32, ANCHORS, (352, 352), **kw)
    want = jax_native.postprocess(s16, s32, ANCHORS, (352, 352), **kw)
    _same_bits(got, want)
    # both act on every image: NMS removes candidates, and more survive it
    # than the max_det cap keeps
    uncapped, no_nms = (native.postprocess(
        s16, s32, ANCHORS, (352, 352), conf_thres=conf, iou_thres=i,
        max_det=100000) for i in (iou, 1.0))
    for d, u, n in zip(got, uncapped, no_nms):
        assert len(d) == max_det < len(u) < len(n)


def test_host_postprocess_builds_without_image_libraries():
    """The port's library is its own source, built without -ljpeg -lpng:
    it exports the postprocess and none of the JAX runtime's decoders."""
    lib = native._load()
    assert lib.fd_version() == 2
    assert "-ljpeg" not in native.CXX_FLAGS and "-lpng" not in native.CXX_FLAGS
    for name in ("fd_preprocess_batch", "fd_pack_s2d"):
        with pytest.raises(AttributeError):
            getattr(lib, name)


@pytest.fixture(scope="module")
def photo_batch():
    return photo_pair()


def test_hybrid_pipeline_matches_jax_and_device_pipeline(photo_batch):
    cfg = Config.from_file(DATA)
    variables = jax.tree.map(jnp.asarray, load_npz_variables(WEIGHTS))
    want = JaxHybridPipeline(JaxDetector(80, 3), variables,
                             JaxConfig.from_file(DATA), conf_thres=0.3,
                             iou_thres=0.4)(photo_batch)
    with few_torch_threads():
        got = HybridPipeline(Detector(80, 3), load_state_dict(WEIGHTS), cfg,
                             conf_thres=0.3, iou_thres=0.4,
                             device="cpu")(photo_batch)
        dev = DevicePipeline(Detector(80, 3), load_state_dict(WEIGHTS), cfg,
                             conf_thres=0.3, iou_thres=0.4,
                             device="cpu")(photo_batch)
    for g, w, d in zip(got, want, dev):
        assert len(g) == len(w) == len(d) > 0
        np.testing.assert_allclose(g[:, :5], w[:, :5], atol=1e-2)
        np.testing.assert_allclose(g[:, :5], d[:, :5], atol=1e-2)
        np.testing.assert_array_equal(g[:, 5], d[:, 5])


def test_hybrid_pipeline_is_deploy_then_host_postprocess(photo_batch):
    """`__call__` = `deploy` on the device, the maps as f32 on the host,
    `host_postprocess`: bit for bit, bf16 model too."""
    cfg = Config.from_file(DATA)
    for dtype in (torch.float32, torch.bfloat16):
        with few_torch_threads():
            pipe = HybridPipeline(Detector(80, 3, dtype=dtype),
                                  load_state_dict(WEIGHTS), cfg,
                                  device="cpu")
            got = pipe(photo_batch)
            maps = pipe.deploy(torch.from_numpy(photo_batch))
        assert all(m.dtype == dtype for m in maps)
        want = native.postprocess(*(m.float().numpy() for m in maps),
                                  ANCHORS, (352, 352))
        _same_bits(got, want)


def _small_cfg():
    return dataclasses.replace(Config.from_file(DATA), width=128,
                               height=128)


def _pipes():
    cfg, sd = _small_cfg(), load_state_dict(WEIGHTS)
    return {"device": DevicePipeline(Detector(80, 3), sd, cfg,
                                     conf_thres=0.05, device="cpu"),
            "fused": FusedPipeline(sd, cfg, conf_thres=0.05, device="cpu"),
            "hybrid": HybridPipeline(Detector(80, 3), sd, cfg,
                                     conf_thres=0.05, device="cpu")}


@pytest.mark.parametrize("which", ["device", "fused", "hybrid"])
def test_streaming_run_equals_direct_calls(which):
    """5 frames at batch_size 2: three batches, the last padded with a
    zero frame; the per-frame detections in order, bit for bit those of
    the pipeline called on the same batches."""
    frames = photo_crops(5, (128, 128), 13)
    with few_torch_threads():
        pipe = _pipes()[which]
        got = StreamingPipeline(pipe, batch_size=2).run(iter(frames))
        tail = np.concatenate([frames[4:], np.zeros_like(frames[:1])])
        want = pipe(frames[0:2]) + pipe(frames[2:4]) + pipe(tail)[:1]
    assert len(got) == 5
    assert sum(len(d) for d in got) > 0
    _same_bits(got, want)


def test_streaming_run_files_names_the_missing_decoder():
    with few_torch_threads():
        pipes = _pipes()
    for pipe in (pipes["device"], pipes["fused"]):
        with pytest.raises(NotImplementedError, match="host image decoder"):
            StreamingPipeline(pipe, batch_size=2).run_files(
                [os.path.join(REPO, "test_result.png")] * 3)


def test_streaming_raises_the_failures_of_either_side():
    """A failing frame source and a failing pipeline both reach the
    caller; neither leaves the producer blocked."""
    def frames():
        yield np.zeros((8, 8, 3), np.uint8)
        raise ValueError("bad frame")

    with pytest.raises(ValueError, match="bad frame"):
        StreamingPipeline(lambda b: [b] * len(b), batch_size=1).run(frames())

    def broken(batch):
        raise RuntimeError("device lost")

    with pytest.raises(RuntimeError, match="device lost"):
        StreamingPipeline(broken, batch_size=1).run(
            np.zeros((6, 8, 8, 3), np.uint8))
