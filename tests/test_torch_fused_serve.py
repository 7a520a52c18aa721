"""The port's `FusedPipeline` on the CPU: against the JAX `FusedPipeline`
(f32, Pallas in interpret mode) and against the port's own
`DevicePipeline` on the repo's photo, its input forms and the options it
refuses, and `--pipeline fused` in the port's serving CLI.

Pipeline tolerance, as in tests/test_torch_serve.py: the same detections
(count, order, class), scores within 1e-4 and boxes within 1e-2 px.  The
forwards agree within 2e-4 on the logits (tests/test_torch_fused_infer.py),
and that difference reaches the outputs through the sigmoids and the
(2s)²·anchor box size.
"""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet.config import Config as JaxConfig
from fastdet.io.torch_convert import load_npz_variables
from fastdet.kernels.fused_infer import pack_images_s2d as jax_pack
from fastdet.serve import FusedPipeline as JaxFusedPipeline
from fastdet_torch.cli import serve as serve_cli
from fastdet_torch.config import Config
from fastdet_torch.io import load_state_dict
from fastdet_torch.kernels.fused_infer import pack_images_s2d
from fastdet_torch.models import Detector
from fastdet_torch.serve import DevicePipeline, FusedPipeline
from fastdet_torch.server import InferenceServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "coco.data")
REF_NPZ = os.path.join(REPO, "weights", "coco2017-ref.npz")


@pytest.fixture(scope="module")
def images():
    """The repo's photo (BGR) at 352² and its mirror image."""
    img = cv2.imread(os.path.join(REPO, "test_result.png"), cv2.IMREAD_COLOR)
    img = cv2.resize(img, (352, 352), interpolation=cv2.INTER_LINEAR)
    return np.stack([img, img[:, ::-1]])


@pytest.fixture(scope="module")
def sd():
    return load_state_dict(REF_NPZ)


def _assert_same_detections(got, want):
    assert len(got) == len(want)
    for d, j in zip(got, want):
        assert d.shape == j.shape and len(d) > 0
        np.testing.assert_array_equal(d[:, 5], j[:, 5])
        np.testing.assert_allclose(d[:, 4], j[:, 4], rtol=0, atol=1e-4)
        np.testing.assert_allclose(d[:, :4], j[:, :4], rtol=0, atol=1e-2)


@pytest.mark.parametrize("conf", [0.01, 0.3])
def test_fused_pipeline_matches_jax(images, sd, conf):
    jax_pipe = JaxFusedPipeline(load_npz_variables(REF_NPZ),
                                JaxConfig.from_file(DATA), conf_thres=conf,
                                dtype=jnp.float32, interpret=True)
    want = jax_pipe(np.asarray(jax_pack(images)))       # pre-packed
    got = FusedPipeline(sd, Config.from_file(DATA), conf_thres=conf,
                        dtype=torch.float32,
                        device="cpu")(images)            # NHWC, host-packed
    _assert_same_detections(got, want)


def test_fused_pipeline_matches_device_pipeline(images, sd):
    cfg = Config.from_file(DATA)
    fused = FusedPipeline(sd, cfg, dtype=torch.float32, device="cpu")
    device = DevicePipeline(Detector(80, 3), sd, cfg, device="cpu")
    _assert_same_detections(fused(images), device(images))


def test_fused_pipeline_input_forms(images, sd):
    """NHWC and pre-packed input give the same rows; `detect` takes the
    packed tensor and returns padded device tensors."""
    pipe = FusedPipeline(sd, Config.from_file(DATA), dtype=torch.float32,
                         device="cpu")
    packed = pack_images_s2d(images)
    a, b = pipe(images), pipe(packed)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    dets, counts = pipe.detect(torch.from_numpy(packed))
    assert tuple(dets.shape) == (2, 300, 6)
    assert counts.tolist() == [len(x) for x in a]


@pytest.mark.parametrize("kwargs,match", [
    ({"dtype": torch.float16}, "float16"),
    ({"dtype": torch.float64}, "float64"),
])
def test_fused_pipeline_unported_options_raise(sd, kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        FusedPipeline(sd, Config.from_file(DATA), device="cpu", **kwargs)


def test_fused_pipeline_from_files_raises(sd):
    pipe = FusedPipeline(sd, Config.from_file(DATA), dtype=torch.float32,
                         device="cpu")
    with pytest.raises(NotImplementedError, match="decoder"):
        pipe.from_files([os.path.join(REPO, "test_result.png")])


def test_fused_pipeline_requires_card_unless_cpu(sd, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedPipeline(sd, Config.from_file(DATA))


@pytest.mark.parametrize("argv,cls", [
    ([], FusedPipeline),                                # the default
    (["--pipeline", "fused"], FusedPipeline),
    (["--pipeline", "device"], DevicePipeline),
])
def test_cli_serves_the_chosen_pipeline(monkeypatch, images, argv, cls):
    """The CLI builds the pipeline, warms each batch bucket and hands it to
    the server, whose HTTP loop is replaced here by one raw request."""
    served = []

    def serve_once(self, host, port, quiet=False):
        try:
            served.append((self._pipe, self.detect_raw(
                images[0].tobytes(), 352, 352)))
        finally:
            self.shutdown()

    monkeypatch.setattr(InferenceServer, "serve_forever", serve_once)
    args = ["--data", DATA, "--weights", REF_NPZ, "--device", "cpu",
            "--batch", "2"]
    assert serve_cli.main(args + argv) == 0
    (pipe, answer), = served
    assert isinstance(pipe, cls)
    rows = pipe(images[:1])[0]
    assert answer["count"] == len(rows) > 0
    assert [d["class_id"] for d in answer["detections"]] == \
        rows[:, 5].astype(int).tolist()
