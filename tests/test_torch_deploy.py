"""The deploy forward (`Detector(deploy=True)`: the two per-scale NHWC maps
cat[σ(reg), σ(obj), softmax(cls)]) and `DevicePipeline` over a bf16
`Detector`, against the JAX package on the CPU with the reference weights
`weights/coco2017-ref.npz`.

Tolerances:
  * f32 maps: 2e-4 (absolute; every value lies in [0, 1]), the port's
    f32 forward tolerance; XLA's and PyTorch's convs sum in other orders;
  * bf16 maps: 2⁻⁵, the bf16 forward tests' bound on the logits'
    max |value| (tests/test_torch_bf16_forward.py): bf16 rounds ~20
    layers deep, and σ and softmax move a logit's error by at most 1/4
    and 1/2 of it;
  * bf16 detections: the JAX package's bf16 serving contract
    (tests/test_postprocess.py:268-285), the same count and classes, boxes
    within 4 px and scores within 0.05: on the photo and its mirror
    against JAX's bf16 detect, and on the photo, where the JAX test states
    it, against the port's f32 pipeline.  On the mirror the port's bf16
    moves one low-score box more than 4 px from f32 (JAX's bf16 less):
    a tall box, whose edges follow a small change of its height logit.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet.config import Config as JaxConfig
from fastdet.io.torch_convert import load_npz_variables
from fastdet.models import Detector as JaxDetector
from fastdet.serve import DevicePipeline as JaxDevicePipeline
from fastdet_torch.config import Config
from fastdet_torch.io import load_state_dict
from fastdet_torch.models import Detector
from fastdet_torch.models.layers import deploy_maps
from fastdet_torch.serve import DevicePipeline
from torch_cases import (assert_bf16_serving_contract, few_torch_threads,
                         photo_crops, photo_pair)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "coco.data")
WEIGHTS = os.path.join(REPO, "weights", "coco2017-ref.npz")
F32_ATOL = 2e-4
BF16_ATOL = 2.0 ** -5
BF16 = torch.bfloat16


@functools.lru_cache(maxsize=None)
def _variables():
    return jax.tree.map(jnp.asarray, load_npz_variables(WEIGHTS))


def _port(dtype=torch.float32):
    model = Detector(80, 3, dtype=dtype)
    model.load_state_dict(load_state_dict(WEIGHTS))
    return model.eval()


def _jax_deploy(images, dtype):
    x = jnp.asarray(images, jnp.float32) / 255.0
    return [np.asarray(m, np.float32) for m in JaxDetector(80, 3, dtype=dtype)
            .apply(_variables(), x, train=False, deploy=True)]


def _port_deploy(images, dtype):
    with few_torch_threads(), torch.no_grad():
        return _port(dtype)(torch.from_numpy(images).float() / 255.0,
                            deploy=True)


@pytest.mark.parametrize("hw", [(64, 64), (96, 64)])
def test_deploy_maps_match_jax_f32(hw):
    images = photo_crops(2, hw, 5)
    want = _jax_deploy(images, jnp.float32)
    got = _port_deploy(images, torch.float32)
    assert len(got) == 2
    for g, j, stride in zip(got, want, (16, 32)):
        assert g.dtype == torch.float32
        assert tuple(g.shape) == j.shape == (2, hw[0] // stride,
                                             hw[1] // stride, 95)
        err = float(np.abs(g.numpy() - j).max())
        assert err <= F32_ATOL, err


@pytest.mark.parametrize("hw", [(64, 64), (96, 64)])
def test_deploy_maps_match_jax_bf16(hw):
    images = photo_crops(2, hw, 6)
    want = _jax_deploy(images, jnp.bfloat16)
    got = _port_deploy(images, BF16)
    for g, j in zip(got, want):
        assert g.dtype == BF16 and tuple(g.shape) == j.shape
        err = float(np.abs(g.float().numpy() - j).max())
        assert err <= BF16_ATOL, err


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_deploy_is_the_bake_of_the_raw_outputs(dtype):
    """deploy=True is `deploy_maps` of the training/eval outputs, per
    scale, bit for bit; each cell's class probabilities sum to 1."""
    images = photo_crops(2, (64, 96), 7)
    x = torch.from_numpy(images).float() / 255.0
    with few_torch_threads(), torch.no_grad():
        model = _port(dtype)
        raw = model(x)
        maps = model(x, deploy=True)
    for m, (reg, obj, cls) in zip(maps, (raw[:3], raw[3:])):
        assert torch.equal(m, deploy_maps(reg, obj, cls))
        s = m[..., 15:].float().sum(-1)
        tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
        assert float((s - 1).abs().max()) <= tol


def test_bf16_device_pipeline_matches_jax_and_f32():
    """`DevicePipeline(Detector(dtype=bfloat16))` at 352² under the JAX
    package's bf16 serving contract: on the photo and its mirror against
    JAX's DevicePipeline over its bf16 Detector (`build_detect_fn(dtype=
    bf16)`), on the photo against the port's f32 pipeline."""
    images = photo_pair()
    jcfg = JaxConfig.from_file(DATA)
    want = JaxDevicePipeline(JaxDetector(80, 3, dtype=jnp.bfloat16),
                             _variables(), jcfg)(images)
    cfg = Config.from_file(DATA)
    with few_torch_threads():
        got = DevicePipeline(Detector(80, 3, dtype=BF16),
                             load_state_dict(WEIGHTS), cfg,
                             device="cpu")(images)
        f32 = DevicePipeline(Detector(80, 3), load_state_dict(WEIGHTS), cfg,
                             device="cpu")(images)
    assert all(len(d) > 0 for d in got)
    assert_bf16_serving_contract(got, want)
    assert_bf16_serving_contract(got[:1], f32[:1])
