"""The port's Detector (fastdet_torch/models) against JAX
`Detector.apply(train=False)` in f32: the same seeded inputs through both,
all six raw NHWC head outputs within 2e-4 (the JAX package's forward
contract; the two sides sum convolutions in different orders)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet.io.torch_convert import load_npz_variables
from fastdet.models import Detector as JaxDetector
from fastdet_torch import resolve_device
from fastdet_torch.io import from_jax_variables
from fastdet_torch.models import Detector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_NPZ = os.path.join(REPO, "weights", "coco2017-ref.npz")
ATOL = 2e-4


def _compare(jax_model, variables, port, x):
    jout = jax_model.apply(jax.tree.map(jnp.asarray, variables),
                           jnp.asarray(x), train=False)
    port.load_state_dict(from_jax_variables(variables))
    port.eval()
    with torch.no_grad():
        tout = port(torch.from_numpy(x))
    assert len(tout) == 6
    for j, t in zip(jout, tout):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=ATOL)
    return tout


def test_ref_weights_352_batch2():
    variables = load_npz_variables(REF_NPZ)
    x = (np.random.default_rng(0).integers(0, 256, (2, 352, 352, 3))
         .astype(np.float32) / np.float32(255.0))
    out = _compare(JaxDetector(classes=80, anchor_num=3), variables,
                   Detector(80, 3), x)
    assert [tuple(o.shape) for o in out] == [
        (2, 22, 22, 12), (2, 22, 22, 3), (2, 22, 22, 80),
        (2, 11, 11, 12), (2, 11, 11, 3), (2, 11, 11, 80)]


def test_small_width_random_init():
    """Random init with perturbed BN statistics, so that every BN and the
    channel split/concat order matter."""
    widths = (-1, 8, 16, 32, 64)
    jm = JaxDetector(classes=5, anchor_num=3, out_depth=16,
                     stage_out_channels=widths)
    v = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)), train=False))
    rng = np.random.default_rng(1)

    def perturb(tree):
        out = {}
        for k, a in tree.items():
            if isinstance(a, dict):
                out[k] = perturb(a)
            elif k == "mean":
                out[k] = rng.normal(0, 0.2, a.shape).astype(np.float32)
            else:
                out[k] = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return out

    v = {"params": v["params"], "batch_stats": perturb(v["batch_stats"])}
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    _compare(jm, v, Detector(5, 3, 16, widths), x)


def test_training_mode_raises():
    m = Detector(5, 3, 16, (-1, 8, 16, 32, 64)).train()
    with pytest.raises(NotImplementedError):
        m(torch.zeros(1, 64, 64, 3))


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
