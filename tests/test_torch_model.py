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
from fastdet_torch.models.layers import BatchNorm

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
    """Training mode no longer raises: BatchNorm normalises with the batch
    statistics and updates its running statistics as linen does
    (`apply(train=True, mutable=["batch_stats"])`, momentum 0.9, biased
    two-pass variance).  One BatchNorm: output and new running statistics
    within 1e-5.  The whole Detector from the real weights: the new
    running statistics within 1e-5, the outputs within the f32 forward
    contract (2e-4; batch statistics over the 18 samples a channel has
    at stage 4 here amplify the sums' rounding differences)."""
    from flax import linen as nn
    rng = np.random.default_rng(3)
    u = rng.normal(0.4, 2.0, (4, 5, 6, 16)).astype(np.float32)
    scale, bias, mean, var = (rng.uniform(0.5, 1.5, 16).astype(np.float32)
                              for _ in range(4))
    v = {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean, "var": var}}
    jy, jm = nn.BatchNorm(use_running_average=False, momentum=0.9,
                          epsilon=1e-5, use_fast_variance=False).apply(
        jax.tree.map(jnp.asarray, v), jnp.asarray(u),
        mutable=["batch_stats"])
    bn = BatchNorm(16).train()
    bn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean),
                        "running_var": torch.from_numpy(var)})
    ty = bn(torch.from_numpy(u).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=0, atol=1e-5)
    for k, name in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(jm["batch_stats"][k]),
                                   rtol=0, atol=1e-5)

    variables = load_npz_variables(REF_NPZ)
    x = (np.random.default_rng(2).integers(0, 256, (2, 96, 96, 3))
         .astype(np.float32) / np.float32(255.0))
    jout, mut = JaxDetector(classes=80, anchor_num=3).apply(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x), train=True,
        mutable=["batch_stats"])
    port = Detector(80, 3)
    port.load_state_dict(from_jax_variables(variables))
    port.train()
    tout = port(torch.from_numpy(x))
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=0, atol=ATOL)
    want = from_jax_variables({"batch_stats": jax.tree.map(
        np.asarray, mut["batch_stats"])})
    got = port.state_dict()
    assert want
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
