"""The port's weight carrier (fastdet_torch/io/weights.py) against the JAX
package's variable trees: the released `.npz` loads the same float count,
conv kernels change layout HWIO → OIHW, and the carrier round-trips."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet.io.torch_convert import load_npz_variables as jax_load_npz
from fastdet.models import Detector as JaxDetector
from fastdet_torch.io import (from_jax_variables, load_npz_variables,
                              load_state_dict, to_jax_variables)
from fastdet_torch.models import Detector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_NPZ = os.path.join(REPO, "weights", "coco2017-ref.npz")


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_ref_npz_float_count_and_keys():
    """251,664 reference floats minus the 73 num_batches_tracked scalars
    (tests/test_model_parity.py:61-68), and exactly the port's keys."""
    sd = load_state_dict(REF_NPZ)
    assert sum(t.numel() for t in sd.values()) == 251_664 - 73
    model_sd = Detector().state_dict()
    assert set(sd) == set(model_sd)
    for k, t in sd.items():
        assert t.dtype == torch.float32
        assert t.shape == model_sd[k].shape, k


def test_npz_loader_matches_jax_loader():
    ours = dict(_leaves(load_npz_variables(REF_NPZ)))
    theirs = dict(_leaves(jax_load_npz(REF_NPZ)))
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_conv_layouts():
    v = load_npz_variables(REF_NPZ)
    sd = from_jax_variables(v)
    p = v["params"]["backbone"]["stage2_0"]
    # regular 1×1 conv (kh, kw, in, out) → (out, in, kh, kw)
    np.testing.assert_array_equal(
        sd["backbone.stage2_0.main_pw.conv.weight"].numpy(),
        np.transpose(p["main_pw"]["conv"]["kernel"], (3, 2, 0, 1)))
    # depthwise (3, 3, 1, C) → (C, 1, 3, 3)
    dw = sd["backbone.stage2_0.main_dw.conv.weight"].numpy()
    assert dw.shape == (24, 1, 3, 3)
    np.testing.assert_array_equal(
        dw[5, 0], p["main_dw"]["conv"]["kernel"][:, :, 0, 5])
    # BN leaves and head biases
    s = v["batch_stats"]["backbone"]["first_conv"]["bn"]
    np.testing.assert_array_equal(
        sd["backbone.first_conv.bn.running_var"].numpy(), s["var"])
    np.testing.assert_array_equal(sd["output_cls.bias"].numpy(),
                                  v["params"]["output_cls"]["bias"])


def test_round_trip_ref_weights():
    v = load_npz_variables(REF_NPZ)
    back = to_jax_variables(from_jax_variables(v))
    a, b = dict(_leaves(v)), dict(_leaves(back))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("widths,classes", [
    ((-1, 8, 16, 32, 64), 5),
    ((-1, 24, 48, 96, 192), 80),
])
def test_random_init_tree_loads_strict(widths, classes):
    """A freshly initialised JAX tree of another width carries over with
    load_state_dict(strict=True) and round-trips."""
    model = JaxDetector(classes=classes, anchor_num=3, out_depth=16,
                        stage_out_channels=widths)
    v = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    port = Detector(classes, 3, 16, widths)
    port.load_state_dict(from_jax_variables(v), strict=True)
    back = dict(_leaves(to_jax_variables(port.state_dict())))
    for k, a in _leaves(v):
        np.testing.assert_array_equal(a, back[k])
