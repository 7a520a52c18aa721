"""Reference `.pth` weights in the port (`fastdet_torch/io/
torch_convert.py`, `io/weights.py::load_state_dict`) against the JAX
package's converter (`fastdet/io/torch_convert.py`) on the CPU.

The repository has no `.pth`: `torch_cases.reference_state_dict` builds
the reference's layout from `weights/coco2017-ref.npz` by the inverse of
JAX's map (with `num_batches_tracked` beside each BN, as torch writes
it), and the tests `torch.save` it to a tmp dir.  Loaded by the port, it
is bit for bit JAX's conversion carried across by `from_jax_variables`,
whole and `backbone_only`, and the `.npz`'s own state dict.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet.io import merge_variables as jax_merge
from fastdet.io.torch_convert import convert_state_dict as jax_convert
from fastdet.io.torch_convert import \
    convert_torch_checkpoint as jax_convert_checkpoint
from fastdet.io.torch_convert import load_npz_variables as jax_load_npz
from fastdet.io.torch_convert import load_torch_weights as jax_load_pth
from fastdet.models import Detector as JaxDetector
from fastdet_torch.io import (convert_state_dict, convert_torch_checkpoint,
                              from_jax_variables, load_state_dict,
                              load_torch_weights, merge_variables)
from fastdet_torch.models import Detector
from torch_cases import reference_state_dict, write_reference_pth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "coco2017-ref.npz")


@pytest.fixture(scope="module")
def pths(tmp_path_factory):
    root = tmp_path_factory.mktemp("pth")
    return {bb: str(write_reference_pth(WEIGHTS, root / f"ref{int(bb)}.pth",
                                        backbone_only=bb))
            for bb in (False, True)}


def same(a, b):
    return (list(a) == list(b) and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a))


def test_reference_state_dict_is_the_inverse_of_jax_map():
    """JAX's converter maps the test-side reference dict back onto the
    `.npz`'s tree exactly; the counters are what it drops."""
    sd = reference_state_dict(WEIGHTS)
    assert sum(k.endswith("num_batches_tracked") for k in sd) == 73
    tree = jax_convert({k: v.numpy() for k, v in sd.items()
                        if not k.endswith("num_batches_tracked")})
    want = jax_load_npz(WEIGHTS)
    got = jax.tree_util.tree_leaves_with_path(tree)
    ref = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got] == [p for p, _ in ref]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, ref))


@pytest.mark.parametrize("backbone_only", [False, True])
def test_load_torch_weights_is_jax_carried_across(pths, backbone_only):
    got = load_torch_weights(pths[backbone_only], backbone_only=backbone_only)
    want = from_jax_variables(jax_load_pth(pths[backbone_only],
                                           backbone_only=backbone_only))
    assert same(got, want)
    assert len(got) == (275 if backbone_only else 371)
    assert any(k.startswith("backbone.") for k in got) != backbone_only


def test_convert_state_dict_takes_numpy():
    sd = {k: v.numpy() for k, v in reference_state_dict(WEIGHTS).items()
          if not k.endswith("num_batches_tracked")}
    assert same(convert_state_dict(sd), from_jax_variables(jax_convert(sd)))


def test_pth_state_dict_equals_the_npz(pths):
    got = load_state_dict(pths[False])
    want = load_state_dict(WEIGHTS)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    model = Detector(80, 3)
    model.load_state_dict(got)                 # strict: every key, shape


@pytest.mark.parametrize("backbone_only", [False, True])
def test_convert_torch_checkpoint_writes_jax_npz(pths, tmp_path,
                                                 backbone_only):
    port = tmp_path / "port.npz"
    jaxf = tmp_path / "jax.npz"
    sd = convert_torch_checkpoint(pths[backbone_only], str(port),
                                  backbone_only=backbone_only)
    jax_convert_checkpoint(pths[backbone_only], str(jaxf),
                           backbone_only=backbone_only)
    with np.load(port) as a, np.load(jaxf) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert same(sd, load_state_dict(str(port)))


def test_load_state_dict_dispatch(pths, tmp_path):
    pt = tmp_path / "ref.pt"
    shutil.copy(pths[False], pt)
    want, got = load_state_dict(WEIGHTS), load_state_dict(str(pt))
    assert same(got, load_state_dict(pths[False]))
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="orbax"):
        load_state_dict(str(tmp_path))
    with pytest.raises(ValueError, match="unsupported"):
        load_state_dict(str(tmp_path / "weights.bin"))


@pytest.mark.parametrize("what", ["backbone_pth", "whole_pth_3_classes"])
def test_merge_count_is_jax(pths, what):
    """The train CLI's grafts: a backbone `.pth` (wrapped under
    ``backbone``) onto a fresh 80-class Detector, and a whole 80-class
    `.pth` onto a 3-class one (its heads keep the fresh init): the
    port's `merge_variables` loads as many tensors as JAX's, and keeps as
    many fresh."""
    classes, bb = (80, True) if what == "backbone_pth" else (3, False)
    jtree = jax_load_pth(pths[bb], backbone_only=bb)
    port = load_torch_weights(pths[bb], backbone_only=bb)
    if bb:
        jtree = {"params": {"backbone": jtree["params"]},
                 "batch_stats": {"backbone": jtree["batch_stats"]}}
        port = {"backbone." + k: v for k, v in port.items()}
    init = JaxDetector(classes=classes, anchor_num=3).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)
    _, n_jax, kept_jax = jax_merge(jax.device_get(init), jtree)
    fresh = Detector(classes, 3).state_dict()
    merged, n_port, kept_port = merge_variables(fresh, port)
    assert (n_port, kept_port) == (n_jax, kept_jax)
    assert n_port == (275 if bb else 371 - 2)        # output_cls differs
    assert all(torch.equal(merged[k], port[k]) for k in port
               if k in fresh and fresh[k].shape == port[k].shape)
