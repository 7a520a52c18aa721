"""`fastdet_torch.export` and `python -m fastdet_torch.cli.export` on the
CPU: the port of the JAX package's three export round trips
(tests/test_data_anchors_export.py:156-248; f32, int8 and int8
anchor-free at 64²), here bit for bit against the direct forward, and the
port's artifacts against the JAX package's StableHLO ones.

Tolerances against JAX's exported maps:
  * f32: 2e-4, the port's f32 forward tolerance (every value in [0, 1]);
  * int8: the integer chains are JAX's bit for bit, and each logit stands
    within 2 ULP of JAX's (tests/test_torch_quant.py); σ and softmax move
    a logit's error by at most 1/4 and 1/2 of it, so a map stands within
    one ULP of its scale's largest |logit|, plus 1e-6 for XLA's and
    PyTorch's f32 σ and softmax (tests/test_torch_postprocess.py).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet.export.stablehlo import load_exported as jax_load_exported
from fastdet_torch.export import (export_detector, export_quantized,
                                  load_exported)
from fastdet_torch.io import load_state_dict
from fastdet_torch.models import AnchorFreeDetector, Detector
from fastdet_torch.models.layers import deploy_maps
from fastdet_torch.quant import (calibrate, fold_model, forward_from,
                                 load_quantized, quantize_weights)
from torch_cases import few_torch_threads, photo_crops, run_beside

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "coco.data")
WEIGHTS = os.path.join(REPO, "weights", "coco2017-ref.npz")
INT8 = os.path.join(REPO, "weights", "coco-int8.npz")
F32_ATOL = 2e-4
EXPORTED = re.compile(r"^exported (\d+) bytes -> (.+)$", re.M)


def _seeded(model, seed):
    """`model` with torch's default init drawn from `seed`, in eval mode."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = model()
    return model.eval()


def _quantized(model, seed):
    rng = np.random.RandomState(seed)
    calib = rng.randint(0, 255, (4, 64, 64, 3), np.uint8)
    folded = fold_model(model.state_dict())
    scales = calibrate(folded, calib, batch=4, device="cpu")
    return quantize_weights(folded), scales


def _bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def test_export_roundtrip(tmp_path):
    """export → load → the direct deploy forward, bit for bit; the
    archive keeps no example input."""
    model = _seeded(lambda: Detector(classes=5, anchor_num=3), 0)
    out = str(tmp_path / "model.pt2")
    with few_torch_threads():
        blob = export_detector(model, model.state_dict(), out,
                               input_hw=(64, 64), batch=2, device="cpu")
        assert os.path.getsize(out) == len(blob) > 1000
        assert torch.export.load(out).example_inputs is None   # not stored
        call = load_exported(out, device="cpu")
        img = np.random.RandomState(0).randint(0, 255, (2, 64, 64, 3),
                                               np.uint8)
        got = call(img)
        with torch.no_grad():
            want = model(torch.from_numpy(img).float() / 255.0, deploy=True)
    assert [tuple(g.shape) for g in got] == [(2, 4, 4, 20), (2, 2, 2, 20)]
    _bitwise(got, want)


def test_export_quantized_roundtrip(tmp_path):
    """The int8 export → load → `forward_from`'s maps baked, bit for bit."""
    with few_torch_threads():
        qw, scales = _quantized(
            _seeded(lambda: Detector(classes=5, anchor_num=3), 1), 2)
        out = str(tmp_path / "model-int8.pt2")
        blob = export_quantized(qw, scales, out, input_hw=(64, 64), batch=2,
                                device="cpu")
        assert os.path.getsize(out) == len(blob) > 1000
        img = np.random.RandomState(3).randint(0, 255, (2, 64, 64, 3),
                                               np.uint8)
        got = load_exported(out, device="cpu")(img)
        raw = forward_from(qw, scales, device="cpu")(img)
    _bitwise(got, (deploy_maps(*raw[:3]), deploy_maps(*raw[3:])))


def test_export_quantized_anchorfree_roundtrip(tmp_path):
    """The anchor-free family's int8 export: one stride-16 map, ordered as
    `AnchorFreeDetector(deploy=True)`, the family read from the op
    names."""
    with few_torch_threads():
        qw, scales = _quantized(
            _seeded(lambda: AnchorFreeDetector(classes=5), 3), 4)
        out = str(tmp_path / "af-int8.pt2")
        export_quantized(qw, scales, out, input_hw=(64, 64), batch=2,
                         device="cpu")
        img = np.random.RandomState(5).randint(0, 255, (2, 64, 64, 3),
                                               np.uint8)
        got = load_exported(out, device="cpu")(img)
        obj, cls, reg = forward_from(qw, scales, device="cpu")(img)
    assert isinstance(got, torch.Tensor)
    assert tuple(got.shape) == (2, 4, 4, 10)
    _bitwise([got], [deploy_maps(reg, obj, cls)])


def test_exported_maps_match_jax_f32(tmp_path):
    """The port's and the JAX package's f32 artifacts of the reference
    weights on two photo crops at 64²."""
    import jax
    from fastdet.export.stablehlo import export_detector as jax_export
    from fastdet.io.torch_convert import load_npz_variables
    from fastdet.models import Detector as JaxDetector
    img = photo_crops(2, (64, 64), 9)
    jax_export(JaxDetector(80, 3),
               jax.tree.map(jnp.asarray, load_npz_variables(WEIGHTS)),
               str(tmp_path / "jax.stablehlo"), input_hw=(64, 64), batch=2)
    want = jax_load_exported(str(tmp_path / "jax.stablehlo"))(
        jnp.asarray(img))
    with few_torch_threads():
        export_detector(Detector(80, 3), load_state_dict(WEIGHTS),
                        str(tmp_path / "port.pt2"), input_hw=(64, 64),
                        batch=2, device="cpu")
        got = load_exported(str(tmp_path / "port.pt2"), device="cpu")(img)
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.asarray(w).shape
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) <= F32_ATOL


def _cli_bytes(stdout, path):
    m = EXPORTED.search(stdout)
    assert m, stdout
    assert m.group(2) == path
    assert int(m.group(1)) == os.path.getsize(path) > 1000


def int8_map_tol(images):
    """Per scale: one ULP of the largest |logit| of the port's int8 chain
    on `images` (half the chain's 2-ULP contract; σ' ≤ 1/4, softmax's
    Lipschitz bound 1/2) plus 1e-6."""
    raw = forward_from(*load_quantized(INT8), device="cpu")(images)
    return [float(np.spacing(np.float32(max(float(t.abs().max())
                                             for t in raw[i:i + 3]))))
            + 1e-6 for i in (0, 3)]


@pytest.mark.parametrize("int8", [False, True])
def test_export_cli_beside_jax(tmp_path, int8):
    """`python -m fastdet_torch.cli.export` beside `cli/export.py` on
    data/coco.data at --batch 1, from f32 weights (and --mlir) or from
    --int8 weights/coco-int8.npz: each prints `exported N bytes -> PATH`
    with N the file's size, and both artifacts run one photo crop at 352²
    to the same maps."""
    jax_out = str(tmp_path / "jax.stablehlo")
    port_out = str(tmp_path / "port.pt2")
    src = ["--int8", INT8] if int8 else ["--weights", WEIGHTS]
    common = ["--data", DATA, *src, "--batch", "1"]
    extra = [] if int8 else ["--mlir"]
    theirs, ours = run_beside("export.py", [*common, "--output", jax_out],
                              ("export", [*common, "--output", port_out,
                                          *extra]))
    _cli_bytes(theirs, jax_out)
    _cli_bytes(ours, port_out)
    if not int8:
        assert f"wrote {port_out}.graph.txt" in ours
        with open(port_out + ".graph.txt") as f:
            assert "ExportedProgram" in f.read()
    img = photo_crops(1, (352, 352), 10)
    want = jax_load_exported(jax_out)(jnp.asarray(img))
    with few_torch_threads():
        got = load_exported(port_out, device="cpu")(img)
        tols = int8_map_tol(img) if int8 else [F32_ATOL, F32_ATOL]
    for g, w, tol in zip(got, want, tols):
        assert tuple(g.shape) == np.asarray(w).shape
        err = float(np.abs(g.numpy() - np.asarray(w)).max())
        assert err <= tol, (err, tol)
