"""The port's `quantize` and `test` CLIs against the JAX package's on the
CPU: `python -m fastdet_torch.cli.quantize` and `cli/quantize.py` (at the
defaults) write the same artifact, and `fastdet_torch.cli.test` and
`cli/test.py` print the same detection rows, with `--int8` (both
families) and with f32 weights (the port's `--fused` too).  Each JAX CLI
runs beside its port counterparts.  (`evaluation --int8` is held to the
JAX CLI in tests/test_torch_eval_cli.py and
tests/test_torch_anchorfree_eval_cli.py.)

Images: seeded crops of the repository's photo for calibration, the
photo itself, and an image of `torch_cases.synth_world` (anchor-free,
128²) with an artifact of `weights/anchorfree-synth.npz`.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from fastdet_torch.cli.quantize import load_calib_images
from fastdet_torch.io import load_state_dict
from fastdet_torch.quant import (calibrate, fold_model, load_quantized,
                                 quantize_weights, save_quantized)
from fastdet_torch.quant.ptq import FloatOps, folded_forward_for
from torch_cases import run_beside, synth_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "coco.data")
WEIGHTS = os.path.join(REPO, "weights", "coco2017-ref.npz")
INT8 = os.path.join(REPO, "weights", "coco-int8.npz")
AF_WEIGHTS = os.path.join(REPO, "weights", "anchorfree-synth.npz")
PHOTO = os.path.join(REPO, "test_result.png")


@pytest.fixture(scope="module")
def calib_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("calib")
    rng = np.random.default_rng(3)
    photo = cv2.imread(PHOTO)
    h, w = photo.shape[:2]
    for i in range(4):
        y0, x0 = rng.integers(0, h // 3), rng.integers(0, w // 3)
        crop = photo[y0:y0 + 2 * h // 3, x0:x0 + 2 * w // 3]
        cv2.imwrite(str(root / f"c{i}.png"), crop if i % 2 else crop[:, ::-1])
    return root


def test_quantize_cli_matches_jax(calib_dir, tmp_path):
    """The same artifact: wq, sw and b bitwise, each activation scale
    within one histogram bin (max|x|/2048/127) of JAX's."""
    args = ["--data", DATA, "--weights", WEIGHTS, "--calib", str(calib_dir),
            "--n", "4", "--batch", "2"]
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    _, out = run_beside("quantize.py", [*args, "--output", theirs],
                        ("quantize", [*args, "--output", ours]))
    assert "76 quantized ops" in out, out
    (qw, sx), (jqw, jsx) = load_quantized(ours), load_quantized(theirs)
    assert set(qw) == set(jqw) == set(sx) == set(jsx)
    for name, q in jqw.items():
        for k in ("wq", "sw", "b"):
            assert torch.equal(qw[name][k], q[k]), (name, k)
    folded = fold_model(load_state_dict(WEIGHTS))
    ops = FloatOps(folded, record=True, device="cpu")
    with torch.no_grad():
        folded_forward_for(folded)(torch.from_numpy(load_calib_images(
            str(calib_dir), 4, (352, 352))), ops)
    for name, s in jsx.items():
        one_bin = float(ops.maxabs[name]) / 2048 / 127
        assert abs(sx[name] - s) <= one_bin * 1.001, (name, sx[name], s)


def rows(stdout):
    """The detection lines of the test CLI, between its timing line and
    its `saved` line."""
    lines = stdout.splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith("forward time:"))
    assert lines[-1].startswith("saved "), stdout[-2000:]
    return lines[start + 1:-1]


def test_test_cli_int8_matches_jax(tmp_path):
    """The same rows on the photo from coco-int8.npz; the image drawn."""
    args = ["--data", DATA, "--img", PHOTO, "--int8", INT8]
    out = str(tmp_path / "port.png")
    want, got = run_beside(
        "test.py", [*args, "--output", str(tmp_path / "jax.png")],
        ("test", [*args, "--output", out]))
    assert rows(want), "no detection on the photo"
    assert rows(got) == rows(want)
    assert cv2.imread(out).shape == cv2.imread(PHOTO).shape


def test_test_cli_f32_matches_jax(tmp_path):
    """f32 weights: the default mode's rows are JAX's, and `--fused`
    (FusedPipeline in f32) prints the same rows."""
    args = ["--data", DATA, "--img", PHOTO, "--weights", WEIGHTS]
    want, got, fused = run_beside(
        "test.py", [*args, "--output", str(tmp_path / "jax.png")],
        ("test", [*args, "--output", str(tmp_path / "port.png")]),
        ("test", [*args, "--fused", "--output", str(tmp_path / "f.png")]))
    assert rows(want), "no detection on the photo"
    assert rows(got) == rows(want)
    assert rows(fused) == rows(want)


def test_test_cli_int8_anchorfree_matches_jax(tmp_path):
    """`--int8` with an anchor-free artifact (made by the port, calibrated
    on the synthetic set): the artifact's family decodes, no --model."""
    world = synth_world(tmp_path, AF_WEIGHTS)
    folded = fold_model(load_state_dict(AF_WEIGHTS))
    art = str(tmp_path / "af-int8.npz")
    save_quantized(art, quantize_weights(folded), calibrate(
        folded, load_calib_images(str(world / "list.txt"), 8, (128, 128)),
        device="cpu"))
    args = ["--data", str(world / "synth.data"), "--img",
            str(world / "img1.png"), "--int8", art, "--conf", "0.2"]
    want, got = run_beside(
        "test.py", [*args, "--output", str(tmp_path / "jax.png")],
        ("test", [*args, "--output", str(tmp_path / "port.png")]))
    assert rows(want), "no detection on the synthetic image"
    assert rows(got) == rows(want)
