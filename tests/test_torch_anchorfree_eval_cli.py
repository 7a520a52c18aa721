"""The port's eval CLI with `--model anchorfree` against the JAX package's
(`cli/evaluation.py`) on the CPU, on the seeded 8-image synthetic set of
`torch_cases.synth_world`: the rectangle task `weights/anchorfree-synth.npz`
was trained on, at 128², 3 classes, with labels that give TP, FP and FN.
The yolo set of tests/test_torch_eval_cli.py has 80 classes, for which
the repository has no trained anchor-free checkpoint (a random one
detects nothing there).

`python -m fastdet_torch.cli.evaluation --model anchorfree`, with and
without `--fused`, prints the JAX CLI's `Precision:… Recall:… AP:… F1:…`
line to 1e-6 (the forwards agree to ~1e-6 and both suppress with
`batched_nms`); `--int8` with an artifact of the same weights, made by
the port's `quantize`, prints the JAX CLI's `--int8` line.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from fastdet_torch.cli.quantize import load_calib_images
from fastdet_torch.io import load_state_dict
from fastdet_torch.quant import (calibrate, fold_model, quantize_weights,
                                 save_quantized)
from torch_cases import synth_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "anchorfree-synth.npz")


def run(args, timeout=600):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=REPO)


def summary(stdout):
    lines = [ln for ln in stdout.splitlines() if ln.startswith("Precision:")]
    assert lines, stdout[-2000:]
    return [float(t.split(":")[1]) for t in lines[-1].split()]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return synth_world(tmp_path_factory.mktemp("afevalworld"), WEIGHTS)


@pytest.fixture(scope="module")
def af_int8(world):
    """An int8 artifact of `anchorfree-synth.npz` made by the port,
    calibrated on the set's own images."""
    folded = fold_model(load_state_dict(WEIGHTS))
    images = load_calib_images(str(world / "list.txt"), 8, (128, 128))
    path = str(world / "af-int8.npz")
    save_quantized(path, quantize_weights(folded),
                   calibrate(folded, images, device="cpu"))
    return path


def test_eval_cli_matches_jax(world):
    args = ["--data", str(world / "synth.data"), "--weights", WEIGHTS,
            "--model", "anchorfree", "--batch", "4"]
    jax_run = run([os.path.join(REPO, "cli", "evaluation.py"), *args])
    assert jax_run.returncode == 0, jax_run.stderr[-3000:]
    want = summary(jax_run.stdout)
    assert all(0 < v < 1 for v in want), want         # TP, FP and FN
    for extra in ((), ("--fused",)):
        port = run(["-m", "fastdet_torch.cli.evaluation", "--device", "cpu",
                    *args, *extra])
        assert port.returncode == 0, port.stderr[-3000:]
        np.testing.assert_allclose(summary(port.stdout), want, rtol=0,
                                   atol=1e-6, err_msg=str(extra))


def test_eval_cli_int8_matches_jax(world, af_int8):
    """`--int8` with an anchor-free artifact: the family comes from the
    artifact (no --model, no weights), and the line is the JAX CLI's."""
    args = ["--data", str(world / "synth.data"), "--int8", af_int8,
            "--batch", "4"]
    jax_run = run([os.path.join(REPO, "cli", "evaluation.py"), *args])
    assert jax_run.returncode == 0, jax_run.stderr[-3000:]
    want = summary(jax_run.stdout)
    assert all(0 < v < 1 for v in want), want
    port = run(["-m", "fastdet_torch.cli.evaluation", "--device", "cpu",
                *args])
    assert port.returncode == 0, port.stderr[-3000:]
    np.testing.assert_allclose(summary(port.stdout), want, rtol=0,
                               atol=1e-6)
