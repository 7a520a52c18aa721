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
`batched_nms`).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

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
