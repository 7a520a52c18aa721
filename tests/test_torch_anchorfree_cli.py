"""The port's training and serving CLIs with `--model anchorfree` against
the JAX package's on the CPU, on the seeded 8-image synthetic set of
`torch_cases.synth_world` (128², 3 classes; the eval CLI's test is
tests/test_torch_anchorfree_eval_cli.py).

  * train: `python -m fastdet_torch.cli.train --model anchorfree`
    (finetuning from the checkpoint: every tensor loads, 2 epochs of 2
    steps at b4, the evaluation after epoch 1) prints `cli/train.py`'s
    `Epoch:…` and `Precision:…` lines to 1e-4 (`--fused-backbone` with
    this family: tests/test_torch_train_cli.py);
  * serve: `python -m fastdet_torch.cli.serve --model anchorfree` serves
    a raw request through `FusedPipeline(family="anchorfree")`
    (`--pipeline device` with this family: tests/test_torch_serve.py).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from fastdet.io import load_variables
from fastdet_torch.cli import serve as serve_cli
from fastdet_torch.serve import FusedPipeline
from fastdet_torch.server import InferenceServer
from torch_cases import make_sample, synth_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "anchorfree-synth.npz")


def run(args, timeout=600):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=REPO)


def numbers(stdout, prefix):
    """Every number of the lines that start with `prefix`."""
    return [[float(t.split(":")[-1].split("/")[0]) for t in ln.split()]
            for ln in stdout.splitlines() if ln.startswith(prefix)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return synth_world(tmp_path_factory.mktemp("afworld"), WEIGHTS)


def train_cli(world, out, port, *extra):
    args = (["-m", "fastdet_torch.cli.train", "--device", "cpu"] if port
            else [os.path.join(REPO, "cli", "train.py")])
    return run(args + ["--data", str(world / "synth.data"),
                       "--model", "anchorfree", "--eval_every", "1",
                       "--weights_dir", str(out / "w"),
                       "--ckpt_dir", str(out / "ckpt"), *extra])


def test_train_cli_matches_jax(world, tmp_path):
    jax_run = train_cli(world, tmp_path / "jax", False)
    assert jax_run.returncode == 0, jax_run.stderr[-3000:]
    port = train_cli(world, tmp_path / "port", True)
    assert port.returncode == 0, port.stderr[-3000:]
    assert "(326 tensors loaded, 0 fresh)" in port.stdout, port.stdout
    want = numbers(jax_run.stdout, "Epoch:")
    got = numbers(port.stdout, "Epoch:")
    assert len(got) == len(want) == 4, port.stdout[-2000:]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    want = numbers(jax_run.stdout, "Precision:")
    got = numbers(port.stdout, "Precision:")
    assert len(got) == len(want) == 1, port.stdout[-2000:]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert 0 < got[0][2] <= 1, got                      # a real AP
    # the AP-stamped save is the family's JAX layout
    saved = [f for f in os.listdir(tmp_path / "port" / "w")
             if "-1-epoch-" in f]
    assert len(saved) == 1
    variables = load_variables(str(tmp_path / "port" / "w" / saved[0]))
    ref = load_variables(WEIGHTS)
    for coll in ("params", "batch_stats"):
        assert set(variables[coll]) == set(ref[coll])


def test_serve_cli_serves_the_family(world, monkeypatch):
    """`--model anchorfree` serves through FusedPipeline with the family's
    head: the CLI warms each batch bucket and hands the pipeline to the
    server, whose HTTP loop is replaced here by one raw request."""
    img = make_sample(np.random.RandomState(3), 128)[0]
    served = []

    def serve_once(self, host, port, quiet=False):
        try:
            served.append((self._pipe, self.detect_raw(img.tobytes(), 128,
                                                       128)))
        finally:
            self.shutdown()

    monkeypatch.setattr(InferenceServer, "serve_forever", serve_once)
    assert serve_cli.main(["--data", str(world / "synth.data"), "--weights",
                           WEIGHTS, "--model", "anchorfree", "--device",
                           "cpu", "--batch", "2"]) == 0
    (pipe, answer), = served
    assert isinstance(pipe, FusedPipeline)
    rows = pipe(img[None])[0]
    assert answer["count"] == len(rows) > 0
    assert [d["class_id"] for d in answer["detections"]] == \
        rows[:, 5].astype(int).tolist()
    assert [d["class_name"] for d in answer["detections"]] == [
        ("red", "green", "blue")[int(c)] for c in rows[:, 5]]
