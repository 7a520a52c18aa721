"""The port's anchor generation (`fastdet_torch/anchors.py`,
`python -m fastdet_torch.cli.genanchors`) against the JAX package's
(`fastdet/anchors.py`, `cli/genanchors.py`) on the CPU: on a seeded
Darknet label set in a tmp dir (JPEGImages/ image paths whose labels sit
in labels/, as the reference's path munge finds them), the label dims,
the IoU table, k-means for k = 1..10 at two seeds bit for bit, and the
`anchors{k}.txt` files byte for byte, from the module and from the CLIs.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from fastdet import anchors as jax_anchors
from fastdet_torch import anchors
from torch_cases import FEW_THREADS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (0, 7)


@pytest.fixture(scope="module")
def train_txt(tmp_path_factory):
    """40 label files of 1-6 boxes (w, h drawn from three seeded shape
    families, so that k-means has clusters to find) and their list."""
    root = tmp_path_factory.mktemp("darknet")
    (root / "JPEGImages").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(5)
    centers = np.asarray([[0.08, 0.12], [0.3, 0.25], [0.6, 0.7]])
    paths = []
    for i in range(40):
        ext = ".jpg" if i % 4 else ".png"
        paths.append(str(root / "JPEGImages" / f"img{i}{ext}"))
        rows = []
        for _ in range(int(rng.integers(1, 7))):
            c = centers[rng.integers(0, 3)]
            w, h = np.clip(c * rng.uniform(0.6, 1.4, 2), 0.01, 1.0)
            cx, cy = rng.uniform(0.2, 0.8, 2)
            rows.append("%d %.6f %.6f %.6f %.6f\n"
                        % (rng.integers(0, 80), cx, cy, w, h))
        (root / "labels" / f"img{i}.txt").write_text("".join(rows))
    lst = root / "train.txt"
    lst.write_text("\n".join(paths) + "\n")
    return str(lst)


def test_label_dims_and_iou(train_txt):
    wh = anchors.load_label_dims(train_txt)
    want = jax_anchors.load_label_dims(train_txt)
    assert wh.dtype == want.dtype and np.array_equal(wh, want)
    assert len(wh) > 100
    cents = wh[[0, 5, 9]]
    assert np.array_equal(anchors.pair_iou(wh, cents),
                          jax_anchors.pair_iou(wh, cents))
    assert anchors.avg_iou(wh, cents) == jax_anchors.avg_iou(wh, cents)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("k", range(1, 11))
def test_kmeans_bitwise(train_txt, k, seed):
    wh = anchors.load_label_dims(train_txt)
    cents, avg = anchors.kmeans_anchors(wh, k, seed=seed)
    want, want_avg = jax_anchors.kmeans_anchors(wh, k, seed=seed)
    assert cents.shape == (k, 2) and np.array_equal(cents, want)
    assert avg == want_avg


def _files(out):
    return {f: open(os.path.join(out, f), "rb").read()
            for f in sorted(os.listdir(out))}


@pytest.mark.parametrize("num_clusters", [6, 0])
def test_generate_anchors_files_byte_equal(train_txt, tmp_path,
                                           num_clusters):
    got = anchors.generate_anchors(train_txt, str(tmp_path / "port"),
                                   num_clusters, 320, 256, seed=3,
                                   verbose=False)
    want = jax_anchors.generate_anchors(train_txt, str(tmp_path / "jax"),
                                        num_clusters, 320, 256, seed=3,
                                        verbose=False)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    port, jax = _files(tmp_path / "port"), _files(tmp_path / "jax")
    ks = [num_clusters] if num_clusters else range(1, 11)
    assert list(port) == [f"anchors{k}.txt" for k in sorted(ks, key=str)]
    assert port == jax


def test_genanchors_cli_byte_equal(train_txt, tmp_path):
    """`python -m fastdet_torch.cli.genanchors` and `cli/genanchors.py`
    with the same flags (the k = 1..10 sweep) write the same files and
    print the same lines."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", **FEW_THREADS)
    env.pop("PYTHONPATH", None)
    runs = {}
    for name, cmd in (("port", ["-m", "fastdet_torch.cli.genanchors"]),
                      ("jax", [os.path.join(REPO, "cli", "genanchors.py")])):
        out = tmp_path / name
        runs[name] = subprocess.run(
            [sys.executable, *cmd, "--traintxt", train_txt, "--output_dir",
             str(out), "--num_clusters", "0", "--input_width",
             "416", "--seed", "11"], capture_output=True, text=True,
            timeout=300, env=env, cwd=REPO)
        assert runs[name].returncode == 0, runs[name].stderr[-2000:]
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax")
    assert len(files) == 10
    assert runs["port"].stdout.replace(str(tmp_path / "port"), "OUT") == \
        runs["jax"].stdout.replace(str(tmp_path / "jax"), "OUT")
