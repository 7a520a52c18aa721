"""The port's eval CLI (`python -m fastdet_torch.cli.evaluation`) against the
JAX package's (`cli/evaluation.py`) on the CPU, on a seeded 8-image val set
built in a temporary directory: PNG crops of the repository's photo,
written with cv2, and label files made from the port's own detections at
conf 0.3, each box moved by a seeded few pixels, some dropped and one
spurious box added, so that TP, FP and FN all occur.

Both CLIs print the same `Precision:… Recall:… AP:… F1:…` line to 1e-6
(the forwards agree to ~1e-5, the postprocess to a few ULPs), and the
port's `--fused` mode prints its default mode's line; with `--int8
weights/coco-int8.npz` too.
"""

import os
import random
import subprocess
import sys

import cv2
import numpy as np
import pytest

from fastdet.data import dataset as jds
from fastdet.data import loader as jld
from fastdet_torch.config import Config
from fastdet_torch.data import dataset, loader
from fastdet_torch.io import load_state_dict
from fastdet_torch.models import Detector
from fastdet_torch.serve import DevicePipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "coco2017-ref.npz")
INT8 = os.path.join(REPO, "weights", "coco-int8.npz")


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
def val_world(tmp_path_factory):
    root = tmp_path_factory.mktemp("evalworld")
    rng = np.random.default_rng(7)
    photo = cv2.imread(os.path.join(REPO, "test_result.png"))
    h, w = photo.shape[:2]
    paths, crops = [], []
    for i in range(8):
        ch = int(rng.integers(int(0.6 * h), h + 1))
        cw = int(rng.integers(int(0.6 * w), w + 1))
        y0 = int(rng.integers(0, h - ch + 1))
        x0 = int(rng.integers(0, w - cw + 1))
        crop = photo[y0:y0 + ch, x0:x0 + cw]
        if i % 2:
            crop = np.ascontiguousarray(crop[:, ::-1])
        p = root / f"val{i}.png"
        cv2.imwrite(str(p), crop)
        paths.append(str(p))
        crops.append(cv2.resize(crop, (352, 352),
                                interpolation=cv2.INTER_LINEAR))
    cfg = Config.from_file(os.path.join(REPO, "data", "coco.data"))
    pipe = DevicePipeline(Detector(), load_state_dict(WEIGHTS), cfg,
                          device="cpu")
    for p, dets in zip(paths, pipe(np.stack(crops))):
        rows = []
        for x1, y1, x2, y2, _, c in dets:
            if rng.random() < 0.2:                         # a miss
                continue
            x1, y1, x2, y2 = np.asarray([x1, y1, x2, y2]) \
                + rng.uniform(-4, 4, 4)
            rows.append((int(c), (x1 + x2) / 704, (y1 + y2) / 704,
                         (x2 - x1) / 352, (y2 - y1) / 352))
        cx, cy = rng.uniform(0.2, 0.8, 2)       # spurious, a class seen
        rows.append((int(rng.choice(dets[:, 5])) if len(dets) else 0, cx,
                     cy, 0.1, 0.1))
        with open(p.rsplit(".", 1)[0] + ".txt", "w") as f:
            f.writelines("%d %.6f %.6f %.6f %.6f\n" % r for r in rows)
    (root / "val.txt").write_text("\n".join(paths) + "\n")
    data = (open(os.path.join(REPO, "data", "coco.data")).read()
            .replace("./data/val.txt", str(root / "val.txt"))
            .replace("./data/coco.names",
                     os.path.join(REPO, "data", "coco.names")))
    (root / "val.data").write_text(data)
    return root


def port_cli(val_world, *extra):
    return run(["-m", "fastdet_torch.cli.evaluation", "--data",
                str(val_world / "val.data"), "--weights", WEIGHTS,
                "--device", "cpu", "--batch", "4", *extra])


def test_eval_cli_matches_jax(val_world):
    jax_run = run([os.path.join(REPO, "cli", "evaluation.py"), "--data",
                   str(val_world / "val.data"), "--weights", WEIGHTS,
                   "--batch", "4"])
    assert jax_run.returncode == 0, jax_run.stderr[-3000:]
    port = port_cli(val_world)
    assert port.returncode == 0, port.stderr[-3000:]
    want, got = summary(jax_run.stdout), summary(port.stdout)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert all(0 < v < 1 for v in got), got           # TP, FP and FN

    fused = port_cli(val_world, "--fused")
    assert fused.returncode == 0, fused.stderr[-3000:]
    np.testing.assert_allclose(summary(fused.stdout), got, rtol=0,
                               atol=1e-6)


def test_eval_cli_int8_matches_jax(val_world):
    """`--int8 weights/coco-int8.npz` (no weights: the artifact holds them
    and names its family) prints the JAX CLI's `--int8` line: the int8
    chain is JAX's bit for bit (tests/test_torch_quant.py)."""
    args = ["--data", str(val_world / "val.data"), "--int8", INT8,
            "--batch", "4"]
    jax_run = run([os.path.join(REPO, "cli", "evaluation.py"), *args])
    assert jax_run.returncode == 0, jax_run.stderr[-3000:]
    port = run(["-m", "fastdet_torch.cli.evaluation", "--device", "cpu",
                *args])
    assert port.returncode == 0, port.stderr[-3000:]
    want, got = summary(jax_run.stdout), summary(port.stdout)
    assert all(0 < v < 1 for v in want), want
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_eval_cli_data_package_stays_off_module_level():
    """The serving path and the CLI module import no cv2-bound
    `fastdet_torch.data` until `main` runs."""
    r = run(["-c", "import sys; import fastdet_torch.cli.evaluation, "
             "fastdet_torch.serve, fastdet_torch.server; "
             "print(sorted(m for m in sys.modules if m.startswith("
             "('fastdet_torch.data', 'cv2'))))"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"


def test_dataset_and_loader_match_jax(val_world):
    """The port's own copies of the Darknet dataset, its loader and the
    augmentations give the JAX package's batches and images."""
    val = str(val_world / "val.txt")
    got = list(loader.DataLoader(dataset.DarknetDataset(val), 3))
    want = list(jld.DataLoader(jds.DarknetDataset(val), 3))
    assert [len(b[0]) for b in got] == [3, 3, 2]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    shard = loader.DataLoader(dataset.DarknetDataset(val), 2, shard=(1, 2))
    assert len(shard) == 2
    img = got[0][0][0]
    for name in ("contrast_and_brightness", "motion_blur", "augment_hsv",
                 "random_resize", "default_augment"):
        np.testing.assert_array_equal(
            getattr(dataset, name)(img, random.Random(3)),
            getattr(jds, name)(img, random.Random(3)), err_msg=name)
