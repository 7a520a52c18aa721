"""The port's training CLI (`python -m fastdet_torch.cli.train`) against the
JAX package's (`cli/train.py`) on the CPU, on a seeded 8-image Darknet
set at 96², batch 4, 2 epochs, finetuning from
`weights/coco2017-ref.npz`, with the evaluation after epoch 1
(`--eval_every 1`).  The images are PNG crops of the repository's photo
(written with cv2); their labels are the port's own detections at conf
0.3, moved by a seeded few pixels, so that the evaluation has TP, FP and
FN.

Both CLIs print the same `Epoch:…` progress lines and the same
`Precision:… Recall:… AP:… F1:…` line to 1e-4 (f32 forwards and
gradients that agree to ~1e-6, and an LR that stays below 1e-5 in these
4 warm-up steps, so the two trainings stay that close); the saved `.npz`
loads in `fastdet`.
"""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

from fastdet.io import load_variables
from fastdet_torch.config import Config
from fastdet_torch.io import load_state_dict
from fastdet_torch.models import Detector
from fastdet_torch.serve import DevicePipeline
from torch_cases import FEW_THREADS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "weights", "coco2017-ref.npz")


def run(args, timeout=600, env_extra=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("PYTHONPATH", None)
    env.update(FEW_THREADS)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=REPO)


def numbers(stdout, prefix):
    """Every number of the lines that start with `prefix`."""
    return [[float(t.split(":")[-1].split("/")[0]) for t in ln.split()]
            for ln in stdout.splitlines() if ln.startswith(prefix)]


@pytest.fixture(scope="module")
def train_world(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainworld")
    rng = np.random.default_rng(11)
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
        p = root / f"img{i}.png"
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
            x1, y1, x2, y2 = np.asarray([x1, y1, x2, y2]) \
                + rng.uniform(-4, 4, 4)
            rows.append((int(c), (x1 + x2) / 704, (y1 + y2) / 704,
                         (x2 - x1) / 352, (y2 - y1) / 352))
        with open(p.rsplit(".", 1)[0] + ".txt", "w") as f:
            f.writelines("%d %.6f %.6f %.6f %.6f\n" % r for r in rows)
    (root / "list.txt").write_text("\n".join(paths) + "\n")
    data = (open(os.path.join(REPO, "data", "coco.data")).read()
            .replace("epochs=300", "epochs=2")
            .replace("batch_size=128", "batch_size=4")
            .replace("width=352", "width=96").replace("height=352",
                                                      "height=96")
            .replace("pre_weights=None", f"pre_weights={WEIGHTS}")
            .replace("./data/train.txt", str(root / "list.txt"))
            .replace("./data/val.txt", str(root / "list.txt"))
            .replace("./data/coco.names",
                     os.path.join(REPO, "data", "coco.names")))
    (root / "train.data").write_text(data)
    return root


def cli(world, tmp_path, port, *extra):
    args = (["-m", "fastdet_torch.cli.train", "--device", "cpu"] if port
            else [os.path.join(REPO, "cli", "train.py")])
    return run(args + ["--data", str(world / "train.data"),
                       "--eval_every", "1",
                       "--weights_dir", str(tmp_path / "w"),
                       "--ckpt_dir", str(tmp_path / "ckpt"), *extra])


@pytest.fixture(scope="module")
def port_run(train_world, tmp_path_factory):
    """The port's CLI on the default path, and its output directory."""
    out = tmp_path_factory.mktemp("port")
    r = cli(train_world, out, True)
    assert r.returncode == 0, r.stderr[-3000:]
    return r, out


def test_train_cli_matches_jax(train_world, port_run, tmp_path):
    jax_run = cli(train_world, tmp_path / "jax", False)
    assert jax_run.returncode == 0, jax_run.stderr[-3000:]
    port, out = port_run
    want = numbers(jax_run.stdout, "Epoch:")
    got = numbers(port.stdout, "Epoch:")
    assert len(got) == len(want) == 4, port.stdout[-2000:]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    want = numbers(jax_run.stdout, "Precision:")
    got = numbers(port.stdout, "Precision:")
    assert len(got) == len(want) == 1, port.stdout[-2000:]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert 0 < got[0][2] < 1, got                       # a real AP

    # the AP-stamped save is in the JAX layout and loads in fastdet
    saved = [f for f in os.listdir(out / "w") if "-1-epoch-" in f]
    assert len(saved) == 1, os.listdir(out / "w")
    variables = load_variables(str(out / "w" / saved[0]))
    ref = load_variables(WEIGHTS)
    for coll in ("params", "batch_stats"):
        assert set(variables[coll]) == set(ref[coll])
    stem = variables["params"]["backbone"]["first_conv"]["conv"]["kernel"]
    assert stem.shape == (3, 3, 3, 24)


def test_fused_backbone_cli_trains(train_world, port_run, tmp_path):
    """`--fused-backbone` (the training span through its plain version on
    the CPU) trains, evaluates and saves; its loss lines are finite and
    its first step's, where the ghost groups equal the batch (b4 at 96²)
    and the parameters are the finetune's, is the default path's."""
    fused = cli(train_world, tmp_path / "f", True, "--fused-backbone")
    assert fused.returncode == 0, fused.stderr[-3000:]
    lines = numbers(fused.stdout, "Epoch:")
    assert len(lines) == 4 and np.isfinite(lines).all(), fused.stdout
    assert len(numbers(fused.stdout, "Precision:")) == 1
    np.testing.assert_allclose(lines[0], numbers(port_run[0].stdout,
                                                 "Epoch:")[0],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("chain", ["0", "-2"])
def test_train_cli_clamps_chain_as_jax(train_world, port_run, tmp_path,
                                       chain):
    """`--chain` below 1 trains step by step, as the JAX CLI clamps it
    (K = max(1, --chain)): exit 0 and the `Epoch:` lines of `--chain 1`."""
    r = cli(train_world, tmp_path, True, "--chain", chain)
    assert r.returncode == 0, r.stderr[-3000:]
    want = [ln for ln in port_run[0].stdout.splitlines()
            if ln.startswith("Epoch:")]
    got = [ln for ln in r.stdout.splitlines() if ln.startswith("Epoch:")]
    assert len(want) == 4 and got == want, r.stdout[-2000:]


@pytest.mark.parametrize("extra,env,label", [
    (("--fused-backbone", "--model", "anchorfree"), None,
     "--fused-backbone supports the yolo-fastestv2 family only"),
    # a job's count without its coordinator never trains single-process
    ((), {"FASTDET_NUM_PROCESSES": "2"}, "FASTDET_COORDINATOR"),
    # a coordinator without the count: JAX's KeyError
    ((), {"FASTDET_COORDINATOR": "localhost:1"}, "FASTDET_NUM_PROCESSES"),
])
def test_train_cli_unported_options_exit_nonzero(train_world, tmp_path,
                                                 extra, env, label):
    r = run(["-m", "fastdet_torch.cli.train", "--device", "cpu", "--data",
             str(train_world / "train.data"), *extra], env_extra=env)
    assert r.returncode != 0
    assert label in r.stderr


@pytest.fixture(scope="module")
def backbone_files(tmp_path_factory):
    """A reference-layout backbone `.pth` of the reference weights, the
    same as a backbone-only `.npz` (JAX's `convert_torch_checkpoint`), and
    the count of tensors JAX's CLI loads from it: its `merge_variables`
    of the wrapped backbone tree onto a fresh 80-class Detector."""
    import jax
    import jax.numpy as jnp
    from fastdet.io import merge_variables
    from fastdet.io.torch_convert import (convert_torch_checkpoint,
                                          load_torch_weights)
    from fastdet.models import Detector as JaxDetector
    from torch_cases import write_reference_pth
    root = tmp_path_factory.mktemp("backbone")
    pth = write_reference_pth(WEIGHTS, root / "backbone.pth",
                              backbone_only=True)
    npz = root / "backbone.npz"
    convert_torch_checkpoint(str(pth), str(npz), backbone_only=True)
    bb = load_torch_weights(str(pth), backbone_only=True)
    bb = {"params": {"backbone": bb["params"]},
          "batch_stats": {"backbone": bb["batch_stats"]}}
    init = JaxDetector(classes=80, anchor_num=3).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 96, 96, 3)), train=False)
    _, n_load, _ = merge_variables(jax.device_get(init), bb)
    return {"pth": pth, "npz": npz}, n_load


@pytest.mark.parametrize("kind", ["pth", "npz"])
def test_train_cli_initialises_the_backbone(train_world, backbone_files,
                                            tmp_path, kind):
    """`--backbone` with a reference `.pth` (backbone-only, as released)
    or a backbone-only `.npz`, and no `pre_weights`: exit 0 and JAX's
    `Initialize backbone from … (N tensors loaded)` line with JAX's N."""
    files, n_jax = backbone_files
    data = tmp_path / "nopre.data"
    data.write_text((train_world / "train.data").read_text().replace(
        f"pre_weights={WEIGHTS}", "pre_weights=None"))
    r = run(["-m", "fastdet_torch.cli.train", "--device", "cpu", "--data",
             str(data), "--eval_every", "100", "--backbone",
             str(files[kind]), "--weights_dir", str(tmp_path / "w"),
             "--ckpt_dir", str(tmp_path / "ckpt")])
    assert r.returncode == 0, r.stderr[-3000:]
    line = "Initialize backbone from %s (%d tensors loaded)" % (
        files[kind], n_jax)
    assert line in r.stdout.splitlines(), r.stdout[-2000:]
    assert n_jax == 275


def test_train_cli_keeps_cv2_off_module_level():
    r = run(["-c", "import sys; import fastdet_torch.cli.train, "
             "fastdet_torch.train.trainer, fastdet_torch.io.checkpoint; "
             "print(sorted(m for m in sys.modules if m.startswith("
             "('fastdet_torch.data', 'cv2', 'jax', 'fastdet.'))))"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"
