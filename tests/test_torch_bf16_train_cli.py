"""`python -m fastdet_torch.cli.train --bf16` (and `--bf16
--fused-backbone`) against the JAX package's `cli/train.py --bf16` on the
CPU, on tests/test_torch_train_cli.py's seeded 8-image Darknet set at
96², batch 4, 2 epochs, finetuning from `weights/coco2017-ref.npz`, with
the evaluation after epoch 1.

Both CLIs train in bf16 with f32 parameters and evaluate in f32.  The
`Epoch:` lines' epoch, batch and LR are equal; their loss columns within
2⁻⁴ relative of JAX's, where the asked 2⁻⁵ does not hold: the totals read
≤ 0.7% apart, but a small component (Cls ≈ 1.0 on the second line)
reads 5.8%, and 4.0% with `--fused-backbone` — bf16 training's rounding
flips, carried through BatchNorm over these few pixels, as
tests/test_torch_bf16_train.py measures against JAX's own eager and
jitted steps.  The eval line `Precision:… Recall:… AP:… F1:…` within 1e-2
(f32 evaluations of weights that two bf16 trainings moved a little
apart).  The saved AP-stamped `.npz` is f32 in the JAX layout.  The fused
case (tests/test_torch_bf16_train_cli_fused.py) runs the JAX CLI through
tests/jax_bf16_cli.py (the header there says why).  `--bf16 --model
anchorfree` runs on the synthetic 3-class set (finite lines, an f32
evaluation and f32 saves).
"""

import os

import numpy as np

from fastdet.io import load_variables
from test_torch_train_cli import REPO, numbers, run, train_world  # noqa
from torch_cases import synth_world


def _cli(world, out, port, *extra):
    args = (["-m", "fastdet_torch.cli.train", "--device", "cpu"] if port
            else [os.path.join(REPO, "tests", "jax_bf16_cli.py")])
    return run(args + ["--data", str(world / "train.data"), "--bf16",
                       "--eval_every", "1", "--weights_dir", str(out / "w"),
                       "--ckpt_dir", str(out / "ckpt"), *extra])


def _check(world, tmp_path, *extra):
    jax_run = _cli(world, tmp_path / "jax", False, *extra)
    assert jax_run.returncode == 0, jax_run.stderr[-3000:]
    port = _cli(world, tmp_path / "port", True, *extra)
    assert port.returncode == 0, port.stderr[-3000:]
    want = np.array(numbers(jax_run.stdout, "Epoch:"))
    got = np.array(numbers(port.stdout, "Epoch:"))
    assert got.shape == want.shape == (4, 7), port.stdout[-2000:]
    np.testing.assert_array_equal(got[:, :3], want[:, :3])   # epoch, i, LR
    rel = np.abs(got[:, 3:] - want[:, 3:]) / np.abs(want[:, 3:])
    print(f"{extra}: Epoch lines' losses {rel.max():.4f} relative")
    assert rel.max() <= 2 ** -4, (got, want)
    want = numbers(jax_run.stdout, "Precision:")
    got = numbers(port.stdout, "Precision:")
    assert len(got) == len(want) == 1, port.stdout[-2000:]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)
    saved = [f for f in os.listdir(tmp_path / "port" / "w")
             if "-1-epoch-" in f]
    assert len(saved) == 1
    variables = load_variables(str(tmp_path / "port" / "w" / saved[0]))
    kernel = variables["params"]["backbone"]["first_conv"]["conv"]["kernel"]
    assert kernel.dtype == np.float32 and kernel.shape == (3, 3, 3, 24)


def test_train_cli_bf16_matches_jax(train_world, tmp_path):
    _check(train_world, tmp_path)


def test_train_cli_bf16_anchorfree_runs(tmp_path):
    """`--bf16 --model anchorfree` on the synthetic 3-class set
    (tests/torch_cases.py::synth_world, 128², finetuning from
    `weights/anchorfree-synth.npz`): it trains in bf16, its lines are
    finite, it evaluates in f32 and saves f32 weights."""
    (tmp_path / "af").mkdir()
    world = synth_world(tmp_path / "af",
                        os.path.join(REPO, "weights",
                                     "anchorfree-synth.npz"))
    r = run(["-m", "fastdet_torch.cli.train", "--device", "cpu", "--data",
             str(world / "synth.data"), "--bf16", "--model", "anchorfree",
             "--eval_every", "1", "--weights_dir", str(tmp_path / "w"),
             "--ckpt_dir", str(tmp_path / "ckpt")])
    assert r.returncode == 0, r.stderr[-3000:]
    lines = np.array(numbers(r.stdout, "Epoch:"))
    assert lines.shape == (4, 7) and np.isfinite(lines).all(), r.stdout
    assert len(numbers(r.stdout, "Precision:")) == 1
    saved = [f for f in os.listdir(tmp_path / "w") if "-1-epoch-" in f]
    assert len(saved) == 1
    variables = load_variables(str(tmp_path / "w" / saved[0]))
    kernel = variables["params"]["backbone"]["first_conv"]["conv"]["kernel"]
    assert kernel.dtype == np.float32
