"""The port's CLIs as 2-process gloo jobs on the CPU (the FASTDET_*
variables), against the same CLI in one process.

  * train (tests/test_multihost.py's tiny world and checks): the three
    lines `distributed: process 1/2`, `input shard 2/2` and
    `data-parallel mesh over 2 devices`; the step-0 loss components,
    a function of the global batch alone, at rtol 2e-4 atol 1e-6; the
    final parameters and running statistics structurally (≥ 95% of
    every tensor's elements within 1e-3, none beyond 5e-2), as JAX's
    test holds its own 2-process run; rank 0 alone writes the weights.
    The structural check takes as its reference `run_training` in one
    process on the global batches in rank order (the loaders' shards
    concatenated): the ranks' strided shards permute the one-process
    CLI's rows, and at these shapes a permutation alone moves the first
    conv's f32 gradient by 1.6e-3 of the largest at step 0 and its
    kernel by up to 2.1e-3 after the 4 steps, 8.6% of its elements
    beyond 1e-3 (one process, rows [0, 2, 1, 3] against [0, 1, 2, 3]),
    the distance the 2-process run stands from the one-process CLI;
  * eval (tests/test_torch_eval_cli.py's val set): both ranks print the
    same `Precision: Recall: AP: F1:` line, the one-process run's to
    1e-6 (each rank evaluates its strided shard, the statistics are
    gathered).
"""

import os
import subprocess
import sys

import numpy as np
import torch

from fastdet_torch.cli.train import run_training
from fastdet_torch.config import Config
from fastdet_torch.data import DarknetDataset, DataLoader, default_augment
from fastdet_torch.models.registry import get_family
from test_multihost import _load_npz, _tiny_world
from test_torch_eval_cli import WEIGHTS, summary, val_world  # noqa: F401
from test_torch_parallel_train import free_port
from torch_cases import FEW_THREADS, few_torch_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def launch(args, world=None, timeout=600):
    """`python -m fastdet_torch.cli.<args>` once, or as the `world` ranks
    of a gloo job → each process's stdout; each must exit 0."""
    env = dict(os.environ, **FEW_THREADS)
    env.pop("PYTHONPATH", None)
    envs = [env]
    if world:
        port = free_port()
        envs = [dict(env, FASTDET_COORDINATOR=f"localhost:{port}",
                     FASTDET_NUM_PROCESSES=str(world),
                     FASTDET_PROCESS_ID=str(i)) for i in range(world)]
    procs = [subprocess.Popen([sys.executable, "-m", *args],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=e,
                              cwd=REPO) for e in envs]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            assert p.returncode == 0, out[-4000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def first_loss_line(out):
    for line in out.splitlines():
        if line.startswith("Epoch:0 0/"):
            return [float(v.split(":")[1]) for v in line.split()[2:]]
    raise AssertionError(f"no step-0 loss line in:\n{out[-3000:]}")


def rank_ordered_reference(data, weights_dir):
    """The train CLI's init and loop (`run_training`) in one process on
    its 2-process job's global batches: each epoch's rank-0 and rank-1
    loader batches concatenated → the final weights' path."""
    cfg = Config.from_file(data)
    torch.manual_seed(0)
    sd = get_family("yolo-fastestv2", cfg).model.state_dict()
    ds = DarknetDataset(cfg.train, cfg.width, cfg.height,
                        augment=default_augment)
    loaders = [DataLoader(ds, 2, shuffle=True, drop_last=True,
                          num_workers=1, shard=(r, 2)) for r in range(2)]

    def batches(epoch):
        for dl in loaders:
            dl.set_epoch(epoch)
        for parts in zip(*loaders):
            yield tuple(np.concatenate(x) for x in zip(*parts))

    with few_torch_threads():
        run_training(cfg, sd, batches, device="cpu", steps_per_epoch=2,
                     eval_every=100, weights_dir=str(weights_dir))
    for dl in loaders:
        dl.close()
    return weights_dir / "tiny-final-model.npz"


def test_two_process_train_cli_matches_one(tmp_path):
    data = str(_tiny_world(tmp_path))

    def args(tag):
        return ["fastdet_torch.cli.train", "--data", data, "--device",
                "cpu", "--eval_every", "100", "--ckpt_dir",
                str(tmp_path / f"c_{tag}"), "--weights_dir",
                str(tmp_path / f"w_{tag}")]

    (single_out,) = launch(args("single"))
    outs = launch(args("dual"), world=2)
    assert any("distributed: process 1/2" in o for o in outs)
    assert any("input shard 2/2" in o for o in outs)
    assert any("data-parallel mesh over 2 devices" in o for o in outs)
    np.testing.assert_allclose(first_loss_line(outs[0]),
                               first_loss_line(single_out), rtol=2e-4,
                               atol=1e-6, err_msg="step-0 loss differs: "
                               "global batch/BN-sync mismatch")
    (tmp_path / "w_ref").mkdir()
    single = _load_npz(rank_ordered_reference(data, tmp_path / "w_ref"))
    dual = _load_npz(tmp_path / "w_dual" / "tiny-final-model.npz")
    assert set(single) == set(dual)
    for k in single:
        d = np.abs(dual[k].astype(np.float64)
                   - single[k].astype(np.float64)).ravel()
        frac_off = float((d > 1e-3).mean())
        assert frac_off < 0.05 and float(d.max()) < 5e-2, \
            (f"param {k} diverged between 1- and 2-process runs: "
             f"{frac_off:.1%} of elements off by >1e-3, max {d.max():.2e}")
    # rank 0 alone writes the weights
    assert os.listdir(tmp_path / "w_dual") == ["tiny-final-model.npz"]


def test_two_process_eval_cli_matches_one(val_world):  # noqa: F811
    args = ["fastdet_torch.cli.evaluation", "--data",
            str(val_world / "val.data"), "--weights", WEIGHTS, "--device",
            "cpu", "--batch", "4"]
    (single,) = launch(args)
    outs = launch(args, world=2)
    assert "distributed: process 2/2" in outs[1], outs[1][-2000:]
    assert summary(outs[0]) == summary(outs[1])
    np.testing.assert_allclose(summary(outs[0]), summary(single), rtol=0,
                               atol=1e-6)
    assert all(0 < v < 1 for v in summary(single))
