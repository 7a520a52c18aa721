"""Multi-process dry run (counterpart of fastdet/parallel/dryrun.py): the
full training step over n gloo ranks on the CPU at the JAX package's tiny
shapes, two steps, and its line

    dryrun_multichip(n): ok, mesh=<mesh>, loss=…, lr=…

    python -m fastdet_torch.parallel.dryrun [n]

`run_dryrun(n)` starts the n ranks itself (processes on localhost, a free
port) and returns once all have exited 0; rank 0 prints the line.  Below
4 devices the mesh is 1-D data parallel (`mesh=<n>d`).  From 4 it is the
JAX package's 2-D (data, model) mesh with n_model = 2 (`mesh=<n/2>dx2m`):
the batch splits over the data axis, the conv channels over the model
axis (tensor parallel, `parallel/tp.py`); the ranks of one data index
step on the same rows.
"""

from __future__ import annotations

import os
import socket
import sys

import numpy as np


def _rank_main(rank: int, n: int, port: int) -> None:
    import torch

    from fastdet_torch.config import Config
    from fastdet_torch.models import Detector
    from fastdet_torch.parallel import (initialize_distributed, make_mesh,
                                        make_mesh_2d, shard_batch)
    from fastdet_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", n, rank, backend="gloo")
    cfg = Config.from_dict({
        "classes": 8, "width": 64, "height": 64, "anchor_num": 3,
        "anchors": [4.0, 6.0, 9.0, 12.0, 16.0, 24.0,
                    24.0, 16.0, 32.0, 40.0, 52.0, 48.0],
        "learning_rate": 1e-3, "steps": [10, 20], "subdivisions": 1,
        "batch_size": 2 * n, "epochs": 1,
    })
    if n >= 4:
        n_model = 2
        mesh = make_mesh_2d(n // n_model, n_model, devices=["cpu"])
        d, per = mesh.coords[0], 2 * n_model      # its data shard's rows
    else:
        mesh = make_mesh(devices=["cpu"])
        d, per = rank, 2
    torch.manual_seed(0)
    model = Detector(classes=cfg.classes, anchor_num=cfg.anchor_num)
    trainer = Trainer(model, cfg, steps_per_epoch=4, mesh=mesh)

    b, m = 2 * n, 8
    rng = np.random.RandomState(0)
    images = rng.randint(0, 255, (b, cfg.height, cfg.width, 3), np.uint8)
    labels = np.zeros((b, m, 5), np.float32)
    labels[:, 0] = [1, 0.5, 0.5, 0.25, 0.25]
    labels[:, 1] = [3, 0.3, 0.7, 0.10, 0.15]
    mask = np.zeros((b, m), bool)
    mask[:, :2] = True

    rows = slice(d * per, (d + 1) * per)       # this rank's rows
    batch = shard_batch(mesh, (images[rows], labels[rows], mask[rows]))
    trainer.step(*batch)
    metrics = trainer.step(*batch)
    total = float(metrics["total"])
    assert np.isfinite(total), f"non-finite loss {total}"
    if rank == 0:
        desc = "x".join(f"{mesh.shape[a]}{a[0]}" for a in mesh.axis_names)
        print(f"dryrun_multichip({n}): ok, mesh={desc}, "
              f"loss={total:.4f}, lr={float(metrics['lr']):.2e}",
              flush=True)
    torch.distributed.destroy_process_group()


def run_dryrun(n_devices: int, timeout: float = 300) -> None:
    """n gloo ranks on the CPU, each stepping the full training step on
    its data shard of the global batch (2·n rows); raises if any rank
    fails."""
    import subprocess
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fastdet_torch.parallel.dryrun", "--rank",
         str(r), str(n_devices), str(port)], cwd=repo, env=env)
        for r in range(n_devices)]
    try:
        codes = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise RuntimeError(f"dryrun_multichip({n_devices}): rank exit codes "
                           f"{codes}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        _rank_main(*(int(a) for a in sys.argv[2:5]))
    else:
        run_dryrun(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
