"""Subprocess helper of the data-parallel tests: one rank of a gloo job on
the CPU (imports no JAX).

    python tests/torch_dp_worker.py MODE RANK WORLD PORT DIR

DIR holds the case the test wrote (`case.npz`: the port's state dict
under `sd/<key>`, the steps' `images`, `labels` and `mask` of the global
batch; `cfg.json`), and takes each rank's results.  Each rank steps on
its contiguous rows of the global batch (rank r: rows [r·b, (r+1)·b)).

  * gather: the ragged `gather_eval_stats` of tests/test_multihost.py's
    worker (an empty tuple on rank 0) and `process_shard(10)`; writes
    `gather_<rank>.npz`;
  * trainer: `Trainer(mesh=make_mesh(devices=["cpu"]))` over the steps,
    three ways: "global" (as shipped), "local_norm" (each rank's loss
    normalized by its own rows and the gradients averaged, as
    DistributedDataParallel computes a rank-local mean loss) and
    "no_bn_sync" (the BatchNorms without the group); writes
    `trainer_<way>_<rank>.npz` (state dict, momentum buffers, losses);
  * fused: the fused s2d Trainer (B7's and B8's plain versions) with
    `span_stages` from cfg.json, the same outputs as `trainer_fused_...`;
    then the default span stages, whose ghost groups straddle the ranks,
    and writes the `NotImplementedError` text to `straddle_<rank>.txt`.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from fastdet_torch.config import Config  # noqa: E402
from fastdet_torch.models import Detector  # noqa: E402
from fastdet_torch.parallel import (gather_eval_stats,  # noqa: E402
                                    initialize_distributed, make_mesh,
                                    process_shard, sync_batchnorm)
from fastdet_torch.train.loss import compute_loss  # noqa: E402
from fastdet_torch.train.trainer import Trainer  # noqa: E402


def gather(rank, out):
    if rank == 0:
        stats = [(np.array([1., 0.]), np.array([0.9, 0.8]),
                  np.array([0., 1.])),
                 (np.zeros(0), np.zeros(0), np.zeros(0))]
        labels = [0.0, 1.0, 1.0]
    else:
        stats = [(np.array([1., 1., 0.]), np.array([0.7, 0.6, 0.5]),
                  np.array([0., 0., 2.]))]
        labels = [0.0, 2.0]
    gs, gl = gather_eval_stats(stats, labels)
    np.savez(os.path.join(out, f"gather_{rank}.npz"),
             lens=np.asarray([len(s[0]) for s in gs]),
             tp=np.concatenate([s[0] for s in gs]),
             conf=np.concatenate([s[1] for s in gs]),
             cls=np.concatenate([s[2] for s in gs]),
             labels=np.asarray(gl), shard=np.asarray(process_shard(10)),
             dtype=str(gs[0][0].dtype))


def load_case(out):
    with np.load(os.path.join(out, "case.npz")) as z:
        case = {k: z[k] for k in z.files}
    with open(os.path.join(out, "cfg.json")) as f:
        meta = json.load(f)
    sd = {k[3:]: torch.from_numpy(v) for k, v in case.items()
          if k.startswith("sd/")}
    return case, sd, meta


def save_run(path, tr, losses):
    names = dict(tr.model.named_parameters())
    mom = {k: tr.optimizer.state[p]["momentum_buffer"].numpy()
           for k, p in names.items()}
    np.savez(path, **{"sd/" + k: v.detach().numpy()
                      for k, v in tr.model.state_dict().items()},
             **{"mom/" + k: v for k, v in mom.items()},
             losses=np.asarray(losses))


def run_steps(tr, case, rank, world, pack=None):
    b = case["images"].shape[1] // world
    rows = slice(rank * b, (rank + 1) * b)
    losses = []
    for i in range(len(case["images"])):
        images = case["images"][i][rows]
        m = tr.step(pack(images) if pack else images,
                    case["labels"][i][rows], case["mask"][i][rows])
        losses.append([float(m[k]) for k in ("box", "obj", "cls", "total")])
    return losses


def trainer(rank, world, out):
    case, sd, meta = load_case(out)
    cfg = Config.from_dict(meta["cfg"])
    mesh = make_mesh(devices=["cpu"])

    def local_norm(*args, group=None):
        total, comps = compute_loss(*args)
        return total / world, {k: v / world for k, v in comps.items()}

    for way in ("global", "local_norm", "no_bn_sync"):
        model = Detector(classes=cfg.classes, anchor_num=cfg.anchor_num)
        model.load_state_dict(sd)
        tr = Trainer(model, cfg, meta["steps_per_epoch"], device="cpu",
                     mesh=mesh, loss_fn=local_norm if way == "local_norm"
                     else compute_loss)
        if way == "no_bn_sync":
            sync_batchnorm(tr.model, None)
        losses = run_steps(tr, case, rank, world)
        save_run(os.path.join(out, f"trainer_{way}_{rank}.npz"), tr,
                 losses)


def fused(rank, world, out):
    from fastdet_torch.kernels.fused_infer import pack_images_s2d
    from fastdet_torch.train.fused_forward import build_fused_train_apply
    case, sd, meta = load_case(out)
    cfg = Config.from_dict(meta["cfg"])
    mesh = make_mesh(devices=["cpu"]) if world > 1 else None
    group = None if mesh is None else mesh.group
    dtype = getattr(torch, meta.get("dtype", "float32"))

    def pack(images):
        return torch.from_numpy(pack_images_s2d(images))

    def make(span_stages):
        model = Detector(classes=cfg.classes, anchor_num=cfg.anchor_num)
        model.load_state_dict(sd)
        tr = Trainer(model.to(dtype), cfg, meta["steps_per_epoch"],
                     device="cpu", mesh=mesh, fused_backbone=True,
                     fused_input_format="s2d_u8")
        tr._fused = build_fused_train_apply(
            tr.input_hw, input_format="s2d_u8", device="cpu",
            span_stages=span_stages, group=group)
        return tr

    tr = make(tuple(meta["span_stages"]))
    losses = run_steps(tr, case, rank, world, pack)
    save_run(os.path.join(out, f"trainer_fused_{world}_{rank}.npz"), tr,
             losses)
    if world > 1:
        try:
            run_steps(make((2, 3, 4)), case, rank, world, pack)
            text = "no error"
        except NotImplementedError as e:
            text = str(e)
        with open(os.path.join(out, f"straddle_{rank}.txt"), "w") as f:
            f.write(text)


def main():
    mode, rank, world, port, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(2)
    initialize_distributed(f"localhost:{port}", world, rank,
                           backend="gloo")
    {"gather": lambda: gather(rank, out),
     "trainer": lambda: trainer(rank, world, out),
     "fused": lambda: fused(rank, world, out)}[mode]()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
