"""Subprocess helper of the tensor-parallel tests: one rank of a gloo job
on the CPU (imports no JAX).

    python tests/torch_tp_worker.py MODE RANK WORLD PORT DIR

DIR holds the case the test wrote (`case.npz`: the state dict under
`sd/<key>`, each run's `images`, `labels` and `mask` of the global batch;
`cfg.json`) and takes each rank's results.  With WORLD > 1 the job is a
(WORLD/2, 2) `make_mesh_2d`; rank r steps on its data index d = r // 2's
rows of the global batch.  WORLD 1 runs the same in one process (no
mesh), as the reference.

  * contract: the default f32 Trainer in three ways: "tp" (as shipped),
    "gather_sum" (the gather's backward sums the gradient over the model
    group before it keeps its slice) and "world_loss" (the loss's
    normalizers over the world, not the data group); writes
    `contract_<way>_<rank>.npz` (the gathered state dict and momentum
    buffers, the losses, the local shape of `first_conv`'s weight) and
    `mesh_<rank>.json` (coordinates and groups);
  * modes: the fused nhwc and fused s2d Trainers in f64 (B8's and B7's
    plain versions, `span_stages` from cfg.json), the default Trainer in
    bf16 and the anchor-free family's (in the run's dtype); writes
    `<run>_<world>_<rank>.npz`.
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
from fastdet_torch.models.registry import get_family  # noqa: E402
from fastdet_torch.parallel import (initialize_distributed,  # noqa: E402
                                    make_mesh_2d, tp)
from fastdet_torch.train.fused_forward import \
    build_fused_train_apply  # noqa: E402
from fastdet_torch.train.loss import compute_loss  # noqa: E402
from fastdet_torch.train.trainer import Trainer  # noqa: E402

N_MODEL = 2


def load_case(out):
    with np.load(os.path.join(out, "case.npz")) as z:
        case = {k: z[k] for k in z.files}
    with open(os.path.join(out, "cfg.json")) as f:
        meta = json.load(f)
    sd = {k[3:]: torch.from_numpy(v) for k, v in case.items()
          if k.startswith("sd/")}
    return case, sd, meta


def save_run(path, tr, losses, **extra):
    """The full (gathered) state dict and momentum buffers, the losses."""
    names = dict(tr.model.named_parameters())
    mom = {k: tr.optimizer.state[p]["momentum_buffer"]
           for k, p in names.items()}
    if tr.tp_specs is not None:
        mom = tp.gather_state(mom, tr.mesh, tr.tp_specs)
    np.savez(path, **{"sd/" + k: v.detach().float().numpy()
                      if v.dtype == torch.bfloat16 else v.detach().numpy()
                      for k, v in tr.full_state_dict().items()},
             **{"mom/" + k: v.numpy() for k, v in mom.items()},
             losses=np.asarray(losses), **extra)


def run_steps(tr, images, labels, mask, mesh, pack=None):
    n_data = 1 if mesh is None else mesh.n_data
    d = 0 if mesh is None else mesh.coords[0]
    b = images.shape[1] // n_data
    rows = slice(d * b, (d + 1) * b)
    losses = []
    for i in range(len(images)):
        x = images[i][rows]
        m = tr.step(pack(x) if pack else x, labels[i][rows], mask[i][rows])
        losses.append([float(m[k]) for k in ("box", "obj", "cls", "total")])
    return losses


def contract(rank, world, mesh, out):
    case, sd, meta = load_case(out)
    cfg = Config.from_dict(meta["cfg"])
    coords = mesh.coords
    with open(os.path.join(out, f"mesh_{rank}.json"), "w") as f:
        json.dump({"coords": list(coords), "shape": mesh.shape,
                   "axis_names": list(mesh.axis_names),
                   "data": torch.distributed.get_process_group_ranks(
                       mesh.data_group),
                   "model": torch.distributed.get_process_group_ranks(
                       mesh.model_group)}, f)

    def world_loss(*args, group=None):
        return compute_loss(*args, group=torch.distributed.group.WORLD)

    backward = tp._GatherFromModel.backward

    def summed(ctx, g):
        g = g.contiguous().clone()
        torch.distributed.all_reduce(g, group=mesh.model_group)
        return backward(ctx, g)

    for way in ("tp", "gather_sum", "world_loss"):
        model = Detector(classes=cfg.classes, anchor_num=cfg.anchor_num)
        model.load_state_dict(sd)
        tr = Trainer(model, cfg, meta["steps_per_epoch"], device="cpu",
                     mesh=mesh, loss_fn=world_loss if way == "world_loss"
                     else compute_loss)
        tp._GatherFromModel.backward = staticmethod(
            summed if way == "gather_sum" else backward)
        try:
            losses = run_steps(tr, case["images"], case["labels"],
                               case["mask"], mesh)
        finally:
            tp._GatherFromModel.backward = staticmethod(backward)
        save_run(os.path.join(out, f"contract_{way}_{rank}.npz"), tr,
                 losses, first_conv=np.asarray(
                     tr.model.backbone.first_conv.conv.weight.shape))


def modes(rank, world, mesh, out):
    from fastdet_torch.kernels.fused_infer import pack_images_s2d
    case, sd, meta = load_case(out)
    group = None if mesh is None else mesh.data_group

    def pack(images):
        return torch.from_numpy(pack_images_s2d(images))

    for run in meta["runs"]:
        name, cfg = run["name"], Config.from_dict(run["cfg"])
        images, labels, mask = (case[f"{name}/{k}"]
                                for k in ("images", "labels", "mask"))
        fmt = run.get("format")
        if run.get("family") == "anchorfree":
            fam = get_family("anchorfree", cfg,
                             getattr(torch, run.get("dtype", "float32")))
            fam.model.load_state_dict({k[3:]: v for k, v in (
                (k, torch.from_numpy(case[k])) for k in case
                if k.startswith("af/"))})
            tr = Trainer(fam.model, cfg, 1, device="cpu", mesh=mesh,
                         loss_fn=fam.loss_fn)
        else:
            dtype = getattr(torch, run["dtype"])
            if dtype == torch.bfloat16:
                model = Detector(cfg.classes, cfg.anchor_num, dtype=dtype)
                model.load_state_dict(sd)
            else:
                model = Detector(cfg.classes, cfg.anchor_num)
                model.load_state_dict(sd)
                model = model.to(dtype)
            tr = Trainer(model, cfg, 1, device="cpu", mesh=mesh,
                         fused_backbone=fmt is not None,
                         fused_input_format=fmt or "nhwc")
            if fmt is not None:
                tr._fused = build_fused_train_apply(
                    tr.input_hw, input_format=fmt, device="cpu",
                    span_stages=tuple(run["span_stages"]), group=group)
        losses = run_steps(tr, images, labels, mask, mesh,
                           pack if fmt == "s2d_u8" else None)
        save_run(os.path.join(out, f"{name}_{world}_{rank}.npz"), tr,
                 losses)


def main():
    mode, rank, world, port, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(2)
    mesh = None
    if world > 1:
        initialize_distributed(f"localhost:{port}", world, rank,
                               backend="gloo")
        mesh = make_mesh_2d(world // N_MODEL, N_MODEL, devices=["cpu"])
    {"contract": contract, "modes": modes}[mode](rank, world, mesh, out)
    if world > 1:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
