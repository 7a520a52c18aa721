"""Training CLI (counterpart of cli/train.py, argparse parity).

Usage, from the repository root:
  python -m fastdet_torch.cli.train --data data/coco.data \\
      [--bf16] [--fused-backbone] [--eval_every 10] [--device cpu]

Finetunes from the `.data` file's `pre_weights` when that path exists
(tensors of matching name and shape load, the rest keep the seeded
init), trains with SGD m=0.949 wd=5e-4, quartic warmup over 5 epochs of
batches then ×0.1 at the milestones, gradient accumulation over
`subdivisions`, prints the JAX CLI's progress line every 10th batch and
at the end of an epoch, and every `--eval_every` epochs evaluates the val
set in two passes (mAP at conf 0.01 with a 2048 window, P/R/F1 at conf
0.3 with 1024) and saves AP-stamped weights
(`<weights_dir>/<name>-<epoch>-epoch-<ap>ap-model.npz`, in the JAX
variable layout, so `fastdet` loads them) and a full-state checkpoint
that `--resume` continues from.

Runs on CUDA unless `--device cpu` is given.  `--fused-backbone` runs the
backbone's stride-1 spans through the training span kernel B8 (ghost
BN); it takes the yolo-fastestv2 family only, as in the JAX CLI.
`--model anchorfree` trains the anchor-free family with its loss and
evaluates it with its detect builder (`models/registry.py`).  `--bf16`
trains in bfloat16 as the JAX CLI does: the family's model computes in
bf16 (parameters, gradients and momentum f32; with `--fused-backbone` the
bf16 forms of the span kernel), while the evaluation at eval epochs and
the saved weights stay f32.  `--backbone` initialises the backbone from
a reference `.pth` backbone checkpoint or a `.npz` (backbone-only or
whole), as the JAX CLI does, when no `pre_weights` finetune applies.  Not
ported, it raises naming its ROADMAP item: multi-process jobs through the
FASTDET_* environment variables (A12).

The data loader reads images with cv2, which the card's machine lacks;
`run_training` takes the batches from its caller, so that
`chip_smoke.py` drives the same loop with in-memory batches.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Iterable, Optional

import torch

from fastdet_torch import resolve_device
from fastdet_torch.cli.evaluation import run_evaluation
from fastdet_torch.config import Config
from fastdet_torch.io import (latest_step, load_checkpoint, load_state_dict,
                              load_torch_weights, merge_variables,
                              save_checkpoint, save_npz_variables)
from fastdet_torch.models.registry import family_name, get_family
from fastdet_torch.train.trainer import Trainer
from fastdet_torch.utils import MetricsLogger, StepTimer, trace


def run_training(cfg: Config, state_dict, batches: Callable[[int], Iterable],
                 *, fused_backbone: bool = False, device=None,
                 steps: Optional[int] = None,
                 steps_per_epoch: Optional[int] = None,
                 val_batches: Optional[Callable[[int], Iterable]] = None,
                 eval_every: int = 10, weights_dir: Optional[str] = None,
                 ckpt_dir: Optional[str] = None, resume: bool = False,
                 profile: str = "", mlog: Optional[MetricsLogger] = None,
                 family: str = "yolo-fastestv2",
                 dtype: torch.dtype = torch.float32) -> Trainer:
    """The train CLI after data loading.  `batches(epoch)` yields
    (images_u8 (B,H,W,3), labels (B,M,5) normalized [cls,cx,cy,w,h],
    label_mask (B,M)) for one epoch; `steps_per_epoch` (the schedule's)
    defaults to `len(batches(0))`.  Trains `cfg.epochs` epochs, or stops
    after `steps` micro-steps.  `val_batches(batch)` (optional) feeds the
    periodic evaluation.  `family` names the model family
    (`models/registry.py`) whose weights `state_dict` holds; `dtype`
    its compute dtype (bfloat16 for `--bf16`; the evaluation stays f32).
    → the Trainer."""
    dev = resolve_device(device)
    fam = get_family(family, cfg, dtype=dtype)
    fam.model.load_state_dict(state_dict)
    spe = steps_per_epoch or len(batches(0))
    trainer = Trainer(fam.model, cfg, spe, fused_backbone=fused_backbone,
                      device=dev, loss_fn=fam.loss_fn)
    mlog = mlog or MetricsLogger(None)
    timer = StepTimer()
    bsz = int(cfg.batch_size / (cfg.subdivisions or 1))

    start_epoch = 0
    if resume and ckpt_dir:
        step = latest_step(ckpt_dir)
        if step is not None:
            trainer.load_state_dict(load_checkpoint(ckpt_dir, step))
            start_epoch = int(step)
            print(f"Resumed from epoch {start_epoch}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    print("Starting training for %g epochs..." % cfg.epochs)
    done = 0
    for epoch in range(start_epoch, cfg.epochs):
        t_epoch = time.time()
        for i, (images, labels, mask) in enumerate(batches(epoch)):
            if steps is not None and done >= steps:
                break
            done += 1
            if profile and epoch == start_epoch and i == 4:
                with trace(profile):
                    trainer.step(images, labels, mask)
                    sync()
                print(f"profiler trace written to {profile}")
                continue
            with timer:
                metrics = trainer.step(images, labels, mask)
            if i % 10 == 0 or i == spe - 1:
                m = {k: float(v) for k, v in metrics.items()}
                mlog.log(trainer.step_count, m)
                print("Epoch:%d %d/%d LR:%f CIou:%f Obj:%f Cls:%f Total:%f"
                      % (epoch, i, spe, m["lr"], m["box"], m["obj"],
                         m["cls"], m["total"]), flush=True)
        ts = timer.summary()
        print("epoch %d took %.1fs (step p50 %.1f ms)"
              % (epoch, time.time() - t_epoch, ts.get("p50_ms", 0.0)))

        if (epoch % eval_every == 0 and epoch > 0
                and val_batches is not None):
            eval_sd = {k: v.detach().clone()
                       for k, v in trainer.model.state_dict().items()}
            res_map, res_pr = run_evaluation(cfg, eval_sd, val_batches,
                                             fused=False, device=dev,
                                             batch=bsz, family=fam.name)
            ap = res_map[2] if res_map else 0.0
            precision, recall, f1 = (res_pr[0], res_pr[1], res_pr[3]) \
                if res_pr else (0.0, 0.0, 0.0)
            print("Precision:%f Recall:%f AP:%f F1:%f"
                  % (precision, recall, ap, f1))
            if weights_dir:
                out = os.path.join(weights_dir, "%s-%d-epoch-%fap-model.npz"
                                   % (cfg.model_name, epoch, ap))
                save_npz_variables(eval_sd, out)
                print("saved", out)
            if ckpt_dir:
                # step = completed epochs: --resume continues at epoch+1
                save_checkpoint(ckpt_dir, epoch + 1, trainer.state_dict())
        if steps is not None and done >= steps:
            break

    if ckpt_dir and steps is None:
        save_checkpoint(ckpt_dir, cfg.epochs, trainer.state_dict())
    if weights_dir and steps is None:
        save_npz_variables(trainer.model.state_dict(), os.path.join(
            weights_dir, "%s-final-model.npz" % cfg.model_name))
    return trainer


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=str, default="",
                        help="Specify training profile *.data")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint")
    parser.add_argument("--ckpt_dir", type=str, default="checkpoints")
    parser.add_argument("--weights_dir", type=str, default="weights")
    parser.add_argument("--eval_every", type=int, default=10)
    parser.add_argument("--fused-backbone", action="store_true",
                        help="train the backbone's stride-1 spans through "
                             "the training span kernel (ghost BN)")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute (f32 parameters; the "
                             "evaluation stays f32)")
    parser.add_argument("--chain", type=int, default=1,
                        help="accepted for parity with the JAX CLI: the "
                             "port runs the K = max(1, --chain) steps of a "
                             "chain one after another, which is the same "
                             "arithmetic (--chain 0 or less trains step by "
                             "step, as --chain 1)")
    parser.add_argument("--summary", action="store_true",
                        help="print the model parameter table at startup")
    parser.add_argument("--profile", type=str, default="",
                        help="capture a torch.profiler trace of one step "
                             "into this directory")
    parser.add_argument("--logdir", type=str, default="",
                        help="append per-step metrics to <logdir>/train.jsonl")
    parser.add_argument("--tb", action="store_true",
                        help="also write TensorBoard event files under "
                             "<logdir>/train_tb (requires --logdir)")
    parser.add_argument("--model", type=str, default="yolo-fastestv2",
                        help="model family: yolo-fastestv2 | anchorfree")
    parser.add_argument("--backbone", type=str, default="",
                        help="pretrained backbone weights (.pth/.npz) to "
                             "initialize from when not finetuning")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    opt = parser.parse_args(argv)

    family = family_name(opt.model)
    if opt.fused_backbone and family != "yolo-fastestv2":
        raise SystemExit("--fused-backbone supports the yolo-fastestv2 "
                         "family only")
    if any(os.environ.get(v) for v in ("FASTDET_COORDINATOR",
                                       "FASTDET_NUM_PROCESSES",
                                       "FASTDET_PROCESS_ID")):
        raise NotImplementedError(
            "fastdet_torch: multi-process training is ROADMAP A12, not "
            "ported yet")
    chain = max(1, opt.chain)          # as the JAX CLI clamps it

    cfg = Config.from_file(opt.data)
    print("train config:")
    print(cfg.to_dict())

    from fastdet_torch.data import DarknetDataset, DataLoader, default_augment
    train_ds = DarknetDataset(cfg.train, cfg.width, cfg.height,
                              augment=default_augment)
    val_ds = DarknetDataset(cfg.val, cfg.width, cfg.height, augment=None)
    batch_size = int(cfg.batch_size / (cfg.subdivisions or 1))
    nw = min(os.cpu_count() or 1, batch_size if batch_size > 1 else 1, 8)
    train_loader = DataLoader(train_ds, batch_size, shuffle=True,
                              drop_last=True, num_workers=nw)

    # seeded init; pre_weights merge with strict=False semantics
    # (matching tensors load, the rest keep the fresh init)
    torch.manual_seed(0)
    model = get_family(family, cfg).model
    state_dict = model.state_dict()
    if cfg.pre_weights and os.path.exists(cfg.pre_weights):
        state_dict, n_load, n_keep = merge_variables(
            state_dict, load_state_dict(cfg.pre_weights))
        print("Load finetune model param: %s (%d tensors loaded, %d fresh)"
              % (cfg.pre_weights, n_load, n_keep))
    elif opt.backbone and os.path.exists(opt.backbone):
        bb = (load_torch_weights(opt.backbone, backbone_only=True)
              if opt.backbone.endswith((".pth", ".pt"))
              else load_state_dict(opt.backbone))
        if not any(k.startswith("backbone.") for k in bb):
            bb = {"backbone." + k: v for k, v in bb.items()}
        state_dict, n_load, _ = merge_variables(state_dict, bb)
        print("Initialize backbone from %s (%d tensors loaded)"
              % (opt.backbone, n_load))
    else:
        print("Initialize weights randomly (no pre_weights)")
    if opt.summary:
        from fastdet_torch.utils import summarize_model
        print(summarize_model(model, (1, cfg.height, cfg.width, 3)))
    if chain > 1:
        print(f"chaining {chain} train steps: run one after another")
    os.makedirs(opt.weights_dir, exist_ok=True)

    def batches(epoch):
        train_loader.set_epoch(epoch)
        return train_loader

    def val_batches(bs):
        loader = DataLoader(val_ds, bs, shuffle=False, drop_last=False,
                            num_workers=nw)
        try:
            yield from loader
        finally:
            loader.close()

    mlog = MetricsLogger(opt.logdir or None, "train", tensorboard=opt.tb)
    try:
        run_training(cfg, state_dict, batches, family=family,
                     fused_backbone=opt.fused_backbone, device=opt.device,
                     steps_per_epoch=len(train_loader),
                     val_batches=val_batches, eval_every=opt.eval_every,
                     weights_dir=opt.weights_dir, ckpt_dir=opt.ckpt_dir,
                     resume=opt.resume, profile=opt.profile, mlog=mlog,
                     dtype=torch.bfloat16 if opt.bf16 else torch.float32)
    finally:
        mlog.close()
        train_loader.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
