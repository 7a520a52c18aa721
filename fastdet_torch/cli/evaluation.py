"""Dataset evaluation CLI (counterpart of cli/evaluation.py, argparse
parity): runs the val set twice, mAP at conf 0.01 (NMS window 2048) and
P/R/F1 at conf 0.3 (window 1024), and prints the same summary line.

Usage, from the repository root:
  python -m fastdet_torch.cli.evaluation --data data/coco.data \\
      --weights weights/coco2017-ref.npz [--fused] [--batch 32] \\
      [--device cpu]

Runs on CUDA unless `--device cpu` is given.  The default mode runs the
family's model through its detect builder (`models/registry.py`); `--fused`
runs the fused forward (`build_fused_forward`, the host packs s2d(4) in
numpy).  `--int8 PATH` evaluates the int8 PTQ forward of a `quantize`
artifact (`fastdet_torch.quant.forward_from`, the default MAC); the
family comes from the artifact and `--weights` is not needed.  For
Yolo-FastestV2 both windows exceed 384, so on the card every pass goes
through the `nms_keep` kernel.  `--model anchorfree` decodes the
single-scale maps and suppresses with `batched_nms` in every mode, as the
JAX CLI does.

Multi-process, as the JAX CLI: the FASTDET_* variables (see
`fastdet_torch.cli.train`) start a job; each process evaluates its shard
of the val set (`DataLoader(shard=(rank, n))`) and the statistics are
all-gathered, so that every process prints the global metrics.

The data loader reads images with cv2, which the card's machine lacks;
`run_evaluation` takes the batches from its caller, so that
`chip_smoke.py` drives the same chain with in-memory batches.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, Iterable

import numpy as np
import torch

from fastdet_torch import disable_tf32, resolve_device
from fastdet_torch.config import Config
from fastdet_torch.eval.runner import evaluate
from fastdet_torch.io import load_state_dict
from fastdet_torch.kernels.fused_infer import (build_fused_forward,
                                               pack_images_s2d)
from fastdet_torch.models.anchorfree import decode_anchorfree
from fastdet_torch.models.registry import family_name, get_family
from fastdet_torch.ops.nms import batched_nms
from fastdet_torch.ops.postprocess import postprocess
from fastdet_torch.parallel import initialize_distributed, make_mesh
from fastdet_torch.quant import forward_from, infer_family, load_quantized

MAP_PASS = dict(conf_thres=0.01, iou_thres=0.4, max_nms=2048)
PR_PASS = dict(conf_thres=0.3, iou_thres=0.4, max_nms=1024)


def run_evaluation(cfg: Config, state_dict, batches: Callable[[int],
                                                              Iterable], *,
                   fused: bool, device=None, batch: int,
                   family: str = "yolo-fastestv2", int8=None,
                   distributed: bool = False):
    """The eval CLI after data loading: both passes over `batches(batch)`,
    which yields (images_u8 (B,H,W,3) with B ≤ batch, labels (B,M,5)
    normalized [cls,cx,cy,w,h], label_mask (B,M)) and is called once per
    pass, for the model family `family` (`models/registry.py`) whose
    weights `state_dict` holds.  `int8=(qw, scales)` (`load_quantized`)
    evaluates the int8 forward instead, of the artifact's own family;
    `state_dict` and `fused` are then unused.  `distributed`: the batches
    are this process's shard of a job's val set, and the statistics are
    gathered over the job (`evaluate(distributed=True)`).  → (mAP pass,
    P/R pass), each `evaluate`'s (P, R, mAP, F1) or None."""
    dev = resolve_device(device)
    hw = (cfg.height, cfg.width)
    anchors = np.asarray(cfg.anchors, np.float32).reshape(
        cfg.num_scales, cfg.anchor_num, 2)
    if int8 is None and not fused:
        fam = get_family(family, cfg)
        fam.model.load_state_dict(state_dict)

        def make_detect(conf_thres, iou_thres, max_nms):
            return fam.build_detect_fn(conf_thres=conf_thres,
                                       iou_thres=iou_thres, max_nms=max_nms,
                                       device=dev)
    else:
        if int8 is not None:
            # the int8 graph through the same two passes (the JAX CLI's
            # quantized-accuracy run); the weights go to the card once
            anchorfree = infer_family(int8[0]) == "anchorfree"
            forward = forward_from(*int8, device=dev)
        else:
            disable_tf32(dev)
            anchorfree = family_name(family) == "anchorfree"
            # f32: the JAX eval CLI's fused pass is eval-grade precision
            # (cli/evaluation.py), not the bf16 that serving defaults to
            fwd, packed = build_fused_forward(
                state_dict, input_hw=hw, dtype=torch.float32, device=dev,
                head="anchorfree" if anchorfree else "yolo")

            def forward(images):
                xs = torch.from_numpy(pack_images_s2d(images.cpu().numpy()))
                return fwd(xs.to(dev), packed)

        def make_detect(conf_thres, iou_thres, max_nms):
            kw = dict(conf_thres=conf_thres, iou_thres=iou_thres,
                      max_nms=max_nms)

            @torch.inference_mode()
            def detect(images):
                outs = forward(images)
                if anchorfree:
                    return batched_nms(*decode_anchorfree(*outs, hw), **kw)
                return postprocess(outs, anchors, hw, **kw)
            return detect

    def on_device():
        for images, labels, mask in batches(batch):
            yield torch.as_tensor(images).to(dev), labels, mask

    print("computer mAP...")
    res_map = evaluate(make_detect(**MAP_PASS), on_device(), hw,
                       progress=True, distributed=distributed)
    print("computer PR...")
    res_pr = evaluate(make_detect(**PR_PASS), on_device(), hw,
                      progress=True, distributed=distributed)
    return res_map, res_pr


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=str, default="",
                        help="Specify training profile *.data")
    parser.add_argument("--weights", type=str, default="",
                        help="The path of the model weights (.npz/.pth)")
    parser.add_argument("--model", type=str, default="yolo-fastestv2",
                        help="model family: yolo-fastestv2 | anchorfree")
    parser.add_argument("--batch", type=int, default=0,
                        help="override eval batch size")
    parser.add_argument("--fused", action="store_true",
                        help="evaluate through the fused forward (s2d "
                             "input layout, stem and span kernels)")
    parser.add_argument("--int8", type=str, default="",
                        help="evaluate int8 PTQ inference from a quantize "
                             "artifact (.npz) instead of f32 weights")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    opt = parser.parse_args(argv)

    family = family_name(opt.model)
    cfg = Config.from_file(opt.data)
    assert opt.int8 or os.path.exists(opt.weights), "invalid weights path"
    print("eval config:")
    print("model_name:%s" % cfg.model_name)
    print("width:%d height:%d" % (cfg.width, cfg.height))
    print("val:%s" % cfg.val)
    print("model_path:%s" % opt.weights)

    # multi-process entry: the FASTDET_* variables start a job
    device, shard = opt.device, None
    if initialize_distributed(backend="gloo" if opt.device == "cpu"
                              else None):
        mesh = make_mesh(devices=None if opt.device == "cuda"
                         else [opt.device])
        print(f"distributed: process {mesh.rank + 1}/{mesh.size}")
        device, shard = mesh.device, (mesh.rank, mesh.size)

    from fastdet_torch.data import DarknetDataset, DataLoader
    if opt.int8:               # the artifact names its family
        int8, state_dict = load_quantized(opt.int8), None
    else:
        int8, state_dict = None, load_state_dict(opt.weights)
    batch_size = opt.batch or int(cfg.batch_size / (cfg.subdivisions or 1))
    val_ds = DarknetDataset(cfg.val, cfg.width, cfg.height, augment=None)

    def batches(bs):
        loader = DataLoader(val_ds, bs, shuffle=False, drop_last=False,
                            shard=shard)
        try:
            yield from loader
        finally:
            loader.close()

    res_map, res_pr = run_evaluation(cfg, state_dict, batches,
                                     fused=opt.fused, device=device,
                                     batch=batch_size, family=family,
                                     int8=int8, distributed=shard is not None)
    ap = res_map[2] if res_map else 0.0
    precision, recall, f1 = (res_pr[0], res_pr[1], res_pr[3]) if res_pr \
        else (0.0, 0.0, 0.0)
    print("Precision:%f Recall:%f AP:%f F1:%f" % (precision, recall, ap, f1))
    if shard is not None:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
