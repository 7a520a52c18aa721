"""HTTP detection server CLI (counterpart of cli/serve.py).

Usage, from the repository root:
  python -m fastdet_torch.cli.serve --data data/coco.data \\
      --weights weights/coco2017-ref.npz --port 8000 --batch 32

  curl -X POST -H 'X-Height: 352' -H 'X-Width: 352' \\
      --data-binary @img_352x352.bgr http://127.0.0.1:8000/detect_raw
  curl http://127.0.0.1:8000/stats

Runs on CUDA unless `--device cpu` is given.  `--pipeline fused` (the
default, as in the JAX CLI) serves through FusedPipeline: the host packs
each batch into the s2d(4) layout and the card runs the stem and span
kernels, in bf16 on the card and in f32 with `--device cpu`, as the JAX
CLI chooses bf16 on its accelerator and f32 elsewhere.  `--pipeline
device` serves through DevicePipeline.
`--model anchorfree` serves the anchor-free family through FusedPipeline
(`family="anchorfree"`); `--pipeline device` takes yolo-fastestv2 only
and exits with an error for it (the JAX package's DevicePipeline feeds any
model's maps to the anchor postprocess, which the anchor-free maps do not
fit).
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=str, default="",
                        help="Specify training profile *.data")
    parser.add_argument("--weights", type=str, default="",
                        help="The path of the model weights (.npz/.pth)")
    parser.add_argument("--model", type=str, default="yolo-fastestv2",
                        help="model family: yolo-fastestv2 | anchorfree")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--batch", type=int, default=32,
                        help="dynamic-batching max batch size")
    parser.add_argument("--max-wait-ms", type=float, default=5.0,
                        help="max time the oldest queued request waits "
                             "before a partial batch dispatches")
    parser.add_argument("--conf", type=float, default=0.3)
    parser.add_argument("--nms", type=float, default=0.4)
    parser.add_argument("--pipeline", type=str, default="fused",
                        choices=["fused", "device"],
                        help="fused = FusedPipeline (s2d uint8 input, stem "
                             "and span kernels); device = DevicePipeline")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--verbose", action="store_true",
                        help="log each HTTP request")
    opt = parser.parse_args(argv)

    from fastdet_torch.models.registry import family_name
    try:
        family = family_name(opt.model)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if opt.pipeline == "device" and family != "yolo-fastestv2":
        print(f"error: --pipeline device serves the yolo-fastestv2 family "
              f"only; serve {family} with --pipeline fused", file=sys.stderr)
        return 2
    if not os.path.exists(opt.weights):
        print(f"error: invalid weights path {opt.weights!r}", file=sys.stderr)
        return 2

    import numpy as np

    from fastdet_torch.config import Config, load_names, resolve_path
    from fastdet_torch.io import load_state_dict
    from fastdet_torch.models import Detector
    from fastdet_torch.serve import DevicePipeline, FusedPipeline
    from fastdet_torch.server import InferenceServer

    cfg = Config.from_file(opt.data)
    sd = load_state_dict(opt.weights)
    if opt.pipeline == "fused":
        import torch
        on_card = torch.device(opt.device).type == "cuda"
        pipe = FusedPipeline(sd, cfg, conf_thres=opt.conf,
                             iou_thres=opt.nms,
                             dtype=torch.bfloat16 if on_card
                             else torch.float32,
                             device=opt.device, family=family)
    else:
        pipe = DevicePipeline(Detector(cfg.classes, cfg.anchor_num), sd,
                              cfg, conf_thres=opt.conf, iou_thres=opt.nms,
                              device=opt.device)

    names_path = resolve_path(cfg.names, opt.data)
    names = load_names(names_path) \
        if names_path and os.path.exists(names_path) else None

    # run every batch bucket once (InferenceServer pads coalesced
    # batches to power-of-two buckets), so the first requests do not
    # pay cuDNN's per-shape set-up or the kernels' build
    b = 1
    while True:
        print(f"warming the {opt.pipeline} pipeline (batch={b})...")
        pipe(np.zeros((b, cfg.height, cfg.width, 3), np.uint8))
        if b >= opt.batch:
            break
        b *= 2

    server = InferenceServer(pipe, cfg, names=names, max_batch=opt.batch,
                             max_wait_ms=opt.max_wait_ms,
                             model_name=opt.model)
    server.serve_forever(opt.host, opt.port, quiet=not opt.verbose)
    return 0


if __name__ == "__main__":
    sys.exit(main())
