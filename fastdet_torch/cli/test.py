"""Single-image detection CLI (counterpart of cli/test.py, argparse
parity): detect on one image, print one line per detection and write the
image with the boxes drawn.

Usage, from the repository root:
  python -m fastdet_torch.cli.test --data data/coco.data \\
      --weights weights/coco2017-ref.npz --img img.jpg --device cpu
  python -m fastdet_torch.cli.test --data data/coco.data \\
      --int8 weights/coco-int8.npz --img img.jpg --device cpu

The default mode runs the family's model through its detect builder
(`models/registry.py`); `--fused` runs `FusedPipeline` in f32; `--int8`
runs the int8 forward of a `quantize` artifact (the family is the
artifact's) into the postprocess (anchor-based: `postprocess`, window
1024; anchor-free: `decode_anchorfree` + `batched_nms`).  Boxes are
scaled back to the image with the (h/H, w/W) factors of the JAX CLI.

The image is read, resized and drawn with cv2, which the card's machine
lacks, so in practice this CLI runs on the CPU (`--device cpu`); the
device defaults to CUDA as every entry point's does.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=str, default="",
                        help="Specify training profile *.data")
    parser.add_argument("--weights", type=str, default="",
                        help="The path of the model weights (.npz)")
    parser.add_argument("--img", type=str, default="",
                        help="The path of test image")
    parser.add_argument("--output", type=str, default="test_result.png")
    parser.add_argument("--model", type=str, default="yolo-fastestv2",
                        help="model family: yolo-fastestv2 | anchorfree")
    parser.add_argument("--conf", type=float, default=0.3)
    parser.add_argument("--nms", type=float, default=0.4)
    parser.add_argument("--fused", action="store_true",
                        help="run the fused serving path (FusedPipeline, "
                             "f32; s2d input layout)")
    parser.add_argument("--int8", type=str, default="",
                        help="run int8 PTQ inference from a quantize "
                             "artifact (.npz) instead of f32 weights")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    opt = parser.parse_args(argv)

    import cv2
    import torch

    from fastdet_torch import resolve_device
    from fastdet_torch.config import Config, load_names, resolve_path
    from fastdet_torch.io import load_state_dict
    from fastdet_torch.models.registry import family_name, get_family
    cfg = Config.from_file(opt.data)
    assert opt.int8 or os.path.exists(opt.weights), "invalid weights path"
    assert os.path.exists(opt.img), "invalid test image path"
    dev = resolve_device(opt.device)
    family = family_name(opt.model)

    ori_img = cv2.imread(opt.img)
    res_img = cv2.resize(ori_img, (cfg.width, cfg.height),
                         interpolation=cv2.INTER_LINEAR)
    batch = torch.from_numpy(res_img[None]).to(dev)

    if opt.int8:
        from fastdet_torch.models.anchorfree import decode_anchorfree
        from fastdet_torch.ops.nms import batched_nms
        from fastdet_torch.ops.postprocess import postprocess
        from fastdet_torch.quant import (forward_from, infer_family,
                                         load_quantized)
        qw, scales = load_quantized(opt.int8)
        fwd = forward_from(qw, scales, device=dev)
        anchors = np.asarray(cfg.anchors, np.float32).reshape(-1, 3, 2)
        hw = (cfg.height, cfg.width)

        if infer_family(qw) == "anchorfree":
            def detect(im):
                return batched_nms(*decode_anchorfree(*fwd(im), hw),
                                   conf_thres=opt.conf, iou_thres=opt.nms)
        else:
            def detect(im):
                return postprocess(fwd(im), anchors, hw,
                                   conf_thres=opt.conf, iou_thres=opt.nms)
    elif opt.fused:
        from fastdet_torch.kernels.fused_infer import pack_images_s2d
        from fastdet_torch.serve import FusedPipeline
        pipe = FusedPipeline(load_state_dict(opt.weights), cfg,
                             conf_thres=opt.conf, iou_thres=opt.nms,
                             dtype=torch.float32, device=dev, family=family)
        batch = torch.from_numpy(pack_images_s2d(res_img[None])).to(dev)
        detect = pipe.detect
    else:
        fam = get_family(family, cfg)
        fam.model.load_state_dict(load_state_dict(opt.weights))
        detect = fam.build_detect_fn(conf_thres=opt.conf,
                                     iou_thres=opt.nms, device=dev)

    def timed():
        out = detect(batch)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out

    timed()                                   # kernel builds, cuDNN set-up
    start = time.perf_counter()
    dets, counts = timed()
    end = time.perf_counter()
    print("forward time:%fms" % ((end - start) * 1000.0))

    names_path = resolve_path(cfg.names, opt.data)
    names = load_names(names_path) \
        if names_path and os.path.exists(names_path) \
        else [str(i) for i in range(cfg.classes)]

    h, w, _ = ori_img.shape
    scale_h, scale_w = h / cfg.height, w / cfg.width

    dets = dets[0][:int(counts[0])].cpu().numpy()
    for box in dets.tolist():
        obj_score = box[4]
        category = names[int(box[5])]
        x1, y1 = int(box[0] * scale_w), int(box[1] * scale_h)
        x2, y2 = int(box[2] * scale_w), int(box[3] * scale_h)
        cv2.rectangle(ori_img, (x1, y1), (x2, y2), (255, 255, 0), 2)
        cv2.putText(ori_img, "%.2f" % obj_score, (x1, y1 - 5), 0, 0.7,
                    (0, 255, 0), 2)
        cv2.putText(ori_img, category, (x1, y1 - 25), 0, 0.7,
                    (0, 255, 0), 2)
        print(f"{category} {obj_score:.3f} [{x1},{y1},{x2},{y2}]")

    cv2.imwrite(opt.output, ori_img)
    print(f"saved {opt.output} ({len(dets)} detections)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
