"""Post-training int8 quantization CLI (counterpart of cli/quantize.py,
argparse parity): calibrates activation scales over a set of images and
writes one `.npz` artifact (int8 kernels, weight scales, biases and
activation scales) in the JAX package's layout, which
`fastdet_torch.cli.evaluation --int8`, `fastdet_torch.cli.test --int8`
and the JAX package's CLIs read.

Usage, from the repository root:
  python -m fastdet_torch.cli.quantize --data data/coco.data \\
      --weights weights/coco2017-ref.npz --calib <image-dir | list.txt> \\
      --n 32 --output weights/coco-int8.npz [--device cpu]

Calibrates on CUDA unless `--device cpu` is given.  Unlike the JAX CLI,
which parses `--method` and `--percentile` but calibrates at their
defaults, this one passes both to `calibrate`; at the defaults the two
CLIs write the same artifact.  The image loader reads with cv2, which it
imports itself: the module imports on a machine without cv2, and there
`fastdet_torch.quant.calibrate` takes in-memory images.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

_IMG_EXT = (".jpg", ".jpeg", ".png", ".bmp")


def load_calib_images(source: str, n: int, size_wh) -> np.ndarray:
    """First `n` images from a directory (sorted) or a Darknet list file,
    resized to the network input (cv2 INTER_LINEAR, BGR, as the JAX CLI)
    → (n,H,W,3) uint8."""
    import cv2
    if os.path.isdir(source):
        paths = sorted(
            p for p in glob.glob(os.path.join(source, "*"))
            if p.lower().endswith(_IMG_EXT))
    else:
        with open(source) as f:
            paths = [ln.strip() for ln in f if ln.strip()]
    paths = paths[:n]
    if not paths:
        raise SystemExit(f"no calibration images found in {source}")
    imgs = []
    for p in paths:
        img = cv2.imread(p)
        if img is None:
            raise SystemExit(f"unreadable calibration image: {p}")
        imgs.append(cv2.resize(img, size_wh, interpolation=cv2.INTER_LINEAR))
    return np.stack(imgs).astype(np.uint8)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=str, required=True,
                        help="Specify training profile *.data")
    parser.add_argument("--weights", type=str, required=True,
                        help="f32 model weights (.npz)")
    parser.add_argument("--calib", type=str, default="",
                        help="calibration images: directory or list file "
                             "(default: the profile's val list)")
    parser.add_argument("--n", type=int, default=32,
                        help="number of calibration images")
    parser.add_argument("--batch", type=int, default=8,
                        help="calibration forward batch size")
    parser.add_argument("--method", type=str, default="percentile",
                        choices=("percentile", "max"),
                        help="activation calibration: percentile "
                             "histogram clip (robust, default) or max-|x|")
    parser.add_argument("--percentile", type=float, default=0.9999,
                        help="histogram clip point for --method "
                             "percentile")
    parser.add_argument("--output", type=str, required=True,
                        help="output artifact path (.npz)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    opt = parser.parse_args(argv)

    from fastdet_torch.config import Config, resolve_path
    from fastdet_torch.io import load_state_dict
    from fastdet_torch.quant import (calibrate, fold_model,
                                     quantize_weights, save_quantized)
    cfg = Config.from_file(opt.data)
    calib_src = opt.calib or resolve_path(cfg.val, opt.data)
    images = load_calib_images(calib_src, opt.n, (cfg.width, cfg.height))
    print(f"calibrating on {len(images)} images from {calib_src}")

    folded = fold_model(load_state_dict(opt.weights))
    scales = calibrate(folded, images, batch=opt.batch, method=opt.method,
                       percentile=opt.percentile, device=opt.device)
    qw = quantize_weights(folded)
    save_quantized(opt.output, qw, scales)
    size = os.path.getsize(opt.output) / 1024.0
    print(f"saved {opt.output} ({size:.0f} KiB, {len(qw)} quantized ops)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
