"""Model export CLI (counterpart of cli/export.py, argparse parity; fills
the role of the reference's pytorch2onnx.py): serializes the deploy-mode
forward (activations and the per-scale NHWC concat baked in, the weights
embedded) as a `torch.export` program in a `.pt2` archive, which
`fastdet_torch.export.load_exported` reads back.

Usage, from the repository root:
  python -m fastdet_torch.cli.export --data data/coco.data \\
      --weights weights/coco2017-ref.npz [--output model.pt2] [--batch N] \\
      [--int8 weights/coco-int8.npz] [--mlir] [--device cpu]

It exports `Detector(classes, anchor_num)` from f32 weights, or with
`--int8` the int8 deploy forward of a quantized artifact of either family
(the family read from the artifact's op names).  The program runs on the
device it was exported on: CUDA unless `--device cpu` is given.  `--mlir`
keeps JAX's flag name; the artifact is not StableHLO, so it writes the
exported program's printed graph to `<output>.graph.txt`.
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
                        help="The path of the model weights to export")
    parser.add_argument("--output", type=str, default="./model.pt2",
                        help="The path where the exported model is saved")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--int8", type=str, default="",
                        help="export the int8 PTQ deploy forward from a "
                             "quantize CLI artifact (.npz) instead of f32 "
                             "weights")
    parser.add_argument("--mlir", action="store_true",
                        help="also write the exported program's graph as "
                             "text (<output>.graph.txt)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu: where the program "
                             "runs")
    opt = parser.parse_args(argv)

    from fastdet_torch.config import Config
    cfg = Config.from_file(opt.data)
    assert opt.int8 or os.path.exists(opt.weights), "invalid weights path"
    hw = (cfg.height, cfg.width)

    from fastdet_torch.export import export_detector, export_graph_text
    if opt.int8:
        from fastdet_torch.export import export_quantized
        from fastdet_torch.quant import load_quantized
        qw, scales = load_quantized(opt.int8)
        blob = export_quantized(qw, scales, opt.output, input_hw=hw,
                                batch=opt.batch, device=opt.device)
        print(f"exported {len(blob)} bytes -> {opt.output}")
        return 0

    from fastdet_torch.io import load_state_dict
    from fastdet_torch.models import Detector
    model = Detector(classes=cfg.classes, anchor_num=cfg.anchor_num)
    state_dict = load_state_dict(opt.weights)
    blob = export_detector(model, state_dict, opt.output, input_hw=hw,
                           batch=opt.batch, device=opt.device)
    print(f"exported {len(blob)} bytes -> {opt.output}")
    if opt.mlir:
        with open(opt.output + ".graph.txt", "w") as f:
            f.write(export_graph_text(opt.output))
        print(f"wrote {opt.output}.graph.txt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
