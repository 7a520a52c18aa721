#!/usr/bin/env python3
"""Smoke phase 11 (int8 PTQ) of `chip_smoke.py` alone, on one NVIDIA
card: `weights/coco-int8.npz` through `forward_from` at b128 352² with
both MACs against each other and the CPU, `calibrate` on the card, the
int8 detections against the f32 model's by the JAX package's rule,
`run_evaluation(int8=...)` beside f32, the forward's times, and
rank_decode_nms and nms_keep on the int8 path.

    python3 int8_phase.py

Run from the repository root.  It builds the kernels as phase 1 does and
sets up what phase 11 takes from the phases before it: the reference
weights, phase 4's f32 `DevicePipeline` and phase 7's 256 photo variants.
It sits beside `chip_smoke.py` because it reuses the smoke's phases and
helpers.
"""

import os
import sys


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("int8_phase: no CUDA card", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    for path in (repo, os.path.join(repo, "tests")):
        if path not in sys.path:
            sys.path.insert(0, path)
    import chip_smoke as cs
    from fastdet_torch.config import Config
    from fastdet_torch.io import load_state_dict
    from fastdet_torch.models import Detector
    from fastdet_torch.serve import DevicePipeline
    card = cs.phase_device()
    photo = cs.read_png_bgr(cs.PHOTO)
    sd = load_state_dict(cs.WEIGHTS)
    dev_pipe = DevicePipeline(Detector(80, 3), sd, Config.from_file(cs.DATA))
    images = cs.photo_variants(photo, 256, seed=7)
    launches, out = cs.phase_int8(sd, photo, card, dev_pipe, images)
    cs.log(f"int8 path launches: {launches}")
    for name, (ms, plain, bound_ms, by, err) in out.items():
        cs.log(f"  {name}: {ms:.4f} ms, plain {plain:.4f}, bound "
               f"{bound_ms:.6f} ({by}), max |Δ| {err:.3g}")
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
