#!/usr/bin/env python3
"""Smoke phase 10 (bf16 training) of `chip_smoke.py` alone, on one NVIDIA
card: the bf16 forms of the training kernels B8 and B7 against their
plain bf16 versions, each with its time, bound, plain time and cuDNN's
bf16 time; the Trainer in bf16 (default, --fused-backbone, fused s2d at
ghost group 1 and 16) at b128 352² from the reference weights, its bf16
kernel launches counted from 0, each fused step against the same step on
the plain versions, and ms/step, img/s and the device busy share beside
the f32 step (timed here).  For iterating on the bf16 training path.

    python3 bf16_train_phase.py

Run from the repository root.  It builds the kernels as phase 1 does and
sets up what phase 10 takes from the phases before it: the reference
weights, the photo and the DevicePipeline that labels the training batch.
It sits beside `chip_smoke.py` because it reuses the smoke's phases and
helpers.
"""

import os
import sys


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bf16_train_phase: no CUDA card", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    for path in (repo, os.path.join(repo, "tests")):
        if path not in sys.path:
            sys.path.insert(0, path)
    import chip_smoke as cs
    from fastdet_torch import disable_tf32
    from fastdet_torch.config import Config
    from fastdet_torch.io import load_state_dict
    from fastdet_torch.models import Detector
    from fastdet_torch.serve import DevicePipeline
    card = cs.phase_device()
    disable_tf32(torch.device("cuda"))
    photo = cs.read_png_bgr(cs.PHOTO)
    sd = load_state_dict(cs.WEIGHTS)
    dev_pipe = DevicePipeline(Detector(), sd, Config.from_file(cs.DATA))
    launches, out = cs.phase_bf16_train(sd, photo, dev_pipe, card, None)
    cs.log(f"bf16 training launches on their main paths: {launches}")
    for name, (ms, plain, bound_ms, by, err, lib) in out.items():
        cs.log(f"  {name}: {ms:.4f} ms, plain {plain:.4f}, bound "
               f"{bound_ms:.4f} ({by}), cuDNN bf16 {lib:.4f}, max |Δ| "
               f"{err:.3g}")
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
