#!/usr/bin/env python3
"""Smoke phase 13 (the deploy forward, export and the host pipelines) of
`chip_smoke.py` alone, on one NVIDIA card: `Detector(deploy=True)`
against the CPU, the f32 and int8 exports at b128 round trip,
`HybridPipeline` against `DevicePipeline`, `StreamingPipeline` over
`FusedPipeline` in bf16 and f32 with B1, B2 and B3 counted, and the bf16
`DevicePipeline` against f32.

    python3 deploy_phase.py

Run from the repository root.  It builds the kernels as phase 1 does and
sets up what phase 13 takes from the phases before it: the reference
weights, the photo, phase 4's served batch and f32 `DevicePipeline`, and
phase 4b's f32 `FusedPipeline`.  It sits beside `chip_smoke.py` because
it reuses the smoke's phases and helpers.
"""

import os
import sys


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("deploy_phase: no CUDA card", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    for path in (repo, os.path.join(repo, "tests")):
        if path not in sys.path:
            sys.path.insert(0, path)
    import chip_smoke as cs
    from fastdet_torch.config import Config
    from fastdet_torch.io import load_state_dict
    from fastdet_torch.models import Detector
    from fastdet_torch.serve import DevicePipeline, FusedPipeline
    card = cs.phase_device()
    photo = cs.read_png_bgr(cs.PHOTO)
    sd = load_state_dict(cs.WEIGHTS)
    cfg = Config.from_file(cs.DATA)
    dev_pipe = DevicePipeline(Detector(80, 3), sd, cfg)
    fused_pipe = FusedPipeline(sd, cfg, dtype=torch.float32)
    _, big = cs.served_batch(photo)
    launches = cs.phase_deploy(sd, photo, card, big, dev_pipe, fused_pipe)
    cs.log(f"phase 13 launches: {launches}")
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
