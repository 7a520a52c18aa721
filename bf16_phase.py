#!/usr/bin/env python3
"""Smoke phase 9 (bf16 serving) of `chip_smoke.py` alone, on one NVIDIA
card: the bf16 kernels against their plain versions, `FusedPipeline(
dtype=None)` behind the HTTP server and at b128 352² against the f32
pipeline, each bf16 kernel's time, bound and cuDNN's bf16 time, the flag
combinations, 640² and the anchor-free family in bf16.  About a minute
where the full smoke takes three; for iterating on the bf16 path.

    python3 bf16_phase.py

Run from the repository root.  It builds the kernels as phase 1 does and
sets up what phase 9 takes from the phases before it: the reference
weights, phase 4's served photos, the f32 FusedPipeline and phase 8d's
seeded full-width anchor-free model.  It sits beside `chip_smoke.py`
because it reuses the smoke's phases and helpers.
"""

import os
import sys


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bf16_phase: no CUDA card", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    for path in (repo, os.path.join(repo, "tests")):
        if path not in sys.path:
            sys.path.insert(0, path)
    import chip_smoke as cs
    from fastdet_torch import disable_tf32
    from fastdet_torch.config import Config
    from fastdet_torch.io import load_state_dict
    from fastdet_torch.serve import FusedPipeline
    card = cs.phase_device()
    disable_tf32(torch.device("cuda"))
    photo = cs.read_png_bgr(cs.PHOTO)
    sd = load_state_dict(cs.WEIGHTS)
    images, big = cs.served_batch(photo)
    fused_pipe = FusedPipeline(sd, Config.from_file(cs.DATA),
                               dtype=torch.float32)
    host = cs.photo_variants(photo, 128, seed=61)
    af_sd = cs.af_full_width_model(
        torch.from_numpy(host).cuda().float() / 255.0).state_dict()
    launches, out = cs.phase_bf16(sd, photo, card, images, big, fused_pipe,
                                  af_sd)
    cs.log(f"bf16 launches on their main paths: {launches}")
    for name, (ms, plain, bound_ms, by, err, lib) in out.items():
        cs.log(f"  {name}: {ms:.4f} ms, plain {plain:.4f}, bound "
               f"{bound_ms:.4f} ({by}), cuDNN bf16 {lib:.4f}, max |Δ| "
               f"{err:.3g}")
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
