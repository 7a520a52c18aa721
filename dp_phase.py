#!/usr/bin/env python3
"""Smoke phase 14 (data parallel, ROADMAP A12) of `chip_smoke.py` alone,
on one NVIDIA card: two gloo ranks on the card and a 1-rank nccl job,
each `Trainer(mesh=)` in the default, fused s2d f32 and fused s2d bf16
modes against one process on the same global b128 batch, the distributed
evaluation against one process, and `ShardedPipeline` /
`FusedPipeline(mesh=)` in f32 and bf16 against the single-device
pipelines.

    python3 dp_phase.py
    python3 dp_phase.py --cards 4

Run from the repository root.  With `--cards N` (a machine with N
cards) it runs, in place of the phase, its reference and one job of N
nccl ranks, each on its own card (the layout a multi-card user runs),
held as phase 14 holds its jobs.  It builds the kernels as phase 1 does and
sets up what phase 14 takes from the phases before it: the reference
weights, the photo, phase 4's served batch and f32 `DevicePipeline`, and
phase 7's eval images.  It sits beside `chip_smoke.py` because it reuses
the smoke's phases and helpers.
"""

import os
import shutil
import sys
import tempfile
import time


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("dp_phase: no CUDA card", file=sys.stderr)
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
    _, big = cs.served_batch(photo)
    eval_images = cs.photo_variants(photo, 256, seed=7)
    if sys.argv[1:2] == ["--cards"]:
        n = int(sys.argv[2])
        cs.check(torch.cuda.device_count() >= n, f"{n} cards wanted, "
                 f"{torch.cuda.device_count()} present")
        out = tempfile.mkdtemp(prefix="fastdet_dp_")
        try:
            ref, ref_eval, ref_keep = cs.dp_reference(
                sd, photo, dev_pipe, eval_images, out,
                min(cs.DP_EVAL_BATCH, cs.DP_EVAL_IMAGES // n))
            t0 = time.perf_counter()
            procs, logs = cs.dp_start(n, "default", out, own=True)
            results = cs.dp_results(procs, logs)
            launches = cs.dp_check("cards", n, "default", results, ref,
                                   ref_eval, ref_keep, card,
                                   time.perf_counter() - t0,
                                   where="their own cards")
        finally:
            shutil.rmtree(out, ignore_errors=True)
    else:
        launches = cs.phase_parallel(sd, photo, card, dev_pipe,
                                     eval_images, big)
    cs.log(f"phase 14 launches: {launches}")
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
