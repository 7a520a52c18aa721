#!/usr/bin/env python3
"""Smoke phase 15 (tensor parallel, ROADMAP A20) of `chip_smoke.py` alone,
on one NVIDIA card: four gloo ranks sharing the card as a (2, 2) (data,
model) mesh, `Trainer(mesh=make_mesh_2d(2, 2))` in the default f32, default
bf16, fused s2d f32 and fused s2d bf16 modes against one process on the
same global b32 batch.

    python3 tp_phase.py
    python3 tp_phase.py --cards 4

Run from the repository root.  With `--cards 4` (a machine with four
cards) it runs, in place of the shared-card job, the reference and one
(2, 2) job of four nccl ranks, each on its own card, held as phase 15
holds its job.  It builds the kernels as phase 1 does and sets up what
phase 15 takes from the phases before it: the reference weights, the
photo and phase 4's f32 `DevicePipeline`.  It sits beside `chip_smoke.py`
because it reuses the smoke's phases and helpers.
"""

import os
import shutil
import sys
import tempfile
import time


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tp_phase: no CUDA card", file=sys.stderr)
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
    if sys.argv[1:2] == ["--cards"]:
        n = int(sys.argv[2])
        world = cs.TP_MESH[0] * cs.TP_MESH[1]
        cs.check(n == world and torch.cuda.device_count() >= n,
                 f"a {cs.TP_MESH} mesh wants {world} cards: --cards {n}, "
                 f"{torch.cuda.device_count()} present")
        out = tempfile.mkdtemp(prefix="fastdet_tp_")
        try:
            ref = cs.tp_reference(sd, photo, dev_pipe, out)
            t0 = time.perf_counter()
            procs, logs = cs.dp_start(n, "default", out, own=True,
                                      flag="--tp-rank")
            results = cs.dp_results(procs, logs, "phase 15", "TP15 ",
                                    cs.TP_TIMEOUT_S)
            launches = cs.tp_check("cards", n, "default", results, ref,
                                   card, time.perf_counter() - t0,
                                   "their own cards")
        finally:
            shutil.rmtree(out, ignore_errors=True)
    else:
        launches = cs.phase_tensor_parallel(sd, photo, card, dev_pipe)
    cs.log(f"phase 15 launches: {launches}")
    cs.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
