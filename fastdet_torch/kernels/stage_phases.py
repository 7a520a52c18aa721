"""Where the stage kernel's time goes (B2 and B9, `csrc/span_block.cuh`):
builds of the kernel with one phase cut out, timed beside the whole
kernel at b128 352² on the card.  The card's machine has no `ncu`, so a
phase's share is read as the time its removal saves.  A cut build
computes a wrong function; its outputs are not checked.

    python -m fastdet_torch.kernels.stage_phases

Needs a CUDA card and `nvcc`; the builds go to `build/stage_phases/`.
Prints one line per stage: the B2 and B9 times (CUDA events, ms per
call, the plan's launch) of the whole kernel and of each cut build.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from fastdet_torch.kernels import _build
from fastdet_torch.kernels import fused_infer as fi
from fastdet_torch.kernels.phase_cuts import build_variants, ms

HEADER = "span_block.cuh"
PW1_S2 = ("    pw_phase<MID>(sm, tsrc, tdst, wb, wb + MID * MID,\n"
          "                  pad4(kChunkRows * xw), [&](int p) {")
# phase → (source text, its replacement) pairs; each text must be present
CUTS = {
    "span dw": [("    dw_phase<MID>(sm, tdst, tsrc, wd, bd, rv, w, htop, "
                 "hbot, L.hs);", "")],
    "span pw1+pw2": [
        ("    pw_phase<MID>(sm, tsrc, tdst, w1, b1, pad4(rv * w), "
         "KeepAll());", ""),
        ("    pw_phase<MID>(sm, tsrc, tdst, w2, b2, pad4(rv * w), "
         "KeepAll());", "")],
    "band load": [("        cp_async4(sm + c * L.ps + p, xb + c * plane + p, "
                   "true);", "")],
    "cluster barriers": [
        ("      cluster_arrive();\n      cluster_wait();", ""),
        ("      cluster_arrive();                // done reading the "
         "neighbours", ""),
        ("    if (halo == 1) cluster_wait();     // before the scratch is "
         "overwritten", "")],
    "s2 input chunks": [("        cp_async4(dst + col, ok ? src + col - 1 : "
                         "xb, ok);", "")],
    "s2 pw1": [(PW1_S2, "    if (0)\n" + PW1_S2)],
    "s2 dw": [
        ("    dw_s2_phase<MID>(sm, L.xbuf, L.xs, MID * L.ps + 2 * chunk * w, "
         "L.ps,\n                     wpd, bpd, orows, w);", ""),
        ("    dw_s2_phase<MID>(sm, L.ybuf, L.xs, 2 * chunk * w, L.ps, wd, bd, "
         "orows,\n                     w);", "")],
}


def main() -> int:
    if not torch.cuda.is_available():
        print("stage_phases: needs a CUDA card")
        return 1
    from fastdet_torch import disable_tf32
    from fastdet_torch.io import load_state_dict
    from fastdet_torch.kernels.fold import STAGES
    disable_tf32(torch.device("cuda"))
    root = os.path.join(os.path.dirname(_build.BUILD_DIR), "stage_phases")
    libs = build_variants(CUTS, root, HEADER,
                          {"span": fi._SPAN_SIGNATURES,
                           "s2span": fi._S2SPAN_SIGNATURES})
    weights = os.path.join(os.path.dirname(_build._PKG), "weights",
                           "coco2017-ref.npz")
    _, p = fi.build_fused_forward(load_state_dict(weights))
    stream = torch.cuda.current_stream().cuda_stream
    x = torch.from_numpy(np.abs(np.random.default_rng(0).normal(
        0.0, 1.0, (128, 24, 88, 88))).astype(np.float32)).cuda()
    print(f"stage kernel phases, ms per b128 352² call "
          f"({torch.cuda.get_device_name(0)}); B2 / B9 of the whole kernel, "
          f"then the time each cut saves")
    with torch.inference_mode():
        for sid, reps, c in STAGES:
            nblk = reps - 1
            xin = fi._s2_block(x, p, f"s{sid}_0")
            b, _, h, w = xin.shape
            p2 = fi.span_stage_plan(b, c, h, w, nblk)
            p9 = fi.span_stage_plan(b, c, h, w, nblk, True)
            w2, w9 = p[f"s{sid}_span"], p[f"s{sid}_s2span"]
            out = torch.empty_like(xin)
            times = {}
            for name, lib in libs.items():
                t2 = ms(lambda: lib["span"].fastdet_span(
                    xin.data_ptr(), out.data_ptr(), out.data_ptr(),
                    w2.data_ptr(), b, c, h, w, nblk, p2.rows, p2.cluster,
                    0, stream))
                t9 = ms(lambda: lib["s2span"].fastdet_s2span(
                    x.data_ptr(), out.data_ptr(), out.data_ptr(),
                    w9.data_ptr(), b, c // 2, x.shape[2], x.shape[3], nblk,
                    p9.rows, p9.rows, p9.cluster, 0, stream))
                times[name] = (t2, t9)
            t2, t9 = times["whole"]
            cuts = ", ".join(f"{n} {t2 - a:.4f} / {t9 - z:.4f}"
                             for n, (a, z) in times.items() if n != "whole")
            print(f"stage {sid}: B2 {t2:.4f}, B9 {t9:.4f}; saved by cutting "
                  f"{cuts}", flush=True)
            x = fi.s2span(x, w9, nblk)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
