"""Where the stage kernels' time goes (B2 and B9, `csrc/span_block.cuh`,
f32 and bf16): builds of the kernel with one phase cut out, timed beside
the whole kernel at b128 352² on the card.  The card's machine has no
`ncu`, so a phase's share is read as the time its removal saves.  A cut
build computes a wrong function; its outputs are not checked.

    python -m fastdet_torch.kernels.stage_phases [f32|bf16|clusters]

Needs a CUDA card and `nvcc`; the builds go to `build/stage_phases/`.
Prints one line per stage: the B2 and B9 times (CUDA events, ms per
call, the plan's launch) of the whole kernel and of each cut build; both
dtypes unless one is named.  `clusters` times the bf16 stage kernel
itself at each cluster of 1, 2, 4, 8 CTAs an image that fits (the
stride-2 prologue at the most chunk rows that fit), the choice
`span16_plan` makes.
"""

from __future__ import annotations

import os
import sys

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

# the bf16 stage kernel (span16_stage_kernel)
CUTS16 = {
    "band staging": [("          e[u][k] = ok ? xb[inv[8 * gs + k] * plane + "
                      "off]", "          e[u][k] = ok ? __float2bfloat16("
                      "1.f)")],
    "s2 input staging": [("            e[u][k] = ok ? src[k * in_plane] : "
                          "__float2bfloat16(0.f);",
                          "            e[u][k] = __float2bfloat16(ok ? 1.f "
                          ": 0.f);")],
    "output": [("      if (two)\n        *reinterpret_cast<__nv_bfloat162*>"
                "(dst) = __halves2bfloat162(\n            e[0][k], e[1][k]);"
                "\n      else\n        dst[0] = e[0][k];", "")],
    "weight stream": [("    cp_async16_to(dst + 16 * i, s + 16 * i);", "")],
    "mma": [("          mma_bf16_16816(acc[mt][n], a[mt], b[n]);",
             "          acc[mt][n][0] += __uint_as_float(a[mt][0] ^ b[n].x);")],
    "halo exchange": [
        ("        cluster_arrive();\n        cluster_wait();\n        for "
         "(int i = 16 * tid; i < rowb; i += 16 * kThreads16) {",
         "        for (int i = rowb; i < rowb; i += 16 * kThreads16) {"),
        ("        cluster_arrive();                    // done reading the "
         "neighbours", ""),
        ("      if (halo == 1 && k > 0) cluster_wait();   // the neighbours "
         "read Y", ""),
        ("    if (halo == 1) cluster_wait();           // the neighbours are "
         "done", "")],
    "pw1 epilogue": [("              *reinterpret_cast<__nv_bfloat162*>(dst "
                      "+ o) = t;", "")],
    "z epilogue": [("              px[zslot[n].x] = t.x;\n"
                    "              px[zslot[n].y] = t.y;", "")],
}


def main() -> int:
    if not torch.cuda.is_available():
        print("stage_phases: needs a CUDA card")
        return 1
    which = sys.argv[1:] or ["f32", "bf16"]
    if "f32" in which:
        main32()
    if "bf16" in which:
        main16()
    if "clusters" in which:
        clusters16()
    return 0


def main32() -> None:
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


def main16() -> None:
    from fastdet_torch.io import load_state_dict
    from fastdet_torch.kernels.fold import STAGES
    root = os.path.join(os.path.dirname(_build.BUILD_DIR), "stage_phases16")
    libs = build_variants(CUTS16, root, HEADER,
                          {"span": fi._SPAN_SIGNATURES,
                           "s2span": fi._S2SPAN_SIGNATURES})
    weights = os.path.join(os.path.dirname(_build._PKG), "weights",
                           "coco2017-ref.npz")
    _, p = fi.build_fused_forward(load_state_dict(weights),
                                  dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    x = torch.from_numpy(np.abs(np.random.default_rng(0).normal(
        0.0, 1.0, (128, 24, 88, 88))).astype(np.float32)).cuda().to(
            torch.bfloat16)
    print(f"bf16 stage kernel phases, ms per b128 352² call "
          f"({torch.cuda.get_device_name(0)}); B2 / B9 of the whole kernel, "
          f"then the time each cut saves")
    with torch.inference_mode():
        for sid, reps, c in STAGES:
            nblk = reps - 1
            xin = fi._s2_block_bf16(x, p, f"s{sid}_0")
            b, _, h, w = xin.shape
            win = x.shape[3]
            p2 = fi.span16_plan(b, c, h, w, nblk)
            p9 = fi.span16_plan(b, c, h, w, nblk, True, win)
            ws, bs = p[f"s{sid}_span16"], p[f"s{sid}_span16_b"]
            w2, b2 = p[f"s{sid}_s2_16"], p[f"s{sid}_s2_16_b"]
            out = torch.empty_like(xin)
            times = {}
            for name, lib in libs.items():
                t2 = ms(lambda: lib["span"].fastdet_span_bf16(
                    xin.data_ptr(), out.data_ptr(), out.data_ptr(),
                    ws.data_ptr(), bs.data_ptr(), b, c, h, w, nblk, p2.rows,
                    p2.cluster, 0, stream))
                t9 = ms(lambda: lib["s2span"].fastdet_s2span_bf16(
                    x.data_ptr(), out.data_ptr(), out.data_ptr(),
                    w2.data_ptr(), b2.data_ptr(), ws.data_ptr(),
                    bs.data_ptr(), b, c // 2, x.shape[2], win, nblk,
                    p9.rows, p9.rows, p9.orows, p9.cluster, 0, stream))
                times[name] = (t2, t9)
            t2, t9 = times["whole"]
            cuts = ", ".join(f"{n} {t2 - a:.4f} / {t9 - z:.4f}"
                             for n, (a, z) in times.items() if n != "whole")
            print(f"stage {sid}: B2 {t2:.4f}, B9 {t9:.4f}; saved by cutting "
                  f"{cuts}", flush=True)
            x = fi.s2span_bf16(x, w2, b2, ws, bs, nblk)



def clusters16() -> None:
    from fastdet_torch.io import load_state_dict
    from fastdet_torch.kernels.fold import STAGES
    weights = os.path.join(os.path.dirname(_build._PKG), "weights",
                           "coco2017-ref.npz")
    _, p = fi.build_fused_forward(load_state_dict(weights),
                                  dtype=torch.bfloat16, device="cuda")
    lib = _build.load("span", fi._SPAN_SIGNATURES)
    lib2 = _build.load("s2span", fi._S2SPAN_SIGNATURES)
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    print(f"bf16 stage kernel by cluster, ms per b128 352² call "
          f"({torch.cuda.get_device_name(0)})")
    for (sid, reps, c), hw in zip(STAGES, (44, 22, 11)):
        mid, nblk = c // 2, reps - 1
        x, xs = (torch.from_numpy(np.abs(rng.normal(0.0, 1.0, shape)).astype(
            np.float32)).cuda().to(torch.bfloat16)
            for shape in ((128, c, hw, hw), (128, mid, 2 * hw, 2 * hw)))
        out = torch.empty_like(x)
        ws, bs = p[f"s{sid}_span16"], p[f"s{sid}_span16_b"]
        w2, b2 = p[f"s{sid}_s2_16"], p[f"s{sid}_s2_16_b"]
        row = []
        for n in fi.STAGE_CLUSTERS:
            rows = -(-hw // n)
            halo = 1 if n > 1 else 0
            if ((n - 1) * rows >= hw or fi.span16_smem(mid, rows, hw, halo)
                    > fi.SMEM_PER_CTA):
                continue
            t2 = ms(lambda: lib.fastdet_span_bf16(
                x.data_ptr(), out.data_ptr(), out.data_ptr(), ws.data_ptr(),
                bs.data_ptr(), 128, c, hw, hw, nblk, rows, n, 0, stream))
            o = fi._orows16(mid, rows, hw, halo, 2 * hw)
            t9 = ms(lambda: lib2.fastdet_s2span_bf16(
                xs.data_ptr(), out.data_ptr(), out.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), ws.data_ptr(), bs.data_ptr(), 128, mid,
                2 * hw, 2 * hw, nblk, rows, rows, o, n, 0,
                stream)) if o else float("nan")
            row.append(f"{n}: B2 {t2:.4f}, B9 {t9:.4f} (chunks of {o})")
        plan = fi.span16_plan(128, c, hw, hw, nblk)
        print(f"stage {sid}: " + "; ".join(row)
              + f"; the plan's cluster {plan.cluster}", flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
