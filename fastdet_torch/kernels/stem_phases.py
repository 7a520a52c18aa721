"""Where the u8 stems' time goes (B1 and B6, `csrc/stem_s2d.cu`; B10,
`csrc/stem_s2d8.cu`; both on the stem kernel `csrc/stem_core.cuh`):
builds of the stem kernel cut after a phase or without one, timed beside
the whole kernel on the card (`phase_cuts`): staging only, no output
stores, no staging, half the A loads, no MMAs.

    python -m fastdet_torch.kernels.stem_phases

Needs a CUDA card and `nvcc`; the builds go to `build/stem_phases/`.
Prints one line per call (B1 and B10 at b128 352², B6 at b32 640²): its
plan and the occupancy calculator's CTAs an SM, then the time of the
whole kernel and of each cut build (CUDA events, ms per call).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from fastdet_torch.kernels import _build
from fastdet_torch.kernels import fused_infer as fi
from fastdet_torch.kernels.phase_cuts import build_variants, ms

HEADER = "stem_core.cuh"
_STRIPS = "    if (v0 + kStripCells * warp < j_end)"
_STORE = "        if (store)\n"
_MMA = ('''  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));''')
# phase → (source text, its replacement) pairs; each text must be present.
# "staging only" keeps the weights and each tile's copies and unpacking
# between the barriers; "no stores" keeps conv and pool (v is never < 0)
CUTS = {
    "staging only": [(_STRIPS, (
        "    if (tid == 0) out[0] = __half2float(s_img[ps + 5 * rs + 9]);\n"
        "    if (false)\n") + _STRIPS)],
    "no stores": [(_STORE, "        if (store && v < 0.f)\n")],
    "no staging": [
        ("    unpack_tile<K>(raw, stride, s_img,",
         "    if (tid < 0) unpack_tile<K>(raw, stride, s_img,"),
        ("    if (next < total) {", "    if (next < 0) {")],
    "half the A loads": [
        ("    const unsigned short* p1 = s + at + off[4 * ks + 1];",
         "    const unsigned short* p1 = p0;"),
        ("    const unsigned short* p3 = s + at + off[4 * ks + 3];",
         "    const unsigned short* p3 = p2;")],
    "no MMA": [(_MMA, (
        "  d[0] += __int_as_float(a0 ^ b0);\n"
        "  d[1] += __int_as_float(a1 ^ b1);\n"
        "  d[2] += __int_as_float(a2);\n"
        "  d[3] += __int_as_float(a3);"))],
}
# (label, source, factor, batch, H, W) of the three timed calls
CALLS = (("B1", "stem_s2d", 4, 128, 352, 352),
         ("B10", "stem_s2d8", 8, 128, 352, 352),
         ("B6", "stem_s2d", 4, 32, 640, 640))


def main() -> int:
    if not torch.cuda.is_available():
        print("stem_phases: needs a CUDA card")
        return 1
    from fastdet_torch.io import load_state_dict
    from fastdet_torch.kernels.fold import pack_fused_weights
    root = os.path.join(os.path.dirname(_build.BUILD_DIR), "stem_phases")
    libs = build_variants(CUTS, root, HEADER,
                          {"stem_s2d": fi._STEM_SIGNATURES,
                           "stem_s2d8": fi._STEM8_SIGNATURES})
    weights = os.path.join(os.path.dirname(_build._PKG), "weights",
                           "coco2017-ref.npz")
    pk = pack_fused_weights(load_state_dict(weights))
    w, b = (torch.from_numpy(np.ascontiguousarray(a))
            for a in fi.pack_stem_s2d(pk["stem_w"], pk["stem_b"]))
    stream = torch.cuda.current_stream().cuda_stream
    print(f"stem phases ({torch.cuda.get_device_name(0)}), ms per call; "
          f"the whole kernel, then each cut build")
    rng = np.random.default_rng(0)
    for label, src, k, bsz, ih, iw in CALLS:
        imgs = rng.integers(0, 256, (bsz, ih, iw, 3), dtype=np.uint8)
        x = torch.from_numpy(fi._space_to_depth(imgs, k)).cuda()
        out = torch.empty((bsz, 24, ih // 4, iw // 4), device="cuda")
        plan = fi.stem_plan(bsz, ih // 4, iw // 4, k)
        occ = libs["whole"][src].fastdet_stem_ctas_per_sm(plan.rows,
                                                          plan.strips)
        print(f"{label}: {plan.tiles} tiles of {plan.rows} × {plan.cols} "
              f"cells over {plan.grid[0]} CTAs, {plan.smem_bytes} B each, "
              f"{occ} CTAs an SM (occupancy calculator)")

        def call(lib, src=src, x=x, out=out, k=k, bsz=bsz, ih=ih, iw=iw,
                 plan=plan):
            rc = getattr(lib[src], "fastdet_" + src)(
                x.data_ptr(), out.data_ptr(), w.data_ptr(), b.data_ptr(),
                bsz, ih // k, iw // k, x.shape[2], plan.rows, plan.strips,
                plan.grid[0], stream)
            assert rc == 0, rc
        times = {name: ms(lambda lib=lib: call(lib), 30)
                 for name, lib in libs.items()}
        rest = ", ".join(f"{n} {t:.4f}" for n, t in times.items()
                         if n != "whole")
        print(f"{label} b{bsz} {ih}²: whole {times['whole']:.4f}; {rest}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
