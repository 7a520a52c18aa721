"""Where the bf16 training stem's time goes (B7 in bf16,
`csrc/stem16_train.cu`): builds of the kernel without a phase, timed
beside the whole kernel on the card (`phase_cuts`), forward and backward
at b128 352², ghost group 1 and 16.

    python -m fastdet_torch.kernels.stem16_train_phases

Needs a CUDA card and `nvcc`; the builds go to
`build/stem16_train_phases/`.  Prints one line per build (ms per call,
CUDA events; forward g1 / g16 | backward g1 / g16) and the ms each cut
saves against the whole kernel.  A cut build computes a wrong function;
its outputs are not checked, and each backward runs on the whole kernel's
saved inputs.  The compiler drops what a cut leaves unused (cutting the
winner stores drops the winners' selection too).
"""

from __future__ import annotations

import os
import sys

import torch

from fastdet_torch.kernels import _build
from fastdet_torch.kernels import stem_train as stt
from fastdet_torch.kernels.phase_cuts import build_variants, ms

SOURCE = "stem16_train.cu"
_CONV = [("  for (int ky = 0; ky < 3; ++ky) {\n#pragma unroll\n"
          "    for (int kx = 0; kx < 3; ++kx) {\n#pragma unroll\n"
          "      for (int c = 0; c < 3; ++c) {\n        float wv[NCH];",
          "  for (int ky = 0; ky < 1; ++ky) {\n#pragma unroll\n"
          "    for (int kx = 0; kx < 1; ++kx) {\n#pragma unroll\n"
          "      for (int c = 0; c < 1; ++c) {\n        float wv[NCH];")]
_MOMENTS = [("  for (int it = warp; it < NS * 4 * nchk; it += nwarps) {",
             "  for (int it = warp; it < 0; it += nwarps) {")]
_POOL = [("      const float rs = __shfl_up_sync(kFull, r1, 1);\n"
          "      const int el = __shfl_up_sync(kFull, e1, 1);\n"
          "      const float zl = __shfl_up_sync(kFull, z1, 1);",
          "      const float rs = r1;\n      const int el = e1;\n"
          "      const float zl = z1;")]
_WINNERS = [("        code0[at] = (uint8_t)(3 * cc + (cc == 0 ? e0 : "
             "(cc == 1 ? e1 : el)));\n"
             "        zw0[at] = cc == 0 ? z0 : (cc == 1 ? z1 : zl);", "")]
_ROUTE = [("          const int cA = c0p[co * kRS], cB = c0p[co * kRS + 1];",
           "          const int cA = o & 7, cB = 6;"),
          ("            const int cC = c1p[co * kRS], cD = c1p[co * kRS + 1];",
           "            const int cC = 2, cD = 8;")]
_DW = [("    for (int q2 = 0; q2 < 2; ++q2) {",
        "    for (int q2 = 0; q2 < 0; ++q2) {")]
# phase → (source text, its replacement) pairs; each text must be present
CUTS = {
    "conv 1 tap of 27 (emit, sweep)": _CONV,
    "no moments (gram MMAs)": _MOMENTS,
    "no pool shuffles (emit)": _POOL,
    "no winner stores (emit: code, zw)": _WINNERS,
    "no routing (sweep: codes)": _ROUTE,
    "no dW product (sweep MMAs)": _DW,
    "rest": _CONV + _MOMENTS + _POOL + _WINNERS + _ROUTE + _DW,
}
CASES = ((128, 88, 88, 1), (128, 88, 88, 16))


def _calls(lib, case, stream):
    """(forward, backward) closures of the C entries at case's plan."""
    from torch_cases import stem_train_case
    b, h4, w4, g = case
    x, w_raw, gamma, beta, dy = stem_train_case(7, b, 4 * h4, 4 * w4,
                                                device="cuda")
    w = (w_raw * (1.0 / 255.0)).contiguous()
    dy = dy.to(torch.bfloat16)
    plan = stt.stem16_train_plan(b, h4, w4, g)
    npad = x.shape[2]
    _, stats, zw, code = stt.stem_train_forward_bf16(x, w, gamma, beta, h4,
                                                     w4, g)
    y2 = torch.empty((b, 24, h4, w4), dtype=torch.bfloat16, device="cuda")
    zw2, code2 = torch.empty_like(zw), torch.empty_like(code)
    st2 = torch.empty_like(stats)
    fs = torch.empty(lib.fastdet_stem16_train_fwd_scratch(
        b, h4, w4, plan.rows, plan.ncw), dtype=torch.int32, device="cuda")
    bs = torch.empty(lib.fastdet_stem16_train_bwd_scratch(
        b, h4, w4, plan.rows, plan.ncw), device="cuda")
    dw, dg, db = torch.empty_like(w), torch.empty_like(gamma), \
        torch.empty_like(beta)

    def fwd():
        assert lib.fastdet_stem16_train_fwd(
            x.data_ptr(), w.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            y2.data_ptr(), zw2.data_ptr(), code2.data_ptr(), st2.data_ptr(),
            fs.data_ptr(), b, h4, w4, npad, g, plan.rows, plan.ncw,
            stream) == 0

    def bwd():
        assert lib.fastdet_stem16_train_bwd(
            dy.data_ptr(), x.data_ptr(), zw.data_ptr(), code.data_ptr(),
            stats.data_ptr(), w.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), dw.data_ptr(), dg.data_ptr(), db.data_ptr(),
            bs.data_ptr(), b, h4, w4, npad, g, plan.rows, plan.ncw,
            stream) == 0
    return fwd, bwd


def main() -> int:
    if not torch.cuda.is_available():
        print("stem16_train_phases: needs a CUDA card")
        return 1
    tests = os.path.join(os.path.dirname(_build._PKG), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    root = os.path.join(os.path.dirname(_build.BUILD_DIR),
                        "stem16_train_phases")
    libs = build_variants(CUTS, root, SOURCE,
                          {"stem16_train": stt._SIGNATURES16})
    stream = torch.cuda.current_stream().cuda_stream
    print(f"stem16_train phases ({torch.cuda.get_device_name(0)}), ms per "
          f"call at b128 352², forward g1 / g16 | backward g1 / g16")
    times = {}
    for name, lb in libs.items():
        calls = [_calls(lb["stem16_train"], case, stream) for case in CASES]
        times[name] = ([ms(f) for f, _ in calls] + [ms(b) for _, b in calls])
        t = times[name]
        print(f"  {name}: {t[0]:.4f} / {t[1]:.4f} | {t[2]:.4f} / "
              f"{t[3]:.4f}", flush=True)
    whole = times["whole"]
    for name, t in times.items():
        if name != "whole":
            print(f"  saved by '{name}': " + " / ".join(
                f"{a - c:.4f}" for a, c in zip(whole, t)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
