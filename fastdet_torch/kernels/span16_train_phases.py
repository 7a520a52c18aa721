"""Where the bf16 training span's time goes (B8 in bf16,
`csrc/span16_train.cu`): builds of the kernel without a phase, timed
beside the whole kernel on the card (`phase_cuts`), forward and backward
at the three b128 352² stages; then the whole kernel at a forced cluster
size beside the plan's.

    python -m fastdet_torch.kernels.span16_train_phases

Needs a CUDA card and `nvcc`; the builds go to
`build/span16_train_phases/`.  Prints one line per build (ms per stage
call, CUDA events, forward and backward by stage) and one per forced
cluster.  A cut build computes a wrong function; its outputs are not
checked, and each backward runs on the whole kernel's saved inputs.
"""

from __future__ import annotations

import os
import sys

import torch

from fastdet_torch.kernels import _build
from fastdet_torch.kernels import fused_train as ft
from fastdet_torch.kernels.phase_cuts import build_variants, ms

SOURCE = "span16_train.cu"
_PW = ("  for (int i0 = 0; i0 < MID; i0 += 8) {\n    uint4 av[K::MTW][2];",
       "  for (int i0 = 0; i0 < 0; i0 += 8) {\n    uint4 av[K::MTW][2];")
_DW = ("          if (yp[mt][r] < 0) continue;", "          continue;")
_DWD = ("      for (int cp2 = warp; cp2 < MID / 2; cp2 += kWarps) {",
        "      for (int cp2 = warp; cp2 < 0; cp2 += kWarps) {")
_DWGEMM = ("  for (int tile = warp; tile < MTD * NTD; tile += kWarps) {",
           "  for (int tile = warp; tile < 0; tile += kWarps) {")
_DXW = ("          gq[cur[2 * o + 1] * plane] = acc[mt][n][2 * r];\n"
        "          gq[cur[2 * o + 3] * plane] = acc[mt][n][2 * r + 1];", "")
_STORE = ("    store_x<MID>(S, xsave + k * act, inv, G, B);\n", "\n")
_MERGE = [("  if (G.n > 1) {\n    if (threadIdx.x == 0)\n      mbar_expect_tx",
           "  if (false) {\n    if (threadIdx.x == 0)\n      mbar_expect_tx"),
          ("    if (G.n > 1) {\n      const uint32_t mine",
           "    if (false) {\n      const uint32_t mine")]
_HALO = ("  if (G.n < 2 || G.bpi < 2) return;\n  __syncthreads();",
         "  return;\n  __syncthreads();")
# phase → (source text, its replacement) pairs; each text must be present.
# "no merges": each CTA keeps its own sums (no pushes, no waits); "rest":
# all the cuts above the merges at once, what the phases leave
CUTS = {
    "no pw1/pw2": [_PW],
    "no depthwise (fwd, recompute, dy)": [_DW],
    "no dwd": [_DWD],
    "no dW1/dW2": [_DWGEMM],
    "no dx writes": [_DXW],
    "no xsave stores": [_STORE],
    "no merges": _MERGE,
    "no halo rows": [_HALO],
    "rest": [_PW, _DW, _DWD, _DWGEMM, _DXW, _STORE] + _MERGE + [_HALO],
}
# cluster sizes timed beside the plan's at stage 3 (a band of 6 or 8 rows)
CLUSTERS = (12, 16)


def _calls(lib, case, stream):
    """(forward, backward) closures of the C entries at case's plan."""
    from torch_cases import span_train_case
    b, c, h, w, nblk, g = case
    x32, rows, dy32 = span_train_case(sum(case) + 1, b, c, h, w, nblk, "cuda")
    x, dy = x32.to(torch.bfloat16), dy32.to(torch.bfloat16)
    plan = ft.span16_train_plan(b, c, h, w, nblk, g)
    out, xsave, stats = ft.span_train_forward_bf16(x, rows, g)
    dx, db = torch.empty_like(dy), torch.empty_like(rows)
    scratch = torch.empty(lib.fastdet_span16_train_scratch(
        b, c, h, w, nblk, g, *plan.args), device="cuda")
    xs2, st2 = torch.empty_like(xsave), torch.empty_like(stats)

    def fwd():
        assert lib.fastdet_span16_train_fwd(
            x.data_ptr(), rows.data_ptr(), out.data_ptr(), xs2.data_ptr(),
            st2.data_ptr(), b, c, h, w, nblk, g, *plan.args, stream) == 0

    def bwd():
        assert lib.fastdet_span16_train_bwd(
            dy.data_ptr(), xsave.data_ptr(), stats.data_ptr(),
            rows.data_ptr(), dx.data_ptr(), db.data_ptr(),
            scratch.data_ptr(), None, None, b, c, h, w, nblk, g,
            *plan.args, stream) == 0
    return fwd, bwd


def main() -> int:
    if not torch.cuda.is_available():
        print("span16_train_phases: needs a CUDA card")
        return 1
    tests = os.path.join(os.path.dirname(_build._PKG), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from torch_cases import SPAN_TRAIN_FULL, span_train_case
    root = os.path.join(os.path.dirname(_build.BUILD_DIR),
                        "span16_train_phases")
    libs = build_variants(CUTS, root, SOURCE,
                          {"span16_train": ft._SIGNATURES16})
    stream = torch.cuda.current_stream().cuda_stream
    print(f"span16_train phases ({torch.cuda.get_device_name(0)}), ms per "
          f"stage call at b128 352² (stages 2 / 3 / 4), forward | backward")
    calls = {name: [_calls(lb["span16_train"], case, stream)
                    for case in SPAN_TRAIN_FULL] for name, lb in libs.items()}
    for name, per_stage in calls.items():
        f = [ms(fn, 10) for fn, _ in per_stage]
        bw = [ms(fn, 10) for _, fn in per_stage]
        print(f"  {name}: " + " / ".join(f"{t:.4f}" for t in f) + " | "
              + " / ".join(f"{t:.4f}" for t in bw), flush=True)
    b, c, h, w, nblk, g = SPAN_TRAIN_FULL[1]
    x32, rows, dy32 = span_train_case(sum(SPAN_TRAIN_FULL[1]) + 1, b, c, h,
                                      w, nblk, "cuda")
    x, dy = x32.to(torch.bfloat16), dy32.to(torch.bfloat16)
    lib = _build.load("span16_train", ft._SIGNATURES16)
    plan_of = ft.span16_train_plan
    for n in (None,) + CLUSTERS:
        plan = plan_of(b, c, h, w, nblk, g, n)
        ft.span16_train_plan = lambda *a, **k: plan_of(*a, cluster=n)
        try:
            out, xsave, stats = ft.span_train_forward_bf16(x, rows, g)
            tf = ms(lambda: ft.span_train_forward_bf16(x, rows, g), 10)
            tb = ms(lambda: ft.span_train_backward_bf16(dy, xsave, stats,
                                                        rows, g), 10)
        finally:
            ft.span16_train_plan = plan_of
        occ = [lib.fastdet_span16_train_clusters(b, c, h, w, nblk, g,
                                                 *plan.args, k)
               for k in (0, 1)]
        print(f"  stage 3, cluster {plan.cluster} ({plan.bpi} bands of "
              f"{plan.rows} rows an image{'' if n else ', the plan'}): "
              f"active clusters {occ[0]} / {occ[1]}, forward {tf:.4f} ms, "
              f"backward {tb:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
