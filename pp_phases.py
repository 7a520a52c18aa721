#!/usr/bin/env python3
"""Where rank_decode_nms's time goes (B3, `fastdet_torch/csrc/pp_fused.cu`):
builds of the kernel cut after a phase, timed beside the whole kernel on
the card (`fastdet_torch.kernels.phase_cuts`): after the decode, after
the compaction, after the rows, and an empty build that returns at once
(one launch of the same grid, the floor under any design).

    python3 pp_phases.py

Run from the repository's root; needs a CUDA card and `nvcc`; the builds
go to `build/pp_phases/`.  Each build is called through the wrapper
`pp_fused.rank_decode_nms` with its library in place of the main
build's, and timed back to back (CUDA events, the wrapper's host work
included) and on the device (torch.profiler, the kernels' own time, by
`chip_smoke.planned_split`), in ms per call:
  * on the served b128 batch's window (`chip_smoke.served_window`: the
    reference weights on the photo variants of the smoke's phase 4, k =
    128, conf 0.3), with the window's n_v per image and kept count:
    every build;
  * at the smoke's phase 2 classes (B 1 / 128 × k 128 / 256 / 384 ×
    dense / sparse / clustered, `torch_cases.make_inputs`): the whole
    kernel and the empty build, and every build at b128 k384 dense (n_v
    = 384, the widest class).

The cuts fit this tree's `pp_fused.cu`.  A cut build computes a wrong
function; its outputs are not checked.
"""

from __future__ import annotations

import ctypes
import os
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
for _path in (REPO, os.path.join(REPO, "tests")):
    if _path not in sys.path:
        sys.path.insert(0, _path)

import torch  # noqa: E402

from chip_smoke import (PHOTO, WEIGHTS, planned_split,  # noqa: E402
                        read_png_bgr, served_batch, served_window)

HEADER = "pp_fused.cu"
_RETURN = "  if (k > 0) return;\n"   # always taken; the code after stays live
_ROWS = "  image_rows(im, nv, iou_thres);\n"
_WALK = "  if (threadIdx.x < 32) walk("
# phase → (source text, its replacement) pairs; each text must be present
CUTS = {
    "empty": [("  const size_t b = blockIdx.x;\n",
               _RETURN + "  const size_t b = blockIdx.x;\n")],
    "decode": [("  int nv;\n", _RETURN + "  int nv;\n")],
    "decode + compaction": [(_ROWS, _RETURN + _ROWS)],
    "all but the walk": [(_WALK, _RETURN + _WALK)],
}
CLASSES = [(b, k, case) for b in (1, 128) for k in (128, 256, 384)
           for case in ("dense", "sparse", "clustered")]
SPLIT = (128, 384, "dense")   # every build here too


def main() -> int:
    if not torch.cuda.is_available():
        print("pp_phases: needs a CUDA card")
        return 1
    from fastdet_torch.io import load_state_dict
    from fastdet_torch.kernels import _build, pp_fused
    from fastdet_torch.kernels.phase_cuts import build_variants, ms
    from torch_cases import IOU, NC, make_inputs, port_geo
    sigs = dict(pp_fused._SIGNATURES)
    sigs["fastdet_cuda_error_string"] = ([ctypes.c_int], ctypes.c_char_p)
    root = os.path.join(os.path.dirname(_build.BUILD_DIR), "pp_phases")
    libs = build_variants(CUTS, root, HEADER, {"pp_fused": sigs})

    def timed(name, call):
        """(back-to-back ms, device ms or None, device launches) of `call`
        with the build `name` behind the wrapper."""
        with _build._lock:
            _build._libs["pp_fused"] = libs[name]["pp_fused"]
        split, n = planned_split(call, 1)
        dev = None if split is None else sum(t for t, _ in split.values())
        return ms(call, 50), dev, n or 0

    def text(t):
        b2b, dev, n = t
        dev = "not measured" if dev is None else f"{dev:.4f}"
        return f"{b2b:.4f} / {dev} ({n:g} launch{'es' if n != 1 else ''})"

    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(f"rank_decode_nms phases ({smi}), ms per call: back to back "
          f"(CUDA events) / device (torch.profiler)")
    _, big = served_batch(read_png_bgr(PHOTO))
    *_, served = served_window(load_state_dict(WEIGHTS), big)
    valid = (served[0] < 0).sum(1).cpu()
    call = (lambda a=served: pp_fused.rank_decode_nms(*a, nc=NC,
                                                      iou_thres=IOU))
    with _build._lock:
        _build._libs["pp_fused"] = libs["whole"]["pp_fused"]
    kept = int(call()[0].sum())
    print(f"served b128 k128: n_v per image min {int(valid.min())} median "
          f"{float(valid.float().median()):g} max {int(valid.max())} "
          f"(sum {int(valid.sum())}), kept {kept}", flush=True)
    for name in libs:
        print(f"  {name}: {text(timed(name, call))}", flush=True)
    geo = port_geo("cuda:0")
    for b, k, case in CLASSES:
        a = [torch.from_numpy(x).cuda()
             for x in make_inputs(k + b, b, k, case)] + [geo]
        call = (lambda a=a: pp_fused.rank_decode_nms(*a, nc=NC,
                                                     iou_thres=IOU))
        names = list(libs) if (b, k, case) == SPLIT else ["whole", "empty"]
        print(f"b{b} k{k} {case}: " + "; ".join(
            f"{n} {text(timed(n, call))}" for n in names), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
