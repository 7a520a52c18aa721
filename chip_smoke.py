#!/usr/bin/env python3
"""Smoke run of fastdet_torch on one NVIDIA card (the quickest proof that
the port still starts on the GPU).

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card.  It builds the
port's ten CUDA sources from `fastdet_torch/csrc/` (one nvcc each, in
parallel), holds each kernel against its plain PyTorch version, checks the
weights and both forwards, serves real requests through `InferenceServer`
over `DevicePipeline` and over `FusedPipeline` and checks the answers,
drives the fused forward's five other combinations of `input_format` and
`fuse_s2` into detections, evaluates seeded labelled photos through the
eval entry point in both of its modes, serves 640² through
`FusedPipeline`, trains at full width on the default, fused and fused
s2d paths, serves, evaluates and trains the anchor-free family, serves
and trains in bf16, runs and evaluates the int8 PTQ chain, and trains
the convergence check's bf16 fused s2d configuration to its bar.
One line per phase; any failed check ends the run with a non-zero exit.
Without a card, or outside the repository, it exits non-zero and prints
no result.

Phases:
  1. device: card name and power limit, kernel build times and ptxas info;
  2. rank_decode_nms against its plain version at every shape class the
     port dispatches (B ∈ {1, 128}, k ∈ {128, 256, 384}, N = 1815,
     nc = 80) and at n_v ∈ `NV_CLASSES` of a k = 384 window (prefix and
     scattered validity); each class's time by kernel name and device
     launches (torch.profiler), held to `rank_decode_nms_plan`, beside
     its time back to back;
  2c. nms_keep (keep_mask_batch) bitwise against its plain version on
     seeded crowded fields, k ∈ {385, 512, 1024, 1815, 2048} × B ∈ {1, 8,
     32, 64, 128}, in both variants of `nms_keep_plan`, and
     suppress_ranked_batch against the plain chain; each class with the
     plan's variant and both variants' times (back to back and on the
     device); the plan's shared memory and workspace against the
     kernel's;
  2b. stem_s2d (B1 at the shapes of `STEM_CASES`: B ∈ {1, 128} at 352²,
     B = 2 at 160×96 with pad lanes, B = 32 at 640², 36×52 and 20×12 with
     tiles cut off at the edge) and span (C = 48/96/192 at 44²/22²/11²,
     B ∈ {1, 128}) against their plain versions, ≤ 2e-4; the launch
     plans (`stem_plan`, `span_stage_plan`) their shared memory the
     kernels' own;
  2d. stem_s2d8 (B10: B ∈ {1, 128} at 352², B = 2 at 160×96 with pad
     lanes, 72×104 and 40×24 with tiles cut off at the edge) and s2span
     (B9: the three stages of 352² at B ∈ {1, 128}, stage 2 of 160×96,
     partial tiles and odd sizes) against their plain versions, ≤ 2e-4,
     and the plans' shared memory the kernels' own;
  3. weights through the carrier, forward on the card (TF32 off) against
     the same forward on the CPU, ≤ 2e-4; the same weights as a
     reference-layout `.pth` (written in a temporary directory): its state
     dict bit for bit the `.npz`'s, the photo's `FusedPipeline`
     detections bit for bit the `.npz`'s;
  3b. the fused forward on the card against Detector on the card, ≤ 2e-4;
  4. serving: ≥ 8 concurrent raw requests through the HTTP server, each
     answer equal to `DevicePipeline` on the same batch; a conf-0.01 batch
     that fills the 128-wide NMS window, against the CPU pipeline; the
     b128 throughput and the split of its batch; rank_decode_nms on that
     batch's window: its n_v per image, its time on the device by kernel
     name and device launches (held to the plan) and back to back;
  4b. the same requests over `FusedPipeline`: each answer equal to
     `FusedPipeline` on the same batch, detections as `DevicePipeline`'s;
     the three kernels' launch counts on this path; b128 throughput of both
     pipelines, the fused forward's per-stage split (`upto=`), and each
     fused kernel on the served batch's inputs with its bound; the
     stem call's and each span stage call's time by kernel name and
     device launches (torch.profiler), held to `stem_plan`'s and
     `span_stage_plan`'s;
  4c. the flag paths: the five other combinations of `input_format`
     (nhwc, s2d_u8, s2d8_u8) and `fuse_s2` at b128 352² on photo
     variants, each forward against Detector on the card (TF32 off) and
     its detections (postprocess, conf 0.3, window 128) against
     FusedPipeline's on the same batch, the launches of stem_s2d8 and
     s2span over the five (counts to 0 just before, read just after); the
     per-stage split of all six combinations (`upto=`); s2span per stage
     against the cuDNN stride-2 block + span it replaces, with its time
     by kernel name and device launches held to `span_stage_plan`'s,
     stem_s2d8 against stem_s2d on the same images, each with its bound,
     and stem_s2d8's time by kernel name and launches held to
     `stem_plan`'s;
  5. shutdown: server, batcher and threads;
  7. eval: `fastdet_torch.cli.evaluation.run_evaluation`, both passes
     (windows 1815 and 1024, through nms_keep), default and --fused mode,
     over 256 seeded photo variants in b128 batches with seeded labels;
     P/R/AP/F1 exactly those of the plain staged chain on the same
     forward outputs, images/s; the eval batch's split (the postprocess
     also as device busy time and the host's enqueue time); nms_keep at
     b128 on the windows k = 512, 1024 (conf 0.3) and 1815, back to back,
     and its time by kernel name and device launches (torch.profiler),
     held to `nms_keep_plan`'s; both variants on the first 8, 32, 64 and
     128 images of each window;
  7b. 640²: stem_s2d and span against their plain versions there (span
     at B ∈ {1, 32}: stage 2 through the stage kernel's per-block
     variant, stages 3-4 through clusters; the cuDNN stem at b32 beside
     stem_s2d, whose time by kernel name and launches are held to
     `stem_plan`'s), and
     FusedPipeline against DevicePipeline on 8 photo variants;
  8a. span_train (B8) forward and backward against their plain versions
     at the three stages at b128 352², at b1, at small geometries with
     ghost group < batch and at the edges of its launch plan (tiles cut
     off at the image's edge, groups of unequal tiles); times, bounds and
     the cuDNN blocks' training-mode times at b128, and by torch.profiler
     each stage call's time by kernel name and its device launches (held
     to the plan's);
  8c. stem_train (B7) forward and backward against their plain versions
     at b128 352² (photo variants, reference weights) at ghost group 1
     and 16, b8 at group 4, b2 160×96 with pad lanes, on images with
     flat blocks (positive pool ties), at 32×48 and 36×52 (tiles cut
     off at the image's edge), and with γ of both signs and one γ = 0;
     y and the pooled conv z bit for bit the plain conv, BN, ReLU and
     pool with the kernel's own stats; the backward bitwise repeatable;
     the plan's shared memory the kernels'; times, bounds and the nhwc
     stem's (cuDNN conv, training BN, ReLU, max_pool2d) at b128, and by
     torch.profiler each call's time by kernel name and its device
     launches (held to `stem_train_plan`'s);
  8b. training: 4 steps at b128 352² from the reference weights on each
     path: default and --fused-backbone through
     `fastdet_torch.cli.train.run_training` (B8's launches counted over
     the fused run), and the fused s2d path through the Trainer
     (`fused_input_format="s2d_u8"`: B7 and B8 counted; then 2 steps at
     stem group 16 through `build_fused_train_apply(stem_group=16)`) on
     the batch packed once by `pack_images_s2d` (its
     host time printed apart); the fused step with the kernels against
     the plain spans and the s2d step against the plain stem (b128), the
     fused step against the default step at b2, the s2d step at stem
     group 2 (b2) and 1 (b1) against the default step on noise images
     (in the s2d ones, the stem's three gradients also one by one);
     ms/step, img/s and a profile of the three modes (B7's kernels'
     share of the s2d step read from its profile);
  8d. the anchor-free family: the golden detections
     (tests/data/anchorfree_golden.json, `weights/anchorfree-synth.npz`,
     128²) through `FusedPipeline(family="anchorfree")` (B1, B2, their
     launches held to the plans) and through the nn path in cuDNN; at
     full width (`AnchorFreeDetector(classes=80)`, seeded, 352², b128
     photo variants packed s2d on the card) the fused maps within 2e-4
     of the nn model's on three input forms, detections equal to the nn
     path's at the serving point (conf 0.3, window 128) and the eval mAP
     window (conf 0.01, window 1024) but for near ties (printed, each
     with its distance from the threshold or its partner), B1 and B2
     launched on the main
     path (counts to 0 just before, read just after; the plain stem and
     span swapped for ones that raise), img/s by CUDA-event medians,
     `stem_kernel` and the stage kernel in the detect call's profile
     held to `stem_plan` and `span_stage_plan`;
     `run_evaluation(family="anchorfree")` on phase 7's images (labels
     from the model's own detections, as phase 7's) in both modes, each
     mode's P/R/AP/F1 exactly those of decode, `batched_nms`
     and the metrics on the same forward's maps, the fused pass's within
     1e-3 of the default pass's; 3 b128 352²
     `Trainer(loss_fn=)` steps (finite losses, ms/step by CUDA events,
     the idle share by torch.profiler) and a b4 128² step's loss within
     1e-4 of the same step on the CPU;
  9. bf16 serving, the JAX package's default: the bf16 kernels (B1, B6,
     B10, B2, B9) against their plain versions at the f32 phases' shape
     classes (stems within one bf16 ULP, stages within 2⁻⁶ of the output's
     max |value|; max |Δ| and the share of equal elements), each call's
     launches held to `stem_plan` / `span16_plan` and each stage plan's
     shared memory to the kernel's (`fastdet_span16_smem`);
     `FusedPipeline(dtype=None)` behind the HTTP server (phase 4's 12
     concurrent /detect_raw requests, the bf16 kernels' launches counted
     from 0), its detections and its b128 352² detections held to the JAX
     package's bf16 contract against the f32 pipeline (classes, boxes
     ≤ 4 px, scores ≤ 0.05; rows near conf or iou_thres reported), img/s
     on the device and host to host, its profile and per-stage split; each
     bf16 kernel on the served batch's inputs with its bound, its plain
     version's and cuDNN's bf16 time; the five other flag combinations in
     bf16 (forward times, detections against f32); `FusedPipeline` at 640²
     in bf16 (B6); the anchor-free family in bf16 at b128 352² (phase 8d's
     model);
  10. bf16 training, the JAX package's training headline: the bf16 forms
     of B8 (`csrc/span16_train.cu`: the three stages at b128 352², real
     weights, the JAX package's groups; stage 3 with seeded weights; two
     small shapes and `SPAN_TRAIN_EDGE`; each block's z as the backward
     recomputes it bit for bit the forward's; the plan's cluster, the
     card's active clusters and the source's ptxas registers and spills
     printed) and
     B7 (`csrc/stem16_train.cu`: b128 352² photo variants at group 1 and
     16, two tie images; the plan's shared memory the kernels')
     against their plain bf16 versions (B8's outputs and gradients within
     2⁻⁶ of max |value|, the seeded stage 3's gradients within twice the
     plain version's own distance from its f64 sums where that is larger,
     the stats within 5e-5; B7's y within one bf16 ULP and y bit for bit
     the plain rounded chain with the kernel's stats, the pool windows'
     winners it saves for the backward (code, zw) bit for bit
     `stem16_winners_reference` of the plain conv, its gradients within
     2⁻⁶), each call's launches held to the plans, times beside the bounds,
     the plain versions' and cuDNN bf16's; the Trainer in bf16 (default,
     --fused-backbone, fused s2d at group 1 and 16) at b128 352² from the
     reference weights with the bf16 kernels' counts from 0 (the f32
     kernels must stay at 0), f32 parameters and momentum and bf16
     outputs, each fused mode's step against the same step on the plain
     bf16 versions (step 1's kernel backward calls against the plain
     versions on the same inputs within 2⁻⁶, step 1's gradients within
     relative L2 0.5 by group of leaves, the loss and the parameters after
     2 steps within 2⁻⁵), ms/step, img/s and the device busy share beside
     8b's f32 step (`bf16_train_phase.py` runs it alone);
  11. int8 PTQ: `weights/coco-int8.npz` through `forward_from` at b128
     352² on photo variants with both MACs (f32 products, and
     `torch._int_mm`), every op's int8 input and integer accumulator
     bitwise between them and against the port's CPU run on 4 of the
     images, the maps bitwise or within one ULP of the CPU's (printed);
     `calibrate` (32 variants, b8) on the card within one histogram bin
     of the CPU's; the int8 detections at the serving point (conf 0.3,
     iou 0.4, window 128) against the f32 model's on the photo by the JAX
     package's rule (counts ±1, classes, IoU ≥ 0.7), for the artifact and
     for the photo's own calibration, and on the 128 variants (how many
     hold it, printed); `run_evaluation(int8=...)` on phase 7's images,
     its P/R/AP/F1 those of the plain staged chain on the int8 maps,
     beside f32's; rank_decode_nms's and nms_keep's launches counted from
     0 on the int8 serving detect and eval, and each kernel on the int8
     path's windows; the forward's time for each MAC beside the f32 nn
     forward's, with the card's name and power limit
     (`int8_phase.py` runs it alone);
  12. convergence: `fastdet_torch.tools.convergence_check.run_convergence`
     at its defaults (600 steps of b32 128², the synthetic task, seed 0)
     for Yolo-FastestV2 in bf16 in the fused s2d mode (B7 and B8 in
     bf16), held to the tool's bar (final mAP@0.5 over 0.5 and above step
     0's), its AP curve, seconds, img/s and the card printed, the
     launches of B7, B8 (both dtypes) and B3 counted from 0 over the run
     (the bf16 B8 3 a step each way, the bf16 B7 1, the f32 ones none, B3
     2 an eval); then B8 bf16 at the run's three stages (ghost groups of
     16) against its plain version on the card tests' seeded inputs by
     the witness rule of `span16_backward_errs` (the trained weights'
     distances printed beside), B7 bf16 on the run's first batch with the
     trained stem, and B3 on the trained model's eval window (b32, k =
     240) bit for bit, each with its time, bound, plain version's and
     cuDNN's;
  6. the kernel summary (a JSON line: launches of stem_s2d, span and
     rank_decode_nms from the fused serving path (rank_decode_nms's ms
     its device time on the served window, phase 4), of nms_keep from the
     eval path, of stem_s2d at 640² from FusedPipeline there, of
     span_train_fwd/bwd from the fused training run, of stem_train_fwd/bwd
     from the s2d training runs at group 1 and 16, of stem_s2d8 and
     s2span from the flag paths of 4c, phase 9's bf16 entries and phase
     10's bf16 training entries, phase 11's int8 entries of
     rank_decode_nms and nms_keep, phase 12's of the bf16 B8 and B7 and
     of rank_decode_nms on the convergence path; the phase line adds
     stem_s2d's and
     span's launches on the anchor-free
     path of 8d), the card line, and
     the host time of each phase, and the last line {"ok": true,
     "device": {...}}.

The last-but-one lines and the last line are read by tools; keep them.
"""

from __future__ import annotations

import faulthandler
import json
import os
import shutil
import struct
import subprocess
import sys
import threading
import time
import urllib.request
import zlib

import numpy as np

WATCHDOG_S = 900          # a hang becomes a traceback and exit 1
REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "data", "coco.data")
WEIGHTS = os.path.join(REPO, "weights", "coco2017-ref.npz")
PHOTO = os.path.join(REPO, "test_result.png")

# the card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
PEAK_F16_TC_OPS_S = 989e12     # f16 on the tensor cores, f32 accumulate

# rank_decode_nms is held against its plain version on the card with the
# seeded windows and tolerance of tests/torch_cases.py: keep bitwise, boxes
# within BOX_ULPS_CARD units in the last place of the box's largest
# |coordinate| (imported once the repository is on sys.path).


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"smoke check failed: {msg}")


def read_png_bgr(path: str) -> np.ndarray:
    """8-bit RGB/RGBA non-interlaced PNG → (H, W, 3) uint8 BGR (no cv2)."""
    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        ln, typ = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + ln]
        if typ == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif typ == b"IDAT":
            idat.append(body)
        elif typ == b"IEND":
            break
        pos += 12 + ln
    w, h, depth, ctype, _, _, interlace = hdr
    check(depth == 8 and ctype in (2, 6) and not interlace,
          "PNG must be 8-bit RGB(A), not interlaced")
    bpp = 3 if ctype == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * bpp)
    out = np.zeros((h, w * bpp), np.uint8)
    prev = np.zeros(w * bpp, np.int64)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = line
        elif ftype == 1:                                   # Sub
            cur = np.cumsum(line.reshape(w, bpp), axis=0).ravel() % 256
        elif ftype == 2:                                   # Up
            cur = (line + prev) % 256
        else:                                              # Average, Paeth
            cur = np.zeros_like(line)
            for x in range(len(line)):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[x] = (line[x] + pred) % 256
        out[y] = cur
        prev = cur
    return out.reshape(h, w, bpp)[..., 2::-1].copy()


def resize_u8(img: np.ndarray, hw=(352, 352)) -> np.ndarray:
    """Bilinear resize of an HWC uint8 image with torch on the CPU."""
    import torch
    import torch.nn.functional as F
    t = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    t = F.interpolate(t.float(), size=hw, mode="bilinear",
                      align_corners=False)
    return t.round().clamp(0, 255).to(torch.uint8)[0].permute(1, 2, 0) \
        .contiguous().numpy()


def photo_variants(photo: np.ndarray, count: int, seed: int,
                   hw=(352, 352)) -> np.ndarray:
    """Seeded crops (60-100% of each side) and mirror images of the photo,
    at `hw`: real scenes, so that the model detects things."""
    rng = np.random.default_rng(seed)
    h, w = photo.shape[:2]
    out = []
    for _ in range(count):
        ch = int(rng.integers(int(0.6 * h), h + 1))
        cw = int(rng.integers(int(0.6 * w), w + 1))
        y0 = int(rng.integers(0, h - ch + 1))
        x0 = int(rng.integers(0, w - cw + 1))
        crop = photo[y0:y0 + ch, x0:x0 + cw]
        if rng.random() < 0.5:
            crop = crop[:, ::-1]
        out.append(resize_u8(crop, hw))
    return np.stack(out)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over iters calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean host time (host clock) to enqueue fn() over iters calls, the
    device not waited for until the last: where it is about the CUDA-event
    time of the same calls back to back, the host sets their pace."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs * 1e3 / iters


def bound(nbytes: float, ops: float, peak_ops_s: float = PEAK_F32_OPS_S):
    """→ (ms, "bytes" or "operations"): the larger of the two least times
    on the card's published peaks (f32 outside the tensor cores unless
    `peak_ops_s` names the rate of the kernel's operation type)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / peak_ops_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rdn_bound(neg_k, combo_k, nc=None):
    """Least time for rank_decode_nms on these inputs: bytes it must move
    (sort keys, gathered reg rows (16 B) and the distinct geometry rows it
    reads (20 B), keep (1 B) and boxes (16 B) out) over the memory rate,
    and its f32 operations (≈40 per candidate decode, 14 per IoU against
    a valid higher-ranked candidate) over the f32 rate; `nc` classes
    (80 by default).  → (ms, by)."""
    from torch_cases import NC
    nc = nc or NC
    b, k = neg_k.shape
    valid = (neg_k < 0).cpu().numpy()
    # pairs (i, j) with j < i and j valid, per image
    pairs = int((np.cumsum(valid, axis=1) - valid).sum())
    n_geo = int(np.unique((combo_k // nc).cpu().numpy()).size)
    nbytes = b * k * (4 + 4 + 16 + 1 + 16) + n_geo * 20
    return bound(nbytes, b * k * 40 + pairs * 14)


def phase_device():
    import torch
    from fastdet_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build_all()                    # one nvcc per source, at once
    build_s = time.perf_counter() - t0
    each = ", ".join(f"{n} {i['seconds']:.2f} s"
                     for n, i in _build.build_log.items())
    log(f"phase 1 device: {torch.cuda.get_device_name(0)} | nvidia-smi: "
        f"{card} | python {sys.version.split()[0]} torch {torch.__version__}"
        f" cuda {torch.version.cuda} | nvcc {_build.nvcc_path()} | ninja "
        f"{shutil.which('ninja')} | kernel builds {build_s:.2f} s in "
        f"parallel ({each})")
    for name, info in _build.build_log.items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return card


def rdn_split(fn, what: str, b: int, k: int):
    """One rank_decode_nms call's device time by kernel name and its
    device launches (torch.profiler), held to `rank_decode_nms_plan`
    (`kernel_launch_split`) → device ms a call."""
    from fastdet_torch.kernels import pp_fused
    plan = pp_fused.rank_decode_nms_plan(b, k)
    split, _ = kernel_launch_split(
        fn, pp_fused.rank_decode_nms, what, plan.launches, plan.kernel,
        f"{plan.ctas} CTAs of {plan.threads} threads, {plan.smem_bytes} B "
        f"of shared memory each", tries=5)
    return split[plan.kernel][0]


def phase_kernels():
    import torch
    from torch_cases import (BOX_ULPS_CARD, IOU, NC, NV_CLASSES, box_ulps,
                             make_inputs, nv_window, port_geo)
    from fastdet_torch.kernels import pp_fused
    geo = port_geo("cuda:0")
    max_err, bitwise = 0.0, True
    classes = [(b, k, case, make_inputs(k + b, b, k, case))
               for b in (1, 128) for k in (128, 256, 384)
               for case in ("dense", "sparse", "clustered")]
    classes += [(b, 384, f"n_v {nv}", nv_window(nv, b))
                for b in (1, 128) for nv in NV_CLASSES]
    for b, k, case, arrays in classes:
        args = [torch.from_numpy(a).cuda() for a in arrays] + [geo]
        keep, boxes = pp_fused.rank_decode_nms(*args, nc=NC, iou_thres=IOU)
        rkeep, rboxes = pp_fused.rank_decode_nms_reference(
            *args, nc=NC, iou_thres=IOU)
        torch.cuda.synchronize()
        nb, rb = boxes.cpu().numpy(), rboxes.cpu().numpy()
        ulps = float(box_ulps(nb, rb).max())
        n_valid = int((args[0] < 0).sum())
        n_keep = int(keep.sum())
        check(torch.equal(keep, rkeep), f"keep differs at b={b} k={k} {case}")
        check(ulps <= BOX_ULPS_CARD,
              f"boxes {ulps} ULPs off at b={b} k={k} {case}")
        if case.startswith("n_v"):
            nv = int(case.split()[1])
            check(n_valid == nv * b and (n_keep == n_valid if nv <= 1
                                         else 0 < n_keep < n_valid),
                  f"b={b} k={k} {case}: {n_keep}/{n_valid} kept")
        else:
            check(0 < n_keep < n_valid,
                  f"trivial case b={b} k={k} {case}: {n_keep}/{n_valid}")
        max_err = max(max_err, float(np.abs(nb - rb).max()))
        bitwise &= bool(np.array_equal(nb, rb))
        run = (lambda a=args: pp_fused.rank_decode_nms(
            *a, nc=NC, iou_thres=IOU))
        plain = (lambda a=args: pp_fused.rank_decode_nms_reference(
            *a, nc=NC, iou_thres=IOU))
        what = f"rank_decode_nms b={b} k={k} {case}"
        dev_ms = rdn_split(run, what, b, k)
        ms, plain_ms = cuda_ms(run, 50), cuda_ms(plain, 3, 1)
        log(f"  {what}: keep equal ({n_keep}/{n_valid} kept), boxes "
            f"{ulps:g} ULPs, kernel {dev_ms:.4f} ms on the device, {ms:.4f} "
            f"back to back, plain {plain_ms:.3f} ms")
    log(f"phase 2 kernels: rank_decode_nms equals its plain version at "
        f"{len(classes)} shape classes (18 windows, 18 n_v classes); boxes "
        f"bitwise: {bitwise}, max |Δ| {max_err:g}")
    return max_err


def phase_weights_forward(photo):
    import torch
    from fastdet_torch.io import load_state_dict
    from fastdet_torch.models import Detector
    sd = load_state_dict(WEIGHTS)
    n = sum(t.numel() for t in sd.values())
    check(n == 251_664 - 73, f"weights carry {n} floats")
    x = np.stack([resize_u8(photo), np.random.default_rng(3).integers(
        0, 256, (352, 352, 3), dtype=np.uint8)])
    x = torch.from_numpy(x).float() / 255.0
    cpu = Detector(80, 3)
    cpu.load_state_dict(sd)
    card = Detector(80, 3)
    card.load_state_dict(sd)
    card = card.cuda().eval()
    # f32 on the card, as DevicePipeline sets it for the process
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        ref = cpu.eval()(x)
        out = card(x.cuda())
        torch.cuda.synchronize()
    err = max(float((o.cpu() - r).abs().max()) for o, r in zip(out, ref))
    check(all(torch.isfinite(o).all() for o in out), "non-finite forward")
    check(err <= 2e-4, f"forward on the card {err} off the CPU's")
    pth_rows = phase_pth_weights(sd, photo)
    log(f"phase 3 weights+forward: {n} floats carried; 6 NHWC outputs "
        f"{[tuple(o.shape) for o in out]}; card vs CPU max |Δ| {err:.3g} "
        f"(≤ 2e-4, TF32 off); the reference-layout .pth of the same weights "
        f"(`torch_cases.write_reference_pth`, in a temporary directory): "
        f"its state dict bit for bit the .npz's, the photo's {pth_rows} "
        f"FusedPipeline detections bit for bit the .npz's")
    return sd


def phase_pth_weights(sd, photo):
    """3: `load_state_dict` of a reference-layout `.pth` (the reference
    weights written back in the reference's names, `num_batches_tracked`
    and all) equals the `.npz`'s, and `FusedPipeline` (bf16, the serving
    default) serves the photo with it bit for bit as with the `.npz`.
    → the detections' count."""
    import tempfile
    import torch
    from fastdet_torch.config import Config
    from fastdet_torch.io import load_state_dict
    from fastdet_torch.serve import FusedPipeline
    from torch_cases import write_reference_pth
    with tempfile.TemporaryDirectory() as tmp:
        sd_pth = load_state_dict(str(write_reference_pth(
            WEIGHTS, os.path.join(tmp, "coco2017-ref.pth"))))
    check(sorted(sd_pth) == sorted(sd)
          and all(torch.equal(sd_pth[k], sd[k]) for k in sd),
          "the .pth state dict is not the .npz's")
    cfg = Config.from_file(DATA)
    img = resize_u8(photo)[None]
    rows = [FusedPipeline(w, cfg)(img)[0] for w in (sd_pth, sd)]
    check(len(rows[1]) > 0 and rows[0].dtype == rows[1].dtype
          and np.array_equal(rows[0], rows[1]),
          f"FusedPipeline from the .pth: {rows[0]}, from the .npz: {rows[1]}")
    return len(rows[1])


class Recorder:
    """The pipeline behind the server, recording each batch it ran."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.calls = []

    def __call__(self, batch):
        out = self.pipe(batch)
        self.calls.append((batch.copy(), out))
        return out


def post_raw(port, img):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/detect_raw", data=img.tobytes(),
        headers={"X-Height": str(img.shape[0]), "X-Width": str(img.shape[1])})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def as_answer(rows, names):
    """What the server makes of pipeline rows for a 352² request."""
    return [{"box": [round(float(v), 2) for v in r[:4]],
             "score": round(float(r[4]), 4), "class_id": int(r[5]),
             "class_name": names[int(r[5])]} for r in rows]


def serve_concurrently(pipe, images, cfg, names, kernels):
    """Serve each image as one concurrent /detect_raw request through the
    HTTP server over `pipe`.  The launch counts of `kernels` are set to 0
    just before the requests and read just after.  Each answer must equal
    the pipeline's rows for that image in the batch the server ran, and a
    direct call on each such batch must give the same rows.  → (answers,
    the served rows per image, stats, {kernel name: launches})."""
    from fastdet_torch.server import InferenceServer
    for bsz in (1, 2, 4, 8, 16):                       # server buckets
        pipe(np.resize(images, (bsz,) + images.shape[1:]))
    rec = Recorder(pipe)
    server = InferenceServer(rec, cfg, names=names, max_batch=16,
                             max_wait_ms=200.0)
    answers = [None] * len(images)
    errors = []

    def client(i):
        try:
            answers[i] = post_raw(port, images[i])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    try:
        # ---- the main path: counts to 0, serve, read the counts
        for k in kernels:
            k.launches = 0
        port = server.start()
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(len(images))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        launches = {k.__name__: k.launches for k in kernels}
        check(not errors and all(not t.is_alive() for t in threads),
              f"requests failed: {errors}")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
    for name, n in launches.items():
        check(n > 0, f"the served requests launched no {name}")
    check(stats["requests"] == len(images), f"stats {stats}")

    for batch, out in rec.calls:
        again = pipe(batch)
        check(all(np.array_equal(a, b) for a, b in zip(out, again)),
              "a direct pipeline call on a served batch differs")
    for i, ans in enumerate(answers):
        check(set(ans) == {"detections", "count", "image_size"}
              and ans["count"] == len(ans["detections"])
              and ans["image_size"] == [352, 352], f"malformed answer {ans}")
        rows = [out[j] for batch, out in rec.calls
                for j in range(len(out)) if np.array_equal(batch[j],
                                                           images[i])]
        check(len(rows) >= 1, f"request {i} not in any served batch")
        check(ans["detections"] == as_answer(rows[0], names),
              f"answer {i} differs from the pipeline's rows")
        for d in ans["detections"]:
            check(np.isfinite(d["box"]).all() and 0 <= d["class_id"] < 80
                  and 0.3 <= d["score"] <= 1, f"bad detection {d}")
    check(sum(a["count"] for a in answers) > 0,
          "no detections in the served photos")
    served = [next(out[j] for batch, out in rec.calls
                   for j in range(len(out))
                   if np.array_equal(batch[j], img)) for img in images]
    return answers, served, stats, launches


def phase_serving(sd, photo, card):
    import torch
    from fastdet_torch.config import Config, load_names, resolve_path
    from fastdet_torch.kernels import pp_fused
    from fastdet_torch.models import Detector
    from fastdet_torch.ops.postprocess import rank_scores
    from fastdet_torch.serve import DevicePipeline

    cfg = Config.from_file(DATA)
    names = load_names(resolve_path(cfg.names, DATA))
    pipe = DevicePipeline(Detector(80, 3), sd, cfg)
    images, big = served_batch(photo)
    answers, _, stats, launches = serve_concurrently(
        pipe, images, cfg, names, [pp_fused.rank_decode_nms])
    launches = launches["rank_decode_nms"]
    n_det = sum(a["count"] for a in answers)
    log(f"phase 4 serving: {len(images)} concurrent /detect_raw requests in "
        f"{stats['batches']} batches {stats['batch_hist']}, {n_det} "
        f"detections, each equal to DevicePipeline on the same batch; "
        f"rank_decode_nms launches on this path: {launches}")

    # conf 0.01 fills the 128-wide window; held against the CPU pipeline
    low = DevicePipeline(Detector(80, 3), sd, cfg, conf_thres=0.01)
    low_cpu = DevicePipeline(Detector(80, 3), sd, cfg, conf_thres=0.01,
                             device="cpu")
    sub = images[:4]
    with torch.inference_mode():
        model = Detector(80, 3)
        model.load_state_dict(sd)
        model = model.cuda().eval()
        ranked, *_ = rank_scores(
            model(torch.from_numpy(sub).cuda().float() / 255.0), (352, 352),
            0.01)
    n_cand = (ranked > 0).sum(1).tolist()
    check(max(n_cand) >= 128, f"window not filled: {n_cand}")
    got, want = low(sub), low_cpu(sub)
    for a, b in zip(got, want):
        check(a.shape == b.shape and np.array_equal(a[:, 5], b[:, 5])
              and np.abs(a[:, 4] - b[:, 4]).max(initial=0) <= 1e-4
              and np.abs(a[:, :4] - b[:, :4]).max(initial=0) <= 1e-2,
              "conf-0.01 detections on the card differ from the CPU's")
    log(f"  conf 0.01: candidates per image {n_cand} (window 128), "
        f"detections {[len(a) for a in got]}, equal to the CPU pipeline "
        f"(classes; scores ≤ 1e-4, boxes ≤ 1e-2 px)")

    # throughput at b128 on the device
    ips_ms = cuda_ms(lambda: pipe.detect(big), 20)
    host_big = big.cpu().numpy()
    pipe(host_big)
    t0 = time.perf_counter()
    for _ in range(5):
        pipe(host_big)
    host_ms = (time.perf_counter() - t0) / 5 * 1e3
    log(f"  throughput b128 352² ({card}): {128e3 / ips_ms:.1f} img/s on "
        f"the device (uint8 on the card → detections, {ips_ms:.3f} ms per "
        f"batch, CUDA events); {128e3 / host_ms:.1f} img/s host to host")
    return launches, big, pipe, images


def served_batch(photo):
    """The served batch: 12 variants of the photo (phase 4's concurrent
    requests) and those repeated to b128 → (images (12, 352, 352, 3) u8,
    big (128, 352, 352, 3) u8 on the card)."""
    import torch
    images = photo_variants(photo, 12, seed=0)
    return images, torch.from_numpy(np.concatenate([images] * 11)[:128]).cuda()


def served_window(sd, big):
    """The reference model (state dict `sd`, f32, TF32 off) on the served
    batch `big`, and the window its postprocess hands rank_decode_nms at
    the serving point (conf 0.3, k = 128; `ops.postprocess.postprocess`'s
    steps) → (model, its input x, its outputs, (neg_k, combo_k, regs,
    geo)), all on the card."""
    import torch
    from fastdet_torch import disable_tf32
    from fastdet_torch.config import Config
    from fastdet_torch.models import Detector
    from fastdet_torch.ops.postprocess import (_anchors_array, _geo_table,
                                               rank_scores, rank_topk)
    from torch_cases import NC
    disable_tf32(torch.device("cuda"))
    cfg = Config.from_file(DATA)
    model = Detector(80, 3)
    model.load_state_dict(sd)
    model = model.cuda().eval()
    with torch.inference_mode():
        x = big.float() / 255.0
        outputs = model(x)
        ranked, reg_f, cls_f, meta = rank_scores(outputs, (352, 352), 0.3)
        neg_k, combo_k = rank_topk(ranked, cls_f, nc=NC, k=128)
        geo = _geo_table(meta, tuple(_anchors_array(np.asarray(
            cfg.anchors, np.float32)).ravel().tolist()), "cuda:0")
    return model, x, outputs, (neg_k, combo_k, reg_f.contiguous(), geo)


def main_path_kernel_timing(sd, big):
    """The b128 serving batch split into forward and postprocess, and
    rank_decode_nms on the inputs that batch gives it."""
    import torch
    from fastdet_torch.config import Config
    from fastdet_torch.kernels import pp_fused
    from fastdet_torch.ops.postprocess import postprocess
    from torch_cases import BOX_ULPS_CARD, IOU, NC, box_ulps
    cfg = Config.from_file(DATA)
    anchors = np.asarray(cfg.anchors, np.float32).reshape(2, 3, 2)
    model, x, outputs, args = served_window(sd, big)
    neg_k, combo_k = args[:2]
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(x), 20)
        post_ms = cuda_ms(lambda: postprocess(
            outputs, anchors, (352, 352), max_nms=128), 20)
        keep, boxes = pp_fused.rank_decode_nms(*args, nc=NC, iou_thres=IOU)
        rkeep, rboxes = pp_fused.rank_decode_nms_reference(
            *args, nc=NC, iou_thres=IOU)
        check(torch.equal(keep, rkeep), "keep differs on the served batch")
        nb, rb = boxes.cpu().numpy(), rboxes.cpu().numpy()
        err = float(np.abs(nb - rb).max())
        ulps = float(box_ulps(nb, rb).max())
        check(ulps <= BOX_ULPS_CARD,
              f"boxes {ulps} ULPs off on the served batch")
        b2b_ms = cuda_ms(lambda: pp_fused.rank_decode_nms(
            *args, nc=NC, iou_thres=IOU), 100, 10)
        plain_ms = cuda_ms(lambda: pp_fused.rank_decode_nms_reference(
            *args, nc=NC, iou_thres=IOU), 10, 2)
        ms = rdn_split(lambda: pp_fused.rank_decode_nms(
            *args, nc=NC, iou_thres=IOU),
            "rank_decode_nms on the served b128 batch", 128, 128)
    nv = (neg_k < 0).sum(1).float().cpu()
    bound_ms, bound_by = rdn_bound(neg_k, combo_k)
    log(f"  b128 split (CUDA events): forward {fwd_ms:.3f} ms, postprocess "
        f"{post_ms:.3f} ms (scores, sort, window, rank_decode_nms, "
        f"compaction)")
    log(f"  rank_decode_nms on the served b128 batch (B=128, k=128, N=1815; "
        f"n_v per image min {int(nv.min())} median {float(nv.median()):g} "
        f"max {int(nv.max())}, {int(keep.sum())} kept): kernel {ms:.4f} ms "
        f"on the device, {b2b_ms:.4f} back to back, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.6f} ms ({bound_by}), keep equal, boxes {ulps:g} "
        f"ULPs (max |Δ| {err:g})")
    return ms, plain_ms, bound_ms, bound_by, err


# ------------------------------------------------ the fused path (B1, B2)

FUSED_ATOL = 2e-4   # stem and span against their plain versions, and the
                    # fused forward against Detector: the f32 forward
                    # contract (other summation orders, FMA contraction)


def stem_bound(b, h4, w4):
    """stem_s2d: the image's uint8 pixels read once, its 672 weights, the
    pooled f32 map written once; 2 operations per conv MAC (27 per conv
    output, 4 conv outputs per pooled cell and channel), twice over (the
    weights' two f16 terms), at the f16 tensor-core rate the kernel's
    products run at."""
    nbytes = b * 48 * h4 * w4 + 672 * 4 + b * 24 * h4 * w4 * 4
    return bound(nbytes, b * 4 * h4 * w4 * 24 * 27 * 2 * 2,
                 PEAK_F16_TC_OPS_S)


def span_bound(b, c, h, w, nblk):
    """span: the activation read once and written once, the weights once;
    2 operations per MAC, (C/2)²·2 + 9·C/2 MACs per pixel and block."""
    mid = c // 2
    nbytes = 2 * b * c * h * w * 4 + nblk * (2 * mid * mid + 12 * mid) * 4
    return bound(nbytes, nblk * b * h * w * 2 * (2 * mid * mid + 9 * mid))


def phase_fused_kernels(sd):
    """B1 and B2 against their plain versions on the card at every shape
    class the fused path dispatches, with the folded weights of the fused
    forward.  → max |Δ| of each."""
    import torch
    from fastdet_torch.kernels import _build
    from fastdet_torch.kernels import fused_infer as fi
    from fastdet_torch.kernels.fold import STAGES
    from torch_cases import STEM_CASES, stem_case
    _, p = fi.build_fused_forward(sd)
    w, bias = p["stem_w"], p["stem_b"]
    err = {"stem_s2d": 0.0, "span": 0.0}
    stem_lib = _build.load("stem_s2d", fi._STEM_SIGNATURES)
    for bsz, ih, iw in STEM_CASES:
        h4, w4 = ih // 4, iw // 4
        plan = check_stem_smem(stem_lib, bsz, h4, w4, 4)
        x = stem_case(bsz + ih, bsz, ih, iw, "cuda")   # junk in the pad
        got = fi.stem_s2d(x, w, bias, h4, w4)
        want = fi.stem_s2d_reference(x, w, bias, h4, w4)
        e = float((got - want).abs().max())
        check(e <= FUSED_ATOL, f"stem_s2d {e} off at b={bsz} {ih}x{iw}")
        err["stem_s2d"] = max(err["stem_s2d"], e)
        ms = cuda_ms(lambda: fi.stem_s2d(x, w, bias, h4, w4), 20)
        plain_ms = cuda_ms(
            lambda: fi.stem_s2d_reference(x, w, bias, h4, w4), 5, 1)
        log(f"  stem_s2d b={bsz} {ih}x{iw} (h4={h4}, w4={w4}, npad="
            f"{x.shape[2]}; {plan.tiles} tiles of {plan.rows} × "
            f"{plan.cols}, {plan.grid[0]} CTAs, {plan.smem_bytes} B): "
            f"max |Δ| {e:.3g}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    lib = _build.load("span", fi._SPAN_SIGNATURES)
    for (stage, reps, c), hw in zip(STAGES, (44, 22, 11)):
        weights = p[f"s{stage}_span"]
        for bsz in (1, 128):
            plan = check_stage_smem(lib, bsz, c, hw, hw, reps - 1, False)
            rng = np.random.default_rng(stage * 1000 + bsz)
            x = torch.from_numpy(np.abs(rng.normal(
                0.0, 1.0, (bsz, c, hw, hw))).astype(np.float32)).cuda()
            got = fi.span(x, weights, reps - 1)
            want = fi.span_reference(x, weights, reps - 1)
            e = float((got - want).abs().max())
            check(e <= FUSED_ATOL, f"span {e} off at b={bsz} C={c}")
            err["span"] = max(err["span"], e)
            ms = cuda_ms(lambda: fi.span(x, weights, reps - 1), 20)
            plain_ms = cuda_ms(
                lambda: fi.span_reference(x, weights, reps - 1), 5, 1)
            log(f"  span b={bsz} C={c} {hw}x{hw} nblk={reps - 1} "
                f"({plan.variant}, cluster {plan.cluster}, {plan.launches} "
                f"launch): max |Δ| {e:.3g}, kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms")
    log(f"phase 2b fused kernels: stem_s2d ({len(STEM_CASES)} shapes) and "
        f"span (6) within {FUSED_ATOL:g} of their plain versions; the stem "
        f"and stage plans' shared memory the kernels'; max |Δ| stem_s2d "
        f"{err['stem_s2d']:.3g}, span {err['span']:.3g}")
    return err


def phase_fused_forward(sd, photo):
    """The fused forward on the card against the port's Detector on the
    card (TF32 off), all six outputs."""
    import torch
    from fastdet_torch.kernels import fused_infer as fi
    from fastdet_torch.models import Detector
    imgs = np.stack([resize_u8(photo), np.random.default_rng(4).integers(
        0, 256, (352, 352, 3), dtype=np.uint8)])
    fwd, p = fi.build_fused_forward(sd)
    det = Detector(80, 3)
    det.load_state_dict(sd)
    det = det.cuda().eval()
    with torch.inference_mode():
        got = fwd(torch.from_numpy(fi.pack_images_s2d(imgs)).cuda(), p)
        want = det(torch.from_numpy(imgs).cuda().float() / 255.0)
        torch.cuda.synchronize()
    check(all(bool(torch.isfinite(g).all()) for g in got),
          "non-finite fused forward")
    check([g.shape for g in got] == [w.shape for w in want],
          "fused forward shapes differ from Detector's")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(err <= FUSED_ATOL, f"fused forward {err} off Detector's")
    log(f"phase 3b fused forward: 6 NHWC outputs "
        f"{[tuple(g.shape) for g in got]}, card vs Detector on the card "
        f"max |Δ| {err:.3g} (≤ {FUSED_ATOL:g})")


def phase_fused_serving(sd, dev_pipe, images):
    """Concurrent requests through the server over FusedPipeline; each
    answer equal to FusedPipeline on the same batch, its detections as
    DevicePipeline's on the same images.  → (pipe, launches)."""
    import torch
    from fastdet_torch.config import Config, load_names, resolve_path
    from fastdet_torch.kernels import fused_infer as fi
    from fastdet_torch.kernels import pp_fused
    from fastdet_torch.serve import FusedPipeline
    cfg = Config.from_file(DATA)
    names = load_names(resolve_path(cfg.names, DATA))
    pipe = FusedPipeline(sd, cfg, dtype=torch.float32)
    answers, served, stats, launches = serve_concurrently(
        pipe, images, cfg, names,
        [fi.stem_s2d, fi.span, pp_fused.rank_decode_nms])
    device = dev_pipe(images)
    for i, (a, b) in enumerate(zip(served, device)):
        check(a.shape == b.shape and np.array_equal(a[:, 5], b[:, 5])
              and np.abs(a[:, 4] - b[:, 4]).max(initial=0) <= 1e-4
              and np.abs(a[:, :4] - b[:, :4]).max(initial=0) <= 1e-2,
              f"fused detections of image {i} differ from DevicePipeline's")
    log(f"phase 4b fused serving: {len(images)} concurrent /detect_raw "
        f"requests in {stats['batches']} batches {stats['batch_hist']}, "
        f"{sum(a['count'] for a in answers)} detections, each equal to "
        f"FusedPipeline on the same batch and to DevicePipeline on the same "
        f"images (classes; scores ≤ 1e-4, boxes ≤ 1e-2 px); launches on "
        f"this path: {launches}")
    return pipe, launches


def profile_device(fn, what: str, calls: int = 5, top: int = 12):
    """torch.profiler over `calls` calls of fn(): device time by kernel
    and the device's busy share of the window (the window measured by
    CUDA events around the same calls).  Device activity only: the rows
    read are kernels and copies, and recording every host operator of a
    training step cost seconds per profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
    window_us = start.elapsed_time(end) * 1e3
    # kernel rows only: an operator's row repeats its kernels' time
    dev = sorted(((e.key, e.self_device_time_total)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0), key=lambda kv: -kv[1])
    busy_us = sum(t for _, t in dev)
    if not dev:
        log("  profile: the profiler saw no device time (not measured)")
        return None
    log(f"  profile of {calls} {what} (torch.profiler): device busy "
        f"{busy_us / calls / 1e3:.3f} ms of {window_us / calls / 1e3:.3f} ms "
        f"per call, idle share {1 - busy_us / window_us:.3f}; by kernel, ms "
        f"per call:")
    for key, t in dev[:top]:
        log(f"    {t / calls / 1e3:.4f}  {100 * t / busy_us:5.1f}%  "
            f"{key[:90]}")
    by_name = {}
    for key, t in dev:
        name = kernel_base_name(key)
        by_name[name] = by_name.get(name, 0.0) + t / calls / 1e3
    return by_name


def kernel_base_name(key: str) -> str:
    """A profiler row's kernel name without its return type, namespaces,
    template arguments and parameters ("pw_kernel"); copies and sets keep
    their first word ("Memcpy", "Memset")."""
    if key.startswith(("Memcpy", "Memset")):
        return key.split()[0]
    name = key.replace("(anonymous namespace)::", "").split("(")[0]
    name = name.split("<")[0].split()
    return name[-1].split("::")[-1] if name else key


# Profiler sessions this run, and those taken again because a profile
# lost records (the phase-times line prints both).  The profiler loses
# kernel records now and then, in every session open during a spell of
# a fraction of a second to over a second (whole sessions' or a few
# calls'), so a profile is taken again only after a pause.
PROFILES = {"sessions": 0, "retaken": 0}
PROFILE_RETAKE_PAUSE_S = 2.0


def retake(i: int) -> None:
    """Before try i of a profile: after a failed one, count it and let
    the profiler's bad spell pass."""
    if i:
        PROFILES["retaken"] += 1
        time.sleep(PROFILE_RETAKE_PAUSE_S)


def kernel_split(fn, calls: int = 3):
    """torch.profiler over `calls` calls of fn(), device activity only,
    after one warm-up step of the profiler (the first records of a session
    have been seen to go missing) → {kernel base name: (ms per call,
    device launches per call)}; copies and sets count as launches.  None
    where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    PROFILES["sessions"] += 1
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=calls,
                                   repeat=1)) as prof:
        for _ in range(calls + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    split = {}
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.self_device_time_total <= 0):
            continue
        name = kernel_base_name(e.key)
        ms, n = split.get(name, (0.0, 0.0))
        split[name] = (ms + e.self_device_time_total / calls / 1e3,
                       n + e.count / calls)
    return split or None


def planned_split(fn, want: int, tries: int = 3):
    """`kernel_split` of fn, taken again (up to `tries` times) while it
    sees no device time or fewer device launches per call than `want`:
    the profiler has been seen to drop kernel records now and then, a
    whole session's too.  → (split, launches per call), (None, None)
    where no try saw device time."""
    split, n = None, None
    for i in range(tries):
        retake(i)
        got = kernel_split(fn)
        if got is None:
            continue
        split, n = got, sum(v[1] for v in got.values())
        if n >= want:       # more launches than planned is no lost record
            break
        log(f"  (profile {i + 1} of {tries} saw {n:g} device launches per "
            f"call, {want} planned)")
    return split, n


def device_busy_ms(fn):
    """The device's busy time in one call of fn(): its kernels' and copies'
    time by torch.profiler (`planned_split`), for fn whose calls back to
    back the host paces; None where no try saw device time."""
    split, _ = planned_split(fn, 1)
    return None if split is None else sum(ms for ms, _ in split.values())


def ms_text(ms) -> str:
    """A time in ms, or "not measured" for None."""
    return "not measured" if ms is None else f"{ms:.3f}"


def counted_split(fn, wrapper, what: str, want: int, names=None,
                  tries: int = 5):
    """One call of a kernel wrapper that counts one launch a call, its
    device launches (torch.profiler) held to the plan: `want` per call,
    of the kernels `names` where given.  A profile that disagrees is
    taken again, up to `tries` times; if none agrees but every one saw
    only planned kernels and fewer launches than planned, the profiler
    dropped records (it has, in spells of five tries at one call), which
    is reported beside the wrapper's count, as `kernel_launch_split`
    does; anything else fails.  → (split, launches per call, note), or
    (None, None, "") where no try saw device time."""
    before = wrapper.launches
    fn()
    counted = wrapper.launches - before
    check(counted == 1, f"{what}: the wrapper counts {counted} launches "
          f"per call, not 1")
    seen = []
    for i in range(tries):
        retake(i)
        got = kernel_split(fn)
        if got is None:
            continue
        n = sum(v[1] for v in got.values())
        if n == want and (names is None or sorted(got) == sorted(names)):
            return got, n, ""
        seen.append((got, n))
        log(f"  (profile {i + 1} of {tries} saw {n:g} device launches per "
            f"call, {want} planned)")
    if not seen:
        return None, None, ""
    check(all(n < want and (names is None or set(got) <= set(names))
              for got, n in seen),
          f"{what}: device launches per call {[n for _, n in seen]} of "
          f"{[sorted(got) for got, _ in seen]}, the plan says {want}"
          + (f" of {sorted(names)}" if names else ""))
    split, n = max(seen, key=lambda gn: gn[1])
    return split, n, (f" (the profiler dropped records in all {len(seen)} "
                      f"tries: {', '.join(f'{k:g}' for _, k in seen)} per "
                      f"call; the wrapper counts one call)")


def split_text(split) -> str:
    """"name ms (count×), ..." by falling time."""
    return ", ".join(f"{name} {ms:.4f} ({cnt:g}×)" for name, (ms, cnt)
                     in sorted(split.items(), key=lambda kv: -kv[1][0]))


def kernel_launch_split(fn, wrapper, what: str, launches: int, kernel: str,
                        desc: str, tries: int = 5):
    """One call of a wrapper whose launch plan says `launches` device
    launches, all of `kernel`: its device time by kernel name and its
    device launches (torch.profiler), held to the plan and to the
    launches the wrapper counts for one call.  The profiler has been seen
    to drop kernel records for several sessions running, so a profile
    that disagrees is taken again, up to `tries` times: the first that
    agrees is kept; if none does but every one saw only the kernel and
    fewer launches than the plan, that is reported beside the wrapper's
    count and the check stands; anything else fails.  → (split, launches
    per call)."""
    before = wrapper.launches
    fn()
    counted = wrapper.launches - before
    check(counted == launches, f"{what}: the wrapper counts {counted} "
          f"launches per call, the plan {launches}")
    seen = []
    for i in range(tries):
        retake(i)
        got = kernel_split(fn)
        if got is None:
            continue
        seen.append((got, sum(v[1] for v in got.values())))
        if set(got) == {kernel} and seen[-1][1] == launches:
            break
    if not seen:
        # the wrapper's count is held to the plan above; the time is taken
        # by CUDA events instead
        ms = cuda_ms(fn, 20)
        log(f"  {what}: the profiler saw no device time in {tries} tries "
            f"(split not measured); {ms:.4f} ms a call by CUDA events back "
            f"to back, {launches} launches as the wrapper counts, the plan "
            f"{launches} ({desc})")
        return {kernel: (ms, float(launches))}, launches
    split, n = max(seen, key=lambda gn: gn[1])
    short = ""
    if n != launches or set(split) != {kernel}:
        check(all(set(g) == {kernel} and k < launches for g, k in seen),
              f"{what}: device launches per call {[k for _, k in seen]} "
              f"({[g for g, _ in seen]}), the plan has {launches} of "
              f"{kernel}")
        short = (f" (the profiler dropped records in all {len(seen)} "
                 f"tries: {', '.join(f'{k:g}' for _, k in seen)} per call; "
                 f"the wrapper counts the plan's {launches})")
    log(f"  {what} by kernel (torch.profiler, ms per call): "
        f"{split_text(split)}; {n:g} device launches per call{short}, the "
        f"plan {launches} ({desc})")
    return split, n


def stage_split(fn, wrapper, what: str, plan, tries: int = 5):
    """One stage call of B2 or B9 held to `span_stage_plan`
    (`kernel_launch_split`: its launches, all of the stage kernel)."""
    from fastdet_torch.kernels.fused_infer import STAGE_KERNEL
    return kernel_launch_split(
        fn, wrapper, what, plan.launches, STAGE_KERNEL,
        f"{plan.variant}, cluster {plan.cluster}, {plan.rows} rows per CTA, "
        f"{plan.ctas} CTAs of {plan.threads} threads, {plan.smem_bytes} B "
        f"of shared memory each", tries)


def stage16_split(fn, wrapper, what: str, plan, tries: int = 5):
    """One bf16 stage call of B2 or B9 held to `span16_plan`
    (`kernel_launch_split`: its launches, all of the bf16 stage kernel)."""
    from fastdet_torch.kernels.fused_infer import SPAN16_KERNEL
    return kernel_launch_split(
        fn, wrapper, what, plan.launches, SPAN16_KERNEL,
        f"{plan.variant}, cluster {plan.cluster}, {plan.rows} rows per CTA"
        + (f" in chunks of {plan.orows} for the stride-2 block"
           if plan.orows else "")
        + f", {plan.ctas} CTAs of {plan.threads} threads, "
        f"{plan.smem_bytes} B of shared memory each", tries)


def stem_split(fn, wrapper, what: str, plan, tries: int = 5):
    """One call of B1, B6 or B10 held to `stem_plan`
    (`kernel_launch_split`: one launch of the stem kernel)."""
    return kernel_launch_split(
        fn, wrapper, what, plan.launches, plan.kernel,
        f"{plan.tiles} tiles of {plan.rows} × {plan.cols} cells over "
        f"{plan.grid[0]} CTAs of {plan.threads} threads, {plan.smem_bytes} "
        f"B of shared memory each", tries)


def check_stem_smem(lib, b, h4, w4, factor):
    """`stem_plan`'s shared memory against the kernel's own
    (`fastdet_stem_smem`, from `stem_smem_bytes`), and the CTAs an SM
    holds (the occupancy calculator) against the plan's persistent grid.
    → the plan."""
    from fastdet_torch.kernels import fused_infer as fi
    plan = fi.stem_plan(b, h4, w4, factor)
    got = lib.fastdet_stem_smem(plan.rows, plan.strips)
    check(got == plan.smem_bytes, f"stem kernel at {(b, h4, w4, factor)}: "
          f"{got} B of shared memory, the plan says {plan.smem_bytes}")
    occ = lib.fastdet_stem_ctas_per_sm(plan.rows, plan.strips)
    check(occ >= fi.STEM_CTAS_PER_SM, f"stem kernel at "
          f"{(b, h4, w4, factor)}: {occ} CTAs an SM, the plan's grid "
          f"assumes {fi.STEM_CTAS_PER_SM}")
    return plan


def check_stage_smem(lib, b, c, h, w, nblk, stride2):
    """`span_stage_plan`'s shared memory against the kernel's own
    (`fastdet_span_stage_smem`, from `stage_layout`) for each of the
    plan's kinds of launch.  → the plan."""
    from fastdet_torch.kernels import fused_infer as fi
    plan = fi.span_stage_plan(b, c, h, w, nblk, stride2)
    got = max(lib.fastdet_span_stage_smem(c // 2, rows, w, halo, int(s2))
              for rows, halo, s2 in plan.layouts)
    check(got == plan.smem_bytes, f"stage kernel at {(b, c, h, w)}: "
          f"{got} B of shared memory, the plan says {plan.smem_bytes}")
    return plan


def phase_fused_timing(sd, dev_pipe, fused_pipe, big, card):
    """b128 throughput of both pipelines (in turns), the fused forward's
    per-stage split, and each fused kernel on the inputs the b128 batch
    gives it, with cuDNN yardsticks.  → {kernel: (ms, plain_ms,
    bound_ms, bound_by, max |Δ|)}."""
    import torch
    import torch.nn.functional as F
    from fastdet_torch.kernels import fused_infer as fi
    from fastdet_torch.kernels.fold import STAGES
    from fastdet_torch.models import Detector
    host_big = big.cpu().numpy()
    big_s2d = torch.from_numpy(fi.pack_images_s2d(host_big)).cuda()
    runs = {"device": lambda: dev_pipe.detect(big),
            "fused": lambda: fused_pipe.detect(big_s2d)}
    dev_ms = {k: [] for k in runs}
    for k in ("device", "fused", "fused", "device"):
        dev_ms[k].append(cuda_ms(runs[k], 20))
    host_ms = {}
    for k, pipe in (("device", dev_pipe), ("fused", fused_pipe)):
        pipe(host_big)
        t0 = time.perf_counter()
        for _ in range(5):
            pipe(host_big)
        host_ms[k] = (time.perf_counter() - t0) / 5 * 1e3
    t0 = time.perf_counter()
    for _ in range(3):
        fi.pack_images_s2d(host_big)
    pack_ms = (time.perf_counter() - t0) / 3 * 1e3
    log(f"  host s2d packing of a b128 batch (numpy, in FusedPipeline's "
        f"host to host time): {pack_ms:.1f} ms")
    for k in runs:
        m = sum(dev_ms[k]) / 2
        log(f"  throughput b128 352² {k} ({card}): {128e3 / m:.1f} img/s "
            f"on the device ({m:.3f} ms per batch; calls "
            f"{', '.join(f'{x:.3f}' for x in dev_ms[k])} ms), "
            f"{128e3 / host_ms[k]:.1f} img/s host to host")

    inside = profile_device(lambda: fused_pipe.detect(big_s2d),
                            "fused b128 batches")
    if inside is not None:
        log("  the port's kernels inside a fused b128 batch (torch.profiler, "
            "ms per batch; alone: phases 4 and 4b): " + ", ".join(
                f"{name} {inside.get(name, 0.0):.4f}" for name in (
                    "stem_kernel", "span_stage_kernel",
                    "rank_decode_nms_kernel")))
    out = {}
    with torch.inference_mode():
        cum = {}
        for upto in ("stem", "s2", "s3", "s4", None):
            fwd, p = fi.build_fused_forward(sd, upto=upto)
            cum[upto] = cuda_ms(lambda: fwd(big_s2d, p), 20)
        split = ", ".join(
            f"{u or 'fpn+heads'} {cum[u] - cum[prev] if prev else cum[u]:.3f}"
            for prev, u in zip((None, "stem", "s2", "s3", "s4"),
                               ("stem", "s2", "s3", "s4", None)))
        log(f"  fused forward b128 per stage (CUDA events, upto=): {split} "
            f"ms; whole forward {cum[None]:.3f} ms")

        w, bias = p["stem_w"], p["stem_b"]
        x = fi.stem_s2d(big_s2d, w, bias, 88, 88)
        e = float((x - fi.stem_s2d_reference(big_s2d, w, bias, 88, 88))
                  .abs().max())
        check(e <= FUSED_ATOL, f"stem_s2d {e} off on the served batch")
        ms = cuda_ms(lambda: fi.stem_s2d(big_s2d, w, bias, 88, 88), 50)
        plain_ms = cuda_ms(
            lambda: fi.stem_s2d_reference(big_s2d, w, bias, 88, 88), 10, 2)
        out["stem_s2d"] = (ms, plain_ms, *stem_bound(128, 88, 88), e)
        stem_split(lambda: fi.stem_s2d(big_s2d, w, bias, 88, 88),
                   fi.stem_s2d, "stem_s2d b128 352²",
                   fi.stem_plan(128, 88, 88, 4))
        det = Detector(80, 3)
        det.load_state_dict(sd)
        det = det.cuda().eval()
        xf = big.permute(0, 3, 1, 2).float() / 255.0
        yard = cuda_ms(lambda: F.max_pool2d(det.backbone.first_conv(xf), 3,
                                            2, 1), 20)
        log(f"  stem_s2d on the served b128 batch: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {out['stem_s2d'][2]:.4f} ms "
            f"({out['stem_s2d'][3]}), max |Δ| {e:.3g}; yardstick: cuDNN "
            f"conv+BN+ReLU + max_pool2d of Detector from f32 NCHW "
            f"{yard:.4f} ms")

        stages = []                  # (ms, plain_ms, bound_ms, by, max |Δ|)
        for sid, reps, c in STAGES:
            xin = fi._s2_block(x, p, f"s{sid}_0")
            wts = p[f"s{sid}_span"]
            x = fi.span(xin, wts, reps - 1)
            e = float((x - fi.span_reference(xin, wts, reps - 1))
                      .abs().max())
            check(e <= FUSED_ATOL, f"span {e} off on the served batch")
            ms = cuda_ms(lambda: fi.span(xin, wts, reps - 1), 50)
            plain_ms = cuda_ms(
                lambda: fi.span_reference(xin, wts, reps - 1), 10, 2)
            b_ms, b_by = span_bound(128, c, xin.shape[2], xin.shape[3],
                                    reps - 1)
            blocks = [getattr(det.backbone, f"stage{sid}_{i}")
                      for i in range(1, reps)]

            def cudnn_span(a=xin, blocks=blocks):
                for blk in blocks:
                    a = blk(a)
                return a

            yard = cuda_ms(cudnn_span, 20)
            stage_split(lambda: fi.span(xin, wts, reps - 1), fi.span,
                        f"span stage {sid}",
                        fi.span_stage_plan(128, c, xin.shape[2],
                                           xin.shape[3], reps - 1))
            log(f"  span stage {sid} on the served b128 batch (C={c}, "
                f"{xin.shape[2]}², nblk={reps - 1}): kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                f"max |Δ| {e:.3g}; yardstick: the Detector's cuDNN blocks "
                f"{yard:.4f} ms")
            stages.append((ms, plain_ms, b_ms, b_by, e))
        # the span work of one batch: the three calls' sums; bound_by of
        # the call with the largest bound
        ms, plain_ms, b_ms = (sum(st[i] for st in stages) for i in range(3))
        out["span"] = (ms, plain_ms, b_ms,
                       max(stages, key=lambda st: st[2])[3],
                       max(st[4] for st in stages))
        log(f"  span, the three stage calls of one b128 batch: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms")
    return out


# ------------------------------- the flag paths (B10, B9; phases 2d, 4c)

# the five combinations of the fused forward beside the default
# ("s2d_u8", fuse_s2=False), each (input_format, fuse_s2)
FLAG_COMBOS = (("nhwc", False), ("nhwc", True), ("s2d_u8", True),
               ("s2d8_u8", False), ("s2d8_u8", True))


def stem8_bound(b, h8, w8):
    """stem_s2d8: the image's uint8 pixels read once, its 672 weights, the
    pooled f32 map written once; 2 operations per conv MAC (27 per conv
    output, 16 conv outputs per coarse cell and channel): the s2d(4)
    stem's work at h4 = 2·h8, w4 = 2·w8, counted as `stem_bound` does."""
    nbytes = b * 192 * h8 * w8 + 672 * 4 + b * 24 * 4 * h8 * w8 * 4
    return bound(nbytes, b * 16 * h8 * w8 * 24 * 27 * 2 * 2,
                 PEAK_F16_TC_OPS_S)


def s2span_bound(b, cin, hin, win, nblk):
    """s2span: the stage input read once, the stage output written once,
    the weights once; 2 operations per MAC: pw1 (cin·mid) on every input
    pixel, per output pixel the two depthwise convs (9·mid, 9·cin), pw2
    (mid²) and the projection's pointwise (cin·mid), then nblk span blocks
    ((C/2)²·2 + 9·C/2 each); mid = cin at every stage."""
    from fastdet_torch.kernels.fused_infer import s2span_floats
    m = cin
    h, w = (hin + 1) // 2, (win + 1) // 2
    nbytes = 4 * (b * cin * hin * win + b * 2 * m * h * w
                  + s2span_floats(cin, nblk))
    macs = (b * hin * win * cin * m
            + b * h * w * (9 * m + m * m + 9 * cin + cin * m)
            + nblk * b * h * w * (2 * m * m + 9 * m))
    return bound(nbytes, 2 * macs)


def phase_flag_kernels(sd):
    """B10 and B9 against their plain versions on the card at the shapes of
    tests/torch_cases.py (STEM8_CASES, S2SPAN_CASES: b1 and b128 352², pad
    lanes, tiles cut off at the edge), with the folded weights of the
    fused forward.  → max |Δ| of each."""
    import torch
    from fastdet_torch.kernels import _build
    from fastdet_torch.kernels import fused_infer as fi
    from fastdet_torch.kernels.fold import STAGES
    from torch_cases import (S2SPAN_CASES, STEM8_CASES, s2span_case,
                             stem8_case)
    _, p = fi.build_fused_forward(sd)
    w, bias = p["stem_w"], p["stem_b"]
    err = {"stem_s2d8": 0.0, "s2span": 0.0}
    stem_lib = _build.load("stem_s2d8", fi._STEM8_SIGNATURES)
    for bsz, ih, iw in STEM8_CASES:
        h8, w8 = ih // 8, iw // 8
        check_stem_smem(stem_lib, bsz, 2 * h8, 2 * w8, 8)
        x = stem8_case(bsz + ih, bsz, ih, iw, "cuda")
        e = float((fi.stem_s2d8(x, w, bias, h8, w8)
                   - fi.stem_s2d8_reference(x, w, bias, h8, w8)).abs().max())
        check(e <= FUSED_ATOL, f"stem_s2d8 {e} off at b={bsz} {ih}x{iw}")
        err["stem_s2d8"] = max(err["stem_s2d8"], e)
        log(f"  stem_s2d8 b={bsz} {ih}x{iw} (h8={h8}, w8={w8}, npad="
            f"{x.shape[2]}): max |Δ| {e:.3g}")
    reps = {sid: r for sid, r, _ in STAGES}
    lib = _build.load("s2span", fi._S2SPAN_SIGNATURES)
    for bsz, stage, hin, win in S2SPAN_CASES:
        cin, nblk = {2: 24, 3: 48, 4: 96}[stage], reps[stage] - 1
        plan = check_stage_smem(lib, bsz, 2 * cin, (hin + 1) // 2,
                                (win + 1) // 2, nblk, True)
        x = s2span_case(stage * 1000 + hin, bsz, cin, hin, win, "cuda")
        wts = p[f"s{stage}_s2span"]
        e = float((fi.s2span(x, wts, nblk)
                   - fi.s2span_reference(x, wts, nblk)).abs().max())
        check(e <= FUSED_ATOL, f"s2span {e} off at b={bsz} stage {stage} "
              f"{hin}x{win}")
        err["s2span"] = max(err["s2span"], e)
        log(f"  s2span b={bsz} stage {stage} {hin}x{win} → "
            f"{(hin + 1) // 2}x{(win + 1) // 2} nblk={nblk} ({plan.variant},"
            f" cluster {plan.cluster}, {plan.launches} launch): max |Δ| "
            f"{e:.3g}")
    torch.cuda.synchronize()
    log(f"phase 2d flag kernels: stem_s2d8 ({len(STEM8_CASES)} shapes) and "
        f"s2span ({len(S2SPAN_CASES)}) within {FUSED_ATOL:g} of their plain "
        f"versions; the stem and stage plans' shared memory the kernels'; "
        f"max |Δ| "
        f"stem_s2d8 {err['stem_s2d8']:.3g}, s2span {err['s2span']:.3g}")
    return err


def cuda_median_ms(fn, calls: int = 15, warmup: int = 3) -> float:
    """Median device time of one fn() call over `calls` calls, each timed
    by its own pair of CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(calls)]
    for a, b in pairs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def phase_flag_paths(sd, photo, fused_pipe, card):
    """The five new combinations of `build_fused_forward` at b128 352² f32
    on photo variants: each forward against Detector on the card (TF32
    off), each through `postprocess` (conf 0.3, window 128) against
    FusedPipeline's detections on the same batch (counts to 0 just before
    the five, read just after); the per-stage split of all six
    combinations (`upto=`, medians of CUDA-event calls); B9 per stage
    against the stride-2 block + B2 it replaces, B10 against B1 on the
    same images.  → (launches, {kernel: (ms, plain_ms, bound_ms, by,
    max |Δ|)})."""
    import torch
    import torch.nn.functional as F
    from fastdet_torch import disable_tf32
    from fastdet_torch.config import Config
    from fastdet_torch.kernels import fused_infer as fi
    from fastdet_torch.kernels import pp_fused
    from fastdet_torch.kernels.fold import STAGES
    from fastdet_torch.models import Detector
    from fastdet_torch.ops.postprocess import postprocess
    disable_tf32(torch.device("cuda"))
    cfg = Config.from_file(DATA)
    anchors = np.asarray(cfg.anchors, np.float32).reshape(2, 3, 2)
    host = photo_variants(photo, 128, seed=44)
    inputs = {"nhwc": torch.from_numpy(host).cuda(),
              "s2d_u8": torch.from_numpy(fi.pack_images_s2d(host)).cuda(),
              "s2d8_u8": torch.from_numpy(fi.pack_images_s2d8(host)).cuda()}
    det = Detector(80, 3)
    det.load_state_dict(sd)
    det = det.cuda().eval()
    fwds = {c: fi.build_fused_forward(sd, input_format=c[0], fuse_s2=c[1])
            for c in FLAG_COMBOS}
    kernels = [fi.stem_s2d, fi.stem_s2d8, fi.span, fi.s2span,
               pp_fused.rank_decode_nms]

    def rows(dets):
        d, n = (t.cpu().numpy() for t in dets)
        return [d[i, :n[i]] for i in range(len(n))]

    with torch.inference_mode():
        want = det(inputs["nhwc"].float() / 255.0)
        ref = rows(fused_pipe.detect(inputs["s2d_u8"]))
        torch.cuda.synchronize()
        # ---- the main path: counts to 0, the five combinations, read
        for k in kernels:
            k.launches = 0
        outs, dets = {}, {}
        for c, (fwd, p) in fwds.items():
            outs[c] = fwd(inputs[c[0]], p)
            dets[c] = postprocess(outs[c], anchors, (352, 352),
                                  conf_thres=0.3, iou_thres=0.45,
                                  max_det=300, max_nms=128)
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in kernels}
    for name in ("stem_s2d8", "s2span"):
        check(launches[name] > 0, f"the flag paths launched no {name}")
    n_det = sum(len(a) for a in ref)
    check(n_det > 0, "no detections on the flag paths' batch")
    for c in FLAG_COMBOS:
        got = outs[c]
        check(all(bool(torch.isfinite(g).all()) for g in got),
              f"non-finite forward {c}")
        check([g.shape for g in got] == [w.shape for w in want],
              f"forward {c} shapes differ from Detector's")
        e = max(float((g - w).abs().max()) for g, w in zip(got, want))
        check(e <= FUSED_ATOL, f"forward {c} {e} off Detector's")
        for i, (a, b) in enumerate(zip(rows(dets[c]), ref)):
            check(a.shape == b.shape and np.array_equal(a[:, 5], b[:, 5])
                  and np.abs(a[:, 4] - b[:, 4]).max(initial=0) <= 1e-4
                  and np.abs(a[:, :4] - b[:, :4]).max(initial=0) <= 1e-2,
                  f"{c} detections of image {i} differ from FusedPipeline's")
        log(f"  {c[0]} fuse_s2={c[1]}: forward vs Detector max |Δ| {e:.3g}; "
            f"detections equal to FusedPipeline's")
    log(f"phase 4c flag paths: 5 combinations at b128 352² on photo "
        f"variants, each within {FUSED_ATOL:g} of Detector, {n_det} "
        f"detections each, equal to FusedPipeline's (classes; scores ≤ "
        f"1e-4, boxes ≤ 1e-2 px); launches {launches}")

    out = {}
    with torch.inference_mode():
        for c in (("s2d_u8", False),) + FLAG_COMBOS:
            cum = {}
            for upto in ("stem", "s2", "s3", "s4", None):
                fwd, p = fi.build_fused_forward(sd, input_format=c[0],
                                                fuse_s2=c[1], upto=upto)
                cum[upto] = cuda_median_ms(lambda: fwd(inputs[c[0]], p))
            split = ", ".join(
                f"{u or 'fpn+heads'} "
                f"{cum[u] - cum[prev] if prev else cum[u]:.3f}"
                for prev, u in zip((None, "stem", "s2", "s3", "s4"),
                                   ("stem", "s2", "s3", "s4", None)))
            log(f"  per stage b128 {c[0]} fuse_s2={c[1]} (median of 15 "
                f"calls, CUDA events, upto=): {split} ms; whole forward "
                f"{cum[None]:.3f} ms ({card})")

        _, p = fwds[("s2d8_u8", True)]
        w, bias = p["stem_w"], p["stem_b"]
        x4, x8 = inputs["s2d_u8"], inputs["s2d8_u8"]
        a = fi.stem_s2d8(x8, w, bias, 44, 44)
        e = float((a - fi.stem_s2d8_reference(x8, w, bias, 44, 44))
                  .abs().max())
        check(e <= FUSED_ATOL, f"stem_s2d8 {e} off on the b128 batch")
        e1 = float((a - fi.stem_s2d(x4, w, bias, 88, 88)).abs().max())
        check(e1 <= FUSED_ATOL, f"stem_s2d8 {e1} off stem_s2d")
        t = {"b10": lambda: fi.stem_s2d8(x8, w, bias, 44, 44),
             "b1": lambda: fi.stem_s2d(x4, w, bias, 88, 88)}
        ms = {k: [] for k in t}
        for k in ("b10", "b1", "b1", "b10"):
            ms[k].append(cuda_ms(t[k], 50))
        plain_ms = cuda_ms(
            lambda: fi.stem_s2d8_reference(x8, w, bias, 44, 44), 10, 2)
        xf = inputs["nhwc"].permute(0, 3, 1, 2).float() / 255.0
        yard = cuda_ms(lambda: F.max_pool2d(det.backbone.first_conv(xf), 3,
                                            2, 1), 20)
        b10_ms = sum(ms["b10"]) / 2
        out["stem_s2d8"] = (b10_ms, plain_ms, *stem8_bound(128, 44, 44), e)
        stem_split(t["b10"], fi.stem_s2d8, "stem_s2d8 b128 352²",
                   fi.stem_plan(128, 88, 88, 8))
        log(f"  stem_s2d8 on the b128 batch: kernel {b10_ms:.4f} ms (calls "
            f"{', '.join(f'{v:.4f}' for v in ms['b10'])}), B1 on the same "
            f"images {sum(ms['b1']) / 2:.4f} ms (calls "
            f"{', '.join(f'{v:.4f}' for v in ms['b1'])}), plain "
            f"{plain_ms:.4f} ms, bound {out['stem_s2d8'][2]:.4f} ms "
            f"({out['stem_s2d8'][3]}), max |Δ| {e:.3g} (to B1's output "
            f"{e1:.3g}); cuDNN conv+BN+ReLU + max_pool2d from f32 NCHW "
            f"{yard:.4f} ms")

        stages = []            # (ms, plain_ms, bound_ms, by, max |Δ|)
        x = fi.stem_s2d(x4, w, bias, 88, 88)
        for sid, reps, c in STAGES:
            xin, wts = x, p[f"s{sid}_s2span"]
            x = fi.s2span(xin, wts, reps - 1)
            e = float((x - fi.s2span_reference(xin, wts, reps - 1))
                      .abs().max())
            check(e <= FUSED_ATOL, f"s2span {e} off on the b128 batch")
            t = {"b9": lambda: fi.s2span(xin, wts, reps - 1),
                 "old": lambda: fi.span(fi._s2_block(xin, p, f"s{sid}_0"),
                                        p[f"s{sid}_span"], reps - 1)}
            ms = {k: [] for k in t}
            for k in ("b9", "old", "old", "b9"):
                ms[k].append(cuda_ms(t[k], 30))
            plain_ms = cuda_ms(
                lambda: fi.s2span_reference(xin, wts, reps - 1), 10, 2)
            b_ms, b_by = s2span_bound(128, c // 2, xin.shape[2],
                                      xin.shape[3], reps - 1)
            b9_ms = sum(ms["b9"]) / 2
            stage_split(lambda: fi.s2span(xin, wts, reps - 1), fi.s2span,
                        f"s2span stage {sid}",
                        fi.span_stage_plan(128, c, x.shape[2], x.shape[3],
                                           reps - 1, True))
            log(f"  s2span stage {sid} on the b128 batch ({c // 2}→{c}, "
                f"{xin.shape[2]}²→{x.shape[2]}², nblk={reps - 1}): kernel "
                f"{b9_ms:.4f} ms (calls "
                f"{', '.join(f'{v:.4f}' for v in ms['b9'])}), cuDNN "
                f"stride-2 block + B2 {sum(ms['old']) / 2:.4f} ms (calls "
                f"{', '.join(f'{v:.4f}' for v in ms['old'])}), plain "
                f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), max |Δ| "
                f"{e:.3g}")
            stages.append((b9_ms, plain_ms, b_ms, b_by, e))
        ms, plain_ms, b_ms = (sum(st[i] for st in stages) for i in range(3))
        out["s2span"] = (ms, plain_ms, b_ms,
                         max(stages, key=lambda st: st[2])[3],
                         max(st[4] for st in stages))
        log(f"  s2span, the three stage calls of one b128 batch: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms")
    return launches, out


# ------------------------------------------------ the staged NMS (B4, B5)

NMS_IOU = 0.4       # the eval passes' NMS threshold


def nms_keep_bound(valid, k):
    """keep_mask_batch: its inputs read once (boxes 16 B, class 8 B,
    validity 1 B per candidate) and keep (1 B) written once; 14 f32
    operations per IoU of a pair j < i of valid candidates (the pairs the
    greedy scan may have to test).  The overlap bitmask is the kernel's
    workspace and not part of the function."""
    v = valid.sum(dim=1).double()
    pairs = float((v * (v - 1) / 2).sum())
    return bound(valid.shape[0] * k * (16 + 8 + 1 + 1), pairs * 14)


def nms_split(fn, b, k):
    """One keep_mask_batch call's device time by kernel name and its
    device launches (torch.profiler), held to `nms_keep_plan`'s kernel
    names and launches."""
    from fastdet_torch.kernels import nms_kernel as nk
    plan = nk.nms_keep_plan(b, k)
    split, n = planned_split(fn, plan.launches)
    if split is None:
        log(f"  nms_keep b={b} k={k}: the profiler saw no device time "
            f"(split not measured)")
        return None, None
    check(n == plan.launches and set(split) == set(plan.kernels),
          f"nms_keep b={b} k={k}: device launches {n} of {split}, the plan "
          f"{plan.launches} of {plan.kernels}")
    log(f"  nms_keep b={b} k={k} by kernel (torch.profiler, ms per call): "
        f"{split_text(split)}; {n:g} device launches per call, the plan "
        f"{plan.launches} ({plan.variant}, {plan.threads} threads, "
        f"{plan.smem_bytes} B of shared memory a CTA, rows on chip to n_v "
        f"{plan.nv_cap}, workspace {plan.workspace_bytes} B)")
    return split, n


def nms_variant_ms(boxes, cls, valid, want, what):
    """Both variants of `nms_keep` on one input, each held bitwise to the
    plain version's keep `want`, then timed: CUDA events over calls back
    to back and the device time a call (torch.profiler).  Launched through
    the wrapper's private launcher with the variant's plan (not counted as
    the main path's).  → {variant: (back-to-back ms, device ms or None
    where the profiler saw no device time)}."""
    import torch
    from fastdet_torch.kernels import nms_kernel as nk
    b, k = valid.shape
    times = {}
    for variant in nk.NMS_VARIANTS:
        plan = nk._variant_plan(variant, b, k)

        def fn(plan=plan):
            return nk._launch(boxes, cls, valid, NMS_IOU, plan)
        keep = fn()
        torch.cuda.synchronize()
        check(torch.equal(keep, want),
              f"nms_keep {variant} differs on {what} b={b} k={k}")
        split, _ = planned_split(fn, plan.launches)
        times[variant] = (cuda_ms(fn, 20), None if split is None else
                          sum(ms for ms, _ in split.values()))
    return times


def variant_text(times, chosen) -> str:
    """"cta X ms (device Y), grid X ms (device Y); the plan: cta"."""
    return (", ".join(f"{v} {ms:.4f} ms (device "
                      + ("not measured)" if dev is None else f"{dev:.4f})")
                      for v, (ms, dev) in times.items())
            + f"; the plan: {chosen}")


def check_nms_plan(b, k):
    """`nms_keep_plan`'s shared memory and workspace against the kernel's
    own (`fastdet_nms_keep_smem`, `fastdet_nms_keep_workspace`), for both
    variants.  → the plan."""
    from fastdet_torch.kernels import _build
    from fastdet_torch.kernels import nms_kernel as nk
    lib = _build.load("nms_keep", nk._SIGNATURES)
    for v, variant in enumerate(nk.NMS_VARIANTS):
        plan = nk._variant_plan(variant, b, k)
        got = (lib.fastdet_nms_keep_smem(v, k),
               lib.fastdet_nms_keep_workspace(v, b, k))
        check(got == (plan.smem_bytes, plan.workspace_bytes),
              f"nms_keep {variant} at b={b} k={k}: the kernel's shared "
              f"memory and workspace {got}, the plan's "
              f"{(plan.smem_bytes, plan.workspace_bytes)}")
    return nk.nms_keep_plan(b, k)


def phase_nms_keep():
    """nms_keep against its plain version, bitwise, on seeded crowded
    fields at k ∈ {385, 512, 1024, 1815, 2048} × B ∈ {1, 8, 32, 64, 128};
    then suppress_ranked_batch's (dets, counts) against the plain chain
    (`ops.nms.suppress_ranked`); both variants of the kernel held and
    timed at each class.  → max |Δ| (0 when bitwise)."""
    import torch
    from torch_cases import crowded
    from fastdet_torch.kernels import nms_kernel as nk
    from fastdet_torch.ops import nms
    err = 0.0
    for k in (385, 512, 1024, 1815, 2048):
        for b in (1, 8, 32, 64, 128):
            boxes, score, cls, valid = (torch.from_numpy(a).cuda()
                                        for a in crowded(k + b, b, k))
            keep = nk.keep_mask_batch(boxes, cls, valid, iou_thres=NMS_IOU)
            want = nk.keep_mask_batch_reference(boxes, cls, valid,
                                                iou_thres=NMS_IOU)
            det, n = nk.suppress_ranked_batch(boxes, score, cls, valid,
                                              iou_thres=NMS_IOU, max_det=300)
            wdet, wn = nms.suppress_ranked(boxes, score, cls, valid,
                                           iou_thres=NMS_IOU, max_det=300)
            torch.cuda.synchronize()
            n_keep, n_valid = int(keep.sum()), int(valid.sum())
            check(torch.equal(keep, want), f"nms_keep differs at b={b} k={k}")
            check(torch.equal(n, wn) and torch.equal(det, wdet),
                  f"suppress_ranked_batch differs at b={b} k={k}")
            check(0 < n_keep < n_valid,
                  f"trivial case b={b} k={k}: {n_keep}/{n_valid}")
            err = max(err, float((keep.float() - want.float()).abs().max()),
                      float((det - wdet).abs().max()))
            plan = check_nms_plan(b, k)
            ms = cuda_ms(lambda: nk.keep_mask_batch(
                boxes, cls, valid, iou_thres=NMS_IOU), 20)
            times = nms_variant_ms(boxes, cls, valid, want, "crowded")
            log(f"  nms_keep b={b} k={k}: keep and (dets, counts) equal "
                f"({n_keep}/{n_valid} kept), kernel {ms:.4f} ms (CUDA "
                f"events back to back); both variants bitwise, "
                f"{variant_text(times, plan.variant)}")
    log("phase 2c nms_keep: keep bitwise against its plain version in both "
        "variants and suppress_ranked_batch equal to the plain chain at 25 "
        "shape classes (k 385-2048, B 1-128); the plan's shared memory and "
        "workspace the kernel's")
    return err


# ------------------------------------------------ the eval path (phase 7)

def eval_labels(dets, seed):
    """Seeded labels from detections: each box moved ±4 px, one in five
    dropped, one spurious box per image, of a class the image's
    detections have (a class no detection has would add a class of AP 0
    to the mean).  → (labels (B,M,5) normalized [cls,cx,cy,w,h], mask
    (B,M))."""
    rng = np.random.default_rng(seed)
    per = []
    for d in dets:
        rows = []
        for x1, y1, x2, y2, _, c in d:
            if rng.random() < 0.2:
                continue
            x1, y1, x2, y2 = np.asarray([x1, y1, x2, y2]) \
                + rng.uniform(-4, 4, 4)
            rows.append((c, (x1 + x2) / 704, (y1 + y2) / 704,
                         (x2 - x1) / 352, (y2 - y1) / 352))
        cx, cy = rng.uniform(0.2, 0.8, 2)
        rows.append((rng.choice(d[:, 5]) if len(d) else 0, cx, cy, 0.1, 0.1))
        per.append(np.asarray(rows, np.float32))
    m = max(len(r) for r in per)
    labels = np.zeros((len(per), m, 5), np.float32)
    mask = np.zeros((len(per), m), bool)
    for i, r in enumerate(per):
        labels[i, :len(r)], mask[i, :len(r)] = r, True
    return labels, mask


def plain_eval(forward, images, labels, mask, bsz):
    """Both eval passes through the plain staged chain on the card, on the
    outputs of `forward` (chunks of 32 images bound the plain keep mask's
    (B,k,k) temporaries).  → (mAP pass, P/R pass)."""
    import torch
    from torch_cases import ANCHORS, staged_reference
    from fastdet_torch.cli.evaluation import MAP_PASS, PR_PASS
    from fastdet_torch.eval.runner import evaluate
    results = []
    for kw in (MAP_PASS, PR_PASS):
        table = []
        for s in range(0, len(images), bsz):
            with torch.inference_mode():
                outs = forward(images[s:s + bsz])
                parts = [staged_reference([o[c:c + 32] for o in outs],
                                          ANCHORS, (352, 352), **kw)
                         for c in range(0, outs[0].shape[0], 32)]
            table.append((torch.cat([p[0] for p in parts]),
                          torch.cat([p[1] for p in parts])))
        batches = [(images[s:s + bsz], labels[s:s + bsz], mask[s:s + bsz])
                   for s in range(0, len(images), bsz)]
        it = iter(table)
        results.append(evaluate(lambda _images: next(it), batches,
                                (352, 352)))
    return results


def phase_eval(sd, photo, dev_pipe, card):
    """The eval entry point on the card: `run_evaluation` (both passes, the
    default and the --fused mode) over 256 seeded photo variants in b128
    batches, with seeded labels from DevicePipeline's detections.  Each
    mode's launch counts are set to 0 just before its run and read just
    after; P/R/AP/F1 must equal the plain staged chain's on the same
    forward outputs.  Then nms_keep timed at b128 on the eval batch's
    windows, k = 512 (B4's shape), 1024 (the P/R pass's) and 1815 (B5's),
    and both variants on their first b images.  → (launches,
    {window: (ms, plain_ms, bound_ms, bound_by, max |Δ|)}, the eval
    images)."""
    import torch
    from torch_cases import ANCHORS, staged_window
    from fastdet_torch.cli.evaluation import (MAP_PASS, PR_PASS,
                                              run_evaluation)
    from fastdet_torch.config import Config
    from fastdet_torch.eval.runner import evaluate
    from fastdet_torch.kernels import fused_infer as fi
    from fastdet_torch.kernels import nms_kernel as nk
    from fastdet_torch.kernels import pp_fused
    from fastdet_torch.models import Detector
    from fastdet_torch.ops.postprocess import postprocess
    cfg = Config.from_file(DATA)
    images = photo_variants(photo, 256, seed=7)
    labels, mask = eval_labels(dev_pipe(images), seed=7)
    bsz = 128

    def batches(bs):
        for s in range(0, len(images), bs):
            yield images[s:s + bs], labels[s:s + bs], mask[s:s + bs]

    det = Detector(80, 3)
    det.load_state_dict(sd)
    det = det.cuda().eval()
    fwd, packed = fi.build_fused_forward(sd)
    forwards = {
        "default": lambda x: det(torch.from_numpy(x).cuda().to(
            torch.float32) / 255.0),
        "fused": lambda x: fwd(torch.from_numpy(
            fi.pack_images_s2d(x)).cuda(), packed)}
    kernels = [nk.keep_mask_batch, pp_fused.rank_decode_nms, fi.stem_s2d,
               fi.span]
    launches = 0
    n_batches = -(-len(images) // bsz)
    for mode in ("default", "fused"):
        run_evaluation(cfg, sd, batches, fused=mode == "fused",
                       device="cuda", batch=bsz)            # warm-up
        torch.cuda.synchronize()
        # ---- the main path: counts to 0, evaluate, read the counts
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        res_map, res_pr = run_evaluation(cfg, sd, batches,
                                         fused=mode == "fused",
                                         device="cuda", batch=bsz)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {k.__name__: k.launches for k in kernels}
        check(counts["keep_mask_batch"] == 2 * n_batches,
              f"{mode}: nms_keep launches {counts} over two passes of "
              f"{n_batches} batches")
        check(counts["rank_decode_nms"] == 0,
              f"{mode}: an eval window went through rank_decode_nms")
        if mode == "fused":
            check(counts["stem_s2d"] > 0 and counts["span"] > 0,
                  f"fused eval launched no stem or span: {counts}")
        launches += counts["keep_mask_batch"]
        check(res_map is not None and res_pr is not None,
              f"{mode}: no detections")
        vals = (res_pr[0], res_pr[1], res_map[2], res_pr[3])
        check(all(np.isfinite(v) and 0 < v < 1 for v in vals),
              f"{mode}: P/R/AP/F1 {vals}")
        plain_map, plain_pr = plain_eval(forwards[mode], images, labels,
                                         mask, bsz)
        check(plain_map == res_map and plain_pr == res_pr,
              f"{mode}: metrics {res_map} {res_pr} differ from the plain "
              f"staged chain's {plain_map} {plain_pr}")
        log(f"phase 7 eval {mode}: Precision:{vals[0]:f} Recall:{vals[1]:f} "
            f"AP:{vals[2]:f} F1:{vals[3]:f} over {len(images)} images "
            f"(b{bsz}), equal to the plain staged chain on the card; "
            f"{2 * len(images) / secs:.1f} img/s over both passes "
            f"({secs:.3f} s, host clock, {card}); launches {counts}")

    # where a b128 eval batch's time goes
    with torch.inference_mode():
        x = torch.from_numpy(images[:bsz]).cuda()
        outs = det(x.to(torch.float32) / 255.0)
        fwd_ms = cuda_ms(lambda: det(x.to(torch.float32) / 255.0), 20)
        xs = torch.from_numpy(fi.pack_images_s2d(images[:bsz])).cuda()
        fused_ms = cuda_ms(lambda: fwd(xs, packed), 20)
        post_ms = [cuda_ms(lambda kw=kw: postprocess(
            outs, ANCHORS, (352, 352), **kw), 20) for kw in (MAP_PASS,
                                                               PR_PASS)]
        post_dev = [device_busy_ms(lambda kw=kw: postprocess(
            outs, ANCHORS, (352, 352), **kw)) for kw in (MAP_PASS,
                                                           PR_PASS)]
        post_host = [host_ms(lambda kw=kw: postprocess(
            outs, ANCHORS, (352, 352), **kw), 20) for kw in (MAP_PASS,
                                                               PR_PASS)]
        dets = postprocess(outs, ANCHORS, (352, 352), **MAP_PASS)
    t0 = time.perf_counter()
    evaluate(lambda _images: dets, [(images[:bsz], labels[:bsz],
                                     mask[:bsz])], (352, 352))
    metrics_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    torch.from_numpy(images[:bsz]).cuda()
    torch.cuda.synchronize()
    upload_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    fi.pack_images_s2d(images[:bsz])
    pack_ms = (time.perf_counter() - t0) * 1e3
    log(f"  eval b128 split ({card}): on the device (CUDA events) forward "
        f"{fwd_ms:.3f} ms (fused forward {fused_ms:.3f} ms), postprocess "
        f"{post_ms[0]:.3f} ms in the mAP pass (k=1815), {post_ms[1]:.3f} ms "
        f"in the P/R pass (k=1024) called back to back, the device busy "
        f"{ms_text(post_dev[0])} and {ms_text(post_dev[1])} ms of them (its kernels' "
        f"time, torch.profiler), the host's enqueue {post_host[0]:.3f} and "
        f"{post_host[1]:.3f} ms a call (host clock); on the host the "
        f"metrics of "
        f"the mAP pass {metrics_ms:.1f} ms, the upload {upload_ms:.1f} ms, "
        f"the s2d packing (--fused) {pack_ms:.1f} ms")

    out = {}
    with torch.inference_mode():
        # B4's shape (k = 512), the P/R pass's window and the mAP pass's
        for k, conf in ((512, 0.01), (1024, PR_PASS["conf_thres"]),
                        (1815, 0.01)):
            boxes, score, cls = staged_window(outs, ANCHORS, (352, 352),
                                              conf_thres=conf, max_nms=k)
            valid = score > 0
            keep = nk.keep_mask_batch(boxes, cls, valid, iou_thres=NMS_IOU)
            want = nk.keep_mask_batch_reference(boxes, cls, valid,
                                                iou_thres=NMS_IOU)
            torch.cuda.synchronize()
            check(torch.equal(keep, want), f"nms_keep differs at b128 k={k}")
            e = float((keep.float() - want.float()).abs().max())
            check_nms_plan(bsz, k)

            def fn():
                return nk.keep_mask_batch(boxes, cls, valid,
                                          iou_thres=NMS_IOU)
            ms = cuda_ms(fn, 50, 5)
            plain_ms = cuda_ms(lambda: nk.keep_mask_batch_reference(
                boxes, cls, valid, iou_thres=NMS_IOU), 2, 1)
            b_ms, b_by = nms_keep_bound(valid, k)
            out[k] = (ms, plain_ms, b_ms, b_by, e)
            split, _ = nms_split(fn, bsz, k)
            log(f"  nms_keep on the eval batch (B=128, k={k}, conf {conf}, "
                f"{int(valid.sum())} valid, at most {int(valid.sum(1).max())}"
                f" and {int(keep.sum(1).max())} kept in an image, "
                f"{int(keep.sum())} kept): kernel {ms:.4f} ms (CUDA events "
                f"back to back), "
                + ("not measured" if split is None else
                   f"{sum(v[0] for v in split.values()):.4f} ms")
                + f" of it on the device (torch.profiler), plain "
                f"{plain_ms:.3f} ms, bound {b_ms:.6f} ms ({b_by}), keep "
                f"equal ({card})")
            # both variants on the first b images of the window: the
            # traffic the plan's choice by (B, k) is set from
            for b in (8, 32, 64, 128):
                times = nms_variant_ms(boxes[:b], cls[:b], valid[:b],
                                       want[:b], "the eval window")
                log(f"  nms_keep variants, eval window k={k} b={b} "
                    f"(n_v {float(valid[:b].sum(1).float().mean()):.1f} on "
                    f"average, {int(valid[:b].sum(1).max())} at most): "
                    f"{variant_text(times, nk.nms_keep_plan(b, k).variant)}")
    return launches, out, images


def phase_640(sd, photo, card):
    """640²: B1 (B ∈ {1, 32}) and B2 at 80²/40²/20² against their plain
    versions, then FusedPipeline at 640² (counts to 0 just before, read
    just after) against DevicePipeline at 640² on 8 photo variants.
    → (launches of stem_s2d, (ms, plain_ms, bound_ms, bound_by, max |Δ|)
    of B1 at b32 640²)."""
    import dataclasses
    import torch
    from fastdet_torch.config import Config
    from fastdet_torch.kernels import fused_infer as fi
    from fastdet_torch.kernels import pp_fused
    from fastdet_torch.kernels.fold import STAGES
    from fastdet_torch.models import Detector
    from fastdet_torch.serve import DevicePipeline, FusedPipeline
    _, p = fi.build_fused_forward(sd, input_hw=(640, 640))
    w, bias = p["stem_w"], p["stem_b"]
    err = 0.0
    for bsz in (1, 32):
        rng = np.random.default_rng(640 + bsz)
        imgs = rng.integers(0, 256, (bsz, 640, 640, 3), dtype=np.uint8)
        xs = fi.pack_images_s2d(imgs)
        x = torch.from_numpy(xs).cuda()
        e = float((fi.stem_s2d(x, w, bias, 160, 160)
                   - fi.stem_s2d_reference(x, w, bias, 160, 160)).abs().max())
        check(e <= FUSED_ATOL, f"stem_s2d {e} off at b={bsz} 640²")
        err = max(err, e)
        ms = cuda_ms(lambda: fi.stem_s2d(x, w, bias, 160, 160), 20)
        plain_ms = cuda_ms(
            lambda: fi.stem_s2d_reference(x, w, bias, 160, 160), 5, 1)
        log(f"  stem_s2d b={bsz} 640² (npad={xs.shape[2]}): max |Δ| {e:.3g},"
            f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    b6 = (ms, plain_ms, *stem_bound(32, 160, 160), err)
    stem_split(lambda: fi.stem_s2d(x, w, bias, 160, 160), fi.stem_s2d,
               "stem_s2d b32 640² (B6)", fi.stem_plan(32, 160, 160, 4))
    det = Detector(80, 3)
    det.load_state_dict(sd)
    det = det.cuda().eval()
    with torch.inference_mode():
        xf = torch.from_numpy(imgs).cuda().permute(0, 3, 1, 2).float() / 255
        yard = cuda_ms(lambda: torch.nn.functional.max_pool2d(
            det.backbone.first_conv(xf), 3, 2, 1), 20)
    log(f"  stem yardstick b32 640²: cuDNN conv+BN+ReLU + max_pool2d of "
        f"Detector from f32 NCHW {yard:.4f} ms (stem_s2d {ms:.4f} ms)")
    for (stage, reps, c), hw in zip(STAGES, (80, 40, 20)):
        weights = p[f"s{stage}_span"]
        for bsz in (1, 32):
            rng = np.random.default_rng(stage * 640 + bsz)
            a = torch.from_numpy(np.abs(rng.normal(
                0.0, 1.0, (bsz, c, hw, hw))).astype(np.float32)).cuda()
            e = float((fi.span(a, weights, reps - 1)
                       - fi.span_reference(a, weights, reps - 1))
                      .abs().max())
            check(e <= FUSED_ATOL, f"span {e} off at b={bsz} C={c} {hw}²")
            plan = fi.span_stage_plan(bsz, c, hw, hw, reps - 1)
            log(f"  span b={bsz} C={c} {hw}x{hw} ({plan.variant}, cluster "
                f"{plan.cluster}, {plan.rows} rows per CTA, {plan.launches} "
                f"launches): max |Δ| {e:.3g}")

    cfg = dataclasses.replace(Config.from_file(DATA), width=640, height=640)
    images = photo_variants(photo, 8, seed=640, hw=(640, 640))
    fused = FusedPipeline(sd, cfg, dtype=torch.float32)
    fused(images[:1])                                  # warm-up
    kernels = [fi.stem_s2d, fi.span, pp_fused.rank_decode_nms]
    # ---- the main path: counts to 0, detect, read the counts
    for k in kernels:
        k.launches = 0
    got = fused(images)
    counts = {k.__name__: k.launches for k in kernels}
    for name, n in counts.items():
        check(n > 0, f"FusedPipeline at 640² launched no {name}")
    want = DevicePipeline(Detector(80, 3), sd, cfg)(images)
    for i, (a, b) in enumerate(zip(got, want)):
        check(a.shape == b.shape and np.array_equal(a[:, 5], b[:, 5])
              and np.abs(a[:, 4] - b[:, 4]).max(initial=0) <= 1e-4
              and np.abs(a[:, :4] - b[:, :4]).max(initial=0) <= 1e-2,
              f"640² detections of image {i} differ from DevicePipeline's")
    n_det = sum(len(a) for a in got)
    check(n_det > 0, "no detections at 640²")
    log(f"phase 7b 640²: stem_s2d (B 1, 32) and span (80²/40²/20²) within "
        f"{FUSED_ATOL:g} of their plain versions; FusedPipeline on 8 photo "
        f"variants: {n_det} detections, equal to DevicePipeline's (classes; "
        f"scores ≤ 1e-4, boxes ≤ 1e-2 px); launches {counts} ({card})")
    return counts["stem_s2d"], b6


# ------------------------------------------------ training (phase 8)

def span_train_bound(b, c, h, w, nblk, g):
    """B8 at one stage: forward and backward bounds → ((ms, by), (ms, by)).
    Forward: x read once, out and the nblk saved block inputs and the
    stats written once, the weights read once; 2 operations per MAC of
    the three convs, (C/2)²·2 + 9·C/2 MACs per pixel and block.
    Backward: dy, the saved inputs, the stats and the weights read once,
    dx and the weight gradients written once; 3× the forward's operations
    (the recomputed forward, the input gradients and the weight
    gradients, each the same MAC count)."""
    mid = c // 2
    act = b * c * h * w
    nstats = nblk * 3 * (b // g) * 3 * mid
    nw = nblk * (2 * mid * mid + 15 * mid)
    ops = nblk * b * h * w * 2 * (2 * mid * mid + 9 * mid)
    fwd = bound(4 * (2 * act + nblk * act + nstats + nw), ops)
    bwd = bound(4 * (2 * act + nblk * act + nstats + 2 * nw), 3 * ops)
    return fwd, bwd


def phase_span_train(sd, card):
    """8a: B8's forward and backward kernels against their plain versions
    on the card: the three stages at b128 352² (the real weights of the
    span blocks), at b1, small geometries with group < batch, and the
    edges of the launch plan (`SPAN_TRAIN_EDGE`).  The backward kernel
    and the plain backward get the same dy, xsave and stats, so their
    recomputed ReLU masks are the same bit for bit (both compute without
    FMA, in the same order); the gradients are held per leaf to
    1e-4·max|ref| + 1e-4 (`span_train_grad_errs`).  The plan's shared
    memory is the kernels' own.  Times at b128 (CUDA events): kernels,
    plain versions, the bounds, and as yardstick the Detector's cuDNN
    stride-1 blocks in training mode, forward and forward + backward;
    then, by torch.profiler, each call's time by kernel name and its
    device launches, which must be the plan's.  → {"fwd"/"bwd": (ms,
    plain_ms, bound_ms, bound_by, max |Δ|, library_ms)} summed over the
    three stages."""
    import torch
    from torch_cases import (SPAN_TRAIN_B1, SPAN_TRAIN_EDGE, SPAN_TRAIN_FULL,
                             SPAN_TRAIN_SMALL, span_train_case,
                             span_train_grad_errs)
    from fastdet_torch.kernels import _build
    from fastdet_torch.kernels import fused_train as ft
    from fastdet_torch.kernels.fold import STAGES
    from fastdet_torch.models import Detector
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    det = Detector(80, 3)
    det.load_state_dict(sd)
    det = det.cuda().train()
    reps = {c: (stage, r) for stage, r, c in STAGES}
    tot = {k: [0.0, 0.0, 0.0, 0.0, 0.0, 0.0] for k in ("fwd", "bwd")}
    by_bytes = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}
    cases = SPAN_TRAIN_FULL + SPAN_TRAIN_B1 + SPAN_TRAIN_SMALL + \
        SPAN_TRAIN_EDGE
    lib = _build.load("span_train", ft._SIGNATURES)
    launches = {"fwd": [], "bwd": []}
    for case in cases:
        b, c, h, w, nblk, g = case
        plan = ft.span_train_plan(b, c, h, w, nblk, g)
        check(all(lib.fastdet_span_train_smem(c, h, w, *tile, bwd)
                  == plan.smem_of(bwd) for bwd, tile in
                  ((0, plan.tile_fwd), (1, plan.tile_bwd))),
              f"B8 plan's shared memory at {case}")
        x, rows, dy = span_train_case(sum(case), b, c, h, w, nblk, "cuda")
        full = (h, w) in ((44, 44), (22, 22), (11, 11))
        if full:
            stage, r = reps[c]
            blocks = [getattr(det.backbone, f"stage{stage}_{i}")
                      for i in range(1, r)]
            rows = ft.pack_span_train_weights(blocks).detach().contiguous()
            check(ft.pick_train_group(b, (h * w + 127) // 128 * 128, c) == g,
                  f"ghost group of {case}")
        out, xsave, stats = ft.span_train_forward(x, rows, g)
        ref = ft.span_train_forward_reference(x, rows, g)
        torch.cuda.synchronize()
        f_err = 0.0
        # the stats one kind at a time (μ, σinv, var have other scales)
        pairs = list(zip(("out", "xsave"), (out, xsave), ref[:2])) + [
            (kind, stats[:, :, :, j], ref[2][:, :, :, j])
            for j, kind in enumerate(("mean", "sinv", "var"))]
        for name, got, want in pairs:
            e = float((got - want).abs().max())
            scale = float(want.abs().max())
            check(e <= 2e-4 * scale, f"B8 forward {name} {e} off "
                  f"(scale {scale}) at {case}")
            f_err = max(f_err, e)
        dx, drows = ft.span_train_backward(dy, xsave, stats, rows, g)
        rdx, rdrows = ft.span_train_backward_reference(dy, xsave, stats,
                                                       rows, g)
        torch.cuda.synchronize()
        errs = span_train_grad_errs(dx, drows, rdx, rdrows)
        bad = [e for e in errs if e[1] > e[2]]
        check(not bad, f"B8 backward off at {case}: {bad[:4]}")
        b_err = max(e[1] for e in errs)
        dx2, drows2 = ft.span_train_backward(dy, xsave, stats, rows, g)
        check(torch.equal(dx, dx2) and torch.equal(drows, drows2),
              f"B8 backward not deterministic at {case}")
        msg = (f"  span_train b={b} C={c} {h}x{w} nblk={nblk} g={g}: "
               f"forward max |Δ| {f_err:.3g}, backward max |Δ| {b_err:.3g} "
               f"(worst leaf {max(errs, key=lambda e: e[1] / e[2])[0]})")
        if not (full and b == 128):
            log(msg)
            tot["fwd"][4] = max(tot["fwd"][4], f_err)
            tot["bwd"][4] = max(tot["bwd"][4], b_err)
            continue
        ms_f = cuda_ms(lambda: ft.span_train_forward(x, rows, g), 10)
        ms_b = cuda_ms(lambda: ft.span_train_backward(dy, xsave, stats,
                                                      rows, g), 10)
        pl_f = cuda_ms(lambda: ft.span_train_forward_reference(x, rows, g),
                       2, 1)
        pl_b = cuda_ms(lambda: ft.span_train_backward_reference(
            dy, xsave, stats, rows, g), 2, 1)
        seq = torch.nn.Sequential(*blocks)
        xg = x.clone().requires_grad_()
        lib_f = cuda_ms(lambda: seq(xg), 10)
        lib_fb = cuda_ms(lambda: seq(xg).backward(dy), 10)
        (bf, byf), (bb, byb) = span_train_bound(b, c, h, w, nblk, g)
        for k, vals in (("fwd", (ms_f, pl_f, bf, f_err, lib_f)),
                        ("bwd", (ms_b, pl_b, bb, b_err, lib_fb - lib_f))):
            t = tot[k]
            t[0] += vals[0]
            t[1] += vals[1]
            t[2] += vals[2]
            t[4] = max(t[4], vals[3])
            t[5] += vals[4]
        by_bytes["fwd"][0 if byf == "bytes" else 1] += bf
        by_bytes["bwd"][0 if byb == "bytes" else 1] += bb
        log(msg + f"; kernels fwd {ms_f:.4f} ms, bwd {ms_b:.4f} ms; plain "
            f"fwd {pl_f:.3f} ms, bwd {pl_b:.3f} ms; bound fwd {bf:.4f} ms "
            f"({byf}), bwd {bb:.4f} ms ({byb}); cuDNN blocks (training "
            f"mode) fwd {lib_f:.4f} ms, fwd+bwd {lib_fb:.4f} ms")
        # the split by kernel name and the device launches per call
        for k, fn, want, tile, ctas in (
                ("fwd", lambda: ft.span_train_forward(x, rows, g),
                 plan.launches_fwd, plan.tile_fwd, plan.ctas_fwd),
                ("bwd", lambda: ft.span_train_backward(dy, xsave, stats,
                                                       rows, g),
                 plan.launches_bwd, plan.tile_bwd, plan.ctas_bwd)):
            split, n = planned_split(fn, want)
            if split is None:
                log(f"  B8 {k} split at C={c}: the profiler saw no device "
                    f"time (not measured)")
                launches[k].append("not measured")
                continue
            check(n == want, f"B8 {k} at {case}: {n:g} device launches per "
                  f"call, the plan says {want}")
            launches[k].append(f"{n:g}")
            log(f"  B8 {k} split at C={c} (torch.profiler, ms per call): "
                + split_text(split) + f"; {n:g} device launches per "
                f"call (plan: tiles {'×'.join(map(str, tile))}, {ctas} CTAs, "
                f"{plan.smem_of(k == 'bwd')} B of shared memory at most)")
    out = {}
    for k in ("fwd", "bwd"):
        t = tot[k]
        out[k] = (t[0], t[1], t[2], "bytes" if by_bytes[k][0] >=
                  by_bytes[k][1] else "operations", t[4], t[5])
    log(f"phase 8a span_train: B8 forward and backward within bounds of "
        f"their plain versions at {len(cases)} shapes; device launches per "
        f"stage call forward {' / '.join(launches['fwd'])}, backward "
        f"{' / '.join(launches['bwd'])}; b128 352² over the 3 stages "
        f"({card}): forward "
        f"{out['fwd'][0]:.4f} ms (bound {out['fwd'][2]:.4f}, plain "
        f"{out['fwd'][1]:.3f}, cuDNN {out['fwd'][5]:.4f}), backward "
        f"{out['bwd'][0]:.4f} ms (bound {out['bwd'][2]:.4f}, plain "
        f"{out['bwd'][1]:.3f}, cuDNN {out['bwd'][5]:.4f})")
    return out


STEM_GROUPED = 16   # the grouped stem's ghost group in 8b and 8c
STEM_LEAVES = tuple(f"backbone.first_conv.{k}"
                    for k in ("conv.weight", "bn.weight", "bn.bias"))


def stem_train_bound(b, h4, w4, g):
    """B7 on b images of (4·h4)×(4·w4) → ((ms, by), (ms, by)) for forward
    and backward.  Forward: x read once (uint8), y written once, the
    weights, γ, β read and the stats written once; operations: one conv
    sweep, 2·27 per conv output and channel (24 × (2·h4)·(2·w4) per
    image).  Backward: dy, x, the stats and the weights read once, dW, dγ,
    dβ written once; operations: the recomputed conv and the dW product,
    2× the forward's."""
    npad = (h4 * w4 + 127) // 128 * 128
    ops = b * 24 * 4 * h4 * w4 * 27 * 2
    small = 4 * (648 + 48 + (b // g) * 24 * 3)
    x_bytes = b * 48 * npad
    y_bytes = 4 * b * 24 * h4 * w4
    return (bound(x_bytes + y_bytes + small, ops),
            bound(x_bytes + y_bytes + small, 2 * ops))


def phase_stem_train(sd, photo, card):
    """8c: B7's forward and backward kernels against their plain versions
    on the card: at b128 352² on photo variants with the reference
    weights, at ghost group 1 (the main path) and STEM_GROUPED; then the
    cases of tests/torch_cases.py (b8 at group 4, b2 160×96 with pad
    lanes, images with flat blocks whose pool windows hold positive ties,
    32×48 and 36×52 whose 8×8-cell tiles are cut off at the edge, and γ
    of both signs with one γ = 0).  y within 2e-4 of its scale, the stats
    per kind within 2e-4 of each one's, and y and z bit for bit the plain
    conv, BN, ReLU and pool with the kernel's own stats; the backward
    kernels and the plain backward get the same dy, x and stats (so the
    same recomputed masks and pool routing) and dW, dγ, dβ are held to
    1e-4·max|ref| + 1e-4 each; a second backward gives the same bits.
    The plan's shared memory is the kernels' own.  Times at b128 (CUDA
    events): kernels, plain versions, the bounds, and as yardstick the
    nhwc path's stem (cuDNN conv, the port's training BatchNorm, ReLU,
    max_pool2d) forward and forward + backward; then, by torch.profiler,
    each call's time by kernel name and its device launches, which must
    be the plan's.  → {"g1"/"grouped": {"fwd"/"bwd": (ms, plain_ms,
    bound_ms, bound_by, max |Δ|, library_ms)}}."""
    import torch
    import torch.nn.functional as F
    from torch_cases import (STEM_TRAIN_CASES, grad_err, pool_ties,
                             stem_train_case)
    from fastdet_torch.kernels import _build
    from fastdet_torch.kernels import stem_train as stt
    from fastdet_torch.kernels.fused_infer import pack_images_s2d
    from fastdet_torch.models import Detector
    torch.backends.cudnn.allow_tf32 = False
    det = Detector(80, 3)
    det.load_state_dict(sd)
    fc = det.cuda().train().backbone.first_conv
    w_real = (fc.conv.weight * (1.0 / 255.0)).detach().contiguous()
    g_real, b_real = fc.bn.weight.detach(), fc.bn.bias.detach()
    photos = photo_variants(photo, 128, seed=31)
    bsz = len(photos)
    x_main = torch.from_numpy(pack_images_s2d(photos)).cuda()
    dy_main = torch.from_numpy(np.random.default_rng(31).normal(
        0.0, 1.0, (bsz, 24, 88, 88)).astype(np.float32)).cuda()
    cases = [(f"b{bsz} 352² photos g={g}", x_main, w_real, g_real, b_real,
              dy_main, 88, 88, g, False) for g in (1, STEM_GROUPED)]
    for case in STEM_TRAIN_CASES[1:]:
        b, hgt, wid, g, tie, signed = case
        x, w_raw, gamma, beta, dy = stem_train_case(sum(case), b, hgt, wid,
                                                    tie, "cuda", signed)
        cases.append((f"b{b} {hgt}x{wid} g={g}{' ties' if tie else ''}"
                      f"{' γ±,0' if signed else ''}", x,
                      (w_raw * (1.0 / 255.0)).contiguous(), gamma, beta, dy,
                      hgt // 4, wid // 4, g, tie))
    lib = _build.load("stem_train", stt._SIGNATURES)
    smem = stt.stem_train_plan(bsz, 88, 88, 1).smem_by_kernel
    check([lib.fastdet_stem_train_smem(k) for k in (0, 1)]
          == [smem["stem_fwd_sweep_kernel"], smem["stem_bwd_sweep_kernel"]],
          f"B7 plan's shared memory {smem}")
    img = torch.from_numpy(photos).cuda().permute(0, 3, 1, 2).float() / 255.0

    def lib_stem():
        return F.max_pool2d(fc(img), 3, 2, 1)

    lib_f = cuda_ms(lib_stem, 10)
    lib_fb = cuda_ms(lambda: lib_stem().backward(dy_main), 10)
    fc.zero_grad(set_to_none=True)
    timed = {}
    errs = [0.0, 0.0]
    launches = {"fwd": [], "bwd": []}
    for name, x, w, gamma, beta, dy, h4, w4, g, tie in cases:
        y, stats, z = stt.stem_train_forward(x, w, gamma, beta, h4, w4, g)
        ry, rstats = stt.stem_train_forward_reference(x, w, gamma, beta, h4,
                                                      w4, g)
        torch.cuda.synchronize()
        f_err = 0.0
        for what, got, want in [("y", y, ry)] + [
                (kind, stats[..., k], rstats[..., k])
                for k, kind in enumerate(("mean", "sinv", "var"))]:
            e = float((got - want).abs().max())
            scale = float(want.abs().max())
            check(e <= 2e-4 * scale, f"B7 forward {what} {e} off (scale "
                  f"{scale}) at {name}")
            f_err = max(f_err, e)
        # the pool before BN (identity 1): y and z bit for bit
        u = stt._conv(stt._image(x, h4, w4, w.dtype), w)
        bn, _ = stt._bn_parts(u, stats, gamma, beta, g)
        check(torch.equal(y, F.max_pool2d(torch.relu(bn), 3, 2, 1)),
              f"B7 y is not the plain BN + ReLU + pool with the kernel's "
              f"stats at {name}")
        check(torch.equal(z, stt.pooled_extreme(u, gamma)),
              f"B7 z is not the plain pooled conv at {name}")
        del u, bn
        grads = stt.stem_train_backward(dy, x, stats, w, gamma, beta, h4, w4,
                                        g, z)
        refs = stt.stem_train_backward_reference(dy, x, stats, w, gamma,
                                                 beta, h4, w4, g)
        torch.cuda.synchronize()
        b_err, worst = 0.0, ("", 0.0)
        for leaf, got, want in zip(("dW", "dgamma", "dbeta"), grads, refs):
            e, lim = grad_err(got, want)
            check(e <= lim, f"B7 backward {leaf} {e} off (bound {lim}) at "
                  f"{name}")
            b_err = max(b_err, e)
            worst = max(worst, (leaf, e / lim), key=lambda t: t[1])
        again = stt.stem_train_backward(dy, x, stats, w, gamma, beta, h4, w4,
                                        g, z)
        check(all(torch.equal(a, c) for a, c in zip(grads, again)),
              f"B7 backward not deterministic at {name}")
        msg = (f"  stem_train {name}: forward max |Δ| {f_err:.3g} (y, z "
               f"bitwise), backward max |Δ| {b_err:.3g} (worst leaf "
               f"{worst[0]} at {worst[1]:.3g} of its bound 1e-4·max|ref| + "
               f"1e-4)")
        if tie:
            n_ties = pool_ties(x, w, stats, gamma, beta, h4, w4, g)
            check(n_ties > 0, f"no positive pool ties at {name}")
            msg += f"; {n_ties} pool windows with a positive tie"
        errs = [max(errs[0], f_err), max(errs[1], b_err)]
        if x is not x_main:
            log(msg)
            continue
        ms_f = cuda_ms(lambda: stt.stem_train_forward(
            x, w, gamma, beta, h4, w4, g), 10)
        ms_b = cuda_ms(lambda: stt.stem_train_backward(
            dy, x, stats, w, gamma, beta, h4, w4, g, z), 10)
        pl_f = cuda_ms(lambda: stt.stem_train_forward_reference(
            x, w, gamma, beta, h4, w4, g), 2, 1)
        pl_b = cuda_ms(lambda: stt.stem_train_backward_reference(
            dy, x, stats, w, gamma, beta, h4, w4, g), 2, 1)
        (bf, byf), (bb, byb) = stem_train_bound(bsz, h4, w4, g)
        timed["g1" if g == 1 else "grouped"] = ((ms_f, pl_f, bf, byf),
                                                (ms_b, pl_b, bb, byb))
        log(msg + f"; kernels fwd {ms_f:.4f} ms, bwd {ms_b:.4f} ms; plain "
            f"fwd {pl_f:.3f} ms, bwd {pl_b:.3f} ms; bound fwd {bf:.4f} ms "
            f"({byf}), bwd {bb:.4f} ms ({byb})")
        # the split by kernel name and the device launches per call
        plan = stt.stem_train_plan(bsz, h4, w4, g)
        for k, fn, names, tile, ctas, sweeps in (
                ("fwd", lambda: stt.stem_train_forward(
                    x, w, gamma, beta, h4, w4, g),
                 plan.kernels_fwd, plan.tile_fwd, plan.ctas_fwd,
                 plan.sweeps_fwd),
                ("bwd", lambda: stt.stem_train_backward(
                    dy, x, stats, w, gamma, beta, h4, w4, g, z),
                 plan.kernels_bwd, plan.tile_bwd, plan.ctas_bwd,
                 plan.sweeps_bwd)):
            split, n = planned_split(fn, len(names))
            if split is None:
                log(f"  B7 {k} split at g={g}: the profiler saw no device "
                    f"time (not measured)")
                launches[k].append("not measured")
                continue
            check(n == len(names) and sorted(split) == sorted(names),
                  f"B7 {k} at {name}: {n:g} device launches per call of "
                  f"{sorted(split)}, the plan says {len(names)} of "
                  f"{sorted(names)}")
            launches[k].append(f"{n:g}")
            log(f"  B7 {k} split at g={g} (torch.profiler, ms per call): "
                + split_text(split) + f"; {n:g} device launches per call "
                f"(plan: tiles {'×'.join(map(str, tile))} cells, {ctas} "
                f"CTAs of the sweep, {sweeps:.3f} conv sweeps)")
    # max |Δ|: the worst over every shape
    out = {key: {"fwd": f + (errs[0], lib_f), "bwd": b + (errs[1],
                                                          lib_fb - lib_f)}
           for key, (f, b) in timed.items()}
    g1, gr = out["g1"], out["grouped"]
    log(f"phase 8c stem_train: B7 forward and backward within bounds of "
        f"their plain versions at {len(cases)} shapes, y and z bit for bit; "
        f"device launches per call forward {' / '.join(launches['fwd'])}, "
        f"backward {' / '.join(launches['bwd'])}; b{bsz} 352² g=1 ({card}): "
        f"forward {g1['fwd'][0]:.4f} ms (bound {g1['fwd'][2]:.4f}, plain "
        f"{g1['fwd'][1]:.3f}), backward {g1['bwd'][0]:.4f} ms (bound "
        f"{g1['bwd'][2]:.4f}, plain {g1['bwd'][1]:.3f}); g={STEM_GROUPED} "
        f"forward {gr['fwd'][0]:.4f} ms, backward {gr['bwd'][0]:.4f} ms; "
        f"the nhwc stem (cuDNN conv, training BN, ReLU, max_pool2d) forward "
        f"{lib_f:.4f} ms, forward + backward {lib_fb:.4f} ms")
    return out


def state_diff(a, b):
    """Largest per-tensor max|Δ| / max|ref| between two state dicts."""
    return max(float((x - b[k]).abs().max())
               / max(float(b[k].abs().max()), 1e-30) for k, x in a.items())


def running_stats_diff(a, b):
    """Per BN: max|Δ running_mean| over the largest running std, and
    max|Δ running_var| over the largest running var; the worst.  (The
    running means of a BN that follows a BN sit near 0, ~1e-8 here,
    and have no scale of their own.)"""
    worst = 0.0
    for k in b:
        if k.endswith("running_mean"):
            kv = k[:-len("mean")] + "var"
            std = float(b[kv].clamp(min=0).sqrt().max())
            worst = max(worst, float((a[k] - b[k]).abs().max()) / std,
                        float((a[kv] - b[kv]).abs().max())
                        / float(b[kv].abs().max()))
    return worst


def make_trainer(sd, cfg, mode, group=None, dtype=None):
    """A Trainer from the reference weights, built as the JAX package's
    bench builds it, for mode "default", "fused" (--fused-backbone) or
    "fused_s2d" (`fused_input_format="s2d_u8"`, the stem's ghost group 1),
    computing in f32, or in bf16 for `dtype=torch.bfloat16` (the bench's
    `Detector(dtype=bf16)`, whose Trainer computes in bf16).  With
    `group`, the s2d Trainer's apply is replaced by
    `build_fused_train_apply(..., input_format="s2d_u8",
    stem_group=group)`: the Trainer, as the JAX one, has no stem group of
    its own."""
    import torch
    from fastdet_torch.models import Detector
    from fastdet_torch.train.fused_forward import build_fused_train_apply
    from fastdet_torch.train.trainer import Trainer
    dtype = dtype or torch.float32
    model = Detector(80, 3, dtype=dtype)
    model.load_state_dict(sd)
    tr = Trainer(model, cfg, 1, fused_backbone=mode != "default",
                 fused_input_format="s2d_u8" if mode == "fused_s2d"
                 else "nhwc", device="cuda")
    if group is not None:
        tr._fused = build_fused_train_apply(
            tr.input_hw, input_format="s2d_u8", stem_group=group,
            device="cuda")
    return tr


def phase_training(sd, photo, dev_pipe, card, b8, b7):
    """8b: training at full width: Yolo-FastestV2, 80 classes, 352², b128
    (the `.data` file's batch), from the reference weights, on seeded
    photo variants with seeded labels.  Three modes: the default path and
    --fused-backbone through `cli.train.run_training`, and the fused s2d
    path through the Trainer as the JAX package's bench builds it
    (`fused_backbone=True, fused_input_format="s2d_u8"`) on the variants
    packed once by `pack_images_s2d` (the pack is timed apart, outside
    every step).  Per mode the counts go to 0 just before 4 steps and are
    read just after; the losses are finite, the params move, the momentum
    buffers fill; in the s2d mode the stem BN's running stats move, B7
    runs once forward and once backward per step and B8 three times each.
    The s2d path with the grouped stem (ghost group STEM_GROUPED, the
    Trainer's apply rebuilt by `build_fused_train_apply`) runs 2 steps
    the same way.  Equalities over 2 steps each: the fused path
    with the kernels against the plain spans (b128), the s2d path with
    the kernels against the plain stem (B8 kernels on both sides, b128),
    the fused path against the default path (b2), and the s2d path at
    stem group 2 (b2) and 1 (b1) against the default path on seeded noise
    images (no positive pool ties, whose order max_pool2d breaks
    otherwise).  Then ms per step and img/s of the three modes (CUDA
    events, median of 5 steps after 2 of warm-up), a profile of each, and
    B8's and B7's shares of their steps.  → ({kernel: launches} over the
    fused run (B8) and the s2d runs (B7 at group 1 and grouped), {mode:
    median ms/step})."""
    import torch
    from fastdet_torch.cli.train import run_training
    from fastdet_torch.config import Config
    from fastdet_torch.kernels import fused_train as ft
    from fastdet_torch.kernels import stem_train as stt
    from fastdet_torch.kernels.fused_infer import pack_images_s2d
    cfg = Config.from_file(DATA)
    bsz, steps = cfg.batch_size, 4
    images = photo_variants(photo, bsz, seed=21)
    labels, mask = eval_labels(dev_pipe(images), seed=21)
    t0 = time.perf_counter()
    images_s2d = pack_images_s2d(images)
    pack_ms = (time.perf_counter() - t0) * 1e3
    log(f"  s2d packing of the b{bsz} 352² training batch on the host "
        f"(pack_images_s2d, numpy, once, outside the timed steps): "
        f"{pack_ms:.1f} ms")
    inputs = {"default": images, "fused": images, "fused_s2d": images_s2d}

    def batches(epoch):
        return [(images, labels, mask)] * steps

    b8k = (ft.span_train_forward, ft.span_train_backward)
    b7k = (stt.stem_train_forward, stt.stem_train_backward)
    trainers, launches = {}, {}
    for mode in ("default", "fused", "fused_s2d", "fused_s2d_grouped"):
        n = 2 if mode == "fused_s2d_grouped" else steps
        # ---- the main path: counts to 0, train, read the counts
        for k in b8k + b7k:
            k.launches = 0
        t0 = time.perf_counter()
        if mode.startswith("fused_s2d"):
            tr = make_trainer(sd, cfg, "fused_s2d",
                              STEM_GROUPED if mode.endswith("grouped")
                              else None)
            for _ in range(n):
                tr.step(images_s2d, labels, mask)
        else:
            tr = run_training(cfg, sd, batches,
                              fused_backbone=mode == "fused", device="cuda",
                              steps=n, steps_per_epoch=1)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        c8 = [k.launches for k in b8k]
        c7 = [k.launches for k in b7k]
        want8 = [0, 0] if mode == "default" else [3 * n] * 2
        want7 = [n, n] if mode.startswith("fused_s2d") else [0, 0]
        check(c8 == want8 and c7 == want7, f"{mode}: B8 launches {c8}, "
              f"want {want8}; B7 launches {c7}, want {want7}")
        launches[mode] = {"b8": c8, "b7": c7}
        moved = state_diff({k: v for k, v in tr.model.state_dict().items()
                            if "running" not in k},
                           {k: v.cuda() for k, v in sd.items()
                            if "running" not in k})
        bufs = [s["momentum_buffer"] for s in tr.optimizer.state.values()]
        check(moved > 0, f"{mode}: params did not move")
        check(len(bufs) == len(list(tr.model.parameters()))
              and all(bool(torch.isfinite(b).all()) for b in bufs)
              and max(float(b.abs().max()) for b in bufs) > 0,
              f"{mode}: momentum buffers empty or non-finite")
        stem_moved = max(
            float((tr.model.state_dict()[f"backbone.first_conv.bn.{k}"]
                   - sd[f"backbone.first_conv.bn.{k}"].cuda()).abs().max())
            for k in ("running_mean", "running_var"))
        check(stem_moved > 0, f"{mode}: the stem BN's running stats stayed")
        m = tr.step(inputs.get(mode, images_s2d), labels, mask)
        vals = {k: float(v) for k, v in m.items()}
        check(all(np.isfinite(v) for v in vals.values()),
              f"{mode}: non-finite loss {vals}")
        if mode != "fused_s2d_grouped":
            trainers[mode] = tr
        via = ("the Trainer" if mode.startswith("fused_s2d")
               else "run_training")
        log(f"phase 8b train {mode}: {n} steps at b{bsz} 352² through {via} "
            f"in {secs:.2f} s (host clock, first build included); params "
            f"moved (max rel {moved:.3g}), stem BN running stats moved (max "
            f"{stem_moved:.3g}); step {n}: LR:{vals['lr']:f} "
            f"CIou:{vals['box']:f} Obj:{vals['obj']:f} Cls:{vals['cls']:f} "
            f"Total:{vals['total']:f}; B8 launches {c8}, B7 launches {c7}")

    def plain_stem_forward(x, w, gamma, beta, h4, w4, g):
        return (*stt.stem_train_forward_reference(x, w, gamma, beta, h4, w4,
                                                  g),
                stt.stem_train_pooled_reference(x, w, gamma, h4, w4))

    def plain_stem_backward(dy, x, stats, w, gamma, beta, h4, w4, g, z):
        return stt.stem_train_backward_reference(dy, x, stats, w, gamma,
                                                 beta, h4, w4, g)

    def run(mode, imgs, lbl, msk, plain=False, plain_stem=False, group=None,
            n=2):
        tr = make_trainer(sd, cfg, mode, group)
        saved = b8k + b7k
        if plain:
            ft.span_train_forward = ft.span_train_forward_reference
            ft.span_train_backward = ft.span_train_backward_reference
        if plain_stem:
            stt.stem_train_forward = plain_stem_forward
            stt.stem_train_backward = plain_stem_backward
        try:
            losses = [float(tr.step(imgs, lbl, msk)["total"])
                      for _ in range(n)]
        finally:
            (ft.span_train_forward, ft.span_train_backward,
             stt.stem_train_forward, stt.stem_train_backward) = saved
        bufs = {k: tr.optimizer.state[p]["momentum_buffer"]
                for k, p in tr.model.named_parameters()}
        return losses, {k: v.clone() for k, v in
                        tr.model.state_dict().items()}, bufs

    noise = np.random.default_rng(41).integers(0, 256, (2, 352, 352, 3),
                                               dtype=np.uint8)
    noise_s2d = pack_images_s2d(noise)
    for name, (a, b), args in (
            ("fused kernels vs fused plain spans, b128",
             (dict(mode="fused"), dict(mode="fused", plain=True)),
             (images, labels, mask)),
            ("s2d kernels vs s2d plain stem, b128",
             (dict(mode="fused_s2d"), dict(mode="fused_s2d",
                                           plain_stem=True)),
             (images_s2d, labels, mask)),
            ("fused vs default, b2", (dict(mode="fused"),
                                      dict(mode="default")),
             (images[:2], labels[:2], mask[:2])),
            ("s2d stem group 2 vs default, b2 noise",
             (dict(mode="fused_s2d", group=2, imgs=noise_s2d),
              dict(mode="default", imgs=noise)), (labels[:2], mask[:2])),
            ("s2d stem group 1 vs default, b1 noise",
             (dict(mode="fused_s2d", imgs=noise_s2d[:1]),
              dict(mode="default", imgs=noise[:1])),
             (labels[:1], mask[:1]))):
        t0 = time.perf_counter()
        if len(args) == 2:
            la, sa, ba = run(a.pop("mode"), a.pop("imgs"), *args, **a)
            lb, sb, bb = run(b.pop("mode"), b.pop("imgs"), *args, **b)
        else:
            la, sa, ba = run(a.pop("mode"), *args, **a)
            lb, sb, bb = run(b.pop("mode"), *args, **b)
        # the momentum buffers hold the two steps' gradients: the relative
        # L2 distance over all of them, and per tensor
        num = sum(float(((ba[k] - y) ** 2).sum()) for k, y in bb.items())
        den = sum(float((y ** 2).sum()) for y in bb.values())
        per = {k: float((ba[k] - y).norm() / y.norm().clamp(min=1e-30))
               for k, y in bb.items()}
        worst = max(per, key=per.get)
        loss_rel = max(abs(x - y) / abs(y) for x, y in zip(la, lb))
        # params against the model's weight scale (many are near 0)
        p_rel = (max(float((v - sb[k]).abs().max()) for k, v in sa.items()
                     if "running" not in k)
                 / max(float(v.abs().max()) for k, v in sb.items()
                       if "running" not in k))
        s_rel = running_stats_diff(sa, sb)
        g_rel = float(np.sqrt(num / den))
        # where the stem differs (B7 or its plain version on one side),
        # its three leaves are held one by one to the same 2e-3
        stem = ({k: per[k] for k in STEM_LEAVES} if "s2d" in name else {})
        log(f"  {name}: per-step loss rel {loss_rel:.3g} (≤ 1e-4); after 2 "
            f"steps params max |Δ| {p_rel:.3g} of the largest weight (≤ "
            f"1e-6), running stats {s_rel:.3g} (≤ 2e-4, see "
            f"running_stats_diff); momentum buffers (the summed "
            f"gradients) relative L2 {g_rel:.3g} over all (≤ 2e-3)"
            + "".join(f", {k} {v:.3g} (≤ 2e-3)" for k, v in stem.items())
            + f"; worst tensor {worst} {per[worst]:.3g}; "
            f"{time.perf_counter() - t0:.1f} s")
        # each run recomputes its backward's ReLU masks from its own
        # forward, whose stats differ in the last bits: masks flip where
        # |BN(u)| is that small, hence the 2e-3 on the gradients
        check(loss_rel <= 1e-4 and p_rel <= 1e-6 and s_rel <= 2e-4
              and g_rel <= 2e-3 and all(v <= 2e-3 for v in stem.values()),
              f"{name}: losses {la} vs {lb} (rel {loss_rel:.3g}), params "
              f"{p_rel:.3g}, running stats {s_rel:.3g}, gradients "
              f"{g_rel:.3g}, stem leaves {stem}")

    times = {}
    b7_prof = None
    for mode, tr in trainers.items():
        t0 = time.perf_counter()
        batch = inputs[mode]
        for _ in range(2):
            tr.step(batch, labels, mask)
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        evs[0].record()
        for i in range(5):
            tr.step(batch, labels, mask)
            evs[i + 1].record()
        torch.cuda.synchronize()
        per = sorted(evs[i].elapsed_time(evs[i + 1]) for i in range(5))
        times[mode] = per[2]
        log(f"  train step {mode} b{bsz} 352² ({card}): median "
            f"{per[2]:.3f} ms of 5 (CUDA events, spread {per[0]:.3f}-"
            f"{per[4]:.3f}), {bsz * 1e3 / per[2]:.1f} img/s")
        prof = profile_device(lambda: tr.step(batch, labels, mask),
                              f"{mode} b{bsz} train steps", calls=3, top=16)
        if mode == "fused_s2d":
            b7_kernels = stt.FWD_KERNELS + stt.BWD_KERNELS
            b7_prof = (None if prof is None else
                       sum(prof.get(k, 0.0) for k in b7_kernels))
        log(f"  timing and profile of {mode}: "
            f"{time.perf_counter() - t0:.1f} s")
    b8_ms = b8["fwd"][0] + b8["bwd"][0]
    b7_ms = b7["g1"]["fwd"][0] + b7["g1"]["bwd"][0]
    log(f"phase 8b training: default {times['default']:.3f} ms/step "
        f"({bsz * 1e3 / times['default']:.1f} img/s), fused "
        f"{times['fused']:.3f} ms/step ({bsz * 1e3 / times['fused']:.1f} "
        f"img/s), fused s2d {times['fused_s2d']:.3f} ms/step "
        f"({bsz * 1e3 / times['fused_s2d']:.1f} img/s; the host s2d pack, "
        f"not in it, {pack_ms:.1f} ms per batch); B8 (forward + backward, 3 "
        f"stages, timed apart in 8a) {b8_ms:.3f} ms = "
        f"{100 * b8_ms / times['fused']:.1f}% of a fused step; B7 (forward + "
        f"backward, timed apart in 8c) {b7_ms:.3f} ms = "
        f"{100 * b7_ms / times['fused_s2d']:.1f}% of a fused s2d step; B7's "
        f"kernels inside that step (its profile) "
        + ("not measured" if b7_prof is None else
           f"{b7_prof:.3f} ms = {100 * b7_prof / times['fused_s2d']:.1f}%")
        + f" ({card})")
    return launches, times


# ------------------------------------------ the anchor-free family (8d)

AF_CLS_GAIN = 4.0   # out_cls ×4 on the seeded full-width model: its class
                    # scores then cross both thresholds (conf 0.3, 0.01)
AF_BOX_PX = 1e-3    # fused against nn detections: boxes within, in px
AF_TIE = 1e-5       # scores this close may rank either way: the fused and
                    # nn maps differ by ≤ 4e-5, the scores by ≤ 2.5e-6
AF_IOU_TIE = 1e-3   # two NMS IoUs of one pair this far apart may fall on
                    # either side of iou_thres: the NMS adds cls·4096 to
                    # the coordinates, which f32 holds to 1/64 px there
AF_EVAL_ATOL = 1e-3  # --fused against default P/R/AP/F1: such ties flip
                     # a few of the ~60k detections of the mAP pass


def pack_s2d_on_device(images, k: int = 4):
    """(B, H, W, 3) uint8 tensor → (B, 3·k², pad128(H/k·W/k)) uint8, the
    layout of `pack_images_s2d` (k = 4) and `pack_images_s2d8` (k = 8),
    made on the tensor's device."""
    import torch.nn.functional as F
    b, ih, iw, _ = images.shape
    h, w = ih // k, iw // k
    x = images.reshape(b, h, k, w, k, 3).permute(0, 2, 4, 5, 1, 3)
    x = x.reshape(b, 3 * k * k, h * w)
    return F.pad(x, (0, -(-h * w // 128) * 128 - h * w)).contiguous()


def af_full_width_model(x):
    """AnchorFreeDetector(classes=80) at full width, its weights drawn
    from a seeded generator (`seeded_init`: flax's LeCun-normal convs),
    its BN running statistics then taken from 20 training-mode passes
    over the f32 NHWC batch `x` (so that the fused path folds statistics
    other than 0 and 1, and the maps have their real scale), out_cls
    ×AF_CLS_GAIN.  → the model on the card, in eval mode."""
    import torch
    from fastdet_torch.models.anchorfree import (AnchorFreeDetector,
                                                 seeded_init)
    model = seeded_init(AnchorFreeDetector(80),
                        torch.Generator().manual_seed(16)).cuda().train()
    with torch.no_grad():
        for _ in range(20):
            model(x)
        model.out_cls.weight.mul_(AF_CLS_GAIN)
        model.out_cls.bias.mul_(AF_CLS_GAIN)
    return model.eval()


def af_cells(maps, hw):
    """Every cell of the raw (obj, cls, reg) maps as `batched_nms` ranks
    it → numpy (boxes xyxy (B,N,4), score (B,N), class (B,N), the gap to
    the second class's score (B,N))."""
    from fastdet_torch.models.anchorfree import decode_anchorfree
    from fastdet_torch.ops.iou import xywh2xyxy
    boxes, obj, cls = decode_anchorfree(*maps, hw)
    top2 = (cls * obj[..., None]).topk(2, dim=-1)
    v, i = top2.values.cpu().numpy(), top2.indices.cpu().numpy()
    return (xywh2xyxy(boxes).cpu().numpy(), v[..., 0], i[..., 0],
            v[..., 0] - v[..., 1])


def af_disagreements(got, want, cells, conf_thres, iou_thres):
    """Per image, the fused path's detections (dets, counts) against the
    nn path's: the same rows (class, box within AF_BOX_PX, score within
    AF_TIE), in the same order or, where two scores tie within AF_TIE,
    in another.  A row that one path keeps and the other lacks is
    explained by a near tie at its cell (`cells`: `af_cells` of each
    path's maps, keyed "fused" and "nn"): its two best classes within
    AF_TIE in either path; its score within AF_TIE of `conf_thres`; or,
    in the path that lacks it, a kept row of its class that suppresses
    it (the NMS's own f32 IoU on class-offset boxes above `iou_thres`)
    where the path that keeps it puts the same pair's IoU at or below
    `iou_thres` by less than AF_IOU_TIE, or with a score within AF_TIE
    of its own, or that the first path lacks in its turn (the tie is
    then that row's).  → (lines of images that disagree, each
    unmatched row with its distances from the thresholds, whether all
    are explained)."""
    from fastdet_torch.ops.nms import MAX_WH
    dets = {name: (d.cpu().numpy(), c.cpu().numpy())
            for name, (d, c) in (("fused", got), ("nn", want))}

    def iou(p, q):
        """The IoU `ops.nms.keep_mask` compares, in its f32 operations on
        the class-offset boxes (p's class)."""
        off = np.float32(p[5] * MAX_WH)
        p, q = (np.asarray(x[:4], np.float32) + off for x in (p, q))
        lt, rb = np.maximum(p[:2], q[:2]), np.minimum(p[2:], q[2:])
        wh = np.maximum(rb - lt, np.float32(0))
        inter = wh[0] * wh[1]
        area = [(x[2] - x[0]) * (x[3] - x[1]) for x in (p, q)]
        return float(inter / (area[0] + area[1] - inter + np.float32(1e-9)))

    def unmatched(a, b):
        """Rows of a with no row of b of the same class, box and score
        (one to one, in order), and the rows of b left over."""
        free = list(range(len(b)))
        left = []
        for r in a:
            j = next((j for j in free if b[j, 5] == r[5]
                      and np.abs(b[j, :4] - r[:4]).max() <= AF_BOX_PX
                      and abs(b[j, 4] - r[4]) <= AF_TIE), None)
            if j is None:
                left.append(r)
            else:
                free.remove(j)
        return left, [b[j] for j in free]

    lines, explained = [], True
    for i in range(len(got[1])):
        a = dets["fused"][0][i, :dets["fused"][1][i]]
        b = dets["nn"][0][i, :dets["nn"][1][i]]
        if (a.shape == b.shape and np.array_equal(a[:, 5], b[:, 5])
                and np.abs(a[:, :4] - b[:, :4]).max(initial=0) <= AF_BOX_PX):
            continue
        only = dict(zip(("fused", "nn"), unmatched(a, b)))
        if not only["fused"] and not only["nn"]:
            lines.append(f"image {i}: the same {len(a)} rows, tied scores "
                         f"(within {AF_TIE:g}) in another order")
            continue
        kept = {"fused": a, "nn": b}
        parts = []
        for name, other in (("fused", "nn"), ("nn", "fused")):
            for r in only[name]:
                boxes = cells[name][0][i]
                c = int(np.abs(boxes - r[:4]).max(1).argmin())
                gap = min(cells[n][3][i, c] for n in cells)
                d_conf = abs(float(r[4]) - conf_thres)
                ob, os_, oc = (cells[other][k][i, c] for k in range(3))
                ob = np.append(ob, [os_, r[5]])
                sup = [(iou(ob, q), q) for q in kept[other]
                       if q[5] == r[5] and q[4] >= os_ - AF_TIE
                       and iou(ob, q) > iou_thres]
                why = []
                if gap <= AF_TIE:
                    why.append(f"its two best classes {gap:.3g} apart")
                if d_conf <= AF_TIE:
                    why.append(f"{d_conf:.3g} from conf {conf_thres}")
                for v, q in sup:
                    twin = [x for x in kept[name] if q[5] == x[5]
                            and np.abs(q[:4] - x[:4]).max() <= AF_BOX_PX]
                    v_here = iou(r, twin[0]) if twin else None
                    if (not twin or abs(float(q[4]) - os_) <= AF_TIE
                            or v - v_here <= AF_IOU_TIE):
                        why.append(
                            f"suppressed in {other} by a row of score "
                            f"{q[4]:.7f} at IoU {v:.7f}"
                            + (f", a row {name} lacks" if not twin else
                               f" ({v_here:.7f} in {name})"))
                explained &= bool(why)
                parts.append(
                    f"{name} only: class {int(r[5])} score {r[4]:.7f} at "
                    f"cell {c} ({other}: class {int(oc)}, score {os_:.7f}, "
                    f"suppressed by {len(sup)}): "
                    + ("; ".join(why) if why else "UNEXPLAINED"))
        lines.append(f"image {i}: counts {len(a)} / {len(b)}; "
                     + " | ".join(parts))
    return lines, explained


def phase_anchorfree(photo, card, images):
    """8d: the anchor-free family on the card, with no fallback: the
    golden detections through B1 and B2 and through cuDNN; the full-width
    fused forward against the nn model; FusedPipeline against the nn
    path's detections at both windows, its B1 and B2 launches (counts to
    0 just before, read just after, the plain stem and span swapped for
    ones that raise), img/s, the profile's `stem_kernel` and stage kernel
    rows held to the plans; `run_evaluation(family="anchorfree")` in both
    modes on phase 7's images; 3 b128 steps of `Trainer(loss_fn=)` and a b4
    128² step against the CPU.  → ({kernel: launches} on the main path,
    the full-width model's state dict)."""
    import dataclasses
    import torch
    from fastdet_torch.cli.evaluation import (MAP_PASS, PR_PASS,
                                              run_evaluation)
    from fastdet_torch.config import Config
    from fastdet_torch.eval.runner import evaluate
    from fastdet_torch.io import load_state_dict
    from fastdet_torch.kernels import fused_infer as fi
    from fastdet_torch.kernels.fold import STAGES
    from fastdet_torch.models.anchorfree import (AnchorFreeDetector,
                                                 build_anchorfree_detect_fn,
                                                 decode_anchorfree)
    from fastdet_torch.ops.nms import batched_nms
    from fastdet_torch.models.registry import get_family
    from fastdet_torch.serve import FusedPipeline
    from fastdet_torch.train.trainer import Trainer
    from torch_cases import (AF_GOLDEN, golden_image, golden_mismatches,
                             make_sample)
    kernels = (fi.stem_s2d, fi.span)

    def planned(b, h4, w4):
        """B1's and B2's launches a forward at (b, h4, w4), their plans'."""
        return {"stem_s2d": fi.stem_plan(b, h4, w4, 4).launches,
                "span": sum(fi.span_stage_plan(b, c, h4 >> i, w4 >> i,
                                               reps - 1).launches
                            for i, (_, reps, c) in enumerate(STAGES, 1))}

    def counted(fn):
        """fn() with the counts set to 0 just before and read just after,
        the plain stem and span replaced by functions that raise."""
        saved = fi.stem_s2d_reference, fi.span_reference

        def refuse(*args, **kw):
            raise RuntimeError("a plain version ran on the card's path")
        for k in kernels:
            k.launches = 0
        fi.stem_s2d_reference = fi.span_reference = refuse
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            fi.stem_s2d_reference, fi.span_reference = saved
        return out, {k.__name__: k.launches for k in kernels}

    # ---- 1. the golden detections
    with open(os.path.join(REPO, AF_GOLDEN)) as f:
        golden = json.load(f)
    img = golden_image(golden)[0][None]
    size = golden["size"]
    gcfg = Config.from_dict({"classes": 3, "width": size, "height": size,
                             "anchor_num": 3})
    gsd = load_state_dict(os.path.join(REPO, golden["weights"]))
    kw = dict(conf_thres=golden["conf_thres"],
              iou_thres=golden["iou_thres"], max_nms=golden["max_nms"])
    gpipe = FusedPipeline(gsd, gcfg, family="anchorfree",
                          dtype=torch.float32, **kw)
    gpipe(img)                                         # warm-up
    fused_rows, counts = counted(lambda: gpipe(img)[0])
    want = planned(1, size // 4, size // 4)
    check(counts == want, f"golden: launches {counts}, the plans {want}")
    gmodel = AnchorFreeDetector(3)
    gmodel.load_state_dict(gsd)
    dets, n = build_anchorfree_detect_fn(gmodel, (size, size), **kw)(
        torch.from_numpy(img).cuda())
    plain_rows = dets[0, :int(n[0])].cpu().numpy()
    for name, rows in (("FusedPipeline", fused_rows), ("cuDNN", plain_rows)):
        bad = golden_mismatches(rows, golden)
        check(not bad, f"anchor-free golden through {name}: {bad}")
    log(f"  anchor-free golden: {len(fused_rows)} detections through "
        f"FusedPipeline (launches {counts}, the plans') and "
        f"{len(plain_rows)} through the nn path in cuDNN, both the golden "
        f"file's by its rule (count {golden['count']}; classes "
        f"{fused_rows[:, 5].astype(int).tolist()}, scores "
        f"{np.round(fused_rows[:, 4], 4).tolist()})")

    # ---- 2. full width: 80 classes, 352², b128
    cfg = Config.from_file(DATA)
    host = photo_variants(photo, 128, seed=61)
    big = torch.from_numpy(host).cuda()
    xs = pack_s2d_on_device(big)
    xs8 = pack_s2d_on_device(big, 8)
    check(torch.equal(xs[:4].cpu(), torch.from_numpy(
        fi.pack_images_s2d(host[:4]))) and torch.equal(
        xs8[:4].cpu(), torch.from_numpy(fi.pack_images_s2d8(host[:4]))),
        "the s2d packing on the card differs from pack_images_s2d(8)")
    xf = big.float() / 255.0
    model = af_full_width_model(xf)
    sd = model.state_dict()
    errs = {}
    with torch.inference_mode():
        maps = model(xf)
        for fmt, fuse_s2, x in (("s2d_u8", False, xs), ("s2d_u8", True, xs),
                                ("s2d8_u8", False, xs8)):
            fwd, p = fi.build_fused_forward(sd, input_format=fmt,
                                            fuse_s2=fuse_s2,
                                            head="anchorfree")
            got = fwd(x, p)
            check([g.shape for g in got] == [m.shape for m in maps]
                  and all(g.dtype == torch.float32 for g in got),
                  f"anchor-free fused maps {fmt} fuse_s2={fuse_s2}: shapes "
                  f"{[tuple(g.shape) for g in got]}")
            e = max(float((g - m).abs().max()) for g, m in zip(got, maps))
            check(e <= FUSED_ATOL, f"anchor-free fused maps {fmt} "
                  f"fuse_s2={fuse_s2} {e} off the nn model's")
            errs[f"{fmt}{'+fuse_s2' if fuse_s2 else ''}"] = e
        fwd, p = fi.build_fused_forward(sd, head="anchorfree")
        cells = {"fused": af_cells(fwd(xs, p), (352, 352)),
                 "nn": af_cells(maps, (352, 352))}
        fwd_ms = cuda_median_ms(lambda: fwd(xs, p))
        nn_ms = cuda_median_ms(lambda: model(xf))
    log(f"  anchor-free full width (80 classes, b128 352², photo variants "
        f"packed on the card, BN statistics of 20 training passes, out_cls "
        f"×{AF_CLS_GAIN:g}): fused (obj, cls, reg) "
        f"{[tuple(m.shape) for m in maps]} against the nn model's, max |Δ| "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (≤ {FUSED_ATOL:g}); forward medians (CUDA events) fused "
        f"{fwd_ms:.3f} ms, nn (cuDNN) {nn_ms:.3f} ms")

    main_counts = None
    for conf, window in ((0.3, 128), (0.01, 1024)):
        pipe = FusedPipeline(sd, cfg, conf_thres=conf, iou_thres=0.45,
                             max_nms=window, family="anchorfree",
                             dtype=torch.float32)
        plain = build_anchorfree_detect_fn(model, (352, 352),
                                           conf_thres=conf, iou_thres=0.45,
                                           max_nms=window)
        pipe.detect(xs)                                # warm-up
        # ---- the main path: counts to 0, detect, read the counts
        got, counts = counted(lambda: pipe.detect(xs))
        want_n = planned(128, 88, 88)
        check(counts == want_n, f"anchor-free detect (conf {conf}): "
              f"launches {counts}, the plans {want_n}")
        if main_counts is None:
            main_counts = counts
        want = plain(big)
        lines, explained = af_disagreements(got, want, cells, conf, 0.45)
        for line in lines:
            log(f"  disagreement at conf {conf}, window {window}: {line}")
        check(explained, f"anchor-free detections at conf {conf}: an "
              f"unexplained disagreement with the nn path")
        n_det = int(got[1].sum())
        check(n_det > 0, f"anchor-free: no detections at conf {conf}")
        f_ms = cuda_median_ms(lambda: pipe.detect(xs))
        p_ms = cuda_median_ms(lambda: plain(big))
        log(f"  anchor-free FusedPipeline.detect conf {conf} window "
            f"{window}: {n_det} detections in 128 images, the nn path's "
            f"(counts, classes; boxes ≤ {AF_BOX_PX:g} px) in "
            f"{128 - len(lines)} images, near ties in {len(lines)}; launches "
            f"{counts}; {128e3 / f_ms:.1f} img/s on the device ({f_ms:.3f} "
            f"ms a b128 batch, median of 15 by CUDA events), nn path "
            f"{128e3 / p_ms:.1f} img/s ({p_ms:.3f} ms) ({card})")
        if conf == 0.3:
            want_k = {fi.STEM_KERNEL: want_n["stem_s2d"],
                      fi.STAGE_KERNEL: want_n["span"]}
            blank = 0
            for i in range(3):
                retake(i)
                split = kernel_split(lambda: pipe.detect(xs)) or {}
                blank += not split
                rows = {k: split.get(k, (0.0, 0.0)) for k in want_k}
                if all(rows[k][1] == n for k, n in want_k.items()):
                    break
                log(f"  (profile {i + 1} of 3 saw launches "
                    f"{ {k: v[1] for k, v in rows.items()} } per call, "
                    f"{want_k} planned)")
            if blank == 3:
                log("  anchor-free detect b128 by kernel: the profiler saw "
                    "no device time in 3 tries (not measured)")
            else:
                check(all(rows[k][1] == n for k, n in want_k.items()),
                      f"anchor-free detect profile: {rows}, the plans "
                      f"{want_k}")
                log(f"  anchor-free detect b128 by kernel (torch.profiler, ms "
                    f"per call): {split_text(split)}; {fi.STEM_KERNEL} and "
                    f"{fi.STAGE_KERNEL} launches {want_k}, the plans'")

    # ---- 3. eval on phase 7's images, both modes, with labels made from
    # the full-width model's own detections as phase 7 makes them from
    # DevicePipeline's (Yolo-FastestV2's classes would give AP 0 here)
    af_detect = build_anchorfree_detect_fn(model, (352, 352))
    own = []
    for s in range(0, len(images), 128):
        dets, n = af_detect(torch.from_numpy(images[s:s + 128]).cuda())
        dets, n = dets.cpu().numpy(), n.cpu().numpy()
        own += [dets[i, :n[i]] for i in range(len(n))]
    labels, mask = eval_labels(own, seed=7)

    def batches(bs):
        for s in range(0, len(images), bs):
            yield images[s:s + bs], labels[s:s + bs], mask[s:s + bs]

    fwd, p = fi.build_fused_forward(sd, head="anchorfree")
    forwards = {
        "default": lambda x: model(torch.from_numpy(x).cuda().float()
                                   / 255.0),
        "fused": lambda x: fwd(torch.from_numpy(
            fi.pack_images_s2d(x)).cuda(), p)}
    results = {}
    for mode in ("default", "fused"):
        run_evaluation(cfg, sd, batches, fused=mode == "fused",
                       device="cuda", batch=128, family="anchorfree")
        t0 = time.perf_counter()
        res, counts = counted(lambda: run_evaluation(
            cfg, sd, batches, fused=mode == "fused", device="cuda",
            batch=128, family="anchorfree"))
        secs = time.perf_counter() - t0
        check(None not in res, f"anchor-free eval {mode}: no detections")
        check((counts["stem_s2d"] > 0 and counts["span"] > 0)
              == (mode == "fused"), f"anchor-free eval {mode}: launches "
              f"{counts}")
        # the same passes by hand on the same forward's maps
        plain = []
        for kw in (MAP_PASS, PR_PASS):
            with torch.inference_mode():
                dets = [batched_nms(*decode_anchorfree(
                    *forwards[mode](images[s:s + 128]), (352, 352)), **kw)
                    for s in range(0, len(images), 128)]
            it = iter(dets)
            plain.append(evaluate(lambda _images: next(it), batches(128),
                                  (352, 352)))
        check(tuple(plain) == res, f"anchor-free eval {mode}: {res} differs "
              f"from the same passes on the same maps {plain}")
        res_map, res_pr = res
        results[mode] = (res_pr[0], res_pr[1], res_map[2], res_pr[3])
        check(all(np.isfinite(v) and 0 < v < 1 for v in results[mode]),
              f"anchor-free eval {mode}: P/R/AP/F1 {results[mode]}")
        log(f"  anchor-free eval {mode}: Precision:{results[mode][0]:f} "
            f"Recall:{results[mode][1]:f} AP:{results[mode][2]:f} "
            f"F1:{results[mode][3]:f} over {len(images)} images (b128), "
            f"equal to decode + batched_nms + the metrics on the same "
            f"forward's maps; {2 * len(images) / secs:.1f} img/s over both "
            f"passes ({secs:.3f} s, host clock, {card}); launches {counts}")
    diff = max(abs(x - y) for x, y in zip(results["fused"],
                                          results["default"]))
    check(diff <= AF_EVAL_ATOL, f"anchor-free eval: --fused "
          f"{results['fused']} off the default mode's {results['default']}")
    log(f"  anchor-free eval: --fused P/R/AP/F1 "
        + ("equal to" if diff == 0 else f"within {diff:.3g} (≤ "
           f"{AF_EVAL_ATOL:g}) of") + " the default mode's")

    # ---- 4. training: 3 b128 352² steps; a b4 128² step on both devices
    fam = get_family("anchorfree", cfg)
    fam.model.load_state_dict(sd)
    tr = Trainer(fam.model, cfg, 1, device="cuda", loss_fn=fam.loss_fn)
    timg, tlab, tmask = images[:128], labels[:128], mask[:128]
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    losses = []
    evs[0].record()
    for i in range(3):
        m = tr.step(timg, tlab, tmask)
        evs[i + 1].record()
        losses.append(m)
    torch.cuda.synchronize()
    losses = [{k: float(v) for k, v in m.items()} for m in losses]
    check(all(np.isfinite(v) for m in losses for v in m.values()),
          f"anchor-free training: non-finite losses {losses}")
    step_ms = [evs[i].elapsed_time(evs[i + 1]) for i in range(3)]
    prof = profile_device(lambda: tr.step(timg, tlab, tmask),
                          "anchor-free b128 train steps", calls=2, top=8)
    log(f"  anchor-free training b128 352² ({card}): "
        + "; ".join(f"CIou:{m['box']:f} Obj:{m['obj']:f} Cls:{m['cls']:f} "
                    f"Total:{m['total']:f}" for m in losses)
        + f"; ms/step (CUDA events) {', '.join(f'{t:.3f}' for t in step_ms)}"
        f" (the first with the set-up), {128e3 / step_ms[-1]:.1f} img/s at "
        f"the last" + ("; the profiler saw no device time (idle share not "
                       "measured)" if prof is None else ""))
    rng = np.random.RandomState(5)
    samples = [make_sample(rng, 128) for _ in range(4)]
    simg = np.stack([s[0] for s in samples])
    slab = np.zeros((4, 3, 5), np.float32)
    smask = np.zeros((4, 3), bool)
    for i, (_, lab) in enumerate(samples):
        slab[i, :len(lab)], smask[i, :len(lab)] = lab, True
    scfg = dataclasses.replace(cfg, classes=3, width=128, height=128,
                               batch_size=4)
    small = {}
    for dev in ("cuda", "cpu"):
        f = get_family("anchorfree", scfg)
        f.model.load_state_dict(gsd)
        small[dev] = float(Trainer(f.model, scfg, 1, device=dev,
                                   loss_fn=f.loss_fn).step(
            simg, slab, smask)["total"])
    rel = abs(small["cuda"] - small["cpu"]) / abs(small["cpu"])
    check(rel <= 1e-4, f"anchor-free b4 128² step: loss {small['cuda']} on "
          f"the card, {small['cpu']} on the CPU")
    log(f"phase 8d anchor-free: the golden detections, full-width maps and "
        f"detections at both windows, eval (each mode's P/R/AP/F1 those of "
        f"its maps; --fused within {diff:.3g} of the default) "
        f"and training (3 b128 steps finite; b4 128² loss "
        f"{small['cuda']:.6f} on the card, {small['cpu']:.6f} on the CPU, "
        f"rel {rel:.3g} ≤ 1e-4); main-path launches {main_counts}")
    return main_counts, sd


# ---------------------------------------------- bf16 serving (ROADMAP A1)

PEAK_BF16_TC_OPS_S = 989e12    # bf16 on the tensor cores, f32 accumulate
BF16_STAGE_RTOL = 2.0 ** -6    # bf16 stages against their plain versions,
                               # of the output's max |value| (a rounding a
                               # block; a flip moves what follows)
BF16_BOX_PX = 4.0              # the JAX package's bf16 serving contract
BF16_SCORE = 0.05              # (tests/test_postprocess.py): boxes, scores
BF16_BOX_REL = 2.0 ** -5       # boxes also within this share of the box's
                               # larger side (the 2⁻⁵ of the CPU tests' map
                               # bound): its 4 px, set on one golden image,
                               # is under 2.5% of a 170 px box
BF16_WIDE = 2.0                # pairs past the contract but within this
                               # multiple of it are counted and printed: on
                               # image 41 of phase 4c's batch the JAX
                               # package's own bf16 score is 0.047 off its
                               # f32 one (0.428 / 0.381, CPU)
BF16_MAP_RTOL = 2.0 ** -5      # a bf16 forward's maps against the plain
                               # bf16 forward's (the CPU tests' bound against
                               # the JAX package's bf16); against f32 maps
                               # the JAX package's own bf16 reads up to 9%
BF16_NEAR = 0.05               # a row missing on one side is excused when
                               # its score is within this of conf, or its
                               # IoU with a same-class row of the other
                               # side within this of iou_thres


def stem16_bound(b, h4, w4):
    """The bf16 stem: the u8 pixels read once, its 648 bf16 weights and 24
    f32 biases, the pooled bf16 map written once; 2 operations per conv
    MAC (27 per conv output, 4 conv outputs per pooled cell and channel),
    one bf16 term, at the bf16 tensor-core rate."""
    nbytes = b * 48 * h4 * w4 + 648 * 2 + 24 * 4 + b * 24 * h4 * w4 * 2
    return bound(nbytes, b * 4 * h4 * w4 * 24 * 27 * 2, PEAK_BF16_TC_OPS_S)


def span16_bound(b, c, h, w, nblk):
    """The bf16 span: the bf16 activation read and written once, the
    weights once; per pixel and block the composed function's MACs, mid²
    (pw1) + 9·mid² (dw3×3 ∘ pw2), at the bf16 tensor-core rate."""
    from fastdet_torch.kernels.fold import span16_elems
    mid = c // 2
    nbytes = (2 * b * c * h * w * 2
              + nblk * (span16_elems(mid) * 2 + 2 * mid * 4))
    return bound(nbytes, nblk * b * h * w * 2 * 10 * mid * mid,
                 PEAK_BF16_TC_OPS_S)


def s2span16_bound(b, cin, hin, win, nblk):
    """The bf16 stage: input and output bf16 once, weights once; pw1 on
    every input pixel (cin·mid MACs), 9·mid² + 9·cin·mid per output pixel
    (both composed stride-2 convs), then the span's."""
    from fastdet_torch.kernels.fold import s2_16_elems, span16_elems
    mid = cin
    h, w = (hin + 1) // 2, (win + 1) // 2
    nbytes = (b * cin * hin * win * 2 + b * 2 * mid * h * w * 2
              + s2_16_elems(cin, mid) * 2 + 3 * mid * 4
              + nblk * (span16_elems(mid) * 2 + 2 * mid * 4))
    macs = (hin * win * cin * mid + h * w * 9 * mid * (mid + cin)
            + nblk * h * w * 10 * mid * mid)
    return bound(nbytes, b * macs * 2, PEAK_BF16_TC_OPS_S)


BF16_ULP_FLOOR = 2.0 ** -10   # the ULP is taken at no smaller magnitude:
                              # below it an f32 sum's own rounding is many
                              # bf16 ULPs of a result that cancels (~1e-7:
                              # cuDNN's f32 conv reads 20 there against f64)


def bf16_ulps(got, want) -> float:
    """Largest |Δ| in bf16 ULPs of each element's magnitude (at least
    BF16_ULP_FLOOR)."""
    import torch
    g, w = got.float(), want.float()
    e = torch.floor(torch.log2(torch.maximum(g.abs(), w.abs()).clamp_min(
        BF16_ULP_FLOOR)))
    return float(((g - w).abs() / torch.exp2(e - 7)).max())


def np_iou(a, b):
    """IoU of xyxy box a against each row of b (numpy)."""
    lt = np.maximum(a[:2], b[:, :2])
    rb = np.minimum(a[2:4], b[:, 2:4])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
    area = lambda x: (x[..., 2] - x[..., 0]) * (x[..., 3] - x[..., 1])
    return inter / (area(a) + area(b) - inter)


def bf16_contract(got, want, conf, iou, names=("bf16", "f32")):
    """The JAX package's bf16 serving contract per image, `got` (bf16)
    against `want` (f32) lists of (n, 6) rows: each row paired with one of
    the other side of the same class, box within BF16_BOX_PX (or
    BF16_BOX_REL of its larger side), score within BF16_SCORE.  Pairs
    past that but within BF16_WIDE times it, and pairs whose boxes
    overlap by IoU ≥ 0.5 with scores within BF16_SCORE (the NMS kept the
    other of two candidates of one object), are reported apart (as
    excused lines).  A row left without a partner is excused (and
    reported) when its score is within BF16_NEAR of conf, or its IoU with
    a same-class row of the other side within BF16_NEAR of iou (a
    near-tie suppression).  → (pairs, pairs past 4 px, excused lines,
    unexcused lines, images with equal counts)."""
    pairs, wide, excused, bad = 0, 0, [], []
    for i, (g, w) in enumerate(zip(got, want)):
        free = list(range(len(w)))
        lone_g = []
        for row in g:
            side = max(row[2] - row[0], row[3] - row[1])
            tol = max(BF16_BOX_PX, BF16_BOX_REL * side)
            for k in (1.0, BF16_WIDE, None):
                if k is None:        # NMS kept the other of two candidates
                    hit = [j for j in free if w[j, 5] == row[5]
                           and np_iou(row, w[j:j + 1])[0] >= 0.5
                           and abs(w[j, 4] - row[4]) <= BF16_SCORE]
                else:
                    hit = [j for j in free if w[j, 5] == row[5]
                           and np.abs(w[j, :4] - row[:4]).max() <= k * tol
                           and abs(w[j, 4] - row[4]) <= k * BF16_SCORE]
                if hit:
                    break
            if hit:
                d = np.abs(w[hit[0], :4] - row[:4]).max()
                wide += d > BF16_BOX_PX
                if k != 1.0:
                    excused.append(
                        f"image {i}: pair past the contract ("
                        + ("another candidate kept, IoU "
                           f"{np_iou(row, w[hit[0]:hit[0] + 1])[0]:.3f}"
                           if k is None else f"within {BF16_WIDE:g}×")
                        + f"), cls {int(row[5])} scores {row[4]:.4f} / "
                        f"{w[hit[0], 4]:.4f}, boxes {d:.2f} px apart (box "
                        f"{side:.1f} px)")
                free.remove(hit[0])
                pairs += 1
            else:
                lone_g.append(row)
        for side, rows, other in ((names[0], lone_g, w),
                                  (names[1], [w[j] for j in free], g)):
            for row in rows:
                same = other[other[:, 5] == row[5]]
                near_iou = (np.abs(np_iou(row, same) - iou).min()
                            if len(same) else 1.0)
                line = (f"image {i}: {side} row cls {int(row[5])} score "
                        f"{row[4]:.4f} (conf {conf}) box "
                        f"{np.round(row[:4], 1).tolist()}, IoU with the "
                        f"nearest same-class row off iou_thres by "
                        f"{near_iou:.3f}")
                if row[4] - conf <= BF16_NEAR or near_iou <= BF16_NEAR:
                    excused.append(line)
                else:
                    bad.append(line)
    equal = sum(len(g) == len(w) for g, w in zip(got, want))
    return pairs, int(wide), excused, bad, equal


class plain_bf16:
    """Within it the bf16 forward runs its kernels' plain versions on the
    card (the same bf16 function in cuDNN f32 with the JAX package's
    rounding points): the four bf16 wrappers of `fused_infer` are swapped
    for their plain versions, as the forward looks them up at each
    call."""
    NAMES = (("stem_s2d_bf16", "stem_s2d_reference_bf16"),
             ("stem_s2d8_bf16", "stem_s2d8_reference_bf16"),
             ("span_bf16", "span_reference_bf16"),
             ("s2span_bf16", "s2span_reference_bf16"))

    def __enter__(self):
        from fastdet_torch.kernels import fused_infer as fi
        self.saved = {k: getattr(fi, k) for k, _ in self.NAMES}
        for k, ref in self.NAMES:
            setattr(fi, k, getattr(fi, ref))

    def __exit__(self, *exc):
        from fastdet_torch.kernels import fused_infer as fi
        for k, fn in self.saved.items():
            setattr(fi, k, fn)


def contract_line(what, res, n):
    pairs, wide, excused, _, equal = res
    return (f"{what}: {pairs} pairs ({wide} past {BF16_BOX_PX:g} px), "
            f"{equal}/{n} equal counts, {len(excused)} excused")


def rows_of(dets, counts):
    d, c = dets.cpu().numpy(), counts.cpu().numpy()
    return [d[i, :c[i]] for i in range(len(c))]


def library16_stem(x16, w, b):
    """cuDNN in bf16 for the stem's function: conv3×3 s2 + bias, ReLU,
    max_pool2d on the bf16 NCHW image (x/255 folded into w as the kernel
    has it)."""
    import torch.nn.functional as F
    return F.max_pool2d(F.relu(F.conv2d(x16, w, b, stride=2, padding=1)),
                        3, 2, 1)


def library16_blocks(x, mats, nblk, s2=None):
    """cuDNN in bf16 for the composed blocks: the stride-2 block (if s2 =
    (w1, b1, wc, bc, wp, bp)), then nblk stride-1 blocks (mats[k] = (w1,
    b1, wc, bc)), each conv bf16 in and out."""
    import torch
    import torch.nn.functional as F
    if s2 is not None:
        w1, b1, wc, bc, wp, bp = s2
        y = F.relu(F.conv2d(x, w1, b1))
        x = torch.cat([F.relu(F.conv2d(x, wp, bp, stride=2, padding=1)),
                       F.relu(F.conv2d(y, wc, bc, stride=2, padding=1))], 1)
    for k in range(nblk):
        w1, b1, wc, bc = mats[k]
        y = F.relu(F.conv2d(x[:, 1::2], w1, b1))
        x = torch.cat([x[:, 0::2], F.relu(F.conv2d(y, wc, bc, padding=1))],
                      1)
    return x


def library16_weights(p, stage, nblk):
    """A stage's bf16 composed matrices as cuDNN conv weights (bf16 OIHW)
    and bf16 biases, from the fragment-ordered tensors the kernels take."""
    import torch
    from fastdet_torch.kernels import fused_infer as fi
    m = {2: 24, 3: 48, 4: 96}[stage]
    k1, kc = fi._pad16(m) * m, fi._pad16(9 * m) * m
    b16 = torch.bfloat16

    def mats(w1, wc, b):
        return [w1[:, :, None, None].to(b16), b[:m].to(b16),
                fi._tap_conv_weight(wc, m).to(b16), b[m:2 * m].to(b16)]
    span = [mats(*fi.span16_matrices(p[f"s{stage}_span16"][k], m, k),
                 p[f"s{stage}_span16_b"][k]) for k in range(nblk)]
    w, b = p[f"s{stage}_s2_16"], p[f"s{stage}_s2_16_b"]
    s2 = mats(fi._frag_matrix(w[:k1], m, m), fi._frag_matrix(
        w[k1:k1 + kc], m, 9 * m), b) + [
            fi._tap_conv_weight(fi._frag_matrix(w[k1 + kc:], m, 9 * m),
                                m).to(b16), b[2 * m:].to(b16)]
    return span, s2


def phase_bf16(sd, photo, card, images, big, fused_pipe, af_sd):
    """9: bf16 serving, the JAX package's default.  The bf16 kernels (B1,
    B6, B10, B2, B9) against their plain versions at the f32 phases' shape
    classes (stems within one bf16 ULP, stages within 2⁻⁶ of the output's
    max |value|; max |Δ| and the share of equal elements), launches per
    call held to the plans; FusedPipeline(dtype=None) behind the HTTP
    server (12 concurrent /detect_raw requests, counts to 0 just before,
    read just after), its b128 detections held to the JAX package's bf16
    contract against the f32 pipeline, img/s and its profile; each kernel
    on the served batch's inputs with its bound, its plain version's and
    cuDNN's bf16 time; the five other flag combinations in bf16; the
    anchor-free family in bf16 at b128; FusedPipeline at 640² in bf16.
    → ({kernel: launches on its main path}, {kernel: (ms, plain_ms,
    bound_ms, bound_by, max |Δ|, library_ms)})."""
    import dataclasses
    import torch
    from fastdet_torch.config import Config, load_names, resolve_path
    from fastdet_torch.kernels import _build
    from fastdet_torch.kernels import fused_infer as fi
    from fastdet_torch.kernels import pp_fused
    from fastdet_torch.kernels.fold import STAGES
    from fastdet_torch.ops.postprocess import postprocess
    from fastdet_torch.serve import FusedPipeline
    from torch_cases import (S2SPAN_CASES, SPAN_CASES, STEM8_CASES,
                             STEM_CASES, s2span_case, stem8_case, stem_case)
    b16 = torch.bfloat16
    span_lib = _build.load("span", fi._SPAN_SIGNATURES)
    reps = {s: r for s, r, _ in STAGES}
    chans = {s: c for s, _, c in STAGES}
    cfg = Config.from_file(DATA)
    names = load_names(resolve_path(cfg.names, DATA))
    anchors = np.asarray(cfg.anchors, np.float32).reshape(2, 3, 2)
    _, p = fi.build_fused_forward(sd, dtype=b16)
    err = {k: 0.0 for k in ("stem_s2d_bf16", "stem_s2d8_bf16", "span_bf16",
                            "s2span_bf16")}

    def launched(fn, call, want, what):
        before = fn.launches
        out = call()
        check(fn.launches - before == want, f"{what}: {fn.launches - before} "
              f"launches, the plan {want}")
        return out

    # ---- 1. each bf16 kernel against its plain version
    for factor, cases, make, fn, ref in (
            (4, STEM_CASES, stem_case, fi.stem_s2d_bf16,
             fi.stem_s2d_reference_bf16),
            (8, STEM8_CASES, stem8_case, fi.stem_s2d8_bf16,
             fi.stem_s2d8_reference_bf16)):
        worst = (0.0, 1.0)
        for bsz, ih, iw in cases:
            x = make(bsz + ih + 16, bsz, ih, iw, "cuda")
            args = (p["stem_w"], p["stem_b"], ih // factor, iw // factor)
            got = launched(fn, lambda: fn(x, *args), 1,
                           f"{fn.__name__} b{bsz} {ih}x{iw}")
            want = ref(x, *args)
            ulps, eq = bf16_ulps(got, want), float((got == want).float().mean())
            check(ulps <= 1 and eq >= 0.99, f"{fn.__name__} b{bsz} {ih}x{iw}: "
                  f"{ulps} ULPs, {eq:.5f} equal")
            err[fn.__name__] = max(err[fn.__name__],
                                   float((got.float() - want.float()).abs()
                                         .max()))
            worst = (max(worst[0], ulps), min(worst[1], eq))
        log(f"  {fn.__name__} against its plain version at {len(cases)} "
            f"shapes (junk in the pad lanes): ≤ {worst[0]:g} bf16 ULP, ≥ "
            f"{worst[1]:.5f} of the elements equal, max |Δ| "
            f"{err[fn.__name__]:.3g}; 1 launch a call (`stem_plan`)")
    for what, cases in (("span_bf16", SPAN_CASES), ("s2span_bf16",
                                                    S2SPAN_CASES)):
        worst = (0.0, 1.0)
        for case in cases:
            if what == "span_bf16":
                bsz, stage, h, w = case
                x = s2span_case(stage + h + 5, bsz, chans[stage], h, w,
                                "cuda").to(b16)
                n = reps[stage] - 1
                args = (p[f"s{stage}_span16"], p[f"s{stage}_span16_b"], n)
                plan = fi.span16_plan(bsz, chans[stage], h, w, n)
                fn, ref = fi.span_bf16, fi.span_reference_bf16
            else:
                bsz, stage, hin, win = case
                x = s2span_case(stage * 3 + hin + 5, bsz, chans[stage] // 2,
                                hin, win, "cuda").to(b16)
                n = reps[stage] - 1
                args = (p[f"s{stage}_s2_16"], p[f"s{stage}_s2_16_b"],
                        p[f"s{stage}_span16"], p[f"s{stage}_span16_b"], n)
                plan = fi.span16_plan(bsz, chans[stage], (hin + 1) // 2,
                                      (win + 1) // 2, n, True, win)
                fn, ref = fi.s2span_bf16, fi.s2span_reference_bf16
            got = launched(fn, lambda: fn(x, *args), plan.launches,
                           f"{what} {case}")
            win = x.shape[3] if what == "s2span_bf16" else 0
            for rows, halo, s2, orows in plan.layouts:
                smem = span_lib.fastdet_span16_smem(
                    chans[stage] // 2, rows, got.shape[3], halo, int(s2),
                    win, orows)
                check(smem <= plan.smem_bytes and (
                    len(plan.layouts) > 1 or smem == plan.smem_bytes),
                    f"{what} {case}: the kernel's {smem} B of shared "
                    f"memory, the plan's {plan.smem_bytes}")
            want = ref(x, *args)
            e = float((got.float() - want.float()).abs().max())
            rel = e / float(want.float().abs().max())
            eq = float((got == want).float().mean())
            check(rel <= BF16_STAGE_RTOL, f"{what} {case}: {rel:.3g} of the "
                  f"output's max |value| off")
            err[what] = max(err[what], e)
            worst = (max(worst[0], rel), min(worst[1], eq))
        log(f"  {what} against its plain version at {len(cases)} shapes: "
            f"max |Δ| ≤ {worst[0]:.3g} of the output's max |value| (≤ "
            f"2^-6), ≥ {worst[1]:.5f} of the elements equal, max |Δ| "
            f"{err[what]:.3g}; launches a call and shared memory as "
            f"`span16_plan`")

    # the bf16 convs of the parts the JAX package leaves to XLA: cuDNN's
    # bf16 conv against the f32 conv of the same bf16 values, rounded
    with torch.inference_mode():
        worst = (0.0, 1.0)
        for cin, cout, k, stride, groups, hw in (
                (96, 96, 5, 1, 96, 22), (192, 72, 1, 1, 1, 11),
                (24, 24, 1, 1, 1, 88), (48, 48, 3, 2, 48, 44)):
            g = torch.Generator(device="cuda").manual_seed(cin + k)
            x = torch.rand(128, cin, hw, hw, generator=g, device="cuda").to(
                b16)
            w = (torch.randn(cout, cin // groups, k, k, generator=g,
                             device="cuda") / k).to(b16)
            got = fi._conv16(x, w, stride, k // 2, groups)
            want = torch.nn.functional.conv2d(
                x.float(), w.float(), None, stride, k // 2, 1, groups).to(b16)
            ulps, eq = bf16_ulps(got, want), float((got == want).float()
                                                    .mean())
            check(got.dtype == b16 and ulps <= 1 and eq >= 0.99,
                  f"_conv16 {cin}→{cout} k{k}: {ulps} ULPs, {eq:.5f} equal")
            worst = (max(worst[0], ulps), min(worst[1], eq))
    log(f"  _conv16 on the card (cuDNN bf16) against the f32 conv of the same "
        f"bf16 values, rounded: ≤ {worst[0]:g} bf16 ULP, ≥ {worst[1]:.5f} "
        f"equal (4 shapes of the heads, FPN and stride-2 blocks)")

    # ---- 2. FusedPipeline(dtype=None) behind the server: the main path
    pipe = FusedPipeline(sd, cfg)
    check(pipe.dtype == b16, f"FusedPipeline(dtype=None) is {pipe.dtype}")
    answers, served, stats, serve_launches = serve_concurrently(
        pipe, images, cfg, names,
        [fi.stem_s2d_bf16, fi.span_bf16, pp_fused.rank_decode_nms])
    per_batch = 1 + sum(fi.span16_plan(1, c, 88 >> i, 88 >> i, r - 1).launches
                     for i, (_, r, c) in enumerate(STAGES, 1))
    check(serve_launches["stem_s2d_bf16"] * (per_batch - 1)
          == serve_launches["span_bf16"],
          f"served launches {serve_launches}: not 1 stem to "
          f"{per_batch - 1} span launches a batch")
    pairs, wide, excused, bad, equal = bf16_contract(
        served, fused_pipe(images), 0.3, 0.45)
    check(not bad, f"bf16 served detections: {bad}")
    log(f"phase 9 bf16 serving: FusedPipeline(dtype=None) = bf16; "
        f"{len(images)} concurrent /detect_raw requests in "
        f"{stats['batches']} batches {stats['batch_hist']}, "
        f"{sum(a['count'] for a in answers)} detections, each equal to the "
        f"bf16 pipeline on the same batch; against the f32 pipeline {pairs} "
        f"pairs (classes, boxes ≤ {BF16_BOX_PX:g} px or 2^-5 of the box, "
        f"{wide} of them past {BF16_BOX_PX:g} px, scores ≤ {BF16_SCORE:g}), "
        f"{equal}/{len(images)} images with equal counts, "
        f"{len(excused)} rows excused near conf/iou; launches on this path "
        f"{serve_launches}")
    for line in excused:
        log(f"  excused: {line}")

    host_big = big.cpu().numpy()
    big_s2d = torch.from_numpy(fi.pack_images_s2d(host_big)).cuda()
    with torch.inference_mode():
        got16 = rows_of(*pipe.detect(big_s2d))
        got32 = rows_of(*fused_pipe.detect(big_s2d))
    pairs, wide, excused, bad, equal = bf16_contract(got16, got32, 0.3, 0.45)
    check(not bad, f"bf16 b128 detections: {bad}")
    check(pairs > 0, "no bf16 detections at b128")
    runs = {"f32": lambda: fused_pipe.detect(big_s2d),
            "bf16": lambda: pipe.detect(big_s2d)}
    dev_ms = {k: [] for k in runs}
    for k in ("f32", "bf16", "bf16", "f32"):
        dev_ms[k].append(cuda_ms(runs[k], 20))
    h2h = {}
    for k, pp_ in (("f32", fused_pipe), ("bf16", pipe)):
        pp_(host_big)
        t0 = time.perf_counter()
        for _ in range(5):
            pp_(host_big)
        h2h[k] = (time.perf_counter() - t0) / 5 * 1e3
    log(f"  b128 352² (conf 0.3, window 128): bf16 detections against the "
        f"f32 pipeline's, {pairs} pairs ({wide} past {BF16_BOX_PX:g} px), "
        f"{equal}/128 images with equal counts, {len(excused)} rows excused "
        f"near conf/iou")
    for line in excused:
        log(f"  excused: {line}")
    for k in runs:
        m = sum(dev_ms[k]) / 2
        log(f"  throughput b128 352² FusedPipeline {k} ({card}): "
            f"{128e3 / m:.1f} img/s on the device ({m:.3f} ms a batch; calls "
            f"{', '.join(f'{x:.3f}' for x in dev_ms[k])} ms), "
            f"{128e3 / h2h[k]:.1f} img/s host to host")
    inside = profile_device(lambda: pipe.detect(big_s2d),
                            "bf16 fused b128 batches")
    if inside is not None:
        log("  the bf16 kernels inside a b128 batch (torch.profiler, ms a "
            "batch): " + ", ".join(
                f"{name} {inside.get(name, 0.0):.4f}" for name in (
                    "stem_kernel", fi.SPAN16_KERNEL,
                    "rank_decode_nms_kernel")))

    # ---- 3. each kernel on the served batch's inputs: time, bound,
    #         plain version, cuDNN in bf16
    out = {}
    with torch.inference_mode():
        cum = {}
        for upto in ("stem", "s2", "s3", "s4", None):
            fwd, _ = fi.build_fused_forward(sd, dtype=b16, upto=upto)
            cum[upto] = cuda_ms(lambda: fwd(big_s2d, p), 10)
        log("  bf16 forward b128 per stage (CUDA events, upto=): " + ", ".join(
            f"{u or 'fpn+heads'} {cum[u] - cum[v] if v else cum[u]:.3f}"
            for v, u in zip((None, "stem", "s2", "s3", "s4"),
                            ("stem", "s2", "s3", "s4", None)))
            + f" ms; whole forward {cum[None]:.3f} ms")
        args = (p["stem_w"], p["stem_b"], 88, 88)
        x0 = fi.stem_s2d_bf16(big_s2d, *args)
        img16 = (big.permute(0, 3, 1, 2).contiguous().to(b16))
        w16 = p["stem_w"].cuda().permute(3, 2, 0, 1).contiguous()
        b16v = p["stem_b"].cuda().to(b16)
        k_ms = cuda_ms(lambda: fi.stem_s2d_bf16(big_s2d, *args), 20)
        plain = cuda_ms(lambda: fi.stem_s2d_reference_bf16(big_s2d, *args),
                        5, 1)
        lib = cuda_ms(lambda: library16_stem(img16, w16, b16v), 10)
        e = float((x0.float() - fi.stem_s2d_reference_bf16(
            big_s2d, *args).float()).abs().max())
        out["stem_s2d_bf16"] = (k_ms, plain) + stem16_bound(128, 88, 88) \
            + (e, lib)
        span_t, s2_t = [0.0] * 4, [0.0] * 4
        x, xs2 = x0, x0
        for (sid, r, c), hw in zip(STAGES, (44, 22, 11)):
            xb = fi._s2_block_bf16(x, p, f"s{sid}_0")
            a = (p[f"s{sid}_span16"], p[f"s{sid}_span16_b"], r - 1)
            a2 = (p[f"s{sid}_s2_16"], p[f"s{sid}_s2_16_b"]) + a
            mats, s2m = library16_weights(p, sid, r - 1)
            for acc, fn, ref, inp, aa, libf, bnd in (
                    (span_t, fi.span_bf16, fi.span_reference_bf16, xb, a,
                     lambda inp=xb, m=mats: library16_blocks(inp, m, r - 1),
                     span16_bound(128, c, hw, hw, r - 1)),
                    (s2_t, fi.s2span_bf16, fi.s2span_reference_bf16, xs2, a2,
                     lambda inp=xs2, m=mats, s=s2m: library16_blocks(
                         inp, m, r - 1, s),
                     s2span16_bound(128, c // 2, 2 * hw, 2 * hw, r - 1))):
                y = fn(inp, *aa)
                e = float((y.float() - ref(inp, *aa).float()).abs().max())
                t = (cuda_ms(lambda: fn(inp, *aa), 20),
                     cuda_ms(lambda: ref(inp, *aa), 5, 1), cuda_ms(libf, 10))
                for i, v in enumerate(t):
                    acc[i] += v
                acc[3] = max(acc[3], e)
                acc.append(bnd)
                log(f"  {fn.__name__} s{sid} b128 {hw}² on the batch's "
                    f"input: kernel {t[0]:.4f} ms, plain {t[1]:.4f}, cuDNN "
                    f"bf16 {t[2]:.4f}, bound {bnd[0]:.4f} ({bnd[1]}), "
                    f"max |Δ| {e:.3g}")
                s2 = fn is fi.s2span_bf16
                stage16_split(lambda: fn(inp, *aa), fn,
                              f"{fn.__name__} s{sid} b128",
                              fi.span16_plan(128, c, hw, hw, r - 1, s2,
                                             2 * hw if s2 else 0))
            x = fi.span_bf16(xb, *a)
            xs2 = fi.s2span_bf16(xs2, *a2)
        for name, acc in (("span_bf16", span_t), ("s2span_bf16", s2_t)):
            out[name] = (acc[0], acc[1], sum(b[0] for b in acc[4:]),
                         max(acc[4:])[1], acc[3], acc[2])
        log(f"  stem_s2d_bf16 b128 352²: kernel {out['stem_s2d_bf16'][0]:.4f}"
            f" ms, plain {plain:.4f}, cuDNN bf16 conv+ReLU+max_pool2d "
            f"{lib:.4f}, bound {out['stem_s2d_bf16'][2]:.4f} "
            f"({out['stem_s2d_bf16'][3]})")

    # ---- 4. the five other flag combinations in bf16
    host = photo_variants(photo, 128, seed=44)
    inputs = {"nhwc": torch.from_numpy(host).cuda(),
              "s2d_u8": torch.from_numpy(fi.pack_images_s2d(host)).cuda(),
              "s2d8_u8": torch.from_numpy(fi.pack_images_s2d8(host)).cuda()}
    fwd16 = {c: fi.build_fused_forward(sd, dtype=b16, input_format=c[0],
                                       fuse_s2=c[1])
             for c in (("s2d_u8", False),) + FLAG_COMBOS}
    fwd32 = {c: fi.build_fused_forward(sd, input_format=c[0], fuse_s2=c[1])
             for c in fwd16}
    flag_kernels = (fi.stem_s2d8_bf16, fi.s2span_bf16)

    def detect(fwd_p, c):
        f, pk = fwd_p
        return rows_of(*postprocess(f(inputs[c[0]], pk), anchors,
                                    (352, 352), conf_thres=0.3,
                                    iou_thres=0.45, max_nms=128))
    with torch.inference_mode():
        for k in flag_kernels:
            k.launches = 0
        got = {c: detect(fwd16[c], c) for c in FLAG_COMBOS}
        torch.cuda.synchronize()
        flag_launches = {k.__name__: k.launches for k in flag_kernels}
        for k, n in flag_launches.items():
            check(n > 0, f"the bf16 flag paths launched no {k}")
        for c in fwd16:
            rows16 = got[c] if c in got else detect(fwd16[c], c)
            maps16 = fwd16[c][0](inputs[c[0]], fwd16[c][1])
            maps32 = fwd32[c][0](inputs[c[0]], fwd32[c][1])
            with plain_bf16():
                plain_maps = fwd16[c][0](inputs[c[0]], fwd16[c][1])
                plain_rows = detect(fwd16[c], c)
            rel = max(float((a - b).abs().max() / b.abs().max())
                      for a, b in zip(maps16, plain_maps))
            rel32 = max(float((a - b).abs().max() / b.abs().max())
                        for a, b in zip(maps16, maps32))
            check(rel <= BF16_MAP_RTOL, f"bf16 {c}: maps {rel:.3g} of their "
                  f"max |value| off the plain bf16 forward's")
            res = bf16_contract(rows16, plain_rows, 0.3, 0.45,
                                ("kernels", "plain"))
            check(not res[3], f"bf16 {c} against its plain version: {res[3]}")
            res32 = bf16_contract(rows16, detect(fwd32[c], c), 0.3, 0.45)
            f16, f32_ = cuda_median_ms(lambda: fwd16[c][0](inputs[c[0]],
                                                           fwd16[c][1]), 7), \
                cuda_median_ms(lambda: fwd32[c][0](inputs[c[0]],
                                                   fwd32[c][1]), 7)
            log(f"  bf16 {c[0]}{' fuse_s2' if c[1] else ''} b128: forward "
                f"{f16:.3f} ms (f32 {f32_:.3f}); maps {rel:.3g} of their max "
                f"|value| off the plain bf16 forward's (≤ 2^-5), {rel32:.3g} "
                f"off the f32 forward's (not a gate); detections "
                + contract_line("against the plain bf16 path's", res, 128)
                + "; " + contract_line("against f32 (not a gate)", res32, 128)
                + f", {len(res32[3])} unexplained")
        args8 = (p["stem_w"], p["stem_b"], 44, 44)
        x8 = inputs["s2d8_u8"]
        y8 = fi.stem_s2d8_bf16(x8, *args8)
        e = float((y8.float() - fi.stem_s2d8_reference_bf16(
            x8, *args8).float()).abs().max())
        img16 = inputs["nhwc"].permute(0, 3, 1, 2).contiguous().to(b16)
        out["stem_s2d8_bf16"] = (
            cuda_ms(lambda: fi.stem_s2d8_bf16(x8, *args8), 20),
            cuda_ms(lambda: fi.stem_s2d8_reference_bf16(x8, *args8), 5, 1)) \
            + stem16_bound(128, 88, 88) + (e, cuda_ms(
                lambda: library16_stem(img16, w16, b16v), 10))
    log(f"  the bf16 flag paths: launches over the five {flag_launches}")

    # ---- 5. 640²: B6 in bf16, FusedPipeline(dtype=None) at 640²
    cfg640 = dataclasses.replace(Config.from_file(DATA), width=640,
                                 height=640)
    host640 = photo_variants(photo, 32, seed=66, hw=(640, 640))
    x640 = torch.from_numpy(fi.pack_images_s2d(host640)).cuda()
    pipe640 = FusedPipeline(sd, cfg640)
    pipe640(host640[:8])
    fi.stem_s2d_bf16.launches = 0
    rows640 = pipe640(host640[:8])
    b6_launches = fi.stem_s2d_bf16.launches
    check(b6_launches == 1, f"640² bf16 batch: {b6_launches} stem launches")
    with plain_bf16():
        plain640 = pipe640(host640[:8])
    res640 = bf16_contract(rows640, plain640, 0.3, 0.45,
                           ("kernels", "plain"))
    check(not res640[3], f"bf16 640² against its plain version: "
          f"{res640[3]}")
    res640_32 = bf16_contract(rows640, FusedPipeline(
        sd, cfg640, dtype=torch.float32)(host640[:8]), 0.3, 0.45)
    with torch.inference_mode():
        a640 = (p["stem_w"], p["stem_b"], 160, 160)
        y = fi.stem_s2d_bf16(x640, *a640)
        e = float((y.float() - fi.stem_s2d_reference_bf16(
            x640, *a640).float()).abs().max())
        img640 = torch.from_numpy(host640).cuda().permute(
            0, 3, 1, 2).contiguous().to(b16)
        out["stem_s2d_bf16@640"] = (
            cuda_ms(lambda: fi.stem_s2d_bf16(x640, *a640), 20),
            cuda_ms(lambda: fi.stem_s2d_reference_bf16(x640, *a640), 5, 1)) \
            + stem16_bound(32, 160, 160) + (e, cuda_ms(
                lambda: library16_stem(img640, w16, b16v), 10))
    log(f"  640² bf16: FusedPipeline(dtype=None) on 8 photo variants, "
        + contract_line("against the plain bf16 path's", res640, 8) + "; "
        + contract_line("against f32 (not a gate)", res640_32, 8)
        + f", {len(res640_32[3])} unexplained; stem_s2d_bf16 b32 640² "
        f"{out['stem_s2d_bf16@640'][0]:.4f} ms (plain "
        f"{out['stem_s2d_bf16@640'][1]:.4f}, cuDNN bf16 "
        f"{out['stem_s2d_bf16@640'][5]:.4f}, bound "
        f"{out['stem_s2d_bf16@640'][2]:.4f})")

    # ---- 6. the anchor-free family in bf16 at b128 352²
    xs = pack_s2d_on_device(torch.from_numpy(host).cuda())
    af16 = FusedPipeline(af_sd, cfg, family="anchorfree")
    af32 = FusedPipeline(af_sd, cfg, family="anchorfree",
                         dtype=torch.float32)
    with torch.inference_mode():
        af16.detect(xs)
        fi.stem_s2d_bf16.launches = fi.span_bf16.launches = 0
        rows16 = rows_of(*af16.detect(xs))
        torch.cuda.synchronize()
        af_launches = {"stem_s2d_bf16": fi.stem_s2d_bf16.launches,
                       "span_bf16": fi.span_bf16.launches}
        check(af_launches == {"stem_s2d_bf16": 1, "span_bf16": per_batch - 1},
              f"anchor-free bf16 launches {af_launches}")
        fwd_af, p_af = fi.build_fused_forward(af_sd, dtype=b16,
                                              head="anchorfree")
        maps = fwd_af(xs, p_af)
        with plain_bf16():
            af_plain = rows_of(*af16.detect(xs))
            plain_maps = fwd_af(xs, p_af)
        rel = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(maps, plain_maps))
        check(rel <= BF16_MAP_RTOL, f"anchor-free bf16 maps {rel:.3g} of "
              f"their max |value| off the plain bf16 forward's")
        res_af = bf16_contract(rows16, af_plain, 0.3, 0.45,
                               ("kernels", "plain"))
        check(res_af[0] > 0, "anchor-free bf16: no detections")
        res_af32 = bf16_contract(rows16, rows_of(*af32.detect(xs)), 0.3,
                                 0.45)
        t16 = cuda_median_ms(lambda: af16.detect(xs))
        t32 = cuda_median_ms(lambda: af32.detect(xs))
    log(f"  anchor-free bf16 (80 classes, b128 352², phase 8d's seeded "
        f"model, whose dense near ties make detections a report, not a "
        f"gate): maps {rel:.3g} of their max |value| off the plain bf16 "
        f"forward's (≤ 2^-5); "
        + contract_line("against the plain bf16 path's", res_af, 128)
        + f", {len(res_af[3])} unexplained; "
        + contract_line("against f32 (not a gate)", res_af32, 128)
        + f", {len(res_af32[3])} unexplained; launches "
        f"{af_launches}; detect {t16:.3f} ms bf16, {t32:.3f} ms f32 "
        f"({128e3 / t16:.1f} / {128e3 / t32:.1f} img/s)")
    launches = {"stem_s2d_bf16": serve_launches["stem_s2d_bf16"],
                "span_bf16": serve_launches["span_bf16"],
                "stem_s2d8_bf16": flag_launches["stem_s2d8_bf16"],
                "s2span_bf16": flag_launches["s2span_bf16"],
                "stem_s2d_bf16@640": b6_launches}
    for name in out:
        base = name.split("@")[0]
        out[name] = out[name][:4] + (max(out[name][4], err[base]),
                                     out[name][5])
    return launches, out


# ------------------------------------------------ bf16 training (phase 10)

BF16_TRAIN_RTOL = 2.0 ** -6   # B8 bf16 outputs and every bf16 gradient
                              # against the plain versions, of max |value|
BF16_STEP_RTOL = 2.0 ** -5    # a bf16 step with the kernels against the
                              # same step on the plain versions
STATS_RTOL = 5e-5             # ghost statistics, per kind, of the largest
# step 1's gradients with the kernels against those on the plain versions,
# relative L2 over a group of leaves: a rounding or ReLU mask flipped in
# one layer spreads through the whole bf16 backward, so two correct paths
# stand far apart here (phase 10 prints it); a kernel that returned no
# gradient reads 1.  The kernels' own gradients are held on step 1's
# cotangents at BF16_TRAIN_RTOL.
STEP_GRAD_RL2 = 0.5


def span16_train_bound(b, c, h, w, nblk, g):
    """B8's bf16 form at one stage → ((ms, by), (ms, by)): the bytes of
    `span_train_bound` with the activations (x, out, the saved block
    inputs; dy and dx) at 2 bytes, the operations (the same MACs) at the
    bf16 tensor-core rate, since every product is bf16 × bf16."""
    mid = c // 2
    act = b * c * h * w
    nstats = nblk * 3 * (b // g) * 3 * mid
    nw = nblk * (2 * mid * mid + 15 * mid)
    ops = nblk * b * h * w * 2 * (2 * mid * mid + 9 * mid)
    return (bound(2 * (2 * act + nblk * act) + 4 * (nstats + nw), ops,
                  PEAK_BF16_TC_OPS_S),
            bound(2 * (2 * act + nblk * act) + 4 * (nstats + 2 * nw),
                  3 * ops, PEAK_BF16_TC_OPS_S))


def stem16_train_bound(b, h4, w4, g):
    """B7's bf16 form → ((ms, by), (ms, by)): the bytes of
    `stem_train_bound` with y (and dy) at 2 bytes, the operations at the
    bf16 tensor-core rate (bf16 weights times u8 pixels)."""
    npad = (h4 * w4 + 127) // 128 * 128
    ops = b * 24 * 4 * h4 * w4 * 27 * 2
    nbytes = (b * 48 * npad + 2 * b * 24 * h4 * w4
              + 4 * (648 + 48 + (b // g) * 24 * 3))
    return (bound(nbytes, ops, PEAK_BF16_TC_OPS_S),
            bound(nbytes, 2 * ops, PEAK_BF16_TC_OPS_S))


def median_step_ms(tr, batch, labels, mask) -> list:
    """5 training steps after 2 of warm-up, each by a CUDA-event pair →
    their ms, sorted."""
    import torch
    for _ in range(2):
        tr.step(batch, labels, mask)
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    evs[0].record()
    for i in range(5):
        tr.step(batch, labels, mask)
        evs[i + 1].record()
    torch.cuda.synchronize()
    return sorted(evs[i].elapsed_time(evs[i + 1]) for i in range(5))


def rel_err(got, want) -> float:
    """max |Δ| over max |want|."""
    w = want.float()
    return float((got.float() - w).abs().max() / w.abs().max().clamp_min(
        1e-30))


def phase_bf16_train(sd, photo, dev_pipe, card, f32_times):
    """10. bf16 training, the JAX package's training headline
    (`Trainer(Detector(dtype=bf16), compute_dtype=bf16, fused_backbone=
    True, fused_input_format="s2d_u8")`).  The bf16 forms of B8 and B7
    against their plain bf16 versions on the card: B8 at the three stages
    at b128 352² (the span blocks' real weights, `pick_train_group`'s
    groups), at stage 3 with the card tests' seeded weights (its backward
    held with the plain version's own spread, which the phase prints:
    `span16_backward_errs`), a small shape and `SPAN_TRAIN_EDGE`; B7 at
    b128 352² photo
    variants with the real stem weights at ghost group 1 and
    STEM_GROUPED, and two tie images (one with γ of both signs and 0);
    its bf16 form is `csrc/stem16_train.cu` (`stem16_train_plan`).
    B8's bf16 form is `csrc/span16_train.cu`: a cluster per ghost
    group, one launch forward and two backward a stage call
    (`span16_train_plan`); the backward's recomputed block outputs (z,
    written on request by `span16_backward_launch`) equal the forward's
    out and saved inputs bit for bit.  Bounds: B8's out, saved
    inputs, dx and weight gradients within BF16_TRAIN_RTOL of max |value|
    (the backward given the same dy, saved inputs and stats; the seeded
    stage 3's within twice the plain version's distance from its f64 sums
    where larger), the stats within STATS_RTOL; B7's y within one bf16
    ULP and bit for bit the plain conv, rounded BN + ReLU and pool with
    the kernel's stats, the pool windows' winners it saves (code, zw) bit
    for bit `stem16_winners_reference` of the plain conv, dW, dγ, dβ
    within BF16_TRAIN_RTOL; a second backward gives the same bits; each call's device launches are
    the plan's (`counted_split`: a profiler that drops records in every
    try is reported beside the wrapper's count).  Times at b128 (CUDA events): kernels, plain versions, the
    bounds, and cuDNN in bf16 for the same stride-1 blocks and stem
    (`Detector(dtype=bf16)`'s own modules), forward and backward.  Then
    the three Trainer modes in bf16 at b128 352² from the reference
    weights (default and --fused-backbone through `run_training(dtype=
    bf16)`, fused s2d through the Trainer; the s2d mode at STEM_GROUPED
    too): the bf16 kernels' counts go to 0 just before and are read just
    after (the f32 kernels must stay at 0); each fused bf16 step with the
    kernels against the same step on the plain versions: step 1's B8 and
    B7 backward calls, on the main path's own cotangents, against the
    plain versions on the same inputs within BF16_TRAIN_RTOL; step 1's
    gradients (the momentum buffers at LR 0) within STEP_GRAD_RL2 by
    group of leaves; after 2 steps the loss within BF16_STEP_RTOL
    relative, the parameters within BF16_STEP_RTOL of max |value|;
    ms/step, img/s and the device's busy share (torch.profiler), with
    phase 8b's f32 step beside (`f32_times`; None: the f32 Trainers are
    timed here, as `bf16_train_phase.py` runs it).
    → ({entry:
    launches}, {entry: (ms, plain_ms, bound_ms, bound_by, max |Δ|,
    library_ms)}) with entries span_train_fwd/bwd_bf16 and
    stem_train_fwd/bwd_bf16 (g1 and grouped)."""
    import torch
    import torch.nn.functional as F
    from torch_cases import (SPAN_TRAIN_EDGE, SPAN_TRAIN_FULL,
                             STEM_TRAIN_CASES, span16_backward_errs,
                             span_train_case, span_train_rel_errs,
                             stem_train_case)
    from fastdet_torch.cli.train import run_training
    from fastdet_torch.kernels import _build
    from fastdet_torch.config import Config
    from fastdet_torch.kernels import fused_train as ft
    from fastdet_torch.kernels import stem_train as stt
    from fastdet_torch.kernels.fold import STAGES
    from fastdet_torch.kernels.fused_infer import pack_images_s2d
    from fastdet_torch.models import Detector
    b16 = torch.bfloat16
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    det = Detector(80, 3, dtype=b16)
    det.load_state_dict(sd)
    det = det.cuda().train()
    reps = {c: (stage, r) for stage, r, c in STAGES}
    out = {}

    # ---- B8 bf16
    tot = {k: [0.0] * 6 for k in ("fwd", "bwd")}
    by_bytes = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}
    launches = {"fwd": [], "bwd": []}
    # the three stages with their real weights (timed), stage 3 with the
    # seeded weights of the card tests (ill-conditioned: its backward is
    # held with the plain version's own spread, `span16_backward_errs`), a
    # small shape and the edges of the plan
    span_cases = ([(c, True) for c in SPAN_TRAIN_FULL]
                  + [(SPAN_TRAIN_FULL[1], False), ((4, 48, 6, 7, 2, 2), False)]
                  + [(c, False) for c in SPAN_TRAIN_EDGE])
    lib16 = _build.load("span16_train", ft._SIGNATURES16)
    regs = [ln.strip() for ln in _build.build_log.get(
        "span16_train", {}).get("ptxas", "").splitlines()
        if "registers" in ln or "spill" in ln]
    if regs:
        log("  span16_train ptxas (fwd 24/48/96, bwd 24/48/96 and "
            "reduce_rows in the order built): " + " | ".join(regs))
    for case, full in span_cases:
        b, c, h, w, nblk, g = case
        x32, rows, dy32 = span_train_case(sum(case) + 1, b, c, h, w, nblk,
                                          "cuda")
        x, dy = x32.to(b16), dy32.to(b16)
        witness = b == 128 and not full
        if full:
            stage, r = reps[c]
            blocks = [getattr(det.backbone, f"stage{stage}_{i}")
                      for i in range(1, r)]
            rows = ft.pack_span_train_weights(blocks).detach().contiguous()
            check(ft.pick_train_group(b, (h * w + 127) // 128 * 128, c) == g,
                  f"ghost group of {case}")
        fo, xsave, stats = ft.span_train_forward_bf16(x, rows, g)
        ro, rxsave, rstats = ft.span_train_forward_reference(x, rows, g)
        torch.cuda.synchronize()
        check(fo.dtype == xsave.dtype == b16 and stats.dtype == torch.float32,
              f"B8 bf16 dtypes at {case}")
        f_err = max(rel_err(fo, ro), rel_err(xsave, rxsave))
        check(f_err <= BF16_TRAIN_RTOL, f"B8 bf16 forward {f_err:.3g} of "
              f"max |value| off at {case}")
        # the first block's stats within STATS_RTOL; later blocks' inputs
        # carry the roundings the two sides flipped before them
        s_err = max(rel_err(stats[0, :, :, j], rstats[0, :, :, j])
                    for j in range(3))
        s_all = max(rel_err(stats[:, :, :, j], rstats[:, :, :, j])
                    for j in range(3))
        check(s_err <= STATS_RTOL and s_all <= BF16_TRAIN_RTOL,
              f"B8 bf16 stats {s_err:.3g} (block 0), {s_all:.3g} (all) off "
              f"at {case}")
        dx, drows = ft.span_train_backward_bf16(dy, xsave, stats, rows, g)
        torch.cuda.synchronize()
        check(dx.dtype == b16 and drows.dtype == torch.float32,
              f"B8 bf16 backward dtypes at {case}")
        # the backward's recompute: each block's z bit for bit the
        # forward's (the next block input's second half, or out's)
        rec = torch.empty((nblk, b, c // 2, h, w), dtype=b16, device="cuda")
        ft.span16_backward_launch(dy, xsave, stats, rows, g, rec)
        torch.cuda.synchronize()
        nexts = [xsave[k + 1] for k in range(nblk - 1)] + [fo]
        check(all(torch.equal(rec[k], nexts[k][:, c // 2:])
                  for k in range(nblk)),
              f"B8 bf16 backward's recomputed z is not the forward's at "
              f"{case}")
        del rec, nexts
        plan16 = ft.span16_train_plan(b, c, h, w, nblk, g)
        occ = [lib16.fastdet_span16_train_clusters(b, c, h, w, nblk, g,
                                                   *plan16.args, k)
               for k in (0, 1)]
        check(min(occ) > 0 and [lib16.fastdet_span16_train_smem(
            c // 2, plan16.rows, w, plan16.ipc, plan16.cluster, k)
            for k in (0, 1)]
            == [plan16.smem_fwd, plan16.smem_bwd],
            f"B8 bf16 plan at {case}: active clusters {occ}, or shared "
            f"memory not the kernel's")
        held, (rdx, rdrows) = span16_backward_errs(
            (dx, drows), dy, xsave, stats, rows, g, witness)
        errs = [(k, e) for k, (e, _) in held.items()]
        off = {k: v for k, v in held.items() if v[0] > v[1]}
        b_err = max(e for _, e in errs)
        check(not off, f"B8 bf16 backward off at {case} (leaf: (err, "
              f"bound)): {off}")
        dx2, drows2 = ft.span_train_backward_bf16(dy, xsave, stats, rows, g)
        check(torch.equal(dx, dx2) and torch.equal(drows, drows2),
              f"B8 bf16 backward not deterministic at {case}")
        eq = float((fo == ro).float().mean())
        msg = (f"  span_train bf16 b={b} C={c} {h}x{w} nblk={nblk} g={g}: "
               f"out {rel_err(fo, ro):.3g} of max |out| ({eq:.5f} equal), "
               f"stats {s_err:.3g} (block 0; all {s_all:.3g}), backward "
               f"{b_err:.3g} (worst "
               f"{max(errs, key=lambda e: e[1])[0]}); recomputed z bit for "
               f"bit the forward's; cluster {plan16.cluster} ({plan16.bpi} "
               f"bands of {plan16.rows} rows an image, {plan16.ipc} images a "
               f"CTA, {plan16.ctas} CTAs), active clusters fwd {occ[0]}, bwd "
               f"{occ[1]}, smem fwd {plan16.smem_fwd} B, bwd "
               f"{plan16.smem_bwd} B")
        tot["fwd"][4] = max(tot["fwd"][4], float((fo.float() - ro.float())
                                                 .abs().max()))
        tot["bwd"][4] = max(tot["bwd"][4], float((dx.float() - rdx.float())
                                                 .abs().max()),
                            float((drows - rdrows).abs().max()))
        if witness:
            # the witness: the plain version against itself, in f64 sums
            # on the card and in f32 sums on the CPU
            p64 = ft.span_train_backward_reference(dy, xsave, stats, rows,
                                                   g, torch.float64)
            cpu = ft.span_train_backward_reference(
                dy.cpu(), xsave.cpu(), stats.cpu(), rows.cpu(), g)
            ours = dict(errs)
            spread = span_train_rel_errs(rdx, rdrows, *p64)
            cpu_card = span_train_rel_errs(*cpu, rdx.cpu(), rdrows.cpu())
            msg += "; seeded weights, of max |value|, " + ", ".join(
                f"{k}: kernel {ours[k]:.4g}, plain f32 vs f64 sums "
                f"{spread[k]:.4g}, plain CPU vs card {cpu_card[k]:.4g}"
                for k in sorted(ours, key=lambda k: -ours[k])[:3])
            del p64, cpu
        if not full:
            log(msg)
            continue
        ms_f = cuda_ms(lambda: ft.span_train_forward_bf16(x, rows, g), 10)
        ms_b = cuda_ms(lambda: ft.span_train_backward_bf16(
            dy, xsave, stats, rows, g), 10)
        pl_f = cuda_ms(lambda: ft.span_train_forward_reference(x, rows, g),
                       2, 1)
        pl_b = cuda_ms(lambda: ft.span_train_backward_reference(
            dy, xsave, stats, rows, g), 2, 1)
        seq = torch.nn.Sequential(*blocks)
        xg = x.clone().requires_grad_()
        lib_f = cuda_ms(lambda: seq(xg), 10)
        lib_fb = cuda_ms(lambda: seq(xg).backward(dy), 10)
        (bf, byf), (bb, byb) = span16_train_bound(b, c, h, w, nblk, g)
        for k, vals in (("fwd", (ms_f, pl_f, bf, lib_f)),
                        ("bwd", (ms_b, pl_b, bb, lib_fb - lib_f))):
            t = tot[k]
            t[0] += vals[0]
            t[1] += vals[1]
            t[2] += vals[2]
            t[5] += vals[3]
        by_bytes["fwd"][0 if byf == "bytes" else 1] += bf
        by_bytes["bwd"][0 if byb == "bytes" else 1] += bb
        log(msg + f"; kernels fwd {ms_f:.4f} ms, bwd {ms_b:.4f} ms; plain "
            f"fwd {pl_f:.3f} ms, bwd {pl_b:.3f} ms; bound fwd {bf:.4f} ms "
            f"({byf}), bwd {bb:.4f} ms ({byb}); cuDNN bf16 blocks (training "
            f"mode) fwd {lib_f:.4f} ms, fwd+bwd {lib_fb:.4f} ms")
        for k, fn, wrapper, want in (
                ("fwd", lambda: ft.span_train_forward_bf16(x, rows, g),
                 ft.span_train_forward_bf16, plan16.launches_fwd),
                ("bwd", lambda: ft.span_train_backward_bf16(
                    dy, xsave, stats, rows, g), ft.span_train_backward_bf16,
                 plan16.launches_bwd)):
            split, n, note = counted_split(fn, wrapper, f"B8 bf16 {k} at "
                                           f"{case}", want)
            if split is None:
                launches[k].append("not measured")
                continue
            launches[k].append(f"{n:g}")
            log(f"  B8 bf16 {k} split at C={c} (torch.profiler, ms per "
                f"call): " + split_text(split) + note)
        del xsave, rxsave, dx, rdx
    for k in ("fwd", "bwd"):
        t = tot[k]
        out[f"span_train_{k}_bf16"] = (
            t[0], t[1], t[2], "bytes" if by_bytes[k][0] >= by_bytes[k][1]
            else "operations", t[4], t[5])
    log(f"  B8 bf16 device launches per stage call forward "
        f"{' / '.join(launches['fwd'])}, backward "
        f"{' / '.join(launches['bwd'])} (the plan's)")

    # ---- B7 bf16
    fc = det.backbone.first_conv
    w_real = (fc.conv.weight * (1.0 / 255.0)).detach().contiguous()
    g_real, b_real = fc.bn.weight.detach(), fc.bn.bias.detach()
    photos = photo_variants(photo, 128, seed=31)
    bsz = len(photos)
    x_main = torch.from_numpy(pack_images_s2d(photos)).cuda()
    dy_main = torch.from_numpy(np.random.default_rng(32).normal(
        0.0, 1.0, (bsz, 24, 88, 88)).astype(np.float32)).cuda().to(b16)
    cases = [(f"b{bsz} 352² photos g={g}", x_main, w_real, g_real, b_real,
              dy_main, 88, 88, g) for g in (1, STEM_GROUPED)]
    for case in (STEM_TRAIN_CASES[3], STEM_TRAIN_CASES[6]):
        b, hgt, wid, g, tie, signed = case
        x, w_raw, gamma, beta, dy = stem_train_case(sum(case) + 1, b, hgt,
                                                    wid, tie, "cuda", signed)
        cases.append((f"b{b} {hgt}x{wid} g={g} ties"
                      f"{' γ±,0' if signed else ''}", x,
                      (w_raw * (1.0 / 255.0)).contiguous(), gamma, beta,
                      dy.to(b16), hgt // 4, wid // 4, g))
    img16 = (torch.from_numpy(photos).cuda().permute(0, 3, 1, 2).to(b16)
             / 255.0)

    def lib_stem():
        return F.max_pool2d(fc(img16), 3, 2, 1)

    lib_f = cuda_ms(lib_stem, 10)
    lib_fb = cuda_ms(lambda: lib_stem().backward(dy_main), 10)
    fc.zero_grad(set_to_none=True)
    lib7 = _build.load("stem16_train", stt._SIGNATURES16)
    plan7 = stt.stem16_train_plan(bsz, 88, 88, 1)
    check([lib7.fastdet_stem16_train_smem(k) for k in range(3)]
          == [plan7.smem_by_kernel[k] for k in (
              "stem16_gram_kernel", "stem16_emit_kernel",
              "stem16_bwd_kernel")],
          f"B7 bf16 plan's shared memory {plan7.smem_by_kernel} is not the "
          f"kernels'")
    regs = [ln.strip() for ln in _build.build_log.get(
        "stem16_train", {}).get("ptxas", "").splitlines()
        if "registers" in ln or "spill" in ln]
    if regs:
        log("  stem16_train ptxas (in the order built): " + " | ".join(regs))
    errs7 = [0.0, 0.0]
    for name, x, w, gamma, beta, dy, h4, w4, g in cases:
        y, stats, zw, code = stt.stem_train_forward_bf16(x, w, gamma, beta,
                                                         h4, w4, g)
        ry, rstats = stt.stem_train_forward_reference(x, w, gamma, beta, h4,
                                                      w4, g, True)
        torch.cuda.synchronize()
        ulps = bf16_ulps(y, ry)
        eq = float((y == ry).float().mean())
        s_err = max(rel_err(stats[..., k], rstats[..., k]) for k in range(3))
        check(y.dtype == b16 and ulps <= 1 and eq >= 0.99
              and s_err <= STATS_RTOL, f"B7 bf16 forward at {name}: y "
              f"{ulps:.3g} ULPs, {eq:.5f} equal, stats {s_err:.3g}")
        u = stt._conv(stt._image(x, h4, w4, w.dtype), stt._rounded(w, True))
        bn, _ = stt._bn_parts(u, stats, gamma, beta, g)
        check(torch.equal(y, F.max_pool2d(torch.relu(bn).to(b16), 3, 2, 1)),
              f"B7 bf16 y is not the plain rounded BN + ReLU + pool with the "
              f"kernel's stats at {name}")
        rcode, rzw = stt.stem16_winners_reference(u, stats, gamma, beta, g)
        check(torch.equal(code, rcode) and torch.equal(zw, rzw),
              f"B7 bf16 winners (code, zw) are not the plain route's of the "
              f"plain conv at {name}")
        del u, bn, rcode, rzw
        grads = stt.stem_train_backward_bf16(dy, x, stats, w, gamma, beta,
                                             h4, w4, g, zw, code)
        refs = stt.stem_train_backward_reference(dy, x, stats, w, gamma,
                                                 beta, h4, w4, g, True)
        torch.cuda.synchronize()
        b_rel = {leaf: rel_err(got, want) for leaf, got, want in
                 zip(("dW", "dgamma", "dbeta"), grads, refs)}
        check(max(b_rel.values()) <= BF16_TRAIN_RTOL,
              f"B7 bf16 backward at {name}: {b_rel}")
        again = stt.stem_train_backward_bf16(dy, x, stats, w, gamma, beta,
                                             h4, w4, g, zw, code)
        check(all(torch.equal(a, c) for a, c in zip(grads, again)),
              f"B7 bf16 backward not deterministic at {name}")
        errs7 = [max(errs7[0], float((y.float() - ry.float()).abs().max())),
                 max([errs7[1]] + [float((a - c).abs().max())
                                   for a, c in zip(grads, refs)])]
        msg = (f"  stem_train bf16 {name}: y {ulps:.3g} bf16 ULPs "
               f"({eq:.5f} equal; y bit for bit the plain rounded chain "
               f"with the kernel's stats, code and zw the plain winners), "
               f"stats {s_err:.3g}; backward of max |value|: "
               + ", ".join(f"{k} {v:.3g}" for k, v in b_rel.items()))
        if x is not x_main:
            log(msg)
            continue
        ms_f = cuda_ms(lambda: stt.stem_train_forward_bf16(
            x, w, gamma, beta, h4, w4, g), 10)
        ms_b = cuda_ms(lambda: stt.stem_train_backward_bf16(
            dy, x, stats, w, gamma, beta, h4, w4, g, zw, code), 10)
        pl_f = cuda_ms(lambda: stt.stem_train_forward_reference(
            x, w, gamma, beta, h4, w4, g, True), 2, 1)
        pl_b = cuda_ms(lambda: stt.stem_train_backward_reference(
            dy, x, stats, w, gamma, beta, h4, w4, g, True), 2, 1)
        (bf, byf), (bb, byb) = stem16_train_bound(bsz, h4, w4, g)
        key = "g1" if g == 1 else "grouped"
        out[f"stem_train_fwd_bf16_{key}"] = (ms_f, pl_f, bf, byf, 0.0,
                                             lib_f)
        out[f"stem_train_bwd_bf16_{key}"] = (ms_b, pl_b, bb, byb, 0.0,
                                             lib_fb - lib_f)
        log(msg + f"; kernels fwd {ms_f:.4f} ms, bwd {ms_b:.4f} ms; plain "
            f"fwd {pl_f:.3f} ms, bwd {pl_b:.3f} ms; bound fwd {bf:.4f} ms "
            f"({byf}), bwd {bb:.4f} ms ({byb}); cuDNN bf16 stem (conv, "
            f"training BN, ReLU, max_pool2d) fwd {lib_f:.4f} ms, fwd+bwd "
            f"{lib_fb:.4f} ms")
        plan = stt.stem16_train_plan(bsz, h4, w4, g)
        for k, fn, wrapper, names in (
                ("fwd", lambda: stt.stem_train_forward_bf16(
                    x, w, gamma, beta, h4, w4, g),
                 stt.stem_train_forward_bf16, plan.kernels_fwd),
                ("bwd", lambda: stt.stem_train_backward_bf16(
                    dy, x, stats, w, gamma, beta, h4, w4, g, zw, code),
                 stt.stem_train_backward_bf16, plan.kernels_bwd)):
            split, n, note = counted_split(fn, wrapper, f"B7 bf16 {k} at "
                                           f"{name}", len(names), names)
            if split is None:
                log(f"  B7 bf16 {k} split at g={g}: not measured")
                continue
            log(f"  B7 bf16 {k} split at g={g} (torch.profiler, ms per "
                f"call): " + split_text(split) + note)
    for key in list(out):
        if key.startswith("stem_train_"):
            e = errs7[0] if "_fwd_" in key else errs7[1]
            out[key] = out[key][:4] + (e,) + out[key][5:]

    # ---- the Trainer in bf16, three modes, b128 352²
    cfg = Config.from_file(DATA)
    bsz, steps = cfg.batch_size, 3
    images = photo_variants(photo, bsz, seed=21)
    labels, mask = eval_labels(dev_pipe(images), seed=21)
    images_s2d = pack_images_s2d(images)
    inputs = {"default": images, "fused": images, "fused_s2d": images_s2d}
    k16 = (ft.span_train_forward_bf16, ft.span_train_backward_bf16,
           stt.stem_train_forward_bf16, stt.stem_train_backward_bf16)
    k32 = (ft.span_train_forward, ft.span_train_backward,
           stt.stem_train_forward, stt.stem_train_backward)

    def batches(epoch):
        return [(images, labels, mask)] * steps

    trainers, step_launches = {}, {}
    for mode in ("default", "fused", "fused_s2d", "fused_s2d_grouped"):
        n = 2 if mode == "fused_s2d_grouped" else steps
        for k in k16 + k32:
            k.launches = 0
        if mode.startswith("fused_s2d"):
            tr = make_trainer(sd, cfg, "fused_s2d",
                              STEM_GROUPED if mode.endswith("grouped")
                              else None, dtype=b16)
            for _ in range(n):
                tr.step(images_s2d, labels, mask)
        else:
            tr = run_training(cfg, sd, batches,
                              fused_backbone=mode == "fused", device="cuda",
                              steps=n, steps_per_epoch=1, dtype=b16)
        torch.cuda.synchronize()
        c16 = [k.launches for k in k16]
        c32 = [k.launches for k in k32]
        want = ([0, 0] if mode == "default" else [3 * n] * 2) + (
            [n, n] if mode.startswith("fused_s2d") else [0, 0])
        check(c16 == want and c32 == [0] * 4, f"bf16 {mode}: bf16 launches "
              f"{c16}, want {want}; f32 kernel launches {c32}, want none")
        step_launches[mode] = c16
        params = list(tr.model.parameters())
        bufs = [tr.optimizer.state[p]["momentum_buffer"] for p in params]
        check(all(p.dtype == torch.float32 for p in params)
              and all(b.dtype == torch.float32 and bool(torch.isfinite(b)
                                                        .all())
                      for b in bufs)
              and max(float(b.abs().max()) for b in bufs) > 0,
              f"bf16 {mode}: parameters or momentum buffers not f32, "
              f"finite and filled")
        with torch.no_grad():                # 16 images: the stem group
            outs = tr._forward(inputs.get(mode, images_s2d)[:STEM_GROUPED])
        check(all(o.dtype == b16 for o in outs), f"bf16 {mode}: outputs "
              f"{[o.dtype for o in outs]}")
        m = {k: float(v) for k, v in tr.step(inputs.get(mode, images_s2d),
                                             labels, mask).items()}
        check(all(np.isfinite(v) for v in m.values()),
              f"bf16 {mode}: non-finite loss {m}")
        if mode != "fused_s2d_grouped":
            trainers[mode] = tr
        log(f"phase 10 train bf16 {mode}: {n} steps at b{bsz} 352²; bf16 "
            f"kernel launches (B8 fwd, bwd, B7 fwd, bwd) {c16}, f32 kernels "
            f"none; parameters and momentum f32, outputs bf16; step {n}: "
            f"LR:{m['lr']:f} CIou:{m['box']:f} Obj:{m['obj']:f} "
            f"Cls:{m['cls']:f} Total:{m['total']:f}")

    def plain_stem_forward(x, w, gamma, beta, h4, w4, g):
        y, stats = stt.stem_train_forward_reference(x, w, gamma, beta, h4,
                                                    w4, g, True)
        u = stt._conv(stt._image(x, h4, w4, w.dtype), stt._rounded(w, True))
        code, zw = stt.stem16_winners_reference(u, stats, gamma, beta, g)
        return y, stats, zw, code

    def plain_stem_backward(dy, x, stats, w, gamma, beta, h4, w4, g, zw,
                            code):
        return stt.stem_train_backward_reference(dy, x, stats, w, gamma,
                                                 beta, h4, w4, g, True)

    def recording(fn, calls):
        """fn, keeping each call's arguments and results (the wrapper
        takes the call's count: the wrappers count on their own name)."""
        def rec(*args):
            res = fn(*args)
            calls.append((args, res))
            return res
        rec.launches = 0
        return rec

    def grad_groups(got, want):
        """Relative L2 distance of two steps' momentum buffers (after
        step 1 at LR 0: that step's gradient plus the decay), over the
        span blocks' leaves (β2 apart: 0 in exact arithmetic), the stem's,
        the rest and all."""
        span = [f"backbone.stage{st}_{i}." for st, r, _ in STAGES
                for i in range(1, r)]
        sums = {k: [0.0, 0.0] for k in ("span", "stem", "other", "all")}
        for k, v in want.items():
            if "main_dw.bn.bias" in k or "proj_dw.bn.bias" in k:
                key = None
            elif any(k.startswith(p) for p in span):
                key = "span"
            else:
                key = "stem" if "first_conv" in k else "other"
            for kk in ((key, "all") if key else ("all",)):
                sums[kk][0] += float(((got[k] - v) ** 2).sum())
                sums[kk][1] += float((v ** 2).sum())
        return {k: (n / d) ** 0.5 for k, (n, d) in sums.items()}

    def run(mode, plain):
        """Two bf16 steps → (losses, momentum buffers after step 1, the
        parameters after step 2, the bf16 backward calls of step 1 with
        the kernels: ([B8 (args, results)], [B7 ...]))."""
        tr = make_trainer(sd, cfg, mode, dtype=b16)
        calls = ([], [])
        if plain:
            ft.span_train_forward_bf16 = ft.span_train_forward_reference
            ft.span_train_backward_bf16 = ft.span_train_backward_reference
            stt.stem_train_forward_bf16 = plain_stem_forward
            stt.stem_train_backward_bf16 = plain_stem_backward
        else:
            ft.span_train_backward_bf16 = recording(k16[1], calls[0])
            stt.stem_train_backward_bf16 = recording(k16[3], calls[1])
        try:
            losses = [float(tr.step(inputs[mode], labels, mask)["total"])]
            grads = {k: tr.optimizer.state[p]["momentum_buffer"].clone()
                     for k, p in tr.model.named_parameters()}
            if not plain:
                ft.span_train_backward_bf16 = k16[1]
                stt.stem_train_backward_bf16 = k16[3]
            losses.append(float(tr.step(inputs[mode], labels, mask)["total"]))
        finally:
            (ft.span_train_forward_bf16, ft.span_train_backward_bf16,
             stt.stem_train_forward_bf16, stt.stem_train_backward_bf16) = k16
        return losses, grads, {k: v.clone() for k, v in
                               tr.model.state_dict().items()
                               if "running" not in k}, calls

    for mode in ("fused", "fused_s2d"):
        la, ga, sa, calls = run(mode, False)
        lb, gb, sb, _ = run(mode, True)
        check(len(calls[0]) == 3 and len(calls[1]) == (mode == "fused_s2d"),
              f"bf16 {mode}: step 1 made {len(calls[0])} B8 and "
              f"{len(calls[1])} B7 backward calls")
        # step 1's kernel calls on the main path's own cotangents against
        # the plain versions on the same inputs, at the kernels' bounds
        held = []
        for args, res in calls[0]:
            errs, _ = span16_backward_errs(res, *args)
            worst = max(errs, key=lambda k: errs[k][0])
            held.append(f"B8 C={args[0].shape[1]} {errs[worst][0]:.3g} "
                        f"({worst})")
            check(all(e <= bound for e, bound in errs.values()),
                  f"bf16 {mode}: step 1's B8 backward at C="
                  f"{args[0].shape[1]} off its plain version: "
                  f"{ {k: v for k, v in errs.items() if v[0] > v[1]} }")
        for args, res in calls[1]:
            ref = stt.stem_train_backward_reference(*args[:9], True)
            rel = [rel_err(a, r) for a, r in zip(res, ref)]
            held.append("B7 dW, dγ, dβ "
                        + ", ".join(f"{e:.3g}" for e in rel))
            check(max(rel) <= BF16_TRAIN_RTOL, f"bf16 {mode}: step 1's B7 "
                  f"backward off its plain version: {rel}")
        del calls
        grel = grad_groups(ga, gb)
        loss_rel = max(abs(x - y) / abs(y) for x, y in zip(la, lb))
        p_rel = max(float((v - sb[k]).abs().max())
                    / max(float(sb[k].abs().max()), 1e-2)
                    for k, v in sa.items())
        log(f"  bf16 {mode} b{bsz}: step 1's backward calls against the "
            f"plain versions on the same inputs (of max |value|, each ≤ "
            f"2^-6): {'; '.join(held)}; 2 steps with the kernels against "
            f"the plain versions: loss rel {loss_rel:.3g}, parameters "
            f"{p_rel:.3g} of max |value| (each ≤ 2^-5); step 1's gradients "
            f"(momentum buffers), relative L2: "
            + ", ".join(f"{k} {v:.3g}" for k, v in grel.items())
            + f" (each ≤ {STEP_GRAD_RL2})")
        check(loss_rel <= BF16_STEP_RTOL and p_rel <= BF16_STEP_RTOL,
              f"bf16 {mode}: kernels against plain, losses {la} vs {lb}, "
              f"parameters {p_rel:.3g}")
        check(max(grel.values()) <= STEP_GRAD_RL2, f"bf16 {mode}: step 1's "
              f"gradients with the kernels against the plain versions: "
              f"{grel}")

    if f32_times is None:
        f32_times = {mode: median_step_ms(make_trainer(sd, cfg, mode),
                                          inputs[mode], labels, mask)[2]
                     for mode in inputs}
    times16 = {}
    for mode, tr in trainers.items():
        batch = inputs[mode]
        per = median_step_ms(tr, batch, labels, mask)
        prof = profile_device(lambda: tr.step(batch, labels, mask),
                              f"bf16 {mode} b{bsz} train steps", calls=3,
                              top=10)
        busy = None if prof is None else sum(prof.values())
        times16[mode] = per[2]
        f32 = f32_times[mode]
        log(f"  train step bf16 {mode} b{bsz} 352² ({card}): median "
            f"{per[2]:.3f} ms of 5 (CUDA events, spread {per[0]:.3f}-"
            f"{per[4]:.3f}), {bsz * 1e3 / per[2]:.1f} img/s; device busy "
            + ("not measured" if busy is None else
               f"{busy:.3f} ms, {busy / per[2]:.3f} of the step")
            + f"; f32 in the same run {f32:.3f} ms, "
            f"{bsz * 1e3 / f32:.1f} img/s")
    rates = " / ".join(f"{bsz * 1e3 / t:.1f}" for t in times16.values())
    log(f"phase 10 bf16 training: default {times16['default']:.3f} / fused "
        f"{times16['fused']:.3f} / fused s2d {times16['fused_s2d']:.3f} "
        f"ms/step ({rates} img/s), f32 {f32_times['default']:.3f} / "
        f"{f32_times['fused']:.3f} "
        f"/ {f32_times['fused_s2d']:.3f}; B8 bf16 fwd "
        f"{out['span_train_fwd_bf16'][0]:.4f} ms, bwd "
        f"{out['span_train_bwd_bf16'][0]:.4f} ms (3 stages); B7 bf16 g1 fwd "
        f"{out['stem_train_fwd_bf16_g1'][0]:.4f} ms, bwd "
        f"{out['stem_train_bwd_bf16_g1'][0]:.4f} ms ({card})")
    launches = {"span_train_fwd_bf16": step_launches["fused"][0],
                "span_train_bwd_bf16": step_launches["fused"][1],
                "stem_train_fwd_bf16_g1": step_launches["fused_s2d"][2],
                "stem_train_bwd_bf16_g1": step_launches["fused_s2d"][3],
                "stem_train_fwd_bf16_grouped":
                    step_launches["fused_s2d_grouped"][2],
                "stem_train_bwd_bf16_grouped":
                    step_launches["fused_s2d_grouped"][3]}
    return launches, out


# ------------------------------------------------ int8 PTQ (phase 11)

INT8 = os.path.join(REPO, "weights", "coco-int8.npz")
INT8_MACS = ("bf16", "int32")
INT8_SERVE = dict(conf_thres=0.3, iou_thres=0.4, max_nms=128)


def greedy_match(det_a, det_b):
    """The JAX package's matching for its int8 detection rule
    (tests/test_quant.py `_greedy_match`): greedy, class-aware, by xyxy
    IoU → the IoUs of the matches."""
    ious = []
    used = np.zeros(len(det_b), bool)
    for a in det_a:
        best, best_j = 0.0, -1
        for j, b in enumerate(det_b):
            if used[j] or int(a[5]) != int(b[5]):
                continue
            x1, y1 = max(a[0], b[0]), max(a[1], b[1])
            x2, y2 = min(a[2], b[2]), min(a[3], b[3])
            inter = max(x2 - x1, 0.0) * max(y2 - y1, 0.0)
            ua = ((a[2] - a[0]) * (a[3] - a[1])
                  + (b[2] - b[0]) * (b[3] - b[1]) - inter)
            iou = inter / ua if ua > 0 else 0.0
            if iou > best:
                best, best_j = iou, j
        if best_j >= 0:
            used[best_j] = True
            ious.append(best)
    return ious


def int8_rule(f32, q):
    """JAX's rule for int8 detections against the f32 model's
    (tests/test_quant.py::test_int8_detections_match_f32): counts within
    ±1, all but one matched within their class, every match at IoU
    ≥ 0.7.  → (holds, the matches' IoUs)."""
    ious = greedy_match(f32, q)
    return (abs(len(f32) - len(q)) <= 1
            and len(ious) >= min(len(f32), len(q)) - 1
            and all(i >= 0.7 for i in ious)), ious


def chain_check(got, want, what, rows=None):
    """Every op's int8 inputs and integer accumulators in the record `got`
    bit for bit those of `want` (its first `rows` images); the
    accumulators compared as values (f32 under the "bf16" MAC, int32
    under "int32").  → the number of op calls compared."""
    check(set(got) == set(want), f"{what}: ops {sorted(set(got) ^ set(want))}")
    calls = 0
    for name, pairs in got.items():
        check(len(pairs) == len(want[name]), f"{what}: {name} calls")
        for (xq, acc), (wxq, wacc) in zip(pairs, want[name]):
            if rows is not None:
                wxq, wacc = wxq[:rows], wacc[:rows]
            check(torch_equal(xq, wxq), f"{what}: {name} int8 input differs")
            check(torch_equal(acc.double(), wacc.double()),
                  f"{what}: {name} accumulator differs")
            calls += 1
    return calls


def torch_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(a, b.to(a.device))


def phase_int8(sd, photo, card, dev_pipe, images):
    """Int8 PTQ on the card: `weights/coco-int8.npz` through
    `forward_from` at b128 352² with both MACs, each op's int8 input and
    accumulator bit for bit between them and against the port's CPU run
    on the first 4 images; `calibrate` on the card against the CPU; the
    int8 detections at the serving point against the f32 model's by JAX's
    rule; `run_evaluation(int8=...)` on phase 7's images beside f32's,
    equal to the plain staged chain on the int8 maps; the forward's time
    for each MAC beside the f32 nn forward's.  rank_decode_nms's and
    nms_keep's launches are counted from 0 on the int8 serving detect and
    the int8 eval.  → (launches, {kernel: (ms, plain_ms, bound_ms,
    bound_by, max |Δ|)})."""
    import torch
    from torch_cases import ANCHORS, BOX_ULPS_CARD, IOU, NC, box_ulps, \
        staged_window
    from fastdet_torch import disable_tf32
    from fastdet_torch.cli.evaluation import PR_PASS, run_evaluation
    from fastdet_torch.config import Config
    from fastdet_torch.kernels import nms_kernel as nk
    from fastdet_torch.kernels import pp_fused
    from fastdet_torch.models import Detector
    from fastdet_torch.ops.postprocess import (_anchors_array, _geo_table,
                                               postprocess, rank_scores,
                                               rank_topk)
    from fastdet_torch.quant import (calibrate, fold_model, forward_from,
                                     load_quantized, quantize_weights)
    from fastdet_torch.quant.ptq import FloatOps, QuantOps, forward_folded
    disable_tf32(torch.device("cuda"))
    cfg = Config.from_file(DATA)
    qw, scales = load_quantized(INT8)
    check(len(qw) == 76, f"{INT8}: {len(qw)} ops")
    x = torch.from_numpy(photo_variants(photo, 128, seed=11)).cuda()
    fwd = {mac: forward_from(qw, scales, mac=mac) for mac in INT8_MACS}

    # ---- 1. both MACs at b128 352², every op bit for bit
    recs, outs = {}, {}
    for mac in INT8_MACS:
        recs[mac] = {}
        outs[mac] = fwd[mac](x, record=recs[mac])
    torch.cuda.synchronize()
    check(all(o.is_cuda and torch.isfinite(o).all() for o in outs["bf16"]),
          "int8 maps not finite or not on the card")
    check(all(torch.equal(a, b) for a, b in zip(*outs.values())),
          "the two MACs' maps differ")
    calls = chain_check(recs["int32"], recs["bf16"], "int32 against bf16")

    # ---- 2. the port's own CPU run on the first 4 images
    cpu_rec = {}
    cpu_out = forward_from(qw, scales, device="cpu")(x[:4].cpu(),
                                                     record=cpu_rec)
    chain_check(cpu_rec, recs["bf16"], "CPU against the card", rows=4)
    worst, bitwise = 0.0, True
    for a, b in zip(cpu_out, outs["bf16"]):
        a, b = a.numpy(), b[:4].cpu().numpy()
        bitwise &= bool(np.array_equal(a, b))
        mag = np.maximum(np.abs(a), np.abs(b))
        worst = max(worst, float((np.abs(a - b) / np.spacing(mag)).max()))
    check(worst <= 1, f"logits {worst} ULPs from the CPU run's")
    rescales = [(name, acc) for name, pairs in recs["bf16"].items()
                for _, acc in pairs]                   # for step 6
    del recs, cpu_rec
    log(f"phase 11 int8: coco-int8.npz ({len(qw)} ops) at b128 352² on "
        f"photo variants, MACs bf16 (f32 products) and int32 "
        f"(torch._int_mm): {calls} op calls' int8 inputs and accumulators "
        f"bitwise equal, maps bitwise equal; against the port's CPU run on "
        f"4 images every int8 input and accumulator bitwise, the logits "
        + ("bitwise" if bitwise else f"within {worst:g} ULP"))

    # ---- 3. calibration on the card against the CPU
    folded = fold_model(sd)
    cal = photo_variants(photo, 32, seed=12)
    t0 = time.perf_counter()
    s_card = calibrate(folded, cal, batch=8)
    cal_s = time.perf_counter() - t0
    s_cpu = calibrate(folded, cal, batch=8, device="cpu")
    max_ops = FloatOps(folded, record=True)
    with torch.inference_mode():
        for i in range(0, len(cal), 8):
            forward_folded(torch.from_numpy(cal[i:i + 8]).cuda(), max_ops)
    bins = {k: abs(s_card[k] - s_cpu[k]) / (float(m) / 2048 / 127)
            for k, m in max_ops.maxabs.items()}
    check(set(s_card) == set(s_cpu) == set(bins) and
          max(bins.values()) <= 1.001,
          f"calibration on the card {max(bins.values())} bins off the CPU's")
    same = sum(s_card[k] == s_cpu[k] for k in s_card)
    log(f"  calibrate (percentile, 32 photo variants, b8): {len(s_card)} "
        f"scales within {max(bins.values()):.3g} histogram bins of the CPU "
        f"run's ({same} equal), {cal_s:.2f} s on the card (host clock)")

    # ---- 4. detections at the serving point against the f32 model's
    anchors = np.asarray(cfg.anchors, np.float32).reshape(2, 3, 2)
    det = Detector(80, 3)
    det.load_state_dict(sd)
    det = det.cuda().eval()

    def serve(maps):
        d, n = postprocess(maps, anchors, (352, 352), **INT8_SERVE)
        return [r[:c] for r, c in zip(d.cpu().numpy(), n.cpu().numpy())]

    g = resize_u8(photo)[None]
    calg = np.concatenate([g] + [np.clip(g.astype(np.int32) * f // 4, 0,
                                         255).astype(np.uint8)
                                 for f in (3, 5)])
    models = {"coco-int8.npz": fwd["bf16"],
              "calibrated on the photo ×1, ×3/4, ×5/4 on the card":
                  forward_from(quantize_weights(folded),
                               calibrate(folded, calg))}
    with torch.inference_mode():
        gt = torch.from_numpy(g).cuda()
        want_g = serve(det(gt.float() / 255.0))[0]
        want_x = serve(det(x.float() / 255.0))
        check(len(want_g) > 0, "the f32 model found nothing on the photo")
        for what, f in models.items():
            got_g = serve(f(gt))[0]
            ok, ious = int8_rule(want_g, got_g)
            ious = [round(float(i), 3) for i in ious]
            check(ok, f"int8 ({what}) on the photo: {len(got_g)} detections "
                  f"against f32's {len(want_g)}, IoUs {ious}")
            if f is fwd["bf16"]:
                pp_fused.rank_decode_nms.launches = 0
                got_x = serve(f(x))
                b3 = pp_fused.rank_decode_nms.launches
                check(b3 == 1, f"int8 serving detect: {b3} B3 launches")
            else:
                got_x = serve(f(x))
            held = sum(int8_rule(a, b)[0] for a, b in zip(want_x, got_x))
            log(f"  int8 ({what}) at the serving point (conf 0.3, iou 0.4, "
                f"window 128): the photo {len(got_g)} detections against "
                f"f32's {len(want_g)}, IoUs {ious} (JAX's rule holds); on "
                f"the {len(want_x)} variants "
                f"{sum(map(len, got_x))} against {sum(map(len, want_x))}, "
                f"the rule holds on {held}")

    # ---- 5. eval: run_evaluation(int8=...) on phase 7's images
    labels, mask = eval_labels(dev_pipe(images), seed=7)
    bsz, n_batches = 128, -(-len(images) // 128)

    def batches(bs):
        for s in range(0, len(images), bs):
            yield images[s:s + bs], labels[s:s + bs], mask[s:s + bs]

    run_evaluation(cfg, None, batches, fused=False, device="cuda",
                   batch=bsz, int8=(qw, scales))                 # warm-up
    torch.cuda.synchronize()
    nk.keep_mask_batch.launches = pp_fused.rank_decode_nms.launches = 0
    t0 = time.perf_counter()
    res_map, res_pr = run_evaluation(cfg, None, batches, fused=False,
                                     device="cuda", batch=bsz,
                                     int8=(qw, scales))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    keep_n = nk.keep_mask_batch.launches
    check(keep_n == 2 * n_batches and pp_fused.rank_decode_nms.launches == 0,
          f"int8 eval: nms_keep {keep_n}, rank_decode_nms "
          f"{pp_fused.rank_decode_nms.launches} launches")
    check(res_map is not None and res_pr is not None, "int8 eval: nothing")
    plain = plain_eval(fwd["bf16"], images, labels, mask, bsz)
    check(plain == [res_map, res_pr], f"int8 eval {res_map} {res_pr} differs "
          f"from the plain staged chain's {plain}")
    f_map, f_pr = run_evaluation(cfg, sd, batches, fused=False,
                                 device="cuda", batch=bsz)
    q_vals = (res_pr[0], res_pr[1], res_map[2], res_pr[3])
    f_vals = (f_pr[0], f_pr[1], f_map[2], f_pr[3])
    log(f"  eval --int8 on phase 7's {len(images)} images (b{bsz}): "
        + " ".join(f"{k}:{v:f}" for k, v in zip(
            ("Precision", "Recall", "AP", "F1"), q_vals))
        + ", equal to the plain staged chain on the int8 maps; f32 "
        + " ".join(f"{k}:{v:f}" for k, v in zip(
            ("Precision", "Recall", "AP", "F1"), f_vals))
        + f"; {2 * len(images) / secs:.1f} img/s over both passes "
        f"({secs:.3f} s, host clock); nms_keep {keep_n} launches")

    # ---- 6. times at b128 352² (CUDA-event medians)
    with torch.inference_mode():
        ms = {mac: cuda_median_ms(lambda f=fwd[mac]: f(x)) for mac in
              INT8_MACS}
        f32_ms = cuda_median_ms(lambda: det(x.float() / 255.0))
    log(f"  int8 forward at b128 352² ({card}): bf16 MAC {ms['bf16']:.3f} "
        f"ms, int32 MAC {ms['int32']:.3f} ms, the f32 nn forward (cuDNN, "
        f"TF32 off) {f32_ms:.3f} ms (CUDA-event medians of 15)")
    for mac in INT8_MACS:
        with torch.inference_mode():
            profile_device(lambda f=fwd[mac]: f(x),
                           f"int8 forwards ({mac} MAC) at b128", calls=3,
                           top=10)
    # the rescales alone (acc·(sx·sw) + b in f64, rounded once), replayed
    # on the b128 forward's own accumulators
    ops = QuantOps(qw, scales)

    def rescale_all():
        for name, acc in rescales:
            ops._out(name, ops.ops[name], None, acc, relu=False)
    with torch.inference_mode():
        rescale_ms = cuda_median_ms(rescale_all)
    del rescales
    log(f"  of the bf16-MAC forward's {ms['bf16']:.3f} ms, its "
        f"{len(ops.ops) + 3} rescales take {rescale_ms:.3f} ms (replayed on "
        f"its accumulators, CUDA-event median of 15)")

    # ---- 7. B3 and nms_keep on the int8 path's own windows
    out = {}
    with torch.inference_mode():
        maps = outs["bf16"]
        ranked, reg_f, cls_f, meta = rank_scores(maps, (352, 352), 0.3)
        neg_k, combo_k = rank_topk(ranked, cls_f, nc=NC, k=128)
        geo = _geo_table(meta, tuple(_anchors_array(anchors).ravel()
                                     .tolist()), "cuda:0")
        args = (neg_k, combo_k, reg_f.contiguous(), geo)
        keep, boxes = pp_fused.rank_decode_nms(*args, nc=NC, iou_thres=IOU)
        rkeep, rboxes = pp_fused.rank_decode_nms_reference(*args, nc=NC,
                                                           iou_thres=IOU)
        check(torch.equal(keep, rkeep), "B3 keep differs on the int8 window")
        nb, rb = boxes.cpu().numpy(), rboxes.cpu().numpy()
        check(float(box_ulps(nb, rb).max()) <= BOX_ULPS_CARD,
              "B3 boxes off on the int8 window")

        def run_b3():
            return pp_fused.rank_decode_nms(*args, nc=NC, iou_thres=IOU)
        b3_ms = rdn_split(run_b3, "rank_decode_nms on the int8 b128 window",
                          128, 128)
        b3_plain = cuda_ms(lambda: pp_fused.rank_decode_nms_reference(
            *args, nc=NC, iou_thres=IOU), 10, 2)
        out["rank_decode_nms"] = (b3_ms, b3_plain, *rdn_bound(neg_k, combo_k),
                                  float(np.abs(nb - rb).max()))
        emaps = fwd["bf16"](images[:bsz])
        boxes, score, cls = staged_window(emaps, ANCHORS, (352, 352),
                                          conf_thres=PR_PASS["conf_thres"],
                                          max_nms=PR_PASS["max_nms"])
        valid = score > 0
        keep = nk.keep_mask_batch(boxes, cls, valid, iou_thres=NMS_IOU)
        want = nk.keep_mask_batch_reference(boxes, cls, valid,
                                            iou_thres=NMS_IOU)
        check(torch.equal(keep, want), "nms_keep differs on the int8 window")
        k_ms = cuda_ms(lambda: nk.keep_mask_batch(boxes, cls, valid,
                                                  iou_thres=NMS_IOU), 50, 5)
        k_plain = cuda_ms(lambda: nk.keep_mask_batch_reference(
            boxes, cls, valid, iou_thres=NMS_IOU), 2, 1)
        out["nms_keep"] = (k_ms, k_plain,
                           *nms_keep_bound(valid, PR_PASS["max_nms"]), 0.0)
    log(f"  on the int8 path's windows: rank_decode_nms (b128, k=128) "
        f"{b3_ms:.4f} ms a call (timed as the line above says), plain "
        f"{b3_plain:.3f} ms, keep equal;"
        f" nms_keep (b128, k=1024, conf 0.3, {int(valid.sum())} valid) "
        f"{k_ms:.4f} ms back to back, plain {k_plain:.3f} ms, keep equal")
    return {"rank_decode_nms": b3, "nms_keep": keep_n}, out


# ------------------------------------------------ convergence (phase 12)

# the configuration phase 12 gates with the convergence check at its
# defaults (600 steps of b32 128², seed 0): the training headline, bf16 in
# the fused s2d mode (B7 and B8 in bf16).  The default f32 mode's run
# would take the script past 450 s; the eight configurations of the
# check are run with the tool itself (README, PERF.md §2)
CONVERGENCE_NAME = ("yolo-fastestv2 --bf16 --fused-backbone --input-format "
                    "s2d_u8")
CONVERGENCE_KW = {"bf16": True, "fused_backbone": True,
                  "input_format": "s2d_u8"}


def phase_convergence(card):
    """12. Convergence on the card: `run_convergence` (the tool's entry
    point) at its defaults for `CONVERGENCE_KW`, held to the tool's bar
    (final mAP@0.5 over 0.5 and above step 0's), with the launches of B7,
    B8 (both dtypes) and B3 counted from 0 over the run; then, at the
    run's own shapes, B8 bf16 (the three stages at b32 128², ghost groups
    of 16; held on the card tests' seeded inputs and weights by the
    witness rule of `span16_backward_errs`, and, printed beside them, with
    the trained weights, timed), B7 bf16 (the run's first batch, the
    trained stem, group 1) and B3 (the trained model's eval window, b32
    k = 240) against their plain versions, with times, bounds and
    cuDNN's.  → (launches, kernel numbers)."""
    import torch
    import torch.nn.functional as F
    from fastdet_torch.kernels import fused_train as ft
    from fastdet_torch.kernels import pp_fused
    from fastdet_torch.kernels import stem_train as stt
    from fastdet_torch.kernels.fused_infer import pack_images_s2d
    from fastdet_torch.ops.postprocess import (_geo_table, rank_scores,
                                               rank_topk)
    from fastdet_torch.tools import convergence_check as cc
    from torch_cases import (BOX_ULPS_CARD, CONV_ANCHORS, CONV_K, CONV_NC,
                             SPAN_TRAIN_CONV, box_ulps, span16_backward_errs,
                             span_train_case, span_train_rel_errs)
    b16 = torch.bfloat16
    counted = (ft.span_train_forward, ft.span_train_backward,
               stt.stem_train_forward, stt.stem_train_backward,
               ft.span_train_forward_bf16, ft.span_train_backward_bf16,
               stt.stem_train_forward_bf16, stt.stem_train_backward_bf16,
               pp_fused.rank_decode_nms)
    for k in counted:
        k.launches = 0
    rec = {}
    aps = cc.run_convergence(device="cuda", record=rec, **CONVERGENCE_KW)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counted}
    ok = cc.converged(aps)
    log(f"phase 12 convergence, {CONVERGENCE_NAME}: AP curve "
        f"{[round(a, 4) for a in aps]}, {rec['seconds']:.1f} s of training "
        f"and eval ({rec['img_s']:.1f} img/s) on {card}; launches over the "
        f"run: {launches}; CONVERGENCE {'OK' if ok else 'FAILED'}")
    check(ok, f"{CONVERGENCE_NAME} failed the convergence bar: {aps}")
    check(all(launches[k.__name__] == 0 for k in counted[:4])
          and launches["rank_decode_nms"] == 2 * len(aps)
          and launches["span_train_forward_bf16"] == 3 * 600
          and launches["span_train_backward_bf16"] == 3 * 600
          and launches["stem_train_forward_bf16"] == 600
          and launches["stem_train_backward_bf16"] == 600,
          f"launches {launches}, want the bf16 B8 1800 and the bf16 B7 600 "
          f"each way, the f32 ones none, B3 2 an eval")
    model = rec["trainer"].model
    out = {}

    # ---- B8 bf16 at the run's three stages
    tot = {"fwd": [0.0] * 6, "bwd": [0.0] * 6}
    by = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}

    def span16_errs(x, rows, dy, g):
        fo, xsave, stats = ft.span_train_forward_bf16(x, rows, g)
        ro, rxsave, rstats = ft.span_train_forward_reference(x, rows, g)
        f_err = max(rel_err(fo, ro), rel_err(xsave, rxsave))
        s_err = max(rel_err(stats[0, :, :, j], rstats[0, :, :, j])
                    for j in range(3))
        dx, drows = ft.span_train_backward_bf16(dy, xsave, stats, rows, g)
        held, (rdx, rdrows) = span16_backward_errs(
            (dx, drows), dy, xsave, stats, rows, g, witness=True)
        err = (float((fo.float() - ro.float()).abs().max()),
               max(float((dx.float() - rdx.float()).abs().max()),
                   float((drows - rdrows).abs().max())))
        return f_err, s_err, held, err, (xsave, stats, dx, drows)

    for case in SPAN_TRAIN_CONV:
        b, c, h, w, nblk, g = case
        check(ft.pick_train_group(b, (h * w + 127) // 128 * 128, c) == g,
              f"ghost group of {case}")
        x32, seeded, dy32 = span_train_case(sum(case) + 1, b, c, h, w, nblk,
                                            "cuda")
        x, dy = x32.to(b16), dy32.to(b16)
        # held as the card tests hold it: seeded inputs and weights
        f_err, s_err, held, err, _ = span16_errs(x, seeded, dy, g)
        check(f_err <= BF16_TRAIN_RTOL and s_err <= STATS_RTOL,
              f"B8 bf16 forward at {case}: {f_err:.3g}, stats {s_err:.3g}")
        off = {k: v for k, v in held.items() if v[0] > v[1]}
        check(not off, f"B8 bf16 backward off at {case}: {off}")
        worst = max(held, key=lambda k: held[k][0])
        # the trained weights: printed with the plain version's own
        # distance from its f64 sums, and timed
        stage, reps = {48: (2, 4), 96: (3, 8), 192: (4, 4)}[c]
        blocks = [getattr(model.backbone, f"stage{stage}_{i}")
                  for i in range(1, reps)]
        rows = ft.pack_span_train_weights(blocks).detach().contiguous()
        t_f, t_s, t_held, _, (xsave, stats, dx, drows) = span16_errs(
            x, rows, dy, g)
        p64 = ft.span_train_backward_reference(dy, xsave, stats, rows, g,
                                               torch.float64)
        k64 = span_train_rel_errs(dx, drows, *p64)
        t_worst = max(t_held, key=lambda k: t_held[k][0] / t_held[k][1])
        log(f"  span_train bf16 at b{b} C={c} {h}x{w} g={g}: seeded (held): "
            f"out {f_err:.3g} of max |value|, stats {s_err:.3g}, backward "
            f"worst {worst} {held[worst][0]:.3g} (bound {held[worst][1]:.3g}"
            f"); the trained weights (printed): out {t_f:.3g}, stats "
            f"{t_s:.3g}, backward {t_worst}: kernel vs plain "
            f"{t_held[t_worst][0]:.4g} (witness bound "
            f"{t_held[t_worst][1]:.4g}, twice the plain version's f32 sums "
            f"from its f64 sums), kernel vs the plain version's f64 sums "
            f"{k64[t_worst]:.4g}")
        ms_f = cuda_ms(lambda: ft.span_train_forward_bf16(x, rows, g), 10)
        ms_b = cuda_ms(lambda: ft.span_train_backward_bf16(
            dy, xsave, stats, rows, g), 10)
        pl_f = cuda_ms(lambda: ft.span_train_forward_reference(x, rows, g),
                       2, 1)
        pl_b = cuda_ms(lambda: ft.span_train_backward_reference(
            dy, xsave, stats, rows, g), 2, 1)
        seq = torch.nn.Sequential(*blocks).train()
        xg = x.clone().requires_grad_()
        lib_f = cuda_ms(lambda: seq(xg), 10)
        lib_fb = cuda_ms(lambda: seq(xg).backward(dy), 10)
        seq.zero_grad(set_to_none=True)
        (bf, byf), (bb, byb) = span16_train_bound(b, c, h, w, nblk, g)
        log(f"    times (trained weights): kernels fwd {ms_f:.4f} ms, bwd "
            f"{ms_b:.4f} ms; plain {pl_f:.3f} / {pl_b:.3f} ms; bound "
            f"{bf:.4f} ({byf}) / {bb:.4f} ({byb}) ms; cuDNN bf16 blocks "
            f"fwd {lib_f:.4f}, fwd+bwd {lib_fb:.4f} ms")
        for k, vals, e, byk, bk in (
                ("fwd", (ms_f, pl_f, bf, lib_f), err[0], byf, bf),
                ("bwd", (ms_b, pl_b, bb, lib_fb - lib_f), err[1], byb, bb)):
            t = tot[k]
            t[0] += vals[0]
            t[1] += vals[1]
            t[2] += vals[2]
            t[4] = max(t[4], e)
            t[5] += vals[3]
            by[k][0 if byk == "bytes" else 1] += bk
        del xsave, stats, dx, drows, p64
    for k in ("fwd", "bwd"):
        t = tot[k]
        out[f"span_train_{k}_bf16"] = (
            t[0], t[1], t[2], "bytes" if by[k][0] >= by[k][1]
            else "operations", t[4], t[5])

    # ---- B7 bf16 on the run's first s2d batch, the trained stem
    images, _, _ = cc.make_batch(np.random.RandomState(0), 32)
    x = torch.from_numpy(pack_images_s2d(images)).cuda()
    fc = model.backbone.first_conv.train()
    w = (fc.conv.weight * (1.0 / 255.0)).detach().contiguous()
    gamma, beta = fc.bn.weight.detach(), fc.bn.bias.detach()
    dy = torch.from_numpy(np.random.default_rng(12).normal(
        0.0, 1.0, (32, 24, 32, 32)).astype(np.float32)).cuda().to(b16)
    y, stats, zw, code = stt.stem_train_forward_bf16(x, w, gamma, beta, 32,
                                                     32, 1)
    ry, rstats = stt.stem_train_forward_reference(x, w, gamma, beta, 32, 32,
                                                  1, True)
    ulps = bf16_ulps(y, ry)
    s_err = max(rel_err(stats[..., k], rstats[..., k]) for k in range(3))
    check(ulps <= 1 and s_err <= STATS_RTOL,
          f"B7 bf16 forward at b32 128²: y {ulps:.3g} ULPs, stats "
          f"{s_err:.3g}")
    grads = stt.stem_train_backward_bf16(dy, x, stats, w, gamma, beta, 32,
                                         32, 1, zw, code)
    refs = stt.stem_train_backward_reference(dy, x, stats, w, gamma, beta,
                                             32, 32, 1, True)
    b_rel = {leaf: rel_err(a, c) for leaf, a, c in
             zip(("dW", "dgamma", "dbeta"), grads, refs)}
    check(max(b_rel.values()) <= BF16_TRAIN_RTOL,
          f"B7 bf16 backward at b32 128²: {b_rel}")
    img16 = (torch.from_numpy(images).cuda().permute(0, 3, 1, 2).to(b16)
             / 255.0)

    def lib_stem():
        return F.max_pool2d(fc(img16), 3, 2, 1)

    lib_f = cuda_ms(lib_stem, 10)
    lib_fb = cuda_ms(lambda: lib_stem().backward(dy), 10)
    fc.zero_grad(set_to_none=True)
    ms_f = cuda_ms(lambda: stt.stem_train_forward_bf16(
        x, w, gamma, beta, 32, 32, 1), 10)
    ms_b = cuda_ms(lambda: stt.stem_train_backward_bf16(
        dy, x, stats, w, gamma, beta, 32, 32, 1, zw, code), 10)
    pl_f = cuda_ms(lambda: stt.stem_train_forward_reference(
        x, w, gamma, beta, 32, 32, 1, True), 2, 1)
    pl_b = cuda_ms(lambda: stt.stem_train_backward_reference(
        dy, x, stats, w, gamma, beta, 32, 32, 1, True), 2, 1)
    (bf, byf), (bb, byb) = stem16_train_bound(32, 32, 32, 1)
    e_f = float((y.float() - ry.float()).abs().max())
    e_b = max(float((a - c).abs().max()) for a, c in zip(grads, refs))
    out["stem_train_fwd_bf16"] = (ms_f, pl_f, bf, byf, e_f, lib_f)
    out["stem_train_bwd_bf16"] = (ms_b, pl_b, bb, byb, e_b, lib_fb - lib_f)
    log(f"  stem_train bf16 at b32 128² g=1 (the run's first batch, trained "
        f"stem): y {ulps:.3g} bf16 ULPs, stats {s_err:.3g}, backward "
        + ", ".join(f"{k} {v:.3g}" for k, v in b_rel.items())
        + f"; kernels fwd {ms_f:.4f} ms, bwd {ms_b:.4f} ms; plain "
        f"{pl_f:.3f} / {pl_b:.3f} ms; bound {bf:.4f} ({byf}) / {bb:.4f} "
        f"({byb}) ms; cuDNN bf16 stem fwd {lib_f:.4f}, fwd+bwd "
        f"{lib_fb:.4f} ms")

    # ---- B3 on the trained model's eval window (its outputs in f32, as
    # its detect casts them)
    model.eval()
    ev_images, _, _ = cc.eval_set()
    with torch.inference_mode():
        outs = [o.float() for o in model(
            torch.from_numpy(ev_images[:32]).cuda().float() / 255.0)]
        ranked, reg_f, cls_f, meta = rank_scores(outs, (128, 128), 0.05)
        neg_k, combo_k = rank_topk(ranked, cls_f, nc=CONV_NC,
                                   k=min(1024, ranked.shape[1]))
    check(neg_k.shape == (32, CONV_K), f"eval window {tuple(neg_k.shape)}")
    geo = _geo_table(meta, tuple(CONV_ANCHORS.ravel().tolist()), "cuda")
    reg_f = reg_f.contiguous()
    args = (neg_k, combo_k, reg_f, geo)
    keep, boxes = pp_fused.rank_decode_nms(*args, nc=CONV_NC, iou_thres=0.45)
    rkeep, rboxes = pp_fused.rank_decode_nms_reference(*args, nc=CONV_NC,
                                                       iou_thres=0.45)
    ulp = float(box_ulps(boxes.cpu().numpy(), rboxes.cpu().numpy()).max())
    check(torch.equal(keep, rkeep) and ulp <= BOX_ULPS_CARD,
          f"B3 on the eval window: keep equal {torch.equal(keep, rkeep)}, "
          f"boxes {ulp} ULPs")
    ms = cuda_ms(lambda: pp_fused.rank_decode_nms(*args, nc=CONV_NC,
                                                  iou_thres=0.45), 20)
    pl = cuda_ms(lambda: pp_fused.rank_decode_nms_reference(
        *args, nc=CONV_NC, iou_thres=0.45), 3, 1)
    bd, byd = rdn_bound(neg_k, combo_k, CONV_NC)
    err = float(np.nan_to_num(np.abs(boxes.cpu().numpy()
                                     - rboxes.cpu().numpy())).max())
    out["rank_decode_nms"] = (ms, pl, bd, byd, err)
    log(f"  rank_decode_nms on the trained model's eval window (b32 k=240, "
        f"{int((neg_k < 0).sum())} valid, {int(keep.sum())} kept): keep "
        f"bit for bit, boxes ≤ {ulp:.3g} ULPs; {ms:.4f} ms back to back, "
        f"plain {pl:.3f} ms, bound {bd:.6f} ms ({byd})")
    return launches, out


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    for path in (REPO, os.path.join(REPO, "tests")):
        if path not in sys.path:
            sys.path.insert(0, path)
    import fastdet_torch  # noqa: F401 — fails outside the repository

    t_start = time.perf_counter()
    laps = [("start", t_start)]

    def lap(name):
        laps.append((name, time.perf_counter()))

    card = phase_device()
    lap("1")
    err_classes = phase_kernels()
    lap("2")
    err_nms = phase_nms_keep()
    lap("2c")
    photo = read_png_bgr(PHOTO)
    sd = phase_weights_forward(photo)
    lap("3")
    fused_err = phase_fused_kernels(sd)
    lap("2b")
    flag_err = phase_flag_kernels(sd)
    lap("2d")
    phase_fused_forward(sd, photo)
    lap("3b")
    launches, big, dev_pipe, images = phase_serving(sd, photo, card)
    ms, plain_ms, bound_ms, bound_by, err_main = main_path_kernel_timing(
        sd, big)
    lap("4")
    fused_pipe, fused_launches = phase_fused_serving(sd, dev_pipe, images)
    fused_main = phase_fused_timing(sd, dev_pipe, fused_pipe, big, card)
    lap("4b")
    flag_launches, flag_main = phase_flag_paths(sd, photo, fused_pipe, card)
    lap("4c")
    for t in threading.enumerate():         # request handlers finishing
        if t is not threading.main_thread():
            t.join(timeout=10)
    alive = [t.name for t in threading.enumerate()
             if t is not threading.main_thread()]
    check(not alive, f"threads still running: {alive}")
    log("phase 5 shutdown: server stopped, batcher closed, no threads left")
    eval_launches, eval_nms, eval_images = phase_eval(sd, photo, dev_pipe,
                                                      card)
    lap("7")
    b6_launches, b6 = phase_640(sd, photo, card)
    lap("7b")
    b8 = phase_span_train(sd, card)
    lap("8a")
    b7 = phase_stem_train(sd, photo, card)
    lap("8c")
    train_launches, train_times = phase_training(sd, photo, dev_pipe, card,
                                                 b8, b7)
    lap("8b")
    af_launches, af_sd = phase_anchorfree(photo, card, eval_images)
    lap("8d")
    bf16_launches, bf16_main = phase_bf16(sd, photo, card, images, big,
                                          fused_pipe, af_sd)
    lap("9")
    train16_launches, train16 = phase_bf16_train(sd, photo, dev_pipe, card,
                                                 train_times)
    lap("10")
    int8_launches, int8_main = phase_int8(sd, photo, card, dev_pipe,
                                          eval_images)
    lap("11")
    conv_launches, conv_main = phase_convergence(card)
    lap("12")
    log('phase 6 kernels: ["stem_s2d", "span", "rank_decode_nms", '
        '"nms_keep", "span_train", "stem_train", "stem_s2d8", "s2span"] '
        f'(rank_decode_nms launches on the device path: {launches}; '
        f'nms_keep on the eval path: {eval_launches}; stem_s2d8 and s2span '
        f'on the flag paths: {flag_launches["stem_s2d8"]}, '
        f'{flag_launches["s2span"]}; stem_s2d and span on the anchor-free '
        f'path: {af_launches["stem_s2d"]}, {af_launches["span"]}); the bf16 '
        f'kernels stem_s2d_bf16 and span_bf16 on the bf16 serving path, '
        f'stem_s2d8_bf16 and s2span_bf16 on its flag paths, stem_s2d_bf16 '
        f'at 640²: {bf16_launches}; the bf16 training kernels on the bf16 '
        f'training paths: {train16_launches}; rank_decode_nms and '
        f'nms_keep on the int8 path: {int8_launches["rank_decode_nms"]}, '
        f'{int8_launches["nms_keep"]}; the convergence runs: '
        f'{conv_launches}')
    log("phase times (host clock, s): " + ", ".join(
        f"{name} {t - laps[i][1]:.1f}"
        for i, (name, t) in enumerate(laps[1:]))
        + f"; profiler sessions {PROFILES['sessions']}, "
        f"{PROFILES['retaken']} of them taken again")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    kernels = []
    for name, replaces in (("stem_s2d", "fastdet/kernels/fused_infer.py:418"),
                           ("span", "fastdet/kernels/fused_infer.py:219")):
        k_ms, k_plain, k_bound, k_by, k_err = fused_main[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"fastdet_torch/csrc/{name}.cu", "replaces": replaces,
            "launches": fused_launches[name],
            "max_abs_err": max(fused_err[name], k_err), "ms": k_ms,
            "plain_ms": k_plain, "bound_ms": k_bound, "bound_by": k_by,
            "library_ms": None})
    kernels.append({
        "name": "rank_decode_nms", "route": "cuda",
        "source": "fastdet_torch/csrc/pp_fused.cu",
        "replaces": "fastdet/kernels/pp_fused.py:156",
        "launches": fused_launches["rank_decode_nms"],
        "max_abs_err": max(err_classes, err_main),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None})
    # nms_keep replaces B4 (k ≤ 512) and B5 (k > 512): one entry each,
    # timed at k = 512 and k = 1815; its launches are the eval path's
    for k, replaces in ((512, "fastdet/kernels/nms_kernel.py:256"),
                        (1815, "fastdet/kernels/nms_kernel.py:201")):
        k_ms, k_plain, k_bound, k_by, k_err = eval_nms[k]
        kernels.append({
            "name": "nms_keep", "route": "cuda",
            "source": "fastdet_torch/csrc/nms_keep.cu", "replaces": replaces,
            "launches": eval_launches, "max_abs_err": max(err_nms, k_err),
            "ms": k_ms, "plain_ms": k_plain, "bound_ms": k_bound,
            "bound_by": k_by, "library_ms": None})
    # B6 (the row-chunked stem for > 8192 lanes) is B1's kernel at 640²
    k_ms, k_plain, k_bound, k_by, k_err = b6
    kernels.append({
        "name": "stem_s2d", "route": "cuda",
        "source": "fastdet_torch/csrc/stem_s2d.cu",
        "replaces": "fastdet/kernels/fused_infer.py:466",
        "launches": b6_launches, "max_abs_err": k_err, "ms": k_ms,
        "plain_ms": k_plain, "bound_ms": k_bound, "bound_by": k_by,
        "library_ms": None})
    # B8: forward and backward, launches from the fused training run,
    # times summed over the three stages of one b128 352² step
    for (name, replaces), key, n in zip(
            (("span_train_fwd", "fastdet/kernels/fused_train.py:329"),
             ("span_train_bwd", "fastdet/kernels/fused_train.py:362")),
            ("fwd", "bwd"), train_launches["fused"]["b8"]):
        k_ms, k_plain, k_bound, k_by, k_err, k_lib = b8[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fastdet_torch/csrc/span_train.cu",
            "replaces": replaces, "launches": n, "max_abs_err": k_err,
            "ms": k_ms, "plain_ms": k_plain, "bound_ms": k_bound,
            "bound_by": k_by, "library_ms": k_lib})
    # B7: one CUDA design for the JAX package's four sites, the group-1
    # pair (launches from the s2d run at the default group 1) and the
    # grouped pair (from the s2d run at STEM_GROUPED); b128 352² times
    for (name, replaces), key, mode, idx in (
            (("stem_train_fwd", "fastdet/kernels/stem_train.py:462"), "g1",
             "fused_s2d", 0),
            (("stem_train_bwd", "fastdet/kernels/stem_train.py:490"), "g1",
             "fused_s2d", 1),
            (("stem_train_fwd", "fastdet/kernels/stem_train.py:519"),
             "grouped", "fused_s2d_grouped", 0),
            (("stem_train_bwd", "fastdet/kernels/stem_train.py:549"),
             "grouped", "fused_s2d_grouped", 1)):
        k_ms, k_plain, k_bound, k_by, k_err, k_lib = b7[key][
            ("fwd", "bwd")[idx]]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fastdet_torch/csrc/stem_train.cu",
            "replaces": replaces,
            "launches": train_launches[mode]["b7"][idx],
            "max_abs_err": k_err, "ms": k_ms, "plain_ms": k_plain,
            "bound_ms": k_bound, "bound_by": k_by, "library_ms": k_lib})
    # B10 and B9 on the flag paths: launches over the five combinations
    # of phase 4c, times at b128 352² (B9's summed over the three stages)
    for name, replaces in (
            ("stem_s2d8", "fastdet/kernels/fused_infer.py:622"),
            ("s2span", "fastdet/kernels/fused_infer.py:241")):
        k_ms, k_plain, k_bound, k_by, k_err = flag_main[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"fastdet_torch/csrc/{name}.cu", "replaces": replaces,
            "launches": flag_launches[name],
            "max_abs_err": max(flag_err[name], k_err), "ms": k_ms,
            "plain_ms": k_plain, "bound_ms": k_bound, "bound_by": k_by,
            "library_ms": None})
    # the bf16 forms (phase 9): B1 and B2 launches from the bf16 serving
    # path, B10 and B9 from its flag paths, B6 from FusedPipeline at 640²;
    # b128 352² times (b32 640² for B6), B2's and B9's summed over the
    # three stages; library_ms is cuDNN in bf16 on the same inputs
    for name, key, source, replaces in (
            ("stem_s2d_bf16", "stem_s2d_bf16", "stem_s2d",
             "fastdet/kernels/fused_infer.py:422"),
            ("stem_s2d_bf16", "stem_s2d_bf16@640", "stem_s2d",
             "fastdet/kernels/fused_infer.py:466"),
            ("span_bf16", "span_bf16", "span",
             "fastdet/kernels/fused_infer.py:223"),
            ("s2span_bf16", "s2span_bf16", "s2span",
             "fastdet/kernels/fused_infer.py:241"),
            ("stem_s2d8_bf16", "stem_s2d8_bf16", "stem_s2d8",
             "fastdet/kernels/fused_infer.py:622")):
        k_ms, k_plain, k_bound, k_by, k_err, k_lib = bf16_main[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"fastdet_torch/csrc/{source}.cu",
            "replaces": replaces, "launches": bf16_launches[key],
            "max_abs_err": k_err, "ms": k_ms, "plain_ms": k_plain,
            "bound_ms": k_bound, "bound_by": k_by, "library_ms": k_lib})
    # the bf16 training forms (phase 10): launches from the bf16 fused run
    # (B8) and the bf16 s2d runs at group 1 and STEM_GROUPED (B7); b128
    # 352² times, B8's summed over the three stages; library_ms is cuDNN
    # in bf16 on the same inputs
    for name, key, source, replaces in (
            ("span_train_fwd_bf16", "span_train_fwd_bf16", "span16_train",
             "fastdet/kernels/fused_train.py:329"),
            ("span_train_bwd_bf16", "span_train_bwd_bf16", "span16_train",
             "fastdet/kernels/fused_train.py:362"),
            ("stem_train_fwd_bf16", "stem_train_fwd_bf16_g1",
             "stem16_train", "fastdet/kernels/stem_train.py:462"),
            ("stem_train_bwd_bf16", "stem_train_bwd_bf16_g1",
             "stem16_train", "fastdet/kernels/stem_train.py:490"),
            ("stem_train_fwd_bf16", "stem_train_fwd_bf16_grouped",
             "stem16_train", "fastdet/kernels/stem_train.py:519"),
            ("stem_train_bwd_bf16", "stem_train_bwd_bf16_grouped",
             "stem16_train", "fastdet/kernels/stem_train.py:549")):
        k_ms, k_plain, k_bound, k_by, k_err, k_lib = train16[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"fastdet_torch/csrc/{source}.cu",
            "replaces": replaces, "launches": train16_launches[key],
            "max_abs_err": k_err, "ms": k_ms, "plain_ms": k_plain,
            "bound_ms": k_bound, "bound_by": k_by, "library_ms": k_lib})
    # the int8 path (phase 11): B3 on its serving detect (k = 128), and
    # nms_keep (B5's site, k = 1024) on its eval; times on its windows
    for name, source, replaces in (
            ("rank_decode_nms", "pp_fused", "fastdet/kernels/pp_fused.py:156"),
            ("nms_keep", "nms_keep", "fastdet/kernels/nms_kernel.py:201")):
        k_ms, k_plain, k_bound, k_by, k_err = int8_main[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"fastdet_torch/csrc/{source}.cu",
            "replaces": replaces, "launches": int8_launches[name],
            "max_abs_err": k_err, "ms": k_ms, "plain_ms": k_plain,
            "bound_ms": k_bound, "bound_by": k_by, "library_ms": None})
    # the convergence runs (phase 12): launches over both runs (B3 over
    # their evals, the bf16 B8 and B7 over the fused s2d run); times at the
    # runs' own shapes (b32 128²) with the trained weights
    for name, wrapper, source, replaces in (
            ("span_train_fwd_bf16", "span_train_forward_bf16",
             "span16_train", "fastdet/kernels/fused_train.py:329"),
            ("span_train_bwd_bf16", "span_train_backward_bf16",
             "span16_train", "fastdet/kernels/fused_train.py:362"),
            ("stem_train_fwd_bf16", "stem_train_forward_bf16",
             "stem16_train", "fastdet/kernels/stem_train.py:462"),
            ("stem_train_bwd_bf16", "stem_train_backward_bf16",
             "stem16_train", "fastdet/kernels/stem_train.py:490")):
        k_ms, k_plain, k_bound, k_by, k_err, k_lib = conv_main[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"fastdet_torch/csrc/{source}.cu",
            "replaces": replaces, "launches": conv_launches[wrapper],
            "max_abs_err": k_err, "ms": k_ms, "plain_ms": k_plain,
            "bound_ms": k_bound, "bound_by": k_by, "library_ms": k_lib})
    k_ms, k_plain, k_bound, k_by, k_err = conv_main["rank_decode_nms"]
    kernels.append({
        "name": "rank_decode_nms", "route": "cuda",
        "source": "fastdet_torch/csrc/pp_fused.cu",
        "replaces": "fastdet/kernels/pp_fused.py:156",
        "launches": conv_launches["rank_decode_nms"], "max_abs_err": k_err,
        "ms": k_ms, "plain_ms": k_plain, "bound_ms": k_bound,
        "bound_by": k_by, "library_ms": None})
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
