#!/usr/bin/env python3
"""Smoke run of fastdet_torch on one NVIDIA card (the quickest proof that
the port still starts on the GPU).

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card.  It builds the
port's CUDA kernels from `fastdet_torch/csrc/`, holds each against its
plain PyTorch version, checks the weights and the forward, serves real
requests through `InferenceServer` over `DevicePipeline` and checks the
answers.  One line per phase; any failed check ends the run with a
non-zero exit.  Without a card, or outside the repository, it exits
non-zero and prints no result.

Phases:
  1. device: card name and power limit, kernel build time and ptxas info;
  2. kernels against their plain versions at every shape class the port
     dispatches (B ∈ {1, 128}, k ∈ {128, 256, 384}, N = 1815, nc = 80);
  3. weights through the carrier, forward on the card (TF32 off) against
     the same forward on the CPU, ≤ 2e-4;
  4. serving: ≥ 8 concurrent raw requests through the HTTP server, each
     answer equal to `DevicePipeline` on the same batch; a conf-0.01 batch
     that fills the 128-wide NMS window, against the CPU pipeline; the
     b128 throughput;
  5. shutdown: server, batcher and threads;
  6. the kernel summary (a JSON line), the card line, and the last line
     {"ok": true, "device": {...}}.

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

WATCHDOG_S = 600          # a hang becomes a traceback and exit 1
REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "data", "coco.data")
WEIGHTS = os.path.join(REPO, "weights", "coco2017-ref.npz")
PHOTO = os.path.join(REPO, "test_result.png")

# the card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12

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


def photo_variants(photo: np.ndarray, count: int, seed: int) -> np.ndarray:
    """Seeded crops (60-100% of each side) and mirror images of the photo,
    at 352²: real scenes, so that the model detects things."""
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
        out.append(resize_u8(crop))
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


def rdn_bound(neg_k, combo_k):
    """Least time for rank_decode_nms on these inputs: bytes it must move
    (sort keys, gathered reg rows (16 B) and the distinct geometry rows it
    reads (20 B), keep (1 B) and boxes (16 B) out) over the memory rate,
    and its f32 operations (≈40 per candidate decode, 14 per IoU against
    a valid higher-ranked candidate) over the f32 rate.  → (ms, by)."""
    from torch_cases import NC
    b, k = neg_k.shape
    valid = (neg_k < 0).cpu().numpy()
    # pairs (i, j) with j < i and j valid, per image
    pairs = int((np.cumsum(valid, axis=1) - valid).sum())
    n_geo = int(np.unique((combo_k // NC).cpu().numpy()).size)
    nbytes = b * k * (4 + 4 + 16 + 1 + 16) + n_geo * 20
    ops = b * k * 40 + pairs * 14
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


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
    _build.build("pp_fused")
    build_s = time.perf_counter() - t0
    log(f"phase 1 device: {torch.cuda.get_device_name(0)} | nvidia-smi: "
        f"{card} | python {sys.version.split()[0]} torch {torch.__version__}"
        f" cuda {torch.version.cuda} | nvcc {_build.nvcc_path()} | ninja "
        f"{shutil.which('ninja')} | kernel build {build_s:.2f} s")
    for name, info in _build.build_log.items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return card


def phase_kernels():
    import torch
    from torch_cases import (BOX_ULPS_CARD, IOU, NC, box_ulps, make_inputs,
                             port_geo)
    from fastdet_torch.kernels import pp_fused
    geo = port_geo("cuda:0")
    max_err, bitwise = 0.0, True
    for b in (1, 128):
        for k in (128, 256, 384):
            for case in ("dense", "sparse", "clustered"):
                args = [torch.from_numpy(a).cuda() for a in
                        make_inputs(k + b, b, k, case)] + [geo]
                keep, boxes = pp_fused.rank_decode_nms(
                    *args, nc=NC, iou_thres=IOU)
                rkeep, rboxes = pp_fused.rank_decode_nms_reference(
                    *args, nc=NC, iou_thres=IOU)
                torch.cuda.synchronize()
                nb, rb = boxes.cpu().numpy(), rboxes.cpu().numpy()
                ulps = float(box_ulps(nb, rb).max())
                n_valid = int((args[0] < 0).sum())
                n_keep = int(keep.sum())
                check(torch.equal(keep, rkeep),
                      f"keep differs at b={b} k={k} {case}")
                check(ulps <= BOX_ULPS_CARD,
                      f"boxes {ulps} ULPs off at b={b} k={k} {case}")
                check(0 < n_keep < n_valid,
                      f"trivial case b={b} k={k} {case}: {n_keep}/{n_valid}")
                max_err = max(max_err, float(np.abs(nb - rb).max()))
                bitwise &= bool(np.array_equal(nb, rb))
                run = (lambda a=args: pp_fused.rank_decode_nms(
                    *a, nc=NC, iou_thres=IOU))
                plain = (lambda a=args: pp_fused.rank_decode_nms_reference(
                    *a, nc=NC, iou_thres=IOU))
                ms, plain_ms = cuda_ms(run, 50), cuda_ms(plain, 3, 1)
                log(f"  rank_decode_nms b={b} k={k} {case}: keep equal "
                    f"({n_keep}/{n_valid} kept), boxes {ulps:g} ULPs, "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms")
    log(f"phase 2 kernels: rank_decode_nms equals its plain version at 18 "
        f"shape classes; boxes bitwise: {bitwise}, max |Δ| {max_err:g}")
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
    log(f"phase 3 weights+forward: {n} floats carried; 6 NHWC outputs "
        f"{[tuple(o.shape) for o in out]}; card vs CPU max |Δ| {err:.3g} "
        f"(≤ 2e-4, TF32 off)")
    return sd


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


def phase_serving(sd, photo, card):
    import torch
    from fastdet_torch.config import Config, load_names, resolve_path
    from fastdet_torch.kernels import pp_fused
    from fastdet_torch.models import Detector
    from fastdet_torch.ops.postprocess import rank_scores
    from fastdet_torch.serve import DevicePipeline
    from fastdet_torch.server import InferenceServer

    cfg = Config.from_file(DATA)
    names = load_names(resolve_path(cfg.names, DATA))
    pipe = DevicePipeline(Detector(80, 3), sd, cfg)
    images = photo_variants(photo, 12, seed=0)
    for bsz in (1, 2, 4, 8, 16):                       # server buckets
        pipe(images[:bsz] if bsz <= 12 else np.concatenate(
            [images, images[:bsz - 12]]))
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
        pp_fused.rank_decode_nms.launches = 0
        port = server.start()
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(len(images))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        launches = pp_fused.rank_decode_nms.launches
        check(not errors and all(not t.is_alive() for t in threads),
              f"requests failed: {errors}")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
    check(launches > 0, "the served requests launched no rank_decode_nms")
    check(stats["requests"] == len(images), f"stats {stats}")

    # each answer: well formed, and equal to the pipeline's rows for that
    # image in the batch the server ran; a direct call on each such batch
    # gives the same rows
    n_det = 0
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
        n_det += ans["count"]
    check(n_det > 0, "no detections in the served photos")
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

    # throughput at b128 on the device, and the main path's own kernel
    # inputs for the kernel's time
    big = torch.from_numpy(np.concatenate(
        [images] * 11)[:128]).cuda()
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
    return launches, big


def main_path_kernel_timing(sd, big):
    """The b128 serving batch split into forward and postprocess, and
    rank_decode_nms on the inputs that batch gives it."""
    import torch
    from fastdet_torch.config import Config
    from fastdet_torch.kernels import pp_fused
    from fastdet_torch.models import Detector
    from fastdet_torch.ops.postprocess import (_anchors_array, _geo_table,
                                               postprocess, rank_scores,
                                               rank_topk)
    from torch_cases import BOX_ULPS_CARD, IOU, NC, box_ulps
    cfg = Config.from_file(DATA)
    anchors = np.asarray(cfg.anchors, np.float32).reshape(2, 3, 2)
    model = Detector(80, 3)
    model.load_state_dict(sd)
    model = model.cuda().eval()
    with torch.inference_mode():
        x = big.float() / 255.0
        outputs = model(x)
        fwd_ms = cuda_ms(lambda: model(x), 20)
        post_ms = cuda_ms(lambda: postprocess(
            outputs, anchors, (352, 352), max_nms=128), 20)
        ranked, reg_f, cls_f, meta = rank_scores(outputs, (352, 352), 0.3)
        neg_k, combo_k = rank_topk(ranked, cls_f, nc=NC, k=128)
        geo = _geo_table(meta, tuple(_anchors_array(np.asarray(
            cfg.anchors, np.float32)).ravel().tolist()), "cuda:0")
        args = (neg_k, combo_k, reg_f.contiguous(), geo)
        keep, boxes = pp_fused.rank_decode_nms(*args, nc=NC, iou_thres=IOU)
        rkeep, rboxes = pp_fused.rank_decode_nms_reference(
            *args, nc=NC, iou_thres=IOU)
        check(torch.equal(keep, rkeep), "keep differs on the served batch")
        nb, rb = boxes.cpu().numpy(), rboxes.cpu().numpy()
        err = float(np.abs(nb - rb).max())
        ulps = float(box_ulps(nb, rb).max())
        check(ulps <= BOX_ULPS_CARD,
              f"boxes {ulps} ULPs off on the served batch")
        ms = cuda_ms(lambda: pp_fused.rank_decode_nms(
            *args, nc=NC, iou_thres=IOU), 100, 10)
        plain_ms = cuda_ms(lambda: pp_fused.rank_decode_nms_reference(
            *args, nc=NC, iou_thres=IOU), 10, 2)
    bound_ms, bound_by = rdn_bound(neg_k, combo_k)
    log(f"  b128 split (CUDA events): forward {fwd_ms:.3f} ms, postprocess "
        f"{post_ms:.3f} ms (scores, sort, window, rank_decode_nms, "
        f"compaction)")
    log(f"  rank_decode_nms on the served b128 batch (B=128, k=128, N=1815): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.6f} "
        f"ms ({bound_by}), keep equal, boxes {ulps:g} ULPs (max |Δ| {err:g})")
    return ms, plain_ms, bound_ms, bound_by, err


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
    card = phase_device()
    err_classes = phase_kernels()
    photo = read_png_bgr(PHOTO)
    sd = phase_weights_forward(photo)
    launches, big = phase_serving(sd, photo, card)
    ms, plain_ms, bound_ms, bound_by, err_main = main_path_kernel_timing(
        sd, big)
    for t in threading.enumerate():         # request handlers finishing
        if t is not threading.main_thread():
            t.join(timeout=10)
    alive = [t.name for t in threading.enumerate()
             if t is not threading.main_thread()]
    check(not alive, f"threads still running: {alive}")
    log("phase 5 shutdown: server stopped, batcher closed, no threads left")
    log('phase 6 kernels: ["rank_decode_nms"]')
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "rank_decode_nms", "route": "cuda",
        "source": "fastdet_torch/csrc/pp_fused.cu",
        "replaces": "fastdet/kernels/pp_fused.py:156",
        "launches": launches, "max_abs_err": max(err_classes, err_main),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
