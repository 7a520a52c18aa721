"""The fused inference forward (counterpart of
fastdet/kernels/fused_infer.py, `input_format="s2d_u8"`, `head="yolo"`).

Input contract: the host's uint8 space-to-depth(4) batch
(B, 48, pad128(H/4·W/4)), channel yoff·12 + xoff·3 + c, lane i·(W/4) + j
for pixel (4i+yoff, 4j+xoff, c), written by `pack_images_s2d`.  Inside,
activations are NCHW f32.  The forward:

  1. `stem_s2d`: conv3×3 s2 (3→24, /255 and BN folded) + ReLU + maxpool
     3×3 s2 → (B, 24, H/4, W/4), the hand-written CUDA kernel
     `csrc/stem_s2d.cu` on the card;
  2. per stage (48/96/192 channels): the stride-2 ShuffleV2 block in
     PyTorch (cuDNN on the card), then `span`, the stage's 3/7/3 stride-1
     blocks, the hand-written CUDA kernel `csrc/span.cu` on the card;
  3. LightFPN and the shared heads in PyTorch;

and returns the raw NHWC 6-tuple (reg2, obj2, cls2, reg3, obj3, cls3) of
the port's `Detector`.  The JAX package leaves the stride-2 blocks, the
FPN and the heads to XLA, so they stay library calls here.

`stem_s2d` and `span` launch their kernel on a CUDA tensor (or raise) and
run their plain PyTorch version, `stem_s2d_reference` / `span_reference`,
only on a CPU tensor.  Each counts its kernel launches in `.launches`.

The TPU's lane grouping (`_pick_group`, `_LANE_BUDGET`) is a VMEM rule and
is not ported.  Nor is the row-chunked stem (`_stem_call_chunked`, B6):
the JAX package splits inputs above 8192 s2d lanes (640²: 25,600) into
row chunks with a one-row halo because one image's stem must fit in
VMEM.  `stem_s2d`'s CUDA grid already tiles 8×8 pooled cells at any
h/4 × w/4, with a halo of its own, and its shared memory does not grow
with the image, so one launch serves every size; `span` tiles any h × w
likewise.  Not ported yet: `input_format="nhwc"`, `"s2d8_u8"` (B10),
`fuse_s2=True` (B9), bf16 and the anchor-free head (ROADMAP A8, A14).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fastdet_torch import resolve_device
from fastdet_torch.kernels import _build
from fastdet_torch.kernels.fold import STAGES, pack_fused_weights

SPAN_CHANNELS = (48, 96, 192)


def _pad128(n: int) -> int:
    return (n + 127) // 128 * 128


# ------------------------------------------------------------ host packing

def pack_stem_s2d(stem_w: np.ndarray, stem_b: np.ndarray,
                  scale: float = 1.0 / 255.0):
    """Fold the input scale into the (3,3,3,24) HWIO stem conv.  → (w
    (3,3,3,24) f32, b (24,) f32).  The values are the nonzero entries of
    the TPU kernel's (192, 96) phase matrix (`pack_stem_s2d` of the JAX
    package); the CUDA kernel convolves directly and needs no phase form."""
    return (np.asarray(stem_w, np.float32) * scale,
            np.asarray(stem_b, np.float32).copy())


def pack_images_s2d(images: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) uint8 → (B, 48, pad128(H/4·W/4)) uint8 s2d(4) layout,
    zero pad lanes."""
    b, ih, iw, _ = images.shape
    h, w = ih // 4, iw // 4
    hw = h * w
    x = np.asarray(images).reshape(b, h, 4, w, 4, 3)
    x = x.transpose(0, 2, 4, 5, 1, 3).reshape(b, 48, hw)
    return np.pad(x, ((0, 0), (0, 0), (0, _pad128(hw) - hw)))


def pack_span_weights(blocks) -> np.ndarray:
    """Per-block dicts of `fold.pack_s1_block` → the span kernel's
    (nblk, 2·mid² + 12·mid) f32 rows [w1 | b1 | wd (tap-major 9×mid) | bd |
    w2 | b2]."""
    rows = []
    for p in blocks:
        mid = p["b1"].shape[0]
        rows.append(np.concatenate([
            p["w1"].ravel(), p["b1"], p["wd"].reshape(9, mid).ravel(),
            p["bd"], p["w2"].ravel(), p["b2"]]).astype(np.float32))
    return np.stack(rows)


# ------------------------------------------------------------ kernel B1

def stem_s2d_reference(x, w, b, h4: int, w4: int):
    """Plain PyTorch version of the stem kernel, any device.  x (B,48,npad)
    uint8, w (3,3,3,24) HWIO f32 with /255 folded in, b (24,) →
    (B, 24, h4, w4) f32."""
    bsz = x.shape[0]
    img = x[:, :, :h4 * w4].reshape(bsz, 4, 4, 3, h4, w4)
    img = img.permute(0, 3, 4, 1, 5, 2).reshape(bsz, 3, 4 * h4, 4 * w4)
    wt = torch.as_tensor(w, device=x.device).permute(3, 2, 0, 1)
    y = F.conv2d(img.float(), wt, torch.as_tensor(b, device=x.device),
                 stride=2, padding=1)
    return F.max_pool2d(F.relu(y), 3, 2, 1)


_STEM_SIGNATURES = {
    "fastdet_stem_s2d": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                         + [ctypes.c_void_p], ctypes.c_int),
}


def stem_s2d(x, w, b, h4: int, w4: int):
    """→ (B, 24, h4, w4) f32.  CUDA: the kernel of `csrc/stem_s2d.cu`, with
    `w` and `b` f32 on the host (they travel as the kernel's parameter
    block); CPU: the plain version."""
    dev = x.device
    if dev.type == "cpu":
        return stem_s2d_reference(x, w, b, h4, w4)
    if dev.type != "cuda":
        raise ValueError(f"stem_s2d: unsupported device {dev}")
    bsz = x.shape[0]
    npad = _pad128(h4 * w4)
    if (x.dtype != torch.uint8 or tuple(x.shape) != (bsz, 48, npad)
            or not x.is_contiguous()):
        raise ValueError(
            f"stem_s2d: expected a contiguous uint8 (B, 48, {npad}) tensor "
            f"for h4={h4}, w4={w4}, got {x.dtype} {tuple(x.shape)}")
    for t, shape in ((w, (3, 3, 3, 24)), (b, (24,))):
        if (not isinstance(t, torch.Tensor) or t.device.type != "cpu"
                or t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"stem_s2d: the weights are kernel parameters: expected a "
                f"contiguous f32 {shape} tensor on the CPU")
    out = torch.empty((bsz, 24, h4, w4), dtype=torch.float32, device=dev)
    lib = _build.load("stem_s2d", _STEM_SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.fastdet_stem_s2d(
            x.data_ptr(), out.data_ptr(), w.data_ptr(), b.data_ptr(), bsz,
            h4, w4, npad, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "stem_s2d")
    stem_s2d.launches += 1
    return out


stem_s2d.launches = 0


# ------------------------------------------------------------ kernel B2

def _unpack_block(row: torch.Tensor, mid: int):
    sizes = (mid * mid, mid, 9 * mid, mid, mid * mid, mid)
    w1, b1, wd, bd, w2, b2 = torch.split(row, sizes)
    return (w1.reshape(mid, mid), b1, wd.reshape(9, mid), bd,
            w2.reshape(mid, mid), b2)


def span_reference(x, weights, nblk: int):
    """Plain PyTorch version of the span kernel, any device.  x (B,C,h,w)
    f32, weights (nblk, 2·mid² + 12·mid) → (B,C,h,w) f32."""
    mid = x.shape[1] // 2
    for k in range(nblk):
        w1, b1, wd, bd, w2, b2 = _unpack_block(weights[k], mid)
        y = F.relu(F.conv2d(x[:, 1::2], w1.t()[:, :, None, None], b1))
        y = F.conv2d(y, wd.t().reshape(mid, 1, 3, 3), bd, padding=1,
                     groups=mid)
        y = F.relu(F.conv2d(y, w2.t()[:, :, None, None], b2))
        x = torch.cat([x[:, 0::2], y], dim=1)
    return x


_SPAN_SIGNATURES = {
    "fastdet_span": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                     + [ctypes.c_void_p], ctypes.c_int),
}


def span(x, weights, nblk: int):
    """→ (B,C,h,w) f32 after `nblk` stride-1 blocks.  CUDA: the kernel of
    `csrc/span.cu`, one launch per block (each counted); CPU: the plain
    version."""
    dev = x.device
    if dev.type == "cpu":
        return span_reference(x, weights, nblk)
    if dev.type != "cuda":
        raise ValueError(f"span: unsupported device {dev}")
    if (x.dim() != 4 or x.shape[1] not in SPAN_CHANNELS
            or x.dtype != torch.float32 or not x.is_contiguous()):
        raise ValueError(
            f"span: expected a contiguous f32 (B, C, h, w) tensor with C in "
            f"{SPAN_CHANNELS}, got {x.dtype} {tuple(x.shape)}")
    bsz, c, h, w = x.shape
    mid = c // 2
    shape = (nblk, 2 * mid * mid + 12 * mid)
    if (weights.device != dev or weights.dtype != torch.float32
            or tuple(weights.shape) != shape or not weights.is_contiguous()
            or weights.data_ptr() % 16):
        raise ValueError(
            f"span: expected contiguous 16-byte-aligned f32 weights {shape} "
            f"on {dev}, got {weights.dtype} {tuple(weights.shape)} on "
            f"{weights.device}")
    out = torch.empty_like(x)
    tmp = torch.empty_like(x) if nblk > 1 else out
    lib = _build.load("span", _SPAN_SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.fastdet_span(
            x.data_ptr(), out.data_ptr(), tmp.data_ptr(), weights.data_ptr(),
            bsz, c, h, w, nblk, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "span")
    span.launches += nblk
    return out


span.launches = 0


# ------------------------------------------------------ the PyTorch pieces

def _s2_block(x, p, prefix: str):
    """Stride-2 ShuffleV2 block with folded weights → concat[proj, main]."""
    mid = p[f"{prefix}_bd"].shape[0]
    cin = x.shape[1]
    y = F.relu(F.conv2d(x, p[f"{prefix}_w1"], p[f"{prefix}_b1"]))
    y = F.conv2d(y, p[f"{prefix}_wd"], p[f"{prefix}_bd"], stride=2,
                 padding=1, groups=mid)
    y = F.relu(F.conv2d(y, p[f"{prefix}_w2"], p[f"{prefix}_b2"]))
    pr = F.conv2d(x, p[f"{prefix}_wpd"], p[f"{prefix}_bpd"], stride=2,
                  padding=1, groups=cin)
    pr = F.relu(F.conv2d(pr, p[f"{prefix}_wpp"], p[f"{prefix}_bpp"]))
    return torch.cat([pr, y], dim=1)


def _dwcb(x, p, head: str):
    """Head DWConvBlock: ReLU after each depthwise conv, none after a
    pointwise one."""
    for dw, pw in ((f"{head}_dw1", f"{head}_pw1"),
                   (f"{head}_dw2", f"{head}_pw2")):
        x = F.relu(F.conv2d(x, p[dw + "_w"], p[dw + "_b"], padding=2,
                            groups=x.shape[1]))
        x = F.conv2d(x, p[pw + "_w"], p[pw + "_b"])
    return x


def _fpn(c2, c3, p):
    """LightFPN + shared heads → the raw NHWC 6-tuple."""
    s3 = F.relu(F.conv2d(c3, p["conv1x1_3_w"], p["conv1x1_3_b"]))
    up = F.interpolate(c3, scale_factor=2, mode="nearest")
    s2 = F.relu(F.conv2d(torch.cat([up, c2], dim=1), p["conv1x1_2_w"],
                    p["conv1x1_2_b"]))
    outs = []
    for s, tag in ((s2, 2), (s3, 3)):
        cls_f = _dwcb(s, p, f"cls_head_{tag}")
        reg_f = _dwcb(s, p, f"reg_head_{tag}")
        outs += [F.conv2d(reg_f, p["output_reg_w"], p["output_reg_b"]),
                 F.conv2d(cls_f, p["output_obj_w"], p["output_obj_b"]),
                 F.conv2d(cls_f, p["output_cls_w"], p["output_cls_b"])]
    return tuple(o.permute(0, 2, 3, 1) for o in outs)


def _device_weights(pk: Dict[str, np.ndarray],
                    device) -> Dict[str, torch.Tensor]:
    """Folded numpy weights (JAX layouts) → the forward's tensors: conv
    weights as OIHW on `device`, each stage's span as one packed tensor on
    `device`, the stem's scaled weight and bias on the host."""
    p: Dict[str, torch.Tensor] = {}
    s1 = {}
    for k, v in pk.items():
        parts = k.split("_")
        if k.startswith("stem_"):
            continue
        if parts[0][0] == "s" and parts[0][1:].isdigit() and parts[1] != "0":
            s1.setdefault(int(parts[0][1:]), {}).setdefault(
                int(parts[1]), {})[parts[2]] = v
            continue
        if v.ndim == 3:                                 # depthwise (kh,kw,C)
            v = v.transpose(2, 0, 1)[:, None]
        elif v.ndim == 2:                               # pointwise (Cin,Cout)
            v = v.T[:, :, None, None]
        p[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    for stage, blocks in s1.items():
        p[f"s{stage}_span"] = torch.from_numpy(pack_span_weights(
            [blocks[i] for i in sorted(blocks)])).to(device)
    w, b = pack_stem_s2d(pk["stem_w"], pk["stem_b"])
    p["stem_w"] = torch.from_numpy(np.ascontiguousarray(w))
    p["stem_b"] = torch.from_numpy(b)
    return p


def build_fused_forward(state_dict, input_hw: Tuple[int, int] = (352, 352),
                        dtype=torch.float32, input_format: str = "s2d_u8",
                        upto: str = None, fuse_s2: bool = False,
                        head: str = "yolo", device=None
                        ) -> Tuple[Callable, Dict[str, torch.Tensor]]:
    """Returns (forward_fn, packed): forward_fn(images, packed) with images
    a (B, 48, pad128(H/4·W/4)) uint8 tensor on `device` → the raw NHWC
    6-tuple of `Detector`.  `state_dict` is the port's (e.g.
    `fastdet_torch.io.load_state_dict`); the head's classes and anchors
    follow from it.  `packed` holds the folded weights: conv weights OIHW
    on `device`, each stage's span as one tensor `s{stage}_span`, and the
    stem's `stem_w`/`stem_b` on the host.

    upto: None for the whole forward; "stem"/"s2"/"s3"/"s4" stop after that
    stage and return its NHWC map (the per-stage timing hook)."""
    if input_format != "s2d_u8":
        raise NotImplementedError(
            f"fastdet_torch: input_format={input_format!r} is not ported; "
            "only 's2d_u8' ('nhwc' and 's2d8_u8' with kernel B10 are ROADMAP "
            "A14)")
    if fuse_s2:
        raise NotImplementedError(
            "fastdet_torch: fuse_s2=True needs kernel B9 (_s2span_call), "
            "not ported (ROADMAP A14)")
    if head != "yolo":
        raise NotImplementedError(
            f"fastdet_torch: head={head!r} is not ported (ROADMAP A8)")
    if dtype != torch.float32:
        raise NotImplementedError(
            f"fastdet_torch: dtype={dtype} is not ported; the fused forward "
            "computes f32 (bf16 is ROADMAP A1)")
    if upto not in (None, "stem", "s2", "s3", "s4"):
        raise ValueError(f"unknown upto {upto!r}")
    ih, iw = input_hw
    h4, w4 = ih // 4, iw // 4
    if ih % 32 or iw % 32:
        raise ValueError(f"input {input_hw} must be a multiple of 32")
    npad = _pad128(h4 * w4)
    dev = resolve_device(device)
    packed = _device_weights(pack_fused_weights(state_dict), dev)

    def nhwc(x):
        return x.permute(0, 2, 3, 1)

    def forward(images, p):
        if (images.dim() != 3 or tuple(images.shape[1:]) != (48, npad)
                or images.dtype != torch.uint8):
            raise ValueError(f"expected (B, 48, {npad}) uint8 s2d input, "
                             f"got {images.dtype} {tuple(images.shape)}")
        x = stem_s2d(images, p["stem_w"], p["stem_b"], h4, w4)
        if upto == "stem":
            return nhwc(x)
        feats = {}
        for sid, reps, _ in STAGES:
            x = _s2_block(x, p, f"s{sid}_0")
            x = span(x, p[f"s{sid}_span"], reps - 1)
            feats[sid] = x
            if upto == f"s{sid}":
                return nhwc(x)
        return _fpn(feats[3], feats[4], p)

    return forward, packed
