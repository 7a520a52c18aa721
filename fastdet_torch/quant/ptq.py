"""Int8 post-training quantization (PTQ) of the detectors (counterpart of
fastdet/quant/ptq.py).

The eval-mode model is folded to a flat affine-conv graph (every Conv+BN
pair → one conv with bias, by `fastdet_torch.kernels.fold._fold`), then
each conv runs as an integer contraction:

  * weights: symmetric per-output-channel int8 (`w ≈ s_w[c] · w_q`);
  * activations: symmetric per-tensor int8 (`x ≈ s_x · x_q`, rounded
    half to even and clipped to ±127) with scales calibrated over a
    calibration set: by default the p99.99 point of a 2048-bin |x|
    histogram, optionally plain max-|x| (`calibrate(method=...)`);
  * between ops the integer accumulator is rescaled to f32
    (`y = acc · (s_x·s_w) + b`), ReLU'd, and re-quantized by the next
    op's scale.

The arithmetic is the one XLA gives the JAX package's jitted forward (its
eval and test CLIs jit it), so that the integer chain stays equal to
JAX's bit for bit on real images, where one rounding flip at a tie of
round(x/s_x) changes every op after it:
  * `s_x·s_w` is rounded to f32 first (JAX's python-float scalar is
    weak-typed), and x/s_x is x times f32(1/s_x);
  * the input's /255 is a product with f32(1/255): XLA rewrites a
    division by a constant so;
  * the rescale is one fused multiply-add, which XLA contracts it to;
    here it is computed in f64 (acc·(s_x·s_w) is exact there) and
    rounded once to f32.  That equals the f32 FMA but where the f64 sum
    rounds onto an f32 tie, which is far rarer than the ties it removes.

The op names are the JAX package's (`backbone/stage2_0/main_pw`,
`fpn/conv1x1_2`, `output_cls`, ...): the port's modules carry JAX's
names, so a name is a state-dict prefix with dots turned to slashes.
`save_quantized` / `load_quantized` use the JAX package's `.npz` keys,
so each package reads the other's artifacts.

The MAC unit (`QuantOps(mac=...)`) carries the contractions (the
pointwise convs, the stem's 3×3 as one product over its 27 taps, the
depthwise taps elementwise):
  * "bf16" (default, the JAX package's name for its floating MAC): the
    int8 operands as f32, products and sums in f32.  Exact: ±127 and
    every product (≤ 127²) are f32 integers, and every partial sum stays
    an integer below 2²⁴ (the widest contraction is `fpn/conv1x1_2`,
    K = 288: |acc| ≤ 288·127² = 4,645,152), so no addition rounds, in any
    order.  Not `torch.matmul` on bf16 tensors, which returns bf16 and
    rounds any sum above 256;
  * "int32": int8 × int8 → int32.  On CUDA `torch._int_mm` (cuBLASLt's
    int8 GEMM), which wants more than 16 rows and K and N multiples of
    8: the operands are zero-padded to that and the padding sliced off;
    on the CPU an int32 product.  A failure raises; nothing falls back
    to the other MAC.
Both give the same accumulators, bit for bit.

`forward_from(qw, scales, mac=, device=)` moves the weights to the
device once and returns `forward(images_u8)` → the raw NHWC maps that
`fastdet_torch.ops.postprocess.postprocess` (anchor-based) or
`decode_anchorfree` + `batched_nms` (anchor-free) take.  The JAX package
runs these contractions in XLA (no Pallas kernel), so here they are
PyTorch and cuBLAS calls.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fastdet_torch import disable_tf32, resolve_device
from fastdet_torch.kernels.fold import _fold, _np

_STAGE_REPEATS = ((2, 4), (3, 8), (4, 4))
_YOLO_HEADS = ("output_reg", "output_obj", "output_cls")
_AF_HEADS = ("out_obj", "out_cls", "out_reg")
_MACS = ("bf16", "int32")
_INV_255 = float(np.float32(1) / np.float32(255))


# ------------------------------------------------------------- folding

def fold_model(state_dict) -> Dict[str, Dict[str, np.ndarray]]:
    """All Conv+BN pairs of the port's `state_dict` folded to {name: {"w",
    "b"}} (HWIO f32 kernels, per-out-channel bias), plus the biased 1×1
    head convs; names slash-joined as the JAX package's.  Both families:
    the anchor-based Detector (backbone + fpn + output_* heads) and the
    anchor-free one (backbone + fuse + head_cls/head_reg + out_* heads),
    told apart by the `fpn` prefix; `infer_family` reads it back."""
    sd = state_dict
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for key in sd:
        if key.endswith(".conv.weight"):
            prefix = key[:-len(".conv.weight")]
            if f"{prefix}.bn.weight" in sd:
                w, b = _fold(sd, prefix)
                out[prefix.replace(".", "/")] = {"w": w, "b": b}
    yolo = any(k.startswith("fpn.") for k in sd)
    for head in (_YOLO_HEADS if yolo else _AF_HEADS):
        out[head] = {"w": np.ascontiguousarray(                 # OIHW → HWIO
                         _np(sd[f"{head}.weight"]).transpose(2, 3, 1, 0)),
                     "b": _np(sd[f"{head}.bias"])}
    return out


def infer_family(folded_or_qw) -> str:
    """Family from the folded/quantized op names (also how the `.npz`
    artifact self-describes)."""
    return "anchorfree" if "fuse" in folded_or_qw else "yolo-fastestv2"


def quantize_weights(folded) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-output-channel symmetric int8: wq int8 HWIO, sw (Cout,) f32,
    b (Cout,) f32, as CPU tensors (the JAX package's numpy arithmetic)."""
    out = {}
    for name, q in folded.items():
        w = np.asarray(q["w"], np.float32)
        sw = np.maximum(np.abs(w).reshape(-1, w.shape[-1]).max(0),
                        1e-12) / 127.0
        wq = np.clip(np.round(w / sw), -127, 127).astype(np.int8)
        out[name] = {"wq": torch.from_numpy(wq),
                     "sw": torch.from_numpy(sw.astype(np.float32)),
                     "b": torch.from_numpy(np.asarray(q["b"], np.float32))}
    return out


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


# ------------------------------------------------------------- op sets

def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _relu(y, relu):
    return torch.clamp_min(y, 0.0) if relu else y


class FloatOps:
    """f32 ops on the folded graph (cuDNN/BLAS on the device, TF32 off);
    with `record=True` it keeps each op's input max-|x| on the device
    (the calibration pass), pooled over every call of an op (the shared
    head convs' two sites, and every batch the object sees)."""

    def __init__(self, folded, record: bool = False, device=None):
        self.device = resolve_device(device)
        disable_tf32(self.device)
        self.record = record
        self.maxabs: Dict[str, torch.Tensor] = {}
        self.w: Dict[str, torch.Tensor] = {}
        self.b: Dict[str, torch.Tensor] = {}
        for name, q in folded.items():
            w = torch.from_numpy(np.asarray(_host(q["w"]), np.float32))
            kh, kw = w.shape[:2]
            # pointwise: (Cin, Cout); others OIHW
            w = w[0, 0] if kh == kw == 1 else w.permute(3, 2, 0, 1)
            self.w[name] = w.contiguous().to(self.device)
            self.b[name] = torch.from_numpy(
                np.asarray(_host(q["b"]), np.float32)).to(self.device)

    def _rec(self, name, x):
        if self.record:
            m = x.abs().max()
            if name in self.maxabs:
                m = torch.maximum(m, self.maxabs[name])
            self.maxabs[name] = m

    def _conv(self, name, x, stride, relu, groups):
        self._rec(name, x)
        w = self.w[name]
        y = F.conv2d(_nchw(x), w, stride=stride,
                     padding=(w.shape[2] // 2, w.shape[3] // 2),
                     groups=groups)
        return _relu(_nhwc(y) + self.b[name], relu)

    def conv(self, name, x, stride, relu):
        return self._conv(name, x, stride, relu, groups=1)

    def dw(self, name, x, stride, relu):
        return self._conv(name, x, stride, relu, groups=x.shape[-1])

    def pw(self, name, x, relu):
        self._rec(name, x)
        return _relu(x @ self.w[name] + self.b[name], relu)


def _quant_in(x, scale):
    """x → int8 round(x/scale) clipped to ±127, half to even; x is
    multiplied by f32(1/scale), as JAX's weak-typed python scalar is."""
    inv = float(np.float32(1.0 / scale))
    return torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _int_mm(a, b, n: int):
    """int8 (M, K) × the K-padded (Kp, Np) int8 matrix b → int32 (M, n) by
    `torch._int_mm`: the rows padded past 16, the columns of a to Kp."""
    m, k = a.shape
    mp = max(m, 32)
    a = F.pad(a, (0, b.shape[0] - k, 0, mp - m))
    return torch._int_mm(a, b)[:m, :n]


class QuantOps:
    """int8 ops: per-tensor activation scales (calibrated), per-channel
    weight scales, integer-exact accumulation (see the module docstring
    for the two MAC units).  The weights go to `device` once, in each
    op's contraction form.

    `float_names`: ops run in f32 on the dequantized weights (wq·sw) with
    no activation quantization, as the JAX package's escape hatch.

    `record`: a dict that collects, per op name, a list of (int8 input,
    integer accumulator) pairs, one per call (the shared head convs are
    called twice); the accumulator is f32 under "bf16", int32 under
    "int32" (equal values).  `recording(d)` is a copy of these ops that
    records into `d`."""

    def __init__(self, qw, scales: Dict[str, float],
                 float_names=frozenset(), mac: str = "bf16", device=None,
                 record=None):
        if mac not in _MACS:
            raise ValueError(f"unknown mac {mac!r}")
        self.device = resolve_device(device)
        disable_tf32(self.device)
        self.scales = scales
        self.float_names = frozenset(float_names)
        self.mac = mac
        self.record = record
        self.ops = {name: self._prepare(name, q) for name, q in qw.items()}

    def recording(self, record) -> "QuantOps":
        ops = copy.copy(self)
        ops.record = record
        return ops

    def _acc_dtype(self):
        return torch.float32 if self.mac == "bf16" else torch.int32

    def _prepare(self, name, q):
        dev = self.device
        wq = torch.as_tensor(_host(q["wq"]).astype(np.int8))
        sw = np.asarray(_host(q["sw"]), np.float32)
        b = np.asarray(_host(q["b"]), np.float32)
        kh, kw, cin, cout = wq.shape
        p = {"kh": kh, "kw": kw, "n": cout,
             "b": torch.from_numpy(b).to(dev)}
        if name in self.float_names:
            deq = wq.to(torch.float32) * torch.from_numpy(sw)
            p["deq"] = (deq[0, 0] if kh == kw == 1
                        else deq.permute(3, 2, 0, 1)).contiguous().to(dev)
            return p
        sx = self.scales[name]
        p["ssw"] = torch.from_numpy(np.float32(sx) * sw).to(dev)
        # the rescale's operands in f64, for the one rounding of an FMA
        p["ssw64"], p["b64"] = p["ssw"].double(), p["b"].double()
        if cin == 1 and kh > 1:                  # depthwise taps (kh,kw,C)
            p["taps"] = wq[:, :, 0, :].to(self._acc_dtype()).to(dev)
            return p
        mat = wq.reshape(kh * kw * cin, cout)    # rows tap-major, then Cin
        if self.mac == "bf16":
            p["mat"] = mat.to(torch.float32).to(dev)
        elif dev.type == "cuda":
            # (Kp, Np), column-major: cuBLASLt's int8 GEMM layout
            p["mat"] = F.pad(mat, (0, _pad8(cout) - cout,
                                   0, _pad8(mat.shape[0]) - mat.shape[0])
                             ).t().contiguous().to(dev).t()
        else:
            p["mat"] = mat.to(torch.int32).to(dev)
        return p

    def _contract(self, xq2, p):
        """int8 (M, K) × the op's (K, N) → the (M, N) accumulator."""
        if self.mac == "bf16":
            return xq2.to(torch.float32) @ p["mat"]
        if xq2.is_cuda:
            return _int_mm(xq2.contiguous(), p["mat"], p["n"])
        return xq2.to(torch.int32) @ p["mat"]

    def _out(self, name, p, xq, acc, relu):
        if self.record is not None:
            self.record.setdefault(name, []).append((xq, acc))
        y = (acc.to(torch.float64) * p["ssw64"] + p["b64"]).to(
            torch.float32)
        return _relu(y, relu)

    def _taps_conv(self, name, x, stride, relu, groups):
        p = self.ops[name]
        kh, kw = p["kh"], p["kw"]
        if name in self.float_names:
            y = F.conv2d(_nchw(x), p["deq"], stride=stride,
                         padding=(kh // 2, kw // 2), groups=groups)
            return _relu(_nhwc(y) + p["b"], relu)
        xq = _quant_in(x, self.scales[name])
        ph, pw_ = kh // 2, kw // 2
        xp = F.pad(xq, (0, 0, pw_, pw_, ph, ph))
        b, hgt, wid, c = x.shape
        oh = (hgt + 2 * ph - kh) // stride + 1
        ow = (wid + 2 * pw_ - kw) // stride + 1
        taps = [xp[:, dy:dy + stride * oh:stride, dx:dx + stride * ow:stride]
                for dy in range(kh) for dx in range(kw)]
        if groups == 1:                     # one product over kh·kw·Cin
            cols = torch.cat(taps, dim=-1).reshape(b * oh * ow, -1)
            acc = self._contract(cols, p).reshape(b, oh, ow, p["n"])
        else:                               # depthwise, elementwise taps
            w = p["taps"].reshape(kh * kw, c)
            acc = None
            for t, sl in enumerate(taps):
                term = sl.to(w.dtype) * w[t]
                acc = term if acc is None else acc + term
        return self._out(name, p, xq, acc, relu)

    def conv(self, name, x, stride, relu):
        return self._taps_conv(name, x, stride, relu, groups=1)

    def dw(self, name, x, stride, relu):
        return self._taps_conv(name, x, stride, relu, groups=x.shape[-1])

    def pw(self, name, x, relu):
        p = self.ops[name]
        if name in self.float_names:
            return _relu(x @ p["deq"] + p["b"], relu)
        xq = _quant_in(x, self.scales[name])
        acc = self._contract(xq.reshape(-1, xq.shape[-1]), p)
        return self._out(name, p, xq, acc.reshape(*xq.shape[:-1], p["n"]),
                         relu)


# ----------------------------------------------------- shared structure

def _maxpool(x):
    return _nhwc(F.max_pool2d(_nchw(x), 3, stride=2, padding=1))


def _upsample2x(x):
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(
        b, h * 2, w * 2, c)


def _backbone_folded(images_u8, ops) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared ShuffleNetV2 folded forward → (C2 stride-16, C3 stride-32).
    The input is u8 · f32(1/255), XLA's form of the JAX package's /255."""
    x = images_u8.to(torch.float32) * _INV_255
    y = ops.conv("backbone/first_conv", x, stride=2, relu=True)
    y = _maxpool(y)

    feats = []
    for sid, reps in _STAGE_REPEATS:
        for i in range(reps):
            nm = f"backbone/stage{sid}_{i}"
            if i == 0:
                proj = ops.dw(f"{nm}/proj_dw", y, stride=2, relu=False)
                proj = ops.pw(f"{nm}/proj_pw", proj, relu=True)
                m = ops.pw(f"{nm}/main_pw", y, relu=True)
                m = ops.dw(f"{nm}/main_dw", m, stride=2, relu=False)
                m = ops.pw(f"{nm}/main_pw_linear", m, relu=True)
                y = torch.cat([proj, m], dim=-1)
            else:
                x_proj, x_main = y[..., 0::2], y[..., 1::2]
                m = ops.pw(f"{nm}/main_pw", x_main, relu=True)
                m = ops.dw(f"{nm}/main_dw", m, stride=1, relu=False)
                m = ops.pw(f"{nm}/main_pw_linear", m, relu=True)
                y = torch.cat([x_proj, m], dim=-1)
        feats.append(y)
    return feats[1], feats[2]


def _dwblock_folded(ops, nm, s):
    t = ops.dw(f"{nm}/dw1", s, stride=1, relu=True)
    t = ops.pw(f"{nm}/pw1", t, relu=False)
    t = ops.dw(f"{nm}/dw2", t, stride=1, relu=True)
    t = ops.pw(f"{nm}/pw2", t, relu=False)
    return t


def forward_folded(images_u8, ops) -> Tuple[torch.Tensor, ...]:
    """Eval-mode forward of the anchor-based Detector on the folded graph.
    `images_u8` (B,H,W,3) uint8 on the ops' device; → the raw NHWC 6-tuple
    (reg, obj, cls at stride 16, then at stride 32)."""
    C2, C3 = _backbone_folded(images_u8, ops)
    S3 = ops.pw("fpn/conv1x1_3", C3, relu=True)
    cls3 = _dwblock_folded(ops, "fpn/cls_head_3", S3)
    reg3 = _dwblock_folded(ops, "fpn/reg_head_3", S3)
    P2 = torch.cat([_upsample2x(C3), C2], dim=-1)
    S2 = ops.pw("fpn/conv1x1_2", P2, relu=True)
    cls2 = _dwblock_folded(ops, "fpn/cls_head_2", S2)
    reg2 = _dwblock_folded(ops, "fpn/reg_head_2", S2)
    return (ops.pw("output_reg", reg2, relu=False),
            ops.pw("output_obj", cls2, relu=False),
            ops.pw("output_cls", cls2, relu=False),
            ops.pw("output_reg", reg3, relu=False),
            ops.pw("output_obj", cls3, relu=False),
            ops.pw("output_cls", cls3, relu=False))


def forward_folded_af(images_u8, ops) -> Tuple[torch.Tensor, ...]:
    """Anchor-free folded forward: one stride-16 scale → the raw NHWC
    (obj, cls, reg) 3-tuple."""
    C2, C3 = _backbone_folded(images_u8, ops)
    P = torch.cat([C2, _upsample2x(C3)], dim=-1)
    S = ops.pw("fuse", P, relu=True)
    feat_cls = _dwblock_folded(ops, "head_cls", S)
    feat_reg = _dwblock_folded(ops, "head_reg", S)
    return (ops.pw("out_obj", feat_cls, relu=False),
            ops.pw("out_cls", feat_cls, relu=False),
            ops.pw("out_reg", feat_reg, relu=False))


def folded_forward_for(folded_or_qw):
    """The family's folded forward for a folded/quantized dict."""
    return (forward_folded_af if infer_family(folded_or_qw) == "anchorfree"
            else forward_folded)


# --------------------------------------------------------- calibration

def histogram_edges(mx: float, bins: int) -> torch.Tensor:
    """`jnp.histogram`'s f32 edges over (0, mx): `jnp.linspace(0, mx,
    bins + 1)` as XLA computes it, mx·(i·f32(1/bins)) for i < bins (the
    division by the constant taken as a product with its f32 reciprocal),
    then mx itself."""
    mx32 = torch.tensor(np.float32(mx))
    step = torch.arange(bins, dtype=torch.float32) * float(
        np.float32(1) / np.float32(bins))
    return torch.cat([mx32 * step, mx32[None]])


def histogram(a, edges) -> torch.Tensor:
    """`jnp.histogram(a, bins=edges)`'s counts (int64, len(edges) − 1):
    a value's bin is the right-side `searchsorted` of the edges, a value
    equal to the last edge falls in the last bin, values outside the
    edges are dropped."""
    bins = edges.numel() - 1
    a = a.reshape(-1)
    idx = torch.searchsorted(edges, a, right=True)
    idx = torch.where(a == edges[-1], bins, idx)
    return torch.bincount(idx, minlength=bins + 2)[1:bins + 1]


class _HistOps(FloatOps):
    """FloatOps that accumulates a fixed-range |x| histogram per op
    (ranges from a prior max pass; the shared head convs pool both
    sites)."""

    def __init__(self, folded, maxes: Dict[str, float], bins: int,
                 device=None):
        super().__init__(folded, record=False, device=device)
        self.edges = {k: histogram_edges(max(v, 1e-12), bins).to(
            self.device) for k, v in maxes.items()}
        self.hists: Dict[str, torch.Tensor] = {}

    def _rec(self, name, x):
        h = histogram(x.abs(), self.edges[name])
        self.hists[name] = h if name not in self.hists \
            else self.hists[name] + h


@torch.inference_mode()
def calibrate(folded, calib_images_u8, batch: int = 8,
              method: str = "percentile", percentile: float = 0.9999,
              bins: int = 2048, device=None) -> Dict[str, float]:
    """Per-op activation scales over the calibration set ((n,H,W,3) uint8,
    numpy or a tensor), run in chunks of `batch` on `device`.

    method="percentile" (default): two passes, a max-|x| scan fixing each
    op's histogram range (0, max), then a `bins`-bin |x| histogram whose
    `percentile` point becomes the clip threshold (scale = thr/127).
    method="max": the max-|x| pass alone (scale = max/127).  The shared
    head convs pool both application sites.  An op whose inputs are all 0
    gets scale 1."""
    if method not in ("percentile", "max"):
        raise ValueError(f"unknown calibration method {method!r}")
    fwd = folded_forward_for(folded)
    images = torch.as_tensor(calib_images_u8)
    n = len(images)

    max_ops = FloatOps(folded, record=True, device=device)
    for i in range(0, n, batch):
        fwd(images[i:i + batch].to(max_ops.device), max_ops)
    maxes = {k: float(v) for k, v in max_ops.maxabs.items()}

    if method == "max":
        return {k: (v / 127.0 if v > 0 else 1.0) for k, v in maxes.items()}

    hist_ops = _HistOps(folded, maxes, bins, device=device)
    for i in range(0, n, batch):
        fwd(images[i:i + batch].to(hist_ops.device), hist_ops)

    scales: Dict[str, float] = {}
    for k, mx in maxes.items():
        if mx <= 0:
            scales[k] = 1.0
            continue
        c = np.cumsum(hist_ops.hists[k].cpu().numpy())
        i = int(np.searchsorted(c, c[-1] * percentile))
        thr = (i + 0.5) / bins * mx
        scales[k] = max(thr, 1e-8) / 127.0
    return scales


def build_int8_forward(state_dict, calib_images_u8, device=None,
                       ) -> Tuple[Callable, Dict[str, float]]:
    """→ (forward(images_u8) → the raw NHWC maps, activation scales):
    fold, calibrate on `calib_images_u8`, quantize, all on `device`."""
    folded = fold_model(state_dict)
    scales = calibrate(folded, calib_images_u8, device=device)
    qw = quantize_weights(folded)
    return forward_from(qw, scales, device=device), scales


def forward_from(qw, scales: Dict[str, float], mac: str = "bf16",
                 device=None) -> Callable:
    """Int8 forward from already-quantized weights and activation scales.
    The weights go to `device` (CUDA unless "cpu" is asked for) here,
    once.  → `forward(images_u8, record=None)`: (B,H,W,3) uint8 (moved to
    the device if it is not there) → the family's raw NHWC maps, f32;
    `record`, a dict, collects each op's int8 input and accumulator
    (`QuantOps`)."""
    ops = QuantOps(qw, scales, mac=mac, device=device)
    fwd = folded_forward_for(qw)

    @torch.inference_mode()
    def forward(images_u8, record=None):
        images = torch.as_tensor(images_u8).to(ops.device)
        return fwd(images, ops if record is None else ops.recording(record))

    return forward


# ------------------------------------------------------------- artifact

def save_quantized(path: str, qw, scales: Dict[str, float]) -> None:
    """One `.npz` in the JAX package's layout: `name|wq` int8 kernels,
    `name|sw` weight scales, `name|b` biases and `name|sx` the calibrated
    activation scale as float64 (an exact round trip)."""
    flat: Dict[str, np.ndarray] = {}
    for name, q in qw.items():
        flat[f"{name}|wq"] = np.asarray(_host(q["wq"]), np.int8)
        flat[f"{name}|sw"] = np.asarray(_host(q["sw"]), np.float32)
        flat[f"{name}|b"] = np.asarray(_host(q["b"]), np.float32)
        flat[f"{name}|sx"] = np.float64(scales[name])
    np.savez(path, **flat)


def load_quantized(path: str) -> Tuple[Dict[str, Dict[str, torch.Tensor]],
                                       Dict[str, float]]:
    """Inverse of `save_quantized` → (qw with CPU tensors, scales)."""
    with np.load(path) as z:
        qw: Dict[str, Dict[str, torch.Tensor]] = {}
        scales: Dict[str, float] = {}
        for key in z.files:
            name, kind = key.rsplit("|", 1)
            if kind == "sx":
                scales[name] = float(z[key])
            elif kind in ("wq", "sw", "b"):
                qw.setdefault(name, {})[kind] = torch.from_numpy(
                    np.array(z[key]))
            else:
                raise KeyError(f"unknown artifact key {key!r}")
    return qw, scales
