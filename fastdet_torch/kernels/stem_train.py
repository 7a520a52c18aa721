"""The training stem B7: conv3×3 stride 2 (3 → 24) + ghost BatchNorm + ReLU
+ maxpool 3×3 stride 2, forward and backward, from the s2d(4) uint8 layout
(counterpart of fastdet/kernels/stem_train.py, `make_stem_train`).

x (B, 48, pad128(h4·w4)) uint8 is `pack_images_s2d`'s layout (channel
yoff·12 + xoff·3 + c, lane i·w4 + j for pixel (4i+yoff, 4j+xoff, c)); pad
lanes are never read.  w (24, 3, 3, 3) is the OIHW conv weight with the
1/255 input scale applied (the caller scales `first_conv.conv.weight` by a
torch op, so autograd carries dW back through it); the conv multiplies it
by the integer pixel values, as the JAX kernel does.
  u = conv(image, w): the 27 taps summed in the order (ky, kx, c),
      acc = acc + x·w from 0;
  ghost BN over g consecutive images (4·h4·w4·g samples per channel): μ,
      then the biased variance mean((u−μ)²), σinv = rsqrt(var + 1e-5),
      bn = (u−μ)·(σinv·γ)+β — in both directions (the JAX kernel's
      backward mask uses ((u−μ)·σinv)·γ+β; one form here);
  y = maxpool3×3 s2 pad 1 of ReLU(bn), (B, 24, h4, w4) f32 NCHW;
  stats (B/g, 24, [μ, σinv, var]).
The backward returns dW (with respect to the scaled weight), dγ and dβ
summed over the groups; the images are uint8, so there is no dX.  It
routes the pooled cotangent with the JAX kernel's fixed precedence, which
matters on uint8 images (in a flat region neighbouring conv outputs are
bitwise equal, so positive ties are real): the conv column 2j first, then
2j+1, then 2j−1; within it the row 2i, then 2i+1, then 2i−1.  PyTorch's
`max_pool2d` backward breaks ties in another order, so the two agree only
where no positive tie occurs.

The TPU kernel's forms are not carried over: no (192, 96) phase matrix
and its selection matmuls, no lane rolls or bf16 bitcasts, no ×4 phase
tiling of γ/β.  One CUDA design (`csrc/stem_train.cu`) serves the JAX
package's group-1 and grouped kernels, with g as an argument.

`stem_train_forward` / `stem_train_backward` launch the CUDA kernels on a
CUDA tensor (or raise) and run the plain versions
`stem_train_forward_reference` / `stem_train_backward_reference` only on a
CPU tensor; each counts its calls that launch kernels in `.launches`.
`StemTrain` is the autograd.Function around them: it saves x and the
stats, and its backward recomputes from them.  The plain versions do the
kernels' operations in the kernels' order (the CUDA source is built with
`--fmad=false`), so from the same saved stats both recompute the same
conv outputs, ReLU masks and pool routing bit for bit.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from fastdet_torch.kernels import _build

EPS = 1e-5
COUT = 24


def _pad128(n: int) -> int:
    return (n + 127) // 128 * 128


# ------------------------------------------------------------ plain versions

def _image(x: torch.Tensor, h4: int, w4: int, dtype) -> torch.Tensor:
    """(B, 48, npad) uint8 → the (B, 3, 4·h4 + 2, 4·w4 + 2) image in dtype,
    zero-padded by one pixel on each side (the conv's pad)."""
    b = x.shape[0]
    img = x[:, :, :h4 * w4].reshape(b, 4, 4, 3, h4, w4)
    img = img.permute(0, 3, 4, 1, 5, 2).reshape(b, 3, 4 * h4, 4 * w4)
    return F.pad(img.to(dtype), (1, 1, 1, 1))


def _tap(imgp: torch.Tensor, c: int, ky: int, kx: int) -> torch.Tensor:
    """The input pixel of tap (ky, kx, c) under every conv output:
    imgp[:, c, 2r + ky, 2s + kx] → (B, 2·h4, 2·w4)."""
    h2 = (imgp.shape[2] - 2) // 2
    w2 = (imgp.shape[3] - 2) // 2
    return imgp[:, c, ky:ky + 2 * h2:2, kx:kx + 2 * w2:2]


def _conv(imgp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The stem conv as the kernel sums it: acc = acc + x·w over the 27
    taps in the order (ky, kx, c), from 0.  → (B, 24, 2·h4, 2·w4)."""
    b = imgp.shape[0]
    h2, w2 = (imgp.shape[2] - 2) // 2, (imgp.shape[3] - 2) // 2
    acc = torch.zeros((b, COUT, h2, w2), dtype=w.dtype, device=w.device)
    for ky in range(3):
        for kx in range(3):
            for c in range(3):
                acc = acc + (_tap(imgp, c, ky, kx)[:, None]
                             * w[:, c, ky, kx][None, :, None, None])
    return acc


def _per_image(t: torch.Tensor, g: int) -> torch.Tensor:
    """(G, 24) per-group values → (B, 24, 1, 1)."""
    return t.repeat_interleave(g, 0)[:, :, None, None]


def _group_stats(u: torch.Tensor, g: int) -> torch.Tensor:
    """(B, 24, H, W) → (G, 24, [μ, σinv, var]): the mean, then the biased
    variance mean((u−μ)²), over each group's g·H·W samples."""
    b = u.shape[0]
    ug = u.reshape(b // g, g, COUT, -1)
    mu = ug.mean((1, 3))
    d = ug - mu[:, None, :, None]
    var = (d * d).mean((1, 3))
    return torch.stack([mu, torch.rsqrt(var + EPS), var], -1)


def _bn_parts(u, stats, gamma, beta, g):
    """→ (bn = (u−μ)·(σinv·γ)+β, x̂ = (u−μ)·σinv) with the saved stats."""
    d = u - _per_image(stats[:, :, 0], g)
    bn = d * _per_image(stats[:, :, 1] * gamma, g) + beta[:, None, None]
    return bn, d * _per_image(stats[:, :, 1], g)


def stem_train_forward_reference(x, w, gamma, beta, h4: int, w4: int,
                                 g: int):
    """Plain version of the forward kernels, any device and float dtype
    (that of w).  → (y (B, 24, h4, w4), stats (B/g, 24, 3))."""
    u = _conv(_image(x, h4, w4, w.dtype), w)
    stats = _group_stats(u, g)
    bn, _ = _bn_parts(u, stats, gamma, beta, g)
    return F.max_pool2d(torch.relu(bn), 3, 2, 1), stats


def _shift(t: torch.Tensor, dim: int, step: int, fill: float):
    """t moved by one along dim (step +1: index i takes i−1; −1: i takes
    i+1), the vacated edge filled with `fill`."""
    n = t.shape[dim]
    edge = torch.full_like(t.narrow(dim, 0, 1), fill)
    if step > 0:
        return torch.cat([edge, t.narrow(dim, 0, n - 1)], dim)
    return torch.cat([t.narrow(dim, 1, n - 1), edge], dim)


def _route(yb: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The pooled cotangent dy (B, 24, h4, w4) sent back to the conv
    outputs yb (B, 24, 2·h4, 2·w4) (ReLU applied) with the JAX kernel's
    first-term-wins precedence: conv column 2j, then 2j+1, then 2j−1;
    within it the row 2i, then 2i+1, then 2i−1.  The pool's −inf pad
    reaches only row 0 and column 0."""
    ninf = float("-inf")
    ph = [yb[:, :, py::2, px::2] for py in (0, 1) for px in (0, 1)]
    R, E = [], []
    for px in (0, 1):
        c0, c1 = ph[px], ph[2 + px]
        c2 = _shift(c1, 2, 1, ninf)                     # row 2i−1
        r = torch.maximum(torch.maximum(c0, c1), c2)
        e0 = c0 == r
        e1 = (c1 == r) & ~e0
        R.append(r)
        E.append((e0, e1, (c2 == r) & ~e0 & ~e1))
    t2 = _shift(R[1], 3, 1, ninf)                       # column 2j−1
    out = torch.maximum(torch.maximum(R[0], R[1]), t2)
    m0 = R[0] == out
    m1 = (R[1] == out) & ~m0
    m2 = (t2 == out) & ~m0 & ~m1
    zero = torch.zeros_like(dy)
    dR = [torch.where(m0, dy, zero),
          torch.where(m1, dy, zero)
          + _shift(torch.where(m2, dy, zero), 3, -1, 0.0)]
    gy = torch.empty_like(yb)
    for px in (0, 1):
        e0, e1, e2 = E[px]
        gy[:, :, 0::2, px::2] = torch.where(e0, dR[px], zero)
        gy[:, :, 1::2, px::2] = (torch.where(e1, dR[px], zero)
                                 + _shift(torch.where(e2, dR[px], zero), 2,
                                          -1, 0.0))
    return gy


def stem_train_backward_reference(dy, x, stats, w, gamma, beta, h4: int,
                                  w4: int, g: int):
    """Plain version of the backward kernels (an explicit backward, not
    autograd): recompute the conv from x, BN from the saved stats, route
    dy through the pool and the ReLU, then BN's backward within each group
    and the weight gradient.  → (dW (24, 3, 3, 3), dγ (24,), dβ (24,))."""
    b = x.shape[0]
    imgp = _image(x, h4, w4, w.dtype)
    u = _conv(imgp, w)
    bn, xhat = _bn_parts(u, stats, gamma, beta, g)
    gy = _route(torch.relu(bn), dy)
    gy = torch.where(bn > 0, gy, torch.zeros_like(gy))
    sg = gy.reshape(b // g, g, COUT, -1).sum((1, 3))
    sgx = (gy * xhat).reshape(b // g, g, COUT, -1).sum((1, 3))
    inv_m = 1.0 / (g * 4 * h4 * w4)
    du = (_per_image(gamma * stats[:, :, 1], g)
          * ((gy - _per_image(sg * inv_m, g))
             - xhat * _per_image(sgx * inv_m, g)))
    dw = torch.empty_like(w)
    for ky in range(3):
        for kx in range(3):
            for c in range(3):
                dw[:, c, ky, kx] = (du * _tap(imgp, c, ky, kx)[:, None]).sum(
                    (0, 2, 3))
    return dw, sgx.sum(0), sg.sum(0)


def combine_stem_stats(stats: torch.Tensor):
    """(G, 24, [μ, σinv, var]) per-group stats → the exact full-batch
    (mean (24,), var (24,)) for equal group sizes: mean = E_g[μ_g], var =
    E_g[var_g] + E_g[(μ_g − mean)²].  The JAX package writes the variance
    as E_g[var_g + μ_g²] − mean², which cancels in f32 where |μ| ≫ σ; this
    form has no cancellation."""
    mus, vars_ = stats[:, :, 0], stats[:, :, 2]
    mean = mus.mean(0)
    d = mus - mean
    return mean, vars_.mean(0) + (d * d).mean(0)


# ------------------------------------------------------------ the kernels

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "fastdet_stem_train_fwd": ([_P] * 7 + [_I] * 5 + [_P], _I),
    "fastdet_stem_train_bwd": ([_P] * 10 + [_I] * 5 + [_P], _I),
    "fastdet_stem_train_fwd_scratch": ([_I] * 3, ctypes.c_size_t),
    "fastdet_stem_train_bwd_scratch": ([_I] * 4, ctypes.c_size_t),
}


def _check(what: str, x, w, gamma, beta, h4: int, w4: int, g: int):
    npad = _pad128(h4 * w4)
    b = x.shape[0] if x.dim() == 3 else -1
    if (x.dtype != torch.uint8 or x.dim() != 3
            or tuple(x.shape[1:]) != (48, npad) or not x.is_contiguous()):
        raise ValueError(
            f"{what}: expected a contiguous uint8 (B, 48, {npad}) tensor for "
            f"h4={h4}, w4={w4}, got {x.dtype} {tuple(x.shape)}")
    for name, t, shape in (("w", w, (COUT, 3, 3, 3)),
                           ("gamma", gamma, (COUT,)), ("beta", beta, (COUT,))):
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"{what}: expected {name} as a contiguous f32 {shape} tensor "
                f"on {x.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if g < 1 or b % g:
        raise ValueError(f"{what}: group {g} does not divide batch {b}")
    return b, npad


def stem_train_forward(x, w, gamma, beta, h4: int, w4: int, g: int):
    """→ (y (B, 24, h4, w4), stats (B/g, 24, 3)) as
    `stem_train_forward_reference`.  CUDA: the forward kernels of
    `csrc/stem_train.cu` (one counted call); CPU: the plain version."""
    dev = x.device
    if dev.type == "cpu":
        return stem_train_forward_reference(x, w, gamma, beta, h4, w4, g)
    if dev.type != "cuda":
        raise ValueError(f"stem_train_forward: unsupported device {dev}")
    b, npad = _check("stem_train_forward", x, w, gamma, beta, h4, w4, g)
    lib = _build.load("stem_train", _SIGNATURES)
    y = torch.empty((b, COUT, h4, w4), dtype=torch.float32, device=dev)
    stats = torch.empty((b // g, COUT, 3), dtype=torch.float32, device=dev)
    scratch = torch.empty(lib.fastdet_stem_train_fwd_scratch(b, h4, w4),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.fastdet_stem_train_fwd(
            x.data_ptr(), w.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            y.data_ptr(), stats.data_ptr(), scratch.data_ptr(), b, h4, w4,
            npad, g, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "stem_train_forward")
    stem_train_forward.launches += 1
    return y, stats


stem_train_forward.launches = 0


def stem_train_backward(dy, x, stats, w, gamma, beta, h4: int, w4: int,
                        g: int):
    """→ (dW, dγ, dβ) as `stem_train_backward_reference`.  CUDA: the
    backward kernels of `csrc/stem_train.cu` (one counted call); partial
    sums reduced in a fixed order, so two runs give the same bits.  CPU:
    the plain version."""
    dev = x.device
    if dev.type == "cpu":
        return stem_train_backward_reference(dy, x, stats, w, gamma, beta,
                                             h4, w4, g)
    if dev.type != "cuda":
        raise ValueError(f"stem_train_backward: unsupported device {dev}")
    b, npad = _check("stem_train_backward", x, w, gamma, beta, h4, w4, g)
    for name, t, shape in (("dy", dy, (b, COUT, h4, w4)),
                           ("stats", stats, (b // g, COUT, 3))):
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"stem_train_backward: expected {name} as a contiguous f32 "
                f"{shape} tensor on {dev}, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}")
    lib = _build.load("stem_train", _SIGNATURES)
    dw = torch.empty_like(w)
    dgamma = torch.empty_like(gamma)
    dbeta = torch.empty_like(beta)
    scratch = torch.empty(lib.fastdet_stem_train_bwd_scratch(b, h4, w4, g),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.fastdet_stem_train_bwd(
            dy.data_ptr(), x.data_ptr(), stats.data_ptr(), w.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), dw.data_ptr(),
            dgamma.data_ptr(), dbeta.data_ptr(), scratch.data_ptr(), b, h4,
            w4, npad, g, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "stem_train_backward")
    stem_train_backward.launches += 1
    return dw, dgamma, dbeta


stem_train_backward.launches = 0


class StemTrain(torch.autograd.Function):
    """The differentiable training stem: `StemTrain.apply(x_u8, w, gamma,
    beta, h4, w4, g) -> (y, stats)`; w is the scaled OIHW weight; stats
    carry no gradient (they feed the running statistics), x gets none."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, h4, w4, g):
        y, stats = stem_train_forward(x, w, gamma, beta, h4, w4, g)
        ctx.save_for_backward(x, stats, w, gamma, beta)
        ctx.geom = (h4, w4, g)
        ctx.mark_non_differentiable(stats)
        return y, stats

    @staticmethod
    def backward(ctx, dy, _dstats):
        x, stats, w, gamma, beta = ctx.saved_tensors
        dw, dgamma, dbeta = stem_train_backward(dy.contiguous(), x, stats, w,
                                                gamma, beta, *ctx.geom)
        return None, dw, dgamma, dbeta, None, None, None
