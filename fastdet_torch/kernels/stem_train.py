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
package's group-1 and grouped kernels, with g as an argument.  It sweeps
the conv once each way, from two identities that the plain helpers below
state: the pool commutes with BN and ReLU if it takes the raw conv's max
where γ ≥ 0 and its min where γ < 0 (`stem_train_pooled_reference`,
`stem_train_emit_reference`: bit for bit), so the forward pools the raw
conv in the sweep that takes the moments and writes that extreme z; and
the backward's BN sums Sg, Sgx follow from (dy, z) without a conv
(`stem_train_sums_reference`), so its one sweep recomputes the conv,
routes dy, forms du and the weight gradient, and takes dγ, dβ from the
routed gradient (z does not tell the winner where γ = 0).
`stem_train_plan` gives the launches, tiles and shared memory.

`stem_train_forward` / `stem_train_backward` launch the CUDA kernels on a
CUDA tensor (or raise) and run the plain versions
`stem_train_forward_reference` / `stem_train_backward_reference` only on a
CPU tensor; each counts its calls that launch kernels in `.launches`.
`StemTrain` is the autograd.Function around them: it saves x, the stats
and z, and its backward recomputes the conv from them.  The plain versions
do the kernels' operations in the kernels' order (the CUDA source is built
with `--fmad=false`), so from the same saved stats both recompute the same
conv outputs, ReLU masks and pool routing bit for bit.

bf16 (`bf16=True`, the JAX kernels at `dtype=bfloat16`): the weight is
bf16(w) (w already scaled by 1/255 in f32), the u8 pixels are exact, so
the conv sums stay f32; yb = bf16(ReLU(bn)) is pooled, y is bf16; the
statistics are f32; the backward routes dy by the JAX precedence among
the rounded yb, recomputed as the forward rounds them, and rounds du to
bf16 before the dW product.  The statistics keep the port's two-pass
variance; JAX's stem takes max(E[u²] − μ², 0) (ROADMAP §C).  The kernels
are `stem_train_forward_bf16` / `stem_train_backward_bf16` (the same
kernels with bf16's rounding points, counts of their own); their two
approximations of the bf16 function are stated in `csrc/stem_train.cu`.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from fastdet_torch.kernels import _build
from fastdet_torch.models.layers import round16

EPS = 1e-5
COUT = 24
BF16 = torch.bfloat16


def _rounded(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    """t at a bf16 rounding point (`round16`) where bf16, else t."""
    return round16(t) if bf16 else t


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
                                 g: int, bf16: bool = False):
    """Plain version of the forward kernels, any device and float dtype
    (that of w), or with `bf16` the bf16 function from an f32 w.  → (y
    (B, 24, h4, w4) (bf16 for bf16), stats (B/g, 24, 3))."""
    u = _conv(_image(x, h4, w4, w.dtype), _rounded(w, bf16))
    stats = _group_stats(u, g)
    bn, _ = _bn_parts(u, stats, gamma, beta, g)
    if bf16:
        return F.max_pool2d(torch.relu(bn).to(BF16), 3, 2, 1), stats
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
                                  w4: int, g: int, bf16: bool = False):
    """Plain version of the backward kernels (an explicit backward, not
    autograd): recompute the conv from x, BN from the saved stats, route
    dy through the pool and the ReLU, then BN's backward within each group
    and the weight gradient.  With `bf16`, the bf16 function: the route
    among the rounded yb, du rounded before dW.  → (dW (24, 3, 3, 3), dγ
    (24,), dβ (24,))."""
    b = x.shape[0]
    imgp = _image(x, h4, w4, w.dtype)
    u = _conv(imgp, _rounded(w, bf16))
    bn, xhat = _bn_parts(u, stats, gamma, beta, g)
    yb = _rounded(torch.relu(bn), bf16)
    gy = _route(yb, dy.float() if bf16 else dy)
    gy = torch.where(bn > 0, gy, torch.zeros_like(gy))
    sg = gy.reshape(b // g, g, COUT, -1).sum((1, 3))
    sgx = (gy * xhat).reshape(b // g, g, COUT, -1).sum((1, 3))
    inv_m = 1.0 / (g * 4 * h4 * w4)
    du = (_per_image(gamma * stats[:, :, 1], g)
          * ((gy - _per_image(sg * inv_m, g))
             - xhat * _per_image(sgx * inv_m, g)))
    du = _rounded(du, bf16)
    dw = torch.empty_like(w)
    for ky in range(3):
        for kx in range(3):
            for c in range(3):
                dw[:, c, ky, kx] = (du * _tap(imgp, c, ky, kx)[:, None]).sum(
                    (0, 2, 3))
    return dw, sgx.sum(0), sg.sum(0)


def pooled_extreme(u: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Raw conv outputs (B, 24, 2·h4, 2·w4) → z (B, 24, h4, w4): the 3×3
    s2 pad-1 pool of u, its max on a channel with γ ≥ 0 and its min on one
    with γ < 0."""
    neg = (gamma < 0)[None, :, None, None]
    return torch.where(neg, -F.max_pool2d(-u, 3, 2, 1),
                       F.max_pool2d(u, 3, 2, 1))


def stem_train_pooled_reference(x, w, gamma, h4: int, w4: int):
    """Plain version of the forward sweep's pooled output: z of the conv,
    (B, 24, h4, w4).  Each rounded step of bn and ReLU is monotone in u
    (non-decreasing for γ ≥ 0, non-increasing for γ < 0), so
    `stem_train_emit_reference(z, stats, …)` is the forward's y bit for
    bit, whatever the stats."""
    return pooled_extreme(_conv(_image(x, h4, w4, w.dtype), w), gamma)


def stem_train_emit_reference(z, stats, gamma, beta, g: int):
    """y = ReLU((z − μ)·(σinv·γ) + β) with the group's stats: BN and ReLU
    after the pool (the forward's last pass)."""
    bn, _ = _bn_parts(z, stats, gamma, beta, g)
    return torch.relu(bn)


def stem_train_sums_reference(dy, z, stats, gamma, beta, g: int):
    """The backward's BN sums from the pooled cotangent alone → (Sg, Sgx),
    each (B/g, 24): Sg = Σ dy·[bn(z) > 0], Sgx = Σ dy·[bn(z) > 0]·x̂(z).
    A pool window passes dy to one winner, whose ReLU output is y, so these
    are the routed sums wherever the winner's x̂ is z's: up to ties of bn
    between different u (rounding noise in Sgx), and not on a channel
    whose σinv·γ is 0, where every member ties and only the routed gy
    gives dγ (there du = 0, so dW does not depend on it)."""
    b = dy.shape[0]
    bn, xhat = _bn_parts(z, stats, gamma, beta, g)
    gy = torch.where(bn > 0, dy, torch.zeros_like(dy))
    return (gy.reshape(b // g, g, COUT, -1).sum((1, 3)),
            (gy * xhat).reshape(b // g, g, COUT, -1).sum((1, 3)))


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


# ------------------------------------------------------------ the plan

FWD_ROWS = 11           # cell rows of a forward tile, at most (kFR)
FWD_WARP_COLS = 31      # cell columns a forward warp owns (kFWarpCols)
FWD_MAX_WARPS = 3       # warps across a forward tile (93 columns)
FWD_GROUPS = 4          # channel groups of 6, each its own warps (kFGroups)
BWD_TILE = 8            # a backward tile is 8×8 cells (kBT)
BWD_THREADS = 256
BWD_HALO = 33           # halo conv outputs a backward tile recomputes
SMEM_PER_CTA = 232_448  # bytes of shared memory a CTA may use on sm_90
SMS = 132               # the H100's SMs
FWD_KERNELS = ("stem_fwd_sweep_kernel", "stem_stats_combine_kernel",
               "stem_fwd_emit_kernel")
BWD_KERNELS = ("stem_bwd_sums_kernel", "stem_bwd_sweep_kernel",
               "stem_bwd_reduce_kernel")


def _smem_bytes() -> Dict[str, int]:
    """Dynamic shared memory of the two sweeps (`fastdet_stem_train_smem`):
    the forward's weights, signs, per-warp moments and input rows; the
    backward's `BwdSmem`."""
    fwd = (4 * (27 * COUT + COUT + FWD_MAX_WARPS * FWD_GROUPS * 6 * 3)
           + 48 * (FWD_ROWS + 1) * 100)
    rc, wc = (BWD_TILE + 1) ** 2, (BWD_TILE + 2) ** 2
    floats = (27 * COUT + 3 * COUT + 4 * COUT * rc + 2 * COUT * wc
              + (4 * BWD_TILE ** 2 + BWD_HALO) * COUT + 8 * COUT * 2)
    codes = 3 * COUT * wc
    inputs = 2 * 48 * (BWD_TILE + 1) * 16
    return {"stem_fwd_sweep_kernel": fwd,
            "stem_bwd_sweep_kernel": 4 * floats + codes + inputs}


def _bwd_halo():
    """The 33 halo outputs of a backward tile as (row, col, phase) of its
    9×9-cell region (`halo_point`): phase (0, 1) of the left column, phase
    (1, 0) of the top row, then phase (1, 1) of the top row, the left
    column and the corner."""
    edge = range(1, BWD_TILE + 1)
    return ([(r, 0, 1) for r in edge] + [(0, c, 2) for c in edge]
            + [(0, c, 3) for c in edge] + [(r, 0, 3) for r in edge]
            + [(0, 0, 3)])


def _fwd_outputs(h4: int, w4: int, tr: int, ncw: int) -> int:
    """Conv outputs inside the image that the forward sweep computes: each
    band's cells (and a warp's left column again where it lies inside the
    image), four phases each, and the phases py = 1 of the row above a
    band that does not start at row 0."""
    cw = FWD_WARP_COLS * ncw
    cols = 0
    for c0 in range(0, w4, cw):
        for k in range(ncw):
            lo = c0 + k * FWD_WARP_COLS - 1
            cols += len(range(max(lo, 0), min(lo + 32, c0 + cw, w4)))
    rows = sum(4 * min(tr, h4 - i0) + 2 * (i0 > 0) for i0 in range(0, h4, tr))
    return cols * rows


def _bwd_outputs(h4: int, w4: int) -> int:
    """Conv outputs inside the image that the backward sweep computes: each
    tile's own and its halo's."""
    t = BWD_TILE
    halo = _bwd_halo()
    n = 0
    for i0 in range(0, h4, t):
        for j0 in range(0, w4, t):
            n += 4 * min(t, h4 - i0) * min(t, w4 - j0)
            n += sum(0 <= i0 - 1 + r < h4 and 0 <= j0 - 1 + c < w4
                     for r, c, _ in halo)
    return n


@dataclass(frozen=True)
class StemTrainPlan:
    """How `csrc/stem_train.cu` runs one call at (b, h4, w4, g).

    Forward sweep: one CTA of 128·ncw threads per tile of `tile_fwd` =
    (rows, 31·ncw) cells of one image (row bands; wider images in column
    chunks): each warp owns 31 cell columns for one group of 6 channels
    and computes the column to their left again (the pool's column 2j−1
    comes by shuffle); the band's top row costs the phases py = 1 of one
    more row.  Backward sweep: one CTA of 256 threads per band of 8 cell
    rows of one image, its 8×8-cell tiles left to right; a tile owns its
    64 windows and recomputes 33 halo outputs (the pool's row 2i−1 and
    column 2j−1 to its top and left).  `sweeps_*` counts the conv outputs
    a call computes at places inside the image, a tile's own and its
    halo's, over the image's."""
    tile_fwd: Tuple[int, int]
    tile_bwd: Tuple[int, int]
    ctas_fwd: int
    ctas_bwd: int
    threads_fwd: int
    threads_bwd: int
    smem_by_kernel: Dict[str, int]
    kernels_fwd: Tuple[str, ...]
    kernels_bwd: Tuple[str, ...]
    sweeps_fwd: float
    sweeps_bwd: float

    @property
    def launches_fwd(self) -> int:
        return len(self.kernels_fwd)

    @property
    def launches_bwd(self) -> int:
        return len(self.kernels_bwd)

    @property
    def ncw(self) -> int:
        return self.tile_fwd[1] // FWD_WARP_COLS


@functools.lru_cache(maxsize=64)
def stem_train_plan(b: int, h4: int, w4: int, g: int) -> StemTrainPlan:
    """The launch plan of B7 for b images of (4·h4)×(4·w4) at ghost group
    g (g does not change it: a group is whole images)."""
    del g
    tr = -(-h4 // -(-h4 // FWD_ROWS))    # balanced bands of ≤ FWD_ROWS
    ncw = min(FWD_MAX_WARPS, -(-w4 // FWD_WARP_COLS))
    cw = FWD_WARP_COLS * ncw
    nchunk = -(-w4 // cw)
    nband = -(-h4 // tr)
    hw4 = 4 * h4 * w4
    return StemTrainPlan(
        tile_fwd=(tr, cw), tile_bwd=(BWD_TILE, BWD_TILE),
        ctas_fwd=b * nband * nchunk, ctas_bwd=b * -(-h4 // BWD_TILE),
        threads_fwd=FWD_GROUPS * 32 * ncw, threads_bwd=BWD_THREADS,
        smem_by_kernel=_smem_bytes(), kernels_fwd=FWD_KERNELS,
        kernels_bwd=BWD_KERNELS,
        sweeps_fwd=_fwd_outputs(h4, w4, tr, ncw) / hw4,
        sweeps_bwd=_bwd_outputs(h4, w4) / hw4)


# ------------------------------------------------------------ the kernels

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "fastdet_stem_train_fwd": ([_P] * 8 + [_I] * 7 + [_P], _I),
    "fastdet_stem_train_fwd_bf16": ([_P] * 8 + [_I] * 7 + [_P], _I),
    "fastdet_stem_train_bwd": ([_P] * 11 + [_I] * 5 + [_P], _I),
    "fastdet_stem_train_bwd_bf16": ([_P] * 11 + [_I] * 5 + [_P], _I),
    "fastdet_stem_train_fwd_scratch": ([_I] * 5, ctypes.c_size_t),
    "fastdet_stem_train_bwd_scratch": ([_I] * 2, ctypes.c_size_t),
    "fastdet_stem_train_smem": ([_I], ctypes.c_size_t),
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


def _forward(counter, bf16: bool, x, w, gamma, beta, h4: int, w4: int,
             g: int):
    """The forward of either form: CPU → the plain versions; CUDA → the C
    entry of `csrc/stem_train.cu` (one counted call on `counter`)."""
    dev = x.device
    if dev.type == "cpu":
        return (*stem_train_forward_reference(x, w, gamma, beta, h4, w4, g,
                                              bf16),
                stem_train_pooled_reference(x, _rounded(w, bf16), gamma, h4,
                                            w4))
    what = counter.__name__
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    b, npad = _check(what, x, w, gamma, beta, h4, w4, g)
    plan = stem_train_plan(b, h4, w4, g)
    lib = _build.load("stem_train", _SIGNATURES)
    y = torch.empty((b, COUT, h4, w4),
                    dtype=BF16 if bf16 else torch.float32, device=dev)
    z = torch.empty((b, COUT, h4, w4), dtype=torch.float32, device=dev)
    stats = torch.empty((b // g, COUT, 3), dtype=torch.float32, device=dev)
    tr, ncw = plan.tile_fwd[0], plan.ncw
    scratch = torch.empty(
        lib.fastdet_stem_train_fwd_scratch(b, h4, w4, tr, ncw),
        dtype=torch.float32, device=dev)
    fn = (lib.fastdet_stem_train_fwd_bf16 if bf16
          else lib.fastdet_stem_train_fwd)
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), w.data_ptr(), gamma.data_ptr(),
                beta.data_ptr(), y.data_ptr(), z.data_ptr(),
                stats.data_ptr(), scratch.data_ptr(), b, h4, w4, npad, g, tr,
                ncw, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, what)
    counter.launches += 1
    return y, stats, z


def stem_train_forward(x, w, gamma, beta, h4: int, w4: int, g: int):
    """→ (y (B, 24, h4, w4), stats (B/g, 24, 3)) as
    `stem_train_forward_reference`, and z (B, 24, h4, w4), the pooled raw
    conv that the backward takes.  CUDA: the forward kernels of
    `csrc/stem_train.cu` (one counted call); CPU: the plain versions."""
    return _forward(stem_train_forward, False, x, w, gamma, beta, h4, w4, g)


def stem_train_forward_bf16(x, w, gamma, beta, h4: int, w4: int, g: int):
    """The bf16 form of `stem_train_forward`: y bf16 (stats and z f32)."""
    return _forward(stem_train_forward_bf16, True, x, w, gamma, beta, h4,
                    w4, g)


stem_train_forward.launches = 0
stem_train_forward_bf16.launches = 0


def _backward(counter, bf16: bool, dy, x, stats, w, gamma, beta, h4: int,
              w4: int, g: int, z):
    """The backward of either form: CPU → the plain version; CUDA → the C
    entry (one counted call on `counter`)."""
    dev = x.device
    if dev.type == "cpu":
        return stem_train_backward_reference(dy, x, stats, w, gamma, beta,
                                             h4, w4, g, bf16)
    what = counter.__name__
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    b, npad = _check(what, x, w, gamma, beta, h4, w4, g)
    for name, t, shape, dt in (
            ("dy", dy, (b, COUT, h4, w4), BF16 if bf16 else torch.float32),
            ("z", z, (b, COUT, h4, w4), torch.float32),
            ("stats", stats, (b // g, COUT, 3), torch.float32)):
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{what}: expected {name} as a contiguous {dt} {shape} "
                f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    lib = _build.load("stem_train", _SIGNATURES)
    dw = torch.empty_like(w)
    dgamma = torch.empty_like(gamma)
    dbeta = torch.empty_like(beta)
    scratch = torch.empty(lib.fastdet_stem_train_bwd_scratch(b, h4),
                          dtype=torch.float32, device=dev)
    fn = (lib.fastdet_stem_train_bwd_bf16 if bf16
          else lib.fastdet_stem_train_bwd)
    with torch.cuda.device(dev):
        rc = fn(dy.data_ptr(), x.data_ptr(), z.data_ptr(), stats.data_ptr(),
                w.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                dw.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
                scratch.data_ptr(), b, h4, w4, npad, g,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, what)
    counter.launches += 1
    return dw, dgamma, dbeta


def stem_train_backward(dy, x, stats, w, gamma, beta, h4: int, w4: int,
                        g: int, z):
    """→ (dW, dγ, dβ) as `stem_train_backward_reference`.  CUDA: the
    backward kernels of `csrc/stem_train.cu` (one counted call), which
    take z, the forward's pooled raw conv, for the BN sums; partial sums
    reduced in a fixed order, so two runs give the same bits.  CPU: the
    plain version, which recomputes everything from x and does not read
    z."""
    return _backward(stem_train_backward, False, dy, x, stats, w, gamma,
                     beta, h4, w4, g, z)


def stem_train_backward_bf16(dy, x, stats, w, gamma, beta, h4: int, w4: int,
                             g: int, z):
    """The bf16 form of `stem_train_backward`: dy bf16, the gradients
    f32."""
    return _backward(stem_train_backward_bf16, True, dy, x, stats, w, gamma,
                     beta, h4, w4, g, z)


stem_train_backward.launches = 0
stem_train_backward_bf16.launches = 0


class StemTrain(torch.autograd.Function):
    """The differentiable training stem: `StemTrain.apply(x_u8, w, gamma,
    beta, h4, w4, g, bf16=False) -> (y, stats)`; w is the scaled OIHW
    weight (f32 in both forms); with `bf16` the bf16 form (y bf16); stats
    carry no gradient (they feed the running statistics), x gets none.
    It saves z, the pooled raw conv, for the backward's BN sums
    ((B, 24, h4, w4) f32)."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, h4, w4, g, bf16=False):
        fwd = stem_train_forward_bf16 if bf16 else stem_train_forward
        y, stats, z = fwd(x, w, gamma, beta, h4, w4, g)
        ctx.save_for_backward(x, stats, w, gamma, beta, z)
        ctx.geom = (h4, w4, g)
        ctx.bf16 = bf16
        ctx.mark_non_differentiable(stats)
        return y, stats

    @staticmethod
    def backward(ctx, dy, _dstats):
        x, stats, w, gamma, beta, z = ctx.saved_tensors
        bwd = stem_train_backward_bf16 if ctx.bf16 else stem_train_backward
        dw, dgamma, dbeta = bwd(dy.contiguous(), x, stats, w, gamma, beta,
                                *ctx.geom, z)
        return None, dw, dgamma, dbeta, None, None, None, None
