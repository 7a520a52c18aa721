"""The training span B8: the stride-1 ShuffleV2 blocks of one backbone
stage with ghost BatchNorm, forward and backward (counterpart of
fastdet/kernels/fused_train.py, `make_span_train`).

One block, on an NCHW activation x (B, C, h, w), C = 2·mid:
  u1 = pw1(x[:, 1::2])       y = ReLU(BN1(u1))
  u2 = dw3×3(y) (zero pad)   v = BN2(u2)
  u3 = pw2(v)                z = ReLU(BN3(u3))
  out = cat[x[:, 0::2], z]
Each BN takes its statistics over a ghost group: the g consecutive images
of the group, g·h·w samples per channel, the mean first and then the
biased variance mean((u-μ)²), eps 1e-5.  g is the JAX package's
`pick_train_group`, which derives it from a TPU VMEM budget; the group
is part of the function, so the port keeps it whatever its own tiling.
The running statistics are exact full-batch: `combine_ghost_stats` pools
the groups' (μ, var).

The TPU kernel's MXU forms (the merged odd-select·pw1 matrix, the
(mid, 9·mid) diag-expanded depthwise weight) and its lane rolls are not
carried over: the even channels pass through, the odd ones go into pw1,
and dw3×3 is 9 taps per channel with a (9, mid) weight.

Packed weights, one row per block, f32 (`pack_span_train_weights`):
  [w1 (mid_in × mid_out) | wd (9 × mid, tap dy·3+dx major) |
   w2 (mid_in × mid_out) | γ1 β1 γ2 β2 γ3 β3 (6 × mid)],
2·mid² + 15·mid floats.  The row is built from the modules' parameters
by differentiable torch ops, so the packed gradient flows back to them.
Stats: (nblk, 3 BNs, G groups, [μ, σinv, var], mid).  xsave: the block
inputs (nblk, B, C, h, w).

`span_train_forward` / `span_train_backward` launch the hand-written
CUDA kernels of `csrc/span_train.cu` on a CUDA tensor (or raise) and run
the plain versions `span_train_forward_reference` /
`span_train_backward_reference` only on a CPU tensor.  Each counts its
calls that launch kernels in `.launches`.  `span_train_plan` is their
launch plan (each CTA's pixel tile in the forward and in the backward,
shared memory, grids, device launches per call); the wrappers pass its
tiles to the kernels.
`SpanTrain` is the autograd.Function around them: its forward saves the
block inputs and the ghost stats, its backward recomputes each block
from them.

The plain versions repeat the kernels' arithmetic in order: a pointwise
conv is a loop over input channels of acc = acc + x·w, the depthwise
conv a loop over the 9 taps, and BN is (u-μ)·(σinv·γ)+β; the CUDA source
is built with `--fmad=false`.  So from the same saved inputs and stats
the backward's recomputed ReLU masks are the same bit for bit on both
sides, and the kernels agree with the plain versions up to the order of
their sums.

bf16 (the JAX kernels at `dtype=bfloat16`, the JAX package's bf16
training): a bf16 x gives the bf16 function, which rounds inside the
block, not around it.  The weights are rounded per matrix (bf16(w1),
bf16(wd), bf16(w2)); y, v and z round to bf16; u1, u2, u3 and every
statistic stay f32; the saved block inputs and the span's output are
bf16.  The backward rounds du3 before dv = w2·du3, du2 before the
depthwise products, and du1 and the passthrough gradient before dx; dW2
= v ⊗ du3 and dW1 = x ⊗ du1 are f32 products of the upcast bf16 v and x;
the gradient between blocks stays f32 and dx leaves the span as bf16.
The plain versions compute it in f32 from the bf16-rounded operands (a
bf16 × bf16 product is exact in f32), not by torch's bf16 ops, which
round their outputs.  `span_train_forward_bf16` /
`span_train_backward_bf16` launch the bf16 C entries of
`csrc/span_train.cu` (the same kernels on bf16 activations; the plan is
the f32 form's), with launch counts of their own.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from fastdet_torch.kernels import _build
from fastdet_torch.kernels.fused_infer import SPAN_CHANNELS
from fastdet_torch.models.layers import round16

EPS = 1e-5
BF16 = torch.bfloat16

# lanes per training-span program on the TPU (the JAX package's
# _TRAIN_LANE_BUDGET): it fixes the ghost group, so it is kept as is
_TRAIN_LANE_BUDGET = {48: 4096, 96: 2048, 192: 2048}


def pick_train_group(b: int, nimg: int, c: int) -> int:
    """The ghost-BN group of the JAX package for a batch of b images of
    nimg (128-padded h·w) lanes at c channels."""
    g = 1
    budget = _TRAIN_LANE_BUDGET.get(c, 2048)
    while (b % (g * 2) == 0) and (g * 2 * nimg <= budget):
        g *= 2
    return g


def row_len(mid: int) -> int:
    return 2 * mid * mid + 15 * mid


def row_sections(mid: int):
    """[(name, start, stop)] of the fields of a packed row."""
    sizes = [("w1", mid * mid), ("wd", 9 * mid), ("w2", mid * mid)] + [
        (n, mid) for n in ("g1", "b1", "g2", "b2", "g3", "b3")]
    out, at = [], 0
    for name, n in sizes:
        out.append((name, at, at + n))
        at += n
    return out


def pack_span_train_weights(blocks: Sequence[torch.nn.Module]
                            ) -> torch.Tensor:
    """Stride-1 `ShuffleV2Block`s → (nblk, 2·mid² + 15·mid) packed rows,
    differentiable with respect to the blocks' parameters."""
    rows = []
    for blk in blocks:
        mid = blk.main_pw.conv.weight.shape[0]
        w1 = blk.main_pw.conv.weight[:, :, 0, 0].t()          # (in, out)
        wd = blk.main_dw.conv.weight[:, 0].reshape(mid, 9).t()
        w2 = blk.main_pw_linear.conv.weight[:, :, 0, 0].t()
        gb = [p for m in (blk.main_pw, blk.main_dw, blk.main_pw_linear)
              for p in (m.bn.weight, m.bn.bias)]
        rows.append(torch.cat([w1.reshape(-1), wd.reshape(-1),
                               w2.reshape(-1)] + gb))
    return torch.stack(rows)


def _unpack(row: torch.Tensor, mid: int):
    w1, wd, w2, gb = torch.split(row, (mid * mid, 9 * mid, mid * mid,
                                       6 * mid))
    return (w1.reshape(mid, mid), wd.reshape(9, mid), w2.reshape(mid, mid),
            gb.reshape(6, mid))


# ------------------------------------------------------------ plain versions

def _per_image(t: torch.Tensor, g: int) -> torch.Tensor:
    """(G, mid) per-group values → (B, mid, 1, 1)."""
    return t.repeat_interleave(g, 0)[:, :, None, None]


def _group_stats(u: torch.Tensor, g: int) -> torch.Tensor:
    """(B, mid, h, w) → (3, G, mid): μ, σinv, var over each group."""
    b, mid = u.shape[:2]
    ug = u.reshape(b // g, g, mid, -1)
    mu = ug.mean((1, 3))
    d = ug - mu[:, None, :, None]
    var = (d * d).mean((1, 3))
    return torch.stack([mu, torch.rsqrt(var + EPS), var])


def _bn(u, st, gamma, beta, g):
    """(u-μ)·(σinv·γ)+β with the group's saved (μ, σinv)."""
    return ((u - _per_image(st[0], g)) * _per_image(st[1] * gamma, g)
            + beta[:, None, None])


def _xhat(u, st, g):
    return (u - _per_image(st[0], g)) * _per_image(st[1], g)


def _pw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """1×1 conv as the kernel sums it: out[o] = Σ_i x[i]·w[i, o], input
    channels in order, one rounding per product and per sum."""
    acc = torch.zeros((x.shape[0], w.shape[1]) + x.shape[2:],
                      dtype=x.dtype, device=x.device)
    for i in range(w.shape[0]):
        acc = acc + x[:, i:i + 1] * w[i][None, :, None, None]
    return acc


def _dw(x: torch.Tensor, wd: torch.Tensor, flip: bool = False):
    """Depthwise 3×3, zero pad, taps in order t = (dy+1)·3 + (dx+1);
    `flip` takes tap 8-t's weight (the transposed conv of the backward)."""
    h, w = x.shape[2:]
    xp = F.pad(x, (1, 1, 1, 1))
    acc = torch.zeros_like(x)
    for t in range(9):
        ky, kx = t // 3, t % 3
        acc = acc + (wd[8 - t if flip else t][None, :, None, None]
                     * xp[:, :, ky:ky + h, kx:kx + w])
    return acc


def _rounding(bf16: bool):
    """bf16's rounding points (`round16`), or the identity."""
    return round16 if bf16 else (lambda t: t)


def _block_forward(x, row, st, g, rnd=_rounding(False)):
    """One block from x with stats `st` (3, 3, G, mid) → (u1, y, u2, v,
    u3, out); `rnd` rounds at bf16's points."""
    mid = x.shape[1] // 2
    w1, wd, w2, gb = _unpack(row, mid)
    u1 = _pw(x[:, 1::2], rnd(w1))
    y = rnd(torch.relu(_bn(u1, st[0], gb[0], gb[1], g)))
    u2 = _dw(y, rnd(wd))
    v = rnd(_bn(u2, st[1], gb[2], gb[3], g))
    u3 = _pw(v, rnd(w2))
    z = rnd(torch.relu(_bn(u3, st[2], gb[4], gb[5], g)))
    return u1, y, u2, v, u3, torch.cat([x[:, 0::2], z], 1)


def span_train_forward_reference(x: torch.Tensor, blocks: torch.Tensor,
                                 g: int):
    """Plain version of the forward kernel, any device and float dtype
    (bf16 x: the bf16 function, computed in f32).  x (B, C, h, w), blocks
    (nblk, row) → (out (B, C, h, w), xsave (nblk, B, C, h, w), stats
    (nblk, 3, G, 3, mid)); out and xsave in x's dtype, stats f32 for
    bf16."""
    bf16 = x.dtype == BF16
    rnd = _rounding(bf16)
    x = x.float() if bf16 else x
    mid = x.shape[1] // 2
    xsave, stats = [], []
    for row in blocks:
        xsave.append(x)
        w1, wd, w2, gb = _unpack(row, mid)
        u1 = _pw(x[:, 1::2], rnd(w1))
        st1 = _group_stats(u1, g)
        y = rnd(torch.relu(_bn(u1, st1, gb[0], gb[1], g)))
        u2 = _dw(y, rnd(wd))
        st2 = _group_stats(u2, g)
        u3 = _pw(rnd(_bn(u2, st2, gb[2], gb[3], g)), rnd(w2))
        st3 = _group_stats(u3, g)
        z = rnd(torch.relu(_bn(u3, st3, gb[4], gb[5], g)))
        x = torch.cat([x[:, 0::2], z], 1)
        stats.append(torch.stack([st1, st2, st3]).transpose(1, 2))
    xsave = torch.stack(xsave)
    if bf16:
        x, xsave = x.to(BF16), xsave.to(BF16)
    return x, xsave, torch.stack(stats)


def _bn_backward(gr, xhat, gamma, sinv, g):
    """Backward of γ·x̂+β under the group's stats: (du, dγ, dβ), with the
    group sums Σg and Σg·x̂ (`_bn_bwd` of the JAX kernel)."""
    b, mid = gr.shape[:2]
    m = g * gr.shape[2] * gr.shape[3]
    sg = gr.reshape(b // g, g, mid, -1).sum((1, 3))
    sgx = (gr * xhat).reshape(b // g, g, mid, -1).sum((1, 3))
    du = (_per_image(gamma * sinv, g)
          * (gr - _per_image(sg / m, g) - xhat * _per_image(sgx / m, g)))
    return du, sgx.sum(0), sg.sum(0)


def span_train_backward_reference(dy: torch.Tensor, xsave: torch.Tensor,
                                  stats: torch.Tensor, blocks: torch.Tensor,
                                  g: int, acc: torch.dtype = torch.float32):
    """Plain version of the backward kernel (an explicit backward, not
    autograd): recompute each block from its saved input and the saved
    stats, then backprop.  → (dx (B, C, h, w), dblocks (nblk, row)); a
    bf16 dy gives the bf16 function (dx bf16, dblocks f32), computed in
    `acc` (float64: the same rounding points with every sum in f64, the
    yardstick of how far two f32 sum orders of the function stand apart;
    dblocks then f64)."""
    bf16 = dy.dtype == BF16
    rnd = _rounding(bf16)
    if bf16:
        dy, stats, blocks = dy.to(acc), stats.to(acc), blocks.to(acc)
    b, c, h, w = dy.shape
    mid = c // 2
    dblocks = []
    for i in range(blocks.shape[0] - 1, -1, -1):
        x, row = xsave[i], blocks[i]
        x = x.to(acc) if bf16 else x
        st = stats[i].transpose(1, 2)                     # (3, 3, G, mid)
        w1, wd, w2, gb = _unpack(row, mid)
        u1, y, u2, v, u3, _ = _block_forward(x, row, st, g, rnd)
        dz = dy[:, mid:]
        gz = torch.where(_bn(u3, st[2], gb[4], gb[5], g) > 0, dz,
                         torch.zeros_like(dz))
        du3, dg3, db3 = _bn_backward(gz, _xhat(u3, st[2], g), gb[4],
                                     st[2][1], g)
        dw2 = torch.einsum("bihw,bohw->io", v, du3)
        dv = _pw(rnd(du3), rnd(w2).t())
        du2, dg2, db2 = _bn_backward(dv, _xhat(u2, st[1], g), gb[2],
                                     st[1][1], g)
        du2 = rnd(du2)
        yp = F.pad(y, (1, 1, 1, 1))
        dwd = torch.stack([
            (du2 * yp[:, :, t // 3:t // 3 + h, t % 3:t % 3 + w]).sum(
                (0, 2, 3)) for t in range(9)])
        dyy = _dw(du2, rnd(wd), flip=True)
        gy = torch.where(_bn(u1, st[0], gb[0], gb[1], g) > 0, dyy,
                         torch.zeros_like(dyy))
        du1, dg1, db1 = _bn_backward(gy, _xhat(u1, st[0], g), gb[0],
                                     st[0][1], g)
        dw1 = torch.einsum("bihw,bohw->io", x[:, 1::2], du1)
        dxo = _pw(rnd(du1), rnd(w1).t())
        dy = torch.stack([rnd(dy[:, :mid]), dxo], 2).reshape(b, c, h, w)
        dblocks.append(torch.cat([dw1.reshape(-1), dwd.reshape(-1),
                                  dw2.reshape(-1), dg1, db1, dg2, db2, dg3,
                                  db3]))
    return (dy.to(BF16) if bf16 else dy), torch.stack(dblocks[::-1])


def combine_ghost_stats(stats: torch.Tensor):
    """(nblk, 3, G, 3, mid) per-group [μ, σinv, var] → the exact
    full-batch (mean, var), each (nblk, 3, mid), for equal group sizes:
    mean = E_g[μ_g], var = E_g[var_g] + E_g[(μ_g − mean)²].  The JAX
    package writes the same variance as E_g[var_g + μ_g²] − mean², which
    cancels in f32 where |μ| ≫ σ (3% off on the card at b128, where two
    equal runs' groups differed by one rounding); this form has no
    cancellation."""
    mus, vars_ = stats[:, :, :, 0], stats[:, :, :, 2]
    mean = mus.mean(2)
    d = mus - mean[:, :, None]
    return mean, vars_.mean(2) + (d * d).mean(2)


# ------------------------------------------------------------ launch plan

# Pixels of one CTA's tile by mid, at most TILE_COLS wide, chosen by
# timing the stage calls at b128 352² on the card with several tile
# heights (PERF.md §6).  Backward: 4×44, 6×22 and 6×11, the stage-4
# tile the largest whose weight gradients still have one partial row for
# each of 132 SMs (whole images would leave 128).  Forward: 11×44, 11×22
# and 11×11 (a quarter, half and whole image), so that stages 3-4 run in
# one wave of CTAs.
TILE_PIXELS = {24: 176, 48: 132, 96: 66}
FWD_TILE_PIXELS = {24: 484, 48: 242, 96: 121}
TILE_COLS = 64
SMEM_PER_CTA = 232_448     # bytes of shared memory a CTA may use on sm_90
SMEM_PER_SM = 233_472      # the SM's 228 KB, 1 KB of it reserved per CTA
THREADS = 256
# the dW product's pixel groups (csrc/span_train.cu, DW<MID>::PG)
_DW_GROUPS = {24: 4, 48: 4, 96: 1}
FWD_KERNELS = ("in", "fwd_dw", "fwd_pw2")
BWD_KERNELS = ("in", "rec", "bn3", "bn2", "bn1")


def _smem_floats(mid: int, tr: int, tc: int) -> Dict[str, int]:
    """Shared-memory floats of each kernel of csrc/span_train.cu
    (`Smem<MID>`), for tiles of tr × tc pixels."""
    ps = (tr * tc) | 1
    phs = ((tr + 2) * (tc + 2)) | 1
    constf, const = 12 * mid, 18 * mid
    comb = _DW_GROUPS[mid] * mid * mid if _DW_GROUPS[mid] > 1 else 0
    bn3 = mid * mid + const + 2 * mid * ps + comb
    return {"in": mid * mid + constf + 2 * mid * ps,
            "fwd_dw": 9 * mid + constf + mid * phs + mid * ps,
            "fwd_pw2": mid * mid + constf + 2 * mid * ps,
            "rec": mid * mid + 9 * mid + const + mid * phs + mid * ps,
            "bn3": bn3, "bn2": 9 * mid + const + 2 * mid * phs, "bn1": bn3}


def _tile(h: int, w: int, pixels: int) -> Tuple[int, int]:
    tc = min(w, TILE_COLS)
    return max(1, min(h, pixels // tc)), tc


@dataclass(frozen=True)
class SpanTrainPlan:
    """How `csrc/span_train.cu` runs one stage call.  Every kernel is one
    CTA of THREADS threads per tile of (rows, cols) pixels of one image,
    `tile_fwd` in the forward, `tile_bwd` in the backward; a ghost group
    is a run of whole tiles, and each BN's statistics go from the
    producing kernel's epilogue (per tile) to the consuming kernel's
    prologue (merged over the group's tiles), so no thread-block cluster
    is used (`cluster` 1).  The weight gradients have one partial row per
    backward tile (`dw_grid` CTAs), added in a fixed order by one last
    launch.  `smem_bytes` is the most any kernel takes (`smem_by_kernel`:
    "in" at the backward tile, the forward's "in" as "in_fwd")."""
    cluster: int
    tile_fwd: Tuple[int, int]
    tile_bwd: Tuple[int, int]
    ctas_fwd: int
    ctas_bwd: int
    smem_bytes: int
    smem_by_kernel: Dict[str, int]
    dw_grid: int
    launches_fwd: int
    launches_bwd: int

    def smem_of(self, backward: bool) -> int:
        """Bytes of the forward's or the backward's largest kernel
        (`fastdet_span_train_smem`)."""
        keys = BWD_KERNELS if backward else ("in_fwd",) + FWD_KERNELS[1:]
        return max(self.smem_by_kernel[k] for k in keys)

    @property
    def pixels_per_cta(self) -> Tuple[int, int]:
        """(forward, backward) tile pixels."""
        return (self.tile_fwd[0] * self.tile_fwd[1],
                self.tile_bwd[0] * self.tile_bwd[1])


def span_train_plan(b: int, c: int, h: int, w: int, nblk: int,
                    g: int) -> SpanTrainPlan:
    """The launch plan of B8 for a (b, c, h, w) span input of nblk blocks
    at ghost group g."""
    mid = c // 2
    tf, tb = _tile(h, w, FWD_TILE_PIXELS[mid]), _tile(h, w, TILE_PIXELS[mid])
    fwd, bwd = _smem_floats(mid, *tf), _smem_floats(mid, *tb)
    smem = {k: 4 * bwd[k] for k in BWD_KERNELS}
    smem.update({k if k != "in" else "in_fwd": 4 * fwd[k]
                 for k in FWD_KERNELS})
    most = max(smem.values())

    def tiles(t):
        return b * -(-h // t[0]) * -(-w // t[1])

    return SpanTrainPlan(
        cluster=1, tile_fwd=tf, tile_bwd=tb, ctas_fwd=tiles(tf),
        ctas_bwd=tiles(tb), smem_bytes=most, smem_by_kernel=smem,
        dw_grid=tiles(tb),
        # forward: in, dw, pw2 per block and a last in; backward: in, rec,
        # bn3, bn2, bn1 per block and the partial rows' sum
        launches_fwd=3 * nblk + 1, launches_bwd=5 * nblk + 1)


# ------------------------------------------------------------ the kernels

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "fastdet_span_train_fwd": ([_P] * 6 + [_I] * 8 + [_P], _I),
    "fastdet_span_train_fwd_bf16": ([_P] * 6 + [_I] * 8 + [_P], _I),
    "fastdet_span_train_fwd_scratch": ([_I] * 8, ctypes.c_size_t),
    "fastdet_span_train_bwd": ([_P] * 7 + [_I] * 8 + [_P], _I),
    "fastdet_span_train_bwd_bf16": ([_P] * 7 + [_I] * 8 + [_P], _I),
    "fastdet_span_train_bwd_scratch": ([_I] * 8, ctypes.c_size_t),
    "fastdet_span_train_bwd_scratch_bf16": ([_I] * 8, ctypes.c_size_t),
    "fastdet_span_train_smem": ([_I] * 6, ctypes.c_size_t),
}


def _check_inputs(what, x, blocks, g, dtype):
    if (x.dim() != 4 or x.shape[1] not in SPAN_CHANNELS
            or x.dtype != dtype or not x.is_contiguous()):
        raise ValueError(
            f"{what}: expected a contiguous {dtype} (B, C, h, w) tensor with "
            f"C in {SPAN_CHANNELS}, got {x.dtype} {tuple(x.shape)}")
    b, c = x.shape[:2]
    mid = c // 2
    if (blocks.device != x.device or blocks.dtype != torch.float32
            or blocks.dim() != 2 or blocks.shape[1] != row_len(mid)
            or not blocks.is_contiguous()):
        raise ValueError(
            f"{what}: expected contiguous f32 weights "
            f"(nblk, {row_len(mid)}) on {x.device}")
    if g < 1 or b % g:
        raise ValueError(f"{what}: group {g} does not divide batch {b}")


def _forward(counter, bf16: bool, x, blocks, g):
    """The forward of either form: CPU → the plain version; CUDA → the C
    entry of `csrc/span_train.cu` (one counted call on `counter`)."""
    dev = x.device
    if dev.type == "cpu":
        return span_train_forward_reference(x, blocks, g)
    what = counter.__name__
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    _check_inputs(what, x, blocks, g, BF16 if bf16 else torch.float32)
    b, c, h, w = x.shape
    nblk, mid = blocks.shape[0], c // 2
    tr, tc = span_train_plan(b, c, h, w, nblk, g).tile_fwd
    out = torch.empty_like(x)
    xsave = torch.empty((nblk,) + tuple(x.shape), dtype=x.dtype, device=dev)
    stats = torch.empty((nblk, 3, b // g, 3, mid), dtype=torch.float32,
                        device=dev)
    lib = _build.load("span_train", _SIGNATURES)
    scratch = torch.empty(
        lib.fastdet_span_train_fwd_scratch(b, c, h, w, nblk, g, tr, tc),
        dtype=torch.float32, device=dev)
    fn = (lib.fastdet_span_train_fwd_bf16 if bf16
          else lib.fastdet_span_train_fwd)
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), blocks.data_ptr(), out.data_ptr(),
                xsave.data_ptr(), stats.data_ptr(), scratch.data_ptr(), b, c,
                h, w, nblk, g, tr, tc,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, what)
    counter.launches += 1
    return out, xsave, stats


def span_train_forward(x: torch.Tensor, blocks: torch.Tensor, g: int):
    """→ (out, xsave, stats) as `span_train_forward_reference`.  CUDA: the
    forward kernels of `csrc/span_train.cu` (one counted call); CPU: the
    plain version."""
    return _forward(span_train_forward, False, x, blocks, g)


def span_train_forward_bf16(x: torch.Tensor, blocks: torch.Tensor, g: int):
    """The bf16 form of `span_train_forward`: x, out and xsave bf16, stats
    f32."""
    return _forward(span_train_forward_bf16, True, x, blocks, g)


span_train_forward.launches = 0
span_train_forward_bf16.launches = 0


def _backward(counter, bf16: bool, dy, xsave, stats, blocks, g):
    """The backward of either form: CPU → the plain version; CUDA → the C
    entry (one counted call on `counter`)."""
    dev = dy.device
    if dev.type == "cpu":
        return span_train_backward_reference(dy, xsave, stats, blocks, g)
    what = counter.__name__
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    dt = BF16 if bf16 else torch.float32
    _check_inputs(what, dy, blocks, g, dt)
    b, c, h, w = dy.shape
    nblk, mid = blocks.shape[0], c // 2
    for t, shape, tdt in ((xsave, (nblk, b, c, h, w), dt),
                          (stats, (nblk, 3, b // g, 3, mid), torch.float32)):
        if (t.device != dev or t.dtype != tdt
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"{what}: expected a contiguous {tdt} {shape} tensor on "
                f"{dev}, got {t.dtype} {tuple(t.shape)}")
    tr, tc = span_train_plan(b, c, h, w, nblk, g).tile_bwd
    lib = _build.load("span_train", _SIGNATURES)
    dx = torch.empty_like(dy)
    dblocks = torch.empty_like(blocks)
    nscratch = (lib.fastdet_span_train_bwd_scratch_bf16 if bf16
                else lib.fastdet_span_train_bwd_scratch)
    scratch = torch.empty(nscratch(b, c, h, w, nblk, g, tr, tc),
                          dtype=torch.float32, device=dev)
    fn = (lib.fastdet_span_train_bwd_bf16 if bf16
          else lib.fastdet_span_train_bwd)
    with torch.cuda.device(dev):
        rc = fn(dy.data_ptr(), xsave.data_ptr(), stats.data_ptr(),
                blocks.data_ptr(), dx.data_ptr(), dblocks.data_ptr(),
                scratch.data_ptr(), b, c, h, w, nblk, g, tr, tc,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, what)
    counter.launches += 1
    return dx, dblocks


def span_train_backward(dy: torch.Tensor, xsave: torch.Tensor,
                        stats: torch.Tensor, blocks: torch.Tensor, g: int):
    """→ (dx, dblocks) as `span_train_backward_reference`.  CUDA: the
    backward kernels of `csrc/span_train.cu` (one counted call); the
    weight gradients are per-tile partial sums reduced in a fixed order,
    so two runs give the same bits.  CPU: the plain version."""
    return _backward(span_train_backward, False, dy, xsave, stats, blocks, g)


def span_train_backward_bf16(dy: torch.Tensor, xsave: torch.Tensor,
                             stats: torch.Tensor, blocks: torch.Tensor,
                             g: int):
    """The bf16 form of `span_train_backward`: dy, xsave and dx bf16,
    dblocks f32."""
    return _backward(span_train_backward_bf16, True, dy, xsave, stats,
                     blocks, g)


span_train_backward.launches = 0
span_train_backward_bf16.launches = 0


class SpanTrain(torch.autograd.Function):
    """The differentiable training span: `SpanTrain.apply(x, blocks, g)
    -> (out, stats)`, the bf16 form for a bf16 x (out and dx bf16);
    stats carry no gradient (they feed the running statistics)."""

    @staticmethod
    def forward(ctx, x, blocks, g):
        fwd = span_train_forward_bf16 if x.dtype == BF16 else \
            span_train_forward
        out, xsave, stats = fwd(x, blocks, g)
        ctx.save_for_backward(xsave, stats, blocks)
        ctx.g = g
        ctx.mark_non_differentiable(stats)
        return out, stats

    @staticmethod
    def backward(ctx, dout, _dstats):
        xsave, stats, blocks = ctx.saved_tensors
        bwd = span_train_backward_bf16 if xsave.dtype == BF16 else \
            span_train_backward
        dx, dblocks = bwd(dout.contiguous(), xsave, stats, blocks, ctx.g)
        return dx, dblocks, None
