"""The fused inference forward (counterpart of
fastdet/kernels/fused_infer.py, `head="yolo"` and `head="anchorfree"`).

Input contracts (`input_format`), all uint8:
  * "s2d_u8", the port's default: the host's space-to-depth(4) batch
    (B, 48, pad128(H/4·W/4)), channel yoff·12 + xoff·3 + c, lane
    i·(W/4) + j for pixel (4i+yoff, 4j+xoff, c), written by
    `pack_images_s2d`;
  * "s2d8_u8": space-to-depth(8), (B, 192, pad128(H/8·W/8)), channel
    yoff·24 + xoff·3 + c, written by `pack_images_s2d8`;
  * "nhwc": (B, H, W, 3).
Inside, activations are NCHW f32 (bf16 with `dtype=torch.bfloat16`).
The forward:

  1. the stem, conv3×3 s2 (3→24, /255 and BN folded) + ReLU + maxpool
     3×3 s2 → (B, 24, H/4, W/4): `stem_s2d` (kernel B1,
     `csrc/stem_s2d.cu`) or `stem_s2d8` (B10, `csrc/stem_s2d8.cu`), one
     stem kernel (`csrc/stem_core.cuh`, `stem_plan`) under two entry
     points, or, from NHWC, PyTorch (the JAX package leaves that stem to
     XLA);
  2. per stage (48/96/192 channels) either the stride-2 ShuffleV2 block
     in PyTorch (cuDNN on the card) and then `span`, the stage's 3/7/3
     stride-1 blocks (B2, `csrc/span.cu`), or, with `fuse_s2=True` (and at
     stage 2 of "s2d8_u8" always, as in the JAX package), `s2span`, the
     stride-2 block and the span in one call (B9, `csrc/s2span.cu`);
  3. the neck and heads in PyTorch: for `head="yolo"` LightFPN and the
     shared heads, returning the raw NHWC 6-tuple (reg2, obj2, cls2,
     reg3, obj3, cls3) of the port's `Detector`; for `head="anchorfree"`
     the single-scale fuse and the decoupled heads (`_af_neck`),
     returning the raw NHWC (obj, cls, reg) of `AnchorFreeDetector`.

Both families share the ShuffleNetV2 backbone, so its kernels serve
both.  The JAX package leaves the stride-2 blocks (off the fused stage),
the necks and the heads to XLA, so they stay library calls here.

Each kernel wrapper launches its kernel on a CUDA tensor (or raises) and
runs its plain PyTorch version (`*_reference`) only on a CPU tensor.
Each counts its kernel launches in `.launches`.

The TPU's phase-packed layouts are not ported: its s2d(8) stem emits the
pooled map as four phase planes and its stage kernel reads the stage
input phase-split, because Mosaic has no strided lane addressing.  Here
B10 writes the NCHW map that B1 writes, and B9 reads any stage input
NCHW with stride-2 addressing.  Nor are the TPU's lane grouping
(`_pick_group`, `_LANE_BUDGET`, `_LANE_BUDGET_S2`) and its row-chunked
stem (`_stem_call_chunked`, B6) ported: they fit VMEM.  Here the stem
kernels tile any size with shared memory that does not grow with the
image, and the stage kernel's launch plan (`span_stage_plan`) holds a
stage in a thread-block cluster where it fits and runs it one block per
launch where it does not.  The s2d(8) guard (at most 2048
lanes) is the JAX package's and is kept.

`dtype=torch.bfloat16` (the JAX package's serving default; this module's
default stays f32) runs the JAX package's bf16 function: bf16 maps, bf16
weight matrices cast as the JAX package casts them (the spans' and
stride-2 blocks' composed matrices, `fold.compose_s1_block` /
`compose_s2_block`), f32 biases, products accumulated in f32 and rounded
to bf16 where JAX rounds.  Its kernels are the bf16 forms of the stems
(`stem_s2d_bf16`, `stem_s2d8_bf16`) and stages (`span_bf16`,
`s2span_bf16`), each with its plain version; the parts the JAX package
leaves to XLA follow jnp's promotion rules, written out (`_conv16`).  The
heads' logits are f32.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fastdet_torch import resolve_device
from fastdet_torch.kernels import _build
from fastdet_torch.kernels.fold import (S2_ROW_KEYS, STAGES,
                                        mma_fragment_index,
                                        pack_fused_weights,
                                        pack_fused_weights_af, pack_s2_16,
                                        pack_s2span_weights, pack_span16,
                                        pack_span_weights, s2_16_elems,
                                        span16_elems)
from fastdet_torch.kernels.stem_train import SMS
from fastdet_torch.models.layers import add_bias as _bias
from fastdet_torch.models.layers import conv16 as _conv16

SPAN_CHANNELS = (48, 96, 192)
S2SPAN_CHANNELS = (24, 48, 96)           # stage inputs, = each stage's MID
INPUT_FORMATS = ("nhwc", "s2d_u8", "s2d8_u8")
STEM8_LANE_BUDGET = 2048    # the JAX package's s2d(8) guard, kept as is


def _pad128(n: int) -> int:
    return (n + 127) // 128 * 128


# ------------------------------------------------------------ host packing

def pack_stem_s2d(stem_w: np.ndarray, stem_b: np.ndarray,
                  scale: float = 1.0 / 255.0):
    """Fold the input scale into the (3,3,3,24) HWIO stem conv.  → (w
    (3,3,3,24) f32, b (24,) f32).  The values are the nonzero entries of
    the TPU kernel's (192, 96) phase matrix (`pack_stem_s2d` of the JAX
    package); the CUDA kernel needs no phase form (it splits the weights
    into its f16 terms itself, on the host, at each launch)."""
    return (np.asarray(stem_w, np.float32) * scale,
            np.asarray(stem_b, np.float32).copy())


def _space_to_depth(images: np.ndarray, k: int) -> np.ndarray:
    """(B, H, W, 3) → (B, 3·k², pad128(H/k·W/k)), channel yoff·3k + xoff·3
    + c, lane i·(W/k) + j for pixel (k·i+yoff, k·j+xoff, c), zero pad
    lanes."""
    b, ih, iw, _ = images.shape
    h, w = ih // k, iw // k
    hw = h * w
    x = np.asarray(images).reshape(b, h, k, w, k, 3)
    x = x.transpose(0, 2, 4, 5, 1, 3).reshape(b, 3 * k * k, hw)
    return np.pad(x, ((0, 0), (0, 0), (0, _pad128(hw) - hw)))


def _unpack_space_to_depth(x, k: int, h: int, w: int):
    """(B, 3·k², npad) s2d(k) tensor → (B, 3, k·h, k·w) image."""
    bsz = x.shape[0]
    img = x[:, :, :h * w].reshape(bsz, k, k, 3, h, w)
    return img.permute(0, 3, 4, 1, 5, 2).reshape(bsz, 3, k * h, k * w)


def _stem_conv_pool(img, w, b):
    """conv3×3 s2 (HWIO `w`, bias `b`) + ReLU + maxpool 3×3 s2 of an
    (B, 3, H, W) image, in f32."""
    wt = torch.as_tensor(w, device=img.device).permute(3, 2, 0, 1)
    y = F.conv2d(img.float(), wt, torch.as_tensor(b, device=img.device),
                 stride=2, padding=1)
    return F.max_pool2d(F.relu(y), 3, 2, 1)


def pack_images_s2d(images: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) uint8 → (B, 48, pad128(H/4·W/4)) uint8 s2d(4) layout,
    zero pad lanes."""
    return _space_to_depth(images, 4)


# --------------------------------------------- the stem kernel (B1, B10)
#
# `csrc/stem_core.cuh`, under the entry points `stem_s2d.cu` (s2d(4), B1
# and B6) and `stem_s2d8.cu` (s2d(8), B10): persistent CTAs walk tiles of
# pooled rows × 7·strips pooled columns; a CTA unpacks a tile's s2d plane
# words into f16 pixel planes and starts the copies of its next tile,
# then a warp walks a strip of 7 cells (and a halo cell) down the tile's
# rows, the conv on f16 tensor cores with the weights in two f16 terms,
# the pool in registers.  `stem_plan` picks the tile and the grid; the C
# function `fastdet_stem_smem` reports the same shared memory as
# `stem_smem`.

STEM_KERNEL = "stem_kernel"
STEM_STRIP_CELLS = 7         # kStripCells: own pooled cells a warp
STEM_MAX_STRIPS = 8          # kMaxStrips: warps a CTA
STEM_ROWS = 8                # pooled rows a tile
STEM_FRAG_WORDS = 24 * 32    # the B fragments of the parameter block
STEM_FACTORS = (4, 8)
STEM_CTAS_PER_SM = 2         # resident CTAs an SM (registers, shared memory)


def stem_row_stride(strips: int) -> int:
    """f16 elements of one pixel row of a tile (`stem_row_stride`): 8
    halo columns and 28 a strip, made 32 modulo 64 (bank spread)."""
    need = 8 + 4 * STEM_STRIP_CELLS * strips
    return need + (32 - need) % 64


def stem_raw_words(rows: int, strips: int, factor: int) -> int:
    """Words of a CTA's raw buffer (`stem_raw_words`): `factor` plane
    words a staging task, for the most tasks a tile can have."""
    urows = -(-(4 * rows + 4) // factor) + 1
    lanes = -(-(4 * STEM_STRIP_CELLS * strips + 4) // factor) + 1
    return urows * 3 * factor * ((lanes + 3) // 4 + 1) * factor


def stem_smem(rows: int, strips: int, factor: int) -> int:
    """Shared memory (bytes) of one CTA of the stem kernel
    (`stem_smem_bytes`): three f16 pixel planes of 4·rows + 4 rows (a
    16-element skew between planes), the raw buffer of the next tile's
    plane words, the B fragments, b·2^e and 2^-e."""
    plane = (4 * rows + 4) * stem_row_stride(strips) + 16
    return (2 * 3 * plane + 4 * (stem_raw_words(rows, strips, factor)
                                 + STEM_FRAG_WORDS) + 4 * 2 * 24)


@dataclass(frozen=True)
class StemPlan:
    """How one call of `stem_s2d` or `stem_s2d8` runs on the card."""
    factor: int        # the s2d factor of the input, 4 or 8
    rows: int          # pooled rows a tile
    strips: int        # warps a CTA, each 7 pooled columns
    bands: int         # tiles down an image
    tiles_x: int       # tiles across an image
    tiles: int         # tiles of the call, b · bands · tiles_x
    grid: tuple        # (persistent CTAs,), each walking every grid-th tile
    threads: int
    smem_bytes: int    # shared memory a CTA
    kernel: str        # the kernel's name (both factors)
    launches: int      # device launches a call
    split_weights: bool  # the weights travel as two f16 terms (hi + lo)

    @property
    def cols(self) -> int:
        """Pooled columns a tile."""
        return STEM_STRIP_CELLS * self.strips

    def image_tiles(self, h4: int, w4: int) -> List[Tuple[int, int, int, int]]:
        """(first row, rows, first column, columns) of each tile of an
        image's pooled map, in the kernel's order."""
        return [(by * self.rows, min(self.rows, h4 - by * self.rows),
                 tx * self.cols, min(self.cols, w4 - tx * self.cols))
                for by in range(self.bands) for tx in range(self.tiles_x)]


@functools.lru_cache(maxsize=None)
def stem_plan(b: int, h4: int, w4: int, factor: int) -> StemPlan:
    """The launch plan of the stem kernel for a pooled map (b, 24, h4, w4)
    from s2d(`factor`) input: tiles of STEM_ROWS pooled rows (fewer where
    the image has fewer) across as few tiles as hold the width at most
    STEM_MAX_STRIPS strips each, the strips spread evenly over them; one
    launch of as many persistent CTAs as the card holds at once, at most
    one a tile."""
    if factor not in STEM_FACTORS:
        raise ValueError(f"stem_plan: factor {factor} not in {STEM_FACTORS}")
    if b < 1 or h4 < 1 or w4 < 1:
        raise ValueError(f"stem_plan: empty map {(b, h4, w4)}")
    rows = min(STEM_ROWS, h4)
    need = -(-w4 // STEM_STRIP_CELLS)
    tiles_x = -(-need // STEM_MAX_STRIPS)
    strips = -(-need // tiles_x)
    tiles_x = -(-w4 // (STEM_STRIP_CELLS * strips))
    bands = -(-h4 // rows)
    tiles = b * bands * tiles_x
    return StemPlan(factor, rows, strips, bands, tiles_x, tiles,
                    (min(tiles, STEM_CTAS_PER_SM * SMS),), 32 * strips,
                    stem_smem(rows, strips, factor), STEM_KERNEL, 1, True)


# ------------------------------------------------------------ kernel B1

def stem_s2d_reference(x, w, b, h4: int, w4: int):
    """Plain PyTorch version of the stem kernel, any device.  x (B,48,npad)
    uint8, w (3,3,3,24) HWIO f32 with /255 folded in, b (24,) →
    (B, 24, h4, w4) f32."""
    return _stem_conv_pool(_unpack_space_to_depth(x, 4, h4, w4), w, b)


_STEM_SIGNATURES = {
    "fastdet_stem_s2d": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                         + [ctypes.c_void_p], ctypes.c_int),
    "fastdet_stem_s2d_bf16": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                              + [ctypes.c_void_p], ctypes.c_int),
    "fastdet_stem_smem": ([ctypes.c_int] * 2, ctypes.c_size_t),
    "fastdet_stem_ctas_per_sm": ([ctypes.c_int] * 2, ctypes.c_int),
}


def stem_s2d(x, w, b, h4: int, w4: int):
    """→ (B, 24, h4, w4) f32.  CUDA: the stem kernel through
    `csrc/stem_s2d.cu` as `stem_plan(..., 4)` launches it, with `w` and `b`
    f32 on the host (they travel as the kernel's parameter block); CPU: the
    plain version."""
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
    if x.data_ptr() % 4:   # the kernel copies 4-byte plane words: an
        x = x.clone()      # unaligned view goes through an aligned copy
    plan = stem_plan(bsz, h4, w4, 4)
    out = torch.empty((bsz, 24, h4, w4), dtype=torch.float32, device=dev)
    lib = _build.load("stem_s2d", _STEM_SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.fastdet_stem_s2d(
            x.data_ptr(), out.data_ptr(), w.data_ptr(), b.data_ptr(), bsz,
            h4, w4, npad, plan.rows, plan.strips, plan.grid[0],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "stem_s2d")
    stem_s2d.launches += plan.launches
    return out


stem_s2d.launches = 0


# ------------------------------------------- the stage kernel (B2 and B9)
#
# `csrc/span_block.cuh` holds a band of output rows of one image, all C
# channels and a scratch of C/2 planes, in one CTA's shared memory, and
# runs the span's blocks there: the channel shuffle relabels slots
# (`span_slot_tables`), the depthwise halo rows come from the neighbouring
# CTAs of the image's thread-block cluster.  `span_stage_plan` picks the
# launch; the C function `fastdet_span_stage_smem` reports the same shared
# memory as `span_stage_smem`.

STAGE_THREADS = 384          # kThreads
STAGE_CHUNK_ROWS = 5         # kChunkRows: input rows per stride-2 pw1 chunk
STAGE_CLUSTERS = (1, 2, 4, 8)
SMEM_PER_CTA = 227 * 1024    # the card's shared memory per block
STAGE_KERNEL = "span_stage_kernel"


def _pad4(n: int) -> int:
    return (n + 3) & ~3


def span_stage_smem(mid: int, rows: int, w: int, halo: int,
                    stride2: bool) -> int:
    """Shared memory (bytes) of one CTA of the stage kernel
    (`stage_layout`): 3·mid slot planes of a band of `rows` rows of width
    w; with halo 1 (cluster neighbours) a halo buffer, with halo 2 (per
    block) also its pw1 input; a block's weights, or with stride2 one
    pointwise matrix beside the 5-row chunk buffers X and Y (X in the free
    slots when it fits); the slot tables."""
    ps = _pad4(rows * w)
    hs = _pad4(2 * w) if halo else 0
    floats = 3 * mid * ps + mid * hs * (2 if halo == 2 else 1)
    region = 2 * mid * mid + 12 * mid
    if stride2:
        xs = _pad4(STAGE_CHUNK_ROWS * (2 * w + 2))
        region = max(region, mid * mid + mid
                     + (1 if xs <= ps else 2) * mid * xs)
    return 4 * (floats + region + 7 * mid)


@dataclass(frozen=True)
class SpanStagePlan:
    """How one call of `span` or `s2span` runs on the card."""
    variant: str     # "stage": one launch; "per_block": one per block
    cluster: int     # CTAs of an image's cluster (1 for "per_block")
    rows: int        # output rows per CTA in the span's launches
    rows_s2: int     # in the stride-2 launch ("per_block"; else rows)
    bands: int       # CTAs per image in the span's launches
    halo: int        # 0 none, 1 from the cluster neighbours, 2 recomputed
    threads: int
    layouts: tuple   # (rows, halo, stride2) of each kind of launch
    smem_bytes: int  # shared memory per CTA, the largest launch's
    launches: int    # device launches per call
    ctas: int        # CTAs of the span's launch (of the whole call, "stage")

    def band_rows(self, h: int) -> List[Tuple[int, int]]:
        """(first row, rows) of each CTA's band of an image."""
        return [(i * self.rows, min(self.rows, h - i * self.rows))
                for i in range(self.bands)]


def _fit_rows(mid: int, h: int, w: int, stride2: bool, span: bool) -> int:
    """The largest band that fits one CTA in a per-block launch."""
    for rows in range(h, 0, -1):
        halo = 2 if span and rows < h else 0
        if span_stage_smem(mid, rows, w, halo, stride2) <= SMEM_PER_CTA:
            return rows
    raise ValueError(f"no band of {w} columns at mid {mid} fits a CTA")


@functools.lru_cache(maxsize=None)
def span_stage_plan(b: int, c: int, h: int, w: int, nblk: int,
                    stride2: bool = False) -> SpanStagePlan:
    """The launch plan of the stage kernel for a stage output (b, c, h, w)
    of nblk span blocks, after a stride-2 block when stride2 (B9).  The
    smallest cluster (1, 2, 4 or 8 CTAs, a band of ⌈h/n⌉ rows each, no
    band empty) whose CTA fits the card's shared memory holds the whole
    stage: one launch.  Else one launch per block (and one for the
    stride-2 block), each CTA as large a band as fits, its halo rows' pw1
    computed by itself."""
    mid = c // 2
    for n in STAGE_CLUSTERS:
        rows = -(-h // n)
        if (n - 1) * rows >= h:
            continue
        halo = 1 if n > 1 and nblk > 0 else 0
        smem = span_stage_smem(mid, rows, w, halo, stride2)
        if smem <= SMEM_PER_CTA:
            return SpanStagePlan("stage", n, rows, rows, n, halo,
                                 STAGE_THREADS, ((rows, halo, stride2),),
                                 smem, 1, b * n)
    rows = _fit_rows(mid, h, w, False, True) if nblk else h
    rows_s2 = _fit_rows(mid, h, w, True, False) if stride2 else rows
    halo = 2 if rows < h else 0
    layouts = (((rows, halo, False),) if nblk else ()) + (
        ((rows_s2, 0, True),) if stride2 else ())
    bands = -(-h // rows)
    return SpanStagePlan("per_block", 1, rows, rows_s2, bands, halo,
                         STAGE_THREADS, layouts,
                         max(span_stage_smem(mid, r, w, hl, s2)
                             for r, hl, s2 in layouts),
                         nblk + int(stride2), b * bands)


def span_slot_tables(mid: int, nblk: int, stride2: bool = False):
    """The stage kernel's slot relabelling.  → (blocks, lmap): blocks[k] =
    (odd, scratch), the slots of block k's odd logical channels (pw1's
    input, dw's output, pw2's input) and of its scratch (pw1's output,
    dw's input, pw2's output); lmap, the slot of each logical channel
    after the last block.  The band starts in slots 0..C-1 (the span) or,
    after a stride-2 block, with the projection in 2·mid..3·mid-1 and the
    main branch in mid..2·mid-1."""
    if stride2:
        lmap = list(range(2 * mid, 3 * mid)) + list(range(mid, 2 * mid))
        free = list(range(mid))
    else:
        lmap, free = list(range(2 * mid)), list(range(2 * mid, 3 * mid))
    blocks = []
    for _ in range(nblk):
        odd = [lmap[2 * j + 1] for j in range(mid)]
        blocks.append((odd, free))
        lmap, free = [lmap[2 * j] for j in range(mid)] + free, odd
    return blocks, lmap


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


def span_slots_reference(x, weights, nblk: int):
    """`span_reference` through the stage kernel's decomposition, any
    device: the activation in 3·mid slot planes, pw1 from the odd slots
    into the scratch, dw from the scratch back into the odd slots, pw2
    into the scratch, the shuffle a relabelling (`span_slot_tables`).  The
    same convolutions on the same values as `span_reference`."""
    mid = x.shape[1] // 2
    slots = [x[:, c] for c in range(2 * mid)] + [None] * mid
    blocks, lmap = span_slot_tables(mid, nblk)

    def planes(idx):
        return torch.stack([slots[s] for s in idx], 1)

    def put(idx, y):
        for j, s in enumerate(idx):
            slots[s] = y[:, j]

    for k, (odd, scratch) in enumerate(blocks):
        w1, b1, wd, bd, w2, b2 = _unpack_block(weights[k], mid)
        put(scratch, F.relu(F.conv2d(planes(odd), w1.t()[:, :, None, None],
                                     b1)))
        put(odd, F.conv2d(planes(scratch), wd.t().reshape(mid, 1, 3, 3), bd,
                          padding=1, groups=mid))
        put(scratch, F.relu(F.conv2d(planes(odd), w2.t()[:, :, None, None],
                                     b2)))
    return planes(lmap)


_SPAN_SIGNATURES = {
    "fastdet_span": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                     + [ctypes.c_void_p], ctypes.c_int),
    "fastdet_span_stage_smem": ([ctypes.c_int] * 5, ctypes.c_size_t),
    "fastdet_span_bf16": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                          + [ctypes.c_void_p], ctypes.c_int),
    "fastdet_span16_smem": ([ctypes.c_int] * 5, ctypes.c_size_t),
}


def span(x, weights, nblk: int):
    """→ (B,C,h,w) f32 after `nblk` stride-1 blocks.  CUDA: the stage
    kernel of `csrc/span.cu` as `span_stage_plan` launches it (its
    launches counted); CPU: the plain version."""
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
    plan = span_stage_plan(bsz, c, h, w, nblk)
    per_block = plan.variant == "per_block"
    out = torch.empty_like(x)
    tmp = torch.empty_like(x) if per_block and nblk > 1 else out
    lib = _build.load("span", _SPAN_SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.fastdet_span(
            x.data_ptr(), out.data_ptr(), tmp.data_ptr(), weights.data_ptr(),
            bsz, c, h, w, nblk, plan.rows, plan.cluster, int(per_block),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "span")
    span.launches += plan.launches
    return out


span.launches = 0


# ----------------------------------------------------------- kernel B10

def pack_images_s2d8(images: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) uint8 → (B, 192, pad128(H/8·W/8)) uint8 s2d(8) layout,
    channel yoff·24 + xoff·3 + c, lane i·(W/8) + j for pixel (8i+yoff,
    8j+xoff, c), zero pad lanes."""
    return _space_to_depth(images, 8)


def check_stem8_size(ih: int, iw: int) -> None:
    """The JAX package's s2d(8) guard: H and W divisible by 8 and at most
    STEM8_LANE_BUDGET lanes after padding; larger inputs take s2d_u8."""
    if ih % 8 or iw % 8 or _pad128((ih // 8) * (iw // 8)) > STEM8_LANE_BUDGET:
        raise ValueError(
            "s2d8_u8 needs H,W divisible by 8 and "
            f"pad128(H/8·W/8) ≤ {STEM8_LANE_BUDGET} lanes "
            f"(got {(ih, iw)}); use s2d_u8 for larger inputs")


def stem_s2d8_reference(x, w, b, h8: int, w8: int):
    """Plain PyTorch version of the s2d(8) stem kernel, any device.
    x (B,192,npad) uint8, w (3,3,3,24) HWIO f32 with /255 folded in, b (24,)
    → (B, 24, 2·h8, 2·w8) f32."""
    return _stem_conv_pool(_unpack_space_to_depth(x, 8, h8, w8), w, b)


_STEM8_SIGNATURES = {
    "fastdet_stem_s2d8": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                          + [ctypes.c_void_p], ctypes.c_int),
    "fastdet_stem_s2d8_bf16": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                               + [ctypes.c_void_p], ctypes.c_int),
    "fastdet_stem_smem": ([ctypes.c_int] * 2, ctypes.c_size_t),
    "fastdet_stem_ctas_per_sm": ([ctypes.c_int] * 2, ctypes.c_int),
}


def stem_s2d8(x, w, b, h8: int, w8: int):
    """→ (B, 24, 2·h8, 2·w8) f32, NCHW (the layout the stage kernel B9
    reads).  CUDA: the stem kernel through `csrc/stem_s2d8.cu` as
    `stem_plan(..., 8)` launches it, with `w` and `b` f32 on the host (its
    parameter block); CPU: the plain version."""
    dev = x.device
    if dev.type == "cpu":
        return stem_s2d8_reference(x, w, b, h8, w8)
    if dev.type != "cuda":
        raise ValueError(f"stem_s2d8: unsupported device {dev}")
    bsz = x.shape[0]
    npad = _pad128(h8 * w8)
    if (x.dtype != torch.uint8 or tuple(x.shape) != (bsz, 192, npad)
            or not x.is_contiguous()):
        raise ValueError(
            f"stem_s2d8: expected a contiguous uint8 (B, 192, {npad}) tensor "
            f"for h8={h8}, w8={w8}, got {x.dtype} {tuple(x.shape)}")
    for t, shape in ((w, (3, 3, 3, 24)), (b, (24,))):
        if (not isinstance(t, torch.Tensor) or t.device.type != "cpu"
                or t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"stem_s2d8: the weights are kernel parameters: expected a "
                f"contiguous f32 {shape} tensor on the CPU")
    if x.data_ptr() % 4:   # the kernel copies 4-byte plane words: an
        x = x.clone()      # unaligned view goes through an aligned copy
    plan = stem_plan(bsz, 2 * h8, 2 * w8, 8)
    out = torch.empty((bsz, 24, 2 * h8, 2 * w8), dtype=torch.float32,
                      device=dev)
    lib = _build.load("stem_s2d8", _STEM8_SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.fastdet_stem_s2d8(
            x.data_ptr(), out.data_ptr(), w.data_ptr(), b.data_ptr(), bsz,
            h8, w8, npad, plan.rows, plan.strips, plan.grid[0],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "stem_s2d8")
    stem_s2d8.launches += plan.launches
    return out


stem_s2d8.launches = 0


# ------------------------------------------------------------ kernel B9

def s2span_floats(cin: int, nblk: int) -> int:
    """Length of a stage's flat row (`fold.pack_s2span_weights`)."""
    return 3 * cin * cin + 23 * cin + nblk * (2 * cin * cin + 12 * cin)


def _unpack_s2(row: torch.Tensor, m: int):
    sizes = (m * m, m, 9 * m, m, m * m, m, 9 * m, m, m * m, m)
    return dict(zip(S2_ROW_KEYS, torch.split(row[:sum(sizes)], sizes)))


def s2span_reference(x, weights, nblk: int):
    """Plain PyTorch version of the stage kernel, any device.  x
    (B, cin, H, W) f32, weights the flat row of `fold.pack_s2span_weights`
    → (B, 2·cin, ⌈H/2⌉, ⌈W/2⌉) f32: the stride-2 block, concat[proj,
    main], then `nblk` span blocks."""
    m = x.shape[1]
    q = _unpack_s2(weights, m)

    def pw(a, wt, bias):
        return F.relu(F.conv2d(a, wt.reshape(m, m).t()[:, :, None, None],
                               bias))

    def dw(a, wt, bias):
        return F.conv2d(a, wt.reshape(9, m).t().reshape(m, 1, 3, 3), bias,
                        stride=2, padding=1, groups=m)

    y = dw(pw(x, q["w1"], q["b1"]), q["wd"], q["bd"])
    y = pw(y, q["w2"], q["b2"])
    pr = pw(dw(x, q["wpd"], q["bpd"]), q["wpp"], q["bpp"])
    out = torch.cat([pr, y], dim=1)
    if nblk == 0:
        return out
    head = 3 * m * m + 23 * m
    return span_reference(out, weights[head:].reshape(nblk, -1), nblk)


_S2SPAN_SIGNATURES = {
    "fastdet_s2span": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p], ctypes.c_int),
    "fastdet_span_stage_smem": ([ctypes.c_int] * 5, ctypes.c_size_t),
    "fastdet_s2span_bf16": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                            + [ctypes.c_void_p], ctypes.c_int),
    "fastdet_span16_smem": ([ctypes.c_int] * 5, ctypes.c_size_t),
}


def s2span(x, weights, nblk: int):
    """→ (B, 2·cin, ⌈H/2⌉, ⌈W/2⌉) f32 after the stride-2 block and `nblk`
    stride-1 blocks.  CUDA: the stage kernel of `csrc/s2span.cu` as
    `span_stage_plan(..., stride2=True)` launches it (its launches
    counted); CPU: the plain version."""
    dev = x.device
    if dev.type == "cpu":
        return s2span_reference(x, weights, nblk)
    if dev.type != "cuda":
        raise ValueError(f"s2span: unsupported device {dev}")
    if (x.dim() != 4 or x.shape[1] not in S2SPAN_CHANNELS
            or x.dtype != torch.float32 or not x.is_contiguous()):
        raise ValueError(
            f"s2span: expected a contiguous f32 (B, cin, H, W) tensor with "
            f"cin in {S2SPAN_CHANNELS}, got {x.dtype} {tuple(x.shape)}")
    bsz, cin, hin, win = x.shape
    n = s2span_floats(cin, nblk)
    if (weights.device != dev or weights.dtype != torch.float32
            or tuple(weights.shape) != (n,) or not weights.is_contiguous()
            or weights.data_ptr() % 16):
        raise ValueError(
            f"s2span: expected contiguous 16-byte-aligned f32 weights ({n},) "
            f"on {dev}, got {weights.dtype} {tuple(weights.shape)} on "
            f"{weights.device}")
    shape = (bsz, 2 * cin, (hin + 1) // 2, (win + 1) // 2)
    plan = span_stage_plan(bsz, 2 * cin, shape[2], shape[3], nblk, True)
    per_block = plan.variant == "per_block"
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    tmp = torch.empty_like(out) if per_block and nblk > 0 else out
    lib = _build.load("s2span", _S2SPAN_SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.fastdet_s2span(
            x.data_ptr(), out.data_ptr(), tmp.data_ptr(), weights.data_ptr(),
            bsz, cin, hin, win, nblk, plan.rows, plan.rows_s2, plan.cluster,
            int(per_block), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "s2span")
    s2span.launches += plan.launches
    return out


s2span.launches = 0


# ------------------------------------------------- the bf16 kernels (A1)
#
# The JAX package's default serving runs its Pallas kernels in bf16
# (`FusedPipeline(dtype=None)`): bf16 activations and weight matrices, f32
# biases, products accumulated in f32, one rounding to bf16 after the
# bias and ReLU.  The port's bf16 forms of B1 (B6), B10, B2 and B9 compute
# that function: the stems on the stem core with one bf16 term a weight
# (`csrc/stem_core.cuh`), the stages on the bf16 stage kernels of
# `csrc/span_block.cuh` with the JAX package's composed matrices (fold.py
# `pack_span16`, `pack_s2_16`).  Beside each, its plain PyTorch version
# computes from the bf16 values in f32 and rounds where JAX rounds.

BF16 = torch.bfloat16
DTYPES = (torch.float32, BF16)
SPAN16_KERNEL = "span_bf16_kernel"
S2_16_KERNEL = "s2_bf16_kernel"
SPAN16_SMEM_BUDGET = 113 * 1024   # two CTAs an SM


def _pad16(n: int) -> int:
    return (n + 15) // 16 * 16


def bf16_from_bits(bits: np.ndarray) -> torch.Tensor:
    """uint16 bf16 bit patterns → a bf16 tensor of the same values."""
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(
        BF16)


@functools.lru_cache(maxsize=None)
def _fragment_index(n: int, k: int) -> torch.Tensor:
    return torch.from_numpy(mma_fragment_index(n, k))


def _frag_matrix(frag: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """A flat bf16 B operand in `fold.mma_fragments` order → its (n, k)
    matrix, f32 (the bf16 values, exact)."""
    kp = _pad16(k)
    out = torch.zeros(n * kp, dtype=BF16, device=frag.device)
    out[_fragment_index(n, k).to(frag.device)] = frag
    return out.reshape(n, kp)[:, :k].float()


def _tap_conv_weight(wm: torch.Tensor, cin: int) -> torch.Tensor:
    """A composed (cout, 9·cin) tap-major matrix (K index t·cin + c, tap t
    = ky·3 + kx) → the OIHW 3×3 conv weight it is."""
    return wm.reshape(-1, 9, cin).permute(0, 2, 1).reshape(-1, cin, 3, 3)


def _stem_conv_pool_bf16(img, w16, b):
    """The bf16 stem's function: conv3×3 s2 of the u8 pixels with the bf16
    weights (/255 folded in), f32 accumulation, + bias, ReLU, one rounding
    to bf16; the pool on those values (computed before the rounding, which
    is monotone)."""
    wt = w16.to(img.device).float().permute(3, 2, 0, 1)
    y = F.conv2d(img.float(), wt, torch.as_tensor(b, device=img.device),
                 stride=2, padding=1)
    return F.max_pool2d(F.relu(y), 3, 2, 1).to(BF16)


def stem_s2d_reference_bf16(x, w16, b, h4: int, w4: int):
    """Plain PyTorch version of the bf16 stem (B1, B6), any device.  x
    (B,48,npad) uint8, w16 (3,3,3,24) HWIO bf16 with /255 folded in, b (24,)
    f32 → (B, 24, h4, w4) bf16."""
    return _stem_conv_pool_bf16(_unpack_space_to_depth(x, 4, h4, w4), w16, b)


def stem_s2d8_reference_bf16(x, w16, b, h8: int, w8: int):
    """Plain PyTorch version of the bf16 s2d(8) stem (B10), any device →
    (B, 24, 2·h8, 2·w8) bf16."""
    return _stem_conv_pool_bf16(_unpack_space_to_depth(x, 8, h8, w8), w16, b)


def _check_stem16_params(w16, b, what: str) -> None:
    for t, shape, dt in ((w16, (3, 3, 3, 24), BF16),
                         (b, (24,), torch.float32)):
        if (not isinstance(t, torch.Tensor) or t.device.type != "cpu"
                or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{what}: the weights are kernel parameters: expected a "
                f"contiguous {dt} {shape} tensor on the CPU")


def _stem16_launch(name, fn, x, w16, b, shape, hk, wk, factor):
    dev = x.device
    bsz = x.shape[0]
    npad = _pad128(hk * wk)
    if (x.dtype != torch.uint8 or tuple(x.shape) != (bsz, shape, npad)
            or not x.is_contiguous()):
        raise ValueError(
            f"{name}: expected a contiguous uint8 (B, {shape}, {npad}) "
            f"tensor, got {x.dtype} {tuple(x.shape)}")
    _check_stem16_params(w16, b, name)
    if x.data_ptr() % 4:   # the kernel copies 4-byte plane words: an
        x = x.clone()      # unaligned view goes through an aligned copy
    h4, w4 = hk * factor // 4, wk * factor // 4
    plan = stem_plan(bsz, h4, w4, factor)
    out = torch.empty((bsz, 24, h4, w4), dtype=BF16, device=dev)
    lib = _build.load(name.replace("_bf16", ""),
                      _STEM_SIGNATURES if factor == 4 else _STEM8_SIGNATURES)
    with torch.cuda.device(dev):
        rc = getattr(lib, fn)(
            x.data_ptr(), out.data_ptr(), w16.data_ptr(), b.data_ptr(), bsz,
            hk, wk, npad, plan.rows, plan.strips, plan.grid[0],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, name)
    return out, plan


def stem_s2d_bf16(x, w16, b, h4: int, w4: int):
    """→ (B, 24, h4, w4) bf16.  CUDA: the stem kernel's bf16 form through
    `csrc/stem_s2d.cu` (`fastdet_stem_s2d_bf16`) as `stem_plan(..., 4)`
    launches it, `w16` bf16 and `b` f32 on the host (its parameter block);
    CPU: the plain version."""
    dev = x.device
    if dev.type == "cpu":
        return stem_s2d_reference_bf16(x, w16, b, h4, w4)
    if dev.type != "cuda":
        raise ValueError(f"stem_s2d_bf16: unsupported device {dev}")
    out, plan = _stem16_launch("stem_s2d_bf16", "fastdet_stem_s2d_bf16", x,
                               w16, b, 48, h4, w4, 4)
    stem_s2d_bf16.launches += plan.launches
    return out


stem_s2d_bf16.launches = 0


def stem_s2d8_bf16(x, w16, b, h8: int, w8: int):
    """→ (B, 24, 2·h8, 2·w8) bf16.  CUDA: the stem kernel's bf16 form
    through `csrc/stem_s2d8.cu` (`fastdet_stem_s2d8_bf16`) as
    `stem_plan(..., 8)` launches it; CPU: the plain version."""
    dev = x.device
    if dev.type == "cpu":
        return stem_s2d8_reference_bf16(x, w16, b, h8, w8)
    if dev.type != "cuda":
        raise ValueError(f"stem_s2d8_bf16: unsupported device {dev}")
    out, plan = _stem16_launch("stem_s2d8_bf16", "fastdet_stem_s2d8_bf16",
                               x, w16, b, 192, h8, w8, 8)
    stem_s2d8_bf16.launches += plan.launches
    return out


stem_s2d8_bf16.launches = 0


def px_stride16(mid: int) -> int:
    """bf16 elements between two pixels of the bf16 stage kernel's
    pixel-major buffers (`px_stride16`): mid rounded up so that the stride
    in 4-byte words is 4 modulo 8."""
    words = mid // 2
    return 2 * (words + (12 - words % 8) % 8)


def span16_smem(mid: int, rows: int, w: int, stride2: bool = False,
                win: int = 0) -> int:
    """Shared memory (bytes) of one CTA of a bf16 stage kernel
    (`span16_smem_bytes`): the staged input X and pw1's output Y, each
    rows + 2 rows of w pixels (stride 1) or 2·rows + 1 input rows of win
    pixels (stride 2), px_stride16(mid) bf16 a pixel."""
    npix = (2 * rows + 1) * win if stride2 else (rows + 2) * w
    return 2 * npix * px_stride16(mid) * 2


@dataclass(frozen=True)
class Span16Plan:
    """How one call of `span_bf16` or `s2span_bf16` runs on the card: one
    launch a block, each over bands of output rows, one CTA a band and
    image."""
    rows: int        # output rows a CTA in the span's launches
    rows_s2: int     # in the stride-2 block's launch
    smem_bytes: int  # a CTA of the span's launches
    smem_s2: int     # a CTA of the stride-2 block's launch (0 without)
    launches: int    # device launches a call: nblk (+ 1 with stride2)


def _rows16(mid: int, h: int, w: int, stride2: bool, win: int) -> int:
    """Equal bands, as few as keep a CTA within SPAN16_SMEM_BUDGET (two an
    SM; one band row if even that is over, while it fits a CTA)."""
    fit = 1
    for rows in range(h, 0, -1):
        if span16_smem(mid, rows, w, stride2, win) <= SPAN16_SMEM_BUDGET:
            fit = rows
            break
    if span16_smem(mid, fit, w, stride2, win) > SMEM_PER_CTA:
        raise ValueError(f"no band of the bf16 stage at mid {mid}, width "
                         f"{win if stride2 else w} fits a CTA")
    return -(-h // -(-h // fit))


@functools.lru_cache(maxsize=None)
def span16_plan(b: int, c: int, h: int, w: int, nblk: int,
                stride2: bool = False, win: int = 0) -> Span16Plan:
    """The launch plan of the bf16 stage for an output (b, c, h, w) of
    nblk span blocks, after a stride-2 block from input width `win` when
    stride2 (B9)."""
    mid = c // 2
    rows = _rows16(mid, h, w, False, 0) if nblk else h
    rows_s2 = _rows16(mid, h, w, True, win) if stride2 else rows
    return Span16Plan(rows, rows_s2,
                      span16_smem(mid, rows, w) if nblk else 0,
                      span16_smem(mid, rows_s2, w, True, win) if stride2
                      else 0, nblk + int(stride2))


def span_reference_bf16(x, weights, bias, nblk: int):
    """Plain PyTorch version of the bf16 span (B2), any device.  x
    (B, C, h, w) bf16, weights (nblk, fold.span16_elems(C/2)) bf16 in
    fragment order, bias (nblk, C) f32 → (B, C, h, w) bf16; per block y =
    bf16(ReLU(pw1(x_odd) + b1)), z = bf16(ReLU(Wc ⊛ y + bc)), concat
    [x_even, z]."""
    mid = x.shape[1] // 2
    k1 = _pad16(mid) * mid
    for k in range(nblk):
        w1 = _frag_matrix(weights[k, :k1], mid, mid)
        wc = _tap_conv_weight(_frag_matrix(weights[k, k1:], mid, 9 * mid),
                              mid)
        y = F.relu(F.conv2d(x[:, 1::2].float(), w1[:, :, None, None],
                            bias[k, :mid])).to(BF16)
        z = F.relu(F.conv2d(y.float(), wc, bias[k, mid:], padding=1))
        x = torch.cat([x[:, 0::2], z.to(BF16)], dim=1)
    return x


def s2span_reference_bf16(x, w_s2, b_s2, w_span, b_span, nblk: int):
    """Plain PyTorch version of the bf16 stage (B9), any device.  x
    (B, cin, H, W) bf16, w_s2/b_s2 the stride-2 block's `fold.pack_s2_16`,
    w_span/b_span the span's → (B, 2·cin, ⌈H/2⌉, ⌈W/2⌉) bf16: y =
    bf16(ReLU(pw1(x) + b1)), concat[bf16(ReLU(Wp ⊛s2 x + bp)),
    bf16(ReLU(Wc ⊛s2 y + bc))], then `nblk` span blocks."""
    m = x.shape[1]
    k1, kc = _pad16(m) * m, _pad16(9 * m) * m
    w1 = _frag_matrix(w_s2[:k1], m, m)
    wc = _tap_conv_weight(_frag_matrix(w_s2[k1:k1 + kc], m, 9 * m), m)
    wp = _tap_conv_weight(_frag_matrix(w_s2[k1 + kc:], m, 9 * m), m)
    y = F.relu(F.conv2d(x.float(), w1[:, :, None, None], b_s2[:m])).to(BF16)
    z = F.relu(F.conv2d(y.float(), wc, b_s2[m:2 * m], stride=2, padding=1))
    pr = F.relu(F.conv2d(x.float(), wp, b_s2[2 * m:], stride=2, padding=1))
    out = torch.cat([pr.to(BF16), z.to(BF16)], dim=1)
    if nblk == 0:
        return out
    return span_reference_bf16(out, w_span, b_span, nblk)


def _check16(t, what, name, dev, dtype, shape, align):
    if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous() or t.data_ptr() % align):
        raise ValueError(
            f"{what}: expected contiguous {align}-byte-aligned {dtype} {name} "
            f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def span_bf16(x, weights, bias, nblk: int):
    """→ (B,C,h,w) bf16 after `nblk` bf16 stride-1 blocks.  CUDA: the bf16
    stage kernel of `csrc/span.cu` (`fastdet_span_bf16`) as `span16_plan`
    launches it (its launches counted); CPU: the plain version."""
    dev = x.device
    if dev.type == "cpu":
        return span_reference_bf16(x, weights, bias, nblk)
    if dev.type != "cuda":
        raise ValueError(f"span_bf16: unsupported device {dev}")
    if (x.dim() != 4 or x.shape[1] not in SPAN_CHANNELS or x.dtype != BF16
            or not x.is_contiguous()):
        raise ValueError(
            f"span_bf16: expected a contiguous bf16 (B, C, h, w) tensor with "
            f"C in {SPAN_CHANNELS}, got {x.dtype} {tuple(x.shape)}")
    bsz, c, h, w = x.shape
    mid = c // 2
    _check16(weights, "span_bf16", "weights", dev, BF16,
             (nblk, span16_elems(mid)), 8)
    _check16(bias, "span_bf16", "biases", dev, torch.float32,
             (nblk, 2 * mid), 4)
    plan = span16_plan(bsz, c, h, w, nblk)
    out = torch.empty_like(x)
    tmp = torch.empty_like(x) if nblk > 1 else out
    lib = _build.load("span", _SPAN_SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.fastdet_span_bf16(
            x.data_ptr(), out.data_ptr(), tmp.data_ptr(), weights.data_ptr(),
            bias.data_ptr(), bsz, c, h, w, nblk, plan.rows,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "span_bf16")
    span_bf16.launches += plan.launches
    return out


span_bf16.launches = 0


def s2span_bf16(x, w_s2, b_s2, w_span, b_span, nblk: int):
    """→ (B, 2·cin, ⌈H/2⌉, ⌈W/2⌉) bf16 after the bf16 stride-2 block and
    `nblk` bf16 span blocks.  CUDA: the bf16 stage kernels of
    `csrc/s2span.cu` (`fastdet_s2span_bf16`) as `span16_plan(...,
    stride2=True)` launches them (their launches counted); CPU: the plain
    version."""
    dev = x.device
    if dev.type == "cpu":
        return s2span_reference_bf16(x, w_s2, b_s2, w_span, b_span, nblk)
    if dev.type != "cuda":
        raise ValueError(f"s2span_bf16: unsupported device {dev}")
    if (x.dim() != 4 or x.shape[1] not in S2SPAN_CHANNELS or x.dtype != BF16
            or not x.is_contiguous()):
        raise ValueError(
            f"s2span_bf16: expected a contiguous bf16 (B, cin, H, W) tensor "
            f"with cin in {S2SPAN_CHANNELS}, got {x.dtype} {tuple(x.shape)}")
    bsz, cin, hin, win = x.shape
    _check16(w_s2, "s2span_bf16", "stride-2 weights", dev, BF16,
             (s2_16_elems(cin, cin),), 8)
    _check16(b_s2, "s2span_bf16", "stride-2 biases", dev, torch.float32,
             (3 * cin,), 4)
    if nblk:
        _check16(w_span, "s2span_bf16", "span weights", dev, BF16,
                 (nblk, span16_elems(cin)), 8)
        _check16(b_span, "s2span_bf16", "span biases", dev, torch.float32,
                 (nblk, 2 * cin), 4)
    shape = (bsz, 2 * cin, (hin + 1) // 2, (win + 1) // 2)
    plan = span16_plan(bsz, 2 * cin, shape[2], shape[3], nblk, True, win)
    out = torch.empty(shape, dtype=BF16, device=dev)
    tmp = torch.empty_like(out) if nblk > 0 else out
    lib = _build.load("s2span", _S2SPAN_SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.fastdet_s2span_bf16(
            x.data_ptr(), out.data_ptr(), tmp.data_ptr(), w_s2.data_ptr(),
            b_s2.data_ptr(), w_span.data_ptr() if nblk else None,
            b_span.data_ptr() if nblk else None, bsz, cin, hin, win, nblk,
            plan.rows_s2, plan.rows,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, "s2span_bf16")
    s2span_bf16.launches += plan.launches
    return out


s2span_bf16.launches = 0


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


def _af_neck(c2, c3, p):
    """The anchor-free single-scale neck and decoupled heads → the raw NHWC
    (obj, cls, reg) at stride 16.  The concat is [C2, upsample(C3)], the
    reverse of LightFPN's."""
    up = F.interpolate(c3, scale_factor=2, mode="nearest")
    s = F.relu(F.conv2d(torch.cat([c2, up], dim=1), p["fuse_w"],
                        p["fuse_b"]))
    cls_f = _dwcb(s, p, "head_cls")
    reg_f = _dwcb(s, p, "head_reg")
    outs = (F.conv2d(cls_f, p["out_obj_w"], p["out_obj_b"]),
            F.conv2d(cls_f, p["out_cls_w"], p["out_cls_b"]),
            F.conv2d(reg_f, p["out_reg_w"], p["out_reg_b"]))
    return tuple(o.permute(0, 2, 3, 1) for o in outs)


HEADS = {"yolo": (pack_fused_weights, _fpn),
         "anchorfree": (pack_fused_weights_af, _af_neck)}


def _device_weights(pk: Dict[str, np.ndarray], device,
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Folded numpy weights (JAX layouts) → the forward's tensors: conv
    weights as OIHW on `device` (the nhwc stem's as `stem_conv_w`/`_b`),
    each stage's span and its whole stage as one packed tensor each on
    `device`, the stem's scaled weight and bias on the host (B1's and
    B10's kernel parameters).

    dtype bf16: every weight of ndim > 1 is cast to bf16 as the JAX
    package casts its packed arrays (every bias stays f32), and each
    stage's span and stride-2 block are the bf16 kernels' composed
    `s{stage}_span16`/`_b` and `s{stage}_s2_16`/`_b` (fold.py
    `pack_span16`, `pack_s2_16`), in place of `s{stage}_span` and
    `s{stage}_s2span`."""
    p: Dict[str, torch.Tensor] = {}
    blocks = {}                  # stage → block index → folded arrays
    for k, v in pk.items():
        parts = k.split("_")
        if k.startswith("stem_"):
            continue
        if parts[0][0] == "s" and parts[0][1:].isdigit():
            blocks.setdefault(int(parts[0][1:]), {}).setdefault(
                int(parts[1]), {})[parts[2]] = v
            if parts[1] != "0":
                continue
        if v.ndim == 3:                                 # depthwise (kh,kw,C)
            v = v.transpose(2, 0, 1)[:, None]
        elif v.ndim == 2:                               # pointwise (Cin,Cout)
            v = v.T[:, :, None, None]
        t = torch.from_numpy(np.ascontiguousarray(v))
        p[k] = (t.to(dtype) if v.ndim > 1 else t).to(device)
    for stage, blk in blocks.items():
        s1 = [blk[i] for i in sorted(blk) if i > 0]
        if dtype == BF16:
            for name, (w, b) in (("span16", pack_span16(s1)),
                                 ("s2_16", pack_s2_16(blk[0]))):
                p[f"s{stage}_{name}"] = bf16_from_bits(w).to(device)
                p[f"s{stage}_{name}_b"] = torch.from_numpy(b).to(device)
            continue
        p[f"s{stage}_span"] = torch.from_numpy(
            pack_span_weights(s1)).to(device)
        p[f"s{stage}_s2span"] = torch.from_numpy(
            pack_s2span_weights(blk[0], s1)).to(device)
    w, b = pack_stem_s2d(pk["stem_w"], pk["stem_b"])
    p["stem_w"] = torch.from_numpy(np.ascontiguousarray(w)).to(dtype)
    p["stem_b"] = torch.from_numpy(b)
    p["stem_conv_w"] = torch.from_numpy(np.ascontiguousarray(
        pk["stem_w"].transpose(3, 2, 0, 1))).to(dtype).to(device)
    p["stem_conv_b"] = torch.from_numpy(pk["stem_b"]).to(device)
    return p


# ------------------------------------------------- the bf16 PyTorch pieces
#
# The parts the JAX package leaves to XLA, in bf16 under jnp's promotion
# rules, each rounding point written out (torch refuses mixed-dtype
# products): bf16 ⊛ bf16 gives bf16, one rounding after the f32
# accumulation and before the f32 bias, which promotes the sum to f32;
# f32 ⊛ bf16 gives f32 (TF32 off on the card); an activation cast back to
# bf16 is one rounding.

def _s2_block_bf16(x, p, prefix: str):
    """The stride-2 block as `_s2_block_xla` computes it in bf16: x bf16 →
    concat[proj, main] bf16."""
    mid = p[f"{prefix}_bd"].shape[0]
    cin = x.shape[1]
    y = F.relu(_bias(_conv16(x, p[f"{prefix}_w1"]), p[f"{prefix}_b1"]))
    y = _bias(_conv16(y.to(BF16), p[f"{prefix}_wd"], 2, 1, mid),
              p[f"{prefix}_bd"])
    y = F.relu(F.conv2d(y, p[f"{prefix}_w2"].float(), p[f"{prefix}_b2"]))
    pr = _bias(_conv16(x, p[f"{prefix}_wpd"], 2, 1, cin), p[f"{prefix}_bpd"])
    pr = F.relu(F.conv2d(pr, p[f"{prefix}_wpp"].float(), p[f"{prefix}_bpp"]))
    return torch.cat([pr, y], dim=1).to(BF16)


def _dwcb_bf16(x, p, head: str):
    """The head DWConvBlock as `_dwcb_xla` computes it in bf16."""
    for dw, pw in ((f"{head}_dw1", f"{head}_pw1"),
                   (f"{head}_dw2", f"{head}_pw2")):
        x = F.relu(_bias(_conv16(x, p[dw + "_w"], 1, 2, x.shape[1]),
                         p[dw + "_b"])).to(BF16)
        x = _bias(_conv16(x, p[pw + "_w"]), p[pw + "_b"]).to(BF16)
    return x


def _up2(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _fpn_bf16(c2, c3, p):
    """LightFPN + shared heads as `_fpn_xla` computes them in bf16 → the
    raw NHWC 6-tuple, f32."""
    s3 = F.relu(_bias(_conv16(c3, p["conv1x1_3_w"]),
                      p["conv1x1_3_b"])).to(BF16)
    s2 = F.relu(_bias(_conv16(torch.cat([_up2(c3), c2], dim=1),
                              p["conv1x1_2_w"]), p["conv1x1_2_b"])).to(BF16)
    outs = []
    for s, tag in ((s2, 2), (s3, 3)):
        cls_f = _dwcb_bf16(s, p, f"cls_head_{tag}")
        reg_f = _dwcb_bf16(s, p, f"reg_head_{tag}")
        outs += [_bias(_conv16(reg_f, p["output_reg_w"]), p["output_reg_b"]),
                 _bias(_conv16(cls_f, p["output_obj_w"]), p["output_obj_b"]),
                 _bias(_conv16(cls_f, p["output_cls_w"]), p["output_cls_b"])]
    return tuple(o.permute(0, 2, 3, 1) for o in outs)


def _af_neck_bf16(c2, c3, p):
    """The anchor-free neck and heads as `_af_neck_xla` computes them in
    bf16 → the raw NHWC (obj, cls, reg), f32."""
    s = F.relu(_bias(_conv16(torch.cat([c2, _up2(c3)], dim=1), p["fuse_w"]),
                     p["fuse_b"])).to(BF16)
    cls_f = _dwcb_bf16(s, p, "head_cls")
    reg_f = _dwcb_bf16(s, p, "head_reg")
    outs = (_bias(_conv16(cls_f, p["out_obj_w"]), p["out_obj_b"]),
            _bias(_conv16(cls_f, p["out_cls_w"]), p["out_cls_b"]),
            _bias(_conv16(reg_f, p["out_reg_w"]), p["out_reg_b"]))
    return tuple(o.permute(0, 2, 3, 1) for o in outs)


def _stem_nhwc_bf16(images, p):
    """The NHWC stem as the JAX package's XLA stem computes it in bf16:
    bf16(u8) / bf16(255) (a bf16 division), bf16 ⊛ bf16(stem_w) → bf16, +
    the f32 bias, ReLU, bf16, max pool."""
    x = (images.permute(0, 3, 1, 2).contiguous().float() / 255.0).to(BF16)
    y = F.relu(_bias(_conv16(x, p["stem_conv_w"], 2, 1),
                     p["stem_conv_b"])).to(BF16)
    return F.max_pool2d(y.float(), 3, 2, 1).to(BF16)


HEADS_BF16 = {"yolo": _fpn_bf16, "anchorfree": _af_neck_bf16}


def build_fused_forward(state_dict, input_hw: Tuple[int, int] = (352, 352),
                        dtype=torch.float32, input_format: str = "s2d_u8",
                        upto: str = None, fuse_s2: bool = False,
                        head: str = "yolo", device=None
                        ) -> Tuple[Callable, Dict[str, torch.Tensor]]:
    """Returns (forward_fn, packed): forward_fn(images, packed) with images
    a uint8 tensor on `device` in `input_format` → the raw NHWC 6-tuple of
    `Detector` (`head="yolo"`) or the raw NHWC (obj, cls, reg) of
    `AnchorFreeDetector` (`head="anchorfree"`), f32.  `state_dict` is the
    port's (e.g. `fastdet_torch.io.load_state_dict`) for that head's
    model; the head's classes and anchors follow from it.  `packed` holds the folded weights: conv weights OIHW
    on `device`, each stage's span as one tensor `s{stage}_span` and its
    whole stage as one flat row `s{stage}_s2span`, and the stem's scaled
    `stem_w`/`stem_b` on the host.

    input_format:
      * "s2d_u8" (the port's default; the JAX package's is "nhwc"):
        (B, 48, pad128(H/4·W/4)) from `pack_images_s2d`, stem B1;
      * "s2d8_u8": (B, 192, pad128(H/8·W/8)) from `pack_images_s2d8`, stem
        B10, and stage 2 always through the stage kernel B9, as in the JAX
        package; H and W divisible by 8 and pad128(H/8·W/8) ≤ 2048;
      * "nhwc": (B, H, W, 3), the stem in PyTorch (/255, conv, ReLU,
        max_pool2d), as the JAX package leaves it to XLA.

    fuse_s2: every stage through B9 (stride-2 block and span in one call);
    else a stage is the stride-2 block in PyTorch, then B2.

    upto: None for the whole forward; "stem"/"s2"/"s3"/"s4" stop after that
    stage and return its NHWC map (the per-stage timing hook)."""
    if input_format not in INPUT_FORMATS:
        raise ValueError(f"unknown input_format {input_format!r}")
    if head not in HEADS:
        raise ValueError(f"unknown head {head!r}")
    if dtype not in DTYPES:
        raise NotImplementedError(
            f"fastdet_torch: the fused forward computes torch.float32 or "
            f"torch.bfloat16 (the JAX package's serving dtypes), not "
            f"dtype={dtype}")
    if upto not in (None, "stem", "s2", "s3", "s4"):
        raise ValueError(f"unknown upto {upto!r}")
    ih, iw = input_hw
    h4, w4 = ih // 4, iw // 4
    if ih % 32 or iw % 32:
        raise ValueError(f"input {input_hw} must be a multiple of 32")
    if input_format == "s2d8_u8":
        check_stem8_size(ih, iw)
    shape = {"s2d_u8": (48, _pad128(h4 * w4)),
             "s2d8_u8": (192, _pad128(h4 * w4 // 4)),
             "nhwc": (ih, iw, 3)}[input_format]
    dev = resolve_device(device)
    pack, neck = HEADS[head]

    def nhwc(x):
        return x.permute(0, 2, 3, 1)

    def check_input(images):
        if (tuple(images.shape[1:]) != shape
                or images.dtype != torch.uint8):
            raise ValueError(f"expected (B, {', '.join(map(str, shape))}) "
                             f"uint8 {input_format} input, got "
                             f"{images.dtype} {tuple(images.shape)}")

    packed = _device_weights(pack(state_dict), dev, dtype)
    if dtype == BF16:
        return _bf16_forward(check_input, input_format, fuse_s2, upto, head,
                             h4, w4), packed

    def stem(images, p):
        if input_format == "s2d_u8":
            return stem_s2d(images, p["stem_w"], p["stem_b"], h4, w4)
        if input_format == "s2d8_u8":
            return stem_s2d8(images, p["stem_w"], p["stem_b"], h4 // 2,
                             w4 // 2)
        # NCHW-contiguous: a permuted view would make every conv after it
        # channels-last, which the kernels do not take
        x = images.permute(0, 3, 1, 2).contiguous().float() / 255.0
        x = F.relu(F.conv2d(x, p["stem_conv_w"], p["stem_conv_b"], stride=2,
                            padding=1))
        return F.max_pool2d(x, 3, 2, 1)

    def forward(images, p):
        check_input(images)
        x = stem(images, p)
        if upto == "stem":
            return nhwc(x)
        feats = {}
        for sid, reps, _ in STAGES:
            if fuse_s2 or (sid == 2 and input_format == "s2d8_u8"):
                x = s2span(x, p[f"s{sid}_s2span"], reps - 1)
            else:
                x = _s2_block(x, p, f"s{sid}_0")
                x = span(x, p[f"s{sid}_span"], reps - 1)
            feats[sid] = x
            if upto == f"s{sid}":
                return nhwc(x)
        return neck(feats[3], feats[4], p)

    return forward, packed


def _bf16_forward(check_input, input_format: str, fuse_s2: bool, upto,
                  head: str, h4: int, w4: int) -> Callable:
    """The bf16 forward of `build_fused_forward(dtype=torch.bfloat16)`:
    the JAX package's bf16 function, stage by stage (bf16 maps; the heads'
    logits f32)."""
    neck = HEADS_BF16[head]

    def stem(images, p):
        if input_format == "s2d_u8":
            return stem_s2d_bf16(images, p["stem_w"], p["stem_b"], h4, w4)
        if input_format == "s2d8_u8":
            return stem_s2d8_bf16(images, p["stem_w"], p["stem_b"], h4 // 2,
                                  w4 // 2)
        return _stem_nhwc_bf16(images, p)

    def forward(images, p):
        check_input(images)
        x = stem(images, p)
        if upto == "stem":
            return x.permute(0, 2, 3, 1)
        feats = {}
        for sid, reps, _ in STAGES:
            if fuse_s2 or (sid == 2 and input_format == "s2d8_u8"):
                x = s2span_bf16(x, p[f"s{sid}_s2_16"], p[f"s{sid}_s2_16_b"],
                                p[f"s{sid}_span16"], p[f"s{sid}_span16_b"],
                                reps - 1)
            else:
                x = _s2_block_bf16(x, p, f"s{sid}_0")
                x = span_bf16(x, p[f"s{sid}_span16"], p[f"s{sid}_span16_b"],
                              reps - 1)
            feats[sid] = x
            if upto == f"s{sid}":
                return x.permute(0, 2, 3, 1)
        return neck(feats[3], feats[4], p)

    return forward
