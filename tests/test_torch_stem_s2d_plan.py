"""The inference stem kernel's launch plan and its steps
(fastdet_torch/csrc/stem_core.cuh under stem_s2d.cu and stem_s2d8.cu), on
the CPU.

The plan (`stem_plan`): at every shape the card tests and the smoke run,
a CTA fits the card's shared memory, the tiles cover each image once with
their halo rows and their plane words fit the raw buffer, a call is one
launch, and at b128 352² the persistent grid fills the 132 SMs.

The steps (`stem_steps`, below): the kernel's arithmetic in numpy, in its
order and with its indexing: the parameter block (a power of two a
channel, each weight as two f16 terms, the lanes' B fragments), the
staging of a tile from the s2d(4) or s2d(8) planes into f16 pixel planes
(NaN where the kernel leaves shared memory unwritten, so that a read of
it shows), the lanes' K slots and the 16-row M tiles, f32 accumulation
seeded with the scaled bias, ReLU, and the pool from registers (the
previous row's py=1 outputs, the left cell's px=1 column max by a
shuffle, 0 standing in at the top and left edges).  Held within 2e-4 of
`stem_s2d_reference` / `stem_s2d8_reference` with the real stem weights
of weights/coco2017-ref.npz, and the pool bitwise against max_pool2d of
the same conv values, flat-block images with pool ties among them.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fastdet_torch.io import load_state_dict
from fastdet_torch.kernels import fused_infer as fi
from fastdet_torch.kernels.fold import pack_fused_weights
from fastdet_torch.kernels.stem_train import SMS
from torch_cases import STEM8_CASES, STEM_CASES, stem8_case, stem_case

ATOL = 2e-4          # the stem's contract against its plain version
REF_NPZ = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "weights", "coco2017-ref.npz")
TAPS = 27


# ------------------------------------------------------------ the steps

def tap(k: int):
    """(ky, kx, c) of K slot k (the HWIO order); the pad slots read tap 0,
    whose weight there is 0."""
    if k >= TAPS:
        k = 0
    return k // 9, (k // 3) % 3, k % 3


def stem_params(w, b):
    """`stem_pack_params`: → (frag (24, 32) uint32, seed (24,) f32,
    unscale (24,) f32, terms (2, 32, 24) f16): per channel e with
    max|w·2^e| in [2^14, 2^15), w·2^e = hi + lo in f16 (round to nearest
    even), K ≥ 27 zero; lane (g, tig)'s register ((n·2 + ks)·2 + half)·2
    + term holds the pair K = 16ks + 8half + 2tig, +1 of channel 8n + g."""
    w = np.asarray(w, np.float32).reshape(TAPS, 24)
    terms = np.zeros((2, 32, 24), np.float16)
    seed = np.zeros(24, np.float32)
    unscale = np.zeros(24, np.float32)
    for o in range(24):
        m = np.abs(w[:, o]).max()
        e = min(15 - int(np.frexp(m)[1]), 100) if m > 0 else 0
        ws = np.ldexp(w[:, o], e).astype(np.float32)
        terms[0, :TAPS, o] = ws.astype(np.float16)
        terms[1, :TAPS, o] = (ws - terms[0, :TAPS, o].astype(np.float32)
                              ).astype(np.float16)
        seed[o] = np.ldexp(np.float32(b[o]), e)
        unscale[o] = np.ldexp(np.float32(1.0), -e)
    bits = terms.view(np.uint16).astype(np.uint32)
    frag = np.zeros((24, 32), np.uint32)
    for lane in range(32):
        g, tig = lane >> 2, lane & 3
        for n in range(3):
            for ks in range(2):
                for half in range(2):
                    for term in range(2):
                        k = 16 * ks + 8 * half + 2 * tig
                        frag[((n * 2 + ks) * 2 + half) * 2 + term, lane] = (
                            bits[term, k, 8 * n + g]
                            | bits[term, k + 1, 8 * n + g] << 16)
    return frag, seed, unscale, terms


def fragments_to_b(frag):
    """The (2, 32, 24) f32 B matrices the lanes' registers hold."""
    b = np.zeros((2, 32, 24), np.float32)
    for lane in range(32):
        g, tig = lane >> 2, lane & 3
        for r in range(24):
            term, half, ks, n = r & 1, (r >> 1) & 1, (r >> 2) & 1, r >> 3
            pair = np.array([frag[r, lane] & 0xFFFF, frag[r, lane] >> 16],
                            np.uint16).view(np.float16)
            k = 16 * ks + 8 * half + 2 * tig
            b[term, k:k + 2, 8 * n + g] = pair
    return b


def u8_to_f16(x):
    """The kernel's exact u8 → f16: the bits 0x6400 | x are 1024 + x, less
    1024 (in f16)."""
    bits = (np.asarray(x, np.uint16) | np.uint16(0x6400)).view(np.float16)
    return bits - np.float16(1024)


def stage_tile(xs, factor, hk, wk, i0, v0, rows, strips):
    """`stage_tile` and the zero halo of one image's tile → the flat f16
    shared buffer (3 planes of `stem_plane_stride` elements), NaN where
    the kernel leaves it unwritten."""
    k = factor
    rs = fi.stem_row_stride(strips)
    ps = (4 * rows + 4) * rs + 16
    s = np.full(3 * ps, np.nan, np.float16)
    y_lo, y_hi = max(4 * i0 - 4, 0), min(4 * (i0 + rows), k * hk)
    x_lo = max(4 * v0 - 4, 0)
    x_hi = min(4 * v0 + 4 * fi.STEM_STRIP_CELLS * strips, k * wk)
    u_lo, u_hi = y_lo // k, -(-y_hi // k)
    l_lo, l_hi = x_lo // k, -(-x_hi // k)
    nw = (l_hi - l_lo + 3) // 4 + 1
    t = np.arange((u_hi - u_lo) * 3 * k * nw)
    wi, r = t % nw, t // nw
    c, r = r % 3, r // 3
    yoff, u = r % k, u_lo + r // k
    y = k * u + yoff
    first, last = u * wk + l_lo, u * wk + l_hi
    word = (first >> 2) + wi
    assert len(t) * k <= fi.stem_raw_words(rows, strips, k)   # raw buffer
    ok = (y >= y_lo) & (y < y_hi) & (4 * word < last)
    c, yoff, u, y, first, last, word = (a[ok] for a in (c, yoff, u, y, first,
                                                        last, word))
    row = c * ps + (y - 4 * i0 + 4) * rs - 4 * v0 + 8
    for lb in range(4):                       # byte lb of each plane word
        lane = 4 * word + lb
        okl = (lane >= first) & (lane < last)
        x0 = k * (lane - u * wk)
        for q in range(k // 4):
            x = x0 + 4 * q
            okq = okl & (x >= x_lo) & (x < x_hi)
            for d in range(4):                # planes xoff = 4q + d
                plane = yoff * 3 * k + (4 * q + d) * 3 + c
                s[(row + x + d)[okq]] = u8_to_f16(
                    xs[plane[okq], lane[okq]])
    if i0 == 0:
        for ch in range(3):
            s[ch * ps:ch * ps + 4 * rs] = 0
    if v0 == 0:
        for ch in range(3):
            for ys in range(4 * rows + 4):
                s[ch * ps + ys * rs:ch * ps + ys * rs + 8] = 0
    return s, rs, ps


def slot_offsets(rs, ps):
    """off[K]: the element offset K slot reads, from the lane that holds it
    (tig = (K mod 8) / 2, slot r = 4ks + 2half + lo/hi)."""
    off = np.zeros(32, np.int64)
    for tig in range(4):
        for r in range(8):
            k = 16 * (r >> 2) + 8 * ((r >> 1) & 1) + 2 * tig + (r & 1)
            ky, kx, c = tap(k)
            off[k] = c * ps + ky * rs + kx
    return off


def conv_tiles(s, rs, ps, yrows, strips, seed, bmat):
    """conv_mtile at pixel rows `yrows` for every strip and group: → (rows,
    strips, 8 groups, 2 px, 24) f32 ReLU'd conv outputs scaled by 2^e.  A
    row g of the M tile is the group's px 0, row g + 8 its px 1."""
    off = slot_offsets(rs, ps)
    col = 4 * (fi.STEM_STRIP_CELLS * np.arange(strips)[:, None]
               + np.arange(8)[None, :]) + 3
    idx = (np.asarray(yrows)[:, None, None, None, None] * rs
           + col[None, :, :, None, None]
           + 2 * np.arange(2)[None, None, None, :, None]
           + off[None, None, None, None, :])
    a = s[idx].astype(np.float64)
    acc = np.broadcast_to(seed, a.shape[:4] + (24,)).astype(np.float32)
    for ks in range(2):
        for term in range(2):
            part = a[..., 16 * ks:16 * ks + 16] @ bmat[term, 16 * ks:
                                                       16 * ks + 16]
            acc = (acc + part).astype(np.float32)
    return np.maximum(acc, np.float32(0))


def stem_steps(x, w, b, factor, hk, wk):
    """The kernel's steps on the CPU: x (B, 3·factor², npad) uint8 → (the
    pooled map (B, 24, h4, w4) f32, the conv map (B, 24, 2·h4, 2·w4) as
    the kernel's registers held it: ReLU'd and scaled by 2^e)."""
    xs = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    bsz = xs.shape[0]
    h4, w4 = factor * hk // 4, factor * wk // 4
    plan = fi.stem_plan(bsz, h4, w4, factor)
    frag, seed, unscale, _ = stem_params(w, b)
    bmat = fragments_to_b(frag).astype(np.float64)
    out = np.full((bsz, 24, h4, w4), np.nan, np.float32)
    conv = np.full((bsz, 24, 2 * h4, 2 * w4), np.nan, np.float32)
    for bi in range(bsz):
        for i0, _, v0, _ in plan.image_tiles(h4, w4):
            i_end = min(i0 + plan.rows, h4)
            j_end = min(v0 + plan.cols, w4)
            s, rs, ps = stage_tile(xs[bi], factor, hk, wk, i0, v0,
                                   plan.rows, plan.strips)
            yrows = [1] + [4 * (i - i0) + 3 + 2 * py
                           for i in range(i0, i_end) for py in (0, 1)]
            y = conv_tiles(s, rs, ps, yrows, plan.strips, seed, bmat)
            j = (v0 - 1 + fi.STEM_STRIP_CELLS
                 * np.arange(plan.strips)[:, None] + np.arange(8)[None, :])
            mine = (np.arange(8)[None, :] > 0) & (j < j_end)
            prev = y[0] if i0 > 0 else np.zeros_like(y[0])
            for n, i in enumerate(range(i0, i_end)):
                cur0, cur1 = y[1 + 2 * n], y[2 + 2 * n]
                cm = np.maximum(np.maximum(prev, cur0), cur1)
                prev = cur1
                left = np.concatenate([cm[:, :1, 1], cm[:, :-1, 1]], 1)
                left[j == 0] = 0
                v = np.maximum(np.maximum(cm[:, :, 0], cm[:, :, 1]), left)
                out[bi, :, i, j[mine]] = v[mine] * unscale
                for py, cv in ((0, cur0), (1, cur1)):
                    for px in (0, 1):
                        conv[bi, :, 2 * i + py, 2 * j[mine] + px] = (
                            cv[:, :, px][mine])
    return torch.from_numpy(out), torch.from_numpy(conv)


# ------------------------------------------------------------ inputs

@pytest.fixture(scope="module")
def stem_wb():
    pk = pack_fused_weights(load_state_dict(REF_NPZ))
    w, b = fi.pack_stem_s2d(pk["stem_w"], pk["stem_b"])
    return torch.from_numpy(np.ascontiguousarray(w)), torch.from_numpy(b)


# ------------------------------------------------------------ the plan

PLAN_SHAPES = sorted({(b, h // 4, w // 4, 4) for b, h, w in STEM_CASES}
                     | {(b, h // 4, w // 4, 8) for b, h, w in STEM8_CASES})


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=["x".join(map(str, s)) for s in PLAN_SHAPES])
def test_plan_fits_the_card_and_covers_the_image(shape):
    b, h4, w4, factor = shape
    plan = fi.stem_plan(b, h4, w4, factor)
    assert plan.smem_bytes == fi.stem_smem(plan.rows, plan.strips, factor)
    assert plan.smem_bytes <= fi.SMEM_PER_CTA == 232_448
    assert plan.launches == 1 and plan.kernel == fi.STEM_KERNEL
    assert plan.split_weights
    assert 1 <= plan.strips <= fi.STEM_MAX_STRIPS
    assert plan.threads == 32 * plan.strips
    assert plan.tiles == b * plan.bands * plan.tiles_x
    assert plan.grid == (min(plan.tiles, fi.STEM_CTAS_PER_SM * SMS),)
    # each pooled cell in exactly one tile
    seen = np.zeros((h4, w4), np.int64)
    for i0, nr, v0, nc in plan.image_tiles(h4, w4):
        assert nr >= 1 and nc >= 1
        seen[i0:i0 + nr, v0:v0 + nc] += 1
        # the staged pixel rows hold the conv rows the tile's pool reads
        # (2·i0 - 1 .. 2·(i0 + nr) - 1) and their taps, within the image
        lo, hi = max(4 * i0 - 4, 0), min(4 * (i0 + plan.rows), 4 * h4)
        assert lo <= max(4 * i0 - 3, 0) and hi >= 4 * (i0 + nr)
        # the strips hold the tile's columns and the halo cell
        assert 0 < nc <= plan.cols and (v0 - 1) + 8 * plan.strips >= v0 + nc
    assert (seen == 1).all()
    assert plan.tiles_x * plan.cols >= w4 > (plan.tiles_x - 1) * plan.cols


def test_plan_at_the_main_path():
    """b128 352² (B1, B10) and b32 640² (B6): the persistent grid fills
    the card with two CTAs an SM, which its shared memory holds, and each
    CTA walks several tiles."""
    for b, h4, w4, factor in ((128, 88, 88, 4), (128, 88, 88, 8),
                              (32, 160, 160, 4)):
        plan = fi.stem_plan(b, h4, w4, factor)
        assert plan.grid == (fi.STEM_CTAS_PER_SM * SMS,)
        assert plan.tiles >= 7 * plan.grid[0]
        assert fi.STEM_CTAS_PER_SM * (plan.smem_bytes + 1024) <= 228 * 1024
    plan = fi.stem_plan(128, 88, 88, 4)
    assert (plan.rows, plan.strips, plan.tiles_x) == (8, 7, 2)


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        fi.stem_plan(2, 10, 10, 2)
    with pytest.raises(ValueError):
        fi.stem_plan(2, 0, 10, 4)


def test_row_stride_spreads_the_banks():
    """Each strip count's row stride holds the strips' 28 columns and the
    8-column halo, 32 modulo 64 elements; planes 16 elements apart in
    banks."""
    for strips in range(1, fi.STEM_MAX_STRIPS + 1):
        rs = fi.stem_row_stride(strips)
        assert rs >= 8 + 28 * strips and rs % 64 == 32


# ------------------------------------------------------------ the steps

def test_u8_to_f16_is_exact():
    """The kernel's conversion (0x6400 | x as f16, less 1024) gives every
    byte value exactly."""
    x = np.arange(256)
    got = u8_to_f16(x)
    assert got.dtype == np.float16
    assert np.array_equal(got.astype(np.float64), x.astype(np.float64))


def test_weight_terms_hold_f32(stem_wb):
    """hi + lo is w·2^e within 2^-21 of max|w·2^e|, both normal-or-zero
    f16, and the lanes' fragments are those terms."""
    w, b = stem_wb
    frag, seed, unscale, terms = stem_params(w.numpy(), b.numpy())
    wm = w.numpy().reshape(TAPS, 24).astype(np.float64)
    scale = 1.0 / unscale.astype(np.float64)
    got = (terms[0, :TAPS].astype(np.float64)
           + terms[1, :TAPS].astype(np.float64))
    err = np.abs(got - wm * scale).max(0) / (np.abs(wm).max(0) * scale)
    assert (err <= 2.0 ** -21).all(), err.max()
    assert (np.abs(wm * scale).max(0) < 2.0 ** 15).all()
    assert (np.abs(wm * scale).max(0) >= 2.0 ** 14).all()
    assert not terms[:, TAPS:].any()
    assert np.array_equal(fragments_to_b(frag), terms.astype(np.float32))
    assert np.array_equal(seed, (b.numpy() * scale).astype(np.float32))


STEPS4 = ((1, 352, 352), (2, 160, 96), (2, 36, 52), (3, 20, 12),
          (1, 64, 232))
STEPS8 = ((1, 352, 352), (2, 160, 96), (3, 72, 104), (2, 40, 24))


@pytest.mark.parametrize("case", STEPS4,
                         ids=[f"b{b}-{h}x{w}" for b, h, w in STEPS4])
def test_steps_match_the_plain_stem_s2d4(stem_wb, case):
    """s2d(4): 352², pad lanes with junk, tiles cut off at the edges, and
    58 columns in two tiles of 4 strips (64×232)."""
    b, hgt, wid = case
    w, bias = stem_wb
    x = stem_case(sum(case), b, hgt, wid)
    got, _ = stem_steps(x, w.numpy(), bias.numpy(), 4, hgt // 4, wid // 4)
    want = fi.stem_s2d_reference(x, w, bias, hgt // 4, wid // 4)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize("case", STEPS8,
                         ids=[f"b{b}-{h}x{w}" for b, h, w in STEPS8])
def test_steps_match_the_plain_stem_s2d8(stem_wb, case):
    b, hgt, wid = case
    w, bias = stem_wb
    x = stem8_case(sum(case), b, hgt, wid)
    got, _ = stem_steps(x, w.numpy(), bias.numpy(), 8, hgt // 8, wid // 8)
    want = fi.stem_s2d8_reference(x, w, bias, hgt // 8, wid // 8)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= ATOL


def test_both_factors_stage_the_same_pixels(stem_wb):
    """The same images through s2d(4) and s2d(8): the staged tiles, and so
    the outputs, agree bitwise."""
    w, bias = stem_wb
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (2, 72, 104, 3), dtype=np.uint8)
    a, _ = stem_steps(fi._space_to_depth(img, 4), w.numpy(), bias.numpy(),
                      4, 18, 26)
    b, _ = stem_steps(fi._space_to_depth(img, 8), w.numpy(), bias.numpy(),
                      8, 9, 13)
    assert torch.equal(a, b)


@pytest.mark.parametrize("tie", [False, True], ids=["noise", "ties"])
def test_pool_from_registers_is_bitwise(stem_wb, tie):
    """The register pool against max_pool2d (pad −inf) of the same conv
    values, bit for bit; with flat blocks the windows hold positive ties."""
    w, bias = stem_wb
    x = stem_case(11, 2, 96, 96, tie=tie)
    got, conv = stem_steps(x, w.numpy(), bias.numpy(), 4, 24, 24)
    assert torch.isfinite(conv).all()
    want = F.max_pool2d(conv, 3, 2, 1)
    _, _, unscale, _ = stem_params(w.numpy(), bias.numpy())
    assert torch.equal(got, want * torch.from_numpy(unscale)[None, :, None,
                                                             None])
    if tie:
        win = F.unfold(F.pad(conv, (1, 1, 1, 1), value=float("-inf"))
                       .flatten(0, 1)[:, None], 3, stride=2)
        top = win.max(1, keepdim=True).values
        assert int(((win == top).sum(1) > 1)[top[:, 0] > 0].sum()) > 0
