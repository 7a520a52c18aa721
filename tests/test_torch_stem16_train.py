"""The bf16 training stem kernel of B7 (`csrc/stem16_train.cu`), on the
CPU: the exactness its conv rests on, its launch plan
(`stem16_train_plan`) at every shape the smoke and the card tests run, and
the file's `stem16_train_steps`, the kernel's steps in torch: the tiles
(bands of cell rows × chunks of 31·ncw columns), the per-tile integer
Gram matrix of the conv's patches and the stats from the group's sum, the
emit's halo (the phases py = 1 of the row above a band, the column left of
each 31-column warp) and the pool's winner by the JAX precedence among the
rounded values, the backward's owner-computes gy from the winners' codes,
du whole and rounded to bf16, and dW as per-warp f32 sums over K-chunks of
16 outputs (one phase, 16 columns; two warps a chunk, two phases each) in
the MMA's K order, the warps' sums added in order and the tiles' in order;
Sg and Sgx from (dy, zw).  The steps are held to
`stem_train_forward_reference` / `stem_train_backward_reference(bf16=
True)`: y bit for bit the plain
rounded chain with the steps' stats, (code, zw) bit for bit
`stem16_winners_reference` of the plain conv, the stats within 5e-5, the
gradients within 2⁻⁶ of max |value|; a wrong halo or tile table is
caught."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fastdet_torch.kernels import stem_train as st
from torch_cases import BF16_TRAIN_RTOL, STEM_TRAIN_CASES, stem_train_case

BF16 = torch.bfloat16
STATS_RTOL = 5e-5
# (b, h4, w4, g): every B7 shape of the card tests and smoke phase 10, the
# grouped main path, 640² and a width of two column chunks
PLAN_SHAPES = sorted({(b, h // 4, w // 4, g)
                      for b, h, w, g, _, _ in STEM_TRAIN_CASES}
                     | {(128, 88, 88, 16), (32, 160, 160, 1),
                        (2, 8, 100, 1)})
# the small card cases (one band, several bands, g 1 and 2, ties, γ of
# both signs and 0), and one of two column chunks and two bands
STEP_CASES = [STEM_TRAIN_CASES[i] for i in (3, 4, 5, 6, 7)] + [
    (2, 64, 400, 1, True, True)]


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def test_bf16_products_are_exact():
    """Every finite bf16 weight (the stem's scaled weights are among them)
    times every u8 pixel is exact in f32: the product has at most 8 + 8
    significant bits.  So an FMA, which rounds x·w + acc once, equals the
    plain version's rounded product plus a rounded add, bit for bit."""
    w = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    w = w[np.isfinite(w) & (np.abs(w) <= np.finfo(np.float32).max / 255)]
    w64 = w.astype(np.float64)
    for x in range(256):
        prod = np.float32(x) * w
        assert np.array_equal(prod.astype(np.float64), x * w64), x
    # and the accumulation order (ky, kx, c) from 0 is the plain `_conv`'s
    x, w_raw, *_ = stem_train_case(1, 2, 32, 48)
    ws = st.round16(w_raw * (1.0 / 255.0))
    imgp = st._image(x, 8, 12, torch.float64)
    u64 = st._conv(imgp, ws.double())
    u = st._conv(st._image(x, 8, 12, torch.float32), ws)
    assert _rel(u, u64) < 1e-6


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=["x".join(map(str, s)) for s in PLAN_SHAPES])
def test_plan_fits_the_card(shape):
    b, h4, w4, g = shape
    p = st.stem16_train_plan(b, h4, w4, g)
    assert max(p.smem_by_kernel.values()) <= st.SMEM_PER_CTA == 232_448
    # two CTAs of each conv kernel share an SM's 228 KB
    assert all(2 * (v + 1024) <= 233_472 for v in p.smem_by_kernel.values())
    assert 1 <= p.rows <= st.S16_MAX_ROWS and 1 <= p.ncw <= st.S16_MAX_NCW
    assert p.threads == 128 * p.ncw <= 384
    assert (p.launches_fwd, p.launches_bwd) == (3, 3)
    assert p.ctas == b * p.bands * p.chunks
    # a tile's Gram matrix stays in s32: each term ≤ 255², with its ones
    assert p.rows * p.cols * 4 * 255 ** 2 < 2 ** 31
    # the tiles cover each cell once
    cover = np.zeros((h4, w4), np.int64)
    for band in range(p.bands):
        for chunk in range(p.chunks):
            i0, c0 = band * p.rows, chunk * p.cols
            assert i0 < h4 and c0 < w4
            cover[i0:i0 + p.rows, c0:c0 + p.cols] += 1
    assert (cover == 1).all()
    assert p == st.stem16_train_plan(b, h4, w4, 1)


def test_plan_at_352():
    """b128 352²: 8 bands of 11 cell rows, 3 column warps (93 columns for
    88) per channel group of 6, 1024 CTAs of 384 threads; gram, stats, emit
    forward; sums, sweep, reduce backward."""
    p = st.stem16_train_plan(128, 88, 88, 1)
    assert (p.rows, p.ncw, p.bands, p.chunks) == (11, 3, 8, 1)
    assert (p.threads, p.ctas) == (384, 1024)
    assert p.kernels_fwd == ("stem16_gram_kernel", "stem16_stats_kernel",
                             "stem16_emit_kernel")
    assert p.kernels_bwd == ("stem16_sums_kernel", "stem16_bwd_kernel",
                             "stem16_reduce_kernel")
    assert p.smem_by_kernel == {"stem16_gram_kernel": 60_528,
                                "stem16_emit_kernel": 79_680,
                                "stem16_bwd_kernel": 99_488}


# ------------------------------------------------------------ the steps

def _tiles(p, h4, w4):
    """(i0, rows, c0, cols) of each tile of an image, in launch order."""
    for band in range(p.bands):
        for chunk in range(p.chunks):
            i0, c0 = band * p.rows, chunk * p.cols
            yield i0, min(p.rows, h4 - i0), c0, min(p.cols, w4 - c0)


def _patches(imgp, i0, rows, c0, cols):
    """The tile's conv outputs' patches (b, K, 27) in the kernel's K order
    (row, phase, column) and (ky, kx, c) tap order: pixel
    imgp[c, 4i + 2py + ky, 4j + 2px + kx] of the padded image."""
    out = []
    for i in range(i0, i0 + rows):
        for ph in range(4):
            py, px = ph >> 1, ph & 1
            taps = []
            for ky in range(3):
                for kx in range(3):
                    for c in range(3):
                        r = 4 * i + 2 * py + ky
                        taps.append(imgp[:, c, r, 4 * c0 + 2 * px + kx:
                                         4 * (c0 + cols) + 2 * px + kx:4])
            out.append(torch.stack(taps, -1))          # (b, cols, 27)
    return torch.cat(out, 1)


def _stats(gram, w16, m):
    """The stats kernel: a group's int64 Gram matrix (28, 28) → (24, 3)
    f32, the moments in f64 as the kernel takes them."""
    g64 = gram.double()
    s = g64[27, :27]
    c = (g64[:27, :27] - torch.outer(s, s) / m) / m
    wt = w16.double().permute(0, 2, 3, 1).reshape(24, 27)   # (ky, kx, c)
    mu = (wt @ s / m).float()
    var = torch.einsum("oa,ab,ob->o", wt, c, wt).clamp_min(0).float()
    return torch.stack([mu, 1.0 / torch.sqrt(var + st.EPS), var], -1)


def _winners(yb, ut):
    """A tile's windows from its region of rounded yb and raw u (rows 2i0 −
    1 .., columns 2c0 − 1 .., −inf where not recomputed) → (code, zw, the
    pooled value): the first member in the JAX precedence (column 2j,
    2j+1, 2j−1; row 2i, 2i+1, 2i−1) that holds the maximum."""
    nr, nc = (yb.shape[2] - 1) // 2, (yb.shape[3] - 1) // 2
    vals, raws = [], []
    for cs in (1, 2, 0):
        for rs in (1, 2, 0):
            vals.append(yb[:, :, rs:rs + 2 * nr:2, cs:cs + 2 * nc:2])
            raws.append(ut[:, :, rs:rs + 2 * nr:2, cs:cs + 2 * nc:2])
    v = torch.stack(vals)
    top = v.max(0).values
    first = (v == top).int().argmax(0)
    zw = torch.stack(raws).gather(0, first[None])[0]
    return first.to(torch.uint8), zw, top


def stem16_train_steps(x, w, gamma, beta, h4, w4, g, dy, halo=True,
                       plan=None):
    """The kernel's steps in torch → (y, stats, zw, code, (dW, dγ, dβ)).
    `halo=False` drops the emit's recomputed row above each band (a wrong
    halo table); `plan` replaces `stem16_train_plan`'s (a wrong tile
    table); cells no tile covers stay NaN (y, zw) and 255 (code)."""
    b = x.shape[0]
    p = plan or st.stem16_train_plan(b, h4, w4, g)
    w16 = st.round16(w)
    imgp = st._image(x, h4, w4, torch.float32)
    # gram: each tile's integer Gram matrix of [patch, 1], summed by group
    grams = []
    for bi in range(b):
        for i0, rows, c0, cols in _tiles(p, h4, w4):
            pt = _patches(imgp[bi:bi + 1], i0, rows, c0, cols)[0]
            pt = torch.cat([pt, torch.ones_like(pt[:, :1])], 1).long()
            grams.append(pt.T @ pt)
    per = len(grams) // b
    stats = torch.stack([
        _stats(sum(grams[gi * g * per:(gi + 1) * g * per]), w16,
               g * 4 * h4 * w4) for gi in range(b // g)])
    # emit: per tile, the conv of its cells and its halo (row 2i0 − 1, the
    # phases py = 1 of the row above; column 2c0 − 1), −inf at the image's
    # edge and where the halo is not recomputed
    u = st._conv(imgp, w16)
    y = torch.full((b, 24, h4, w4), float("nan"), dtype=BF16)
    zw = torch.full((b, 24, h4, w4), float("nan"))
    code = torch.full((b, 24, h4, w4), 255, dtype=torch.uint8)
    bn, _ = st._bn_parts(u, stats, gamma, beta, g)
    yb_all = st.round16(torch.relu(bn))
    ninf = float("-inf")
    for i0, rows, c0, cols in _tiles(p, h4, w4):
        r0 = 2 * i0 - 1 if (halo and i0 > 0) else 2 * i0
        q0 = max(2 * c0 - 1, 0)
        rs, cs = slice(r0, 2 * (i0 + rows)), slice(q0, 2 * (c0 + cols))
        pad = (1 - (2 * c0 - q0), 0, 1 - (2 * i0 - r0), 0)
        ct, zt, top = _winners(F.pad(yb_all[:, :, rs, cs], pad, value=ninf),
                               F.pad(u[:, :, rs, cs], pad))
        at = (slice(None), slice(None), slice(i0, i0 + rows),
              slice(c0, c0 + cols))
        y[at], code[at], zw[at] = top.to(BF16), ct, zt
    return y, stats, zw, code, _backward_steps(
        p, imgp, u, gamma, beta, stats, zw, code, dy, h4, w4, g)


def _backward_steps(p, imgp, u, gamma, beta, stats, zw, code, dy, h4, w4,
                    g):
    """The backward's steps: Sg, Sgx per plane from (dy, zw) (the sums
    kernel), gy of each conv output from the codes and dy of the windows
    over it (owner computes; the plain route's order (A + B) + (C + D)),
    du whole and rounded, dW by K-chunks of 16 outputs → (dW, dγ, dβ)."""
    b = u.shape[0]
    dyf = dy.float()
    d = zw - st._per_image(stats[:, :, 0], g)
    bnz = d * st._per_image(stats[:, :, 1] * gamma, g) + beta[:, None, None]
    gm = torch.where(bnz > 0, dyf, torch.zeros_like(dyf))
    sg_p = gm.sum((2, 3))
    sgx_p = (gm * (d * st._per_image(stats[:, :, 1], g))).sum((2, 3))
    sg = sg_p.reshape(b // g, g, 24).sum(1)
    sgx = sgx_p.reshape(b // g, g, 24).sum(1)
    inv_m = 1.0 / (g * 4 * h4 * w4)
    cpad = F.pad(code, (0, 1, 0, 1), value=255)
    dpad = F.pad(dyf, (0, 1, 0, 1))

    def won(di, dj, m):
        c = cpad[:, :, di:di + h4, dj:dj + w4]
        return torch.where(c == m, dpad[:, :, di:di + h4, dj:dj + w4], 0.0)
    gy_ph = [won(0, 0, 0), won(0, 0, 3) + won(0, 1, 6),
             won(0, 0, 1) + won(1, 0, 2),
             (won(0, 0, 4) + won(0, 1, 7)) + (won(1, 0, 5) + won(1, 1, 8))]
    gy = torch.empty_like(u)
    for ph in range(4):
        gy[:, :, ph >> 1::2, ph & 1::2] = gy_ph[ph]
    bn, xhat = st._bn_parts(u, stats, gamma, beta, g)
    gy = torch.where(bn > 0, gy, torch.zeros_like(gy))
    du = st.round16(st._per_image(gamma * stats[:, :, 1], g)
                    * ((gy - st._per_image(sg * inv_m, g))
                       - xhat * st._per_image(sgx * inv_m, g)))
    # dW: per tile, per row, K-chunks of (phase, 16 columns) of the tile's
    # 31·ncw columns: chunk ck of phases 2q, 2q + 1 goes to warp ck + nchk·q
    # (nchk = 2·ncw chunks, two warps each); f32 sums per warp, row by row
    # and in a row phase by phase, the warps' sums added in order, then the
    # tiles' in order
    nchk = -(-p.cols // 16)
    dw = torch.zeros(24, 27)
    for bi in range(b):
        for i0, rows, c0, cols in _tiles(p, h4, w4):
            acc = torch.zeros(2 * nchk, 24, 27)
            for i in range(i0, i0 + rows):
                for kc in range(4 * nchk):
                    ph, ck = divmod(kc, nchk)
                    lo, hi = c0 + 16 * ck, min(c0 + 16 * ck + 16, c0 + cols)
                    if lo >= hi:
                        continue
                    pix = _patches(imgp[bi:bi + 1], i, 1, lo, hi - lo)[0]
                    pix = pix[ph * (hi - lo):(ph + 1) * (hi - lo)]
                    dus = du[bi, :, 2 * i + (ph >> 1),
                             2 * lo + (ph & 1):2 * hi:2]
                    acc[ck + nchk * (ph // 2)] += dus @ pix
            part = torch.zeros(24, 27)
            for k in range(2 * nchk):
                part = part + acc[k]
            dw = dw + part
    dw = dw.reshape(24, 3, 3, 3).permute(0, 3, 1, 2)       # (ky,kx,c) → OIHW
    return dw.contiguous(), sgx_p.sum(0), sg_p.sum(0)


def _case(case):
    b, hgt, wid, g, tie, signed = case
    x, w_raw, gamma, beta, dy = stem_train_case(sum(case) + 1, b, hgt, wid,
                                                tie, "cpu", signed)
    return (x, (w_raw * (1.0 / 255.0)).contiguous(), gamma, beta,
            hgt // 4, wid // 4, g, dy.to(BF16))


@pytest.mark.parametrize("case", STEP_CASES,
                         ids=["x".join(map(str, c[:4])) + ("t" if c[4] else "")
                              + ("s" if c[5] else "") for c in STEP_CASES])
def test_steps_equal_the_plain_versions(case):
    x, w, gamma, beta, h4, w4, g, dy = _case(case)
    y, stats, zw, code, grads = stem16_train_steps(x, w, gamma, beta, h4, w4,
                                                   g, dy)
    ry, rstats = st.stem_train_forward_reference(x, w, gamma, beta, h4, w4,
                                                 g, True)
    for k in range(3):
        assert _rel(stats[..., k], rstats[..., k]) <= STATS_RTOL, k
    # y, code and zw bit for bit the plain chain with the steps' stats
    u = st._conv(st._image(x, h4, w4, torch.float32), st.round16(w))
    bn, _ = st._bn_parts(u, stats, gamma, beta, g)
    assert torch.equal(y, F.max_pool2d(torch.relu(bn).to(BF16), 3, 2, 1))
    rcode, rzw = st.stem16_winners_reference(u, stats, gamma, beta, g)
    assert torch.equal(code, rcode) and torch.equal(zw, rzw)
    assert ((y.float() - ry.float()).abs().max()
            <= 2 ** -8 * ry.float().abs().max())
    refs = st.stem_train_backward_reference(dy, x, stats, w, gamma, beta,
                                            h4, w4, g, True)
    for name, got, want in zip(("dW", "dgamma", "dbeta"), grads, refs):
        assert _rel(got, want) <= BF16_TRAIN_RTOL, name


def test_steps_see_a_wrong_halo_or_tile():
    """Without the recomputed row above a band, or with a tile table whose
    bands leave a row uncovered, the steps' y leaves the plain version's."""
    x, w, gamma, beta, h4, w4, g, dy = _case(STEP_CASES[0])
    ry, _ = st.stem_train_forward_reference(x, w, gamma, beta, h4, w4, g,
                                            True)
    p = st.stem16_train_plan(x.shape[0], h4, w4, g)
    assert p.bands > 1
    y = stem16_train_steps(x, w, gamma, beta, h4, w4, g, dy, halo=False)[0]
    assert not torch.equal(y, ry)
    short = dataclasses.replace(p, rows=p.rows - 1)
    y = stem16_train_steps(x, w, gamma, beta, h4, w4, g, dy, plan=short)[0]
    assert torch.isnan(y.float()).any()
