"""The bf16 stage kernel of B2 and B9 (`csrc/span_block.cuh`,
`span16_stage_kernel`), on the CPU: its launch plan (`span16_plan`) at
every shape the smoke and the card tests run, and the file's
`span16_stage_steps`, the kernel's indexing in numpy: the slot tables
(`fold.span16_slots`, lmap and its inverse), the B operand read in the
lanes' fragment order, the A rows of each tap (the pixel's address plus a
tap offset in Y with its zero columns, the 16 zero bytes beyond K = 9·mid),
the halo rows traded between the bands of a cluster or recomputed by a
band of its own, and the stride-2 prologue's chunks of input rows.  On
integer-valued inputs and weights every f32 sum is exact in any order, so
the steps are held bit for bit to the plain versions `span_reference_bf16`
and `s2span_reference_bf16` at the three widths and nblk 0-7."""

import dataclasses

import numpy as np
import pytest
import torch

from fastdet_torch.kernels import fold
from fastdet_torch.kernels import fused_infer as fi
from fastdet_torch.kernels.fold import STAGES
from torch_cases import S2SPAN_CASES, SPAN_CASES

BF16 = torch.bfloat16
NBLK = {c: reps - 1 for _, reps, c in STAGES}
STAGE_C = {sid: c for sid, _, c in STAGES}
# stage outputs (c, h) of the smoke's serving sizes, 352² and 640²
SMOKE = [(c, hw) for size in (352, 640)
         for (_, _, c), hw in zip(STAGES, (size // 8, size // 16,
                                           size // 32))]
PLAN_CASES = (
    [(b, c, hw, hw, NBLK[c], s2) for b in (1, 128) for c, hw in SMOKE
     for s2 in (False, True)]
    + [(b, STAGE_C[stage], h, w, NBLK[STAGE_C[stage]], False)
       for b, stage, h, w in SPAN_CASES]
    + [(b, STAGE_C[stage], (hin + 1) // 2, (win + 1) // 2,
        NBLK[STAGE_C[stage]], True) for b, stage, hin, win in S2SPAN_CASES]
    + [(2, 48, 160, 160, 3, False), (2, 48, 160, 160, 3, True)])


def _win(h, w, s2):
    return 2 * w if s2 else 0


@pytest.mark.parametrize("case", PLAN_CASES, ids=[
    f"b{b}-c{c}-{h}x{w}-{'s2' if s2 else 'span'}"
    for b, c, h, w, _, s2 in PLAN_CASES])
def test_plan_fits_the_card(case):
    b, c, h, w, nblk, s2 = case
    win = _win(h, w, s2)
    plan = fi.span16_plan(b, c, h, w, nblk, s2, win)
    mid = c // 2
    assert plan.smem_bytes <= fi.SMEM_PER_CTA == 232448
    assert 1 <= plan.cluster <= 8 and plan.threads == 256
    bands = plan.band_rows(h)
    assert len(bands) == plan.bands and plan.ctas == b * plan.bands
    assert [r0 for r0, _ in bands] == [i * plan.rows
                                      for i in range(plan.bands)]
    assert all(n >= 1 for _, n in bands) and sum(n for _, n in bands) == h
    assert plan.smem_bytes == max(fi.span16_smem(mid, r, w, hl, t, win, o)
                                  for r, hl, t, o in plan.layouts)
    if plan.variant == "stage":
        assert plan.launches == 1 and plan.bands == plan.cluster
        assert plan.halo == (1 if plan.cluster > 1 and nblk else 0)
        assert plan.layouts == ((plan.rows, plan.halo, s2, plan.orows),)
    else:
        # no cluster of 8 holds the stage: a launch a block, each band
        # computing its halo rows' pw1, the stride-2 block alone
        assert plan.cluster == 1 and plan.launches == nblk + int(s2)
        assert plan.halo == (2 if plan.rows < h else 0)
        rows8 = -(-h // 8)
        assert fi.span16_smem(mid, rows8, w, 1, s2, win,
                              max(plan.orows, 1)) > fi.SMEM_PER_CTA
    if s2:
        # the prologue's chunks: one GEMM pass of Wc and Wp each
        assert 1 <= plan.orows <= plan.rows_s2
        assert plan.orows * w <= fi.span16_pass_pixels(mid)


def test_plan_at_352_and_640():
    """One launch a stage call at the served sizes: 3 launches a forward
    for each of span_bf16 and s2span_bf16 at 352² b128 and 640² b32."""
    for b, size in ((128, 352), (32, 640)):
        for s2 in (False, True):
            launches = 0
            for (_, reps, c), hw in zip(STAGES, (size // 8, size // 16,
                                                 size // 32)):
                plan = fi.span16_plan(b, c, hw, hw, reps - 1, s2,
                                      _win(hw, hw, s2))
                assert plan.variant == "stage"
                launches += plan.launches
            assert launches == 3
    # stage 4 at 352²: one CTA an image, one GEMM pass, N split over two
    # warp columns
    plan = fi.span16_plan(128, 192, 11, 11, 3)
    assert plan.cluster == 1 and plan.ctas == 128
    assert fi.span16_pass_pixels(96) == 128 >= 121


def test_slots_relabel_the_shuffle():
    """P_{k+1}[j] = P_k[2j], P_{k+1}[mid + r] = P_k[2r + 1]: the relabel
    of concat[x_even, z] with z_r where x's channel 2r + 1 was."""
    for mid in (24, 48, 96):
        p = fold.span16_slots(mid, 0)
        assert (p == np.arange(2 * mid)).all()
        for k in range(1, 8):
            q = fold.span16_slots(mid, k)
            assert sorted(q) == list(range(2 * mid))
            assert (q[:mid] == p[0::2]).all() and (q[mid:] == p[1::2]).all()
            p = q


# ------------------------------------------------- the kernel's indexing

def _odd16(n):
    return n if (n // 8) % 2 else n + 8


def _bf16(a):
    """f32 (exact) → its bf16 rounding, as f32."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF16).float() \
        .numpy()


def _bits_f32(bits):
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(
        np.float32)


def b_operand(frag, mid, ks):
    """The B operand (16·ks × mid) as the kernel's lanes read it from a
    ring chunk: k-step s, n-tile n, lane (g, t) = (lane / 4, lane % 4),
    its 8 bytes (e = 0..3) → B[16s + 2t + (e & 1) + 8(e >> 1), 8n + g]."""
    nt = mid // 8
    f = _bits_f32(frag).reshape(ks, nt, 32, 4)
    s, n, lane, e = np.meshgrid(np.arange(ks), np.arange(nt),
                                np.arange(32), np.arange(4), indexing="ij")
    b = np.full((16 * ks, mid), np.nan, np.float32)
    b[16 * s + 2 * (lane % 4) + (e & 1) + 8 * (e >> 1), 8 * n + lane // 4] = f
    assert not np.isnan(b).any()
    return b


def tap_rows(buf, base, pitch, mid):
    """A of a composed 3×3 GEMM (TapAddr16): per 8 columns k0 (one lane's
    ldmatrix row) tap t = k0 / mid, channel k0 % mid, the tap's pixel at
    base + (t / 3)·pitch + t % 3; the 16 zero bytes for t ≥ 9."""
    kp = fi._pad16(9 * mid)
    a = np.zeros((len(base), kp), np.float32)
    for k0 in range(0, kp, 8):
        t, ch = divmod(k0, mid)
        if t < 9:
            a[:, k0:k0 + 8] = buf[base + (t // 3) * pitch + t % 3,
                                  ch:ch + 8]
    return a


def _gemm(a, b, bias):
    """bf16(ReLU(a·b + bias)): exact sums of integer values in f64, cast."""
    return _bf16(np.maximum(a.astype(np.float64) @ b + bias, 0.0))


def span16_stage_steps(x, w_span, b_span, nblk, plan, w_s2=None, b_s2=None):
    """One stage call (one launch, or one a block) of the bf16 stage
    kernel, band by band with its shared-memory buffers: x (B, C, h, w)
    (or the stage input (B, mid, hin, win) with w_s2) as f32 bf16 values,
    the weights as uint16 bits (fold.pack_span16, pack_s2_16) → the
    output (B, C, h, w) f32."""
    s2 = w_s2 is not None
    bsz = x.shape[0]
    mid = x.shape[1] if s2 else x.shape[1] // 2
    c = 2 * mid
    hin, win = x.shape[2:]
    h, w = ((hin + 1) // 2, (win + 1) // 2) if s2 else (hin, win)
    if plan.variant == "per_block":
        y = x
        if s2:
            y = _launch(x, w_span, b_span, 0, 0, w_s2, b_s2, mid, h, w,
                        plan.rows_s2, -(-h // plan.rows_s2), 0, plan.orows)
        for k in range(nblk):
            y = _launch(y, w_span[k:], b_span[k:], 1, k, None, None, mid, h,
                        w, plan.rows, plan.bands, plan.halo, 0)
        return y
    return _launch(x, w_span, b_span, nblk, 0, w_s2, b_s2, mid, h, w,
                   plan.rows, plan.bands, plan.halo, plan.orows)


def _launch(x, w_span, b_span, nblk, k0, w_s2, b_s2, mid, h, w, rows, nbands,
            halo, orows):
    c = 2 * mid
    psx, psy = _odd16(c), _odd16(mid)
    kp1, kpc = fi._pad16(mid), fi._pad16(9 * mid)
    pitch = w + 2
    out = np.zeros((x.shape[0], c, h, w), np.float32)
    lmap0 = fold.span16_slots(mid, k0)
    for img in range(x.shape[0]):
        xs, ys, lm = [], [], []
        for band in range(nbands):
            r0 = band * rows
            rv = max(0, min(rows, h - r0))
            xr0 = r0 - (1 if halo == 2 else 0)
            xrows = rv + (2 if halo == 2 else 0)
            xb = np.full(((rows + 2) * w, psx), np.nan, np.float32)
            inv = np.argsort(lmap0)
            if w_s2 is None:
                # staging: slot s of X pixel q ← logical inv[s], 0 off the
                # image
                for q in range(xrows * w):
                    gy = xr0 + q // w
                    xb[q, :c] = (x[img, inv, gy, q % w] if 0 <= gy < h
                                 else 0.0)
            else:
                _prologue(x[img], xb, w_s2, b_s2, mid, r0, rv, w, orows)
            xs.append(xb)
            # Y with its zero rows and columns; NaN where never written
            yb = np.zeros(((rows + 2) * pitch, psy), np.float32)
            yb[:, mid:] = np.nan
            ys.append(yb)
            lm.append(lmap0.copy())
        for k in range(nblk):
            row = np.asarray(w_span[k])
            bias = np.asarray(b_span[k], np.float64)
            b1 = b_operand(row[:c * mid], mid, c // 16)
            bc = b_operand(row[c * mid:], mid, kpc // 16)
            for band in range(nbands):   # 1. pw1 over all C slots → Y
                r0 = band * rows
                rv = max(0, min(rows, h - r0))
                xr0 = r0 - (1 if halo == 2 else 0)
                yrow0 = 0 if halo == 2 else 1
                npx = (rv + (2 if halo == 2 else 0)) * w
                y = _gemm(xs[band][:npx, :c], b1, bias[:mid])
                for q in range(npx):
                    i, col = divmod(q, w)
                    live = 0 <= xr0 + i < h
                    ys[band][(i + yrow0) * pitch + col + 1, :mid] = (
                        y[q] if live else 0.0)
            if halo == 1:                   # 2. the neighbours' edge rows
                for band in range(nbands):
                    r0 = band * rows
                    rv = max(0, min(rows, h - r0))
                    if band > 0:
                        ys[band][:pitch] = ys[band - 1][
                            rows * pitch:(rows + 1) * pitch]
                    if r0 + rv < h:
                        ys[band][(rv + 1) * pitch:(rv + 2) * pitch] = ys[
                            band + 1][pitch:2 * pitch]
            for band in range(nbands):   # 3. z → the slots of pw1's inputs
                r0 = band * rows
                rv = max(0, min(rows, h - r0))
                xoff = w if halo == 2 else 0
                p = np.arange(rv * w)
                base = (p // w) * pitch + p % w
                z = _gemm(tap_rows(ys[band], base, pitch, mid), bc,
                          bias[mid:])
                cur = lm[band]
                for o in range(mid):
                    xs[band][p + xoff, cur[2 * o + 1]] = z[:, o]
                lm[band] = np.concatenate([cur[0::2], cur[1::2]])
        for band in range(nbands):
            r0 = band * rows
            rv = max(0, min(rows, h - r0))
            xoff = w if halo == 2 else 0
            band_x = xs[band][xoff:xoff + rv * w, lm[band]]
            assert not np.isnan(band_x).any()
            out[img, :, r0:r0 + rv] = band_x.T.reshape(c, rv, w)
    return out


def _prologue(x, xb, w_s2, b_s2, mid, r0, rv, w, orows):
    """The stride-2 block into the band's slots (proj j in slot j, main
    in mid + j), over chunks of orows output rows: XI the 2·orc + 1 input
    rows with a zero column each side, pw1 into YI (0 off the image), Wp over XI's and Wc over YI's stride-2
    taps."""
    hin, win = x.shape[1:]
    kp1, kpc = fi._pad16(mid), fi._pad16(9 * mid)
    pitch = win + 2
    w_s2 = np.asarray(w_s2)
    bias = np.asarray(b_s2, np.float64)
    b1 = b_operand(w_s2[:kp1 * mid], mid, kp1 // 16)
    bc = b_operand(w_s2[kp1 * mid:(kp1 + kpc) * mid], mid, kpc // 16)
    bp = b_operand(w_s2[(kp1 + kpc) * mid:], mid, kpc // 16)
    for ro0 in range(r0, r0 + rv, orows):
        orc = min(orows, r0 + rv - ro0)
        iy0 = 2 * ro0 - 1
        npi = (2 * orc + 1) * pitch
        xi = np.zeros((npi, _odd16(mid)), np.float32)
        xi[:, mid:] = np.nan
        live = np.zeros(npi, bool)
        for q in range(npi):
            lr, pc = divmod(q, pitch)
            iy, ix = iy0 + lr, pc - 1
            if 0 <= iy < hin and 0 <= ix < win:
                xi[q, :mid] = x[:, iy, ix]
                live[q] = True
        # pw1's A: the pixel's channels, the 16 zero bytes beyond mid
        a = np.zeros((npi, kp1), np.float32)
        a[:, :mid] = xi[:, :mid]
        yi = np.where(live[:, None], _gemm(a, b1, bias[:mid]), 0.0)
        p = np.arange(orc * w)
        base = 2 * (p // w) * pitch + 2 * (p % w)
        dst = (ro0 - r0) * w + p
        xb[dst, :mid] = _gemm(tap_rows(xi, base, pitch, mid), bp,
                              bias[2 * mid:])
        xb[dst, mid:2 * mid] = _gemm(tap_rows(yi, base, pitch, mid), bc,
                                     bias[mid:2 * mid])


def _ints(rng, shape, lo, hi, density=1.0):
    a = rng.integers(lo, hi + 1, shape).astype(np.float32)
    return a * (rng.random(shape) < density)


def _sparse_rows(rng, n, k, nnz, cols=None):
    """(n, k) with nnz entries ±1 a row (among `cols`)."""
    a = np.zeros((n, k), np.float32)
    cols = np.arange(k) if cols is None else cols
    for i in range(n):
        a[i, rng.choice(cols, nnz, replace=False)] = rng.choice([-1.0, 1.0],
                                                                nnz)
    return a


def int_span_weights(mid, nblk, seed):
    """Integer-valued composed blocks packed as `fold.pack_span16` packs
    them: pw1 two ±1 a row on the odd channels (the composed `wa`'s top
    half, 0 on the even), Wc four ±1 a row, biases in {-1, 0}; the values
    grow at most 8× a block, every f32 sum exact."""
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for k in range(nblk):
        wa = _sparse_rows(rng, mid, 2 * mid, 2, np.arange(1, 2 * mid, 2))
        wc = _sparse_rows(rng, mid, 9 * mid, 4)
        ws.append(fold.span16_row(wa, wc, k))
        bs.append(_ints(rng, 2 * mid, -1, 0))
    return np.stack(ws).reshape(nblk, -1), np.stack(bs).reshape(nblk, -1)


def int_s2_weights(mid, seed):
    rng = np.random.default_rng(seed)
    mats = (_sparse_rows(rng, mid, mid, 2), _sparse_rows(rng, mid, 9 * mid, 4),
            _sparse_rows(rng, mid, 9 * mid, 4))
    w = np.concatenate([fold.mma_fragments(fold.to_bf16_bits(m))
                        for m in mats])
    return w, _ints(rng, 3 * mid, -1, 0)


def _torch16(bits):
    return fi.bf16_from_bits(np.asarray(bits, np.uint16))


def _plans(b, c, h, w, nblk, s2, win):
    """The plan's own launch, and forced ones: a cluster of 2 and 3 bands
    (halo rows traded), one a block (halo rows recomputed), small
    prologue chunks."""
    plan = fi.span16_plan(b, c, h, w, nblk, s2, win)
    out = [plan]
    for n in (2, 3):
        rows = -(-h // n)
        if (n - 1) * rows < h:
            out.append(dataclasses.replace(
                plan, variant="stage", cluster=n, bands=n, rows=rows,
                halo=1 if nblk else 0, orows=min(2, rows)))
    rows = max(1, h // 3)
    out.append(dataclasses.replace(
        plan, variant="per_block", cluster=1, rows=rows, rows_s2=rows,
        bands=-(-h // rows), halo=2 if rows < h else 0, orows=1))
    return out


@pytest.mark.parametrize("c", [48, 96, 192])
@pytest.mark.parametrize("nblk", range(1, 8))
def test_span_steps_equal_the_plain_version(c, nblk):
    """The stride-1 span at 7×5 (odd rows and columns), every variant."""
    mid = c // 2
    h, w = 7, 5
    rng = np.random.default_rng(c + nblk)
    x = _ints(rng, (2, c, h, w), 0, 3)
    wbits, bias = int_span_weights(mid, nblk, c * 10 + nblk)
    want = fi.span_reference_bf16(
        torch.from_numpy(x).to(BF16), _torch16(wbits),
        torch.from_numpy(bias), nblk).float().numpy()
    for plan in _plans(2, c, h, w, nblk, False, 0):
        got = span16_stage_steps(x, wbits, bias, nblk, plan)
        np.testing.assert_array_equal(got, want, err_msg=str(plan))


@pytest.mark.parametrize("c", [48, 96, 192])
@pytest.mark.parametrize("nblk", range(0, 8))
def test_s2span_steps_equal_the_plain_version(c, nblk):
    """The stride-2 block (input 13×9: odd, the last output column's
    right tap on the zero column) and nblk span blocks, every variant."""
    mid = c // 2
    hin, win = 13, 9
    h, w = 7, 5
    rng = np.random.default_rng(c * 3 + nblk)
    x = _ints(rng, (2, mid, hin, win), 0, 3)
    wbits, bias = int_span_weights(mid, max(nblk, 1), c * 7 + nblk)
    wbits, bias = wbits[:nblk], bias[:nblk]
    w2, b2 = int_s2_weights(mid, c + 100 * nblk)
    want = fi.s2span_reference_bf16(
        torch.from_numpy(x).to(BF16), _torch16(w2), torch.from_numpy(b2),
        _torch16(wbits), torch.from_numpy(bias), nblk).float().numpy()
    for plan in _plans(2, c, h, w, nblk, True, win):
        got = span16_stage_steps(x, wbits, bias, nblk, plan, w2, b2)
        np.testing.assert_array_equal(got, want, err_msg=str(plan))


def test_steps_see_a_wrong_slot_table():
    """The steps are not blind to the shuffle: block 1's pw1 packed with
    block 0's slots gives another output."""
    mid, nblk = 24, 2
    rng = np.random.default_rng(3)
    x = _ints(rng, (1, 2 * mid, 4, 6), 0, 3)
    wbits, bias = int_span_weights(mid, nblk, 5)
    wa, wc = fold.unpack_span16(wbits[1], mid, 1)
    bad = wbits.copy()
    bad[1] = fold.span16_row(_bits_f32(wa), _bits_f32(wc), 0)
    plan = fi.span16_plan(1, 2 * mid, 4, 6, nblk)
    good = span16_stage_steps(x, wbits, bias, nblk, plan)
    assert not np.array_equal(span16_stage_steps(x, bad, bias, nblk, plan),
                              good)
