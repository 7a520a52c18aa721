"""The stage kernel of B2 and B9 (`csrc/span_block.cuh`), on the CPU: its
launch plan (`span_stage_plan`) at every shape the smoke and the card
tests run, and its in-place decomposition of the span (the slot
relabelling of `span_slot_tables`), held bitwise to `span_reference`."""

import numpy as np
import pytest
import torch

from fastdet_torch.kernels import fused_infer as fi
from fastdet_torch.kernels.fold import STAGES
from torch_cases import S2SPAN_CASES

NBLK = {c: reps - 1 for _, reps, c in STAGES}
# stage outputs (c, h) of the smoke's serving sizes, 352² and 640²
SMOKE = [(c, hw) for size in (352, 640)
         for (_, _, c), hw in zip(STAGES, (size // 8, size // 16,
                                           size // 32))]
CASES = ([(b, c, hw, hw, NBLK[c], s2) for b in (1, 128) for c, hw in SMOKE
          for s2 in (False, True)]
         + [(b, 48 << (stage - 2), (hin + 1) // 2, (win + 1) // 2,
             NBLK[48 << (stage - 2)], True)
            for b, stage, hin, win in S2SPAN_CASES])


@pytest.mark.parametrize("case", CASES, ids=[
    f"b{b}-c{c}-{h}x{w}-{'s2' if s2 else 'span'}"
    for b, c, h, w, _, s2 in CASES])
def test_plan_fits_the_card(case):
    b, c, h, w, nblk, s2 = case
    plan = fi.span_stage_plan(b, c, h, w, nblk, s2)
    assert plan.smem_bytes <= fi.SMEM_PER_CTA == 227 * 1024
    assert 1 <= plan.cluster <= 8 and plan.threads == 384
    # the bands cover each image once, none empty
    bands = plan.band_rows(h)
    assert len(bands) == plan.bands and plan.ctas == b * plan.bands
    assert [r0 for r0, _ in bands] == [i * plan.rows
                                      for i in range(plan.bands)]
    assert all(n >= 1 for _, n in bands) and sum(n for _, n in bands) == h
    mid = c // 2
    if plan.variant == "stage":
        # one launch; the depthwise halo rows are the neighbours' edge rows
        assert plan.launches == 1 and plan.bands == plan.cluster
        assert plan.halo == (1 if plan.cluster > 1 and nblk else 0)
        for i, (r0, n) in enumerate(bands[1:], 1):
            assert bands[i - 1] == (r0 - plan.rows, plan.rows)
        assert plan.layouts == ((plan.rows, plan.halo, s2),)
    else:
        # one launch per block, each band computing its halo rows' pw1;
        # the stride-2 block alone in a launch of its own bands
        assert plan.cluster == 1
        assert plan.launches == nblk + int(s2)
        assert plan.halo == (2 if plan.rows < h else 0)
        assert plan.layouts == ((plan.rows, plan.halo, False),) + (
            ((plan.rows_s2, 0, True),) if s2 else ())
    assert plan.smem_bytes == max(fi.span_stage_smem(mid, r, w, halo, t)
                                  for r, halo, t in plan.layouts)


def test_plan_at_352():
    """b128 352²: clusters of 4 / 2 / 1 CTAs of 11 rows, one launch per
    stage call for B2 and for B9, each CTA alone on its SM."""
    for s2 in (False, True):
        plans = [fi.span_stage_plan(128, c, hw, hw, NBLK[c], s2)
                 for (_, _, c), hw in zip(STAGES, (44, 22, 11))]
        assert [p.variant for p in plans] == ["stage"] * 3
        assert [(p.cluster, p.rows, p.launches) for p in plans] == [
            (4, 11, 1), (2, 11, 1), (1, 11, 1)]
        assert [p.ctas for p in plans] == [512, 256, 128]
        assert all(fi.SMEM_PER_CTA // 2 < p.smem_bytes <= fi.SMEM_PER_CTA
                   for p in plans)


def test_plan_at_640():
    """640²: 80² × 48 does not fit a cluster of 8 and takes one launch per
    block (bands of 8 rows); 40² and 20² spans fit clusters of 8 and 4.
    B9 takes one launch per block at every 640² stage."""
    span = [fi.span_stage_plan(32, c, hw, hw, NBLK[c])
            for (_, _, c), hw in zip(STAGES, (80, 40, 20))]
    assert [(p.variant, p.cluster, p.rows, p.launches) for p in span] == [
        ("per_block", 1, 8, 3), ("stage", 8, 5, 1), ("stage", 4, 5, 1)]
    s2 = [fi.span_stage_plan(32, c, hw, hw, NBLK[c], True)
          for (_, _, c), hw in zip(STAGES, (80, 40, 20))]
    assert [p.variant for p in s2] == ["per_block"] * 3
    assert [p.launches for p in s2] == [4, 8, 4]


def test_smem_follows_the_layout():
    """The slot planes, the halo buffers and the weights region of
    `stage_layout`: at 352² stage 4 the stride-2 block's chunk buffers
    (X in the free slots, Y after w1) outgrow a block's weights."""
    mid, rows, w = 96, 11, 11
    ps, xs = 124, 120
    assert fi.span_stage_smem(mid, rows, w, 0, False) == 4 * (
        3 * mid * ps + 2 * mid * mid + 12 * mid + 7 * mid)
    assert fi.span_stage_smem(mid, rows, w, 0, True) == 4 * (
        3 * mid * ps + mid * mid + mid + mid * xs + 7 * mid)
    hs = 24
    assert (fi.span_stage_smem(mid, rows, w, 2, False)
            - fi.span_stage_smem(mid, rows, w, 1, False)
            == fi.span_stage_smem(mid, rows, w, 1, False)
            - fi.span_stage_smem(mid, rows, w, 0, False) == 4 * mid * hs)


@pytest.mark.parametrize("stride2", [False, True])
@pytest.mark.parametrize("mid", [24, 48, 96])
def test_slot_tables_relabel(mid, stride2):
    """Every block reads mid odd slots and writes mid scratch slots,
    disjoint, beside the mid passthrough slots; the passthrough half
    keeps its slots (nothing moves); the last map is 2·mid distinct
    slots of the 3·mid."""
    nblk = 7
    blocks, lmap = fi.span_slot_tables(mid, nblk, stride2)
    prev = (list(range(2 * mid, 3 * mid)) + list(range(mid, 2 * mid))
            if stride2 else list(range(2 * mid)))
    for odd, scratch in blocks:
        keep = [prev[2 * j] for j in range(mid)]
        assert odd == [prev[2 * j + 1] for j in range(mid)]
        assert sorted(keep + odd + scratch) == list(range(3 * mid))
        prev = keep + scratch
    assert lmap == prev and len(set(lmap)) == 2 * mid


@pytest.mark.parametrize("nblk", range(1, 8))
@pytest.mark.parametrize("c", [48, 96, 192])
def test_slot_decomposition_is_bitwise(c, nblk):
    """pw1 into the scratch, dw back into the odd slots, pw2 into the
    scratch, relabel: the same function as `span_reference`, bit for
    bit, on seeded activations and weights (a partial band's shape)."""
    mid = c // 2
    rng = np.random.default_rng(c * 10 + nblk)
    x = torch.from_numpy(np.abs(rng.normal(
        0.0, 1.0, (2, c, 7, 5))).astype(np.float32))
    weights = torch.from_numpy(rng.normal(
        0.0, 0.2, (nblk, 2 * mid * mid + 12 * mid)).astype(np.float32))
    want = fi.span_reference(x, weights, nblk)
    got = fi.span_slots_reference(x, weights, nblk)
    assert torch.equal(got, want)
