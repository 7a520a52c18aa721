"""The launch plan of the training span B8 (`span_train_plan` in
fastdet_torch/kernels/fused_train.py), on the CPU: at every shape the
card tests and the smoke run, each CTA fits the card's shared memory, no
cluster exceeds the portable 8, the weight-gradient grid fills the 132
SMs at b128, and a stage call launches at most half of what the first
CUDA version did (forward 7·nblk + 1, backward 14·nblk + 2)."""

import pytest

from fastdet_torch.kernels import fused_train as ft
from torch_cases import (SPAN_TRAIN_B1, SPAN_TRAIN_EDGE, SPAN_TRAIN_FULL,
                         SPAN_TRAIN_SMALL)

SMS = 132
CASES = SPAN_TRAIN_FULL + SPAN_TRAIN_B1 + SPAN_TRAIN_SMALL + SPAN_TRAIN_EDGE


@pytest.mark.parametrize("case", CASES, ids=[
    "x".join(map(str, c)) for c in CASES])
def test_plan_fits_the_card(case):
    b, c, h, w, nblk, g = case
    plan = ft.span_train_plan(b, c, h, w, nblk, g)
    for (tr, tc), n, pixels, ctas in (
            (plan.tile_fwd, plan.pixels_per_cta[0], ft.FWD_TILE_PIXELS,
             plan.ctas_fwd),
            (plan.tile_bwd, plan.pixels_per_cta[1], ft.TILE_PIXELS,
             plan.ctas_bwd)):
        assert 1 <= tr <= h and 1 <= tc <= w
        assert n == tr * tc <= max(pixels[c // 2], ft.TILE_COLS)
        # the tiles cover each image once, so a ghost group is whole tiles
        assert ctas == b * -(-h // tr) * -(-w // tc)
    assert plan.smem_bytes == max(plan.smem_of(False), plan.smem_of(True))
    assert plan.smem_bytes <= ft.SMEM_PER_CTA == 227 * 1024
    assert plan.cluster <= 8
    assert plan.dw_grid == plan.ctas_bwd
    if b == 128:
        assert plan.dw_grid >= SMS
    assert 2 * plan.launches_fwd <= 7 * nblk + 1
    assert 2 * plan.launches_bwd <= 14 * nblk + 2


def test_plan_at_352():
    """The three stages of the b128 352² training step: forward tiles of
    11×44, 11×22 and 11×11 pixels (one wave of CTAs at stages 3 and 4),
    backward tiles of 4×44, 6×22 and 6×11 with two or more CTAs per SM,
    and the launches per stage call (forward 10 / 22 / 10, backward 16 /
    36 / 16)."""
    plans = [ft.span_train_plan(*case) for case in SPAN_TRAIN_FULL]
    assert [p.tile_fwd for p in plans] == [(11, 44), (11, 22), (11, 11)]
    assert [p.tile_bwd for p in plans] == [(4, 44), (6, 22), (6, 11)]
    assert [p.ctas_fwd for p in plans] == [512, 256, 128]
    assert [p.ctas_bwd for p in plans] == [1408, 512, 256]
    assert all(ft.SMEM_PER_SM // (p.smem_of(True) + 1024) >= 2
               for p in plans)
    assert [(p.launches_fwd, p.launches_bwd) for p in plans] == [
        (10, 16), (22, 36), (10, 16)]


def test_smem_follows_the_tile():
    """Shared memory grows with the tile: the stage-4 backward's largest
    kernel (the recompute: w2, the taps, its constants, the haloed tile
    and the tile) at 6×11 pixels, and a tile wider than the plan allows
    does not fit."""
    mid = 96
    floats = ft._smem_floats(mid, 6, 11)
    assert floats["rec"] == (mid * mid + 9 * mid + 18 * mid + mid * 105
                             + mid * 67)
    assert 4 * max(ft._smem_floats(mid, 16, 64).values()) > ft.SMEM_PER_CTA
