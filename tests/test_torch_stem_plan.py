"""The training stem B7's launch plan and the identities its design rests
on (fastdet_torch/kernels/stem_train.py), on the CPU.

The plan (`stem_train_plan`): at every shape the card tests and the smoke
run, each sweep fits the card's shared memory, the tiles cover each image
once (so a ghost group is whole tiles), the b128 grids fill the 132 SMs,
and a call launches at most 3 kernels forward and 4 backward, sweeping the
conv at most 1.3 times forward and 1.6 times backward.

The identities, with the plain versions: (1) the pool before BN: BN and
ReLU of the pooled raw conv (its max where γ ≥ 0, its min where γ < 0)
are the forward's y bit for bit; (2) the backward's BN sums from (dy, z)
are the routed ones within the gradient bound on every channel with
γ ≠ 0, and where γ = 0 only the routed gradient gives dγ, which the
kernel's decomposition takes.  Inputs: γ of both signs with one 0, the
flat-block tie images, and the real stem weights of
weights/coco2017-ref.npz.
"""

import os

import pytest
import torch
import torch.nn.functional as F

from fastdet_torch.io import load_state_dict
from fastdet_torch.kernels import stem_train as st
from torch_cases import (STEM_TRAIN_CASES, STEM_ZERO_GAMMA, grad_err,
                         stem_train_case)

SMS = 132
REF_NPZ = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "weights", "coco2017-ref.npz")
# (b, h4, w4, g): every B7 shape of the card tests and smoke 8c, and the
# smoke's grouped main path (b128 352² at ghost group 16)
PLAN_SHAPES = sorted({(b, h // 4, w // 4, g)
                      for b, h, w, g, _, _ in STEM_TRAIN_CASES}
                     | {(128, 88, 88, 16)})


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=["x".join(map(str, s)) for s in PLAN_SHAPES])
def test_plan_fits_the_card(shape):
    b, h4, w4, g = shape
    plan = st.stem_train_plan(b, h4, w4, g)
    assert max(plan.smem_by_kernel.values()) <= st.SMEM_PER_CTA == 232_448
    # forward tiles: row bands of whole warps of 31 cell columns
    tr, cw = plan.tile_fwd
    assert 1 <= tr <= st.FWD_ROWS and cw % st.FWD_WARP_COLS == 0
    assert plan.threads_fwd == 128 * (cw // st.FWD_WARP_COLS) <= 384
    assert plan.ctas_fwd == b * -(-h4 // tr) * -(-w4 // cw)
    assert (-(-h4 // tr) - 1) * tr < h4 and (-(-w4 // cw) - 1) * cw < w4
    # backward: one CTA per band of 8×8-cell tiles
    assert plan.tile_bwd == (8, 8)
    assert plan.ctas_bwd == b * -(-h4 // 8)
    if b == 128:
        assert min(plan.ctas_fwd, plan.ctas_bwd) >= SMS
    assert plan.launches_fwd <= 3 and plan.launches_bwd <= 4
    assert 1.0 <= plan.sweeps_fwd <= 1.3
    assert 1.0 <= plan.sweeps_bwd <= 1.6


def test_plan_at_352():
    """b128 352²: forward bands of 11 cell rows and 3 warps (93 columns
    for 88) per channel group, 8 × 128 CTAs of 384 threads, 1.063 conv
    sweeps; backward 11 bands of 8×8 tiles, 11 × 128 CTAs, 1.117 sweeps;
    3 launches each way; two sweeps' CTAs fit an SM's 228 KB of shared
    memory."""
    plan = st.stem_train_plan(128, 88, 88, 1)
    assert plan.tile_fwd == (11, 93) and plan.ctas_fwd == 1024
    assert plan.threads_fwd == 384 and plan.ctas_bwd == 1408
    assert (plan.launches_fwd, plan.launches_bwd) == (3, 3)
    assert round(plan.sweeps_fwd, 3) == 1.063
    assert round(plan.sweeps_bwd, 3) == 1.117
    assert plan.smem_by_kernel == {"stem_fwd_sweep_kernel": 61_152,
                                   "stem_bwd_sweep_kernel": 103_488}
    assert all(2 * (v + 1024) <= 233_472
               for v in plan.smem_by_kernel.values())
    assert plan == st.stem_train_plan(128, 88, 88, 16)


def test_halo_is_what_the_routing_reads():
    """A backward tile owns its 8×8 windows; the conv outputs their
    routing reads, in the tile's 9×9-cell region (row and column 0 are the
    cells above and to the left), are the tile's 64 cells, all four
    phases, and the 33 halo outputs: phases py = 1 of the row above (the
    windows' row 2i−1), px = 1 of the column to the left (their column
    2j−1) and the corner (1, 1)."""
    halo = st._bwd_halo()
    assert len(halo) == len(set(halo)) == st.BWD_HALO == 33
    reads = set()
    for r in range(8):
        for c in range(8):
            for px in (0, 1):
                reads |= {(r + 1, c + 1, px), (r + 1, c + 1, 2 + px),
                          (r, c + 1, 2 + px)}
            reads |= {(r + 1, c, 1), (r + 1, c, 3), (r, c, 3)}
    ring = {(r, c, p) for r, c, p in reads if r == 0 or c == 0}
    assert ring == set(halo)
    assert reads - ring == {(r, c, p) for r in range(1, 9)
                            for c in range(1, 9) for p in range(4)}


def _signed_case(seed, b, hgt, wid, tie):
    x, w_raw, gamma, beta, dy = stem_train_case(seed, b, hgt, wid, tie,
                                                signed=True)
    return x, (w_raw / 255.0).contiguous(), gamma, beta, dy


def _real_case(seed, b, hgt, wid):
    """The reference weights' stem (γ of the real model: one channel at
    1.29e-6) on seeded tie images."""
    sd = load_state_dict(REF_NPZ)
    x, _, _, _, dy = stem_train_case(seed, b, hgt, wid, tie=True)
    w = (sd["backbone.first_conv.conv.weight"] / 255.0).contiguous()
    return (x, w, sd["backbone.first_conv.bn.weight"],
            sd["backbone.first_conv.bn.bias"], dy)


# (name, b, H, W, g): γ of both signs and a 0 on tie images, grouped; the
# same on noise at 160×96; the real weights on tie images
IDENTITY_CASES = {"signed_ties_g2": (4, 96, 96, 2),
                  "signed_160x96_g1": (2, 160, 96, 1),
                  "real_ties_g1": (2, 96, 96, 1)}


def _inputs(name):
    b, hgt, wid, g = IDENTITY_CASES[name]
    seed = b + hgt + wid + g
    if name.startswith("real"):
        return _real_case(seed, b, hgt, wid) + (hgt // 4, wid // 4, g)
    return (_signed_case(seed, b, hgt, wid, "ties" in name)
            + (hgt // 4, wid // 4, g))


def _routed(x, w, stats, gamma, beta, dy, h4, w4, g):
    """The plain backward's routed gy (ReLU mask applied) and x̂ at every
    conv output, and its per-group sums Sg, Sgx."""
    b = x.shape[0]
    u = st._conv(st._image(x, h4, w4, w.dtype), w)
    bn, xhat = st._bn_parts(u, stats, gamma, beta, g)
    gy = st._route(torch.relu(bn), dy)
    gy = torch.where(bn > 0, gy, torch.zeros_like(gy))
    return (gy, xhat, gy.reshape(b // g, g, 24, -1).sum((1, 3)),
            (gy * xhat).reshape(b // g, g, 24, -1).sum((1, 3)))


@pytest.mark.parametrize("name", list(IDENTITY_CASES))
def test_pool_before_bn_is_bitwise(name):
    """y = ReLU(BN(z)) with z the pooled raw extreme, bit for bit, with
    the plain forward's stats and with perturbed ones (the identity holds
    for any stats)."""
    x, w, gamma, beta, _, h4, w4, g = _inputs(name)
    y, stats = st.stem_train_forward_reference(x, w, gamma, beta, h4, w4, g)
    z = st.stem_train_pooled_reference(x, w, gamma, h4, w4)
    assert z.shape == y.shape
    assert torch.equal(st.stem_train_emit_reference(z, stats, gamma, beta,
                                                    g), y)
    other = stats.clone()
    other[:, :, 0] += 0.37 * stats[:, :, 2].sqrt()
    other[:, :, 1] *= 1.9
    u = st._conv(st._image(x, h4, w4, w.dtype), w)
    bn, _ = st._bn_parts(u, other, gamma, beta, g)
    assert torch.equal(st.stem_train_emit_reference(z, other, gamma, beta, g),
                       F.max_pool2d(torch.relu(bn), 3, 2, 1))
    if (gamma < 0).any():
        # a min-pool channel: z differs from the max-pool there
        neg = gamma < 0
        assert not torch.equal(z[:, neg], F.max_pool2d(u, 3, 2, 1)[:, neg])


@pytest.mark.parametrize("name", list(IDENTITY_CASES))
def test_bn_sums_from_dy_and_z(name):
    """Sg and Sgx from (dy, z) against the routed sums: within the
    gradient bound 1e-4·max|ref| + 1e-4 on every channel whose σinv·γ is
    not 0."""
    x, w, gamma, beta, dy, h4, w4, g = _inputs(name)
    _, stats = st.stem_train_forward_reference(x, w, gamma, beta, h4, w4, g)
    z = st.stem_train_pooled_reference(x, w, gamma, h4, w4)
    sg, sgx = st.stem_train_sums_reference(dy, z, stats, gamma, beta, g)
    _, _, rsg, rsgx = _routed(x, w, stats, gamma, beta, dy, h4, w4, g)
    live = (stats[:, :, 1] * gamma) != 0
    assert live.sum() >= live.numel() - live.shape[0]
    for got, want in ((sg, rsg), (sgx, rsgx)):
        err, bound = grad_err(got[live], want[live])
        assert err <= bound, (err, bound)


def test_zero_gamma_takes_the_routed_sums():
    """γ = 0 on one channel: BN is constant there, every window member
    ties, and Sgx from z is not the routed one (off by more than the
    bound); the kernel's decomposition (du from the sums of (dy, z), dγ
    and dβ from the routed gy) gives the plain backward's dW, dγ, dβ within
    the bound, and dγ from z's sums would not."""
    x, w, gamma, beta, dy, h4, w4, g = _inputs("signed_ties_g2")
    o = STEM_ZERO_GAMMA
    assert gamma[o] == 0
    _, stats = st.stem_train_forward_reference(x, w, gamma, beta, h4, w4, g)
    z = st.stem_train_pooled_reference(x, w, gamma, h4, w4)
    sg, sgx = st.stem_train_sums_reference(dy, z, stats, gamma, beta, g)
    gy, xhat, rsg, rsgx = _routed(x, w, stats, gamma, beta, dy, h4, w4, g)
    err, bound = grad_err(sgx[:, o].sum(0), rsgx[:, o].sum(0),
                          float(rsgx.sum(0).abs().max()))
    assert err > bound
    # the kernel's decomposition, in plain ops
    inv_m = 1.0 / (g * 4 * h4 * w4)
    du = (st._per_image(gamma * stats[:, :, 1], g)
          * ((gy - st._per_image(sg * inv_m, g))
             - xhat * st._per_image(sgx * inv_m, g)))
    imgp = st._image(x, h4, w4, w.dtype)
    dw = torch.stack([torch.stack([torch.stack([
        (du * st._tap(imgp, c, ky, kx)[:, None]).sum((0, 2, 3))
        for kx in range(3)], -1) for ky in range(3)], -2)
        for c in range(3)], 1)
    ref = st.stem_train_backward_reference(dy, x, stats, w, gamma, beta, h4,
                                           w4, g)
    for got, want in zip((dw, rsgx.sum(0), rsg.sum(0)), ref):
        e, lim = grad_err(got, want)
        assert e <= lim, (e, lim)
    e, lim = grad_err(sgx.sum(0), ref[1])
    assert e > lim
