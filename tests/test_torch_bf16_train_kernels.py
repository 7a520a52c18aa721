"""The bf16 forms of the training kernels B8 and B7
(fastdet_torch/kernels/fused_train.py, stem_train.py): their plain bf16
versions against the JAX package's `make_span_train` / `make_stem_train`
at dtype=bfloat16 in interpret mode, on the CPU, on the same bf16 inputs
(made from seeds with numpy).

Tolerances, and why:
  * B8 forward, one block: out within two bf16 ULPs (a ULP taken at
    ≥ 2⁻¹⁰, as tests/test_torch_bf16_kernels.py takes it) and ≥ 99% of
    the elements equal: bf16 × bf16 products are exact in f32, so the two
    sides differ only in the order of f32 sums, which flips a rounding of
    y, v or z now and then, and z rounds after y and v.  Multi-block
    spans (3 and 7 blocks): within 2⁻⁶ of max |out|, a flip growing
    through the blocks.  The first block's statistics within 5e-5 of
    the largest: the asked 1e-5 does not hold at c192 (1.54e-5), f32 sums
    of a group's 84 samples in another order.
  * B8 backward, given the same dy: dx and every weight cotangent within
    2⁻⁶ of its max |value| + 1e-6 (β2's cotangent is 0 in exact
    arithmetic, so both sides hold rounding noise there; the floor
    covers it).  For multi-block spans the port's backward takes JAX's
    own saved block inputs and statistics: from its own forward, a
    rounding of z that one side flips changes a ReLU mask downstream,
    and one pixel's mask moves a block's weight gradient by ~10% at
    these 20-121 pixel images (a 3-block c192 span at 11×11 read dx 6-14%
    of max |dx| apart, the same span from JAX's saved inputs 0.6-3%).
  * B7 forward: y within one bf16 ULP (at ≥ 2⁻¹⁰), ≥ 99% equal; μ and
    σinv within 5e-5 relative of the largest, as B8's statistics (f32
    sums of a group's 4·h4·w4·g conv outputs in another order).  The variance formula differs on purpose: JAX's
    stem takes max(E[u²] − μ², 0) in f32, the port the two-pass
    mean((u − μ)²) (ROADMAP §C), so var is held to 1e-4 relative, the
    one-pass form's cancellation at these means.
  * B7 backward: dW, dγ, dβ within 2⁻⁶ of max |value|.
  * B7 route: on a tie image (smooth ramps and flat blocks, the weight one
    tap per channel so that the conv output is exact on both sides, γ = 1
    so that JAX's backward recomputes the forward's rounded yb) with
    JAX's own statistics fed to the port's backward, the rounded yb are
    the same bits on both sides and positive ties are many; there the
    gradients must agree to 1e-5 relative (they read ~3e-7; routed by
    `max_pool2d`'s order instead, dW reads 0.28).

JAX's jitted bf16 graphs with a weight gradient stop on the CPU at a
BF16 × BF16 → F32 dot ("Unsupported element type for DotThunk"), so the
JAX sides here run eagerly (jax.vjp), as the kernels' own interpret mode
does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet.kernels import fused_train as jft
from fastdet.kernels import stem_train as jst
from fastdet.kernels.fused_infer import pack_images_s2d
from fastdet_torch.kernels import fused_train as ft
from fastdet_torch.kernels import stem_train as st
from test_fused_train import _mk_params, _pack_ws, _pack_x, _unpack_x
from test_torch_train_span import _nchw, _rows
from torch_cases import stem_train_case

BF = jnp.bfloat16
T16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """torch on two threads while this file runs (the suite runs in
    parallel workers; a full-width OpenMP pool oversubscribes the CPU for
    every other test), the worker's own count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ulps(got, want):
    """|Δ| in bf16 ULPs of the reference, the ULP taken at ≥ 2⁻¹⁰."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ulp = np.maximum(np.abs(want), 2.0 ** -10) * 2.0 ** -7
    return np.abs(got - want) / ulp


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ------------------------------------------------------------------ B8

# (b, h, w, c, nblk, group): h·w < 128 lanes everywhere (pad lanes)
SPANS = {"c48_g4": (4, 6, 7, 48, 1, 4), "c48_g2": (4, 6, 7, 48, 1, 2),
         "c96_g1": (2, 6, 7, 96, 1, 1), "c192_g2": (2, 3, 5, 192, 1, 2),
         "c48_3blk_g1": (2, 6, 7, 48, 3, 1),
         "c96_7blk_g2": (2, 4, 5, 96, 7, 2),
         "c192_3blk_g2": (2, 6, 7, 192, 3, 2)}


def _jax_span16(geom, seed=0):
    """JAX's bf16 span on seeded inputs: (x, params, dy, out, stats, dx,
    d params, JAX's saved block inputs in the port's (nblk, B, C, h, w)
    layout)."""
    b, h, w, c, nblk, g = geom
    mid, hw = c // 2, h * w
    nimg = (hw + 127) // 128 * 128
    rng = np.random.RandomState(seed)
    x = jnp.asarray(rng.randn(b, h, w, c).astype(np.float32)).astype(BF)
    ps = _mk_params(rng, mid, nblk)
    dy = jnp.asarray(rng.randn(b, h, w, c).astype(np.float32)).astype(BF)
    span = jft.make_span_train(nblk, h, w, nimg, c, g, dtype=BF,
                               interpret=True)
    xt = _pack_x(x, b, hw, c, nimg, g)
    (out_t, stats), vjp = jax.vjp(lambda xt, ps: span(xt, _pack_ws(ps, c)),
                                  xt, ps)
    dxt, dps = vjp((_pack_x(dy, b, hw, c, nimg, g), jnp.zeros_like(stats)))
    flat = [a for blk in _pack_ws(ps, c) for a in blk]
    xsave_t = jft._fwd_call(xt, flat, nblk, h, w, nimg, c, g * hw, BF,
                            True)[1]
    xsave = np.stack([_f32(_unpack_x(xsave_t[:, i], b, h, w, c, nimg, g))
                      for i in range(nblk)]).transpose(0, 1, 4, 2, 3)
    return (x, ps, dy, _unpack_x(out_t, b, h, w, c, nimg, g), stats,
            _unpack_x(dxt, b, h, w, c, nimg, g), dps,
            torch.from_numpy(np.ascontiguousarray(xsave)).to(T16))


@pytest.mark.parametrize("case", list(SPANS))
def test_span16_plain_matches_jax(case):
    b, h, w, c, nblk, g = SPANS[case]
    mid = c // 2
    x, ps, dy, jout, jstats, jdx, jdps, jxsave = _jax_span16(SPANS[case])
    rows = _rows(ps)
    xp = _nchw(_f32(x)).to(T16)
    out, xsave, stats = ft.span_train_forward_reference(xp, rows, g)
    assert out.dtype == xsave.dtype == T16 and stats.dtype == torch.float32
    want = _f32(jout).transpose(0, 3, 1, 2)
    got = out.float().numpy()
    if nblk == 1:
        assert _ulps(got, want).max() <= 2, _ulps(got, want).max()
        assert (got == want).mean() >= 0.99
    else:
        assert _rel(got, want) <= 2 ** -6, _rel(got, want)
    js = np.asarray(jstats)[..., :9].reshape(b // g, nblk, mid, 3, 3)
    js = js.transpose(1, 3, 0, 4, 2)            # (nblk, 3 BNs, G, 3, mid)
    assert _rel(stats[0].numpy(), js[0]) <= 5e-5
    if nblk > 1:
        xsave = jxsave
        stats = torch.from_numpy(np.ascontiguousarray(js))

    dx, drows = ft.span_train_backward_reference(_nchw(_f32(dy)).to(T16),
                                                 xsave, stats, rows, g)
    assert dx.dtype == T16 and drows.dtype == torch.float32
    wdx = _f32(jdx).transpose(0, 3, 1, 2)
    assert _rel(dx.float().numpy(), wdx) <= 2 ** -6
    wrows = _rows(jdps).numpy()
    for i in range(nblk):
        for name, lo, hi in ft.row_sections(mid):
            a, r = drows[i, lo:hi].numpy(), wrows[i, lo:hi]
            err = np.abs(a - r).max()
            assert err <= 2 ** -6 * np.abs(r).max() + 1e-6, (i, name, err)


def test_span16_autograd_function_is_the_plain_pair():
    """`SpanTrain` on a bf16 input runs the bf16 form: bf16 out and dx,
    f32 weight gradients, equal to the plain pair's."""
    b, h, w, c, nblk, g = SPANS["c48_g2"]
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(b, c, h, w)).astype(np.float32))
    x = x.to(T16).requires_grad_()
    rows = _rows(_mk_params(np.random.RandomState(3), c // 2, nblk))
    rows.requires_grad_()
    out, stats = ft.SpanTrain.apply(x, rows, g)
    dy = torch.from_numpy(rng.normal(size=(b, c, h, w)).astype(np.float32))
    out.backward(dy.to(T16))
    assert out.dtype == x.grad.dtype == T16
    assert rows.grad.dtype == torch.float32
    pout, xsave, pst = ft.span_train_forward_reference(x.detach(),
                                                       rows.detach(), g)
    pdx, prows = ft.span_train_backward_reference(dy.to(T16), xsave, pst,
                                                  rows.detach(), g)
    assert torch.equal(out, pout) and torch.equal(stats, pst)
    assert torch.equal(x.grad, pdx) and torch.equal(rows.grad, prows)


# ------------------------------------------------------------------ B7

def _jax_stem16(x, w_raw, gamma, beta, dy, h4, w4, g):
    """JAX's bf16 stem: y (B, 24, h4, w4) f32 values, stats, and the
    gradients of Σ y·dy with respect to the raw OIHW kernel, γ and β,
    dy rounded to bf16 (the cotangent of a bf16 y)."""
    hw = h4 * w4
    stem = jst.make_stem_train(h4, w4, x.shape[2], g, dtype=BF,
                               interpret=True)
    r = jnp.asarray(dy.numpy().reshape(dy.shape[0], 24, hw)).astype(BF)
    xj = jnp.asarray(x.numpy())

    def fwd(kernel, scale, bias):
        wp = jst.pack_stem_weights_traced(kernel)
        return stem(xj, wp, jnp.tile(scale, 4)[:, None],
                    jnp.tile(bias, 4)[:, None])

    kernel = jnp.asarray(w_raw.numpy().transpose(2, 3, 1, 0))   # HWIO
    (y, stats), vjp = jax.vjp(fwd, kernel, jnp.asarray(gamma.numpy()),
                              jnp.asarray(beta.numpy()))
    cot = jnp.zeros(y.shape, BF).at[:, :, :hw].set(r)
    dk, dg, db = vjp((cot, jnp.zeros_like(stats)))
    y = _f32(y)[:, :, :hw].reshape(dy.shape)
    return (y, np.asarray(stats),
            (np.asarray(dk).transpose(3, 2, 0, 1), np.asarray(dg),
             np.asarray(db)))


# (b, H, W, group): 32×48 is 96 of 128 lanes (pad lanes)
STEMS = {"b2_g1": (2, 32, 48, 1), "b4_g2": (4, 32, 48, 2)}


@pytest.mark.parametrize("case", list(STEMS))
def test_stem16_plain_matches_jax(case):
    b, hgt, wid, g = STEMS[case]
    h4, w4 = hgt // 4, wid // 4
    x, w_raw, gamma, beta, dy = stem_train_case(17, b, hgt, wid)
    jy, jstats, jgrads = _jax_stem16(x, w_raw, gamma, beta, dy, h4, w4, g)

    w = w_raw.clone().requires_grad_()
    gm = gamma.clone().requires_grad_()
    bt = beta.clone().requires_grad_()
    y, stats = st.StemTrain.apply(x, w * (1.0 / 255.0), gm, bt, h4, w4, g,
                                  True)
    assert y.dtype == T16 and stats.dtype == torch.float32
    (y.float() * dy.to(T16).float()).sum().backward()
    got = y.detach().float().numpy()
    assert _ulps(got, jy).max() <= 1, _ulps(got, jy).max()
    assert (got == jy).mean() >= 0.99
    assert stats.shape == (b // g, 24, 3)
    for k, kind, tol in ((0, "mu", 5e-5), (1, "sinv", 5e-5),
                         (2, "var", 1e-4)):
        assert _rel(stats[:, :, k].numpy(), jstats[:, :, k]) <= tol, kind
    for name, got, want in (("dW", w.grad, jgrads[0]),
                            ("dgamma", gm.grad, jgrads[1]),
                            ("dbeta", bt.grad, jgrads[2])):
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), want) <= 2 ** -6, name


def _tie_case(seed=5, b=2, hgt=32, wid=48):
    """Smooth ramps (neighbouring pixels within one or two levels) with
    flat blocks, a one-tap weight per channel, γ = 1, β in [1.5, 2.5] (so
    that yb sits in [2, 4), where a bf16 ULP spans more than one pixel
    level)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hgt, 0:wid]
    images = np.empty((b, hgt, wid, 3), np.uint8)
    for i in range(b):
        for c in range(3):
            ramp = 40 + 3 * yy + 2 * xx + 17 * c + 5 * i
            images[i, :, :, c] = np.clip(
                ramp + rng.integers(0, 2, (hgt, wid)), 0, 255)
    images[:, 4:12, 8:24] = (200, 120, 40)
    w = np.zeros((24, 3, 3, 3), np.float32)
    for o in range(24):
        t = (5 * o) % 27
        w[o, t % 3, t // 9, (t // 3) % 3] = 0.5 + 0.05 * o
    gamma = np.ones(24, np.float32)
    beta = (1.5 + rng.random(24)).astype(np.float32)
    dy = rng.normal(0.0, 1.0, (b, 24, hgt // 4, wid // 4)).astype(np.float32)
    return (torch.from_numpy(pack_images_s2d(images)),
            *(torch.from_numpy(a) for a in (w, gamma, beta, dy)))


def test_stem16_route_is_jax_precedence_on_ties():
    b, hgt, wid, g = 2, 32, 48, 1
    h4, w4 = hgt // 4, wid // 4
    x, w_raw, gamma, beta, dy = _tie_case()
    jy, jstats, jgrads = _jax_stem16(x, w_raw, gamma, beta, dy, h4, w4, g)
    stats = torch.from_numpy(np.ascontiguousarray(jstats[:, :, :3]))
    w = w_raw * (1.0 / 255.0)
    # the rounded yb of the port's backward, with JAX's statistics
    u = st._conv(st._image(x, h4, w4, torch.float32), st._rounded(w, True))
    yb = torch.relu(st._bn_parts(u, stats, gamma, beta, g)[0])
    yb = yb.to(T16).float()
    pool = torch.nn.functional.max_pool2d(yb, 3, 2, 1)
    assert np.array_equal(pool.numpy(), jy)       # the same rounded yb
    p = torch.nn.functional.pad(yb, (1, 1, 1, 1), value=float("-inf"))
    win = torch.nn.functional.unfold(p.flatten(0, 1)[:, None], 3, stride=2)
    top = win.max(1, keepdim=True).values
    ties = int(((win == top).sum(1) > 1)[top[:, 0] > 0].sum())
    assert ties > 100, ties
    dw, dg, db = st.stem_train_backward_reference(dy.to(T16), x, stats, w,
                                                  gamma, beta, h4, w4, g,
                                                  bf16=True)
    for name, got, want in (("dW", dw / 255.0, jgrads[0]),
                            ("dgamma", dg, jgrads[1]),
                            ("dbeta", db, jgrads[2])):
        assert _rel(got.numpy(), want) <= 1e-5, (name, _rel(got.numpy(),
                                                            want))
