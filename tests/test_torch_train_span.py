"""The training span B8 (fastdet_torch/kernels/fused_train.py): the port's
plain forward and explicit backward against the JAX package's
`make_span_train` in interpret mode, on the CPU.

Geometries are those of the JAX package's own test
(tests/test_fused_train.py), (b, h, w, c, nblk) = (4, 6, 7, 48, 2) and
(4, 3, 3, 192, 3), each at ghost group b and b/2, so that the per-group
statistics matter.  Bounds are the JAX test's: the loss within 1e-5
relative; dx, every weight/γ/β gradient and the combined running stats
within 1e-4·max|ref| + 1e-4 (f32; the gradient of a bias that feeds a
BN is mathematically 0, so both sides are f32 noise there).  The
explicit backward equals autograd through the plain forward in f64 to
1e-10 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet.kernels import fused_train as jft
from fastdet_torch.kernels import fused_train as ft
from fastdet_torch.models.shufflenet import ShuffleV2Block
from test_fused_train import _mk_params, _pack_ws, _pack_x, _unpack_x

GEOMS = {"c48": (4, 6, 7, 48, 2), "c192": (4, 3, 3, 192, 3)}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def _rows(ps):
    """JAX test params (W1, Kdw (3,3,1,mid), W2, γ/β ×3) → packed rows."""
    rows = []
    for W1, Kdw, W2, *gb in ps:
        mid = W1.shape[0]
        rows.append(np.concatenate(
            [np.asarray(W1).ravel(), np.asarray(Kdw).reshape(9, mid).ravel(),
             np.asarray(W2).ravel()] + [np.asarray(a) for a in gb]))
    return torch.from_numpy(np.stack(rows).astype(np.float32))


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= 1e-4 * scale + 1e-4, f"{what}: {err} vs scale {scale}"


def _jax_case(geom, group):
    b, h, w, c, nblk = geom
    mid, hw = c // 2, h * w
    nimg = (hw + 127) // 128 * 128
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(b, h, w, c).astype(np.float32))
    ps = _mk_params(rng, mid, nblk)
    r = jnp.asarray(rng.randn(b, h, w, c).astype(np.float32))
    span = jft.make_span_train(nblk, h, w, nimg, c, group, dtype=jnp.float32,
                               interpret=True)

    def loss(x, ps):
        out_t, stats = span(_pack_x(x, b, hw, c, nimg, group),
                            _pack_ws(ps, c))
        return (jnp.sum(_unpack_x(out_t, b, h, w, c, nimg, group) * r),
                stats)

    (lv, stats), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(x, ps)
    return x, ps, r, lv, stats, grads, span, nimg


@pytest.mark.parametrize("halve", [False, True], ids=["g=b", "g=b/2"])
@pytest.mark.parametrize("geom", list(GEOMS), ids=list(GEOMS))
def test_plain_span_matches_jax(geom, halve):
    b, h, w, c, nblk = GEOMS[geom]
    mid = c // 2
    group = b // 2 if halve else b
    x, ps, r, lv, jstats, (jdx, jdps), _, _ = _jax_case(GEOMS[geom], group)

    rows = _rows(ps)
    out, xsave, stats = ft.span_train_forward_reference(_nchw(x), rows, group)
    loss = float((out * _nchw(r)).sum())
    assert abs(loss - float(lv)) / abs(float(lv)) < 1e-5
    assert stats.shape == (nblk, 3, b // group, 3, mid)

    # the ghost stats: JAX (G, nblk, mid, 16) columns [μ, σinv, var] × 3
    js = np.asarray(jstats)[..., :9].reshape(b // group, nblk, mid, 3, 3)
    _close(stats.numpy(), js.transpose(1, 3, 0, 4, 2), "ghost stats")
    mean, var = ft.combine_ghost_stats(stats)
    jmean, jvar = jft.combine_ghost_stats(jstats)
    _close(mean.numpy(), np.asarray(jmean).transpose(0, 2, 1), "mean")
    _close(var.numpy(), np.asarray(jvar).transpose(0, 2, 1), "var")

    dx, drows = ft.span_train_backward_reference(_nchw(r), xsave, stats,
                                                 rows, group)
    _close(dx.numpy(), _nchw(jdx).numpy(), "dx")
    want = _rows(jdps).numpy()
    for i in range(nblk):
        for name, lo, hi in ft.row_sections(mid):
            _close(drows[i, lo:hi].numpy(), want[i, lo:hi],
                   f"blk{i}.{name}")


def test_tap_gradient_is_the_diagonal_of_jax_expanded_cotangent():
    """The port's (9, mid) dw gradient equals the per-tap diagonals of
    the TPU kernel's (mid, 9·mid) cotangent (the eye-mask VJP)."""
    b, h, w, c, nblk = GEOMS["c48"]
    mid, hw = c // 2, h * w
    x, ps, r, _, _, _, span, nimg = _jax_case(GEOMS["c48"], b // 2)
    g = b // 2
    ws = _pack_ws(ps, c)
    _, vjp = jax.vjp(lambda ws: span(_pack_x(x, b, hw, c, nimg, g), ws)[0],
                     ws)
    (dws,) = vjp(_pack_x(r, b, hw, c, nimg, g))
    rows = _rows(ps)
    _, xsave, stats = ft.span_train_forward_reference(_nchw(x), rows, g)
    _, drows = ft.span_train_backward_reference(_nchw(r), xsave, stats,
                                                rows, g)
    for i in range(nblk):
        dwdwx = np.asarray(dws[i][1])                       # (mid, 9·mid)
        diag = np.stack([np.diagonal(dwdwx[:, t * mid:(t + 1) * mid])
                         for t in range(9)])
        _close(drows[i, mid * mid:mid * mid + 9 * mid].numpy().reshape(9, mid),
               diag, f"blk{i}.taps")


@pytest.mark.parametrize("geom", list(GEOMS), ids=list(GEOMS))
def test_explicit_backward_equals_autograd_f64(geom):
    b, h, w, c, nblk = GEOMS[geom]
    g = b // 2
    mid = c // 2
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(b, c, h, w))).requires_grad_()
    rows = torch.from_numpy(np.concatenate([
        rng.normal(0, 0.3, (nblk, 2 * mid * mid + 9 * mid)),
        1.0 + 0.1 * rng.normal(size=(nblk, 6 * mid))], 1)).requires_grad_()
    r = torch.from_numpy(rng.normal(size=(b, c, h, w)))
    out, xsave, stats = ft.span_train_forward_reference(x, rows, g)
    (out * r).sum().backward()
    dx, drows = ft.span_train_backward_reference(r, xsave.detach(),
                                                 stats.detach(),
                                                 rows.detach(), g)
    for got, want in ((dx, x.grad), (drows, rows.grad)):
        err = float((got - want).abs().max() / want.abs().max())
        assert err < 1e-10, err


def test_span_train_autograd_function_and_packing():
    """`SpanTrain` on the CPU: its output and gradients are those of the
    plain versions, and the packed gradient reaches every parameter of
    the blocks in their own layout."""
    torch.manual_seed(0)
    c, mid = 48, 24
    blocks = [ShuffleV2Block(mid, c, mid, 3, stride=1).double()
              for _ in range(2)]
    x = torch.randn(4, c, 5, 6, dtype=torch.float64, requires_grad=True)
    r = torch.randn(4, c, 5, 6, dtype=torch.float64)
    out, stats = ft.SpanTrain.apply(x, ft.pack_span_train_weights(blocks),
                                    2)
    (out * r).sum().backward()
    got = {n: p.grad.clone() for i, b in enumerate(blocks)
           for n, p in [(f"{i}.{k}", v) for k, v in b.named_parameters()]}
    x_grad = x.grad.clone()
    for b in blocks:
        b.zero_grad()
    x.grad = None

    # the same function through the reference ops, by autograd
    rows = ft.pack_span_train_weights(blocks)
    out2, _, stats2 = ft.span_train_forward_reference(x, rows, 2)
    (out2 * r).sum().backward()
    assert torch.equal(out, out2) and torch.equal(stats, stats2)
    assert float((x_grad - x.grad).abs().max()) < 1e-10
    for i, b in enumerate(blocks):
        for k, p in b.named_parameters():
            assert p.grad is not None and p.grad.shape == p.shape
            assert float((got[f"{i}.{k}"] - p.grad).abs().max()) < 1e-10, k


def test_pick_train_group_matches_jax():
    for nimg, c in ((2048, 48), (512, 96), (128, 192), (128, 48),
                    (384, 96), (640, 48)):
        for b in range(1, 257):
            assert ft.pick_train_group(b, nimg, c) == \
                jft.pick_train_group(b, nimg, c), (b, nimg, c)
    assert [ft.pick_train_group(128, n, c) for n, c in
            ((2048, 48), (512, 96), (128, 192))] == [2, 4, 16]


def test_combine_ghost_stats_matches_jax():
    """The same function as JAX's (pooled mean and variance), in a form
    without cancellation: exact where |μ| ≫ σ, where JAX's f32 form is
    not."""
    rng = np.random.default_rng(2)
    G, nblk, mid = 4, 2, 8
    js = rng.uniform(0.1, 2.0, (G, nblk, mid, 16)).astype(np.float32)
    mine = torch.from_numpy(js[..., :9].reshape(G, nblk, mid, 3, 3)
                            .transpose(1, 3, 0, 4, 2).copy())
    mean, var = ft.combine_ghost_stats(mine)
    jmean, jvar = jft.combine_ghost_stats(jnp.asarray(js))
    np.testing.assert_allclose(mean.numpy(),
                               np.asarray(jmean).transpose(0, 2, 1),
                               rtol=1e-6)
    np.testing.assert_allclose(var.numpy(),
                               np.asarray(jvar).transpose(0, 2, 1),
                               rtol=1e-5, atol=1e-6)

    # |μ| ≫ σ: against the pooled variance of the same f32 group stats,
    # computed in f64
    mu = rng.normal(30.0, 0.01, (nblk, 3, G, mid)).astype(np.float32)
    var = rng.uniform(1e-5, 2e-4, (nblk, 3, G, mid)).astype(np.float32)
    st = np.stack([mu, np.zeros_like(mu), var], 3)
    got_mean, got_var = ft.combine_ghost_stats(torch.from_numpy(st))
    mu64, var64 = mu.astype(np.float64), var.astype(np.float64)
    want = var64.mean(2) + ((mu64 - mu64.mean(2, keepdims=True)) ** 2).mean(2)
    np.testing.assert_allclose(got_var.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(got_mean.numpy(), mu64.mean(2), rtol=1e-7)
