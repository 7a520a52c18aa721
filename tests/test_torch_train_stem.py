"""The training stem B7 (fastdet_torch/kernels/stem_train.py): the port's
plain forward and explicit backward against the JAX package's
`make_stem_train` in interpret mode, on the CPU; and the fused training
apply's `stem_group` / `span_stages` against the JAX package's.

Geometries: 32×48 (h4·w4 = 96 of 128 lanes: pad lanes) at (b2, group 1)
and (b4, group 2), and b2 group 1 on images with flat blocks, where the
pool windows hold positive ties and the routing precedence decides the
gradient.  Bounds (f32): y within 2e-4 of its scale and the stats μ,
σinv, var within 2e-4 of each kind's scale; the gradients with respect to
the raw kernel, γ and β within 1e-4·max|ref| + 1e-4 per leaf (those of
tests/test_torch_train_span.py).  The explicit backward equals autograd
through conv, ghost BN, ReLU and `max_pool2d` in f64 to 1e-10 relative on
noise images (no positive ties there, so the pool's tie order does not
matter).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fastdet.kernels import stem_train as jst
from fastdet_torch.kernels import stem_train as st
from torch_cases import grad_err, pool_ties, stem_train_case

REF_NPZ = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "weights", "coco2017-ref.npz")
# (b, H, W, group, tie)
CASES = {"b2_g1": (2, 32, 48, 1, False), "b4_g2": (4, 32, 48, 2, False),
         "ties_g1": (2, 32, 48, 1, True)}


def _jax_stem(x, w_raw, gamma, beta, dy, h4, w4, g):
    """JAX's value and gradients with respect to the raw HWIO kernel, γ
    and β of Σ y·dy (y on the valid lanes)."""
    hw = h4 * w4
    npad = x.shape[2]
    stem = jst.make_stem_train(h4, w4, npad, g, dtype=jnp.float32,
                               interpret=True)
    r = jnp.asarray(dy.numpy().reshape(dy.shape[0], 24, hw))
    xj = jnp.asarray(x.numpy())

    def loss(kernel, scale, bias):
        wp = jst.pack_stem_weights_traced(kernel)
        y, stats = stem(xj, wp, jnp.tile(scale, 4)[:, None],
                        jnp.tile(bias, 4)[:, None])
        return jnp.sum(y[:, :, :hw] * r), (y, stats)

    kernel = jnp.asarray(w_raw.numpy().transpose(2, 3, 1, 0))   # HWIO
    (_, (y, stats)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
            kernel, jnp.asarray(gamma.numpy()), jnp.asarray(beta.numpy()))
    y = np.asarray(y)[:, :, :hw].reshape(dy.shape)
    dk, dg, db = (np.asarray(a) for a in grads)
    return y, np.asarray(stats), (dk.transpose(3, 2, 0, 1), dg, db)


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: {err} vs scale {scale}"


@pytest.mark.parametrize("case", list(CASES))
def test_plain_stem_matches_jax(case):
    b, hgt, wid, g, tie = CASES[case]
    h4, w4 = hgt // 4, wid // 4
    x, w_raw, gamma, beta, dy = stem_train_case(7, b, hgt, wid, tie)
    assert x.shape[2] == 128 and h4 * w4 == 96          # pad lanes
    jy, jstats, jgrads = _jax_stem(x, w_raw, gamma, beta, dy, h4, w4, g)

    w = w_raw.clone().requires_grad_()
    gm = gamma.clone().requires_grad_()
    bt = beta.clone().requires_grad_()
    y, stats = st.StemTrain.apply(x, w * (1.0 / 255.0), gm, bt, h4, w4, g)
    (y * dy).sum().backward()
    _close(y.detach(), jy, 2e-4, "y")
    assert stats.shape == (b // g, 24, 3)
    for k, kind in enumerate(("mu", "sinv", "var")):
        _close(stats[:, :, k], jstats[:, :, k], 2e-4, kind)
    for name, got, want in (("dW", w.grad, jgrads[0]), ("dgamma", gm.grad,
                                                        jgrads[1]),
                            ("dbeta", bt.grad, jgrads[2])):
        err, bound = grad_err(got, torch.from_numpy(np.array(want)))
        assert err <= bound, (name, err, bound)
    if tie:
        assert pool_ties(x, w_raw * (1.0 / 255.0), stats, gamma, beta, h4,
                         w4, g) > 0


def _composed(x, w, gamma, beta, h4, w4, g):
    """The same function from library ops (autograd differentiates it):
    conv2d, ghost BN with the biased variance, ReLU, max_pool2d."""
    b = x.shape[0]
    img = x[:, :, :h4 * w4].reshape(b, 4, 4, 3, h4, w4)
    img = img.permute(0, 3, 4, 1, 5, 2).reshape(b, 3, 4 * h4, 4 * w4)
    u = F.conv2d(img.to(w.dtype), w, stride=2, padding=1)
    ug = u.reshape(b // g, g, 24, -1)
    mu = ug.mean((1, 3), keepdim=True)
    var = ((ug - mu) ** 2).mean((1, 3), keepdim=True)
    bn = ((ug - mu) * torch.rsqrt(var + st.EPS)).reshape(u.shape)
    bn = bn * gamma[:, None, None] + beta[:, None, None]
    return F.max_pool2d(torch.relu(bn), 3, 2, 1)


def test_explicit_backward_equals_autograd_f64():
    b, hgt, wid, g = 4, 32, 48, 2
    h4, w4 = hgt // 4, wid // 4
    x, w_raw, gamma, beta, dy = (
        t.double() if t.is_floating_point() else t
        for t in stem_train_case(3, b, hgt, wid))
    leaves = [(w_raw / 255.0).requires_grad_(), gamma.requires_grad_(),
              beta.requires_grad_()]
    (_composed(x, *leaves, h4, w4, g) * dy).sum().backward()
    y, stats = st.stem_train_forward_reference(x, *leaves, h4, w4, g)
    w, gm, bt = (t.detach() for t in leaves)
    stats = stats.detach()
    assert pool_ties(x, w, stats, gm, bt, h4, w4, g) == 0
    got = st.stem_train_backward_reference(dy, x, stats, w, gm, bt, h4, w4,
                                           g)
    for name, a, leaf in zip(("dW", "dgamma", "dbeta"), got, leaves):
        err = float((a - leaf.grad).abs().max() / leaf.grad.abs().max())
        assert err < 1e-10, (name, err)
    want = _composed(x, w, gm, bt, h4, w4, g)
    assert float((y.detach() - want).abs().max() / want.abs().max()) < 1e-12


def test_stem_train_function_equals_plain():
    """`StemTrain` on the CPU: the plain forward's y and stats, and the
    plain backward's gradients through the 1/255 scale."""
    b, hgt, wid, g = 4, 32, 48, 2
    h4, w4 = hgt // 4, wid // 4
    x, w_raw, gamma, beta, dy = stem_train_case(5, b, hgt, wid, tie=True)
    w = w_raw.clone().requires_grad_()
    gm = gamma.clone().requires_grad_()
    bt = beta.clone().requires_grad_()
    ws = w * (1.0 / 255.0)
    y, stats = st.StemTrain.apply(x, ws, gm, bt, h4, w4, g)
    (y * dy).sum().backward()
    ry, rstats = st.stem_train_forward_reference(x, ws.detach(), gamma,
                                                 beta, h4, w4, g)
    assert torch.equal(y, ry) and torch.equal(stats, rstats)
    dws, dg, db = st.stem_train_backward_reference(
        dy, x, rstats, ws.detach(), gamma, beta, h4, w4, g)
    assert torch.equal(w.grad, dws * (1.0 / 255.0))
    assert torch.equal(gm.grad, dg) and torch.equal(bt.grad, db)
    assert not stats.requires_grad


def test_combine_stem_stats():
    """Against JAX's combine (f32, 1e-6) and, in f64, equal to the full
    batch's mean and biased variance of the conv output (1e-12)."""
    rng = np.random.default_rng(4)
    G = 8
    js = rng.uniform(0.1, 2.0, (G, 24, 8)).astype(np.float32)
    mean, var = st.combine_stem_stats(torch.from_numpy(js[:, :, :3].copy()))
    jmean, jvar = jst.combine_stem_stats(jnp.asarray(js))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-6)

    b, hgt, wid, g = 4, 32, 48, 2
    h4, w4 = hgt // 4, wid // 4
    x, w_raw, gamma, beta, _ = (
        t.double() if t.is_floating_point() else t
        for t in stem_train_case(6, b, hgt, wid))
    w = w_raw / 255.0
    _, stats = st.stem_train_forward_reference(x, w, gamma, beta, h4, w4, g)
    mean, var = st.combine_stem_stats(stats)
    img = x[:, :, :h4 * w4].reshape(b, 4, 4, 3, h4, w4)
    img = img.permute(0, 3, 4, 1, 5, 2).reshape(b, 3, 4 * h4, 4 * w4)
    u = F.conv2d(img.double(), w, stride=2, padding=1)
    umean = u.mean((0, 2, 3))
    uvar = ((u - umean[:, None, None]) ** 2).mean((0, 2, 3))
    assert float((mean - umean).abs().max() / umean.abs().max()) < 1e-12
    assert float((var - uvar).abs().max() / uvar.abs().max()) < 1e-12


def test_s2d_apply_with_span_stages_matches_jax_f32():
    """`build_fused_train_apply(input_format="s2d_u8", stem_group=2,
    span_stages=(3,))` against JAX's at 96², b4, f32, from the reference
    weights: stage 3 through B8, stages 2 and 4 through the model's own
    blocks, the stem through B7.  Outputs within 2e-4 of each one's scale
    (the f32 forward contract); per BN, the new running variance within
    1e-4 of its largest and the running mean within 1e-4 of its largest
    running std (the means of BNs that follow BNs sit near 0, ~1e-7)."""
    from fastdet.io.torch_convert import load_npz_variables
    from fastdet.kernels.fused_infer import pack_images_s2d
    from fastdet.train.fused_forward import \
        build_fused_train_apply as jbuild
    from fastdet_torch.io import from_jax_variables
    from fastdet_torch.models import Detector
    from fastdet_torch.train.fused_forward import build_fused_train_apply

    variables = load_npz_variables(REF_NPZ)
    rng = np.random.default_rng(8)
    images = rng.integers(0, 256, (4, 96, 96, 3), dtype=np.uint8)
    xs = pack_images_s2d(images)
    japply = jbuild((96, 96), dtype=jnp.float32, interpret=True,
                    input_format="s2d_u8", stem_group=2, span_stages=(3,))
    jouts, jnew = japply(jax.tree.map(jnp.asarray, variables["params"]),
                         jax.tree.map(jnp.asarray, variables["batch_stats"]),
                         jnp.asarray(xs))
    jstats = from_jax_variables({"batch_stats": jax.tree.map(np.asarray,
                                                             jnew)})

    model = Detector(80, 3)
    model.load_state_dict(from_jax_variables(variables))
    apply_fn = build_fused_train_apply(
        (96, 96), input_format="s2d_u8", stem_group=2, span_stages=(3,),
        device="cpu")
    with torch.no_grad():
        outs = apply_fn(model.train(), torch.from_numpy(xs))
    for o, jo in zip(outs, jouts):
        _close(o, np.asarray(jo), 2e-4, "output")
    sd = model.state_dict()
    assert set(jstats) == {k for k in sd if "running" in k}
    for k in jstats:
        if k.endswith("running_var"):
            _close(sd[k], jstats[k], 1e-4, k)
            km = k[:-len("var")] + "mean"
            err = float((sd[km] - jstats[km]).abs().max())
            assert err <= 1e-4 * float(jstats[k].max()) ** 0.5, (km, err)
