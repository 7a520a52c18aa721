"""The fused forward's flag paths in the port (`input_format` "nhwc" and
"s2d8_u8", `fuse_s2=True`; fastdet_torch/kernels/{fold,fused_infer}.py)
against the JAX package's on the CPU, with the real weights
`weights/coco2017-ref.npz` and seeded uint8 images at b2 64×96 and
160×96.  The JAX side runs its Pallas kernels (the s2d(8) stem
`_stem8_call`, the stage kernel `_s2span_call`) in interpret mode, as its
own tests do; the port's stem_s2d8 and s2span run their plain PyTorch
versions, which the CUDA kernels are held to on the card.

Tolerances (those of tests/test_torch_fused_infer.py):
  * folding and s2d(8) packing: bitwise (the JAX package's composed
    stride-2 matrices are rebuilt from the port's split ones with the JAX
    expressions);
  * stems: 1e-5 (27-term f32 sums of exact u8·w products in other orders);
  * the stage and every forward stage: 2e-4, the JAX package's f32
    forward contract (the TPU kernel composes dw3×3 s2 with the pointwise
    convs, the port runs them apart).
"""

import functools
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet.io.torch_convert import load_npz_variables
from fastdet.kernels import fold as jfold
from fastdet.kernels import fused_infer as jfi
from fastdet_torch.io import from_jax_variables
from fastdet_torch.kernels import fold, fused_infer
from fastdet_torch.models import Detector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_NPZ = os.path.join(REPO, "weights", "coco2017-ref.npz")
STEM_ATOL = 1e-5
ATOL = 2e-4
SIZES = {"64x96": (64, 96), "160x96": (160, 96)}
UPTO = ["stem", "s2", "s3", "s4", None]
# the five combinations this file covers; ("s2d_u8", False) is
# tests/test_torch_fused_infer.py's
COMBOS = [c for c in itertools.product(fused_infer.INPUT_FORMATS,
                                       (False, True))
          if c != ("s2d_u8", False)]
COMBO_IDS = [f"{f}-{'fuse_s2' if s else 'xla_s2'}" for f, s in COMBOS]
STAGE_CIN = {2: 24, 3: 48, 4: 96}


@functools.lru_cache(maxsize=None)
def _variables():
    return load_npz_variables(REF_NPZ)


@functools.lru_cache(maxsize=None)
def _state_dict():
    return from_jax_variables(_variables())


@functools.lru_cache(maxsize=None)
def _jax_packed():
    return jfold.pack_fused_weights(_variables())


@functools.lru_cache(maxsize=None)
def _port_packed():
    return fold.pack_fused_weights(_state_dict())


def _images(size):
    hw = SIZES[size]
    return np.random.default_rng(hw[0] * 1000 + hw[1]).integers(
        0, 256, (2,) + hw + (3,), dtype=np.uint8)


def _inputs(images, input_format):
    if input_format == "s2d_u8":
        return fused_infer.pack_images_s2d(images)
    if input_format == "s2d8_u8":
        return fused_infer.pack_images_s2d8(images)
    return images


def _s2span_row(stage):
    pp = _port_packed()
    reps = {sid: r for sid, r, _ in fold.STAGES}[stage]
    s2 = {k: pp[f"s{stage}_0_{k}"] for k in fold.S2_ROW_KEYS}
    s1 = [{n: pp[f"s{stage}_{i}_{n}"] for n in
           ("w1", "b1", "wd", "bd", "w2", "b2")} for i in range(1, reps)]
    return fold.pack_s2span_weights(s2, s1), s1


# ---------------------------------------------------------------- packing

@pytest.mark.parametrize("hw", [(352, 352), (160, 96), (64, 96), (72, 104)])
def test_pack_images_s2d8_bitwise(hw):
    img = np.random.default_rng(hw[1]).integers(0, 256, (3,) + hw + (3,),
                                                dtype=np.uint8)
    got = fused_infer.pack_images_s2d8(img)
    want = np.asarray(jfi.pack_images_s2d8(img))
    assert got.dtype == np.uint8 and got.shape[2] % 128 == 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stage", [2, 3, 4])
def test_s2span_fold_matches_jax_s2_block_fused(stage):
    """The stage row holds `pack_s2_block`'s ten arrays and the span rows;
    JAX's phase-packed `s{n}_0f_*` matrices rebuilt from them with the JAX
    expressions (fastdet/kernels/fold.py `pack_s2_block_fused`) are bitwise
    the JAX package's."""
    row, s1 = _s2span_row(stage)
    cin = mid = STAGE_CIN[stage]
    assert row.dtype == np.float32
    assert row.shape == (fused_infer.s2span_floats(cin, len(s1)),)
    sizes = [cin * mid, mid, 9 * mid, mid, mid * mid, mid, 9 * cin, cin,
             cin * mid, mid]
    parts = dict(zip(fold.S2_ROW_KEYS, np.split(row, np.cumsum(sizes))))
    np.testing.assert_array_equal(row[sum(sizes):].reshape(len(s1), -1),
                                  fold.pack_span_weights(s1))
    w1 = parts["w1"].reshape(cin, mid)
    wd = parts["wd"].reshape(3, 3, mid)
    w2 = parts["w2"].reshape(mid, mid)
    wpd = parts["wpd"].reshape(3, 3, cin)
    wpp = parts["wpp"].reshape(cin, mid)
    b1, bd, b2, bpd, bpp = (parts[k] for k in ("b1", "bd", "b2", "bpd",
                                                "bpp"))
    wa_blk = np.zeros((4 * mid, 4 * cin), np.float32)
    for p in range(4):
        wa_blk[p * mid:(p + 1) * mid, p * cin:(p + 1) * cin] = w1.T
    wc = np.zeros((mid, 9 * mid), np.float32)
    wp = np.zeros((mid, 9 * cin), np.float32)
    for t in range(9):
        dy, dx = t // 3 - 1, t % 3 - 1
        wc[:, t * mid:(t + 1) * mid] = w2.T * wd[dy + 1, dx + 1][None, :]
        wp[:, t * cin:(t + 1) * cin] = wpp.T * wpd[dy + 1, dx + 1][None, :]
    jp = _jax_packed()
    for name, got in (("wa", wa_blk), ("ba", np.tile(b1, 4)), ("wc", wc),
                      ("bc", w2.T @ bd + b2), ("wp", wp),
                      ("bp", wpp.T @ bpd + bpp)):
        np.testing.assert_array_equal(got, jp[f"s{stage}_0f_{name}"],
                                      err_msg=name)


# ---------------------------------------------------------------- kernels

@pytest.mark.parametrize("size", list(SIZES))
def test_stem_s2d8_reference_matches_jax_stem8_call(size):
    jp = _jax_packed()
    ih, iw = SIZES[size]
    h8, w8 = ih // 8, iw // 8
    xs = fused_infer.pack_images_s2d8(_images(size))
    w768, b384 = jfi.pack_stem_s2d8(jp["stem_w"], jp["stem_b"])
    pp = np.asarray(jfi._stem8_call(jnp.asarray(xs), jnp.asarray(w768),
                                    jnp.asarray(b384), h8, w8, jnp.float32,
                                    True))[:, :, :h8 * w8]
    # phase-unpack as the JAX package's stem8_nhwc: (B, 2, 2, 24, h8, w8)
    want = pp.reshape(2, 2, 2, 24, h8, w8).transpose(0, 3, 4, 1, 5, 2)
    want = want.reshape(2, 24, 2 * h8, 2 * w8)
    w, bias = fused_infer.pack_stem_s2d(jp["stem_w"], jp["stem_b"])
    before = fused_infer.stem_s2d8.launches
    got = fused_infer.stem_s2d8(torch.from_numpy(xs), torch.from_numpy(w),
                                torch.from_numpy(bias), h8, w8)
    assert fused_infer.stem_s2d8.launches == before     # CPU: no kernel
    assert tuple(got.shape) == (2, 24, 2 * h8, 2 * w8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=STEM_ATOL)


@pytest.mark.parametrize("stage", [2, 3, 4])
@pytest.mark.parametrize("hw", [(8, 16), (5, 7)], ids=["no_pad", "pad"])
def test_s2span_reference_matches_jax_s2span_call(stage, hw):
    """Each stage's real folded weights on a seeded stage input of 2h×2w.
    8×16 output fills 128 lanes exactly; 5×7 leaves 93 pad lanes, which
    hold junk on the JAX side's phase-packed input."""
    reps, c = {sid: (r, ch) for sid, r, ch in fold.STAGES}[stage]
    cin, nblk = STAGE_CIN[stage], reps - 1
    h, w = hw
    nimg = (h * w + 127) // 128 * 128
    rng = np.random.default_rng(stage * 100 + h)
    x = np.abs(rng.normal(0.0, 1.0, (2, cin, 2 * h, 2 * w))).astype(
        np.float32)
    xp = rng.normal(0.0, 5.0, (2, 4 * cin, nimg)).astype(np.float32)
    xp[:, :, :h * w] = x.reshape(2, cin, h, 2, w, 2).transpose(
        0, 3, 5, 1, 2, 4).reshape(2, 4 * cin, h * w)
    jp = _jax_packed()
    ws = ([jnp.asarray(jp[f"s{stage}_0f_{nm}"])
           for nm in ("wa", "ba", "wc", "bc", "wp", "bp")]
          + [jnp.asarray(jp[f"s{stage}_{i}_{nm}"]) for i in range(1, reps)
             for nm in ("wa", "ba", "wc", "bc")])
    want = np.asarray(jfi._s2span_call(
        jnp.asarray(xp), ws, nblk, h, w, nimg, cin, c, jnp.float32,
        True))[:, :, :h * w]
    row, _ = _s2span_row(stage)
    before = fused_infer.s2span.launches
    got = fused_infer.s2span(torch.from_numpy(x), torch.from_numpy(row),
                             nblk)
    assert fused_infer.s2span.launches == before         # CPU: no kernel
    assert tuple(got.shape) == (2, c, h, w)
    np.testing.assert_allclose(got.reshape(2, c, h * w).numpy(), want,
                               rtol=0, atol=ATOL)


def test_s2span_reference_equals_block_then_span():
    """The stage's plain version is the non-fused stage's two pieces: the
    stride-2 block of `_s2_block` and `span_reference`, on odd sizes too."""
    _, p = fused_infer.build_fused_forward(_state_dict(), input_hw=(64, 96),
                                           device="cpu")
    for (sid, reps, c), hw in zip(fold.STAGES, ((16, 24), (9, 13), (5, 3))):
        x = torch.from_numpy(np.abs(np.random.default_rng(sid).normal(
            0.0, 1.0, (2, STAGE_CIN[sid]) + hw)).astype(np.float32))
        got = fused_infer.s2span_reference(x, p[f"s{sid}_s2span"], reps - 1)
        want = fused_infer.span_reference(
            fused_infer._s2_block(x, p, f"s{sid}_0"), p[f"s{sid}_span"],
            reps - 1)
        assert got.shape == want.shape == (2, c, (hw[0] + 1) // 2,
                                           (hw[1] + 1) // 2)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5)


# ---------------------------------------------------------------- forward

@functools.lru_cache(maxsize=None)
def _jax_forward(size, input_format, fuse_s2, upto):
    fwd, packed = jfi.build_fused_forward(
        jax.tree.map(jnp.asarray, _variables()), input_hw=SIZES[size],
        dtype=jnp.float32, interpret=True, input_format=input_format,
        upto=upto, fuse_s2=fuse_s2)
    out = fwd(jnp.asarray(_inputs(_images(size), input_format)), packed)
    return [np.asarray(o) for o in (out if upto is None else (out,))]


def _port_forward(size, input_format, fuse_s2, upto):
    fwd, packed = fused_infer.build_fused_forward(
        _state_dict(), input_hw=SIZES[size], input_format=input_format,
        fuse_s2=fuse_s2, upto=upto, device="cpu")
    kernels = (fused_infer.stem_s2d, fused_infer.stem_s2d8,
               fused_infer.span, fused_infer.s2span)
    before = [k.launches for k in kernels]
    with torch.inference_mode():
        out = fwd(torch.from_numpy(_inputs(_images(size), input_format)),
                  packed)
    assert [k.launches for k in kernels] == before       # CPU: no kernel
    return [o.numpy() for o in (out if upto is None else (out,))]


def _cases():
    """Every upto at 64×96, the whole forward at 160×96."""
    out = []
    for (fmt, fs), cid in zip(COMBOS, COMBO_IDS):
        for upto in UPTO:
            out.append(pytest.param("64x96", fmt, fs, upto,
                                    id=f"64x96-{cid}-{upto}"))
        out.append(pytest.param("160x96", fmt, fs, None,
                                id=f"160x96-{cid}-None"))
    return out


@pytest.mark.parametrize("size,input_format,fuse_s2,upto", _cases())
def test_fused_forward_flag_paths_match_jax(size, input_format, fuse_s2,
                                            upto):
    want = _jax_forward(size, input_format, fuse_s2, upto)
    got = _port_forward(size, input_format, fuse_s2, upto)
    assert len(got) == len(want) == (6 if upto is None else 1)
    atol = STEM_ATOL if upto == "stem" else ATOL
    for g, j in zip(got, want):
        assert g.shape == j.shape
        np.testing.assert_allclose(g, j, rtol=0, atol=atol)


@pytest.mark.parametrize("input_format,fuse_s2", [
    pytest.param(f, s, id=f"{f}-{'fuse_s2' if s else 'xla_s2'}")
    for f, s in itertools.product(fused_infer.INPUT_FORMATS, (False, True))])
def test_every_combination_matches_detector(input_format, fuse_s2):
    """All six combinations against the port's Detector (cuDNN-style convs,
    unfolded BN) on the same images at 64×96."""
    det = Detector(80, 3)
    det.load_state_dict(_state_dict())
    det.eval()
    img = _images("64x96")
    with torch.inference_mode():
        want = det(torch.from_numpy(img).float() / 255.0)
    got = _port_forward("64x96", input_format, fuse_s2, None)
    for g, w in zip(got, want):
        assert g.shape == tuple(w.shape)
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("hw", [(640, 640), (352, 416), (448, 288)])
def test_s2d8_guard_raises_where_jax_does(hw):
    """pad128(H/8·W/8) ≤ 2048: 640² (6,400 lanes) and 352×416 (2,288 →
    2,304) are refused by both packages with the advice to use s2d_u8;
    448×288 (2,016 → 2,048) is accepted by both."""
    kw = dict(input_hw=hw, input_format="s2d8_u8")
    refused = (hw[0] // 8) * (hw[1] // 8) > 2048
    if refused:
        with pytest.raises(ValueError, match="use s2d_u8"):
            jfi.build_fused_forward(_variables(), dtype=jnp.float32,
                                    interpret=True, **kw)
        with pytest.raises(ValueError, match="use s2d_u8"):
            fused_infer.build_fused_forward(_state_dict(), device="cpu", **kw)
    else:
        jfi.build_fused_forward(_variables(), dtype=jnp.float32,
                                interpret=True, **kw)
        fused_infer.build_fused_forward(_state_dict(), device="cpu", **kw)
    with pytest.raises(ValueError, match="use s2d_u8"):
        fused_infer.check_stem8_size(hw[0] + 4, hw[1])


@pytest.mark.parametrize("input_format", fused_infer.INPUT_FORMATS)
def test_forward_rejects_other_layouts(input_format):
    fwd, packed = fused_infer.build_fused_forward(
        _state_dict(), input_hw=(64, 96), input_format=input_format,
        device="cpu")
    img = _images("64x96")
    for other in fused_infer.INPUT_FORMATS:
        x = torch.from_numpy(_inputs(img, other))
        if other == input_format:
            fwd(x, packed)
            continue
        with pytest.raises(ValueError, match=input_format):
            fwd(x, packed)
    with pytest.raises(ValueError, match=input_format):
        fwd(torch.from_numpy(_inputs(img, input_format)).float(), packed)
