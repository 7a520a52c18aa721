"""The port's fused forward (fastdet_torch/kernels/{fold,fused_infer}.py)
against the JAX package's on the CPU, with the real weights
`weights/coco2017-ref.npz` and seeded uint8 images.  The JAX side runs its
Pallas kernels in interpret mode, as its own tests do; the port's stem and
span run their plain PyTorch versions, which the CUDA kernels are held to
on the card.

Tolerances:
  * folding and s2d packing: bitwise (numpy f32 in the same operation
    order on both sides; the JAX package's composed stride-1 matrices are
    rebuilt from the port's split ones with the JAX expressions);
  * stem: 1e-5 (27-term f32 sums of exact u8·w products, summed in other
    orders; outputs up to ~4);
  * span and every forward stage: 2e-4, the JAX package's f32 forward
    contract (the TPU kernel composes dw3×3∘pw2 into one matrix, the port
    runs them apart, and the sums run in other orders).
"""

import functools
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
SIZES = {"352": ((352, 352), 1), "160x96": ((160, 96), 2)}
UPTO = ["stem", "s2", "s3", "s4", None]


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
    hw, b = SIZES[size]
    seed = hw[0] * 1000 + hw[1]
    return np.random.default_rng(seed).integers(0, 256, (b,) + hw + (3,),
                                                dtype=np.uint8)


# ---------------------------------------------------------------- folding

def test_fold_matches_jax_pack_fused_weights():
    jp, pp = _jax_packed(), _port_packed()
    s1 = {f"s{sid}_{i}" for sid, reps, _ in fold.STAGES
          for i in range(1, reps)}
    shared = [k for k in jp if "_0f_" not in k
              and not any(k.startswith(p + "_") for p in s1)]
    assert set(shared) == {k for k in pp if not any(
        k.startswith(p + "_") for p in s1)}
    for k in shared:
        assert pp[k].dtype == np.float32
        np.testing.assert_array_equal(pp[k], jp[k], err_msg=k)
    for prefix in sorted(s1):
        c = jp[f"{prefix}_wa"].shape[0]
        mid = c // 2
        w1, b1, wd, bd, w2, b2 = (pp[f"{prefix}_{n}"] for n in
                                  ("w1", "b1", "wd", "bd", "w2", "b2"))
        wa, ba = jp[f"{prefix}_wa"], jp[f"{prefix}_ba"]
        # top half: odd-select ∘ pw1; bottom half: the even passthrough
        np.testing.assert_array_equal(wa[:mid, 1::2], w1.T)
        np.testing.assert_array_equal(wa[:mid, 0::2], 0.0)
        sel_even = np.zeros((mid, c), np.float32)
        sel_even[np.arange(mid), np.arange(0, c, 2)] = 1.0
        np.testing.assert_array_equal(wa[mid:], sel_even)
        np.testing.assert_array_equal(ba, np.concatenate(
            [b1, np.zeros(mid, np.float32)]))
        for t in range(9):
            np.testing.assert_array_equal(
                jp[f"{prefix}_wc"][:, t * mid:(t + 1) * mid],
                w2.T * wd[t // 3, t % 3][None, :])
        np.testing.assert_array_equal(jp[f"{prefix}_bc"], w2.T @ bd + b2)


def test_stem_weights_are_the_phase_matrix_entries():
    jp = _jax_packed()
    w, b = fused_infer.pack_stem_s2d(jp["stem_w"], jp["stem_b"])
    w96, b96 = jfi.pack_stem_s2d(jp["stem_w"], jp["stem_b"])
    np.testing.assert_array_equal(b96, np.tile(b, 4))
    expect = np.zeros_like(w96)
    for py in range(2):
        for px in range(2):
            ph = py * 2 + px
            for ky in range(3):
                v = 2 * py + ky - 1
                du, yoff = (-1, 3) if v < 0 else (0, v)
                for kx in range(3):
                    u = 2 * px + kx - 1
                    dv, xoff = (-1, 3) if u < 0 else (0, u)
                    t = jfi._STEM_TAPS.index((du, dv))
                    for c in range(3):
                        expect[t * 48 + yoff * 12 + xoff * 3 + c,
                               ph * 24:(ph + 1) * 24] = w[ky, kx, c]
    np.testing.assert_array_equal(w96, expect)


@pytest.mark.parametrize("hw", [(352, 352), (160, 96), (64, 32)])
def test_pack_images_s2d_bitwise(hw):
    img = np.random.default_rng(hw[0]).integers(0, 256, (3,) + hw + (3,),
                                                dtype=np.uint8)
    got = fused_infer.pack_images_s2d(img)
    want = np.asarray(jfi.pack_images_s2d(img))
    assert got.dtype == np.uint8 and got.shape[2] % 128 == 0
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- kernels

@pytest.mark.parametrize("size", ["352", "160x96"])
def test_stem_reference_matches_jax_stem_call(size):
    jp = _jax_packed()
    (ih, iw), b = SIZES[size]
    h4, w4 = ih // 4, iw // 4
    xs = fused_infer.pack_images_s2d(_images(size))
    w96, b96 = jfi.pack_stem_s2d(jp["stem_w"], jp["stem_b"])
    want = np.asarray(jfi._stem_call(jnp.asarray(xs), jnp.asarray(w96),
                                     jnp.asarray(b96), h4, w4, jnp.float32,
                                     True))[:, :, :h4 * w4]
    w, bias = fused_infer.pack_stem_s2d(jp["stem_w"], jp["stem_b"])
    before = fused_infer.stem_s2d.launches
    got = fused_infer.stem_s2d(torch.from_numpy(xs), torch.from_numpy(w),
                               torch.from_numpy(bias), h4, w4)
    assert fused_infer.stem_s2d.launches == before     # CPU: no kernel
    assert tuple(got.shape) == (b, 24, h4, w4)
    np.testing.assert_allclose(got.reshape(b, 24, -1).numpy(), want,
                               rtol=0, atol=STEM_ATOL)


def test_stem_reference_matches_jax_chunked_stem(monkeypatch):
    """B6: the JAX package's row-chunked stem (`_stem_call_chunked`, for
    inputs above its 8192-lane budget) against the port's one stem, which
    serves every size.  The lane budget is shrunk to force 8 chunks at
    128×96 (h/4 = 32, w/4 = 24), as tests/test_fused_kernels.py does."""
    monkeypatch.setattr(jfi, "_STEM_LANE_BUDGET", 200)
    jp = _jax_packed()
    ih, iw, b = 128, 96, 2
    h4, w4 = ih // 4, iw // 4
    assert jfi._stem_chunk_rows(h4, w4) == 4
    imgs = np.random.default_rng(128).integers(0, 256, (b, ih, iw, 3),
                                               dtype=np.uint8)
    xs = fused_infer.pack_images_s2d(imgs)
    w96, b96 = jfi.pack_stem_s2d(jp["stem_w"], jp["stem_b"])
    want = np.asarray(jfi._stem_call_chunked(
        jnp.asarray(xs), jnp.asarray(w96), jnp.asarray(b96), h4, w4,
        jnp.float32, interpret=True))
    w, bias = fused_infer.pack_stem_s2d(jp["stem_w"], jp["stem_b"])
    got = fused_infer.stem_s2d_reference(
        torch.from_numpy(xs), torch.from_numpy(w), torch.from_numpy(bias),
        h4, w4)
    np.testing.assert_allclose(got.reshape(b, 24, -1).numpy(), want,
                               rtol=0, atol=STEM_ATOL)


def test_fused_forward_640_matches_detector():
    """B6 on the port's side: 640² (25,600 s2d lanes, over the JAX
    package's 8192 budget) through the fused forward, B = 1."""
    img = np.random.default_rng(640).integers(0, 256, (1, 640, 640, 3),
                                              dtype=np.uint8)
    fwd, packed = fused_infer.build_fused_forward(
        _state_dict(), input_hw=(640, 640), device="cpu")
    det = Detector()
    det.load_state_dict(_state_dict())
    det.eval()
    with torch.inference_mode():
        got = fwd(torch.from_numpy(fused_infer.pack_images_s2d(img)), packed)
        want = det(torch.from_numpy(img).float() / 255.0)
    assert [tuple(g.shape) for g in got] == [
        (1, 40, 40, 12), (1, 40, 40, 3), (1, 40, 40, 80),
        (1, 20, 20, 12), (1, 20, 20, 3), (1, 20, 20, 80)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("stage", [2, 3, 4])
@pytest.mark.parametrize("hw", [(8, 16), (5, 7)], ids=["no_pad", "pad"])
def test_span_reference_matches_jax_span_call(stage, hw):
    """Each stage's real folded blocks.  8×16 fills 128 lanes exactly;
    5×7 leaves 93 pad lanes, which hold junk on the JAX side."""
    reps, c = {sid: (r, ch) for sid, r, ch in fold.STAGES}[stage]
    nblk = reps - 1
    h, w = hw
    nimg = (h * w + 127) // 128 * 128
    rng = np.random.default_rng(stage * 100 + h)
    x = np.abs(rng.normal(0.0, 1.0, (2, c, h, w))).astype(np.float32)
    xt = rng.normal(0.0, 5.0, (2, c, nimg)).astype(np.float32)
    xt[:, :, :h * w] = x.reshape(2, c, h * w)
    jp = _jax_packed()
    ws = [jnp.asarray(jp[f"s{stage}_{i}_{nm}"]) for i in range(1, reps)
          for nm in ("wa", "ba", "wc", "bc")]
    want = np.asarray(jfi._span_call(jnp.asarray(xt), ws, nblk, h, w, nimg,
                                     c, jnp.float32, True))[:, :, :h * w]
    pp = _port_packed()
    weights = torch.from_numpy(fused_infer.pack_span_weights(
        [{n: pp[f"s{stage}_{i}_{n}"] for n in
          ("w1", "b1", "wd", "bd", "w2", "b2")} for i in range(1, reps)]))
    before = fused_infer.span.launches
    got = fused_infer.span(torch.from_numpy(x), weights, nblk)
    assert fused_infer.span.launches == before          # CPU: no kernel
    np.testing.assert_allclose(got.reshape(2, c, h * w).numpy(), want,
                               rtol=0, atol=ATOL)


# ---------------------------------------------------------------- forward

@functools.lru_cache(maxsize=None)
def _jax_forward(size, upto):
    hw, _ = SIZES[size]
    fwd, packed = jfi.build_fused_forward(
        jax.tree.map(jnp.asarray, _variables()), input_hw=hw,
        dtype=jnp.float32, interpret=True, input_format="s2d_u8", upto=upto)
    out = fwd(jnp.asarray(fused_infer.pack_images_s2d(_images(size))),
              packed)
    return [np.asarray(o) for o in (out if upto is None else (out,))]


def _port_forward(size, upto):
    hw, _ = SIZES[size]
    fwd, packed = fused_infer.build_fused_forward(
        _state_dict(), input_hw=hw, upto=upto, device="cpu")
    with torch.inference_mode():
        out = fwd(torch.from_numpy(fused_infer.pack_images_s2d(
            _images(size))), packed)
    return [o.numpy() for o in (out if upto is None else (out,))]


@pytest.mark.parametrize("upto", UPTO, ids=[str(u) for u in UPTO])
@pytest.mark.parametrize("size", list(SIZES))
def test_fused_forward_matches_jax(size, upto):
    want = _jax_forward(size, upto)
    got = _port_forward(size, upto)
    assert len(got) == len(want) == (6 if upto is None else 1)
    for g, j in zip(got, want):
        assert g.shape == j.shape
        np.testing.assert_allclose(g, j, rtol=0, atol=ATOL)


def test_fused_forward_matches_detector():
    """The fused forward against the port's Detector (cuDNN-style convs,
    unfolded BN) on the same images, 160×96 and 352²."""
    det = Detector(80, 3)
    det.load_state_dict(_state_dict())
    det.eval()
    for size in SIZES:
        img = _images(size)
        with torch.inference_mode():
            want = det(torch.from_numpy(img).float() / 255.0)
        got = _port_forward(size, None)
        for g, w in zip(got, want):
            assert g.shape == tuple(w.shape)
            np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("kwargs,match", [
    ({"dtype": torch.float16}, "float16"),
])
def test_unported_options_raise(kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        fused_infer.build_fused_forward(_state_dict(), device="cpu",
                                        **kwargs)


def test_forward_rejects_wrong_input():
    fwd, packed = fused_infer.build_fused_forward(
        _state_dict(), input_hw=(160, 96), device="cpu")
    with pytest.raises(ValueError, match="s2d"):
        fwd(torch.zeros(1, 160, 96, 3, dtype=torch.uint8), packed)
    with pytest.raises(ValueError, match="s2d"):
        fwd(torch.zeros(1, 48, 1024, dtype=torch.float32), packed)
