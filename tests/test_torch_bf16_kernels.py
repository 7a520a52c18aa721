"""The bf16 serving path's pieces in the port (fastdet_torch/kernels/
{fold,fused_infer}.py, `dtype=torch.bfloat16`) against the JAX package's
bf16 (`build_fused_forward(dtype=jnp.bfloat16)`) on the CPU, with the real
weights `weights/coco2017-ref.npz` (and the anchor-free family's
`weights/anchorfree-synth.npz` for its neck) and seeded inputs at b2.
The JAX side runs its Pallas kernels in interpret mode, as its own tests
do; the port's bf16 kernels run their plain PyTorch versions, which the
CUDA kernels are held to on the card.

Tolerances:
  * packing: bitwise (the composed span and stride-2 matrices, the stem's
    phase matrix, every other bf16 weight, the f32 biases);
  * one rounding to bf16 after an f32 sum in another order (the stems,
    the nhwc stem, the stride-2 block): within one bf16 ULP of each element
    and equal in ≥ 99% of elements.  The ULP is taken at no less than
    2⁻¹⁰: where a sum cancels to ~1e-7, the f32 sum's own rounding is many
    bf16 ULPs of the result (on the card cuDNN's f32 stem conv reads 20
    such ULPs from the f64 value);
  * a one-block span call: equal in ≥ 99% of elements and within two
    ULPs of each: the block rounds twice (y, then z), and a one-ULP flip
    of y moves the z that reads it (stage 3's first block at 8×16: 4 of
    24,576 elements at two ULPs, the rest within one);
  * several roundings in a row (a 3/7/3-block span or stage, the head
    blocks, the necks): within 2⁻⁶ of the output's max |value| (a one-ULP
    flip early on moves what follows by a few ULPs).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet.io.torch_convert import load_npz_variables
from fastdet.kernels import fused_infer as jfi
from fastdet_torch.io import from_jax_variables
from fastdet_torch.kernels import fold, fused_infer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_NPZ = os.path.join(REPO, "weights", "coco2017-ref.npz")
SYNTH_NPZ = os.path.join(REPO, "weights", "anchorfree-synth.npz")
BF16 = torch.bfloat16
EQUAL_SHARE = 0.99
CHAIN_RTOL = 2.0 ** -6
ULP_FLOOR = 2.0 ** -10      # a ULP is taken at no smaller magnitude
REPS = {sid: r for sid, r, _ in fold.STAGES}
CHANNELS = {sid: c for sid, _, c in fold.STAGES}


@functools.lru_cache(maxsize=None)
def _variables(which="ref"):
    return load_npz_variables(REF_NPZ if which == "ref" else SYNTH_NPZ)


@functools.lru_cache(maxsize=None)
def _jax_packed(which="ref", hw=(64, 96), input_format="s2d8_u8"):
    _, packed = jfi.build_fused_forward(
        jax.tree.map(jnp.asarray, _variables(which)), input_hw=hw,
        dtype=jnp.bfloat16, interpret=True, input_format=input_format,
        head="yolo" if which == "ref" else "anchorfree")
    return packed


@functools.lru_cache(maxsize=None)
def _port_packed(which="ref"):
    _, packed = fused_infer.build_fused_forward(
        from_jax_variables(_variables(which)), input_hw=(64, 96),
        dtype=BF16, head="yolo" if which == "ref" else "anchorfree",
        device="cpu")
    return packed


def _bits(a) -> np.ndarray:
    """bf16 values (jax, torch or numpy f32 that are bf16) → uint16 bits."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a, jnp.bfloat16).view(np.uint16)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def assert_within_one_ulp(got, want, ulps=1):
    """Each element within `ulps` bf16 ULPs of `want`'s, ≥ 99% equal."""
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape
    mag = np.maximum(np.abs(g), np.abs(w))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, ULP_FLOOR))) - 7)
    assert (np.abs(g - w) <= ulps * ulp).all(), float(
        (np.abs(g - w) / ulp).max())
    assert (g == w).mean() >= EQUAL_SHARE, float((g == w).mean())


def assert_chain_close(got, want, rtol=CHAIN_RTOL):
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape
    err = float(np.abs(g - w).max())
    assert err <= rtol * float(np.abs(w).max()), err


# ---------------------------------------------------------------- packing

def test_bf16_rounding_matches_jax_and_torch():
    a = np.random.default_rng(0).normal(0.0, 3.0, 4096).astype(np.float32)
    a[:6] = [0.0, 1.00390625, 1.01171875, -2.0078125, 1e-40, 65504.0]
    want = _bits(jnp.asarray(a, jnp.bfloat16))
    np.testing.assert_array_equal(fold.to_bf16_bits(a), want)
    np.testing.assert_array_equal(_bits(torch.from_numpy(a).to(BF16)), want)


@pytest.mark.parametrize("n,k", [(24, 24), (48, 48), (96, 96), (24, 216),
                                 (48, 432), (96, 864)])
def test_mma_fragments_roundtrip(n, k):
    w = np.random.default_rng(n + k).integers(0, 65535, (n, k)).astype(
        np.uint16)
    frag = fold.mma_fragments(w)
    assert frag.shape == (fold._pad16(k) * n,)
    np.testing.assert_array_equal(fold.unpack_mma_fragments(frag, n, k), w)
    # lane (g, t) of k-step s and n-tile j holds W[8j + g, 16s + 2t + e]
    f = frag.reshape(-1, n // 8, 32, 4)
    assert f[0, 0, 5, 0] == w[1, 2] and f[0, 0, 5, 3] == w[1, 11]
    assert f[1, 1, 0, 1] == w[8, 17]


@pytest.mark.parametrize("stage", [2, 3, 4])
def test_span16_weights_equal_jax_composed_bitwise(stage):
    """Each span block's bf16 pw1 and composed Wc equal the JAX package's
    bf16 `wa` (its top half: pw1 on the odd columns, 0 on the even, whose
    columns the packing permutes to block k's slots `fold.span16_slots`;
    the bottom half the passthrough selection) and `wc`, bit for bit; the
    f32 biases `ba`, `bc` too."""
    jp, pp = _jax_packed(), _port_packed()
    c = CHANNELS[stage]
    mid = c // 2
    w, b = pp[f"s{stage}_span16"], pp[f"s{stage}_span16_b"]
    assert w.dtype == BF16 and b.dtype == torch.float32
    assert tuple(w.shape) == (REPS[stage] - 1, fold.span16_elems(mid))
    k1 = c * mid
    for i in range(1, REPS[stage]):
        wa, wc = _bits(jp[f"s{stage}_{i}_wa"]), _bits(jp[f"s{stage}_{i}_wc"])
        row = _bits(w[i - 1])
        w1, wc_got = fold.unpack_span16(row, mid, i - 1)
        np.testing.assert_array_equal(w1, wa[:mid])
        slots = fold.span16_slots(mid, i - 1)
        np.testing.assert_array_equal(
            fold.unpack_mma_fragments(row[:k1], mid, c)[:, slots], wa[:mid])
        assert sorted(slots) == list(range(c))
        assert not wa[:mid, 0::2].any()
        sel = np.zeros((mid, c), np.float32)
        sel[np.arange(mid), np.arange(0, c, 2)] = 1.0
        np.testing.assert_array_equal(wa[mid:], _bits(sel))
        np.testing.assert_array_equal(wc_got, wc)
        np.testing.assert_array_equal(
            fold.unpack_mma_fragments(row[k1:], mid, 9 * mid), wc)
        ba, bc = (np.asarray(jp[f"s{stage}_{i}_{k}"]) for k in ("ba", "bc"))
        assert ba.dtype == bc.dtype == np.float32
        assert not ba[mid:].any()
        np.testing.assert_array_equal(b[i - 1].numpy(),
                                      np.concatenate([ba[:mid], bc]))


@pytest.mark.parametrize("stage", [2, 3, 4])
def test_s2_16_weights_equal_jax_fused_bitwise(stage):
    """The bf16 stride-2 block's pw1, Wc and Wp equal the JAX package's
    `s{n}_0f_*` (the block-diagonal `wa`'s four blocks all pw1, the rest
    0), bit for bit; its f32 biases too."""
    jp, pp = _jax_packed(), _port_packed()
    cin = mid = CHANNELS[stage] // 2
    w, b = _bits(pp[f"s{stage}_s2_16"]), pp[f"s{stage}_s2_16_b"].numpy()
    assert w.shape == (fold.s2_16_elems(cin, mid),)
    k1, kc = fold._pad16(cin) * mid, fold._pad16(9 * mid) * mid
    wa = _bits(jp[f"s{stage}_0f_wa"])
    w1 = fold.unpack_mma_fragments(w[:k1], mid, cin)
    blk = np.zeros_like(wa)
    for p in range(4):
        blk[p * mid:(p + 1) * mid, p * cin:(p + 1) * cin] = w1
    np.testing.assert_array_equal(blk, wa)
    np.testing.assert_array_equal(
        fold.unpack_mma_fragments(w[k1:k1 + kc], mid, 9 * mid),
        _bits(jp[f"s{stage}_0f_wc"]))
    np.testing.assert_array_equal(
        fold.unpack_mma_fragments(w[k1 + kc:], mid, 9 * cin),
        _bits(jp[f"s{stage}_0f_wp"]))
    ba, bc, bp = (np.asarray(jp[f"s{stage}_0f_{k}"]) for k in
                  ("ba", "bc", "bp"))
    np.testing.assert_array_equal(ba, np.tile(ba[:mid], 4))
    np.testing.assert_array_equal(b, np.concatenate([ba[:mid], bc, bp]))


def test_stem16_weights_equal_jax_phase_matrices_bitwise():
    """The bf16 stem weight (/255 folded in, cast once) rebuilt into the
    JAX package's (192, 96) and (768, 384) phase matrices with scale 1 is
    its bf16 `stem_w96` and `stem_w768`, bit for bit; the nhwc stem's
    unscaled bf16 weight is its `stem_w`."""
    jp, pp = _jax_packed(), _port_packed()
    w16, bias = pp["stem_w"], pp["stem_b"]
    assert w16.dtype == BF16 and bias.dtype == torch.float32
    w = w16.float().numpy()
    w96, b96 = jfi.pack_stem_s2d(w, bias.numpy(), scale=1.0)
    w768, b384 = jfi.pack_stem_s2d8(w, bias.numpy(), scale=1.0)
    np.testing.assert_array_equal(_bits(w96), _bits(jp["stem_w96"]))
    np.testing.assert_array_equal(_bits(w768), _bits(jp["stem_w768"]))
    np.testing.assert_array_equal(b96, np.asarray(jp["stem_b96"]))
    np.testing.assert_array_equal(b384, np.asarray(jp["stem_b384"]))
    np.testing.assert_array_equal(
        _bits(pp["stem_conv_w"].permute(2, 3, 1, 0)), _bits(jp["stem_w"]))


@pytest.mark.parametrize("which", ["ref", "synth"])
def test_other_bf16_weights_equal_jax_bitwise(which):
    """Every weight the bf16 forward takes from PyTorch's side (stride-2
    blocks, neck, heads) is the JAX package's bf16 array in OIHW, and
    every bias its f32 array."""
    jp, pp = _jax_packed(which), _port_packed(which)
    keys = [k for k in pp if k in jp and not k.startswith("stem_")]
    assert len(keys) > 40
    for k in keys:
        j, t = jp[k], pp[k]
        if j.ndim == 1:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            continue
        assert t.dtype == BF16, k
        jt = np.asarray(j).view(np.uint16)
        jt = jt.T[:, :, None, None] if jt.ndim == 2 else (
            jt.transpose(2, 0, 1)[:, None])
        np.testing.assert_array_equal(_bits(t), jt, err_msg=k)


# ---------------------------------------------------------------- kernels

def _stem_inputs(hw, factor, seed=0):
    """Seeded uint8 images packed s2d(factor), junk in the pad lanes."""
    rng = np.random.default_rng(seed + hw[0])
    img = rng.integers(0, 256, (2,) + hw + (3,), dtype=np.uint8)
    pack = (fused_infer.pack_images_s2d if factor == 4
            else fused_infer.pack_images_s2d8)
    xs = pack(img)
    n = (hw[0] // factor) * (hw[1] // factor)
    xs[:, :, n:] = rng.integers(0, 256, xs[:, :, n:].shape)
    return xs


@pytest.mark.parametrize("hw", [(128, 128), (160, 96)])
def test_stem_s2d_bf16_matches_jax_stem_call(hw):
    jp, pp = _jax_packed(), _port_packed()
    h4, w4 = hw[0] // 4, hw[1] // 4
    xs = _stem_inputs(hw, 4)
    want = jfi._stem_call(jnp.asarray(xs), jp["stem_w96"], jp["stem_b96"],
                          h4, w4, jnp.bfloat16, True)[:, :, :h4 * w4]
    before = fused_infer.stem_s2d_bf16.launches
    got = fused_infer.stem_s2d_bf16(torch.from_numpy(xs), pp["stem_w"],
                                    pp["stem_b"], h4, w4)
    assert fused_infer.stem_s2d_bf16.launches == before   # CPU: no kernel
    assert got.dtype == BF16 and tuple(got.shape) == (2, 24, h4, w4)
    assert_within_one_ulp(got.reshape(2, 24, -1), want)


def test_stem_s2d_bf16_matches_jax_stem_call_chunked(monkeypatch):
    """B6: the JAX package's row-chunked stem, forced into four chunks of
    8 rows at 128² (its lane budget cut to 9 rows), against the same
    plain stem."""
    jp, pp = _jax_packed(), _port_packed()
    monkeypatch.setattr(jfi, "_STEM_LANE_BUDGET", 9 * 32)
    assert jfi._stem_chunk_rows(32, 32) == 8
    xs = _stem_inputs((128, 128), 4, seed=1)
    want = jfi._stem_call_chunked(jnp.asarray(xs), jp["stem_w96"],
                                  jp["stem_b96"], 32, 32, jnp.bfloat16, True)
    got = fused_infer.stem_s2d_bf16(torch.from_numpy(xs), pp["stem_w"],
                                    pp["stem_b"], 32, 32)
    assert_within_one_ulp(got.reshape(2, 24, -1), want)


@pytest.mark.parametrize("hw", [(128, 128), (160, 96)])
def test_stem_s2d8_bf16_matches_jax_stem8_call(hw):
    jp, pp = _jax_packed(), _port_packed()
    h8, w8 = hw[0] // 8, hw[1] // 8
    xs = _stem_inputs(hw, 8)
    out = np.asarray(jfi._stem8_call(
        jnp.asarray(xs), jp["stem_w768"], jp["stem_b384"], h8, w8,
        jnp.bfloat16, True), np.float32)[:, :, :h8 * w8]
    want = out.reshape(2, 2, 2, 24, h8, w8).transpose(0, 3, 4, 1, 5, 2)
    got = fused_infer.stem_s2d8_bf16(torch.from_numpy(xs), pp["stem_w"],
                                     pp["stem_b"], h8, w8)
    assert got.dtype == BF16
    assert_within_one_ulp(got, want.reshape(2, 24, 2 * h8, 2 * w8))


def _act(seed, shape):
    """A seeded bf16 activation (≥ 0, as ReLU outputs are)."""
    x = np.abs(np.random.default_rng(seed).normal(0.0, 1.0, shape))
    return torch.from_numpy(x.astype(np.float32)).to(BF16)


def _lanes(x, nimg):
    """(B, C, h, w) → the TPU kernels' (B, C, nimg) lanes, junk in the
    pad."""
    b, c, h, w = x.shape
    out = np.random.default_rng(7).normal(0.0, 5.0, (b, c, nimg))
    out = out.astype(np.float32)
    out[:, :, :h * w] = x.float().reshape(b, c, h * w).numpy()
    return jnp.asarray(out, jnp.bfloat16)


@pytest.mark.parametrize("stage", [2, 3, 4])
@pytest.mark.parametrize("nblk", ["one", "all"])
def test_span_bf16_matches_jax_span_call(stage, nblk):
    """At 8×16 (128 lanes) for one block, and 5×7 (93 pad lanes of junk)
    for the stage's 3/7/3 blocks."""
    jp, pp = _jax_packed(), _port_packed()
    c = CHANNELS[stage]
    n = 1 if nblk == "one" else REPS[stage] - 1
    h, w = (8, 16) if nblk == "one" else (5, 7)
    x = _act(stage * 10 + n, (2, c, h, w))
    ws = [jp[f"s{stage}_{i}_{nm}"] for i in range(1, n + 1)
          for nm in ("wa", "ba", "wc", "bc")]
    want = np.asarray(jfi._span_call(_lanes(x, 128), ws, n, h, w, 128, c,
                                     jnp.bfloat16, True),
                      np.float32)[:, :, :h * w].reshape(2, c, h, w)
    before = fused_infer.span_bf16.launches
    got = fused_infer.span_bf16(x, pp[f"s{stage}_span16"][:n],
                                pp[f"s{stage}_span16_b"][:n], n)
    assert fused_infer.span_bf16.launches == before       # CPU: no kernel
    assert got.dtype == BF16
    if n == 1:
        assert_within_one_ulp(got, want, ulps=2)
    else:
        assert_chain_close(got, want)


@pytest.mark.parametrize("stage", [2, 3, 4])
@pytest.mark.parametrize("nblk", ["s2_only", "all"])
def test_s2span_bf16_matches_jax_s2span_call(stage, nblk):
    """The stride-2 block alone (8×16 output) and the whole stage (5×7
    output, junk in the pad lanes) on a phase-packed input."""
    jp, pp = _jax_packed(), _port_packed()
    c = CHANNELS[stage]
    cin = c // 2
    n = 0 if nblk == "s2_only" else REPS[stage] - 1
    h, w = (8, 16) if n == 0 else (5, 7)
    x = _act(stage * 100 + n, (2, cin, 2 * h, 2 * w))
    xp = x.float().reshape(2, cin, h, 2, w, 2).permute(0, 3, 5, 1, 2, 4)
    xp = _lanes(xp.reshape(2, 4 * cin, h, w).to(BF16), 128)
    ws = ([jp[f"s{stage}_0f_{nm}"]
           for nm in ("wa", "ba", "wc", "bc", "wp", "bp")]
          + [jp[f"s{stage}_{i}_{nm}"] for i in range(1, n + 1)
             for nm in ("wa", "ba", "wc", "bc")])
    want = np.asarray(jfi._s2span_call(xp, ws, n, h, w, 128, cin, c,
                                       jnp.bfloat16, True),
                      np.float32)[:, :, :h * w].reshape(2, c, h, w)
    before = fused_infer.s2span_bf16.launches
    got = fused_infer.s2span_bf16(
        x, pp[f"s{stage}_s2_16"], pp[f"s{stage}_s2_16_b"],
        pp[f"s{stage}_span16"][:n], pp[f"s{stage}_span16_b"][:n], n)
    assert fused_infer.s2span_bf16.launches == before     # CPU: no kernel
    assert got.dtype == BF16
    if n == 0:
        assert_within_one_ulp(got, want)
    else:
        assert_chain_close(got, want)


@pytest.mark.parametrize("b,c,h,w", [(128, 48, 44, 44), (128, 96, 22, 22),
                                     (128, 192, 11, 11), (32, 48, 80, 80),
                                     (1, 192, 20, 20), (2, 96, 15, 13)])
def test_span16_plan(b, c, h, w):
    """The bf16 stage kernel's launch plan: one launch a stage call (the
    stride-2 block its prologue), a cluster of ≤ 8 CTAs an image whose
    bands cover the image once, each CTA's shared memory within the
    card's and equal to the layout's (`span16_smem`)."""
    mid = c // 2
    for stride2 in (False, True):
        win = 2 * w if stride2 else 0
        plan = fused_infer.span16_plan(b, c, h, w, 3, stride2, win)
        assert plan.variant == "stage" and plan.launches == 1
        assert 1 <= plan.cluster <= 8 and plan.bands == plan.cluster
        assert plan.ctas == b * plan.cluster
        bands = plan.band_rows(h)
        assert all(n >= 1 for _, n in bands) and sum(n for _, n in bands) == h
        assert plan.halo == (1 if plan.cluster > 1 else 0)
        assert plan.smem_bytes <= fused_infer.SMEM_PER_CTA == 232448
        assert plan.smem_bytes == fused_infer.span16_smem(
            mid, plan.rows, w, plan.halo, stride2, win, plan.orows)
        assert (plan.orows >= 1) == stride2


def test_bf16_wrappers_refuse_other_devices():
    for fn, args in ((fused_infer.span_bf16, (None, None, 1)),
                     (fused_infer.stem_s2d_bf16, (None, None, 4, 4))):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(torch.zeros(1, 48, 4, 4, device="meta"), *args)


# ------------------------------------------------- the parts XLA computes

def _nhwc(x):
    return jnp.asarray(x.float().permute(0, 2, 3, 1).numpy(), jnp.bfloat16)


def _nchw(a):
    return np.asarray(a, np.float32).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("stage", [2, 3, 4])
def test_s2_block_bf16_matches_jax(stage):
    jp, pp = _jax_packed(), _port_packed()
    cin, c = CHANNELS[stage] // 2, CHANNELS[stage]
    x = _act(stage, (2, cin, 16, 12))
    want = jfi._s2_block_xla(_nhwc(x), jp, f"s{stage}_0", cin, c,
                             jnp.bfloat16)
    got = fused_infer._s2_block_bf16(x, pp, f"s{stage}_0")
    assert got.dtype == BF16
    assert_within_one_ulp(got, _nchw(want))


@pytest.mark.parametrize("head", ["cls_head_2", "reg_head_3"])
def test_dwcb_bf16_matches_jax(head):
    jp, pp = _jax_packed(), _port_packed()
    x = _act(5, (2, 72, 8, 12))
    want = jfi._dwcb_xla(_nhwc(x), jp, head, jnp.bfloat16)
    got = fused_infer._dwcb_bf16(x, pp, head)
    assert got.dtype == BF16
    assert_chain_close(got, _nchw(want))


def test_fpn_bf16_matches_jax():
    jp, pp = _jax_packed(), _port_packed()
    c2, c3 = _act(2, (2, 96, 8, 12)), _act(3, (2, 192, 4, 6))
    want = jfi._fpn_xla(_nhwc(c2), _nhwc(c3), jp, jnp.bfloat16)
    got = fused_infer._fpn_bf16(c2, c3, pp)
    assert len(got) == len(want) == 6
    for g, j in zip(got, want):
        assert g.dtype == torch.float32 and j.dtype == jnp.float32
        assert_chain_close(g, j)


def test_af_neck_bf16_matches_jax():
    jp, pp = _jax_packed("synth"), _port_packed("synth")
    c2, c3 = _act(4, (2, 96, 8, 8)), _act(5, (2, 192, 4, 4))
    want = jfi._af_neck_xla(_nhwc(c2), _nhwc(c3), jp, jnp.bfloat16)
    got = fused_infer._af_neck_bf16(c2, c3, pp)
    assert len(got) == len(want) == 3
    for g, j in zip(got, want):
        assert g.dtype == torch.float32
        assert_chain_close(g, j)


def test_nhwc_stem_bf16_matches_jax():
    """The XLA stem from NHWC (a bf16 division by 255, bf16(stem_w), the
    conv rounded before the bias), and the division alone over all 256
    values."""
    u8 = np.arange(256, dtype=np.uint8)
    want = np.asarray(jnp.asarray(u8).astype(jnp.bfloat16)
                      / jnp.asarray(255.0, jnp.bfloat16))
    got = (torch.from_numpy(u8).float() / 255.0).to(BF16)
    np.testing.assert_array_equal(_bits(got), want.view(np.uint16))
    img = np.random.default_rng(3).integers(0, 256, (2, 64, 96, 3),
                                            dtype=np.uint8)
    jfwd, jpk = jfi.build_fused_forward(
        jax.tree.map(jnp.asarray, _variables()), input_hw=(64, 96),
        dtype=jnp.bfloat16, interpret=True, input_format="nhwc",
        upto="stem")
    fwd, pk = fused_infer.build_fused_forward(
        from_jax_variables(_variables()), input_hw=(64, 96), dtype=BF16,
        input_format="nhwc", upto="stem", device="cpu")
    out = fwd(torch.from_numpy(img), pk)
    assert out.dtype == BF16
    assert_within_one_ulp(out, np.asarray(jfwd(jnp.asarray(img), jpk)))
