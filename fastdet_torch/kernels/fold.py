"""BN folding and weight packing for the fused inference path (the port's
own copy of fastdet/kernels/fold.py, reading the port's ``state_dict``).

Every Conv+BN pair folds into one affine conv, W' = W·γ/√(σ²+ε) and
b' = β − μ·γ/√(σ²+ε), ε = 1e-5, computed in numpy f32 in the JAX
package's operation order, so that each folded array equals the JAX one
bit for bit.  Layouts are the JAX package's: pointwise convs as
(Cin, Cout), depthwise as (kh, kw, C), the stem as HWIO (3, 3, 3, 24).

The differences are the blocks' kernel forms.  The TPU span kernel takes
a merged (C, C) first matrix (odd-channel select ∘ pw1, with the even
passthrough below) and dw3×3 composed with pw2 into one (C/2, 9·C/2)
matrix, shapes that feed its matrix unit; its stride-2 prologue
(`pack_s2_block_fused` of the JAX package) takes pw1 as a block-diagonal
(4·mid, 4·cin) matrix over four phases and both dw3×3 s2 ∘ pw pairs
composed.  The CUDA kernels run every conv apart, so the folded convs
stay apart: `pack_span_weights` packs `pack_s1_block`'s w1, b1, wd, bd,
w2, b2 into the span kernel's rows, and `pack_s2span_weights` packs
`pack_s2_block`'s ten arrays, followed by those rows, into the stage
kernel's one flat row.

`pack_fused_weights` packs the Yolo-FastestV2 heads, `pack_fused_weights_af`
the anchor-free family's (`models/anchorfree.py`) over the same backbone.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

_EPS = 1e-5

# (stage, repeats, channels); block 0 of each stage is stride 2
STAGES = ((2, 4, 48), (3, 8, 96), (4, 4, 192))


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), np.float32)


def _fold(sd, prefix: str) -> Tuple[np.ndarray, np.ndarray]:
    """ConvBN `prefix` of a state dict → (folded HWIO kernel, bias)."""
    w = np.ascontiguousarray(                            # OIHW → HWIO
        _np(sd[f"{prefix}.conv.weight"]).transpose(2, 3, 1, 0))
    gamma = _np(sd[f"{prefix}.bn.weight"])
    beta = _np(sd[f"{prefix}.bn.bias"])
    mean = _np(sd[f"{prefix}.bn.running_mean"])
    var = _np(sd[f"{prefix}.bn.running_var"])
    s = gamma / np.sqrt(var + _EPS)
    return w * s, beta - mean * s


def _fold_pw(sd, prefix: str) -> Tuple[np.ndarray, np.ndarray]:
    w, b = _fold(sd, prefix)             # (1,1,Cin,Cout)
    return w[0, 0], b                    # (Cin, Cout)


def _fold_dw(sd, prefix: str) -> Tuple[np.ndarray, np.ndarray]:
    w, b = _fold(sd, prefix)             # (kh,kw,1,C)
    return w[:, :, 0, :], b              # (kh,kw,C)


def pack_s1_block(sd, prefix: str) -> Dict[str, np.ndarray]:
    """Stride-1 ShuffleV2 block: the main branch's three folded convs.
    pw1 reads the odd input channels; the block's output is
    concat[even input channels, main]."""
    w1, b1 = _fold_pw(sd, f"{prefix}.main_pw")               # (mid, mid)
    wd, bd = _fold_dw(sd, f"{prefix}.main_dw")               # (3,3,mid)
    w2, b2 = _fold_pw(sd, f"{prefix}.main_pw_linear")        # (mid, mid)
    return {"w1": w1, "b1": b1, "wd": wd, "bd": bd, "w2": w2, "b2": b2}


def pack_s2_block(sd, prefix: str) -> Dict[str, np.ndarray]:
    """Stride-2 ShuffleV2 block (runs in PyTorch, as the JAX package runs
    it in XLA)."""
    w1, b1 = _fold_pw(sd, f"{prefix}.main_pw")
    wd, bd = _fold_dw(sd, f"{prefix}.main_dw")
    w2, b2 = _fold_pw(sd, f"{prefix}.main_pw_linear")
    wpd, bpd = _fold_dw(sd, f"{prefix}.proj_dw")
    wpp, bpp = _fold_pw(sd, f"{prefix}.proj_pw")
    return {"w1": w1, "b1": b1, "wd": wd, "bd": bd, "w2": w2, "b2": b2,
            "wpd": wpd, "bpd": bpd, "wpp": wpp, "bpp": bpp}


def pack_span_weights(blocks) -> np.ndarray:
    """Per-block dicts of `pack_s1_block` → the span kernel's
    (nblk, 2·mid² + 12·mid) f32 rows [w1 | b1 | wd (tap-major 9×mid) | bd |
    w2 | b2]."""
    rows = []
    for p in blocks:
        mid = p["b1"].shape[0]
        rows.append(np.concatenate([
            p["w1"].ravel(), p["b1"], p["wd"].reshape(9, mid).ravel(),
            p["bd"], p["w2"].ravel(), p["b2"]]).astype(np.float32))
    return np.stack(rows)


S2_ROW_KEYS = ("w1", "b1", "wd", "bd", "w2", "b2", "wpd", "bpd", "wpp", "bpp")


def pack_s2span_weights(s2_block, s1_blocks) -> np.ndarray:
    """One stage in the stage kernel's form: `pack_s2_block`'s dict and the
    stage's `pack_s1_block` dicts → one flat f32 row, the stride-2 block's
    3·M² + 23·M floats [w1 (cin×mid) | b1 | wd (tap-major 9×mid) | bd |
    w2 (mid×mid) | b2 | wpd (tap-major 9×cin) | bpd | wpp (cin×mid) | bpp]
    (cin = mid = M at every stage), then the span rows of
    `pack_span_weights`."""
    head = np.concatenate([np.asarray(s2_block[k], np.float32).ravel()
                           for k in S2_ROW_KEYS])
    return np.concatenate([head, pack_span_weights(s1_blocks).ravel()])


def pack_dwconvblock(sd, prefix: str) -> Dict[str, np.ndarray]:
    """Head DWConvBlock: dw5 + pw + dw5 + pw (second pw without ReLU)."""
    out = {}
    for name in ("dw1", "pw1", "dw2", "pw2"):
        fold = _fold_dw if name.startswith("dw") else _fold_pw
        w, b = fold(sd, f"{prefix}.{name}")
        out[f"{name}_w"] = w
        out[f"{name}_b"] = b
    return out


def pack_convbn_pw(sd, prefix: str) -> Dict[str, np.ndarray]:
    w, b = _fold_pw(sd, prefix)
    return {"w": w, "b": b}


def pack_head_conv(sd, prefix: str) -> Dict[str, np.ndarray]:
    """Plain 1×1 conv with bias (the detector's output heads, no BN)."""
    return {"w": _np(sd[f"{prefix}.weight"])[:, :, 0, 0].T.copy(),
            "b": _np(sd[f"{prefix}.bias"])}


def _pack_backbone(packed: Dict[str, np.ndarray], sd) -> None:
    """Stem, stride-2 blocks and stride-1 spans of the ShuffleNetV2
    backbone."""
    w, b = _fold(sd, "backbone.first_conv")
    packed["stem_w"] = w
    packed["stem_b"] = b
    for stage, reps, _ in STAGES:
        for k, v in pack_s2_block(sd, f"backbone.stage{stage}_0").items():
            packed[f"s{stage}_0_{k}"] = v
        for i in range(1, reps):
            blk = pack_s1_block(sd, f"backbone.stage{stage}_{i}")
            for k, v in blk.items():
                packed[f"s{stage}_{i}_{k}"] = v


def pack_fused_weights(sd) -> Dict[str, np.ndarray]:
    """Everything the fused yolo forward needs from the port's state dict
    (`fastdet_torch.io.load_state_dict`), as a flat dict of numpy f32
    arrays."""
    packed: Dict[str, np.ndarray] = {}
    _pack_backbone(packed, sd)
    for name in ("conv1x1_2", "conv1x1_3"):
        pw = pack_convbn_pw(sd, f"fpn.{name}")
        packed[f"{name}_w"] = pw["w"]
        packed[f"{name}_b"] = pw["b"]
    for head in ("cls_head_2", "reg_head_2", "cls_head_3", "reg_head_3"):
        for k, v in pack_dwconvblock(sd, f"fpn.{head}").items():
            packed[f"{head}_{k}"] = v
    for out in ("output_reg", "output_obj", "output_cls"):
        hc = pack_head_conv(sd, out)
        packed[f"{out}_w"] = hc["w"]
        packed[f"{out}_b"] = hc["b"]
    return packed


def pack_fused_weights_af(sd) -> Dict[str, np.ndarray]:
    """The anchor-free family (`models/anchorfree.py`): the same backbone,
    then the single-scale `fuse` ConvBN, the decoupled `head_cls` /
    `head_reg` DWConvBlocks and the three 1×1 output convs with bias."""
    packed: Dict[str, np.ndarray] = {}
    _pack_backbone(packed, sd)
    pw = pack_convbn_pw(sd, "fuse")
    packed["fuse_w"] = pw["w"]
    packed["fuse_b"] = pw["b"]
    for head in ("head_cls", "head_reg"):
        for k, v in pack_dwconvblock(sd, head).items():
            packed[f"{head}_{k}"] = v
    for out in ("out_obj", "out_cls", "out_reg"):
        hc = pack_head_conv(sd, out)
        packed[f"{out}_w"] = hc["w"]
        packed[f"{out}_b"] = hc["b"]
    return packed


# ------------------------------------------------------------------ bf16
#
# The JAX package's bf16 serving casts every packed array with ndim > 1 to
# bf16 (round to nearest even) and keeps every bias f32.  Its span and
# stride-2 blocks run in the composed forms below, and bf16 of a composed
# matrix is not the product of bf16 factors, so the bf16 path packs these
# forms (the f32 path keeps its split convs above).  Each function is the
# port's copy of the JAX package's expression, operation for operation,
# so that the f32 matrices, and with them their bf16 casts, are equal bit
# for bit.

def _sel_odd(c: int) -> np.ndarray:
    s = np.zeros((c, c // 2), np.float32)
    s[np.arange(1, c, 2), np.arange(c // 2)] = 1.0
    return s


def compose_s1_block(blk: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """`pack_s1_block`'s dict → the composed stride-1 block: `wa` (C, C),
    odd-channel select ∘ pw1 on top and the even passthrough below, `ba`,
    `wc` (mid, 9·mid) = dw3×3 composed with pw2 (tap-major K,
    wc[j, t·mid + c] = pw2[c, j]·dw_t[c]) and `bc` (the JAX package's
    `pack_s1_block`)."""
    w1, b1, wd, bd, w2, b2 = (blk[k] for k in
                              ("w1", "b1", "wd", "bd", "w2", "b2"))
    mid = b1.shape[0]
    c = 2 * mid
    w1 = _sel_odd(c) @ w1
    sel_even = np.zeros((mid, c), np.float32)
    sel_even[np.arange(mid), np.arange(0, c, 2)] = 1.0
    wa = np.concatenate([w1.T, sel_even], 0)
    ba = np.concatenate([b1, np.zeros(mid, np.float32)])
    wc = np.zeros((mid, 9 * mid), np.float32)
    for t in range(9):
        dy, dx = t // 3, t % 3
        wc[:, t * mid:(t + 1) * mid] = w2.T * wd[dy, dx][None, :]
    bc = w2.T @ bd + b2
    return {"wa": wa, "ba": ba, "wc": wc, "bc": bc}


def compose_s2_block(blk: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """`pack_s2_block`'s dict → the composed stride-2 block of the JAX
    package's `pack_s2_block_fused`: `wa` (4·mid, 4·cin) block-diagonal pw1
    over the four input phases, `ba`, `wc` (mid, 9·mid) = dw3×3 s2 ∘ pw2,
    `bc`, `wp` (mid, 9·cin) = proj dw3×3 s2 ∘ proj pw, `bp`."""
    w1, b1, wd, bd, w2, b2, wpd, bpd, wpp, bpp = (blk[k] for k in S2_ROW_KEYS)
    cin, mid = w1.shape
    wa_blk = np.zeros((4 * mid, 4 * cin), np.float32)
    for p in range(4):
        wa_blk[p * mid:(p + 1) * mid, p * cin:(p + 1) * cin] = w1.T
    ba_blk = np.tile(b1, 4)
    wc = np.zeros((mid, 9 * mid), np.float32)
    wp = np.zeros((mid, 9 * cin), np.float32)
    for t in range(9):
        dy, dx = t // 3 - 1, t % 3 - 1
        wc[:, t * mid:(t + 1) * mid] = w2.T * wd[dy + 1, dx + 1][None, :]
        wp[:, t * cin:(t + 1) * cin] = wpp.T * wpd[dy + 1, dx + 1][None, :]
    bc = w2.T @ bd + b2
    bp = wpp.T @ bpd + bpp
    return {"wa": wa_blk, "ba": ba_blk, "wc": wc, "bc": bc,
            "wp": wp, "bp": bp}


def to_bf16_bits(a: np.ndarray) -> np.ndarray:
    """f32 array → its bf16 values as uint16 bit patterns, rounded to
    nearest even (as `jnp.asarray(a, jnp.bfloat16)` and torch's casts
    round; no value here is NaN)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = u + 0x7FFF + ((u >> 16) & 1)
    return (u >> 16).astype(np.uint16)


def mma_fragment_index(n: int, k: int) -> np.ndarray:
    """Where each element of the bf16 stage kernel's B operand comes from:
    an (N, K) matrix W (rows the output channels) padded with zero columns
    to Kp = pad16(K), laid out as the lanes of `mma.sync.m16n8k16` take it,
    [Kp/16][N/8][32 lanes][4]: lane (g, t) = (lane / 4, lane % 4) of k-step
    s and n-tile j holds W[8j + g, 16s + 2t + (0, 1, 8, 9)], so one 8-byte
    load gives its two B registers.  → flat indices into the padded
    (N, Kp) matrix, in that order."""
    kp = (k + 15) // 16 * 16
    s, j, lane, e = np.meshgrid(np.arange(kp // 16), np.arange(n // 8),
                                np.arange(32), np.arange(4), indexing="ij")
    row = 8 * j + lane // 4
    col = 16 * s + 2 * (lane % 4) + (e & 1) + 8 * (e >> 1)
    return (row * kp + col).ravel()


def mma_fragments(w_bits: np.ndarray) -> np.ndarray:
    """(N, K) uint16 bf16 bits → the kernel's flat fragment order of
    `mma_fragment_index` (zero where K is padded)."""
    n, k = w_bits.shape
    kp = (k + 15) // 16 * 16
    wp = np.zeros((n, kp), np.uint16)
    wp[:, :k] = w_bits
    return wp.ravel()[mma_fragment_index(n, k)]


def unpack_mma_fragments(frag: np.ndarray, n: int, k: int) -> np.ndarray:
    """The inverse of `mma_fragments`: → the (N, K) matrix."""
    kp = (k + 15) // 16 * 16
    out = np.zeros(n * kp, frag.dtype)
    out[mma_fragment_index(n, k)] = frag
    return out.reshape(n, kp)[:, :k]


def _pad16(n: int) -> int:
    return (n + 15) // 16 * 16


def span16_elems(mid: int) -> int:
    """bf16 elements of one block of the bf16 span (`pack_span16`): pw1
    over the block's 2·mid slots, then the composed `wc`."""
    return (2 * mid + _pad16(9 * mid)) * mid


def span16_slots(mid: int, k: int) -> np.ndarray:
    """The bf16 stage kernel's slot of each logical channel before span
    block k: (2·mid,) int, P_0 the identity, then P_{k+1}[j] = P_k[2j]
    (the passthrough never moves) and P_{k+1}[mid + r] = P_k[2r + 1] (z_r
    is written where pw1's input channel 2r + 1 was)."""
    p = np.arange(2 * mid)
    for _ in range(k):
        p = np.concatenate([p[0::2], p[1::2]])
    return p


def s2_16_elems(cin: int, mid: int) -> int:
    """bf16 elements of a bf16 stride-2 block (`pack_s2_16`)."""
    return (_pad16(cin) + _pad16(9 * mid) + _pad16(9 * cin)) * mid


def pack_span16(blocks) -> Tuple[np.ndarray, np.ndarray]:
    """`pack_s1_block` dicts of one stage → the bf16 span kernel's weights:
    (nblk, span16_elems) uint16 bf16 bits, per block k pw1 (mid_out × 2·mid
    slots: the bf16 of the composed `wa`'s top half, whose even columns
    are 0, with its columns permuted to the kernel's slots,
    `w1[:, span16_slots(mid, k)] = wa[:mid]`) then the composed `wc`, each
    in `mma_fragments` order; and (nblk, 2·mid) f32 biases [ba top half |
    bc].  `unpack_span16` gives back the JAX package's matrices."""
    ws, bs = [], []
    for k, blk in enumerate(blocks):
        comp = compose_s1_block(blk)
        mid = blk["b1"].shape[0]
        ws.append(span16_row(comp["wa"][:mid], comp["wc"], k))
        bs.append(np.concatenate([comp["ba"][:mid], comp["bc"]]))
    return np.stack(ws), np.stack(bs).astype(np.float32)


def span16_row(wa_top: np.ndarray, wc: np.ndarray, k: int) -> np.ndarray:
    """Block k's row of `pack_span16` from its composed f32 matrices
    `wa`[:mid] (mid × 2·mid) and `wc` (mid × 9·mid)."""
    mid = wc.shape[0]
    w1 = np.zeros((mid, 2 * mid), np.float32)
    w1[:, span16_slots(mid, k)] = wa_top
    return np.concatenate([mma_fragments(to_bf16_bits(w1)),
                           mma_fragments(to_bf16_bits(wc))])


def unpack_span16(row: np.ndarray, mid: int, k: int):
    """Block k's row of `pack_span16` → (wa top half (mid × 2·mid, the
    logical channels' columns), wc (mid × 9·mid)), the bits as packed."""
    k1 = 2 * mid * mid
    w1 = unpack_mma_fragments(row[:k1], mid, 2 * mid)
    return (w1[:, span16_slots(mid, k)],
            unpack_mma_fragments(row[k1:], mid, 9 * mid))


def pack_s2_16(blk) -> Tuple[np.ndarray, np.ndarray]:
    """`pack_s2_block`'s dict → the bf16 stride-2 block's weights: uint16
    bf16 bits [pw1 (mid × cin, the composed block-diagonal `wa`'s first
    block) | `wc` | `wp`], each in `mma_fragments` order, and f32 biases
    [ba's first block | bc | bp]."""
    comp = compose_s2_block(blk)
    cin, mid = blk["w1"].shape
    w = np.concatenate([
        mma_fragments(to_bf16_bits(comp["wa"][:mid, :cin])),
        mma_fragments(to_bf16_bits(comp["wc"])),
        mma_fragments(to_bf16_bits(comp["wp"]))])
    b = np.concatenate([comp["ba"][:mid], comp["bc"], comp["bp"]])
    return w, b.astype(np.float32)
