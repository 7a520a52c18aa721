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
