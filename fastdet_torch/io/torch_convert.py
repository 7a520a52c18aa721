"""Reference PyTorch `.pth` checkpoints → the port's state dict
(counterpart of fastdet/io/torch_convert.py).

The reference's released checkpoints are flat state dicts with the
namespaces {backbone., fpn., output_{reg,obj,cls}_layers.}; their modules
are `nn.Sequential`s, so a conv or BN is named by its index in one.
`_reference_tree` is the one table of that layout: it maps each
[conv, bn] pair onto the JAX package's variable tree, exactly as the JAX
converter does (regular conv OIHW → HWIO, depthwise (C, 1, kh, kw) →
(kh, kw, 1, C), BN weight/bias → params …bn.{scale,bias}, running
mean/var → batch_stats …bn.{mean,var}; `num_batches_tracked` dropped).
`io/weights.py::from_jax_variables` then gives the port's names, so the
one function that turns JAX's parameters into the port's stays the one
path.  `convert_torch_checkpoint` writes the JAX package's flat `.npz`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from fastdet_torch.io.weights import _leaves, from_jax_variables

# (stage index → repeats) of ShuffleNetV2 (4, 8, 4)
_STAGE_REPEATS = {2: 4, 3: 8, 4: 4}
# [conv, bn] Sequential indices of a shuffle block's branches and of the
# FPN heads' DWConvblock
_MAIN = (("main_pw", 0, 1), ("main_dw", 3, 4), ("main_pw_linear", 5, 6))
_PROJ = (("proj_dw", 0, 1), ("proj_pw", 2, 3))
_DWBLOCK = (("dw1", 0, 1), ("pw1", 3, 4), ("dw2", 5, 6), ("pw2", 8, 9))
_HEADS = ("cls_head_2", "reg_head_2", "cls_head_3", "reg_head_3")
_OUTPUTS = (("output_reg", "output_reg_layers"),
            ("output_obj", "output_obj_layers"),
            ("output_cls", "output_cls_layers"))


def _hwio(w: np.ndarray) -> np.ndarray:
    """OIHW (or depthwise C1HW) → HWIO."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _convbn(sd, conv: str, bn: str, params: dict, stats: dict,
            path: Tuple[str, ...]) -> None:
    for p in path:
        params = params.setdefault(p, {})
        stats = stats.setdefault(p, {})
    params["conv"] = {"kernel": _hwio(sd[f"{conv}.weight"])}
    params["bn"] = {"scale": sd[f"{bn}.weight"], "bias": sd[f"{bn}.bias"]}
    stats["bn"] = {"mean": sd[f"{bn}.running_mean"],
                   "var": sd[f"{bn}.running_var"]}


def _reference_tree(sd: Dict[str, np.ndarray],
                    backbone_only: bool = False) -> dict:
    """Numpy reference state dict → the JAX package's {'params',
    'batch_stats'} tree.  A `backbone_only` tree has no "backbone" level,
    as the JAX converter's."""
    params: dict = {}
    stats: dict = {}
    bb = "" if backbone_only else "backbone."
    root = () if backbone_only else ("backbone",)
    _convbn(sd, f"{bb}first_conv.0", f"{bb}first_conv.1", params, stats,
            root + ("first_conv",))
    for stage, repeats in _STAGE_REPEATS.items():
        for i in range(repeats):
            prefix, path = f"{bb}stage{stage}.{i}", root + (
                f"stage{stage}_{i}",)
            for name, ci, bi in _MAIN:
                _convbn(sd, f"{prefix}.branch_main.{ci}",
                        f"{prefix}.branch_main.{bi}", params, stats,
                        path + (name,))
            for name, ci, bi in (_PROJ if i == 0 else ()):
                _convbn(sd, f"{prefix}.branch_proj.{ci}",
                        f"{prefix}.branch_proj.{bi}", params, stats,
                        path + (name,))
    if backbone_only:
        return {"params": params, "batch_stats": stats}
    for name in ("conv1x1_2", "conv1x1_3"):
        _convbn(sd, f"fpn.{name}.0", f"fpn.{name}.1", params, stats,
                ("fpn", name))
    for head in _HEADS:
        for name, ci, bi in _DWBLOCK:
            _convbn(sd, f"fpn.{head}.block.{ci}", f"fpn.{head}.block.{bi}",
                    params, stats, ("fpn", head, name))
    for name, ref in _OUTPUTS:
        params[name] = {"kernel": _hwio(sd[f"{ref}.weight"]),
                        "bias": sd[f"{ref}.bias"]}
    return {"params": params, "batch_stats": stats}


def convert_state_dict(sd: Dict[str, np.ndarray],
                       backbone_only: bool = False
                       ) -> Dict[str, torch.Tensor]:
    """Numpy reference state dict → the port's state dict (keys without
    the ``backbone.`` prefix when `backbone_only`)."""
    return from_jax_variables(_reference_tree(sd, backbone_only))


def _load_numpy(pth_path: str) -> Dict[str, np.ndarray]:
    sd = torch.load(pth_path, map_location="cpu")
    return {k: v.detach().numpy().astype(np.float32)
            for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def load_torch_weights(pth_path: str, backbone_only: bool = False
                       ) -> Dict[str, torch.Tensor]:
    """A reference `.pth` → the port's state dict."""
    return convert_state_dict(_load_numpy(pth_path), backbone_only)


def convert_torch_checkpoint(pth_path: str, out_path: str,
                             backbone_only: bool = False
                             ) -> Dict[str, torch.Tensor]:
    """Convert a reference `.pth` and save it as the JAX package's flat
    ``a/b/c``-keyed `.npz` (torch-free to reload) → the port's state
    dict."""
    tree = _reference_tree(_load_numpy(pth_path), backbone_only)
    np.savez(out_path, **{"/".join((coll,) + k): v
                          for coll, sub in tree.items()
                          for k, v in _leaves(sub)})
    return from_jax_variables(tree)
