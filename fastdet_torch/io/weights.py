"""Weights: the flat `.npz` variable files and the JAX → PyTorch carrier.

`load_npz_variables` reads the flat ``a/b/c``-keyed `.npz` that the JAX
package writes (fastdet/io/torch_convert.py:162-172) into the same nested
``{'params': …, 'batch_stats': …}`` dict of numpy arrays.

`from_jax_variables` maps that dict onto the port's `state_dict`.  The
port's modules carry the JAX module names, so a key is the JAX path joined
with dots, with the leaf renamed and conv kernels transposed:

  * ``params/…/conv/kernel`` HWIO ``(kh, kw, in/groups, out)`` → ``…conv.weight``
    OIHW (a depthwise ``(kh, kw, 1, C)`` becomes ``(C, 1, kh, kw)``);
  * ``params/…/bn/{scale,bias}`` → ``…bn.{weight,bias}``;
  * ``batch_stats/…/bn/{mean,var}`` → ``…bn.{running_mean,running_var}``;
  * the head convs ``params/output_*/{kernel,bias}`` keep their bias.

`to_jax_variables` is its inverse.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_PARAM_LEAF = {"scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def load_npz_variables(npz_path: str) -> dict:
    """Reload a converted .npz into the nested variable dict."""
    tree: dict = {}
    with np.load(npz_path) as flat:
        for key in flat.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = flat[key]
    return tree


def _leaves(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_jax_variables(variables: dict) -> Dict[str, torch.Tensor]:
    """JAX variable dict (numpy leaves) → the port's ``state_dict``."""
    sd: Dict[str, torch.Tensor] = {}
    for path, v in _leaves(variables.get("params", {})):
        a = np.asarray(v, np.float32)
        if path[-1] == "kernel":
            name = "weight"
            a = np.transpose(a, (3, 2, 0, 1))        # HWIO → OIHW
        elif path[-2] == "bn":
            name = _PARAM_LEAF[path[-1]]
        elif path[-1] == "bias":
            name = "bias"
        else:
            raise KeyError(f"unknown parameter leaf {'/'.join(path)}")
        sd[".".join(path[:-1] + (name,))] = torch.from_numpy(
            np.array(a, np.float32, order="C"))
    for path, v in _leaves(variables.get("batch_stats", {})):
        if path[-2] != "bn" or path[-1] not in _STAT_LEAF:
            raise KeyError(f"unknown batch_stats leaf {'/'.join(path)}")
        sd[".".join(path[:-1] + (_STAT_LEAF[path[-1]],))] = torch.from_numpy(
            np.array(v, np.float32, order="C"))
    return sd


def to_jax_variables(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The port's ``state_dict`` → JAX variable dict (numpy leaves)."""
    out: dict = {"params": {}, "batch_stats": {}}
    inv_param = {v: k for k, v in _PARAM_LEAF.items()}
    inv_stat = {v: k for k, v in _STAT_LEAF.items()}
    for key, t in state_dict.items():
        parts = key.split(".")
        leaf = parts[-1]
        a = t.detach().cpu().numpy()
        if leaf in inv_stat:
            coll, name = "batch_stats", inv_stat[leaf]
        elif leaf == "weight" and a.ndim == 4:
            coll, name = "params", "kernel"
            a = np.transpose(a, (2, 3, 1, 0))        # OIHW → HWIO
        elif parts[-2] == "bn":
            coll, name = "params", inv_param[leaf]
        elif leaf == "bias":
            coll, name = "params", "bias"
        else:
            raise KeyError(f"unknown state_dict key {key}")
        node = out[coll]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(a)
    return out


def load_state_dict(npz_path: str) -> Dict[str, torch.Tensor]:
    """`.npz` variable file → the port's ``state_dict``."""
    return from_jax_variables(load_npz_variables(npz_path))
