"""Darknet-style `.data` / `.names` config parsing.

The port's own copy of fastdet/config.py (the port imports nothing of the
JAX package).  Byte-compatible with the reference loader (utils/utils.py:13-65):
`[section]` headers and blank lines are skipped, each remaining line is split
on `=`, and values are coerced by fixed typed key lists.  Unknown keys warn
instead of erroring, and keys absent from the file stay ``None``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

# Typed key lists — these mirror the reference's hardcoded coercion tables.
_LIST_KEYS = ("anchors", "steps")
_STR_KEYS = ("model_name", "val", "train", "names", "pre_weights")
_INT_KEYS = ("epochs", "batch_size", "classes", "width", "height",
             "anchor_num", "subdivisions")
_FLOAT_KEYS = ("learning_rate",)

_ALL_KEYS = _LIST_KEYS + _STR_KEYS + _INT_KEYS + _FLOAT_KEYS


def load_datafile(data_path: str) -> dict:
    """Parse a `.data` file into a plain dict with the reference's 14 keys."""
    cfg = {k: None for k in _ALL_KEYS}

    assert os.path.exists(data_path), f"config .data file not found: {data_path}"

    with open(data_path, "r") as f:
        for line in f.readlines():
            if line == "\n" or line[0] == "[":
                continue
            data = line.strip().split("=")
            key = data[0]
            if key not in cfg:
                print(f"{data_path} contains an unknown config key: {data}")
                continue
            if key in _INT_KEYS:
                cfg[key] = int(data[1])
            elif key in _STR_KEYS:
                cfg[key] = data[1]
            elif key in _FLOAT_KEYS:
                cfg[key] = float(data[1])
            elif key in _LIST_KEYS:
                cfg[key] = [float(x) for x in data[1].split(",")]
    return cfg


def load_names(names_path: str) -> List[str]:
    """One class name per line (reference reads these in test.py:52-55)."""
    with open(names_path, "r") as f:
        return [line.strip() for line in f.readlines()]


def resolve_path(path: Optional[str], data_path: str) -> Optional[str]:
    """Resolve a path from a `.data` file.  Relative paths are tried
    against the cwd (reference behavior), then against the .data file's
    directory and its parent (so configs work from any cwd)."""
    if path is None or os.path.isabs(path) or os.path.exists(path):
        return path
    base = os.path.dirname(os.path.abspath(data_path))
    for root in (base, os.path.dirname(base)):
        cand = os.path.normpath(os.path.join(root, path))
        if os.path.exists(cand):
            return cand
    return path


@dataclasses.dataclass(frozen=True)
class Config:
    """Typed view over the `.data` dict (frozen, so it is hashable)."""

    model_name: Optional[str] = None
    epochs: Optional[int] = None
    steps: Optional[tuple] = None
    batch_size: Optional[int] = None
    subdivisions: Optional[int] = None
    learning_rate: Optional[float] = None
    pre_weights: Optional[str] = None
    classes: Optional[int] = None
    width: Optional[int] = None
    height: Optional[int] = None
    anchor_num: Optional[int] = None
    anchors: Optional[tuple] = None
    val: Optional[str] = None
    train: Optional[str] = None
    names: Optional[str] = None

    @classmethod
    def from_file(cls, data_path: str) -> "Config":
        cfg = load_datafile(data_path)
        return cls.from_dict(cfg)

    @classmethod
    def from_dict(cls, cfg: dict) -> "Config":
        cfg = dict(cfg)
        for k in ("steps", "anchors"):
            if cfg.get(k) is not None:
                cfg[k] = tuple(cfg[k])
        # `pre_weights=None` in the file parses to the string "None"; the
        # reference then checks os.path.exists on it, so normalise here.
        if cfg.get("pre_weights") in ("None", "none", ""):
            cfg["pre_weights"] = None
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cfg.items() if k in known})

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for k in ("steps", "anchors"):
            if d.get(k) is not None:
                d[k] = list(d[k])
        return d

    @property
    def num_scales(self) -> int:
        return len(self.anchors) // (2 * self.anchor_num)

    def scale_anchors(self):
        """anchors as a (num_scales, anchor_num, 2) nested tuple, in pixels."""
        a = self.anchors
        n, s = self.anchor_num, self.num_scales
        return tuple(
            tuple(tuple(a[(i * n + j) * 2:(i * n + j) * 2 + 2]) for j in range(n))
            for i in range(s)
        )
