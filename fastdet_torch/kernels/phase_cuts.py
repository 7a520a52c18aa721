"""Builds of a kernel with phases cut out of its header, for timing on the
card, whose machine has no `ncu`: a phase's share is read from the builds
without it.  A cut build computes a wrong function; its outputs are not
checked.  `stage_phases` (B2, B9), `stem_phases` (B1, B6, B10) and the
repo root's `pp_phases.py` (B3) hold the cuts and the calls; this module
builds and times them.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from fastdet_torch.kernels import _build


def cut_source(text: str, pairs, what: str) -> str:
    """`text` with each (old, new) pair replaced; each old must be there."""
    for old, new in pairs:
        if old not in text:
            raise RuntimeError(f"{what}: {old.strip()!r} is not in the "
                               f"source; update the cuts")
        text = text.replace(old, new)
    return text


def build_variant(name: str, pairs, root: str, header: str,
                  sources: dict) -> dict:
    """Builds each `sources` entry (source name → its C signatures) from
    `_build.CSRC` with `pairs` cut out of `header`, under root/name, with
    the flags of the main build → {source name: ctypes library}."""
    d = os.path.join(root, name.replace(" ", "_").replace("+", "_"))
    os.makedirs(d, exist_ok=True)
    units = {src + ".cu" for src in sources}
    for f in os.listdir(_build.CSRC):
        if f.endswith(".cuh") or f in units:
            shutil.copy(os.path.join(_build.CSRC, f), d)
    with open(os.path.join(_build.CSRC, header)) as f:
        text = cut_source(f.read(), pairs, header)
    with open(os.path.join(d, header), "w") as f:
        f.write(text)
    libs = {}
    for src, sigs in sources.items():
        out = os.path.join(d, src + ".so")
        p = subprocess.run([_build.nvcc_path(), *_build.flags(src), "-o",
                            out, os.path.join(d, src + ".cu")],
                           capture_output=True, text=True, check=False)
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}/{src}:\n{p.stderr}")
        lib = ctypes.CDLL(out)
        for fn, (argtypes, restype) in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[src] = lib
    return libs


def build_variants(cuts: dict, root: str, header: str,
                   sources: dict) -> dict:
    """The whole kernel and each cut build (phase → pairs), built at once
    → {"whole" or phase: {source name: library}}."""
    variants = {"whole": [], **cuts}
    with ThreadPoolExecutor(len(variants)) as pool:
        return dict(zip(variants, pool.map(
            lambda kv: build_variant(kv[0], kv[1], root, header, sources),
            variants.items())))


def ms(fn, calls: int = 20) -> float:
    """Mean ms of `fn` over `calls` back to back, after 3 warm-up calls
    (CUDA events)."""
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / calls
