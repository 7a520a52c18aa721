"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `fastdet_torch/csrc/<name>.cu` is one translation unit with a plain C
interface (no PyTorch or CUTLASS headers, so `nvcc` takes seconds); it may
include the package's own `csrc/*.cuh` headers.  It is compiled with
`nvcc` for `sm_90a` into `build/torch_ext/<name>-<hash>.so`, where the
hash covers the source, every `.cuh` header, the flags and the compiler
path, so an edited source or header rebuilds and an unchanged one is
reused.  `build/` is listed in `.gitignore`.

Flags are per source: `--fmad=false` keeps every a*b+c as two rounded
operations, as XLA and PyTorch's elementwise ops compute them, and the
bitwise parity of `pp_fused` and `nms_keep` with their plain versions
depends on it.  The stem and span kernels (both stems, the span and the
stage kernel `s2span`) are held to 2e-4, not bitwise, and contract to
FMA.  The training kernels `span_train` and `stem_train`
are built without FMA so that their plain versions recompute their
forwards bit for bit (their backward's ReLU masks and pool routing then
agree); their bf16 forms, C entries of the same sources, keep that
(their products are bf16 × bf16, exact in f32 with or without FMA).
`build_all` starts one `nvcc` per source, all at once.

A failed build raises; nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_ext")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
SOURCE_FLAGS = {"pp_fused": ("--fmad=false",),
                "nms_keep": ("--fmad=false",),
                "span_train": ("--fmad=false",),
                "stem_train": ("--fmad=false",)}
SOURCES = ("pp_fused", "stem_s2d", "span", "nms_keep", "span_train",
           "stem_train", "stem_s2d8", "s2span")
BUILD_TIMEOUT_S = 600

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, dict] = {}   # name → {"seconds", "ptxas"} of builds run


def nvcc_path() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("fastdet_torch: nvcc not found (set CUDA_HOME); the "
                       "CUDA kernels are built from source at first use")


def flags(name: str) -> tuple:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def _target(name: str, nvcc: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags(name)).encode())
    h.update(nvcc.encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` unless it is built already; returns the
    shared library's path."""
    nvcc = nvcc_path()
    target = _target(name, nvcc)
    if os.path.exists(target):
        return target
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        p = subprocess.run(
            [nvcc, *flags(name), "-o", tmp, os.path.join(CSRC, name + ".cu")],
            capture_output=True, text=True, timeout=BUILD_TIMEOUT_S,
            check=False)
        if p.returncode != 0:
            raise RuntimeError(f"fastdet_torch: nvcc failed on {name}.cu "
                               f"(exit {p.returncode}):\n{p.stdout}{p.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_log[name] = {"seconds": time.perf_counter() - t0,
                       "ptxas": p.stderr.strip()}
    return target


def build_all(names=SOURCES) -> None:
    """Build several sources at once, one `nvcc` each; raises on the first
    failure after all have ended."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        for _ in pool.map(build, names):
            pass


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed.

    signatures: C function name → (argtypes, restype), declared on the
    first load (pointers and the stream as c_void_p, so ctypes does not
    cut them to 32 bits)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            sigs = dict(signatures)
            sigs["fastdet_cuda_error_string"] = ([ctypes.c_int],
                                                 ctypes.c_char_p)
            for fn, (argtypes, restype) in sigs.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        msg = lib.fastdet_cuda_error_string(rc).decode()
        raise RuntimeError(f"fastdet_torch: {what} launch failed: "
                           f"CUDA error {rc} ({msg})")
