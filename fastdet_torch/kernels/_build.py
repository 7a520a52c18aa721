"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `fastdet_torch/csrc/<name>.cu` is one translation unit with a plain C
interface (no PyTorch or CUTLASS headers, so `nvcc` takes seconds).  It is
compiled with `nvcc` for `sm_90a` into
`build/torch_ext/<name>-<hash>.so`, where the hash covers the source, the
flags and the compiler path, so an edited source rebuilds and an
unchanged one is reused.  `build/` is listed in `.gitignore`.

`--fmad=false` keeps every a*b+c as two rounded operations, as XLA and
PyTorch's elementwise ops compute them; the kernels' bitwise parity with
their plain versions depends on it.

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
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_ext")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")
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


def _target(name: str, nvcc: str) -> str:
    h = hashlib.sha256()
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
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
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")],
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
