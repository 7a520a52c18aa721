"""The host postprocess in C++ (counterpart of `postprocess` in
fastdet/native.py): anchor decode and class-aware greedy NMS over the
deploy maps, OpenMP over images, the host half of `HybridPipeline`.

`csrc/host_postprocess.cc` is the port's copy of the JAX package's
csrc/postprocess.cc.  It is compiled at first use with the host compiler
(`g++ -O3 -march=native -fPIC -fopenmp -std=c++17 -shared`, no image
libraries) into `build/host/host_postprocess-<hash>.so`, where the hash
covers the source, the flags and the compiler's path, and loaded with
ctypes.  A failed build raises; nothing falls back to another
implementation.  The JAX package's image decoders (`preprocess.cc`) are
not part of it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG, "csrc", "host_postprocess.cc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "host")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17",
             "-shared")
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib = None


class FDBox(ctypes.Structure):
    _fields_ = [("x1", ctypes.c_float), ("y1", ctypes.c_float),
                ("x2", ctypes.c_float), ("y2", ctypes.c_float),
                ("score", ctypes.c_float), ("cls", ctypes.c_int)]


def cxx_path() -> str:
    cxx = shutil.which("g++")
    if cxx:
        return cxx
    raise RuntimeError("fastdet_torch: no host C++ compiler (g++) found; "
                       "the host postprocess is built from source at first "
                       "use")


def build_native() -> str:
    """Compile `csrc/host_postprocess.cc` unless it is built already →
    the shared library's path."""
    cxx = cxx_path()
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(cxx.encode())
    target = os.path.join(BUILD_DIR,
                          f"host_postprocess-{h.hexdigest()[:16]}.so")
    if os.path.exists(target):
        return target
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    try:
        p = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                           capture_output=True, text=True,
                           timeout=BUILD_TIMEOUT_S, check=False)
        if p.returncode != 0:
            raise RuntimeError(
                f"fastdet_torch: {cxx} failed on host_postprocess.cc (exit "
                f"{p.returncode}):\n{p.stdout}{p.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return target


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_native())
            lib.fd_postprocess.restype = ctypes.c_int
            lib.fd_version.restype = ctypes.c_int
            if lib.fd_version() != 2:
                raise RuntimeError("fastdet_torch: host_postprocess version "
                                   f"{lib.fd_version()}, want 2")
            _lib = lib
        return _lib


def postprocess(s16: np.ndarray, s32: np.ndarray, anchors: np.ndarray,
                input_hw: Tuple[int, int] = (352, 352),
                conf_thres: float = 0.3, iou_thres: float = 0.45,
                max_det: int = 300) -> List[np.ndarray]:
    """Deploy maps (B,h,w,4A+A+nc) ×2 scales → per-image (n,6) float32
    arrays [x1,y1,x2,y2,score,cls]."""
    lib = _load()
    s16 = np.ascontiguousarray(s16, np.float32)
    s32 = np.ascontiguousarray(s32, np.float32)
    b, h16, w16, ch = s16.shape
    _, h32, w32, _ = s32.shape
    anchors = np.ascontiguousarray(anchors, np.float32).reshape(-1)
    anchor_num = anchors.size // 4
    classes = ch - 5 * anchor_num

    boxes = (FDBox * (b * max_det))()
    counts = (ctypes.c_int * b)()
    fp = ctypes.POINTER(ctypes.c_float)
    rc = lib.fd_postprocess(
        s16.ctypes.data_as(fp), s32.ctypes.data_as(fp),
        b, h16, w16, h32, w32, anchor_num, classes,
        anchors.ctypes.data_as(fp), input_hw[1], input_hw[0],
        ctypes.c_float(conf_thres), ctypes.c_float(iou_thres), max_det,
        boxes, counts)
    if rc != 0:
        raise RuntimeError(f"fastdet_torch: fd_postprocess returned {rc}")

    raw = np.ctypeslib.as_array(boxes)
    f32 = raw.view(np.float32).reshape(b, max_det, 6)
    i32 = raw.view(np.int32).reshape(b, max_det, 6)
    out = []
    for i in range(b):
        n = counts[i]
        rows = f32[i, :n].copy()
        rows[:, 5] = i32[i, :n, 5]     # the cls field carries int bits
        out.append(rows)
    return out
