"""Shared seeded inputs of the port's rank→decode→NMS tests (imports no
JAX, so that the card tests can use it on a machine without JAX).

Box tolerances are |Δ| in units in the last place (ULPs) of the box's
largest |coordinate|:
  * BOX_ULPS_XLA, the port against the JAX package on the CPU: XLA's and
    PyTorch's f32 sigmoids differ by up to 2 ULPs (pinned by
    test_torch_postprocess.py::test_transcendentals_within_stated_ulps),
    and w, h square the sigmoid;
  * BOX_ULPS_CARD, the CUDA kernel against the plain version on the card:
    both compute 1/(1+expf(-x)) with the same rounding steps, so the boxes
    are expected bitwise; 2 ULPs leaves room for one expf ULP.
"""

import numpy as np

from fastdet_torch.ops.postprocess import _geo_table

NC = 80
META = ((22 * 22 * 3, 22, 22, 3, 16.0), (11 * 11 * 3, 11, 11, 3, 32.0))
N = 1815
ANCHORS = np.asarray([12.64, 19.39, 37.88, 51.48, 55.71, 138.31, 126.91,
                      78.23, 131.57, 214.55, 279.92, 258.87],
                     np.float32).reshape(2, 3, 2)
IOU = 0.45
BOX_ULPS_XLA = 8
BOX_ULPS_CARD = 2


def make_inputs(seed, b, k, case):
    """Seeded top-k window as the serving postprocess builds it: a ranked
    score row sorted stably, combo = idx·nc + cls, raw reg logits.
    Three classes only (one in the sparse and clustered cases), so that
    same-class boxes overlap and suppress."""
    rng = np.random.default_rng(seed)
    score = rng.uniform(0.3, 1.0, (b, N)).astype(np.float32)
    if case == "dense":
        valid = rng.random((b, N)) < 0.9
    elif case == "sparse":                 # fewer valid than the window
        valid = rng.random((b, N)) < 0.05
    elif case == "tied":                   # every score equal
        score[:] = np.float32(0.5)
        valid = np.ones((b, N), bool)
    elif case == "clustered":              # large same-class boxes: long
        valid = rng.random((b, N)) < 0.9   # chains of suppression
    else:
        raise ValueError(case)
    ranked = np.where(valid, score, np.float32(-1.0))
    cls = rng.integers(0, 1 if case in ("sparse", "clustered") else 3,
                       (b, N))
    order = np.argsort(-ranked, axis=1, kind="stable")[:, :k]
    neg_k = -np.take_along_axis(ranked, order, 1)
    combo_k = (order * NC + np.take_along_axis(cls, order, 1)).astype(np.int32)
    regs = rng.normal(0.0, 1.5, (b, N, 4)).astype(np.float32)
    if case == "clustered":
        regs[..., 2:] = np.abs(regs[..., 2:])
    return neg_k.astype(np.float32), combo_k, regs


def box_ulps(a, b):
    """|a − b| in ULPs of each box's largest |coordinate|."""
    scale = np.maximum(np.abs(a), np.abs(b)).max(-1, keepdims=True)
    return np.abs(a.astype(np.float64) - b) / np.spacing(scale)



def port_geo(device="cpu"):
    return _geo_table(META, tuple(ANCHORS.ravel().tolist()), device)
