"""The port's staged NMS (fastdet_torch/kernels/nms_kernel.py) against the
JAX package's TPU kernels, run in interpret mode on the CPU: B4
`keep_mask_batch`'s single tile (k = 512) and B5 `_suppress_call_tiled`'s
512-blocks with padding (k = 1300, 2048).  On the CPU the port's wrapper
runs its plain version, which the CUDA kernel `nms_keep` is held to
bitwise on the card (tests/test_torch_cuda.py, chip_smoke.py phase 2c).

Seeded crowded fields (`torch_cases.crowded`: three classes, ~10%
invalid, one valid candidate scoring 0, B = 2): long chains of
suppression that cross the 64-candidate words of the card's bitmask and
the TPU's 512-blocks.  Everything is bitwise: the IoU is computed op for
op on both sides.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet.kernels import nms_kernel as jnk
from fastdet_torch.kernels import nms_kernel
from torch_cases import crowded

IOU = 0.4


@functools.lru_cache(maxsize=None)
def field(k):
    return crowded(5, 2, k)


def as_jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def as_torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@functools.lru_cache(maxsize=None)
def jax_keep(k):
    boxes, score, cls, valid = field(k)
    return np.asarray(jnk.keep_mask_batch(*as_jax(boxes, score, cls, valid),
                                          iou_thres=IOU, interpret=True))


@pytest.mark.parametrize("k", [512, 1300, 2048])
def test_keep_mask_bitwise_vs_pallas(k):
    boxes, _, cls, valid = field(k)
    keep = nms_kernel.keep_mask_batch(*as_torch(boxes, cls, valid),
                                      iou_thres=IOU)
    want = jax_keep(k)
    np.testing.assert_array_equal(keep.numpy(), want)
    # not trivial: chains of suppression, and candidates kept in every
    # 512-block of the TPU kernel
    assert 0 < want.sum() < valid.sum()
    for t in range(0, k, 512):
        assert want[:, t:t + 512].any(axis=1).all()


@pytest.mark.parametrize("k", [512, 1300, 2048])
@pytest.mark.parametrize("max_det", [300, 100])
def test_suppress_ranked_batch_matches_jax(k, max_det):
    """`max_det` 100 is below every image's kept count, so the compaction
    cuts."""
    boxes, score, cls, valid = field(k)
    jdet, jn = jnk.suppress_ranked_batch(*as_jax(boxes, score, cls, valid),
                                         iou_thres=IOU, max_det=max_det,
                                         interpret=True)
    det, n = nms_kernel.suppress_ranked_batch(
        *as_torch(boxes, score, cls, valid), iou_thres=IOU, max_det=max_det)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(det.numpy(), np.asarray(jdet))
    if max_det == 100:
        assert (jax_keep(k).sum(1) > max_det).all()
        assert (n.numpy() == max_det).all()


def test_valid_nonpositive_score_is_eligible():
    """tests/test_postprocess.py's case: validity is authoritative.  A
    valid candidate with score 0 or below is kept or suppressed like any
    other (box 1 kept, box 2 suppressed by box 0); the invalid box 3 is
    dropped."""
    boxes = np.asarray([[[0, 0, 10, 10], [100, 100, 110, 110],
                         [1, 1, 11, 11], [200, 200, 210, 210]]], np.float32)
    score = np.asarray([[0.9, 0.0, -0.1, -0.5]], np.float32)
    cls = np.zeros((1, 4), np.int64)
    valid = np.asarray([[True, True, True, False]])
    keep = nms_kernel.keep_mask_batch(*as_torch(boxes, cls, valid),
                                      iou_thres=IOU)
    assert keep.tolist() == [[True, True, False, False]]
    jdet, jn = jnk.suppress_ranked_batch(*as_jax(boxes, score, cls, valid),
                                         iou_thres=IOU, max_det=10,
                                         interpret=True)
    det, n = nms_kernel.suppress_ranked_batch(
        *as_torch(boxes, score, cls, valid), iou_thres=IOU, max_det=10)
    assert int(n[0]) == 2
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(det.numpy(), np.asarray(jdet))


def test_wrapper_refuses_other_devices():
    boxes, _, cls, valid = field(512)
    args = [t.to("meta") for t in as_torch(boxes, cls, valid)]
    with pytest.raises(ValueError, match="unsupported device"):
        nms_kernel.keep_mask_batch(*args, iou_thres=IOU)
