"""rank→decode→NMS: the port's `rank_decode_nms` (plain version on the CPU)
against the JAX package's Pallas kernel run in interpret mode, on the
same seeded inputs at the serving geometry (352², N=1815, nc=80).

Contract: `keep` bitwise; `boxes` within BOX_ULPS_XLA ULPs of the box's
largest coordinate (tests/torch_cases.py).  The only op that may round
differently is the sigmoid (XLA's CPU logistic against PyTorch's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet.kernels.pp_fused import rank_decode_nms as jax_rank_decode_nms
from fastdet.ops.postprocess import _geo_table as jax_geo_table
from fastdet_torch.kernels import pp_fused
from torch_cases import (ANCHORS, BOX_ULPS_XLA, IOU, META, N, NC,
                         box_ulps, make_inputs, port_geo)

NPAD = 1920   # the TPU kernel's lane padding of N


def run_jax(neg_k, combo_k, regs):
    regs_lane = np.pad(regs, ((0, 0), (0, NPAD - N), (0, 0))).transpose(
        0, 2, 1)
    geo = jax_geo_table(META, jnp.asarray(ANCHORS), NPAD)
    keep, boxes = jax_rank_decode_nms(
        jnp.asarray(neg_k), jnp.asarray(combo_k), jnp.asarray(regs_lane), geo,
        nc=NC, iou_thres=IOU, interpret=True)
    return np.asarray(keep), np.asarray(boxes)


@pytest.mark.parametrize("k", [128, 256])
@pytest.mark.parametrize("case", ["dense", "sparse", "tied", "clustered"])
def test_plain_matches_pallas_interpret(k, case):
    neg_k, combo_k, regs = make_inputs(k + len(case), 2, k, case)
    jkeep, jboxes = run_jax(neg_k, combo_k, regs)
    keep, boxes = pp_fused.rank_decode_nms_reference(
        torch.from_numpy(neg_k), torch.from_numpy(combo_k),
        torch.from_numpy(regs), port_geo(), nc=NC, iou_thres=IOU)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    assert box_ulps(boxes.numpy(), jboxes).max() <= BOX_ULPS_XLA
    valid = neg_k < 0
    assert keep.numpy()[~valid].sum() == 0
    # non-trivial: some candidates kept and some valid ones suppressed
    assert 0 < keep.sum() < valid.sum()


def test_geo_table_matches_jax():
    jgeo = np.asarray(jax_geo_table(META, jnp.asarray(ANCHORS), NPAD))
    geo = port_geo().numpy()
    assert geo.shape == (N, 8)
    np.testing.assert_array_equal(geo[:, :5], jgeo[:5, :N].T)
    assert not geo[:, 5:].any()


def test_cpu_wrapper_takes_plain_version_without_launch():
    neg_k, combo_k, regs = make_inputs(0, 2, 128, "dense")
    args = (torch.from_numpy(neg_k), torch.from_numpy(combo_k),
            torch.from_numpy(regs), port_geo())
    before = pp_fused.rank_decode_nms.launches
    keep, boxes = pp_fused.rank_decode_nms(*args, nc=NC, iou_thres=IOU)
    rkeep, rboxes = pp_fused.rank_decode_nms_reference(*args, nc=NC,
                                                       iou_thres=IOU)
    assert pp_fused.rank_decode_nms.launches == before
    assert torch.equal(keep, rkeep) and torch.equal(boxes, rboxes)
