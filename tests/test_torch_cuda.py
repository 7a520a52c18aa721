"""Card tests of the port: the CUDA kernel against its plain version, and
the CUDA dispatch rules.  They skip where there is no NVIDIA card.  The
file imports no JAX, so that it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from fastdet_torch.config import Config
from fastdet_torch.kernels import pp_fused
from fastdet_torch.models import Detector
from fastdet_torch.ops.postprocess import postprocess
from fastdet_torch.serve import DevicePipeline
from torch_cases import (ANCHORS, BOX_ULPS_CARD, IOU, NC, box_ulps,
                         make_inputs, port_geo)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.parametrize("b", [1, 128])
@pytest.mark.parametrize("k", [128, 256, 384])
@pytest.mark.parametrize("case", ["dense", "sparse", "clustered"])
def test_kernel_matches_plain(card, b, k, case):
    neg_k, combo_k, regs = make_inputs(k + b, b, k, case)
    args = [torch.from_numpy(a).to(card) for a in (neg_k, combo_k, regs)]
    args.append(port_geo(str(card)))
    before = pp_fused.rank_decode_nms.launches
    keep, boxes = pp_fused.rank_decode_nms(*args, nc=NC, iou_thres=IOU)
    assert pp_fused.rank_decode_nms.launches == before + 1
    rkeep, rboxes = pp_fused.rank_decode_nms_reference(*args, nc=NC,
                                                       iou_thres=IOU)
    torch.cuda.synchronize()
    assert torch.equal(keep, rkeep)
    assert box_ulps(boxes.cpu().numpy(), rboxes.cpu().numpy()).max() \
        <= BOX_ULPS_CARD
    assert 0 < int(keep.sum()) < int((args[0] < 0).sum())


def test_window_over_kernel_bound_raises(card):
    outs = [torch.zeros(1, 22, 22, 12), torch.zeros(1, 22, 22, 3),
            torch.zeros(1, 22, 22, NC), torch.zeros(1, 11, 11, 12),
            torch.zeros(1, 11, 11, 3), torch.zeros(1, 11, 11, NC)]
    outs = [o.to(card) for o in outs]
    with pytest.raises(NotImplementedError, match="keep_mask_batch"):
        postprocess(outs, ANCHORS, (352, 352), max_nms=512)


def test_device_pipeline_card_matches_cpu(card):
    """The whole pipeline on the card (cuDNN f32 + the kernel) against the
    same pipeline on the CPU, at conf 0.01 on seeded images."""
    cfg = Config.from_file("data/coco.data")
    with torch.random.fork_rng():
        torch.manual_seed(0)
        sd = Detector().state_dict()       # random init: many candidates
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (4, 352, 352, 3), dtype=np.uint8)
    on_card = DevicePipeline(Detector(), sd, cfg, conf_thres=0.01,
                             device=card)(imgs)
    on_cpu = DevicePipeline(Detector(), sd, cfg, conf_thres=0.01,
                            device="cpu")(imgs)
    for a, b in zip(on_card, on_cpu):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
