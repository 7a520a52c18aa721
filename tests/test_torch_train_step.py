"""The port's Trainer (fastdet_torch/train/trainer.py), its fused-backbone
forward (train/fused_forward.py) and its checkpoints (io/checkpoint.py)
on the CPU.

The parity with the JAX package runs in float64 in a subprocess
(tests/torch_train_x64.py, whose header gives the bounds): the default
path's Trainer against JAX's over 3 steps with subdivisions 1 and 2, and
the fused forward, with NHWC and with s2d uint8 input, against JAX's
fused apply and the port's default path.
Here, in f32: a checkpoint roundtrip is bitwise, the fused Trainer's
first step has LR 0 and still fills the momentum buffers (in both input
formats), and the unported options raise naming their ROADMAP items.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fastdet_torch.config import Config
from fastdet_torch.io import (latest_step, load_checkpoint, load_state_dict,
                              save_checkpoint)
from fastdet_torch.kernels.fused_infer import pack_images_s2d
from fastdet_torch.models import Detector
from fastdet_torch.train.fused_forward import build_fused_train_apply
from fastdet_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_NPZ = os.path.join(REPO, "weights", "coco2017-ref.npz")
CFG = {"classes": 80, "width": 64, "height": 64, "anchor_num": 3,
       "anchors": [4.0, 6.0, 9.0, 12.0, 16.0, 24.0,
                   24.0, 16.0, 32.0, 40.0, 52.0, 48.0],
       "learning_rate": 0.01, "steps": [1000], "subdivisions": 2,
       "batch_size": 4, "epochs": 1}


@pytest.mark.parametrize("mode", ["default", "fused", "fused_s2d"])
def test_train_step_matches_jax_x64(mode):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", "torch_train_x64.py"),
         mode], capture_output=True, text=True, timeout=900, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    assert "PASS" in proc.stdout


def _batch(seed, b=2, hw=64):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, (b, hw, hw, 3)).astype(np.uint8)
    labels = np.zeros((b, 4, 5), np.float32)
    labels[:, 0] = [3, 0.4, 0.5, 0.3, 0.4]
    mask = np.zeros((b, 4), bool)
    mask[:, 0] = True
    return images, labels, mask


def _trainer(**kw):
    model = Detector(80, 3)
    model.load_state_dict(load_state_dict(REF_NPZ))
    return Trainer(model, Config.from_dict(CFG), 1, device="cpu", **kw)


def test_checkpoint_roundtrip_is_bitwise(tmp_path):
    """Saved mid-accumulation (subdivisions 2, after 3 micro-steps: one
    apply done, one gradient summed), loaded into a fresh Trainer, two
    more steps: the same bits as stepping on without the roundtrip."""
    a = _trainer()
    for i in range(3):
        a.step(*_batch(i))
    save_checkpoint(str(tmp_path), 3, a.state_dict())
    assert latest_step(str(tmp_path)) == 3
    b = _trainer()
    b.load_state_dict(load_checkpoint(str(tmp_path)))
    assert (b.step_count, b.accum_count) == (3, 1)
    for i in (3, 4):
        ma, mb = a.step(*_batch(i)), b.step(*_batch(i))
        assert float(ma["total"]) == float(mb["total"])
    for (k, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(x, y), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for k in sa["state"]:
        assert torch.equal(sa["state"][k]["momentum_buffer"],
                           sb["state"][k]["momentum_buffer"])
    assert latest_step(str(tmp_path / "none")) is None


def test_fused_trainer_first_step():
    """Step 0's LR is exactly 0, so the parameters stay, but the momentum
    buffers take the fused backbone's gradient and the spans' running
    statistics move (the JAX package's test_fused_trainer_step_runs)."""
    t = _trainer(fused_backbone=True, subdivisions=1)
    p0 = {k: v.clone() for k, v in t.model.state_dict().items()}
    m = t.step(*_batch(7, b=4, hw=96 - 32))
    assert m["lr"] == 0.0 and np.isfinite(float(m["total"]))
    for k, v in t.model.named_parameters():
        assert torch.equal(v, p0[k]), k
    bufs = [s["momentum_buffer"] for s in t.optimizer.state.values()]
    assert len(bufs) == len(list(t.model.parameters()))
    assert max(float(b.abs().max()) for b in bufs) > 0
    k = "backbone.stage3_1.main_pw.bn.running_var"
    assert float((t.model.state_dict()[k] - p0[k]).abs().max()) > 0
    assert t.current_lr(1) > 0


def test_s2d_trainer_first_step():
    """The fused s2d mode (`fused_input_format="s2d_u8"`, the stem through
    B7's plain versions on the CPU): step 0's LR is 0 and its loss finite,
    the momentum buffers fill, the stem BN's running statistics move, and
    the apply refuses NHWC images."""
    t = _trainer(fused_backbone=True, fused_input_format="s2d_u8",
                 subdivisions=1)
    p0 = {k: v.clone() for k, v in t.model.state_dict().items()}
    images, labels, mask = _batch(9, b=4)
    m = t.step(pack_images_s2d(images), labels, mask)
    assert m["lr"] == 0.0 and np.isfinite(float(m["total"]))
    for k, v in t.model.named_parameters():
        assert torch.equal(v, p0[k]), k
    bufs = [s["momentum_buffer"] for s in t.optimizer.state.values()]
    assert len(bufs) == len(list(t.model.parameters()))
    assert max(float(b.abs().max()) for b in bufs) > 0
    assert float(t.optimizer.state[
        t.model.backbone.first_conv.conv.weight]["momentum_buffer"]
        .abs().max()) > 0
    for k in ("running_mean", "running_var"):
        k = f"backbone.first_conv.bn.{k}"
        assert float((t.model.state_dict()[k] - p0[k]).abs().max()) > 0
    with pytest.raises(ValueError, match="s2d"):
        t.step(images, labels, mask)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="A1"):
        _trainer(compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="input_format"):
        build_fused_train_apply((64, 64), input_format="nchw", device="cpu")
