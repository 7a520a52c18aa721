"""Training the anchor-free family in the port (`anchorfree_loss`, the
Trainer's `loss_fn=`) on the CPU.

The parity with the JAX package runs in float64 in a subprocess
(`tests/torch_train_x64.py anchorfree`, whose docstrings give the bounds):
the loss and its gradients with respect to the raw maps, on labels in
border cells, two labels in one cell, masked slots and one class; and the
Trainer with the family's loss from `weights/anchorfree-synth.npz`
against JAX's Trainer(loss_fn=) over 3 steps with subdivisions 1 and 2.
Here, in f32: the obj target is a scatter-max, the gathers accumulate
duplicate cells' gradients, and the fused backbone refuses the family.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fastdet_torch.config import Config
from fastdet_torch.io import load_state_dict
from fastdet_torch.models.anchorfree import anchorfree_loss
from fastdet_torch.models.registry import get_family
from fastdet_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH_NPZ = os.path.join(REPO, "weights", "anchorfree-synth.npz")
CFG = {"classes": 3, "width": 64, "height": 64, "anchor_num": 3,
       "anchors": [4.0, 6.0, 9.0, 12.0, 16.0, 24.0,
                   24.0, 16.0, 32.0, 40.0, 52.0, 48.0],
       "learning_rate": 0.01, "steps": [1000], "subdivisions": 1,
       "batch_size": 2, "epochs": 1}


def test_anchorfree_train_matches_jax_x64():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", "torch_train_x64.py"),
         "anchorfree"], capture_output=True, text=True, timeout=900,
        cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    assert "PASS" in proc.stdout


def _maps(b=1, h=4, w=4, nc=3, requires_grad=False):
    return [torch.zeros(b, h, w, c, requires_grad=requires_grad)
            for c in (1, nc, 4)]


def test_obj_target_is_a_scatter_max():
    """Two boxes with the same centre cell (1, 1) and the same neighbour
    cells (1, 2) and (2, 1) give those cells the target 1, not 2: with
    every obj logit x, d(64·mean BCE)/dx = 4·(σ(x) − t) at a cell, so the
    gradient shows each cell's target."""
    labels = torch.tensor([[[0, 0.40, 0.40, 0.2, 0.2],
                            [1, 0.45, 0.45, 0.3, 0.3]]])
    mask = torch.ones(1, 2, dtype=torch.bool)
    maps = _maps()
    maps[0] = torch.full_like(maps[0], 0.3).requires_grad_()
    _, comps = anchorfree_loss(maps, labels, mask, (64, 64))
    comps["obj"].backward()
    t = torch.zeros(4, 4)
    t[1, 1] = t[1, 2] = t[2, 1] = 1.0
    want = 4 * (torch.sigmoid(torch.tensor(0.3)) - t)
    torch.testing.assert_close(maps[0].grad[0, :, :, 0], want, rtol=0,
                               atol=1e-6)


def test_duplicate_cells_accumulate_gradients():
    """The same box twice gives the box and cls terms the gradients of
    the box once: each copy's candidates carry half the masked mean's
    weight, and the two halves add at the shared cells (a gather whose
    backward kept one copy would give half)."""
    one = torch.tensor([[[2, 0.40, 0.40, 0.2, 0.3]]])
    two = one.repeat(1, 2, 1)
    grads = []
    for labels in (one, two):
        maps = _maps(requires_grad=True)
        with torch.no_grad():
            maps[1].normal_(generator=torch.Generator().manual_seed(0))
            maps[2].normal_(generator=torch.Generator().manual_seed(1))
        _, comps = anchorfree_loss(maps, labels,
                                   torch.ones(labels.shape[:2], dtype=bool),
                                   (64, 64))
        (comps["box"] + comps["cls"]).backward()
        grads.append([m.grad.clone() for m in maps[1:]])
    for g1, g2 in zip(*grads):
        assert float(g1.abs().max()) > 0
        torch.testing.assert_close(g2, g1, rtol=1e-5, atol=1e-7)


def test_trainer_takes_the_family_loss():
    """One f32 step of the Trainer with the family's loss from the synth
    checkpoint: LR 0 at step 0, finite losses, the momentum buffers fill."""
    cfg = Config.from_dict(CFG)
    fam = get_family("anchorfree", cfg)
    fam.model.load_state_dict(load_state_dict(SYNTH_NPZ))
    t = Trainer(fam.model, cfg, 1, device="cpu", loss_fn=fam.loss_fn)
    rng = np.random.RandomState(0)
    images = rng.randint(0, 255, (2, 64, 64, 3)).astype(np.uint8)
    labels = np.zeros((2, 3, 5), np.float32)
    labels[:, 0] = [1, 0.5, 0.5, 0.3, 0.3]
    mask = np.zeros((2, 3), bool)
    mask[:, 0] = True
    m = t.step(images, labels, mask)
    assert m["lr"] == 0.0
    assert all(np.isfinite(float(m[k])) and float(m[k]) > 0
               for k in ("box", "obj", "cls", "total"))
    bufs = [s["momentum_buffer"] for s in t.optimizer.state.values()]
    assert len(bufs) == len(list(t.model.parameters()))


def test_fused_backbone_refuses_the_family():
    cfg = Config.from_dict(CFG)
    fam = get_family("anchorfree", cfg)
    with pytest.raises(ValueError, match="yolo-fastestv2"):
        Trainer(fam.model, cfg, 1, device="cpu", fused_backbone=True,
                loss_fn=fam.loss_fn)
