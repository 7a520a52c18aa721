"""The port's training loss pieces (fastdet_torch/{ops/iou,train/targets,
train/loss,train/schedule}.py) against the JAX package's on the CPU.

Seeded head outputs and labels as tests/test_loss_parity.py makes them
(random, no labels, boundary boxes).  Bounds: the loss components within
2e-4 relative (XLA's and PyTorch's f32 sigmoid, exp and log1p differ by a
few ULPs); their gradients within 1e-5 of each output's largest; the
dense targets' indices and masks equal, their boxes within 1e-6;
`bbox_ciou` within 1e-6; the LR schedule equal at every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet.ops.iou import bbox_ciou as jciou
from fastdet.train.loss import compute_loss as jloss
from fastdet.train.schedule import make_lr_schedule as jschedule
from fastdet.train.targets import build_dense_targets as jtargets
from fastdet_torch.ops.iou import bbox_ciou
from fastdet_torch.train.loss import compute_loss
from fastdet_torch.train.schedule import make_lr_schedule
from fastdet_torch.train.targets import build_dense_targets, pack_labels
from test_loss_parity import ANCHORS, _rand_labels, _rand_outputs

ANCH = np.asarray(ANCHORS, np.float32).reshape(2, 3, 2)
BOUNDARY = [
    np.array([[0, 0.01, 0.01, 0.05, 0.05],
              [5, 0.99, 0.99, 0.08, 0.08],
              [7, 0.5, 0.02, 0.3, 0.04],
              [2, 0.02, 0.5, 0.04, 0.3]], np.float32),
    np.array([[1, 0.5, 0.5, 1.0, 1.0]], np.float32),
]


def _case(name):
    if name == "no_labels":
        rng = np.random.RandomState(3)
        return _rand_outputs(rng, b=2), [np.zeros((0, 5), np.float32)] * 2
    if name == "boundary":
        rng = np.random.RandomState(4)
        return _rand_outputs(rng, b=2), BOUNDARY
    rng = np.random.RandomState(int(name[-1]))
    return _rand_outputs(rng, b=4), _rand_labels(rng, b=4)


@pytest.mark.parametrize("name", ["seed0", "seed1", "seed2", "no_labels",
                                  "boundary"])
def test_loss_matches_jax(name):
    outputs, per_img = _case(name)
    labels, mask = pack_labels(per_img, 16)

    def jax_total(outs):
        return jloss(outs, jnp.asarray(labels), jnp.asarray(mask),
                     jnp.asarray(ANCH), (352, 352))

    (jt, jc), jg = jax.value_and_grad(jax_total, has_aux=True)(
        [jnp.asarray(o) for o in outputs])
    touts = [torch.from_numpy(o).requires_grad_() for o in outputs]
    total, comps = compute_loss(touts, torch.from_numpy(labels),
                                torch.from_numpy(mask),
                                torch.from_numpy(ANCH), (352, 352))
    total.backward()
    for k in ("box", "obj", "cls", "total"):
        want, got = float(jc[k]), float(comps[k].detach())
        assert abs(got - want) <= 2e-4 * abs(want), (k, got, want)
    if name == "no_labels":
        assert float(comps["box"].detach()) == float(comps["cls"].detach()) \
            == 0.0
    for t, g in zip(touts, jg):
        g = np.asarray(g)
        assert np.abs(t.grad.numpy() - g).max() <= 1e-5 * np.abs(g).max()


def test_single_class_skips_ce():
    rng = np.random.RandomState(6)
    outputs = _rand_outputs(rng, b=2, nc=1)
    per_img = [np.array([[0, 0.4, 0.6, 0.2, 0.3]], np.float32)] * 2
    labels, mask = pack_labels(per_img, 4)
    _, jc = jloss([jnp.asarray(o) for o in outputs], jnp.asarray(labels),
                  jnp.asarray(mask), jnp.asarray(ANCH), (352, 352))
    _, comps = compute_loss([torch.from_numpy(o) for o in outputs],
                            torch.from_numpy(labels), torch.from_numpy(mask),
                            torch.from_numpy(ANCH), (352, 352))
    assert float(comps["cls"]) == float(jc["cls"]) == 0.0
    assert abs(float(comps["total"]) - float(jc["total"])) \
        <= 2e-4 * float(jc["total"])


@pytest.mark.parametrize("name", ["seed0", "boundary"])
def test_dense_targets_match_jax(name):
    _, per_img = _case(name)
    labels, mask = pack_labels(per_img, 16)
    for s, hw in enumerate(((22, 22), (11, 11))):
        anch = ANCH[s] / (352 / hw[1])
        j = jtargets(jnp.asarray(labels), jnp.asarray(mask),
                     jnp.asarray(anch), hw)
        t = build_dense_targets(torch.from_numpy(labels),
                                torch.from_numpy(mask),
                                torch.from_numpy(anch), hw)
        for f in ("gi", "gj", "tcls", "mask"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)), f)
        assert t.mask.any()
        np.testing.assert_allclose(t.tbox.numpy(), np.asarray(j.tbox),
                                   rtol=0, atol=1e-6)


def test_pack_labels_matches_jax():
    from fastdet.train.targets import pack_labels as jpack
    per_img = _rand_labels(np.random.RandomState(7), b=3, max_n=20)
    for a, b in zip(pack_labels(per_img, 8), jpack(per_img, 8)):
        np.testing.assert_array_equal(a, b)


def test_bbox_ciou_matches_jax():
    rng = np.random.default_rng(8)
    b1 = np.concatenate([rng.uniform(-1, 2, (500, 2)),
                         rng.uniform(0.05, 4, (500, 2))], 1).astype(np.float32)
    b2 = np.concatenate([rng.uniform(-1, 2, (500, 2)),
                         rng.uniform(0.05, 4, (500, 2))], 1).astype(np.float32)
    b2[:50] = b1[:50]                                   # identical boxes
    got = bbox_ciou(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
    want = np.asarray(jciou(jnp.asarray(b1), jnp.asarray(b2)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("base,spe,milestones,warm", [
    (0.01, 4, (1, 2), 5), (0.001, 10, (1, 2), 1), (0.001, 3, (150, 250), 5)])
def test_schedule_matches_jax_at_every_step(base, spe, milestones, warm):
    mine = make_lr_schedule(base, spe, milestones, warmup_epochs=warm)
    ref = jschedule(base, spe, milestones, warmup_epochs=warm)
    lrs = [mine(s) for s in range(3 * spe + 1)]
    assert lrs == [float(ref(s)) for s in range(3 * spe + 1)]
    assert lrs[0] == 0.0 and max(lrs) > 0.0
