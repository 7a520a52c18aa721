"""bf16 models and bf16 training of the port against the JAX package on
the CPU: `Detector(dtype=bf16)` and `AnchorFreeDetector(dtype=bf16)`
against the linen models at dtype=bfloat16 (the counterpart of
tests/test_trainer.py::test_bf16_dtype_reaches_convs), `get_family(
dtype=bf16)`, and `Trainer(compute_dtype=bf16)` against JAX's bf16
`Trainer` over 3 steps.  Inputs are made from seeds with numpy; the
weights are `weights/coco2017-ref.npz` and `weights/anchorfree-synth.npz`.

Tolerances, and why:
  * outputs are bf16 and every parameter, gradient and momentum buffer
    f32, exactly;
  * eval mode (running statistics): every map within 2⁻⁵ of its max
    |value| (the rounding points are flax's, so the maps are bit for bit
    JAX's eager ones here);
  * training mode (batch statistics) is chaotic in bf16 at test sizes: a
    statistic summed in another f32 order flips a bf16 rounding, and the
    next BatchNorm over a few hundred samples carries the flip through
    the net.  JAX's own eager and jitted forwards of one function stand
    10-33% of max |value| apart at 64²-256².  So each map is held to the
    larger of 2⁻⁵ and twice JAX's eager-against-jit distance on the same
    inputs (the port read 0.6-1.5× that distance at 64²-256²);
  * Trainer steps at 128², b4, against JAX's jitted Trainer, after 3
    steps: the parameters within 2⁻⁵ of the model's largest parameter and
    the running statistics within 2⁻⁵ (per BN, the means against its
    largest running std and the variances against its largest running
    variance: single leaves near 0 have no scale of their own, and a bf16
    gradient of such a leaf is rounding noise, JAX's eager and jitted
    gradients up to 2× apart); the loss components within 2⁻⁴ relative.
    The asked 2⁻⁵ does not hold for the losses: they read up to 5.6%
    (yolo, subdivisions 1, the third step), where JAX's own eager step
    stands 2.3% off its jitted one and 0.4% off the port's.  Measured
    here: parameters ≤ 1.5%, running statistics ≤ 2.1%.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet.config import Config as JConfig
from fastdet.io.torch_convert import load_npz_variables
from fastdet.models.registry import get_family as jget_family
from fastdet.train.trainer import Trainer as JTrainer
from fastdet_torch.config import Config
from fastdet_torch.io import from_jax_variables, load_state_dict
from fastdet_torch.models import Detector
from fastdet_torch.models.anchorfree import AnchorFreeDetector
from fastdet_torch.models.registry import get_family
from fastdet_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_NPZ = os.path.join(REPO, "weights", "coco2017-ref.npz")
AF_NPZ = os.path.join(REPO, "weights", "anchorfree-synth.npz")
BF = jnp.bfloat16
T16 = torch.bfloat16
STEP_RTOL = 2.0 ** -4


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """torch on two threads while this file runs (the suite runs in
    parallel workers; a full-width OpenMP pool oversubscribes the CPU for
    every other test), the worker's own count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _models(family):
    if family == "anchorfree":
        v = load_npz_variables(AF_NPZ)
        return (jget_family("anchorfree", JConfig.from_dict(_cfg(3, 64)),
                            dtype=BF).model,
                AnchorFreeDetector(classes=3, dtype=T16), v, AF_NPZ)
    return (jget_family("yolo-fastestv2", JConfig.from_dict(_cfg(80, 64)),
                        dtype=BF).model,
            Detector(80, 3, dtype=T16), load_npz_variables(REF_NPZ), REF_NPZ)


def _cfg(classes, hw, sub=1):
    return {"classes": classes, "width": hw, "height": hw, "anchor_num": 3,
            "anchors": [4.0, 6.0, 9.0, 12.0, 16.0, 24.0,
                        24.0, 16.0, 32.0, 40.0, 52.0, 48.0],
            "learning_rate": 0.01, "steps": [1000], "subdivisions": sub,
            "batch_size": 4, "epochs": 1}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("family", ["yolo-fastestv2", "anchorfree"])
def test_bf16_model_matches_linen(family, train, hw=(64, 96)):
    jm, pm, v, npz = _models(family)
    pm.load_state_dict(load_state_dict(npz))
    pm.train(train)
    rng = np.random.RandomState(0)
    x = rng.randint(0, 255, (2,) + hw + (3,)).astype(np.float32) / 255.0

    def japply(x):
        if train:
            return jm.apply(v, x, train=True, mutable=["batch_stats"])[0]
        return jm.apply(v, x, train=False)

    eager = japply(jnp.asarray(x))
    outs = pm(torch.from_numpy(x))
    assert all(o.dtype == T16 for o in outs)
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    assert all(b.dtype == torch.float32 for b in pm.buffers())
    if not train:
        for o, e in zip(outs, eager):
            assert _rel(o, e) <= 2 ** -5
        return
    jit = jax.jit(japply)(jnp.asarray(x))
    for i, (o, e, j) in enumerate(zip(outs, eager, jit)):
        spread = _rel(j, e)
        got = _rel(o, e)
        print(f"{family} {hw} map {i}: port {got:.4f} of max |value| off "
              f"JAX eager; JAX jit {spread:.4f}")
        assert got <= max(2 ** -5, 2 * spread), (i, got, spread)


def test_get_family_bf16_is_a_compute_dtype():
    cfg = Config.from_dict(_cfg(3, 64))
    for name in ("yolo-fastestv2", "anchorfree"):
        fam = get_family(name, cfg, dtype=T16)
        assert fam.model.dtype == T16
        assert all(p.dtype == torch.float32 for p in fam.model.parameters())
        # the f64 parity tests keep casting the parameters
        fam64 = get_family(name, cfg, dtype=torch.float64)
        assert all(p.dtype == torch.float64
                   for p in fam64.model.parameters())
    # a bf16 model loads the f32 state dict strictly
    m = get_family("yolo-fastestv2", Config.from_dict(_cfg(80, 64)),
                   dtype=T16).model
    m.load_state_dict(load_state_dict(REF_NPZ), strict=True)


@pytest.mark.parametrize("fused", [False, True], ids=["default", "fused"])
def test_bf16_trainer_takes_the_models_compute_dtype(fused):
    """A model built to compute in bf16 trains in bf16 without
    `compute_dtype` (the same outputs as with it); `compute_dtype=bf16`
    with an f32 model raises."""
    cfg = Config.from_dict(_cfg(3, 64))
    images, labels, mask = _batch(2, 64)
    outs = []
    for kw in ({}, {"compute_dtype": T16}):
        torch.manual_seed(0)
        tr = Trainer(Detector(3, 3, dtype=T16), cfg, 1, device="cpu",
                     fused_backbone=fused, **kw)
        assert tr.compute_dtype == T16
        with torch.no_grad():
            outs.append(tr._forward(images))
    assert all(o.dtype == T16 for o in outs[0])
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    with pytest.raises(ValueError, match="bf16"):
        Trainer(Detector(3, 3), cfg, 1, device="cpu", compute_dtype=T16)


def _batch(b, hw, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, (b, hw, hw, 3)).astype(np.uint8)
    labels = np.zeros((b, 8, 5), np.float32)
    labels[:, 0] = [1, 0.5, 0.5, 0.3, 0.3]
    labels[1::2, 1] = [2, 0.3, 0.6, 0.2, 0.4]
    mask = np.zeros((b, 8), bool)
    mask[:, 0] = True
    mask[1::2, 1] = True
    return images, labels, mask


def _state_err(sd, ref):
    """(parameters: max |Δ| over the model's largest parameter; running
    statistics: per BN, max |Δ mean| over its largest running std and max
    |Δ var| over its largest running var, the worst) — the smoke's
    measures (chip_smoke.py `phase_training`): single leaves near 0 have
    no scale of their own, and a bf16 step's gradient of such a leaf is
    rounding noise, JAX's eager and jitted steps as far apart as any."""
    params = [k for k in ref if "running" not in k]
    p = (max(float(np.abs(sd[k] - ref[k]).max()) for k in params)
         / max(float(np.abs(ref[k]).max()) for k in params))
    s = 0.0
    for k in ref:
        if k.endswith("running_mean"):
            kv = k[:-len("mean")] + "var"
            std = float(np.sqrt(np.clip(ref[kv], 0, None)).max())
            s = max(s, float(np.abs(sd[k] - ref[k]).max()) / std,
                    float(np.abs(sd[kv] - ref[kv]).max())
                    / float(np.abs(ref[kv]).max()))
    return p, s


def run_jax(family, mode, cfg, images, labels, mask, steps=3):
    """JAX's bf16 Trainer → (per-step loss components, the state in the
    port's layout)."""
    from fastdet.kernels.fused_infer import pack_images_s2d
    kw = {"default": {}, "fused": dict(fused_backbone=True),
          "fused_s2d": dict(fused_backbone=True,
                            fused_input_format="s2d_u8")}[mode]
    npz = AF_NPZ if family == "anchorfree" else REF_NPZ
    fam = jget_family(family, JConfig.from_dict(cfg), dtype=BF)
    jt = JTrainer(fam.model, JConfig.from_dict(cfg), 1, compute_dtype=BF,
                  loss_fn=fam.loss_fn, **kw)
    state = jt.init_state(jax.tree.map(jnp.asarray, load_npz_variables(npz)))
    inp = pack_images_s2d(images) if mode == "fused_s2d" else images
    losses = []
    for _ in range(steps):
        state, m = jt.step(state, jnp.asarray(inp), jnp.asarray(labels),
                           jnp.asarray(mask))
        losses.append([float(m[k]) for k in ("box", "obj", "cls", "total")])
    sd = from_jax_variables({
        "params": jax.tree.map(np.asarray, state.params),
        "batch_stats": jax.tree.map(np.asarray, state.batch_stats)})
    return np.array(losses), {k: v.numpy() for k, v in sd.items()}


def run_port(family, mode, cfg, images, labels, mask, steps=3):
    from fastdet_torch.kernels.fused_infer import pack_images_s2d
    kw = {"default": {}, "fused": dict(fused_backbone=True),
          "fused_s2d": dict(fused_backbone=True,
                            fused_input_format="s2d_u8")}[mode]
    npz = AF_NPZ if family == "anchorfree" else REF_NPZ
    fam = get_family(family, Config.from_dict(cfg), dtype=T16)
    fam.model.load_state_dict(load_state_dict(npz))
    pt = Trainer(fam.model, Config.from_dict(cfg), 1, device="cpu",
                 compute_dtype=T16, loss_fn=fam.loss_fn, **kw)
    inp = pack_images_s2d(images) if mode == "fused_s2d" else images
    losses = []
    for _ in range(steps):
        m = pt.step(inp, labels, mask)
        losses.append([float(m[k]) for k in ("box", "obj", "cls", "total")])
    params = list(pt.model.parameters())
    assert all(p.dtype == torch.float32 for p in params)
    assert all(pt.optimizer.state[p]["momentum_buffer"].dtype
               == torch.float32 for p in params)
    state = {k: v.numpy().copy() for k, v in pt.model.state_dict().items()}
    with torch.no_grad():                   # (moves the running stats)
        assert all(o.dtype == T16 for o in pt._forward(inp))
    return np.array(losses), state


@pytest.mark.parametrize("family,sub", [("yolo-fastestv2", 1),
                                        ("yolo-fastestv2", 2),
                                        ("anchorfree", 1),
                                        ("anchorfree", 2)])
def test_bf16_trainer_default_matches_jax(family, sub):
    classes = 3 if family == "anchorfree" else 80
    cfg = _cfg(classes, 128, sub)
    images, labels, mask = _batch(4, 128)
    jl, jsd = run_jax(family, "default", cfg, images, labels, mask)
    pl, psd = run_port(family, "default", cfg, images, labels, mask)
    loss_rel = float((np.abs(pl - jl) / np.abs(jl)).max())
    p_rel, s_rel = _state_err(psd, jsd)
    print(f"{family} sub {sub}: losses {loss_rel:.4f}, parameters "
          f"{p_rel:.3g}, running stats {s_rel:.4f}")
    assert loss_rel <= STEP_RTOL and p_rel <= 2 ** -5 and s_rel <= 2 ** -5
