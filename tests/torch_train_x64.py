"""Subprocess helper: the port's training step against the JAX package's in
float64 (run by tests/test_torch_train_step.py; x64 is process-global in
JAX, so it runs in a process of its own, as tests/fused_train_x64.py
does).

    python tests/torch_train_x64.py default|fused|fused_s2d

f32 comparisons of two equivalent but differently ordered forwards are
dominated by ReLU mask flips on near-zero activations
(tests/fused_train_x64.py); in f64 both sides agree to ~1e-12, so the
bounds are that file's: outputs ≤ 1e-10, batch stats ≤ 1e-8, gradients ≤
1e-4 relative to each leaf's largest.  The port runs on the CPU in f64
(its kernels' plain versions); JAX in x64.

  * default: from weights/coco2017-ref.npz at 64², b4, lr 0.01,
    steps_per_epoch 1 (the configuration of
    tests/test_trainer.py::test_train_loss_decreases, with the
    checkpoint's 80 classes), the Trainers of both packages: the step-0
    gradient of the loss leaf by leaf, the loss components of 3 steps,
    and params and batch_stats after them, with subdivisions 1 and 2.
    The loss itself is computed in f32 by both (the JAX function casts
    its inputs), so its components are held to 1e-6 relative and the
    params, which move by lr·Δgrad, to 1e-8.
  * fused: `build_fused_train_apply` at 96², b4 (ghost group = batch at
    every stage, so ghost BN ≡ full-batch BN) against the JAX package's
    fused apply (Pallas interpret) and against the port's default path:
    outputs, new batch stats and the gradients of Σ outputs·r.
  * fused_s2d: the same with `input_format="s2d_u8"` (the stem through
    B7's plain versions) at b4 with stem_group 4: against JAX's s2d
    apply with span_stages=() (the stride-1 blocks as the model's own),
    and with the spans against the default path; and at b1 with the
    default stem_group 1 (per-image BN is then the batch's) against the
    default path.  The
    images are seeded noise, so no positive tie in a pool window meets
    `max_pool2d`'s other tie order.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_NPZ = os.path.join(REPO, "weights", "coco2017-ref.npz")
CFG = {"classes": 80, "width": 64, "height": 64, "anchor_num": 3,
       "anchors": [4.0, 6.0, 9.0, 12.0, 16.0, 24.0,
                   24.0, 16.0, 32.0, 40.0, 52.0, 48.0],
       "learning_rate": 0.01, "steps": [1000], "subdivisions": 1,
       "batch_size": 4, "epochs": 1}


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def worst(port: dict, ref: dict, eps=1e-6):
    """Largest per-leaf max|Δ| / (max|ref| + eps) over matching keys."""
    assert set(port) == set(ref), set(port) ^ set(ref)
    w = ("", 0.0)
    for k, v in ref.items():
        r = float(np.abs(np.asarray(port[k], np.float64) - v).max()
                  / (np.abs(v).max() + eps))
        if r > w[1]:
            w = (k, r)
    return w


def jax_variables():
    from fastdet.io.torch_convert import load_npz_variables
    v = load_npz_variables(REF_NPZ)
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)


def port_keys(tree, coll):
    """A JAX params/batch_stats tree (or a grads tree) in f64 → the port's
    state_dict keys and layouts, in f64.  The carrier converts to f32, so
    each leaf goes through it as the f32 sum hi + lo, which is exact to
    ~1e-15."""
    from fastdet_torch.io import from_jax_variables
    hi = jax.tree.map(lambda a: np.asarray(a).astype(np.float32), tree)
    lo = jax.tree.map(lambda a, h: (np.asarray(a) - h).astype(np.float32),
                      tree, hi)
    sd_hi = from_jax_variables({coll: hi})
    sd_lo = from_jax_variables({coll: lo})
    return {k: v.double().numpy() + sd_lo[k].double().numpy()
            for k, v in sd_hi.items()}


def batch(b, hw, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, (b, hw, hw, 3)).astype(np.uint8)
    labels = np.zeros((b, 8, 5), np.float32)
    labels[:, 0] = [1, 0.5, 0.5, 0.3, 0.3]
    labels[1::2, 1] = [7, 0.3, 0.6, 0.2, 0.4]
    mask = np.zeros((b, 8), bool)
    mask[:, 0] = True
    mask[1::2, 1] = True
    return images, labels, mask


def port_model(variables):
    from fastdet_torch.io import from_jax_variables
    from fastdet_torch.models import Detector
    m = Detector(80, 3)
    m.load_state_dict(from_jax_variables(jax.tree.map(np.asarray,
                                                      variables)))
    return m.double()


def check_default():
    from fastdet.config import Config as JConfig
    from fastdet.models import Detector as JDetector
    from fastdet.train.trainer import Trainer as JTrainer
    from fastdet_torch.config import Config
    from fastdet_torch.train.trainer import Trainer

    variables = jax_variables()
    jmodel = JDetector(classes=80, anchor_num=3, dtype=jnp.float64)
    images, labels, mask = batch(4, 64)

    for sub in (1, 2):
        cfg = dict(CFG, subdivisions=sub)
        jt = JTrainer(jmodel, JConfig.from_dict(cfg), steps_per_epoch=1,
                      compute_dtype=jnp.float64)
        state = jt.init_state(jax.tree.map(jnp.copy, variables))
        pt = Trainer(port_model(variables), Config.from_dict(cfg), 1,
                     device="cpu")
        for step in range(3):
            state, jm = jt.step(state, jnp.asarray(images),
                                jnp.asarray(labels), jnp.asarray(mask))
            pm = pt.step(images, labels, mask)
            for k in ("box", "obj", "cls", "total"):
                r = abs(float(pm[k]) - float(jm[k])) / abs(float(jm[k]))
                assert r < 1e-6, (sub, step, k, float(pm[k]), float(jm[k]))
            assert pm["lr"] == float(jm["lr"]), (pm["lr"], float(jm["lr"]))
            if sub == 2 and step == 0:
                # the first micro-step's summed gradient, not yet applied
                w = worst({k: p.grad.numpy()
                           for k, p in pt.model.named_parameters()},
                          port_keys(state.grad_accum, "params"))
                assert w[1] < 1e-4, f"step-0 grads diverge: {w}"
                print(f"MAXDIFF default step-0 grads {w[1]:.3e} ({w[0]})")
        sd = {k: v.numpy() for k, v in pt.model.state_dict().items()}
        ref = port_keys(state.params, "params")
        ref.update(port_keys(state.batch_stats, "batch_stats"))
        w = worst(sd, ref)
        assert w[1] < 1e-8, f"subdivisions={sub}: state diverges: {w}"
        print(f"MAXDIFF default subdivisions={sub} params and batch_stats "
              f"after 3 steps {w[1]:.3e} ({w[0]})")


def fused_case(input_format, b, stem_group=None, span_stages=(2, 3, 4),
               with_jax=True):
    """The port's fused apply at 96² (f64) against JAX's fused apply (if
    with_jax) and against the port's default path: outputs, new batch
    stats and the gradients of Σ outputs·r."""
    from fastdet.kernels.fused_infer import pack_images_s2d
    from fastdet.train.fused_forward import \
        build_fused_train_apply as jbuild
    from fastdet_torch.train.fused_forward import build_fused_train_apply

    variables = jax_variables()
    images = batch(b, 96, seed=1)[0]
    fused_in = (pack_images_s2d(images) if input_format == "s2d_u8"
                else images)
    shapes = [(b, 6, 6, 12), (b, 6, 6, 3), (b, 6, 6, 80),
              (b, 3, 3, 12), (b, 3, 3, 3), (b, 3, 3, 80)]
    rng = np.random.RandomState(2)
    r = [rng.randn(*s) for s in shapes]
    refs = []
    if with_jax:
        japply = jbuild((96, 96), dtype=jnp.float64, interpret=True,
                        input_format=input_format, stem_group=stem_group,
                        span_stages=span_stages)
        params, stats = variables["params"], variables["batch_stats"]

        def jloss(params):
            outs, new = japply(params, stats, jnp.asarray(fused_in))
            return sum(jnp.sum(o * w) for o, w in zip(outs, r)), (outs, new)

        (_, (jouts, jnew)), jg = jax.value_and_grad(jloss,
                                                    has_aux=True)(params)
        refs.append(("jax", ([np.asarray(o) for o in jouts],
                             port_keys(jnew, "batch_stats"),
                             port_keys(jg, "params"))))

    apply_fn = build_fused_train_apply((96, 96), input_format=input_format,
                                       stem_group=stem_group,
                                       span_stages=span_stages, device="cpu")
    results = {}
    for mode in ("fused", "default"):
        model = port_model(variables).train()
        if mode == "fused":
            outs = apply_fn(model, torch.from_numpy(fused_in))
        else:
            outs = model(torch.from_numpy(images).double() / 255.0)
        sum((o * torch.from_numpy(w)).sum()
            for o, w in zip(outs, r)).backward()
        results[mode] = (
            [o.detach().numpy() for o in outs],
            {k: v.numpy() for k, v in model.state_dict().items()
             if "running" in k},
            {k: p.grad.numpy() for k, p in model.named_parameters()})
    refs.append(("port default", results["default"]))
    tag = (f"{input_format} b{b} stem_group={stem_group} "
           f"span_stages={span_stages}")
    for ref_name, (ref_outs, ref_stats, ref_grads) in refs:
        outs, new, grads = results["fused"]
        w_out = max(rel(a, b) for a, b in zip(outs, ref_outs))
        assert w_out < 1e-10, f"{tag} vs {ref_name}: outputs {w_out}"
        w_st = worst(new, ref_stats)
        assert w_st[1] < 1e-8, f"{tag} vs {ref_name}: stats {w_st}"
        w_g = worst(grads, ref_grads)
        assert w_g[1] < 1e-4, f"{tag} vs {ref_name}: grads {w_g}"
        print(f"MAXDIFF fused {tag} vs {ref_name}: outputs {w_out:.3e}, "
              f"batch_stats {w_st[1]:.3e}, grads {w_g[1]:.3e} ({w_g[0]})")


def check_fused():
    fused_case("nhwc", 4)


def check_fused_s2d():
    """The stem through B7's plain versions at b4 with stem_group 4 (ghost
    BN ≡ full-batch BN): against JAX with span_stages=() on both sides
    (JAX's span kernels in interpret mode would take ~60 s more; the
    fused mode holds them), and with the spans against the default path;
    at b1 with the default group 1 against the default path."""
    fused_case("s2d_u8", 4, stem_group=4, span_stages=())
    fused_case("s2d_u8", 4, stem_group=4, with_jax=False)
    fused_case("s2d_u8", 1, with_jax=False)


AF_NPZ = os.path.join(REPO, "weights", "anchorfree-synth.npz")
AF_CFG = dict(CFG, classes=3)


def af_labels(nc):
    """Labels for 8 × 6 cells at 128 × 96 (b3, 6 slots), classes < nc:
    image 0 a box in the top-left and one in the bottom-right border cell,
    two boxes in one cell (the obj target's scatter-max), a box whose
    neighbour cells all qualify, a masked slot holding a real-looking
    box; image 1 only masked slots; image 2 one box on a cell's edges."""
    labels = np.zeros((3, 6, 5), np.float32)
    mask = np.zeros((3, 6), bool)
    c = [min(i, nc - 1) for i in range(3)]
    labels[0, :5] = [[c[0], 0.01, 0.02, 0.2, 0.3],
                     [c[1], 0.99, 0.985, 0.1, 0.1],
                     [c[2], 0.52, 0.43, 0.3, 0.25],
                     [c[0], 0.55, 0.47, 0.15, 0.2],
                     [c[1], 0.40, 0.30, 0.25, 0.25]]
    mask[0, :4] = True
    labels[0, 5] = [c[2], 0.75, 0.6, 0.2, 0.2]           # masked
    labels[1, :2] = [[c[1], 0.3, 0.3, 0.2, 0.2], [c[0], 0.6, 0.5, 0.4, 0.1]]
    labels[2, 0] = [c[2], 0.5, 0.5, 0.5, 0.5]
    mask[2, 0] = True
    mask[0, 4] = True
    return labels, mask


def check_anchorfree_loss():
    """`anchorfree_loss` and its gradients with respect to the three raw
    maps, f64 maps into both (each casts them to f32, as the JAX function
    does, so the loss itself is f32 arithmetic): components within 1e-6
    relative, gradients within 1e-5 of each map's largest."""
    from fastdet.models.anchorfree import anchorfree_loss as jloss
    from fastdet_torch.models.anchorfree import anchorfree_loss

    rng = np.random.RandomState(5)
    for nc in (3, 1):
        maps = [rng.randn(3, 8, 6, c) * 2.0 for c in (1, nc, 4)]
        labels, mask = af_labels(nc)

        def jtotal(*outs):
            total, comps = jloss(outs, jnp.asarray(labels),
                                 jnp.asarray(mask), (128, 96))
            return total, comps

        (jt, jcomps), jg = jax.value_and_grad(
            jtotal, argnums=(0, 1, 2), has_aux=True)(
                *[jnp.asarray(m) for m in maps])
        outs = [torch.from_numpy(m).requires_grad_() for m in maps]
        total, comps = anchorfree_loss(outs, torch.from_numpy(labels),
                                       torch.from_numpy(mask), (128, 96))
        total.backward()
        for k in ("box", "obj", "cls", "total"):
            want = float(jcomps[k])
            got = float(comps[k].detach())
            r = abs(got - want) / max(abs(want), 1e-30)
            assert r < 1e-6 or (want == 0 and got == 0), (nc, k, got, want)
        assert float(jcomps["box"]) > 0 and float(jcomps["obj"]) > 0
        assert (float(jcomps["cls"]) > 0) == (nc > 1)
        for name, o, g in zip(("obj", "cls", "reg"), outs, jg):
            g = np.asarray(g)
            # nc = 1: no cls term, so no gradient reaches that map (JAX's
            # is zeros)
            got = (np.zeros_like(g) if o.grad is None
                   else o.grad.numpy())
            assert o.grad is not None or (nc == 1 and name == "cls")
            w = rel(got, g)
            assert w < 1e-5, (nc, name, w)
            print(f"MAXDIFF anchorfree loss nc={nc} d{name} {w:.3e}")
        # duplicates: the cell of the two boxes of image 0 takes both
        # boxes' reg gradients (JAX's gather accumulates them too)
        assert float(outs[2].grad[0, 3, 3].abs().sum()) > 0


def check_anchorfree_step():
    """The Trainer with the anchor-free loss from the synth checkpoint at
    64², b4: three steps with subdivisions 1 and 2 against
    JAX's Trainer(loss_fn=) in f64, as `check_default` holds the default
    family."""
    from fastdet.config import Config as JConfig
    from fastdet.io.torch_convert import load_npz_variables
    from fastdet.models.registry import get_family as jget_family
    from fastdet.train.trainer import Trainer as JTrainer
    from fastdet_torch.config import Config
    from fastdet_torch.io import from_jax_variables
    from fastdet_torch.models.registry import get_family
    from fastdet_torch.train.trainer import Trainer

    variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                             load_npz_variables(AF_NPZ))
    images, labels, mask = batch(4, 64, seed=3)
    labels[..., 0] = np.minimum(labels[..., 0], 2)
    for sub in (1, 2):
        cfg = dict(AF_CFG, subdivisions=sub)
        jfam = jget_family("anchorfree", JConfig.from_dict(cfg),
                           dtype=jnp.float64)
        jt = JTrainer(jfam.model, JConfig.from_dict(cfg), steps_per_epoch=1,
                      compute_dtype=jnp.float64, loss_fn=jfam.loss_fn)
        state = jt.init_state(jax.tree.map(jnp.copy, variables))
        fam = get_family("anchorfree", Config.from_dict(cfg))
        fam.model.load_state_dict(from_jax_variables(
            jax.tree.map(np.asarray, variables)))
        pt = Trainer(fam.model.double(), Config.from_dict(cfg), 1,
                     device="cpu", loss_fn=fam.loss_fn)
        for step in range(3):
            state, jm = jt.step(state, jnp.asarray(images),
                                jnp.asarray(labels), jnp.asarray(mask))
            pm = pt.step(images, labels, mask)
            for k in ("box", "obj", "cls", "total"):
                r = abs(float(pm[k]) - float(jm[k])) / abs(float(jm[k]))
                assert r < 1e-6, (sub, step, k, float(pm[k]), float(jm[k]))
            assert pm["lr"] == float(jm["lr"]), (pm["lr"], float(jm["lr"]))
            if sub == 2 and step == 0:
                w = worst({k: p.grad.numpy()
                           for k, p in pt.model.named_parameters()},
                          port_keys(state.grad_accum, "params"))
                assert w[1] < 1e-4, f"step-0 grads diverge: {w}"
                print(f"MAXDIFF anchorfree step-0 grads {w[1]:.3e} ({w[0]})")
        sd = {k: v.numpy() for k, v in pt.model.state_dict().items()}
        ref = port_keys(state.params, "params")
        ref.update(port_keys(state.batch_stats, "batch_stats"))
        w = worst(sd, ref)
        assert w[1] < 1e-8, f"subdivisions={sub}: state diverges: {w}"
        print(f"MAXDIFF anchorfree subdivisions={sub} params and "
              f"batch_stats after 3 steps {w[1]:.3e} ({w[0]})")


def check_anchorfree():
    check_anchorfree_loss()
    check_anchorfree_step()


if __name__ == "__main__":
    {"default": check_default, "fused": check_fused,
     "fused_s2d": check_fused_s2d,
     "anchorfree": check_anchorfree}[sys.argv[1]]()
    print("PASS")
