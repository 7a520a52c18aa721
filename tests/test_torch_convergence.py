"""The port's convergence check (`python -m
fastdet_torch.tools.convergence_check`) against the JAX package's
(`tools/convergence_check.py`) on the CPU: the synthetic task's draws
and label packing bit for bit, the eval's P/R/AP/F1 on the tool's
64-image eval set within 1e-6 of JAX's `evaluate` with the family's
detect at conf 0.05 / iou 0.45 (the anchor-free model JAX's tool trained,
`weights/anchorfree-synth.npz`, and a Yolo-FastestV2 at JAX's PRNGKey(0)
init carried across), the bar at its edges, the CLI's lines and exit
code, `--save` in the JAX layout, `--chain`, the flags' rule, and two
bf16 fused s2d steps.  A full run (600 steps of b32) is the card's:
`chip_smoke.py` phase 12.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet.config import Config as JaxConfig
from fastdet.eval.runner import evaluate as jax_evaluate
from fastdet.io.torch_convert import load_npz_variables as jax_load_npz
from fastdet.models.registry import get_family as jax_family
from fastdet.train.targets import pack_labels as jax_pack_labels
from fastdet_torch.io import from_jax_variables, load_state_dict
from fastdet_torch.models.registry import get_family
from fastdet_torch.train.targets import pack_labels
from fastdet_torch.tools import convergence_check as cc
from tools.convergence_check import make_sample as jax_make_sample
from torch_cases import FEW_THREADS, few_torch_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AF_NPZ = os.path.join(REPO, "weights", "anchorfree-synth.npz")
STEP_AP = re.compile(r"^step (\d+): mAP@0\.5 = \d+\.\d{4}$")
STEP_LOSS = re.compile(r"^step (\d+): loss=-?\d+\.\d{3} lr=\d+\.\d{5}$")
TRAINED = re.compile(r"^trained (\d+) steps in \d+s \(\d+ img/s\)$")
CURVE = re.compile(r"^AP curve: \[(.*)\]$")


@pytest.fixture(autouse=True)
def few_threads():
    with few_torch_threads():
        yield


@pytest.mark.parametrize("seed", [0, 99])
def test_samples_and_labels_are_jax(seed):
    """32 draws of the task from RandomState(seed) as the JAX tool makes
    them, and their (B, 8, 5) labels and mask as its `pack_labels`
    packs them; the batch maker draws the same stream."""
    a, b = np.random.RandomState(seed), np.random.RandomState(seed)
    got = [cc.make_sample(a, 128) for _ in range(32)]
    want = [jax_make_sample(b, 128) for _ in range(32)]
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype and np.array_equal(gi, wi)
        assert gl.dtype == wl.dtype and np.array_equal(gl, wl)
    assert a.randint(0, 1 << 30) == b.randint(0, 1 << 30)
    lab, mask = pack_labels([l for _, l in got], 8)
    jlab, jmask = jax_pack_labels([l for _, l in want], 8)
    assert np.array_equal(lab, jlab) and np.array_equal(mask, jmask)
    imgs, blab, bmask = cc.make_batch(np.random.RandomState(seed), 32)
    assert np.array_equal(imgs, np.stack([i for i, _ in want]))
    assert np.array_equal(blab, jlab) and np.array_equal(bmask, jmask)


@pytest.mark.parametrize("model", ["anchorfree", "yolo-fastestv2"])
def test_eval_is_jax(model):
    """P/R/AP/F1 on the tool's eval set within 1e-6 of JAX's."""
    images, labels, mask = cc.eval_set()
    cfg = cc.make_config(0.002, 32)
    if model == "anchorfree":
        variables = jax_load_npz(AF_NPZ)
        sd = load_state_dict(AF_NPZ)
    else:                             # JAX's init, carried across; 16 images
        images, labels, mask = images[:16], labels[:16], mask[:16]
        jmodel = jax_family(model, JaxConfig.from_dict(cfg.to_dict())).model
        variables = jax.device_get(jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)), train=False))
        sd = from_jax_variables(variables)
    fam = get_family(model, cfg)
    fam.model.load_state_dict(sd)
    got = cc.eval_result(fam.build_detect_fn(conf_thres=0.05, iou_thres=0.45,
                                             device="cpu"),
                         images, labels, mask, "cpu")
    jfam = jax_family(model, JaxConfig.from_dict(cfg.to_dict()))
    jdetect = jfam.build_detect_fn(conf_thres=0.05, iou_thres=0.45)
    want = jax_evaluate(
        jdetect, jax.tree.map(jnp.asarray, variables),
        ((jnp.asarray(images[i:i + 32]), labels[i:i + 32], mask[i:i + 32])
         for i in range(0, len(images), 32)), (128, 128))
    assert got is not None and want is not None
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if model == "anchorfree":
        assert got[2] > 0.5                     # trained by JAX's tool


@pytest.mark.parametrize("aps,ok", [
    ([0.0, 0.5], False),               # 0.5 is not over the bar
    ([0.0, 0.5000001], True),
    ([0.7, 0.7, 0.7], False),          # flat: not above the first
    ([0.8, 0.6], False),               # over 0.5, below the first
    ([0.01, 0.3, 0.9, 0.51], True),    # only the last point counts
    ([0.2], False),
])
def test_the_bar(aps, ok):
    assert cc.converged(aps) is ok


def test_main_prints_jax_lines_and_fails(tmp_path):
    """`--device cpu --steps 4 --eval_every 2 --batch 2`: the JAX tool's
    lines, 3 curve points, CONVERGENCE FAILED, exit 1."""
    env = dict(os.environ, **FEW_THREADS)
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, "-m", "fastdet_torch.tools.convergence_check",
         "--device", "cpu", "--steps", "4", "--eval_every", "2",
         "--batch", "2"], capture_output=True, text=True, timeout=300,
        env=env, cwd=REPO)
    assert r.returncode == 1, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert [int(STEP_AP.match(ln).group(1)) for ln in lines[:3]] == [0, 2, 4]
    assert TRAINED.match(lines[3]) and int(
        TRAINED.match(lines[3]).group(1)) == 4
    curve = [float(x) for x in CURVE.match(lines[4]).group(1).split(",")]
    assert len(curve) == 3 and all(0 <= a <= 1 for a in curve)
    assert lines[5:] == ["CONVERGENCE FAILED"]


@pytest.fixture
def small_eval(monkeypatch):
    """The eval set cut to its first 4 images, where a test reads the
    training, not the eval."""
    monkeypatch.setattr(cc, "eval_set", lambda: cc.make_batch(
        np.random.RandomState(99), 4))


def _run(capsys, **kw):
    record = {}
    aps = cc.run_convergence(device="cpu", record=record, **kw)
    return aps, capsys.readouterr().out.splitlines(), record


def test_save_is_the_jax_layout(tmp_path, capsys, small_eval):
    """`--save` writes what JAX's `load_npz_variables` reads into its
    model's tree (every leaf, its shape), and the port reads it back bit
    for bit; a second run from the same seed repeats exactly."""
    out = tmp_path / "w.npz"
    aps, lines, rec = _run(capsys, steps=2, eval_every=2, batch=2,
                           save=str(out))
    assert lines[-1] == f"saved {out}"
    tree = jax_load_npz(str(out))
    jmodel = jax_family("yolo-fastestv2", JaxConfig.from_dict(
        cc.make_config(0.002, 2).to_dict())).model
    init = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)), train=False))
    want = jax.tree_util.tree_leaves_with_path(init)
    got = jax.tree_util.tree_leaves_with_path(tree)
    assert sorted(str(p) for p, _ in got) == sorted(str(p) for p, _ in want)
    shapes = {str(p): tuple(v.shape) for p, v in want}
    assert all(tuple(v.shape) == shapes[str(p)] for p, v in got)
    sd = rec["trainer"].model.state_dict()
    back = load_state_dict(str(out))
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    aps2, _, rec2 = _run(capsys, steps=2, eval_every=2, batch=2)
    assert aps2 == aps
    sd2 = rec2["trainer"].model.state_dict()
    assert all(torch.equal(sd2[k], sd[k]) for k in sd)


def test_chain_prints_chain_1_lines(capsys, small_eval, monkeypatch):
    """`--chain 2` over 10 steps with a loss line every 5 (5 steps between
    evals, so the last step before each eval runs alone, as JAX's rule has
    it) prints the loss and mAP lines of `--chain 1`, and ends in the same
    parameters."""
    monkeypatch.setattr(cc, "LOSS_EVERY", 5)
    runs = [_run(capsys, steps=10, eval_every=5, batch=2, chain=k)
            for k in (1, 2)]
    keep = [[ln for ln in lines if STEP_AP.match(ln) or STEP_LOSS.match(ln)]
            for _, lines, _ in runs]
    assert [ln.split(":")[0] for ln in keep[0]] == [
        "step 0", "step 5", "step 5", "step 10", "step 10"]
    assert keep[0] == keep[1]
    sds = [rec["trainer"].model.state_dict() for _, _, rec in runs]
    assert all(torch.equal(sds[0][k], sds[1][k]) for k in sds[0])


def test_input_format_needs_the_fused_backbone(capsys):
    with pytest.raises(SystemExit) as e:
        cc.main(["--device", "cpu", "--input-format", "s2d_u8"])
    assert e.value.code == 2
    assert "--input-format s2d_u8 needs --fused-backbone" in \
        capsys.readouterr().err
    with pytest.raises(ValueError, match="fused_backbone"):
        cc.run_convergence(steps=1, input_format="s2d_u8", device="cpu")


def test_bf16_detect_ranks_f32_outputs(monkeypatch):
    """The bf16 family's detect (the tool's eval of a `--bf16` run) casts
    the model's outputs to f32 before the postprocess, as the JAX
    package's detect does: rank_decode_nms gets an f32 window (its CUDA
    wrapper refuses a bf16 one), and the detections are those of the
    postprocess on the f32-cast outputs, bit for bit."""
    from fastdet_torch.kernels import pp_fused
    from fastdet_torch.ops import postprocess as pp
    torch.manual_seed(0)
    fam = get_family("yolo-fastestv2", cc.make_config(0.002, 4),
                     dtype=torch.bfloat16)
    images = torch.from_numpy(cc.eval_set()[0][:4])
    seen = []
    plain = pp_fused.rank_decode_nms

    def spy(neg_k, *args, **kw):
        seen.append(neg_k.dtype)
        return plain(neg_k, *args, **kw)

    monkeypatch.setattr(pp, "rank_decode_nms", spy)
    dets, counts = fam.build_detect_fn(conf_thres=0.05, iou_thres=0.45,
                                       device="cpu")(images)
    assert seen == [torch.float32] and dets.dtype == torch.float32
    with torch.inference_mode():
        outs = [o.float() for o in fam.model(images.float() / 255.0)]
    rdets, rcounts = pp.postprocess(outs, np.asarray(
        cc.make_config(0.002, 4).anchors, np.float32).reshape(2, 3, 2),
        (128, 128), conf_thres=0.05, iou_thres=0.45)
    assert torch.equal(counts, rcounts) and int(counts.sum()) > 0
    assert torch.equal(dets, rdets)


def test_bf16_fused_s2d_steps(capsys):
    """Two b2 steps of `--bf16 --fused-backbone --input-format s2d_u8`
    (B7's and B8's plain bf16 versions on the CPU): two curve points,
    finite f32 parameters that moved."""
    torch.manual_seed(0)
    before = get_family("yolo-fastestv2", cc.make_config(0.002, 2))
    aps, lines, rec = _run(capsys, steps=2, eval_every=2, batch=2,
                           bf16=True, fused_backbone=True,
                           input_format="s2d_u8")
    tr = rec["trainer"]
    assert len(aps) == 2 and tr.compute_dtype == torch.bfloat16
    assert tr._fused is not None and tr.step_count == 2
    sd = tr.model.state_dict()
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all()
               for v in sd.values())
    assert lines[-1].startswith("AP curve: ")
    w = "backbone.first_conv.conv.weight"
    assert not torch.equal(sd[w].cpu(), before.model.state_dict()[w])
