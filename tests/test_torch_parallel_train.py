"""Data-parallel training of the port (`Trainer(mesh=)`) on the CPU: two
gloo ranks in subprocesses (tests/torch_dp_worker.py), each stepping on
its half of the global batch.

  * Against the JAX package's single-device Trainer on the global batch
    (tests/test_trainer.py's case: 32², 4 classes, b8, 2 steps), with the
    positives split unequally over the ranks (3 labels on each of rank
    0's images, 1 or 0 on rank 1's): the loss components at rtol 1e-4,
    the parameters and running statistics at rtol 2e-4 atol 1e-4, as that
    test holds its tensor-parallel run, and the momentum buffers (the
    gradients of both steps, weight decay included; the LR of step 1 is
    1e-6, so the gradients show there and not in the parameters) within
    1e-3 of their largest element (the port's one-process Trainer stands
    3.1e-4 from JAX's here: BN over 8 values at 1×1 amplifies f32
    rounding).  The two ranks end bit for bit equal.  The same run
    with each rank's loss normalized by its own rows (gradients averaged,
    as DistributedDataParallel does) and with the BatchNorms unsynced must
    miss those bounds: the test is shown to catch both.
  * The fused s2d path (B7's and B8's plain versions) at 256×288, global
    b4, `span_stages=(2,)` (ghost group 2 of the global batch, inside each
    rank's 2 rows), f64: 2 ranks against 1 process, the loss (f32, as
    JAX's) at 1e-6 and the state and momentum buffers within 1e-12 of
    their largest element (measured 9e-8, 3e-16 and 9e-15); with every
    span stage the stage-3 group of 4 would straddle the ranks and raises
    `NotImplementedError`.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet.config import Config as JConfig
from fastdet.models import Detector as JDetector
from fastdet.train.trainer import Trainer as JTrainer
from fastdet_torch.io import from_jax_variables, to_jax_variables
from fastdet_torch.models import Detector
from torch_cases import FEW_THREADS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")
CFG = {"classes": 4, "width": 32, "height": 32, "anchor_num": 3,
       "anchors": [4.0, 6.0, 9.0, 12.0, 16.0, 24.0,
                   24.0, 16.0, 32.0, 40.0, 52.0, 48.0],
       "learning_rate": 0.01, "steps": [1000], "subdivisions": 1,
       "batch_size": 8, "epochs": 1}
LOSS_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 2e-4, 1e-4
GRAD_REL = 1e-3


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(mode, world, out, timeout=300):
    """The `world` ranks of `mode` (tests/torch_dp_worker.py) on DIR
    `out`; each must exit 0."""
    env = dict(os.environ, **FEW_THREADS)
    env.pop("PYTHONPATH", None)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, mode, str(r), str(world), str(port),
         str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=REPO) for r in range(world)]
    try:
        for p in procs:
            text, _ = p.communicate(timeout=timeout)
            assert p.returncode == 0, text[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def write_case(out, sd, images, labels, mask, meta):
    np.savez(os.path.join(out, "case.npz"), images=images, labels=labels,
             mask=mask, **{"sd/" + k: v.detach().numpy()
                           for k, v in sd.items()})
    with open(os.path.join(out, "cfg.json"), "w") as f:
        json.dump(meta, f)


def load_run(path):
    with np.load(path) as z:
        run = {k: z[k] for k in z.files}
    sd = {k[3:]: torch.from_numpy(v) for k, v in run.items()
          if k.startswith("sd/")}
    mom = {k[4:]: torch.from_numpy(v) for k, v in run.items()
           if k.startswith("mom/")}
    return sd, mom, run["losses"]


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float64)
    return out


def tree_rel(got, want):
    """max|Δ| over every leaf / max|want| over every leaf (a BN bias that
    feeds another BN has a gradient of rounding noise alone, so no leaf
    is held to its own scale)."""
    assert set(got) == set(want), set(got) ^ set(want)
    return (max(float(np.abs(got[k] - v).max()) for k, v in want.items())
            / max(float(np.abs(v).max()) for v in want.values()))


def close(got, want, rtol, atol):
    """Largest per-element |Δ| / (atol + rtol·|want|): ≤ 1 passes."""
    return max(float((np.abs(got[k] - v) / (atol + rtol * np.abs(v))).max())
               for k, v in want.items())


@pytest.fixture(scope="module")
def jax_run():
    """JAX's single-device Trainer on the global batches, and the case."""
    cfg = JConfig.from_dict(CFG)
    model = JDetector(classes=4, anchor_num=3)
    variables = model.init(jax.random.PRNGKey(2),
                           jnp.zeros((1, 32, 32, 3)), train=False)
    rng = np.random.RandomState(3)
    images = rng.randint(0, 255, (2, 8, 32, 32, 3), np.uint8)
    labels = np.zeros((2, 8, 4, 5), np.float32)
    mask = np.zeros((2, 8, 4), bool)
    for s in range(2):
        for i in range(8):
            # rank 0 (rows 0-3): 3 labels an image; rank 1: 1, 1, 0, 0
            n = 3 if i < 4 else (1 if i < 6 else 0)
            for j in range(n):
                labels[s, i, j] = [(i + j) % 4, 0.3 + 0.2 * j,
                                   0.35 + 0.1 * j + 0.05 * s,
                                   0.3 + 0.1 * j, 0.4]
                mask[s, i, j] = True
    tr = JTrainer(model, cfg, steps_per_epoch=2)
    state = tr.init_state(jax.tree.map(jnp.copy, variables))
    losses = []
    for s in range(2):
        state, m = tr.step(state, jnp.asarray(images[s]),
                           jnp.asarray(labels[s]), jnp.asarray(mask[s]))
        losses.append([float(m[k]) for k in ("box", "obj", "cls", "total")])
    want = {"params": flat(jax.device_get(state.params)),
            "batch_stats": flat(jax.device_get(state.batch_stats)),
            "mom": flat(jax.device_get(state.opt_state[1].trace)),
            "losses": np.asarray(losses)}
    case = (from_jax_variables(jax.device_get(variables)), images, labels,
            mask)
    return want, case


def port_tree(sd, mom):
    v = to_jax_variables(sd)
    return {"params": flat(v["params"]), "batch_stats": flat(
        v["batch_stats"]), "mom": flat(to_jax_variables(mom)["params"])}


def distances(got, want):
    return {"loss": float((np.abs(got["losses"] - want["losses"])
                           / np.abs(want["losses"]).clip(1e-12)).max()),
            "params": close(got["params"], want["params"], PARAM_RTOL,
                            PARAM_ATOL),
            "batch_stats": close(got["batch_stats"], want["batch_stats"],
                                 PARAM_RTOL, PARAM_ATOL),
            "mom": tree_rel(got["mom"], want["mom"])}


def test_two_rank_trainer_matches_jax_single_device(jax_run, tmp_path):
    want, (sd, images, labels, mask) = jax_run
    write_case(tmp_path, sd, images, labels, mask,
               {"cfg": CFG, "steps_per_epoch": 2})
    spawn("trainer", 2, tmp_path)
    runs = {}
    for way in ("global", "local_norm", "no_bn_sync"):
        r0 = load_run(tmp_path / f"trainer_{way}_0.npz")
        if way == "global":
            r1 = load_run(tmp_path / f"trainer_{way}_1.npz")
            for a, b in zip(r0[:2], r1[:2]):
                for k in a:
                    assert torch.equal(a[k], b[k]), k
            np.testing.assert_array_equal(r0[2], r1[2])
        runs[way] = dict(port_tree(*r0[:2]), losses=r0[2])
    d = {way: distances(run, want) for way, run in runs.items()}
    print("distances (loss rel, params/stats ≤ 1 passes, mom rel):", d)
    got = d["global"]
    assert got["loss"] <= LOSS_RTOL, d
    assert got["params"] <= 1 and got["batch_stats"] <= 1, d
    assert got["mom"] <= GRAD_REL, d
    # a rank-local normalizer moves the loss and the gradients
    assert d["local_norm"]["loss"] > 10 * LOSS_RTOL, d
    assert d["local_norm"]["mom"] > 10 * GRAD_REL, d
    # unsynced BN moves the loss, the gradients and the running stats
    assert d["no_bn_sync"]["loss"] > 10 * LOSS_RTOL, d
    assert d["no_bn_sync"]["mom"] > 10 * GRAD_REL, d
    assert d["no_bn_sync"]["batch_stats"] > 10, d


FUSED_CFG = dict(CFG, width=288, height=256, batch_size=4)
FUSED_LOSS_REL = 1e-6     # the loss computes in f32, as the JAX one
FUSED_REL = 1e-12


def test_two_rank_fused_s2d_matches_one_process(tmp_path):
    torch.manual_seed(5)
    sd = Detector(classes=4, anchor_num=3).state_dict()
    rng = np.random.RandomState(9)
    images = rng.randint(0, 255, (2, 4, 256, 288, 3), np.uint8)
    labels = np.zeros((2, 4, 4, 5), np.float32)
    mask = np.zeros((2, 4, 4), bool)
    for i, n in enumerate((3, 2, 1, 0)):
        for j in range(n):
            labels[:, i, j] = [j, 0.3 + 0.2 * j, 0.4, 0.2 + 0.1 * j, 0.3]
            mask[:, i, j] = True
    write_case(tmp_path, sd, images, labels, mask,
               {"cfg": FUSED_CFG, "steps_per_epoch": 1, "dtype": "float64",
                "span_stages": [2]})
    spawn("fused", 2, tmp_path)
    spawn("fused", 1, tmp_path)
    one = load_run(tmp_path / "trainer_fused_1_0.npz")
    for r in range(2):
        two = load_run(tmp_path / f"trainer_fused_2_{r}.npz")
        dist = [float(np.abs(two[2] - one[2]).max()
                      / np.abs(one[2]).max())]
        for got, ref in zip(two[:2], one[:2]):
            dist.append(tree_rel({k: v.numpy() for k, v in got.items()},
                                 {k: v.numpy() for k, v in ref.items()}))
        print("rank", r, "loss, state, momentum:", dist)
        assert dist[0] <= FUSED_LOSS_REL and max(dist[1:]) <= FUSED_REL, \
            dist
        text = (tmp_path / f"straddle_{r}.txt").read_text()
        assert "straddle" in text and "local batch 2" in text, text
