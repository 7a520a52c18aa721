"""Tensor parallel (`fastdet_torch.parallel.tp`, `Trainer(mesh=make_mesh_2d
(...))`) on the CPU: gloo ranks in subprocesses (tests/torch_tp_worker.py)
as a (data, model) mesh with n_model = 2.

  * The sharding rules: every state-dict entry's spec against JAX's
    `state_shardings` on the same variables at n_model 2, mapped through
    the port's weight names.
  * JAX's own contract (tests/test_trainer.py::
    test_tensor_parallel_matches_single_device, its inputs: 32², 4
    classes, b8, 2 steps, lr 0.01): an 8-rank (4, 2) port Trainer against
    JAX's single-device Trainer, the loss at rtol 1e-4, every parameter
    and running statistic at rtol 2e-4 atol 1e-4; the same run against
    the port's one-process Trainer at those bounds and with the momentum
    buffers within 1e-3 of their largest element (step 0's LR is 0 and
    step 1's 1e-6, so the gradients show in the momentum and not in the
    parameters; the bound is tests/test_torch_parallel_train.py's).  On
    these inputs JAX's jitted step stands 7% of the largest element from
    `jax.grad` of its own model and loss in the momentum (f64; the port's
    one-process step 7e-8 from the latter), so the momentum is held
    against the port's one process and not against JAX.  The mesh's
    coordinates and groups, `first_conv`'s weight held as 12 of 24
    channels on every rank, the gathered states bit for bit equal on all
    eight ranks.  Two mutants, each shown to miss by ≥ 10×: the gather's
    backward summed over the model group (every gradient upstream of a
    gather counted twice), and the loss's normalizers over the world.
  * A (2, 2) mesh against one process: the fused nhwc and fused s2d modes
    in f64 (B8's and B7's plain versions) at 256×288, global b4,
    `span_stages=(2,)` (ghost group 2, inside each data shard's 2 rows),
    the loss at 1e-6 (it computes in f32) and the state and momentum
    within 1e-12 of their largest element; an anchor-free default step,
    f64, at the same bounds (in f32 its momentum stands 1.8e-2 from one
    process's: BN over 16 values amplifies the rounding); a bf16 default
    step within 2⁻⁵ (phase 10's rule on the state, the momentum within
    2⁻⁵ of its largest element).  The four ranks' gathered states bit for
    bit equal.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet.config import Config as JConfig
from fastdet.models import Detector as JDetector
from fastdet.parallel.tp import make_mesh_2d as jax_mesh_2d
from fastdet.parallel.tp import state_shardings as jax_shardings
from fastdet.train.trainer import Trainer as JTrainer
from fastdet_torch.cli.train import run_training
from fastdet_torch.config import Config
from fastdet_torch.io import from_jax_variables, to_jax_variables
from fastdet_torch.models import Detector
from fastdet_torch.models.registry import get_family
from fastdet_torch.parallel import (MODEL_AXIS, make_mesh_2d, state_shardings,
                                    tensor_parallel)
from fastdet_torch.train.trainer import Trainer
from test_torch_parallel_train import (close, flat, free_port, port_tree,
                                       tree_rel)
from torch_cases import FEW_THREADS, few_torch_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_tp_worker.py")
ANCHORS = [4.0, 6.0, 9.0, 12.0, 16.0, 24.0, 24.0, 16.0, 32.0, 40.0, 52.0,
           48.0]
CFG = {"classes": 4, "width": 32, "height": 32, "anchor_num": 3,
       "anchors": ANCHORS, "learning_rate": 0.01, "steps": [1000],
       "subdivisions": 1, "batch_size": 8, "epochs": 1}
LOSS_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 2e-4, 1e-4
GRAD_REL = 1e-3
F64_LOSS_REL, F64_REL = 1e-6, 1e-12
BF16_RTOL = 2.0 ** -5


def spawn(jobs, out, timeout=600):
    """Start every job [(mode, world)] of tests/torch_tp_worker.py on DIR
    `out` at once; each rank must exit 0."""
    env = dict(os.environ, **FEW_THREADS)
    env.pop("PYTHONPATH", None)
    procs = []
    try:
        for mode, world in jobs:
            port = free_port()
            procs += [subprocess.Popen(
                [sys.executable, WORKER, mode, str(r), str(world), str(port),
                 str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=env, cwd=REPO) for r in range(world)]
        for p in procs:
            text, _ = p.communicate(timeout=timeout)
            assert p.returncode == 0, text[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def write_case(out, arrays, meta):
    np.savez(os.path.join(out, "case.npz"), **arrays)
    with open(os.path.join(out, "cfg.json"), "w") as f:
        json.dump(meta, f)


def load(path):
    with np.load(path) as z:
        run = {k: z[k] for k in z.files}
    return ({k[3:]: v for k, v in run.items() if k.startswith("sd/")},
            {k[4:]: v for k, v in run.items() if k.startswith("mom/")}, run)


def jax_contract_case():
    """tests/test_trainer.py's tensor-parallel inputs."""
    model = JDetector(classes=4, anchor_num=3)
    variables = model.init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3)),
                           train=False)
    rng = np.random.RandomState(3)
    images = rng.randint(0, 255, (2, 8, 32, 32, 3), np.uint8)
    labels = np.zeros((2, 8, 4, 5), np.float32)
    labels[..., 0, :] = [1, 0.5, 0.5, 0.5, 0.5]
    mask = np.zeros((2, 8, 4), bool)
    mask[..., 0] = True
    return model, variables, images, labels, mask


def test_shardings_match_jax():
    """Every state-dict entry's sharded dim at n_model 2 against JAX's
    `state_shardings` on the same variables: each port tensor is filled
    with its own index, so the JAX leaf it becomes names it."""
    model, variables, *_ = jax_contract_case()
    sd = from_jax_variables(jax.device_get(variables))
    keys = sorted(sd)
    tagged = {k: torch.full(sd[k].shape, float(i)) for i, k in
              enumerate(keys)}
    shardings = jax_shardings(variables, jax_mesh_2d(4, 2))
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            to_jax_variables(tagged)):
        s = shardings
        for p in path:
            s = s[p.key]
        key = keys[int(np.asarray(leaf).flat[0])]
        want[key] = None if MODEL_AXIS not in s.spec else 0
    assert set(want) == set(keys)
    local = make_mesh_2d(4, 2, devices=["cpu"] * 8)
    got = state_shardings(sd, local)
    assert got == want, {k: (got[k], want[k]) for k in keys
                         if got[k] != want[k]}
    assert sum(v is None for v in got.values()) == 2       # the obj head
    assert got["output_obj.weight"] is None and got["output_obj.bias"] is None
    assert got["backbone.first_conv.conv.weight"] == 0
    assert local.shape == {"data": 4, "model": 2} and local.size == 8


def test_local_2d_mesh_refuses_to_train():
    """One process with no job lays a 2-D mesh out but does not train on
    it: tensor parallel runs one process per device, as data parallel;
    the train CLI's `run_training` takes a 1-D mesh only."""
    mesh = make_mesh_2d(2, 2, devices=["cpu"] * 4)
    assert mesh.group is None and mesh.size == 4
    with pytest.raises(NotImplementedError, match="one process per device"):
        Trainer(Detector(4, 3), Config.from_dict(CFG), 1, mesh=mesh)
    with pytest.raises(NotImplementedError, match="one process per device"):
        tensor_parallel(Detector(4, 3), mesh)
    with pytest.raises(ValueError, match="need 8 devices"):
        make_mesh_2d(4, 2, devices=["cpu"] * 4)
    with pytest.raises(NotImplementedError, match="1-D data mesh"):
        run_training(Config.from_dict(CFG), Detector(4, 3).state_dict(),
                     lambda epoch: [], device="cpu", mesh=mesh)


def _distances(got, ref):
    return {"loss": float((np.abs(got["losses"] - ref["losses"])
                           / np.abs(ref["losses"])).max()),
            "params": close(got["params"], ref["params"], PARAM_RTOL,
                            PARAM_ATOL),
            "batch_stats": close(got["batch_stats"], ref["batch_stats"],
                                 PARAM_RTOL, PARAM_ATOL),
            "mom": tree_rel(got["mom"], ref["mom"])}


@pytest.fixture(scope="module")
def contract(tmp_path_factory):
    """JAX's single-device Trainer on its test's inputs, the port's
    one-process Trainer on them, and the 8-rank (4, 2) job's three ways
    → (JAX's tree, the one process's, {way: rank 0's tree}, DIR)."""
    out = tmp_path_factory.mktemp("tp_contract")
    model, variables, images, labels, mask = jax_contract_case()
    sd = from_jax_variables(jax.device_get(variables))
    write_case(out, {"images": images, "labels": labels, "mask": mask,
                     **{"sd/" + k: v.numpy() for k, v in sd.items()}},
               {"cfg": CFG, "steps_per_epoch": 2})
    jtr = JTrainer(model, JConfig.from_dict(CFG), steps_per_epoch=2)
    state = jtr.init_state(jax.tree.map(jnp.copy, variables))
    jl = []
    for i in range(2):
        state, m = jtr.step(state, jnp.asarray(images[i]),
                            jnp.asarray(labels[i]), jnp.asarray(mask[i]))
        jl.append([float(m[k]) for k in ("box", "obj", "cls", "total")])
    want = {"params": flat(jax.device_get(state.params)),
            "batch_stats": flat(jax.device_get(state.batch_stats)),
            "mom": flat(jax.device_get(state.opt_state[1].trace)),
            "losses": np.asarray(jl)}
    spawn([("contract", 8)], out)

    with few_torch_threads():
        m1 = Detector(4, 3)
        m1.load_state_dict(sd)
        tr1 = Trainer(m1, Config.from_dict(CFG), 2, device="cpu")
        ol = []
        for i in range(2):
            m = tr1.step(images[i], labels[i], mask[i])
            ol.append([float(m[k]) for k in ("box", "obj", "cls", "total")])
    one = dict(port_tree(tr1.model.state_dict(), {
        k: tr1.optimizer.state[p]["momentum_buffer"]
        for k, p in tr1.model.named_parameters()}), losses=np.asarray(ol))
    runs = {}
    for way in ("tp", "gather_sum", "world_loss"):
        sd0, mom0, run0 = load(out / f"contract_{way}_0.npz")
        runs[way] = dict(port_tree(
            {k: torch.from_numpy(v) for k, v in sd0.items()},
            {k: torch.from_numpy(v) for k, v in mom0.items()}),
            losses=run0["losses"])
    return want, one, runs, out


def test_mesh_2d_coordinates_and_groups(contract):
    """make_mesh_2d(4, 2) in an 8-rank job: rank r at (r // 2, r % 2),
    its data group the ranks with its m, its model group those with its
    d, as JAX reshapes the devices (n_data, n_model)."""
    out = contract[3]
    for r in range(8):
        info = json.loads((out / f"mesh_{r}.json").read_text())
        d, m = divmod(r, 2)
        assert info["coords"] == [d, m] and info["shape"] == {
            "data": 4, "model": 2} and info["axis_names"] == ["data",
                                                               "model"]
        assert info["data"] == [m, 2 + m, 4 + m, 6 + m], info
        assert info["model"] == [2 * d, 2 * d + 1], info


def test_sharded_state_and_ranks_agree(contract):
    """`first_conv`'s weight is 12 of its 24 channels on every rank; the
    gathered states, momentum buffers and logged losses are bit for bit
    equal on all eight ranks."""
    out = contract[3]
    sd0, mom0, run0 = load(out / "contract_tp_0.npz")
    for r in range(8):
        sdr, momr, runr = load(out / f"contract_tp_{r}.npz")
        assert tuple(runr["first_conv"]) == (12, 3, 3, 3)
        for a, b in ((sd0, sdr), (mom0, momr)):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(run0["losses"], runr["losses"])


def test_eight_rank_tensor_parallel_matches_jax_single_device(contract):
    want, one, runs, _ = contract
    d_jax, d_one = _distances(runs["tp"], want), _distances(runs["tp"], one)
    print("distances (loss rel, params/stats ≤ 1 passes, mom rel) against "
          "JAX:", d_jax, "against one process:", d_one)
    for got in (d_jax, d_one):
        assert got["loss"] <= LOSS_RTOL, (d_jax, d_one)
        assert got["params"] <= 1 and got["batch_stats"] <= 1, (d_jax,
                                                                 d_one)
    assert d_one["mom"] <= GRAD_REL, d_one


@pytest.mark.parametrize("way", ["gather_sum", "world_loss"])
def test_mutant_misses_one_process(contract, way):
    """The gather's backward summed counts every gradient upstream of a
    gather twice; the loss over the world counts the model ranks' equal
    losses twice.  Each misses the one process by ≥ 10× the bounds."""
    _, one, runs, _ = contract
    d = _distances(runs[way], one)
    print(way, "against one process:", d)
    assert d["mom"] > 10 * GRAD_REL, d
    if way == "world_loss":
        assert d["loss"] > 10 * LOSS_RTOL, d


def _batch(rng, b, h, w, steps=2, classes=4):
    images = rng.randint(0, 255, (steps, b, h, w, 3), np.uint8)
    labels = np.zeros((steps, b, 4, 5), np.float32)
    mask = np.zeros((steps, b, 4), bool)
    for i, n in enumerate((3, 2, 1, 0) * (b // 4)):
        for j in range(n):
            labels[:, i, j] = [(i + j) % classes, 0.3 + 0.2 * j, 0.4,
                               0.2 + 0.1 * j, 0.3]
            mask[:, i, j] = True
    return images, labels, mask


MODE_RUNS = ("fused_nhwc", "fused_s2d", "bf16", "anchorfree")


@pytest.fixture(scope="module")
def modes(tmp_path_factory):
    """The fused nhwc and s2d modes (f64), a bf16 default step and an
    anchor-free default step (f64) over a (2, 2) mesh and in one process
    → ({name: run}, DIR)."""
    out = tmp_path_factory.mktemp("tp_modes")
    torch.manual_seed(5)
    sd = Detector(classes=4, anchor_num=3).state_dict()
    small = dict(CFG, width=64, height=64, batch_size=4)
    af_cfg = dict(small, anchor_num=1)
    torch.manual_seed(6)
    af_sd = get_family("anchorfree", Config.from_dict(af_cfg)
                       ).model.state_dict()
    fused_cfg = dict(CFG, width=288, height=256, batch_size=4)
    rng = np.random.RandomState(9)
    runs = [{"name": "fused_nhwc", "cfg": fused_cfg, "dtype": "float64",
             "format": "nhwc", "span_stages": [2]},
            {"name": "fused_s2d", "cfg": fused_cfg, "dtype": "float64",
             "format": "s2d_u8", "span_stages": [2]},
            {"name": "bf16", "cfg": small, "dtype": "bfloat16"},
            {"name": "anchorfree", "cfg": af_cfg, "family": "anchorfree",
             "dtype": "float64"}]
    arrays = {"sd/" + k: v.numpy() for k, v in sd.items()}
    arrays.update({"af/" + k: v.numpy() for k, v in af_sd.items()})
    for run in runs:
        c = run["cfg"]
        for k, v in zip(("images", "labels", "mask"),
                        _batch(rng, 4, c["height"], c["width"])):
            arrays[f"{run['name']}/{k}"] = v
    write_case(out, arrays, {"runs": runs})
    spawn([("modes", 4), ("modes", 1)], out)
    return {run["name"]: run for run in runs}, out


@pytest.mark.parametrize("name", MODE_RUNS)
def test_four_rank_mode_matches_one_process(modes, name):
    run, out = modes[0][name], modes[1]
    one_sd, one_mom, one = load(out / f"{name}_1_0.npz")
    ref = {**one_sd, **{"mom/" + k: v for k, v in one_mom.items()}}
    ranks = []
    for r in range(4):
        got_sd, got_mom, got = load(out / f"{name}_4_{r}.npz")
        ranks.append((got_sd, got_mom))
        loss = float((np.abs(got["losses"] - one["losses"])
                      / np.abs(one["losses"]).clip(1e-12)).max())
        if run["dtype"] == "float64":
            rel = tree_rel({**got_sd, **{"mom/" + k: v for k, v in
                                         got_mom.items()}}, ref)
            ok = loss <= F64_LOSS_REL and rel <= F64_REL
        else:                                   # bf16: phase 10's rules
            rel = (max(float(np.abs(got_sd[k] - v).max())
                       / max(float(np.abs(v).max()), 1e-2)
                       for k, v in one_sd.items()),
                   tree_rel(got_mom, one_mom))
            ok = loss <= BF16_RTOL and max(rel) <= BF16_RTOL
        print(name, "rank", r, "loss rel", loss, "state/mom", rel)
        assert ok, (name, r, loss, rel)
    for got_sd, got_mom in ranks[1:]:
        for a, b in zip(ranks[0], (got_sd, got_mom)):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
