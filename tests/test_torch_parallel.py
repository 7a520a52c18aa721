"""The port's parallel layer (`fastdet_torch.parallel`) on the CPU.

  * `gather_eval_stats` across two gloo ranks (tests/torch_dp_worker.py
    gather): tests/test_multihost.py's ragged per-rank stats, an empty
    tuple included, rebuilt exactly in rank order as float32 on both
    ranks, and the metrics of JAX's `ap_per_class` on them those of the
    concatenation; `process_shard` the contiguous cover of JAX's;
  * meshes: a local mesh with a device repeated, `n_devices`, the
    default's card, `batch_slices`, `shard_batch` and
    `shard_chained_batch`; the FASTDET_* variables without a coordinator
    raise; `sync_batchnorm`;
  * `ShardedPipeline` and `FusedPipeline(mesh=)` over 8 "cpu" entries on
    a b5 batch (padded to 8, trimmed to 5) against JAX's `ShardedPipeline`
    and `FusedPipeline(mesh=make_mesh())` on conftest's 8 virtual devices
    (the pipelines' tolerance of tests/test_torch_fused_serve.py in f32;
    in bf16 the JAX package's bf16 serving contract against the port's
    single-device pipeline, and against JAX's for every row more than the
    score tolerance above the threshold); the anchor-free family's
    `FusedPipeline(mesh=)` from a config without anchors against its
    single-device pipeline and JAX's; `StreamingPipeline` over a
    `ShardedPipeline`;
  * a local mesh of several devices refuses to train; `run_dryrun(2)`
    prints JAX's line, and `run_dryrun(4)` JAX's 2-D mesh line
    (`mesh=2dx2m`).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet.config import Config as JConfig
from fastdet.eval.metrics import ap_per_class
from fastdet.io.torch_convert import load_npz_variables
from fastdet.kernels.fused_infer import pack_images_s2d as jax_pack
from fastdet.models import Detector as JDetector
from fastdet.parallel.mesh import make_mesh as jax_make_mesh
from fastdet.serve import FusedPipeline as JFusedPipeline
from fastdet.serve import ShardedPipeline as JShardedPipeline
from fastdet_torch.config import Config
from fastdet_torch.io import load_state_dict
from fastdet_torch.models import Detector
from fastdet_torch.models.layers import BatchNorm
from fastdet_torch.parallel import (batch_slices, initialize_distributed,
                                    make_mesh, process_shard, shard_batch,
                                    shard_chained_batch, sync_batchnorm)
from fastdet_torch.parallel.dryrun import run_dryrun
from fastdet_torch.serve import (DevicePipeline, FusedPipeline,
                                 ShardedPipeline, StreamingPipeline)
from fastdet_torch.train.trainer import Trainer
from test_torch_parallel_train import spawn
from torch_cases import (BF16_BOX_ATOL, BF16_SCORE_ATOL,
                         assert_bf16_serving_contract, few_torch_threads,
                         make_sample, photo_crops)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_NPZ = os.path.join(REPO, "weights", "coco2017-ref.npz")
AF_NPZ = os.path.join(REPO, "weights", "anchorfree-synth.npz")
HW = (96, 128)
CFG = {"classes": 80, "width": HW[1], "height": HW[0], "anchor_num": 3,
       "anchors": [12.64, 19.39, 37.88, 51.48, 55.71, 138.31, 126.91,
                   78.23, 131.57, 214.55, 279.92, 258.87]}
CONF = 0.05


def test_two_rank_gather_eval_stats(tmp_path):
    spawn("gather", 2, tmp_path)
    runs = []
    for r in range(2):
        with np.load(tmp_path / f"gather_{r}.npz") as z:
            runs.append({k: z[k] for k in z.files})
    a, b = runs
    for k in a:
        if k != "shard":
            np.testing.assert_array_equal(a[k], b[k])
    assert str(a["dtype"]) == "float32"
    np.testing.assert_array_equal(a["lens"], [2, 0, 3])
    np.testing.assert_array_equal(a["conf"], np.asarray(
        [0.9, 0.8, 0.7, 0.6, 0.5], np.float32))
    np.testing.assert_array_equal(a["tp"], [1, 0, 1, 1, 0])
    np.testing.assert_array_equal(a["cls"], [0, 1, 0, 0, 2])
    np.testing.assert_array_equal(a["labels"], [0, 1, 1, 0, 2])
    # the global metrics: JAX's ap_per_class on the concatenation of the
    # ranks' stats in rank order
    tp = np.asarray([1., 0., 1., 1., 0.])
    conf = np.asarray([0.9, 0.8, 0.7, 0.6, 0.5])
    cls = np.asarray([0., 1., 0., 0., 2.])
    want = ap_per_class(tp, conf, cls, np.asarray([0., 1., 1., 0., 2.]))
    got = ap_per_class(a["tp"], a["conf"], a["cls"], a["labels"])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # process_shard: the contiguous cover of [0, 10), rank by rank
    (a0, a1), (b0, b1) = a["shard"], b["shard"]
    assert (a0, a1, b0, b1) == (0, 5, 5, 10)


def test_one_process_identities():
    assert process_shard(10) == (0, 10)
    assert initialize_distributed() is False


@pytest.mark.parametrize("env", [{"FASTDET_NUM_PROCESSES": "2"},
                                 {"FASTDET_PROCESS_ID": "1"}])
def test_env_without_coordinator_raises(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="FASTDET_COORDINATOR"):
        initialize_distributed()


def test_local_mesh_and_batch_placement(monkeypatch):
    mesh = make_mesh(devices=["cpu", "cpu", "cpu"])
    assert mesh.size == 3 and mesh.shape == {"data": 3}
    assert mesh.axis_names == ("data",) and mesh.group is None
    assert make_mesh(2, devices=["cpu"] * 3).size == 2
    assert [(a, b) for _, a, b in batch_slices(mesh, 6)] == [
        (0, 2), (2, 4), (4, 6)]
    with pytest.raises(ValueError, match="does not divide"):
        batch_slices(mesh, 5)
    x = np.arange(12).reshape(6, 2)
    shards = shard_batch(mesh, (x,))[0]
    assert [s.tolist() for s in shards] == [
        [[0, 1], [2, 3]], [[4, 5], [6, 7]], [[8, 9], [10, 11]]]
    chained = shard_chained_batch(mesh, (x.reshape(2, 6),))[0]
    assert [s.tolist() for s in chained] == [
        [[0, 1], [6, 7]], [[2, 3], [8, 9]], [[4, 5], [10, 11]]]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()


def test_sync_batchnorm_sets_and_clears_the_group():
    model = Detector(4, 3)
    group = object()
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    assert bns and all(m.process_group is None for m in bns)
    sync_batchnorm(model, group)
    assert all(m.process_group is group for m in bns)
    sync_batchnorm(model, None)
    assert all(m.process_group is None for m in bns)


def test_local_mesh_of_several_devices_refuses_to_train():
    cfg = Config.from_dict(dict(CFG, classes=4))
    with pytest.raises(NotImplementedError, match="one process per device"):
        Trainer(Detector(4, 3), cfg, 1, mesh=make_mesh(devices=["cpu"] * 2))


@pytest.fixture(scope="module")
def images():
    return photo_crops(5, HW, seed=4)


def _same_detections(got, want):
    assert len(got) == len(want)
    assert sum(len(d) for d in want) > 0
    for d, j in zip(got, want):
        assert d.shape == j.shape
        np.testing.assert_array_equal(d[:, 5], j[:, 5])
        np.testing.assert_allclose(d[:, 4], j[:, 4], rtol=0, atol=1e-4)
        np.testing.assert_allclose(d[:, :4], j[:, :4], rtol=0, atol=1e-2)


def bf16_rows_match(got, want):
    """The bf16 serving contract (class, box ≤ 4 px, score ≤ 0.05) for
    every row of either side whose score stands more than 0.05 above
    `CONF`, its partner taken from the other side's rows: a row nearer
    the threshold may fall on one side of it only."""
    for a, b in ((got, want), (want, got)):
        for d, j in zip(a, b):
            free = list(range(len(j)))
            for row in d[d[:, 4] > CONF + BF16_SCORE_ATOL]:
                hit = [i for i in free if j[i, 5] == row[5]
                       and np.abs(j[i, :4] - row[:4]).max() <= BF16_BOX_ATOL
                       and abs(j[i, 4] - row[4]) <= BF16_SCORE_ATOL]
                assert hit, f"no partner for {row} in {j}"
                free.remove(hit[0])


def test_sharded_pipeline_matches_jax(images):
    mesh = make_mesh(devices=["cpu"] * 8)
    sd = load_state_dict(REF_NPZ)
    with few_torch_threads():
        got = ShardedPipeline(Detector(80, 3), sd, Config.from_dict(CFG),
                              mesh=mesh, conf_thres=CONF)(images)
        one = DevicePipeline(Detector(80, 3), sd, Config.from_dict(CFG),
                             conf_thres=CONF, device="cpu")(images)
    want = JShardedPipeline(JDetector(80, 3), load_npz_variables(REF_NPZ),
                            JConfig.from_dict(CFG), mesh=jax_make_mesh(),
                            conf_thres=CONF)(images)
    _same_detections(got, want)
    _same_detections(got, one)


@pytest.mark.parametrize("dtype", [torch.float32, None])
def test_fused_pipeline_mesh_matches_jax(images, dtype):
    mesh = make_mesh(devices=["cpu"] * 8)
    sd = load_state_dict(REF_NPZ)
    with few_torch_threads():
        pipe = FusedPipeline(sd, Config.from_dict(CFG), mesh=mesh,
                             conf_thres=CONF, dtype=dtype)
        got = pipe(images)
        one = FusedPipeline(sd, Config.from_dict(CFG), conf_thres=CONF,
                            dtype=dtype, device="cpu")(images)
    jdtype = jnp.float32 if dtype == torch.float32 else None
    want = JFusedPipeline(load_npz_variables(REF_NPZ),
                          JConfig.from_dict(CFG), conf_thres=CONF,
                          dtype=jdtype, interpret=True,
                          mesh=jax_make_mesh())(np.asarray(jax_pack(images)))
    if dtype == torch.float32:
        _same_detections(got, one)
        _same_detections(got, want)
    else:
        # bf16: the JAX package's bf16 contract, also against the port's
        # own pipeline on the whole batch (an f32 ULP of the convs, whose
        # algorithm differs with the batch, can move a bf16 rounding)
        assert_bf16_serving_contract(got, one)
        bf16_rows_match(got, want)
    assert pipe.device == torch.device("cpu")


def test_fused_pipeline_mesh_anchorfree_without_anchors():
    """The anchor-free family over a mesh, from a config with no anchors
    (as the synthetic checkpoint's 3-class world has none), b3 over 2
    entries: the single-device pipeline's and JAX's detections."""
    cfg = {"classes": 3, "width": 128, "height": 128}
    rng = np.random.RandomState(5)
    img = np.stack([make_sample(rng, 128)[0] for _ in range(3)])
    sd = load_state_dict(AF_NPZ)
    with few_torch_threads():
        got = FusedPipeline(sd, Config.from_dict(cfg), family="anchorfree",
                            dtype=torch.float32,
                            mesh=make_mesh(devices=["cpu"] * 2))(img)
        one = FusedPipeline(sd, Config.from_dict(cfg), family="anchorfree",
                            dtype=torch.float32, device="cpu")(img)
    want = JFusedPipeline(load_npz_variables(AF_NPZ), JConfig.from_dict(cfg),
                          dtype=jnp.float32, interpret=True,
                          family="anchorfree", mesh=jax_make_mesh())(
        np.asarray(jax_pack(img)))
    _same_detections(got, one)
    _same_detections(got, want)


def test_streaming_over_sharded_pipeline(images):
    sd = load_state_dict(REF_NPZ)
    with few_torch_threads():
        pipe = ShardedPipeline(Detector(80, 3), sd, Config.from_dict(CFG),
                               mesh=make_mesh(devices=["cpu"] * 2),
                               conf_thres=CONF)
        got = StreamingPipeline(pipe, batch_size=3).run(list(images))
        want = pipe(images)
    assert len(got) == 5
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_dryrun_two_ranks(capfd):
    run_dryrun(2)
    out = capfd.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("dryrun")]
    assert len(line) == 1 and line[0].startswith(
        "dryrun_multichip(2): ok, mesh=2d, loss="), out
    assert np.isfinite(float(line[0].split("loss=")[1].split(",")[0]))


def test_dryrun_four_ranks_runs_the_2d_mesh(capfd):
    """From 4 devices the dry run is JAX's 2-D (data, model) mesh:
    n_model 2, tensor parallel over the conv channels."""
    run_dryrun(4)
    out = capfd.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("dryrun")]
    assert len(line) == 1 and line[0].startswith(
        "dryrun_multichip(4): ok, mesh=2dx2m, loss="), out
    assert np.isfinite(float(line[0].split("loss=")[1].split(",")[0]))
