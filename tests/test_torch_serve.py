"""The port's serving path on the CPU: `DevicePipeline` end to end against
the JAX `DevicePipeline` on a real photo, and the batcher, HTTP server and
CLI of fastdet_torch.

Pipeline tolerance: the same detections (count, order, class), scores
within 1e-4 and boxes within 1e-2 px.  The forwards agree within 2e-4 on
the logits (tests/test_torch_model.py), and that difference reaches the
outputs through the sigmoids and the (2s)²·anchor box size.
"""

import json
import os
import sys
import threading
import time
import urllib.request

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdet.config import Config as JaxConfig
from fastdet.io.torch_convert import load_npz_variables
from fastdet.models import Detector as JaxDetector
from fastdet.serve import DevicePipeline as JaxDevicePipeline
from fastdet_torch.cli import serve as serve_cli
from fastdet_torch.config import Config
from fastdet_torch.io import load_state_dict
from fastdet_torch.models import Detector
from fastdet_torch.serve import DevicePipeline
from fastdet_torch.server import DynamicBatcher, InferenceServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data", "coco.data")
REF_NPZ = os.path.join(REPO, "weights", "coco2017-ref.npz")


@pytest.fixture(scope="module")
def images():
    """The repo's photo (BGR) at 352² and its mirror image."""
    img = cv2.imread(os.path.join(REPO, "test_result.png"), cv2.IMREAD_COLOR)
    img = cv2.resize(img, (352, 352), interpolation=cv2.INTER_LINEAR)
    return np.stack([img, img[:, ::-1]])


@pytest.fixture(scope="module")
def port_pipe():
    return DevicePipeline(Detector(80, 3), load_state_dict(REF_NPZ),
                          Config.from_file(DATA), device="cpu")


@pytest.mark.parametrize("conf", [0.01, 0.3])
def test_device_pipeline_matches_jax(images, conf):
    variables = jax.tree.map(jnp.asarray, load_npz_variables(REF_NPZ))
    jax_out = JaxDevicePipeline(JaxDetector(80, 3), variables,
                                JaxConfig.from_file(DATA),
                                conf_thres=conf)(images)
    out = DevicePipeline(Detector(80, 3), load_state_dict(REF_NPZ),
                         Config.from_file(DATA), conf_thres=conf,
                         device="cpu")(images)
    assert len(out) == len(jax_out) == 2
    for d, j in zip(out, jax_out):
        assert d.shape == j.shape and len(d) > 0
        np.testing.assert_array_equal(d[:, 5], j[:, 5])
        np.testing.assert_allclose(d[:, 4], j[:, 4], rtol=0, atol=1e-4)
        np.testing.assert_allclose(d[:, :4], j[:, :4], rtol=0, atol=1e-2)


def test_device_pipeline_requires_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DevicePipeline(Detector(80, 3), load_state_dict(REF_NPZ),
                       Config.from_file(DATA))


# ---------------------------------------------------------------- batcher

def test_batcher_coalesces_concurrent_requests():
    gate = threading.Event()
    sizes = []

    def infer(items):
        sizes.append(len(items))
        if len(sizes) == 1:
            gate.wait(timeout=10)
        return [x * 2 for x in items]

    b = DynamicBatcher(infer, max_batch=32, max_wait_ms=2.0)
    results = {}
    threads = [threading.Thread(
        target=lambda i=i: results.__setitem__(i, b.submit(i)))
        for i in range(9)]
    threads[0].start()
    while not sizes:
        time.sleep(0.001)
    for t in threads[1:]:
        t.start()
    time.sleep(0.15)
    gate.set()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    b.close()
    assert results == {i: 2 * i for i in range(9)}
    assert sizes[0] == 1 and sum(sizes) == 9 and max(sizes) >= 2
    assert b.stats["requests"] == 9


def test_batcher_errors_reach_callers_and_close_rejects():
    def infer(items):
        raise ValueError("boom")

    b = DynamicBatcher(infer, max_batch=8, max_wait_ms=1.0)
    for _ in range(2):                     # the worker survives a failure
        with pytest.raises(ValueError, match="boom"):
            b.submit(1)
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(1)
    with pytest.raises(ValueError):
        DynamicBatcher(infer, max_batch=0)


# ---------------------------------------------------------------- HTTP

def _post_raw(port, img, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/detect_raw", data=img.tobytes(),
        headers={"X-Height": str(img.shape[0]), "X-Width": str(img.shape[1])})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_server_raw_requests_match_pipeline(images, port_pipe, monkeypatch):
    served = []                      # (batch, rows) as the server ran them

    def pipe(batch):
        rows = port_pipe(batch)
        served.append((batch.copy(), rows))
        return rows

    server = InferenceServer(pipe, Config.from_file(DATA), max_batch=4,
                             max_wait_ms=50.0)
    port = server.start()
    try:
        # a raw request at the model's size never imports cv2
        monkeypatch.setitem(sys.modules, "cv2", None)
        answers = [None, None]

        def client(i):
            answers[i] = _post_raw(port, images[i])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for img, ans in zip(images, answers):
            batch, out = next((b, o) for b, o in served
                              if any(np.array_equal(x, img) for x in b))
            j = next(j for j, x in enumerate(batch)
                     if np.array_equal(x, img))
            direct = port_pipe(batch)          # the same batch, called again
            rows = out[j]
            np.testing.assert_array_equal(direct[j], rows)
            assert ans["count"] == len(rows) > 0
            assert ans["image_size"] == [352, 352]
            for det, row in zip(ans["detections"], rows):
                assert det["class_id"] == int(row[5])
                assert det["box"] == [round(float(v), 2) for v in row[:4]]
                assert det["score"] == round(float(row[4]), 4)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["input_size"] == [352, 352]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=10) as r:
            assert json.loads(r.read())["requests"] == 2
        bad = urllib.request.Request(
            f"http://127.0.0.1:{port}/detect_raw", data=b"xyz",
            headers={"X-Height": "352", "X-Width": "352"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=10)
        assert e.value.code == 400
    finally:
        server.shutdown()
    assert server._serve_thread is None


def test_cli_refuses_unported_paths(capsys):
    args = ["--data", DATA, "--weights", REF_NPZ, "--device", "cpu"]
    assert serve_cli.main(args + ["--pipeline", "fused"]) == 2
    assert "not ported" in capsys.readouterr().err
    assert serve_cli.main(args + ["--model", "anchorfree"]) == 2
    assert serve_cli.main(["--data", DATA, "--weights", "missing.npz"]) == 2
