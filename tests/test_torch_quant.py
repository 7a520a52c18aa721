"""The port's int8 PTQ (`fastdet_torch.quant`) against the JAX package's
(`fastdet.quant`) on the CPU, at small sizes, on inputs seeded with numpy.

The integer chain is held bit for bit: each op's int8 input and its
integer accumulator (both MAC units of the port against JAX's default
"bf16" MAC; JAX's values are recorded inside its own jitted forward,
nothing of the JAX package changes).  The last rescale, acc·(sx·sw) + b,
may round differently where XLA contracts it into a fused multiply-add,
so outputs are held within 2 units in the last place of the larger of
|acc·(sx·sw)| and |y| (`ULPS`).  Folding and weight quantization are
numpy in both packages and held bitwise; the calibration runs f32 convs
in XLA and in PyTorch and is held within one histogram bin.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fastdet.quant.ptq as jptq
from fastdet.io import load_variables
from fastdet.quant import (calibrate as jax_calibrate, fold_model as
                           jax_fold_model, load_quantized as jax_load,
                           quantize_weights as jax_quantize_weights,
                           save_quantized as jax_save)
from fastdet_torch.io import load_state_dict
from fastdet_torch.models import Detector
from fastdet_torch.models.anchorfree import AnchorFreeDetector
from fastdet_torch.quant import ptq
from torch_cases import photo_crops
from fastdet_torch.quant import (build_int8_forward, calibrate, fold_model,
                                 forward_from, infer_family, load_quantized,
                                 quantize_weights, save_quantized)

COCO = "weights/coco2017-ref.npz"
AF = "weights/anchorfree-synth.npz"
INT8 = "weights/coco-int8.npz"
ULPS = 2
MACS = ("bf16", "int32")


@pytest.fixture(scope="module")
def coco_int8():
    return load_quantized(INT8), jax_load(INT8)


# ------------------------------------------------ JAX's recorded chain

class _Scaled:
    """sx·sw of one JAX op: records the accumulator it rescales."""

    def __init__(self, v, sink):
        self.v, self.sink = v, sink

    def __rmul__(self, acc):
        self.sink.append(acc)
        return acc * self.v


class _Sw:
    """An op's sw in JAX's weight dict: `sx * sw` becomes a `_Scaled`."""

    def __init__(self, v, sink):
        self.v, self.sink = v, sink

    def __rmul__(self, sx):
        return _Scaled(sx * self.v, self.sink)


class _RecQuantOps(jptq.QuantOps):
    """JAX's QuantOps whose ops note their name for the `_quant_in`
    recorder and whose weight scales record the accumulators."""

    def __init__(self, qw, scales, rec, mac):
        self.rec, self.cur = rec, None
        sinks = {n: rec.setdefault(n, {"xq": [], "acc": []})["acc"]
                 for n in qw}
        wrapped = {n: {"wq": q["wq"], "b": q["b"],
                       "sw": _Sw(q["sw"], sinks[n])} for n, q in qw.items()}
        super().__init__(wrapped, scales, mac=mac)

    def _taps_conv(self, name, x, stride, relu, groups):
        self.cur = name
        return super()._taps_conv(name, x, stride, relu, groups)

    def pw(self, name, x, relu):
        self.cur = name
        return super().pw(name, x, relu)


def jax_chain(monkeypatch, qw, scales, run, mac="bf16"):
    """run(ops) under JAX's own jit with every op's int8 input and
    accumulator recorded → (run's outputs, {name: {"xq": [...], "acc":
    [...]}}) as numpy."""
    ops_box = {}
    quant_in = jptq._quant_in

    def recording_quant_in(x, scale):
        xq = quant_in(x, scale)
        ops = ops_box["ops"]
        ops.rec[ops.cur]["xq"].append(xq)
        return xq

    monkeypatch.setattr(jptq, "_quant_in", recording_quant_in)
    qdev = jax.tree.map(jnp.asarray, {k: dict(v) for k, v in qw.items()})

    def traced(weights):
        rec = {}
        ops_box["ops"] = _RecQuantOps(weights, scales, rec, mac)
        return run(ops_box["ops"]), {k: v for k, v in rec.items()
                                     if v["xq"]}

    outs, rec = jax.device_get(jax.jit(traced)(qdev))
    return outs, rec


def assert_chain_equal(port_rec, jax_rec):
    """Every op's int8 inputs and accumulators bitwise JAX's."""
    assert set(port_rec) == set(jax_rec)
    for name, calls in port_rec.items():
        want = jax_rec[name]
        assert len(calls) == len(want["xq"]) == len(want["acc"]), name
        for (xq, acc), wxq, wacc in zip(calls, want["xq"], want["acc"]):
            np.testing.assert_array_equal(xq.numpy(), np.asarray(wxq),
                                          err_msg=f"{name} int8 input")
            np.testing.assert_array_equal(
                acc.to(torch.float64).numpy(),
                np.asarray(wacc, np.float64), err_msg=f"{name} accumulator")


def ulps(got, want, scaled) -> float:
    """max |got − want| in units in the last place of max(|acc·(sx·sw)|,
    |want|) elementwise."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.abs(np.asarray(scaled, np.float32)), np.abs(want))
    return float((np.abs(got - want) / np.spacing(mag)).max())


def scaled_acc(ops, name, acc):
    return (acc.to(torch.float32) * ops.ops[name]["ssw"]).numpy()


def seeded_q(seed, shape):
    return np.random.RandomState(seed).randint(-127, 128, shape).astype(
        np.int8)


# --------------------------------------------------- folding and weights

@pytest.mark.parametrize("path", [COCO, AF])
def test_fold_model_matches_jax(path):
    got = fold_model(load_state_dict(path))
    want = jax_fold_model(load_variables(path))
    assert set(got) == set(want)
    assert infer_family(got) == infer_family(want)
    for name, q in want.items():
        for k in ("w", "b"):
            w = np.asarray(q[k])
            assert got[name][k].shape == w.shape, (name, k)
            np.testing.assert_allclose(got[name][k], w, rtol=0,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("path", [COCO, AF])
def test_quantize_weights_matches_jax(path):
    """wq, sw and b bitwise (the folds are equal, and the arithmetic is
    the same numpy); a ±1 tie in wq would show in the count below."""
    got = quantize_weights(fold_model(load_state_dict(path)))
    want = jax_quantize_weights(jax_fold_model(load_variables(path)))
    assert set(got) == set(want)
    ties = 0
    for name, q in want.items():
        d = got[name]["wq"].numpy().astype(np.int32) - np.asarray(
            q["wq"], np.int32)
        ties += int(np.count_nonzero(d))
        assert np.abs(d).max() <= 1, name
        np.testing.assert_array_equal(got[name]["sw"].numpy(),
                                      np.asarray(q["sw"]), err_msg=name)
        np.testing.assert_array_equal(got[name]["b"].numpy(),
                                      np.asarray(q["b"]), err_msg=name)
    assert ties == 0, f"{ties} wq entries one step from JAX's"


# ----------------------------------------------------------- single ops

# (kind, kh, cin, cout, stride, input hw): the stem conv, the backbone's
# 3×3 depthwise at both strides, the heads' 5×5 depthwise, a pointwise
OP_CASES = (("conv", 3, 3, 24, 2, (13, 10)), ("conv", 3, 3, 24, 1, (7, 9)),
            ("dw", 3, 1, 24, 1, (9, 8)), ("dw", 3, 1, 24, 2, (11, 8)),
            ("dw", 5, 1, 16, 1, (7, 6)), ("pw", 1, 48, 40, 1, (5, 6)))


@pytest.mark.parametrize("mac", MACS)
@pytest.mark.parametrize("case", OP_CASES,
                         ids=lambda c: f"{c[0]}{c[1]}s{c[4]}")
def test_quant_op_matches_jax(monkeypatch, case, mac):
    kind, k, cin, cout, stride, (h, w) = case
    rng = np.random.RandomState(OP_CASES.index(case))
    c = cout if kind == "dw" else cin
    x = (rng.randn(2, h, w, c) * 1.5).astype(np.float32)
    name = "op"
    qw = {name: {"wq": seeded_q(int(rng.randint(1 << 30)), (k, k, cin, cout)),
                 "sw": (rng.rand(cout) * 0.02 + 1e-3).astype(np.float32),
                 "b": rng.randn(cout).astype(np.float32)}}
    scales = {name: float(np.abs(x).max() / 127 * 0.8)}   # some clip

    def run(ops):
        xs = jnp.asarray(x) if isinstance(ops, jptq.QuantOps) else \
            torch.from_numpy(x)
        if kind == "pw":
            return ops.pw(name, xs, relu=True)
        return getattr(ops, kind)(name, xs, stride=stride, relu=False)

    want, jrec = jax_chain(monkeypatch, qw, scales, run)
    port_qw = {name: {kk: torch.from_numpy(v) for kk, v in qw[name].items()}}
    rec = {}
    ops = ptq.QuantOps(port_qw, scales, mac=mac, device="cpu", record=rec)
    got = run(ops)
    assert_chain_equal(rec, jrec)
    assert got.shape == want.shape
    assert ulps(got.numpy(), want, scaled_acc(ops, name, rec[name][0][1])) \
        <= ULPS


def test_rescale_is_one_fused_multiply_add():
    """acc·(sx·sw) + b rounds once, as XLA's contraction of JAX's rescale
    does (bitwise jit(a*s + b)); a product and a sum apart would round
    twice and differ in about a quarter of the elements."""
    rng = np.random.RandomState(4)
    n = 4096
    sw = (rng.rand(n) * 0.02 + 1e-4).astype(np.float32)
    qw = {"op": {"wq": torch.ones(1, 1, 1, n, dtype=torch.int8),
                 "sw": torch.from_numpy(sw),
                 "b": torch.from_numpy(rng.randn(n).astype(np.float32))}}
    ops = ptq.QuantOps(qw, {"op": 0.0137}, device="cpu")
    p = ops.ops["op"]
    acc = torch.from_numpy(rng.randint(-4_645_152, 4_645_153, (8, n))
                           .astype(np.float32))
    got = ops._out("op", p, None, acc, relu=False).numpy()
    s, b = p["ssw"].numpy(), p["b"].numpy()
    want = np.asarray(jax.jit(lambda a, s, b: a * s + b)(acc.numpy(), s, b))
    np.testing.assert_array_equal(got, want)
    assert (acc.numpy() * s + b != want).mean() > 0.05


def test_int_mm_pads_rows_and_columns():
    """The CUDA int32 MAC's operand padding (rows past 16, K and N to
    multiples of 8), through `torch._int_mm` on the CPU."""
    a = torch.from_numpy(seeded_q(1, (3, 27)))
    w = torch.from_numpy(seeded_q(2, (27, 3)))
    wp = torch.nn.functional.pad(w, (0, 5, 0, 5))
    got = ptq._int_mm(a, wp, 3)
    assert got.dtype == torch.int32 and got.shape == (3, 3)
    assert torch.equal(got, a.to(torch.int32) @ w.to(torch.int32))


# ------------------------------------------------------- whole forward

def port_forward(qw, scales, images, mac):
    rec = {}
    outs = forward_from(qw, scales, mac=mac, device="cpu")(images, record=rec)
    return [o.numpy() for o in outs], rec


def check_forward(monkeypatch, port_qw, jax_qw, scales, images):
    """Both port MACs bitwise each other; the chain bitwise JAX's; the maps
    within ULPS of JAX's."""
    fwd = jptq.folded_forward_for(jax_qw)
    want, jrec = jax_chain(monkeypatch, jax_qw, scales,
                           lambda ops: fwd(jnp.asarray(images), ops))
    got, rec = port_forward(port_qw, scales, images, "bf16")
    got_i, rec_i = port_forward(port_qw, scales, images, "int32")
    for a, b in zip(got, got_i):
        np.testing.assert_array_equal(a, b)
    assert_chain_equal(rec, jrec)
    assert_chain_equal(rec_i, jrec)
    ops = ptq.QuantOps(port_qw, scales, device="cpu")
    heads = [n for n in port_qw if n.startswith("out")]
    # the maps in call order of the heads (shared heads: both sites)
    calls = {n: iter(rec[n]) for n in heads}
    order = ([h for h in ("output_reg", "output_obj", "output_cls")] * 2
             if infer_family(port_qw) == "yolo-fastestv2"
             else ["out_obj", "out_cls", "out_reg"])
    assert len(got) == len(want) == len(order)
    worst = 0.0
    for g, w, head in zip(got, want, order):
        assert g.shape == np.asarray(w).shape
        assert np.isfinite(g).all()
        acc = next(calls[head])[1]
        worst = max(worst, ulps(g, w, scaled_acc(ops, head, acc)))
    assert worst <= ULPS, worst


@pytest.mark.parametrize("n,hw", [(8, (96, 96)), (4, (64, 96)),
                                  (2, (352, 352))])
def test_forward_from_matches_jax(monkeypatch, coco_int8, n, hw):
    (qw, scales), (jqw, jscales) = coco_int8
    assert scales == jscales
    check_forward(monkeypatch, qw, jqw, scales, photo_crops(n, hw, n))


def test_forward_from_anchorfree_matches_jax(monkeypatch, tmp_path):
    """A quantized `anchorfree-synth` at 128²: calibrated and quantized by
    the port, written, read back by both packages."""
    rng = np.random.RandomState(5)
    calib = rng.randint(0, 256, (3, 128, 128, 3)).astype(np.uint8)
    folded = fold_model(load_state_dict(AF))
    assert infer_family(folded) == "anchorfree"
    path = str(tmp_path / "af-int8.npz")
    save_quantized(path, quantize_weights(folded),
                   calibrate(folded, calib, batch=2, device="cpu"))
    (qw, scales), (jqw, jscales) = load_quantized(path), jax_load(path)
    assert scales == jscales and infer_family(jqw) == "anchorfree"
    images = rng.randint(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    check_forward(monkeypatch, qw, jqw, scales, images)
    # the same in one call: fold, calibrate, quantize → forward
    fwd, built = build_int8_forward(load_state_dict(AF), calib,
                                    device="cpu")
    assert built == scales
    for a, b in zip(fwd(images), forward_from(qw, scales, device="cpu")(
            images)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("family", ["yolo-fastestv2", "anchorfree"])
def test_float_ops_forward_matches_model(family):
    """forward_folded(FloatOps) equals the port's model to folding
    precision (so int8 error is quantization's alone)."""
    if family == "anchorfree":
        model, path, hw = AnchorFreeDetector(3), AF, (128, 128)
    else:
        model, path, hw = Detector(80, 3), COCO, (96, 96)
    sd = load_state_dict(path)
    model.load_state_dict(sd)
    model.eval()
    images = np.random.RandomState(9).randint(0, 256, (2, *hw, 3)).astype(
        np.uint8)
    x = torch.from_numpy(images)
    folded = fold_model(sd)
    with torch.no_grad():
        want = model(x.to(torch.float32) / 255.0)
        got = ptq.folded_forward_for(folded)(x, ptq.FloatOps(folded,
                                                             device="cpu"))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-4,
                                   rtol=0, err_msg=f"output {i}")


# ---------------------------------------------------------- calibration

@pytest.mark.parametrize("bins", [2048, 7])
def test_histogram_matches_jnp(bins):
    """Counts bitwise `jnp.histogram`'s, with values on every edge, at
    mx, above mx and at 0; the edges bitwise too."""
    rng = np.random.RandomState(bins)
    mx = float(np.float32(3.7173))
    edges = np.asarray(jnp.histogram_bin_edges(jnp.zeros(1), bins,
                                               range=(0.0, mx)))
    np.testing.assert_array_equal(ptq.histogram_edges(mx, bins).numpy(),
                                  edges)
    a = np.concatenate([
        edges, np.nextafter(edges, np.float32(0)).astype(np.float32),
        np.nextafter(edges, np.float32(9)).astype(np.float32),
        np.float32([0, mx, mx, np.float32(mx * 1.5)]),
        (rng.rand(5000) * mx).astype(np.float32)]).astype(np.float32)
    want = np.asarray(jnp.histogram(jnp.asarray(a), bins=bins,
                                    range=(0.0, mx))[0])
    got = ptq.histogram(torch.from_numpy(a), ptq.histogram_edges(mx, bins))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("method", ["percentile", "max"])
def test_calibrate_matches_jax(method):
    """Scales within one histogram bin (max/2048/127) of JAX's, both
    methods; every op, the shared heads included."""
    rng = np.random.RandomState(11)
    images = rng.randint(0, 256, (4, 96, 96, 3)).astype(np.uint8)
    folded = fold_model(load_state_dict(COCO))
    got = calibrate(folded, images, batch=2, method=method, device="cpu")
    want = jax_calibrate(jax_fold_model(load_variables(COCO)), images,
                         batch=2, method=method)
    assert set(got) == set(want) == set(folded)
    max_ops = ptq.FloatOps(folded, record=True, device="cpu")
    with torch.no_grad():
        ptq.forward_folded(torch.from_numpy(images), max_ops)
    for name, s in want.items():
        one_bin = float(max_ops.maxabs[name]) / 2048 / 127
        assert abs(got[name] - s) <= one_bin * 1.001, (name, got[name], s)
        assert got[name] > 0


# ----------------------------------------------------------- artifacts

def test_artifacts_cross_read(tmp_path, coco_int8):
    """coco-int8.npz round-trips bitwise through the port; each package
    reads what the other writes."""
    (qw, scales), (jqw, jscales) = coco_int8
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    save_quantized(ours, qw, scales)
    jax_save(theirs, jqw, jscales)
    with np.load(INT8) as a, np.load(ours) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for q2, s2 in (jax_load(ours), load_quantized(theirs)):
        assert s2 == scales and set(q2) == set(qw)
        for name, q in qw.items():
            for k in ("wq", "sw", "b"):
                got = np.asarray(q2[name][k])
                assert got.dtype == q[k].numpy().dtype, (name, k)
                np.testing.assert_array_equal(got, q[k].numpy())
