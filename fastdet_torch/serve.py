"""Serving pipelines (counterpart of fastdet/serve.py).

`DevicePipeline` runs the whole detect chain on the device: uint8 NHWC →
/255 → Detector (f32, or bf16 for a `Detector(dtype=torch.bfloat16)`,
whose outputs reach the postprocess as f32) → postprocess with the fused
rank→decode→NMS kernel.  Defaults are the JAX package's serving
operating point: conf_thres 0.3, iou_thres 0.45, max_det 300 and a
pre-NMS window of `max_nms=128`, sized for conf ≥ 0.3
(fastdet/serve.py:20-26).

`FusedPipeline` runs the same chain on the fused forward
(fastdet_torch/kernels/fused_infer.py): the host packs uint8 NHWC into the
s2d(4) layout, and the card runs the stem and span kernels, the PyTorch
stride-2 blocks and FPN, then the same postprocess.  Its default dtype is
the JAX package's, bf16 (`dtype=None`); `dtype=torch.float32` serves f32.
With `family="anchorfree"` it runs the anchor-free family
(`models/anchorfree.py`) on the same backbone kernels, then its decode and
`batched_nms`.

`HybridPipeline` runs the deploy forward (`Detector(deploy=True)`, the
graph `fastdet_torch.export` serializes) on the device, copies its two
maps to the host as f32 and decodes and suppresses them there in C++
(`fastdet_torch.native.postprocess`, OpenMP over images): the split of
the reference's ncnn deployment, for a host-side postprocess.

`ShardedPipeline` is `DevicePipeline` over a local mesh
(`fastdet_torch.parallel.make_mesh`), the serving counterpart of the
data-parallel train step, and `FusedPipeline(mesh=)` the same for the
fused path: the model (or the packed weights) and the anchors are
replicated to each mesh device, the batch is padded with zero images to a
multiple of the mesh size, each device runs its contiguous shard, and the
result is trimmed to the batch.  One process drives every device of the
mesh; a device may appear more than once.

`StreamingPipeline` wraps any of them: a producer thread stacks batch N+1
while the device runs batch N, and the ragged tail is padded to the
static batch.
"""

from __future__ import annotations

import copy
import functools
import queue
import threading
from typing import List, Sequence

import numpy as np
import torch

from fastdet_torch import disable_tf32, native, resolve_device
from fastdet_torch.config import Config
from fastdet_torch.kernels.fused_infer import (build_fused_forward,
                                               pack_images_s2d)
from fastdet_torch.models.anchorfree import build_anchorfree_fused_detect
from fastdet_torch.models.registry import family_name
from fastdet_torch.ops.postprocess import build_detect_fn, postprocess
from fastdet_torch.parallel.mesh import batch_slices, make_mesh, replicate


NO_DECODER = ("fastdet_torch: {} needs a host image decoder (the JAX "
              "package decodes with native.py's libjpeg/libpng or cv2, "
              "neither of which may sit on the card's path)")


class DevicePipeline:
    """`pipe(images_u8)` with an (N,H,W,3) uint8 numpy batch → a list of
    (n_i, 6) float32 arrays [x1,y1,x2,y2,conf,cls] in model input
    coordinates.

    model: a `fastdet_torch.models.Detector`; variables: its state dict
    (e.g. from `fastdet_torch.io.load_state_dict`), loaded into it."""

    def __init__(self, model, variables, cfg: Config, conf_thres=0.3,
                 iou_thres=0.45, max_det=300, max_nms=128, device=None):
        self.device = resolve_device(device)
        model.load_state_dict(variables)
        self._detect = build_detect_fn(model, cfg, conf_thres=conf_thres,
                                       iou_thres=iou_thres, max_det=max_det,
                                       max_nms=max_nms, device=self.device)

    def detect(self, images: torch.Tensor):
        """(B,H,W,3) uint8 tensor on the device → (dets (B,max_det,6),
        counts (B,)) on the device, without a host round trip."""
        return self._detect(images)

    def __call__(self, images_u8: np.ndarray) -> List[np.ndarray]:
        images = torch.from_numpy(np.ascontiguousarray(images_u8))
        dets, counts = self._detect(images.to(self.device))
        dets, counts = dets.cpu().numpy(), counts.cpu().numpy()
        return [dets[i, :counts[i]] for i in range(len(counts))]


def sharded_detect(mesh, detects):
    """One detect per mesh entry (`detect(images) → (dets, counts)` on
    that entry's device) → a detect over the mesh: the batch padded with
    zero images to a multiple of the mesh size, each device's contiguous
    shard through its detect, the results on the mesh's first device and
    trimmed to the batch."""
    if mesh.group is not None:
        raise ValueError("fastdet_torch: serving splits a batch over a "
                         "local mesh in one process, not over a job's ranks")

    def detect(images: torch.Tensor):
        n = len(images)
        pad = (-n) % mesh.size
        if pad:
            images = torch.cat([images, images.new_zeros(
                (pad,) + tuple(images.shape[1:]))])
        outs = [fn(images[a:b].to(d)) for fn, (d, a, b)
                in zip(detects, batch_slices(mesh, n + pad))]
        return tuple(torch.cat([o[i].to(mesh.device) for o in outs])[:n]
                     for i in range(2))

    return detect


class ShardedPipeline(DevicePipeline):
    """`DevicePipeline` over a local mesh (`parallel.make_mesh()`: the
    local cards by default; `make_mesh(devices=[...])` for others, repeats
    allowed): the model with `variables` replicated to each device, the
    batch padded to a multiple of the mesh size and trimmed, as
    `StreamingPipeline` pads its tail.  `__call__` and `detect` take the
    batch as `DevicePipeline`'s do, on the mesh's first device."""

    def __init__(self, model, variables, cfg: Config, mesh=None,
                 conf_thres=0.3, iou_thres=0.45, max_det=300, max_nms=128):
        mesh = mesh if mesh is not None else make_mesh()
        self.mesh = mesh
        self.device = resolve_device(mesh.device)
        model.load_state_dict(variables)

        def build(dev):
            return build_detect_fn(copy.deepcopy(model), cfg,
                                   conf_thres=conf_thres,
                                   iou_thres=iou_thres, max_det=max_det,
                                   max_nms=max_nms, device=dev)

        self._detect = sharded_detect(mesh, replicate(mesh, build))


class FusedPipeline:
    """`pipe(images_u8)` with an (N,H,W,3) uint8 numpy batch (packed on the
    host by `pack_images_s2d`) or a pre-packed (N, 48, pad128(H/4·W/4))
    uint8 batch → a list of (n_i, 6) float32 arrays [x1,y1,x2,y2,conf,cls]
    in model input coordinates.

    state_dict: the port's (e.g. from `fastdet_torch.io.load_state_dict`),
    the same weights `DevicePipeline` takes, or an `AnchorFreeDetector`'s
    with `family="anchorfree"` ("fastestdet" too).

    dtype: None (the JAX package's default) or torch.bfloat16 runs the
    bf16 forward, the JAX package's bf16 function (bf16 kernels B1, B2);
    torch.float32 the f32 forward.  Any other dtype raises
    `NotImplementedError`.  The logits reach the postprocess as f32 in
    both.

    mesh: a local `parallel.make_mesh(...)` for data-parallel serving:
    the packed weights and anchors replicated to each device, ragged
    batches padded to the mesh size and trimmed (`ShardedPipeline`'s
    contract); `device` is then the mesh's first.

    Not ported, raising `NotImplementedError`: `from_files` and
    `preprocess_files`, which need a host image decoder that the card's
    machine lacks."""

    def __init__(self, state_dict, cfg: Config, conf_thres=0.3,
                 iou_thres=0.45, max_det=300, max_nms=128,
                 dtype=None, device=None, mesh=None,
                 family: str = "yolo-fastestv2"):
        if dtype is None:
            dtype = torch.bfloat16
        if dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(
                f"fastdet_torch: FusedPipeline(dtype={dtype}) is not ported; "
                "it serves torch.bfloat16 (the default) or torch.float32")
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None
                                     else mesh.device)
        self.dtype = dtype
        hw = (cfg.height, cfg.width)
        nms = dict(conf_thres=conf_thres, iou_thres=iou_thres,
                   max_det=max_det, max_nms=max_nms)
        anchorfree = family_name(family) == "anchorfree"
        anchors = None if anchorfree else np.asarray(
            cfg.anchors, np.float32).reshape(cfg.num_scales,
                                             cfg.anchor_num, 2)

        def build(dev):
            """The detect of one device, its weights packed there."""
            dev = resolve_device(dev)
            disable_tf32(dev)
            if anchorfree:
                fused, packed = build_anchorfree_fused_detect(
                    state_dict, hw, dtype=dtype, device=dev, **nms)
                return functools.partial(fused, packed)
            fwd, packed = build_fused_forward(state_dict, input_hw=hw,
                                              dtype=dtype, device=dev)

            @torch.inference_mode()
            def detect(images):
                return postprocess(fwd(images, packed), anchors, hw, **nms)

            return detect

        self._detect = (build(self.device) if mesh is None else
                        sharded_detect(mesh, replicate(mesh, build)))

    def detect(self, images: torch.Tensor):
        """(B, 48, npad) uint8 s2d tensor on the device → (dets
        (B,max_det,6), counts (B,)) on the device, without a host round
        trip."""
        return self._detect(images)

    def __call__(self, images_u8: np.ndarray) -> List[np.ndarray]:
        x = np.asarray(images_u8)
        if x.ndim == 4:                      # NHWC → pack on the host
            x = pack_images_s2d(x)
        images = torch.from_numpy(np.ascontiguousarray(x))
        dets, counts = self._detect(images.to(self.device))
        dets, counts = dets.cpu().numpy(), counts.cpu().numpy()
        return [dets[i, :counts[i]] for i in range(len(counts))]

    def preprocess_files(self, paths: Sequence[str]) -> np.ndarray:
        raise NotImplementedError(NO_DECODER.format(
            "FusedPipeline.preprocess_files"))

    def from_files(self, paths: Sequence[str]) -> List[np.ndarray]:
        return self(self.preprocess_files(paths))


class HybridPipeline:
    """`pipe(images_u8)` with an (N,H,W,3) uint8 numpy batch → a list of
    (n_i, 6) float32 arrays [x1,y1,x2,y2,score,cls] in model input
    coordinates: the deploy forward on the device (/255 in the model's
    dtype, as JAX's `deploy_fwd`), its two maps copied to the host as f32,
    then decode and class-aware NMS in C++ (`native.postprocess`).

    model: a `fastdet_torch.models.Detector` (f32 or bf16); variables: its
    state dict, loaded into it."""

    def __init__(self, model, variables, cfg: Config, conf_thres=0.3,
                 iou_thres=0.45, max_det=300, device=None):
        self.device = resolve_device(device)
        disable_tf32(self.device)
        model.load_state_dict(variables)
        self._model = model.to(self.device).eval()
        self._hw = (cfg.height, cfg.width)
        self._anchors = np.asarray(cfg.anchors, np.float32)
        self._nms = dict(conf_thres=conf_thres, iou_thres=iou_thres,
                         max_det=max_det)

    @torch.inference_mode()
    def deploy(self, images: torch.Tensor):
        """(B,H,W,3) uint8 tensor on the device → the two deploy maps
        there, in the model's dtype."""
        return self._model(images.to(self._model.dtype) / 255.0,
                           deploy=True)

    def host_postprocess(self, s16: np.ndarray, s32: np.ndarray):
        """The two f32 host maps → the per-image detections."""
        return native.postprocess(s16, s32, self._anchors, self._hw,
                                  **self._nms)

    def __call__(self, images_u8: np.ndarray) -> List[np.ndarray]:
        images = torch.from_numpy(np.ascontiguousarray(images_u8))
        s16, s32 = (m.float().cpu().numpy()
                    for m in self.deploy(images.to(self.device)))
        return self.host_postprocess(s16, s32)


class _Stopped(Exception):
    """The stream's consumer has stopped."""


class StreamingPipeline:
    """Double-buffered stream detection over any batch pipeline
    (`DevicePipeline`, `ShardedPipeline`, `FusedPipeline`,
    `HybridPipeline`): a producer
    thread stacks batch N+1 (a queue of two) while the caller's thread
    runs batch N.

      * `run(frames)`: an iterable of model-sized HWC uint8 frames → the
        per-frame detections in order.  Every batch has `batch_size`
        frames: the ragged tail is padded with zero frames and its
        outputs trimmed by the valid count;
      * `run_files(paths)`: JAX's streams files through the pipeline's
        `preprocess_files`; the port has no host image decoder, so this
        raises `NotImplementedError`.

    An exception in the producer is raised in the caller's thread."""

    def __init__(self, pipeline, batch_size: int = 8):
        self._pipe = pipeline
        self._bs = batch_size

    def _stream(self, producer) -> List[np.ndarray]:
        q: "queue.Queue" = queue.Queue(maxsize=2)
        done = object()
        stop = threading.Event()
        failed: List[BaseException] = []

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    pass
            raise _Stopped

        def run_producer():
            try:
                producer(put)
                put(done)
            except _Stopped:                      # the caller has failed
                pass
            except BaseException as e:            # raised in the caller
                failed.append(e)
                try:
                    put(done)
                except _Stopped:
                    pass

        t = threading.Thread(target=run_producer, daemon=True)
        t.start()
        out: List[np.ndarray] = []
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                batch, valid = item
                out.extend(self._pipe(batch)[:valid])
        finally:
            stop.set()
            t.join()
        if failed:
            raise failed[0]
        return out

    def run(self, frames) -> List[np.ndarray]:
        """frames: iterable of HWC uint8 images (already model-sized) →
        per-frame detection arrays, in order."""

        def producer(put):
            buf = []
            for f in frames:
                buf.append(f)
                if len(buf) == self._bs:
                    put((np.stack(buf), self._bs))
                    buf = []
            if buf:
                n = len(buf)
                pad = [np.zeros_like(buf[0])] * (self._bs - n)
                put((np.stack(buf + pad), n))

        return self._stream(producer)

    def run_files(self, paths: Sequence[str]) -> List[np.ndarray]:
        """Image files → per-file detection arrays: raises
        `NotImplementedError`, as the port has no host image decoder."""
        raise NotImplementedError(NO_DECODER.format(
            "StreamingPipeline.run_files"))
