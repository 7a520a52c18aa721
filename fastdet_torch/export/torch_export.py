"""Export of the deploy-mode forward (counterpart of
fastdet/export/stablehlo.py).

Fills the role of the reference's pytorch2onnx.py deployment step, as the
JAX package's StableHLO export does: the artifact takes a (batch, H, W, 3)
uint8 NHWC image batch, divides it by 255 and returns the deploy maps
with sigmoid on reg and obj and the channel softmax on cls baked in (two
per-scale NHWC maps, or one stride-16 map for the anchor-free family's
int8 artifact).  The weights are embedded.

The artifact is PyTorch's, not StableHLO: `torch.export.export` of that
function at a fixed (batch, H, W, 3) uint8 input, written by
`torch.export.save` as a `.pt2` archive, read back by `load_exported`
(`torch.export.load`).  `export_graph_text` is the counterpart of
`export_stablehlo_text`: the printed graph of a saved program (read back,
not traced again).

A `.pt2` program holds its weights and constants on the device it was
exported on, so export on the device the artifact will run on (`device`,
CUDA unless "cpu" is asked for).  Its convolutions and matmuls read the
TF32 switches when they run, not when they were exported, so
`load_exported` turns TF32 off on CUDA as every entry point of the port
does (`disable_tf32`): without that an f32 artifact would compute in
TF32.
"""

from __future__ import annotations

import copy
import os
from typing import Callable, Tuple

import torch
from torch import nn

from fastdet_torch import disable_tf32, resolve_device
from fastdet_torch.models.layers import deploy_maps


class _DeployForward(nn.Module):
    """uint8 NHWC → `model(x / 255, deploy=True)`."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images):
        return self.model(images.to(torch.float32) / 255.0, deploy=True)


class _QuantDeployForward(nn.Module):
    """uint8 NHWC → the int8 forward's raw maps, baked as the f32 deploy
    forward bakes them."""

    def __init__(self, fwd: Callable, anchorfree: bool):
        super().__init__()
        self.fwd = fwd
        self.anchorfree = anchorfree

    def forward(self, images):
        if self.anchorfree:
            obj, cls, reg = self.fwd(images)
            return deploy_maps(reg, obj, cls)
        reg2, obj2, cls2, reg3, obj3, cls3 = self.fwd(images)
        return deploy_maps(reg2, obj2, cls2), deploy_maps(reg3, obj3, cls3)


def _program(module: nn.Module, input_hw: Tuple[int, int], batch: int,
             dev: torch.device):
    h, w = input_hw
    spec = torch.zeros((batch, h, w, 3), dtype=torch.uint8, device=dev)
    with torch.no_grad():
        return torch.export.export(module.eval(), (spec,))


def _save(program, out_path: str) -> bytes:
    """Write `program` without its example input (a zero batch, which
    `torch.export.save` would store beside the weights: 47.6 MB at b128
    352²)."""
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    program.example_inputs = None
    torch.export.save(program, out_path)
    with open(out_path, "rb") as f:
        return f.read()


def _deploy_module(model: nn.Module, state_dict, dev: torch.device):
    model = copy.deepcopy(model)
    model.load_state_dict(state_dict)
    return _DeployForward(model.to(dev).eval())


def export_detector(model: nn.Module, state_dict, out_path: str,
                    input_hw: Tuple[int, int] = (352, 352), batch: int = 1,
                    device=None) -> bytes:
    """Serialize `images_u8 → (scale16_map, scale32_map)`: the deploy
    forward of `model` (a `Detector`, left as it is) with `state_dict`
    loaded, at a (batch, H, W, 3) uint8 input, on `device`.  Writes
    `out_path` (a `.pt2` archive) and returns its bytes."""
    dev = resolve_device(device)
    disable_tf32(dev)
    return _save(_program(_deploy_module(model, state_dict, dev), input_hw,
                          batch, dev), out_path)


def export_quantized(qw, scales, out_path: str,
                     input_hw: Tuple[int, int] = (352, 352), batch: int = 1,
                     device=None, mac: str = "bf16") -> bytes:
    """Serialize the int8 deploy forward (`fastdet_torch.quant.
    forward_from(qw, scales, mac=)`) with the bake: two per-scale maps for
    the anchor-based family, one stride-16 map [σ(reg), σ(obj),
    softmax(cls)] for the anchor-free family (`infer_family`).  The int8
    weights, their contraction forms and the rescale factors are embedded
    as constants.  Writes `out_path` and returns its bytes."""
    from fastdet_torch.quant import forward_from, infer_family
    dev = resolve_device(device)
    fwd = forward_from(qw, scales, mac=mac, device=dev)
    module = _QuantDeployForward(fwd, infer_family(qw) == "anchorfree")
    return _save(_program(module, input_hw, batch, dev), out_path)


def export_graph_text(path: str) -> str:
    """The program saved at `path` (a `.pt2` archive) as text: its graph,
    with the input and output signature, for reading and for diffing two
    exports."""
    return str(torch.export.load(path))


def _program_device(program) -> torch.device:
    for t in list(program.state_dict.values()) + list(
            program.constants.values()):
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


def load_exported(path: str, device=None) -> Callable:
    """Read a `.pt2` archive → `call(images_u8)`: a (batch, H, W, 3) uint8
    array or tensor (moved to the program's device) → the maps as
    tensors there.  `device` (CUDA unless "cpu" is asked for) must be the
    one the program was exported on.  On CUDA this turns TF32 off for the
    whole process."""
    dev = resolve_device(device)
    disable_tf32(dev)
    program = torch.export.load(path)
    at = _program_device(program)
    if at.type != dev.type:
        raise ValueError(f"fastdet_torch: {path} was exported on {at}; load "
                         f"it on that device, not {dev}")
    module = program.module()

    def call(images_u8):
        with torch.inference_mode():
            return module(torch.as_tensor(images_u8).to(at))

    return call
