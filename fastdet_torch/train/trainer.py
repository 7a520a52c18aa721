"""Training step and Trainer (counterpart of fastdet/train/trainer.py).

Optimizer parity with the reference (its train.py:81-90): SGD, momentum
0.949, weight decay 5e-4 on ALL parameters (BN scale/bias and the head
conv biases too), the decay added to the gradient before the momentum
buffer, no dampening, no Nesterov: `torch.optim.SGD(momentum=0.949,
weight_decay=5e-4)` computes exactly optax's add_decayed_weights → trace
→ ×(−lr).  The LR is `schedule(step)`, where `step` counts micro-batches,
set on the optimizer before each apply; step 0's LR is exactly 0 and the
momentum buffer still takes that step's gradient.  `subdivisions` SUMS
the gradients of that many micro-batches (`.grad` accumulates across
backward calls) and applies every `subdivisions` micro-steps.

The forward is the model in training mode on images/255 (the default
path), or with `fused_backbone=True` the fused-backbone forward
(`train/fused_forward.py`: kernel B8 for the stride-1 spans; with
`fused_input_format="s2d_u8"` also kernel B7 for the stem, on (B, 48,
pad128(H/4·W/4)) uint8 batches from `pack_images_s2d`, ghost BN over
each image, as in the JAX package).  The loss is `loss_fn(outputs,
labels, mask, anchors, input_hw)`: `compute_loss` by default, the
family's (`models/registry.py`) for another model, e.g. the anchor-free
family's, whose model has no fused training (`fused_backbone=True` raises
for it, as the JAX CLI refuses it).

The Trainer computes in its model's dtype: f32 (the port's kernels), or
f64 on the CPU for the parity tests.  `compute_dtype=torch.bfloat16` is
the JAX package's bf16 training: the model must be built to compute in
bf16 (`Detector(dtype=torch.bfloat16)`, `get_family(..., dtype=)`), and
such a model makes it the default; its parameters, their gradients and
the momentum buffers stay f32, the images are scaled as
`images.astype(bf16) / bf16(255)`, the fused modes run B7 and B8 in
bf16, and the loss casts the bf16 outputs to f32.
float16 raises.

Data parallel (`mesh=`, a job's `fastdet_torch.parallel.make_mesh()`):
one process per device, each stepping on its rank's rows of the global
batch.  The Trainer broadcasts rank 0's parameters and buffers, gives
every BatchNorm the job's group (global two-pass statistics) and passes
the group to the loss (global normalizers), so each rank's loss is its
share of the global loss.  `subdivisions` still sums `.grad` locally; at
each apply the gradients are all-reduced with SUM (one flat buffer), then
every rank takes the same SGD step.  The logged components are summed
over the ranks: the global loss.  A local mesh of several devices in one
process raises `NotImplementedError`: training is one process per
device (the JAX CLI spreads one process over its local devices).

Tensor parallel (`mesh=`, a job's `fastdet_torch.parallel.make_mesh_2d(
n_data, n_model)`): the Trainer broadcasts rank 0's full state over the
world, then shards it over the model axis (`parallel.tp.tensor_parallel`:
each sharded conv, BN and head conv keeps its block of the output
channels) and builds SGD on the local shards, so the momentum buffers
shard alike.  Each rank steps on its data shard's rows (its data index d
of the mesh's coordinates; the model ranks of one d take the same rows).
BatchNorm statistics, the loss's normalizers, the gradient all-reduce
and the logged components all run over the data group: over the world
they would count the model ranks' equal losses n_model times.  The
replicated parameters' gradients are then broadcast from model rank 0,
so that their replicas cannot drift.  `state_dict()` holds the rank's
shards; `full_state_dict()` gathers the model's full tensors on every
rank.  In the fused modes B7 and B8 take their weights whole
(`train/fused_forward.py`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from fastdet_torch import disable_tf32, resolve_device
from fastdet_torch.config import Config
from fastdet_torch.models.detector import Detector
from fastdet_torch.models.layers import BF16
from fastdet_torch.parallel import multihost, sync_batchnorm, tp
from fastdet_torch.train.loss import compute_loss
from fastdet_torch.train.schedule import make_lr_schedule

MOMENTUM = 0.949
WEIGHT_DECAY = 5e-4


def make_optimizer(params) -> torch.optim.SGD:
    """SGD without an LR of its own: the Trainer sets the schedule's LR
    before each apply."""
    return torch.optim.SGD(params, lr=0.0, momentum=MOMENTUM,
                           weight_decay=WEIGHT_DECAY)


class Trainer:
    """The train state (model parameters and BN buffers, optimizer state,
    micro-step count, gradient accumulation) and its step."""

    def __init__(self, model, cfg: Config, steps_per_epoch: int, *,
                 subdivisions: Optional[int] = None,
                 fused_backbone: bool = False, device=None,
                 compute_dtype: Optional[torch.dtype] = None,
                 fused_input_format: str = "nhwc",
                 loss_fn: Callable = compute_loss, mesh=None):
        if compute_dtype == torch.float16:
            raise NotImplementedError(
                "fastdet_torch: float16 training is not ported (the JAX "
                "package trains in float32 or bfloat16)")
        if fused_backbone and not isinstance(model, Detector):
            raise ValueError("fused_backbone supports the yolo-fastestv2 "
                             "family only")
        model_bf16 = getattr(model, "dtype", None) == BF16
        if compute_dtype is None and model_bf16:
            compute_dtype = BF16
        if (compute_dtype == BF16) != model_bf16:
            raise ValueError(
                "compute_dtype=torch.bfloat16 takes a model built to compute "
                "in bf16 (dtype=torch.bfloat16), and only it")
        if mesh is not None and mesh.group is None and mesh.size > 1:
            raise NotImplementedError(
                "fastdet_torch: training over several devices of one "
                "process is not ported: start one process per device "
                "(initialize_distributed) and pass its make_mesh()")
        # the batch's group: BN, the loss and the gradients reduce over it
        self.group = None if mesh is None else getattr(
            mesh, "data_group", mesh.group)
        self.mesh = mesh
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device)
        disable_tf32(self.device)
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.compute_dtype = compute_dtype
        # bf16 is a compute dtype: the parameters stay f32
        self.model = (model.to(self.device) if compute_dtype == BF16
                      else model.to(self.device, compute_dtype)).train()
        self.input_hw = (cfg.height, cfg.width)
        self.schedule = make_lr_schedule(
            cfg.learning_rate, steps_per_epoch, cfg.steps or (), gamma=0.1,
            warmup_epochs=5)
        self.tp_specs = None              # the full state's shardings
        if self.group is not None:
            multihost.broadcast_module(self.model, mesh.group)
            if tp.MODEL_AXIS in mesh.axis_names:
                self.tp_specs = tp.tensor_parallel(self.model, mesh)
                self._replicated = tp.replicated_params(self.model,
                                                        self.tp_specs)
            sync_batchnorm(self.model, self.group)
        self.optimizer = make_optimizer(self.model.parameters())
        self.anchors = torch.from_numpy(
            np.asarray(cfg.anchors, np.float32).reshape(
                cfg.num_scales, cfg.anchor_num, 2)).to(self.device)
        self.subdivisions = subdivisions or cfg.subdivisions or 1
        self.step_count = 0
        self.accum_count = 0
        self._fused = None
        if fused_backbone:
            from fastdet_torch.train.fused_forward import \
                build_fused_train_apply
            self._fused = build_fused_train_apply(
                self.input_hw, input_format=fused_input_format,
                device=self.device, group=self.group)

    def _forward(self, images_u8: torch.Tensor):
        """The training forward's 6 NHWC outputs: images (B, H, W, 3)
        uint8, or (B, 48, pad128(H/4·W/4)) uint8 s2d batches in the fused
        s2d mode."""
        images = torch.as_tensor(images_u8).to(self.device)
        if self._fused is not None:
            return self._fused(self.model, images)
        if self.compute_dtype == BF16:
            return self.model(images.to(BF16) / 255.0)
        dtype = next(self.model.parameters()).dtype
        return self.model(images.to(dtype) / 255.0)

    def step(self, images_u8, labels, label_mask) -> Dict[str, object]:
        """One micro-step on a uint8 batch (B, H, W, 3), or (B, 48, npad)
        in the fused s2d mode, with (B, M, 5) labels and their (B, M) mask
        → the loss components (0-d tensors on the device) and the step's
        `lr` (a float)."""
        self.model.train()
        outputs = self._forward(images_u8)
        extra = {} if self.group is None else {"group": self.group}
        total, comps = self.loss_fn(
            outputs, torch.as_tensor(labels).to(self.device),
            torch.as_tensor(label_mask).to(self.device), self.anchors,
            self.input_hw, **extra)
        total.backward()
        lr = self.schedule(self.step_count)
        self.accum_count += 1
        if self.accum_count >= self.subdivisions:
            if self.group is not None:
                multihost.all_reduce_grads(self.model.parameters(),
                                           self.group)
            if self.tp_specs is not None:     # model rank 0's, to its group
                mesh = self.mesh
                multihost.broadcast_grads(self._replicated,
                                          mesh.coords[0] * mesh.n_model,
                                          mesh.model_group)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            self.accum_count = 0
        self.step_count += 1
        metrics = {k: v.detach() for k, v in comps.items()}
        if self.group is not None:        # the global loss's components
            keys = sorted(metrics)
            summed = torch.stack([metrics[k].float() for k in keys])
            torch.distributed.all_reduce(summed, group=self.group)
            metrics = dict(zip(keys, summed.unbind()))
        metrics["lr"] = lr
        return metrics

    def full_state_dict(self) -> dict:
        """The model's state dict with full tensors, on every rank (tensor
        parallel gathers the shards; otherwise `model.state_dict()`)."""
        sd = self.model.state_dict()
        if self.tp_specs is None:
            return sd
        return tp.gather_state(sd, self.mesh, self.tp_specs)

    def current_lr(self, step: int) -> float:
        return self.schedule(step)

    def state_dict(self) -> dict:
        """Everything a resumed run needs, bit for bit: parameters and BN
        buffers, the momentum buffers, the micro-step count and the
        gradients summed so far in the current accumulation."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step_count, "accum_count": self.accum_count,
                "grad_accum": [None if p.grad is None else p.grad.clone()
                               for p in self.model.parameters()]}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step_count = int(state["step"])
        self.accum_count = int(state["accum_count"])
        for p, g in zip(self.model.parameters(), state["grad_accum"]):
            p.grad = None if g is None else g.to(p.device, p.dtype).clone()
