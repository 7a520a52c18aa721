"""Detection loss (counterpart of fastdet/train/loss.py).

Per scale, over the dense candidates of `build_dense_targets`:
  * reg: decode pxy = σ·2−0.5, pwh = (σ·2)²·anchor at every candidate,
    CIoU against the target, mean over the valid candidates;
  * obj: BCE-with-logits against a 0/1 grid (1 wherever a valid candidate
    lands; duplicates collapse), mean over the whole grid, scale balance
    (1.0, 0.4);
  * cls: softmax cross-entropy at the candidate cells, mean over the
    valid candidates, ÷ classes; skipped when there is one class;
  * total = 3.2·lbox + 64·lobj + 32·lcls.

The outputs are cast to f32 first, as the JAX function does.  The JAX
package gathers the candidate cells with a one-hot matmul and builds the
obj grid with a packed-key compare-reduce, because XLA serialises
scatters on a TPU; here both are plain indexing (`gather`, `index_put_`),
which gives the same values exactly.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from fastdet_torch.ops.iou import bbox_ciou
from fastdet_torch.train.targets import build_dense_targets

_BALANCE = (1.0, 0.4)
BOX_GAIN, OBJ_GAIN, CLS_GAIN = 3.2, 64.0, 32.0


def _global_sum(t: torch.Tensor, group) -> torch.Tensor:
    """A count summed over the group's ranks (itself without a group)."""
    if group is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=group)
    return t


def _grid_mean(x: torch.Tensor, group) -> torch.Tensor:
    """x.mean(), or with a group this rank's share of the global batch's
    mean (the ranks hold equal batches)."""
    if group is None:
        return x.mean()
    return x.sum() / (x.numel() * dist.get_world_size(group))


def _masked_mean(x: torch.Tensor, mask: torch.Tensor,
                 group=None) -> torch.Tensor:
    denom = _global_sum(mask.sum(), group)
    return torch.where(denom > 0, (x * mask).sum() / denom.clamp(min=1),
                       torch.zeros_like(denom))


def _bce_logits(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits (stable form)."""
    return x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))


def compute_loss(outputs: Sequence[torch.Tensor], labels: torch.Tensor,
                 label_mask: torch.Tensor, anchors: torch.Tensor,
                 input_hw: Tuple[int, int], group=None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """outputs: 6-tuple (reg2,obj2,cls2,reg3,obj3,cls3), NHWC raw logits.
    labels (B,M,5) [cls,cx,cy,w,h] normalized; label_mask (B,M) bool;
    anchors (S,A,2) f32 in input pixels.  → (total, components).

    `group`: a data-parallel process group whose ranks hold equal shares
    of the global batch.  The normalizers are then global (the positive
    counts all-reduced, the obj mean over the global B·H·W·A), so the
    loss is this rank's share of the global loss: the shares sum to it,
    and so do their gradients."""
    dev = outputs[0].device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    lbox, lobj, lcls = zero, zero, zero
    safe = torch.tensor([0.0, 0.0, 1.0, 1.0], device=dev)

    for s in range(len(outputs) // 3):
        reg, obj, cls = (o.float() for o in outputs[3 * s:3 * s + 3])
        b, h, w, _ = reg.shape
        a = obj.shape[-1]
        nc = cls.shape[-1]
        hw = h * w
        t = build_dense_targets(labels, label_mask,
                                anchors[s] / (input_hw[1] / w), (h, w))
        _, mm, _, oo = t.mask.shape
        maskf = t.mask.float()

        # candidate cells are anchor-invariant (gi/gj broadcast over A)
        cell = (t.gj[:, :, 0] * w + t.gi[:, :, 0]).reshape(b, mm * oo)

        def gather_cells(feat):
            flat = feat.reshape(b, hw, -1)
            return flat.gather(1, cell[:, :, None].expand(-1, -1,
                                                          flat.shape[2]))

        # ---- reg (CIoU)
        ps = (gather_cells(reg).reshape(b, mm, oo, a, 4)
              .permute(0, 1, 3, 2, 4))                       # (B,M,A,O,4)
        pxy = torch.sigmoid(ps[..., :2]) * 2.0 - 0.5
        pwh = ((torch.sigmoid(ps[..., 2:4]) * 2.0) ** 2
               * t.anchors[None, None, :, None, :])
        pbox = torch.cat([pxy, pwh], -1)
        # masked-out candidates have zero-size targets (CIoU 0/0): unit
        # boxes stand in for them
        tbox = torch.where(t.mask[..., None], t.tbox, safe)
        lbox = lbox + _masked_mean(1.0 - bbox_ciou(pbox, tbox), maskf,
                                   group)

        # ---- obj: BCE over the full grid against the 0/1 target grid
        a_iota = torch.arange(a, device=dev)[None, None, :, None]
        key = (t.gj * w + t.gi) * a + a_iota                 # (B,M,A,O)
        bidx = torch.arange(b, device=dev)[:, None, None, None].expand_as(key)
        tobj = torch.zeros((b, hw * a), device=dev)
        tobj.index_put_((bidx[t.mask], key[t.mask]),
                        torch.ones((), device=dev))
        lobj = lobj + (_grid_mean(_bce_logits(obj, tobj.reshape(b, h, w, a)),
                                  group) * _BALANCE[s])

        # ---- cls: softmax CE at the candidate cells; the CE value is
        # anchor-independent, the anchor axis only weights the mean
        if nc > 1:
            logp = F.log_softmax(gather_cells(cls).reshape(b, mm, oo, nc),
                                 -1)
            tcls = t.tcls[:, :, None, None].expand(b, mm, oo, 1)
            ce = -(logp.gather(-1, tcls.clamp(0, nc - 1))[..., 0]
                   * ((tcls[..., 0] >= 0) & (tcls[..., 0] < nc)))
            w_mo = maskf.sum(2)                              # (B,M,O)
            denom = _global_sum(maskf.sum(), group)
            lcls = lcls + torch.where(
                denom > 0, (ce * w_mo).sum() / denom.clamp(min=1),
                zero) / nc

    lbox = lbox * BOX_GAIN
    lobj = lobj * OBJ_GAIN
    lcls = lcls * CLS_GAIN
    total = lbox + lobj + lcls
    return total, {"box": lbox, "obj": lobj, "cls": lcls, "total": total}
