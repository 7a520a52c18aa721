"""Dense, static-shape anchor matching (counterpart of
fastdet/train/targets.py).

Every ground-truth box of a padded (B, M) label tensor yields A·5
candidate assignments with a validity mask: the per-anchor wh-ratio
match (< 2), then the neighbour-cell expansion with g = 0.5 over the
5-offset table [center, left, top, right, bottom].  Candidate tensors are
(B, M, A, O), O = 5; the loss reduces them with masks, so duplicate
matches and ties count as in the reference.

`pack_labels` lives here, not in the cv2-bound data package, so that the
training path on a machine without cv2 can import it; the data loader
(fastdet_torch/data/loader.py) imports it from here.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

# neighbour-cell offsets, g = 0.5 (the reference's
# off = [[0,0],[1,0],[0,1],[-1,0],[0,-1]] * 0.5)
_OFFSETS = np.array([[0.0, 0.0], [0.5, 0.0], [0.0, 0.5],
                     [-0.5, 0.0], [0.0, -0.5]], np.float32)


class DenseTargets(NamedTuple):
    """Per-scale static-shape assignment candidates."""
    gi: torch.Tensor       # (B,M,A,O) int64 grid x index, clipped in-bounds
    gj: torch.Tensor       # (B,M,A,O) int64 grid y index, clipped in-bounds
    tbox: torch.Tensor     # (B,M,A,O,4) regression target (dx, dy, gw, gh)
    anchors: torch.Tensor  # (A,2) anchor sizes in grid units
    tcls: torch.Tensor     # (B,M) int64 class id
    mask: torch.Tensor     # (B,M,A,O) bool candidate validity


def pack_labels(label_list: Sequence[np.ndarray], max_labels: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Pack per-image label arrays (n_i, 5) [cls,cx,cy,w,h] into a
    fixed-shape (B, max_labels, 5) tensor + (B, max_labels) mask."""
    b = len(label_list)
    out = np.zeros((b, max_labels, 5), np.float32)
    mask = np.zeros((b, max_labels), bool)
    for i, lab in enumerate(label_list):
        lab = np.asarray(lab, np.float32).reshape(-1, 5)
        n = min(len(lab), max_labels)
        out[i, :n] = lab[:n]
        mask[i, :n] = True
    return out, mask


def build_dense_targets(labels: torch.Tensor, label_mask: torch.Tensor,
                        anchors_grid: torch.Tensor,
                        grid_hw: Tuple[int, int]) -> DenseTargets:
    """Candidates for ONE scale.

    labels (B,M,5) f32 [cls, cx, cy, w, h] normalized to [0,1];
    label_mask (B,M) bool; anchors_grid (A,2) in grid units (pixels /
    stride); grid_hw (h, w) of the feature map."""
    h, w = grid_hw
    a = anchors_grid.shape[0]
    b, m, _ = labels.shape
    dev = labels.device
    wh = torch.tensor([w, h], dtype=torch.float32, device=dev)

    cls_ = labels[..., 0].to(torch.int64)                    # (B,M)
    gxy = labels[..., 1:3] * wh                              # grid units
    gwh = labels[..., 3:5] * wh

    # wh-ratio anchor match: max(r, 1/r).max < 2
    r = gwh[:, :, None, :] / anchors_grid[None, None]        # (B,M,A,2)
    anchor_ok = torch.maximum(r, 1.0 / r).amax(-1) < 2.0     # (B,M,A)

    # neighbour-cell masks (gx%1<g & gx>1 etc.)
    gx, gy = gxy[..., 0], gxy[..., 1]
    inv_x, inv_y = w - gx, h - gy
    j = (gx % 1.0 < 0.5) & (gx > 1.0)          # left neighbour
    k = (gy % 1.0 < 0.5) & (gy > 1.0)          # top neighbour
    l = (inv_x % 1.0 < 0.5) & (inv_x > 1.0)    # right neighbour
    m_ = (inv_y % 1.0 < 0.5) & (inv_y > 1.0)   # bottom neighbour
    off_ok = torch.stack([torch.ones_like(j), j, k, l, m_], -1)  # (B,M,O)

    mask = (label_mask.bool()[:, :, None, None]
            & anchor_ok[:, :, :, None]
            & off_ok[:, :, None, :])                         # (B,M,A,O)

    offs = torch.from_numpy(_OFFSETS).to(dev)                # (O,2)
    # candidate cell = floor(gxy - offset), clipped in-bounds (the
    # reference clamps in place, so its tbox sees the clipped cells too)
    gij = torch.floor(gxy[:, :, None, :] - offs).to(torch.int64)
    gi = gij[..., 0].clamp(0, w - 1)                         # (B,M,O)
    gj = gij[..., 1].clamp(0, h - 1)

    dxy = gxy[:, :, None, :] - torch.stack([gi, gj], -1).to(gxy.dtype)
    tbox = torch.cat([dxy, gwh[:, :, None, :].expand_as(dxy)], -1)

    # offset-axis quantities broadcast over the anchor axis
    gi = gi[:, :, None, :].expand(b, m, a, 5)
    gj = gj[:, :, None, :].expand(b, m, a, 5)
    tbox = tbox[:, :, None].expand(b, m, a, 5, 4)
    return DenseTargets(gi=gi, gj=gj, tbox=tbox, anchors=anchors_grid,
                        tcls=cls_, mask=mask)
