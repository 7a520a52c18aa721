"""Anchor generation: k-means under 1−IoU distance on label (w,h) pairs
(the port's copy of fastdet/anchors.py, which it must not import).

The reference tool's (genanchors.py) capabilities: its corner-anchored
IoU metric, Lloyd iterations until the assignments stop changing, its
`anchors{k}.txt` output (width-sorted `w,h` pairs scaled to the input
size, then the average IoU on its own line), its `JPEGImages→labels` /
`.jpg→.txt` path munge, and a k = 1..10 sweep when num_clusters = 0.
The same `random.Random(seed)` draws and the same arithmetic as the JAX
package's copy, so both write the same files byte for byte.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np


def pair_iou(wh: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """(N,2)×(K,2) → (N,K) IoU of corner-anchored boxes: the closed
    form of the reference's four-case IOU, inter = min(w,cw)·min(h,ch)
    over the union."""
    inter = (np.minimum(wh[:, None, 0], centroids[None, :, 0])
             * np.minimum(wh[:, None, 1], centroids[None, :, 1]))
    union = (wh[:, 0] * wh[:, 1])[:, None] \
        + (centroids[:, 0] * centroids[:, 1])[None, :] - inter
    return inter / union


def avg_iou(wh: np.ndarray, centroids: np.ndarray) -> float:
    return float(pair_iou(wh, centroids).max(axis=1).mean())


def kmeans_anchors(wh: np.ndarray, k: int, seed: Optional[int] = None,
                   init: Optional[np.ndarray] = None,
                   max_iters: int = 10_000,
                   verbose: bool = False) -> Tuple[np.ndarray, float]:
    """Lloyd iterations under d = 1−IoU until assignments stabilise.

    Returns (centroids (k,2), average IoU)."""
    rng = random.Random(seed)
    if init is None:
        idx = [rng.randrange(wh.shape[0]) for _ in range(k)]
        centroids = wh[idx].astype(np.float64).copy()
    else:
        centroids = np.asarray(init, np.float64).copy()

    prev = np.full(wh.shape[0], -1)
    for it in range(max_iters):
        d = 1.0 - pair_iou(wh, centroids)
        assign = np.argmin(d, axis=1)
        if verbose:
            print(f"iter {it + 1}: changed = {(assign != prev).sum()}")
        if (assign == prev).all():
            break
        for j in range(k):
            sel = assign == j
            if sel.any():
                centroids[j] = wh[sel].mean(axis=0)
        prev = assign
    return centroids, avg_iou(wh, centroids)


def load_label_dims(train_txt: str) -> np.ndarray:
    """Collect all (w,h) pairs from the label files of a train list,
    using the reference's path-munge convention."""
    dims: List[Tuple[float, float]] = []
    with open(train_txt) as f:
        lines = [ln.rstrip("\n") for ln in f.readlines()]
    for line in lines:
        line = line.replace("JPEGImages", "labels")
        line = line.replace(".jpg", ".txt").replace(".png", ".txt")
        with open(line) as lf:
            for row in lf.readlines():
                parts = row.rstrip("\n").split(" ")
                if len(parts) >= 5:
                    dims.append((float(parts[3]), float(parts[4])))
    return np.asarray(dims, np.float64)


def write_anchors_file(centroids: np.ndarray, avg: float, path: str,
                       input_w: int, input_h: int) -> np.ndarray:
    """Write `anchors{k}.txt`: width-sorted pixel-scaled pairs + avg IoU."""
    anchors = centroids.copy()
    anchors[:, 0] *= input_w
    anchors[:, 1] *= input_h
    order = np.argsort(anchors[:, 0])
    anchors = anchors[order]
    with open(path, "w") as f:
        f.write(", ".join("%0.2f,%0.2f" % (a[0], a[1]) for a in anchors))
        f.write("\n%f\n" % avg)
    return anchors


def generate_anchors(train_txt: str, output_dir: str, num_clusters: int = 6,
                     input_w: int = 352, input_h: int = 352,
                     seed: Optional[int] = None, verbose: bool = True):
    """End-to-end tool: read labels, run k-means (or sweep k=1..10 when
    num_clusters == 0), write anchors files.  Returns the last (anchors,
    avg_iou)."""
    os.makedirs(output_dir, exist_ok=True)
    wh = load_label_dims(train_txt)
    assert len(wh), f"no labels found via {train_txt}"

    ks = range(1, 11) if num_clusters == 0 else [num_clusters]
    result = None
    for k in ks:
        centroids, avg = kmeans_anchors(wh, k, seed=seed, verbose=verbose)
        out = os.path.join(output_dir, f"anchors{k}.txt")
        anchors = write_anchors_file(centroids, avg, out, input_w, input_h)
        if verbose:
            print(f"k={k}: avg IoU {avg:.6f} -> {out}")
            print("anchors:", ", ".join("%0.2f,%0.2f" % (a[0], a[1])
                                        for a in anchors))
        result = (anchors, avg)
    return result
