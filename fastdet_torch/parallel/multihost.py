"""Multi-process helpers: input shards, eval-stat gathering and the
collectives of a data-parallel step (counterpart of
fastdet/parallel/multihost.py).

Each process of a job feeds and evaluates its own shard of the dataset;
`gather_eval_stats` all-gathers the per-process detection statistics so
that every process computes the same global (P, R, mAP, F1).  On one
process it is the identity.

Every gather here is one `all_reduce(SUM)` of a zero-padded buffer in
which each rank fills its own slot: exact (x + 0 is x), and available on
every backend and device, where gloo has no `all_gather` for CUDA
tensors.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def world(group=None) -> Tuple[int, int]:
    """(rank, size) of this process in `group` (the world by default);
    (0, 1) outside a job."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def process_shard(n_items: int, group=None) -> Tuple[int, int]:
    """[start, end) of this process's contiguous shard of a dataset."""
    pid, n = world(group)
    per = (n_items + n - 1) // n
    start = min(pid * per, n_items)
    return start, min(start + per, n_items)


def comm_device(group=None) -> torch.device:
    """Where a collective's buffers must live: the current card for nccl,
    the CPU otherwise."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_stacked(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `t` (same shape on all) stacked in rank order →
    (world, *t.shape), on t's device."""
    rank, n = world(group)
    buf = t.new_zeros((n,) + tuple(t.shape))
    buf[rank] = t
    dist.all_reduce(buf, group=group)
    return buf


def gather_eval_stats(stats: Sequence[Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]],
                      labels: Sequence[float], group=None):
    """All-gather per-process (tp, conf, cls) stat tuples (empty ones
    too) and the ground-truth label lists, in rank order.

    Returns (all_stats, all_labels) with every process's contributions,
    packed as float32 as the JAX package's are; on one process it is
    the identity."""
    rank, n = world(group)
    if n == 1:
        return list(stats), list(labels)
    dev = comm_device(group)
    flat = [np.concatenate([np.asarray(s[0], np.float32),
                            np.asarray(s[1], np.float32),
                            np.asarray(s[2], np.float32)]) for s in stats]
    buf = np.concatenate(flat) if flat else np.zeros(0, np.float32)
    lens = np.asarray([len(s[0]) for s in stats], np.float32)
    labs = np.asarray(labels, np.float32)
    # the payloads are ragged: gather the sizes, then one buffer of the
    # largest payload's size per rank
    sizes = all_gather_stacked(torch.tensor(
        [buf.size, lens.size, labs.size], dtype=torch.int64, device=dev),
        group).cpu().numpy()
    width = int(sizes.sum(1).max())
    mine = np.zeros(width, np.float32)
    mine[:buf.size + lens.size + labs.size] = np.concatenate(
        [buf, lens, labs])
    gathered = all_gather_stacked(torch.from_numpy(mine).to(dev),
                                  group).cpu().numpy()

    all_stats: List = []
    all_labels: List[float] = []
    for h in range(n):
        nb, nl, ng = (int(v) for v in sizes[h])
        hbuf = gathered[h, :nb]
        offs = 0
        for k in gathered[h, nb:nb + nl]:
            k = int(k)
            all_stats.append(tuple(hbuf[offs + i * k:offs + (i + 1) * k]
                                   for i in range(3)))
            offs += 3 * k
        all_labels.extend(gathered[h, nb + nl:nb + nl + ng].tolist())
    return all_stats, all_labels


def broadcast_module(module: torch.nn.Module, group=None, src: int = 0):
    """Copy rank `src`'s parameters and buffers to every rank."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src, group=group)


def all_reduce_grads(params: Sequence[torch.nn.Parameter], group=None):
    """Sum every rank's `.grad` in place: one flat buffer, one
    all_reduce(SUM).  A sum, not the average that DistributedDataParallel
    takes: each rank's loss already carries the global normalizers, so
    the sum is the gradient of the global loss.  The ranks run the same
    graph, so the same parameters hold a gradient on each."""
    _flat_grads(params, lambda flat: dist.all_reduce(flat, group=group))


def broadcast_grads(params: Sequence[torch.nn.Parameter], src: int,
                    group=None):
    """Rank `src`'s `.grad` (a global rank) to every rank of `group`, in
    place: one flat buffer, one broadcast."""
    _flat_grads(params, lambda flat: dist.broadcast(flat, src, group=group))


def _flat_grads(params, collective):
    """`collective` on the `.grad`s of `params`, packed in one flat
    buffer and copied back."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    collective(flat)
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
