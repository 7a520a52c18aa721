"""Prefetching host data loader: threads + bounded queue, padded batches
(the port's own copy of fastdet/data/loader.py).

A thread pool in place of torch DataLoader worker processes (reference
train.py:40-58): cv2's imread/resize release the GIL, so threads
saturate host cores without multiprocess serialization overhead; a
bounded prefetch queue keeps batches ready while the card computes.

Batches are fixed-shape: (B,H,W,3) uint8 images plus (B, max_labels, 5)
padded labels + (B, max_labels) mask (`pack_labels`, whose one copy in
the port lives in fastdet_torch/train/targets.py, which needs no cv2;
the dense loss reads the same layout).
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np

from fastdet_torch.data.dataset import DarknetDataset
from fastdet_torch.train.targets import pack_labels


class DataLoader:
    def __init__(self, dataset: DarknetDataset, batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 max_labels: int = 100, num_workers: int = 8,
                 prefetch: int = 4, seed: int = 0,
                 shard: Optional[Tuple[int, int]] = None):
        """shard=(index, count): multi-host mode — every host shuffles the
        full index list identically (seed+epoch keyed), then keeps the
        strided slice idx[index::count], so shards are disjoint, equal
        within one batch, and globally cover the dataset (the per-host
        input pipeline of SURVEY.md §5)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.max_labels = max_labels
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self._epoch = 0
        if shard is not None:
            index, count = shard
            assert 0 <= index < count, f"bad shard {shard}"
        self.shard = shard
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle order to an epoch number (deterministic across
        resume and identical on every host of a multi-host job)."""
        self._epoch = int(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)  # augmentation RNG keying

    def _get_pool(self) -> ThreadPoolExecutor:
        """Persistent worker pool, shared across epochs (the
        persistent_workers role of the reference DataLoader)."""
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.num_workers,
                    thread_name_prefix="fastdet-loader")
            return self._pool

    def close(self) -> None:
        with self._pool_lock:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
                self._pool = None

    def __del__(self):  # best-effort cleanup
        try:
            self.close()
        except Exception:
            pass

    def _shard_size(self) -> int:
        n = len(self.dataset)
        if self.shard is None:
            return n
        index, count = self.shard
        return len(range(index, n, count))

    def __len__(self) -> int:
        n = self._shard_size()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed * 100003 + self._epoch).shuffle(idx)
        if self.shard is not None:
            index, count = self.shard
            idx = idx[index::count]
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i:i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk

    def _load_batch(self, pool: ThreadPoolExecutor, chunk):
        samples = list(pool.map(self.dataset.__getitem__, chunk))
        images = np.stack([s[0] for s in samples])
        labels, mask = pack_labels([s[1] for s in samples],
                                   self.max_labels)
        return images, labels, mask

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()
        pool = self._get_pool()

        def _put(item) -> bool:
            """Bounded put that gives up when the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for chunk in self._batch_indices():
                    if stop.is_set():
                        return
                    if not _put(self._load_batch(pool, chunk)):
                        return
            finally:
                _put(sentinel)

        t = threading.Thread(target=producer, daemon=True,
                             name="fastdet-loader-producer")
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            # Abandoned iteration (break / exception / GC): release the
            # producer so it exits instead of blocking on a full queue.
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=10.0)
