"""Batch assembly and host->device prefetching (tpumix/data/prefetch.py).

The reference feeds training through ``torch.utils.data.DataLoader`` with 6
worker processes + pinned memory (reference training.ipynb cell 6).  Here a
lightweight batcher plus a background-thread prefetcher overlaps disk I/O and
batch assembly with device compute and stages the next batches on the device
ahead of time, so the card does not wait on the host.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from tpumix_torch.utils.device import resolve_device


class BatchIterator:
    """Shuffled epoch iterator over a map-style dataset, yielding stacked
    numpy batches.  ``drop_last`` keeps shapes static."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: Optional[int] = None,
        drop_last: bool = True,
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        """``num_shards``/``shard_index``: multi-process data sharding — every
        process builds the iterator with the SAME seed and its own index, the
        shuffled epoch order is identical everywhere (seeded host RNG), and
        each process yields the disjoint strided slice ``order[index::num]``
        (the DistributedSampler pattern; ``batch_size`` stays the PER-PROCESS
        size)."""
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} outside [0, {num_shards})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index
        self._rng = np.random.default_rng(seed)

    def _shard_len(self) -> int:
        # floor division keeps every shard the same length (a straggler shard
        # would deadlock collectives)
        return len(self.dataset) // self.num_shards if self.num_shards > 1 else len(self.dataset)

    def __len__(self) -> int:
        n = self._shard_len()
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        if self.num_shards > 1:
            order = order[self.shard_index :: self.num_shards][: self._shard_len()]
        stop = len(self) * self.batch_size if self.drop_last else len(order)
        for lo in range(0, stop, self.batch_size):
            idxs = order[lo : lo + self.batch_size]
            items = [self.dataset[int(i)] for i in idxs]
            yield tuple(np.stack(parts) for parts in zip(*items))


def prefetch_to_device(
    iterator,
    size: int = 2,
    device=None,
    transform: Optional[Callable] = None,
) -> Iterator:
    """Wrap a host batch iterator with a background thread that stages the
    next ``size`` batches on ``device`` (None = ``cuda``) while the current
    step runs; yields tuples of tensors.  ``transform`` runs on the host
    thread before the transfer.

    On a CUDA device each array is copied into page-locked memory and sent
    with ``non_blocking=True`` on a side stream; the consumer's stream waits
    on the copy's event before the batch is handed out, so the copy of batch
    k+1 overlaps the step on batch k.  A worker's error is raised in the
    consumer."""
    device = resolve_device(device)
    on_cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if on_cuda else None

    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    _END = object()
    _ERR = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def stage(batch):
        tensors = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in batch)
        if not on_cuda:
            return tensors, None
        with torch.cuda.stream(copy_stream):
            # each copy is issued from the pinned tensor itself, so the host
            # allocator keeps its block until the copy has run
            staged = tuple(t.pin_memory().to(device, non_blocking=True) for t in tensors)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return staged, done

    def producer():
        try:
            for batch in iterator:
                if transform is not None:
                    batch = transform(batch)
                if not put(stage(batch)):
                    return
            put(_END)
        except BaseException as e:  # surface worker errors in the consumer
            put((_ERR, e))

    t = threading.Thread(target=producer, daemon=True, name="tpumix-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if item[0] is _ERR:
                raise item[1]
            staged, done = item
            if done is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(done)
                for tensor in staged:  # allocated on the side stream, used on this one
                    tensor.record_stream(current)
            yield staged
    finally:
        stop.set()  # a consumer that stops early releases the producer
