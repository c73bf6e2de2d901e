"""A composable streaming data pipeline on the host, after the JAX
package's ``data/dataset.py`` (the reference's IterableDataset machinery,
cosyvoice/dataset/dataset.py:26-161): a ``DataList`` of shards with
epoch-seeded shuffling and rank / worker partitioning, a chain of
generator processors applied lazily, and a background prefetcher."""

from __future__ import annotations

import queue
import random
import threading
from typing import Callable, Iterable, Iterator, Sequence


class DataList:
    """Shard descriptors with a deterministic shuffle per epoch and a
    partition by rank and worker."""

    def __init__(self, lists: Sequence, shuffle: bool = True,
                 partition: bool = True, rank: int = 0, world_size: int = 1,
                 worker_id: int = 0, num_workers: int = 1):
        self.lists = list(lists)
        self.shuffle = shuffle
        self.partition = partition
        self.rank = rank
        self.world_size = world_size
        self.worker_id = worker_id
        self.num_workers = num_workers
        self.epoch = -1

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[dict]:
        data = list(self.lists)
        if self.shuffle:
            random.Random(self.epoch).shuffle(data)
        if self.partition:
            data = data[self.rank::self.world_size]
        for src in data[self.worker_id::self.num_workers]:
            yield {"src": src, "epoch": self.epoch}


def build_pipeline(source: Iterable, processors: Sequence[Callable]
                   ) -> Iterable:
    """Chains processors, each a generator function ``f(iterable)`` (bind
    keyword arguments with ``functools.partial``, as the reference's
    hyperpyyaml does)."""
    it = source
    for p in processors:
        it = p(it)
    return it


class Prefetcher:
    """Runs an iterable on a background thread ``depth`` items ahead, so
    the card is fed while parquet decoding and features run on the host
    (the role of torch DataLoader workers, train_utils.py:54-76).  An
    exception in the producer is raised in the consumer."""

    _DONE = object()

    def __init__(self, iterable: Iterable, depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err = None

        def worker():
            try:
                for item in iterable:
                    self._q.put(item)
            except BaseException as e:          # raised in the consumer
                self._err = e
            finally:
                self._q.put(self._DONE)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                if self._err is not None:
                    raise self._err
                return
            yield item
