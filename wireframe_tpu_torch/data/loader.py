"""Batch loaders: shuffled fixed-shape batches with background prefetch.

The port's copy of `wireframe_tpu/data/loader.py`.  Host work (parse,
sample, collate) runs in a worker thread one batch ahead of the
consumer, so the card does not wait on ingest.

Determinism: every epoch's shuffle order and per-sample draws come from
`SeedSequence([seed, epoch])`, so a resumed run (`loader.epoch =
start_epoch`, which `train.loop.train_model` sets) replays exactly the
data order of the uninterrupted run, and both packages draw the same
batches.  A worker's exception reaches the consumer: a corrupt file
fails the epoch instead of truncating it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from wireframe_tpu_torch.data.building3d import Building3DDataset, collate_fixed


class ArrayBatchLoader:
    """In-memory loader over pre-collated fixed-shape batches, with the
    surface `train_model` reads from `BatchLoader` (`__len__`, iteration,
    `.epoch`, `.batch_size`, `.dataset`, `.drop_last`)."""

    def __init__(self, batches):
        self.batches = list(batches)
        self.dataset = self.batches
        self.batch_size = (len(self.batches[0]["point_clouds"])
                           if self.batches else 0)
        self.drop_last = False
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self) -> Iterator[dict]:
        self.epoch += 1
        return iter(self.batches)


class BatchLoader:
    def __init__(self, dataset: Building3DDataset, batch_size: int,
                 max_vertices: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0,
                 augment_on_host: Optional[bool] = None,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_vertices = max_vertices
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.augment_on_host = augment_on_host
        self.prefetch = prefetch
        self.seed = seed
        self.epoch = 0  # next epoch index; set before iterating to resume

    def __len__(self) -> int:
        n = len(self.dataset)
        bs = self._primary_per_batch()
        if self.drop_last:
            return n // bs
        return (n + bs - 1) // bs

    def _epoch_rng(self, epoch: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch]))

    def _make_batch(self, indices, rng) -> dict:
        samples = [
            self.dataset.get_sample(
                int(i), rng=rng, augment_on_host=self.augment_on_host)
            for i in indices
        ]
        return collate_fixed(samples, self.max_vertices)

    def _primary_per_batch(self) -> int:
        """Primary-dataset samples per batch (subclasses may reserve
        slots for an auxiliary corpus)."""
        return self.batch_size

    def _epoch_batches(self, rng) -> list:
        """The epoch's shuffled primary-index batches."""
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            rng.shuffle(indices)
        bs = self._primary_per_batch()
        batches = [indices[k:k + bs] for k in range(0, len(indices), bs)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == bs]
        return batches

    def __iter__(self) -> Iterator[dict]:
        epoch = self.epoch
        self.epoch += 1
        rng = self._epoch_rng(epoch)
        batches = self._epoch_batches(rng)

        if self.prefetch <= 0:
            for bi in batches:
                yield self._make_batch(bi, rng)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def worker():
            try:
                for bi in batches:
                    q.put(self._make_batch(bi, rng))
                q.put(sentinel)
            except BaseException as e:  # handed to the consumer, re-raised
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item


class MixedBatchLoader(BatchLoader):
    """Mixed co-training loader (`train.cotrain_root` / `cotrain_count`):
    every batch holds (batch_size - aux_per_batch) primary samples and
    aux_per_batch samples drawn i.i.d. from an auxiliary corpus.

    An epoch is one shuffled pass over the PRIMARY dataset (so
    `num_epochs` keeps meaning real-data passes and the LR schedule's
    step count scales with the primary corpus only); auxiliary draws
    come from the same (seed, epoch)-derived generator, so runs are
    deterministic and resumable like the plain loader's.
    """

    def __init__(self, dataset: Building3DDataset,
                 aux_dataset: Building3DDataset, aux_per_batch: int,
                 batch_size: int, max_vertices: int, **kwargs):
        if not 0 < aux_per_batch < batch_size:
            raise ValueError(
                f"aux_per_batch must be in (0, batch_size): "
                f"{aux_per_batch} vs batch_size={batch_size}")
        if len(aux_dataset) == 0:
            raise ValueError("auxiliary dataset is empty")
        super().__init__(dataset, batch_size, max_vertices, **kwargs)
        self.aux_dataset = aux_dataset
        self.aux_per_batch = aux_per_batch

    def _primary_per_batch(self) -> int:
        return self.batch_size - self.aux_per_batch

    def _make_batch(self, indices, rng) -> dict:
        aux_indices = rng.integers(0, len(self.aux_dataset),
                                   size=self.aux_per_batch)
        samples = [
            self.dataset.get_sample(
                int(i), rng=rng, augment_on_host=self.augment_on_host)
            for i in indices
        ] + [
            self.aux_dataset.get_sample(
                int(j), rng=rng, augment_on_host=self.augment_on_host)
            for j in aux_indices
        ]
        return collate_fixed(samples, self.max_vertices)
