"""Host batch loader with background prefetch, and input normalisation (port
of yolo_dual_tpu/data/loader.py; reference utils/dataloaders.py:103-186).

Under data parallelism (`num_shards` ranks, parallel/mesh.py) each rank
reads only its rows of every global batch.
"""

from __future__ import annotations

import os
import queue
import random
import threading
from typing import Iterator, Optional

import numpy as np
import torch


class Loader:
    """Batches a map-style dataset into stacked numpy dicts.

    - deterministic per-epoch shuffling (set_epoch, reference seed_worker
      determinism utils/dataloaders.py:96-100)
    - `sample_weights` (--image-weights): when set and shuffling, each epoch
      draws len(dataset) indices with replacement in proportion to them,
      uniformly when they are all 0 (JAX data/loader.py:65-80)
    - a dataset with aspect buckets (`bucket_of`, rect evaluation) is batched
      bucket by bucket, so no batch straddles two shapes
    - the final batch of each group padded to `batch_size` by repeating its
      last sample, with the count of real samples in `n_valid`, so every batch
      has one shape; with `drop_last` a final partial batch is dropped instead
    - `collate`: a transform of each batch's sample list before stacking (the
      quad collate of data/dataset.py), with JAX's `n_valid` rule: a collated
      sample is real when it holds at least one real one
    - `num_shards` / `shard_index` (one rank of a data-parallel run): each
      global batch of `batch_size · num_shards` indices is cut as JAX's
      per-host shard idx[r::W] cuts it (data/loader.py:79 there), so rank r's
      batch is rows r, r + W, ... of the global one and the union of the
      ranks' batches is the global batch. Every rank yields the same number
      of batches: where the last global batch leaves a rank no row, its batch
      is padding with `n_valid` 0 (JAX's shard yields none there, and its
      data-parallel val rounds the batch up instead); with `drop_last` the
      partial global batch is dropped on every rank
    - background thread prefetch (depth `prefetch`) overlapping host reads and
      augmentation with device compute
    """

    def __init__(self, dataset, batch_size: int = 16, shuffle: bool = False,
                 seed: int = 0, prefetch: Optional[int] = 2, drop_last: bool = False,
                 collate=None, num_shards: int = 1, shard_index: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        if prefetch and (os.cpu_count() or 1) < 2:
            # on a single-core host the thread overlaps nothing and fights the
            # consumer for the interpreter lock over the batch np.stack copies
            prefetch = 0
        self.prefetch = prefetch
        self.epoch = 0
        self.collate = collate
        self.sample_weights = None
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} of {num_shards} shards")
        self.num_shards, self.shard_index = num_shards, shard_index

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self):
        n = len(self.dataset)
        if self.sample_weights is not None and self.shuffle:
            w = list(self.sample_weights)
            if sum(w) <= 0:  # random.choices refuses all-zero weights
                w = [1.0] * n
            return random.Random(self.seed + self.epoch).choices(range(n), weights=w, k=n)
        idx = list(range(n))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        return idx

    def _chunks(self):
        """This rank's index chunks of the epoch (empty where a padding batch
        stands)."""
        return (mine for mine, _ in self._shards())

    def _shards(self):
        """(this rank's indices, the global chunk's last index) for each global
        chunk of the epoch, bucket by bucket (in bucket order) when the
        dataset has aspect buckets (JAX data/loader.py:85-103)."""
        idx = self._indices()
        bs = self.batch_size * self.num_shards
        bucket_of = getattr(self.dataset, "bucket_of", None)
        groups = [idx]
        if bucket_of is not None:
            by_bucket = {}
            for i in idx:
                by_bucket.setdefault(int(bucket_of[i]), []).append(i)
            groups = [by_bucket[b] for b in sorted(by_bucket)]
        for g in groups:
            stop = len(g) - len(g) % bs if self.drop_last else len(g)
            for s in range(0, stop, bs):
                chunk = g[s:s + bs]
                yield chunk[self.shard_index::self.num_shards], chunk[-1]

    def __len__(self):
        return sum(1 for _ in self._chunks())

    def _batches(self):
        bs = self.batch_size
        for chunk, last in self._shards():
            samples = [self.dataset[i] for i in chunk or [last]]
            samples += [samples[-1]] * (bs - len(samples))
            n_valid = len(chunk)
            if self.collate is not None:
                samples = self.collate(samples)
                if not samples:
                    raise ValueError(f"collate fn returned no samples for a chunk of {bs}; "
                                     "quad collate needs batch_size to be a multiple of 4")
                factor = max(1, bs // len(samples))
                n_valid = min(len(samples), -(-n_valid // factor))
            batch = {k: np.stack([x[k] for x in samples]) for k in samples[0]}
            batch["n_valid"] = np.int32(n_valid)
            yield batch

    def __iter__(self) -> Iterator[dict]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err = []

        def worker():
            try:
                for b in self._batches():
                    q.put(b)
            except Exception as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            b = q.get()
            if b is sentinel:
                break
            yield b
        t.join()
        if err:
            raise err[0]


def normalize_image(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [0, 1]; float tensors pass through unchanged."""
    if x.dtype == torch.uint8:
        return x.float() / 255.0
    return x


def to_device(x, dev, pin: bool) -> torch.Tensor:
    """A loader array on `dev`: through pinned memory to a CUDA device, so the
    copy is one asynchronous DMA."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if pin:
        t = t.pin_memory()
    return t.to(dev, non_blocking=pin)
