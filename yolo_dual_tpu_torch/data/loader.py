"""Host batch loader with background prefetch, and input normalisation (port
of yolo_dual_tpu/data/loader.py; reference utils/dataloaders.py:103-186).

One process reads the whole dataset: the JAX loader's per-host sharding has
no counterpart here. The quad `collate` and `sample_weights` resampling
(--image-weights) are not ported (ROADMAP A item 3).
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
    - the final batch padded to `batch_size` by repeating its last sample, with
      the count of real samples in `n_valid`, so every batch has one shape;
      with `drop_last` a final partial batch is dropped instead
    - background thread prefetch (depth `prefetch`) overlapping host reads and
      rasterisation with device compute
    """

    def __init__(self, dataset, batch_size: int = 16, shuffle: bool = False,
                 seed: int = 0, prefetch: Optional[int] = 2, drop_last: bool = False):
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

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self):
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        return idx

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self):
        idx = self._indices()
        bs = self.batch_size
        for s in range(0, len(self) * bs, bs):
            chunk = idx[s:s + bs]
            samples = [self.dataset[i] for i in chunk]
            samples += [samples[-1]] * (bs - len(chunk))
            batch = {k: np.stack([x[k] for x in samples]) for k in samples[0]}
            batch["n_valid"] = np.int32(len(chunk))
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
