"""Threaded prefetching data loader with seeded per-epoch order, and the
host-to-card copy of its batches.

Counterpart of ``mga_yolo_tpu/data/loader.py``: a thread pool builds
batches ahead (the PNG inflate, the JPEG decode, the torch warps and the
host C++ release the GIL for their heavy work), each sample from a generator seeded by (seed,
epoch, index), so a batch does not depend on which thread built it. Global
batches can be split into ``num_shards`` per-process shards.
:meth:`DataLoader.to_device` copies a batch into pinned host buffers and
from there to the card without blocking the host; the dict it returns is
the one ``train.state.make_train_step`` takes. In :attr:`DataLoader.raw_mode`
a batch is instead ``device_augment.collate_raw`` of un-warped samples, which
``device_augment.make_augment_fn`` finishes on the card. A loader that keeps
the last batch (``drop_last=False``) adds ``first`` to each batch: whether
each row is its image's first in the epoch's global order, which every shard
knows, so a consumer counts a padded row's image once over the shards.
"""

from __future__ import annotations

import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch

from mga_yolo_tpu_torch.data import device_augment as DA
from mga_yolo_tpu_torch.data.dataset import MGADataset, collate
from mga_yolo_tpu_torch.device import resolve_device


class DataLoader:
    """Deterministic, sharded, prefetching loader over an MGADataset.

    ``device`` (CUDA when None; raises without a card) is where
    :meth:`to_device` puts batches. ``use_mosaic`` is on until
    :meth:`set_epoch` reaches the last ``augment.close_mosaic`` epochs.
    """

    def __init__(self, dataset: MGADataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 workers: int = 8, drop_last: bool = True, prefetch: int = 4, num_shards: int = 1,
                 shard_index: int = 0, device: str | torch.device | None = None):
        if batch_size % num_shards:
            raise ValueError(f"batch {batch_size} does not divide into {num_shards} shards")
        self.dataset = dataset
        self.global_batch = batch_size
        self.local_batch = batch_size // num_shards
        self.shuffle = shuffle
        self.seed = seed
        self.workers = max(1, workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.device = resolve_device(device)
        self.epoch = 0
        self.use_mosaic = True
        self.size_buckets: Optional[list[int]] = None  # bucketed multi-scale sizes
        # un-warped canvases, matrices and gains for the device-side
        # augmentation (data/device_augment.py) instead of finished samples
        self.raw_mode = False

    def __len__(self) -> int:
        if getattr(self.dataset, "rect", False):
            return len(self._epoch_batches())
        n = len(self.dataset)
        return n // self.global_batch if self.drop_last else -(-n // self.global_batch)

    def set_epoch(self, epoch: int, epochs: Optional[int] = None) -> None:
        """Start ``epoch``; given the run's ``epochs``, mosaic is off for the
        last ``augment.close_mosaic`` of them."""
        self.epoch = epoch
        if epochs is not None:
            self.use_mosaic = (epochs - epoch) > self.dataset.cfg.augment.close_mosaic

    def _epoch_order(self) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        if self.drop_last and n >= self.global_batch:
            order = order[: (n // self.global_batch) * self.global_batch]
        elif not self.drop_last and self.num_shards > 1 and n % self.global_batch:
            # every shard gets the same number of rows: the tail wraps round,
            # and consumers drop repeats by the batch's ``index``
            order = np.concatenate([order, order[: self.global_batch - n % self.global_batch]])
        return order

    def _epoch_batches(self) -> list[np.ndarray]:
        """Global-batch index arrays; a rect dataset batches within an aspect
        bucket and wraps each bucket's last batch to full size."""
        B = self.global_batch
        if not getattr(self.dataset, "rect", False):
            order = self._epoch_order()
            nb = len(order) // B if self.drop_last else -(-len(order) // B)
            return [order[i * B:(i + 1) * B] for i in range(nb)]
        batches = []
        for b in range(len(self.dataset.bucket_shapes)):
            idx = np.nonzero(self.dataset.bucket == b)[0]
            if self.shuffle and len(idx):
                np.random.default_rng(self.seed + self.epoch + b).shuffle(idx)
            batches += [np.resize(idx[i:i + B], B) for i in range(0, len(idx), B)]
        return batches

    @staticmethod
    def _first_flags(batch_list: list[np.ndarray]) -> list[np.ndarray]:
        """Per global batch, whether each row is the first of its image in
        the epoch (the wrapped tail and a rect bucket's padding repeat)."""
        seen: set[int] = set()
        out = []
        for idx in batch_list:
            flags = np.zeros(len(idx), dtype=bool)
            for j, i in enumerate(idx):
                flags[j] = int(i) not in seen
                seen.add(int(i))
            out.append(flags)
        return out

    def _make_batch(self, batch_list: list, bi: int, use_mosaic: bool, first: Optional[list] = None) -> dict:
        local_idx = batch_list[bi][self.shard_index::self.num_shards]
        imgsz = None
        if self.size_buckets:  # one size a batch, the same on every shard
            brng = np.random.default_rng(self.seed * 7919 + self.epoch * 104_729 + bi)
            imgsz = int(brng.choice(self.size_buckets))
        samples = []
        for di in local_idx:
            rng = np.random.default_rng((self.seed * 1_000_003 + self.epoch * 10_007 + int(di)) % (2**63))
            if self.raw_mode:
                samples.append(DA.build_raw_sample(self.dataset, int(di), rng, use_mosaic, imgsz))
            else:
                samples.append(self.dataset.get(int(di), rng, use_mosaic=use_mosaic, imgsz=imgsz))
        batch = DA.collate_raw(samples) if self.raw_mode else collate(samples)
        if first is not None:
            batch["first"] = first[bi][self.shard_index::self.num_shards]
        return batch

    def __iter__(self) -> Iterator[dict]:
        batch_list = self._epoch_batches()
        nb, use_mosaic = len(batch_list), self.use_mosaic
        first = None if self.drop_last else self._first_flags(batch_list)
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            futures: queue.Queue = queue.Queue()
            for bi in range(min(self.prefetch, nb)):
                futures.put(pool.submit(self._make_batch, batch_list, bi, use_mosaic, first))
            next_bi = futures.qsize()
            for _ in range(nb):
                fut = futures.get()
                if next_bi < nb:
                    futures.put(pool.submit(self._make_batch, batch_list, next_bi, use_mosaic, first))
                    next_bi += 1
                yield fut.result()

    def to_device(self, batch: dict) -> dict:
        """The batch as tensors on :attr:`device` (masks a list, as given).
        On CUDA each array is copied into pinned host memory first, and from
        there to the card with ``non_blocking=True``. PyTorch's caching host
        allocator reuses the pinned blocks, and hands a block out again only
        once the copy out of it has finished."""
        def move(a: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(np.asarray(a))
            if self.device.type == "cuda":
                return t.pin_memory().to(self.device, non_blocking=True)
            return t.to(self.device)

        return {k: [move(m) for m in v] if isinstance(v, list) else move(v) for k, v in batch.items()}
