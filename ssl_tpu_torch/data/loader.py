"""Host-side data loading: the epoch-seeded sampler, ``build_dataloader`` and
a prefetcher that copies batches to the card.

Counterpart of ``ssl_tpu/data/loader.py``.  The JAX package loads with one
background thread; here batches come from ``torch.utils.data.DataLoader``
with ``num_worker_per_gpu`` worker processes, as in BasicSR
(data/__init__.py:40-94, data_sampler.py:21-48, prefetch_dataloader.py).

* ``EnlargedSampler`` yields the JAX sampler's permutation
  (``np.random.RandomState(epoch)``).
* Each worker seeds ``random`` and ``numpy`` with BasicSR's
  ``num_workers * rank + worker_id + seed``, ``rank`` being the data rank
  (ranks that share rows under ``parallel.fsdp`` draw alike).
* With ``num_worker_per_gpu: 0`` the items are drawn in the main process, in
  the order the JAX loader's single thread draws them, so one seed gives the
  same batches in both packages.
* ``device_prefetch`` copies the next batch to the card on a side stream
  (``non_blocking``, from pinned memory) while the step runs."""

from __future__ import annotations

import random
from functools import partial

import numpy as np
import torch
from torch.utils.data import DataLoader, Sampler


class EnlargedSampler(Sampler):
    """Rank-strided, epoch-seeded permutation with an enlarge ratio so
    iteration-based training avoids frequent epoch boundaries (reference
    data_sampler.py:21-48)."""

    def __init__(self, num_samples: int, world_size: int = 1, rank: int = 0, ratio: int = 1):
        self.orig_num = num_samples
        self.world_size = world_size
        self.rank = rank
        self.num_per_rank = int(np.ceil(num_samples * ratio / world_size))
        self.total_size = self.num_per_rank * world_size
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def indices(self) -> np.ndarray:
        g = np.random.RandomState(self.epoch)
        order = g.permutation(self.total_size) % self.orig_num
        return order[self.rank:self.total_size:self.world_size]

    def __iter__(self):
        return iter(self.indices().tolist())

    def __len__(self):
        return self.num_per_rank


def worker_init_fn(worker_id: int, seed: int, num_workers: int = 0, rank: int = 0) -> None:
    """BasicSR's per-worker seed, num_workers * rank + worker_id + seed."""
    worker_seed = num_workers * rank + worker_id + seed
    np.random.seed(worker_seed)
    random.seed(worker_seed)


def build_dataloader(dataset, dataset_opt: dict, sampler=None, seed: int = 0,
                     device="cpu", rank: int = 0) -> DataLoader:
    """Reference-surface builder (data/__init__.py:40-94 semantics).  Train:
    ``batch_size_per_gpu``, ``num_worker_per_gpu`` worker processes (kept
    alive across epochs), whole batches only; val and test: batch 1 in the
    main process.  Batches are pinned when they go to the card."""
    pin = torch.device(device).type == "cuda"
    if dataset_opt.get("phase", "train") != "train":
        return DataLoader(dataset, batch_size=1, shuffle=False, num_workers=0, pin_memory=pin)
    num_workers = dataset_opt.get("num_worker_per_gpu", 4)
    return DataLoader(
        dataset, batch_size=dataset_opt.get("batch_size_per_gpu", 16), sampler=sampler,
        shuffle=sampler is None, num_workers=num_workers, drop_last=True, pin_memory=pin,
        persistent_workers=num_workers > 0,
        worker_init_fn=(partial(worker_init_fn, seed=seed, num_workers=num_workers, rank=rank)
                        if num_workers > 0 else None))


def _to(batch: dict, device, non_blocking: bool) -> dict:
    return {k: (v.to(device, non_blocking=non_blocking) if torch.is_tensor(v) else v)
            for k, v in batch.items()}


def device_prefetch(iterator, device):
    """Yield the batches of ``iterator`` on ``device``.  On the card the next
    batch is fetched and its copy started on a side stream before the current
    one is handed over, so the copy overlaps the step (reference
    CUDAPrefetcher, prefetch_dataloader.py:82-122)."""
    device = torch.device(device)
    it = iter(iterator)
    if device.type != "cuda":
        for batch in it:
            yield _to(batch, device, False)
        return
    stream = torch.cuda.Stream(device)

    def fetch():
        batch = next(it, None)
        if batch is None:
            return None
        with torch.cuda.stream(stream):
            return _to(batch, device, True)

    nxt = fetch()
    while nxt is not None:
        current = torch.cuda.current_stream(device)
        current.wait_stream(stream)
        batch = nxt
        for v in batch.values():
            if torch.is_tensor(v):
                v.record_stream(current)
        nxt = fetch()
        yield batch
